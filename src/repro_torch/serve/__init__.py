"""repro_torch.serve — the multi-tenant sensor-serving stack of the port.

The port of `repro.serve`, with the device in place of the backend name:
the batched execution engine (`engine.py`), per-tenant engine **replica
pools** with least-loaded routing, each replica pinned to a device
(`replicas.py`), the fleet router with deadline-driven micro-batching,
queue-depth **admission control** and manifest **hot-reload**
(`fleet.py` + `batcher.py`), the fleet controller — QoS classes,
per-tenant token-bucket rate limits, and a hysteresis replica
autoscaler (`autoscale.py`) — **process-per-device dispatch workers**
fed over shared-memory reading planes (`workers.py`), and a network
front that speaks the reference's wire protocol: length-prefixed binary
frames with version-negotiated batch frames (`protocol.py`), a sharded
asyncio socket server with optional UDP ingest (`server.py`) and a
blocking client library with batched submits and client-side coalescing
(`client.py`).  The LM engine is `lm_engine.py`.

In-process (on the current CUDA device; `device="cpu"` runs the plain
PyTorch versions):

    from repro_torch.serve import ClassifierFleet
    fleet = ClassifierFleet.from_emit_dir("artifacts", replicas=2,
                                          max_queue=2048)
    req = fleet.submit("tnn_cardio", reading)      # returns immediately
    label = req.result(timeout=1.0)                # blocks until served
    reqs, shed, retry_ms = fleet.submit_many("tnn_cardio", plane)  # batched
    fleet.shutdown(drain=True)

Over the wire:

    python -m repro_torch.serve serve --emit-dir artifacts --port 7341 \\
        --shards 2 --udp-port 7342                                 # server
    python -m repro_torch.serve replay --emit-dir artifacts \\
        --connect 127.0.0.1:7341 --batch 256                       # client
"""
from repro_torch.serve.autoscale import (
    QOS_CLASSES,
    Autoscaler,
    AutoscaleConfig,
    TenantSignals,
    TokenBucket,
)
from repro_torch.serve.batcher import MicroBatcher, QueuedItem
from repro_torch.serve.engine import (
    STATS_WINDOW,
    CircuitServingEngine,
    SensorRequest,
    ServeStats,
)
from repro_torch.serve.fleet import (
    DEFAULT_DEADLINE_MS,
    DEFAULT_MAX_BATCH,
    ClassifierFleet,
    FleetOverloadError,
    FleetRequest,
    TenantSpec,
)
from repro_torch.serve.replicas import EngineReplica, ReplicaPool
from repro_torch.serve.workers import WorkerError, WorkerHost

__all__ = [
    "DEFAULT_DEADLINE_MS",
    "DEFAULT_MAX_BATCH",
    "QOS_CLASSES",
    "STATS_WINDOW",
    "Autoscaler",
    "AutoscaleConfig",
    "CircuitServingEngine",
    "ClassifierFleet",
    "EngineReplica",
    "FleetOverloadError",
    "FleetRequest",
    "MicroBatcher",
    "QueuedItem",
    "ReplicaPool",
    "SensorRequest",
    "ServeStats",
    "TenantSignals",
    "TenantSpec",
    "TokenBucket",
    "WorkerError",
    "WorkerHost",
]
