"""repro_torch.checkpoint — atomic, validated checkpoints on the reference's
on-disk layout (`manager.py`), with JAX's leaf order and paths
(`tree.py`) and the manifest's MessagePack subset (`msgpack_lite.py`)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointManager,
)
