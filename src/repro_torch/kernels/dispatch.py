"""Dispatch of the gate-simulation kernels over devices.

The port's `repro.kernels.dispatch`.  The reference picks an executor by
backend name; here the device decides.  Every entry point takes numpy
plans, validates them on the host (`check_plan`: the CUDA kernel trusts
every node id), moves them to the device and runs the wrappers of
`cuda_circuit_sim`, which launch the kernel for CUDA tensors and run the
plain PyTorch version for CPU tensors; the fleet dispatch validates, pads
and schedules a set of plans once and reuses them.  `devices=None` means
the current CUDA device and raises without one; there is no fallback to
the CPU.

  * `population_eval_uint` / `population_eval_pop` split the population
    axis across an explicit device list;
  * `population_pc_errors` scores a population of popcount circuits
    against true counts (CGP fitness) with one launch a device;
  * `population_simulate` returns the raw output words (uint64);
  * `program_eval_words` runs one program over a large batch and splits
    the packed *word* axis across the devices;
  * `fleet_eval_words` runs every tenant of a manifest in one launch;
  * `replica_devices` pins serving replicas round-robin to CUDA devices;
  * `configure_worker_process` sizes a serve worker's thread pools.

Results come back to the host as int64 numpy arrays, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import circuit_sim as CS
from repro_torch.kernels import cuda_circuit_sim as CK
from repro_torch.kernels.circuit_sim import check_plan


def configure_worker_process(n_procs: int = 1) -> None:
    """Cap math-library threading for a serve worker subprocess.

    A fleet spawning N worker processes on an M-core host wants each
    child's intra-op thread pools sized ~M/N, not M, or N children times M
    threads oversubscribe the host and the per-dispatch latency the
    deadline policy feeds on turns to noise.  `setdefault` keeps any
    operator-provided caps of the OpenMP/MKL/OpenBLAS pools (read when
    those libraries start), and PyTorch's own intra-op pool is set to the
    same share.  Device selection is untouched: a worker's programs go to
    the device the fleet names.
    """
    import os

    if n_procs < 1:
        raise ValueError("n_procs must be >= 1")
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    per = str(max(1, cores // n_procs))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ.setdefault(var, per)
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


def replica_devices(index: int, devices=None) -> tuple:
    """Round-robin device pin for serving-engine replica `index`.

    With `devices=None` the candidates are the `torch.cuda.device_count()`
    CUDA devices, and none is an error: replicas never land on the CPU
    unless the caller lists it.
    """
    if index < 0:
        raise ValueError("replica index must be >= 0")
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device to pin replicas to; pass "
                               "devices explicitly (e.g. ('cpu',))")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices to pin replicas to")
    return (devs[index % len(devs)],)


def _devices(devices) -> list[torch.device]:
    if devices is None:
        return [resolve_device(None)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("empty device list")
    return devs


def _device_slices(n: int, n_dev: int) -> list[slice]:
    """Round-even contiguous slices, one per device (empty ones drop)."""
    per = max(1, -(-n // n_dev))
    return [slice(s, min(s + per, n)) for s in range(0, n, per)] or \
        [slice(0, 0)]


def _to(arrays, dev) -> list[torch.Tensor]:
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _words32(packed):
    """uint64 packed vectors (numpy, 64 a word) -> uint32 words; an int32
    tensor of uint32 bit patterns (32 a word, any device) passes as is."""
    if isinstance(packed, torch.Tensor):
        return packed
    return CS.pack_words32(packed)


def _population_shards(op, in0, in1, outputs, packed, n_inputs: int,
                       devs: list[torch.device]):
    """Yield `(plan shard, words)` per device: the checked plan's rows
    split round-even across `devs`, with their word planes (shared, or the
    rows' own) on that device."""
    plan = check_plan(op, in0, in1, outputs, n_inputs)
    words32 = _words32(packed)
    per_individual = words32.ndim == 3
    for sl, dev in zip(_device_slices(plan[0].shape[0], len(devs)), devs):
        shard = _to([np.ascontiguousarray(a[sl]) for a in plan], dev)
        yield shard, CS.words_tensor(
            words32[sl] if per_individual else words32, dev)


def population_eval_uint(op, in0, in1, outputs, packed_u64,
                         n_inputs: int, devices=None) -> np.ndarray:
    """Per-vector decoded outputs `(P, S)` int64 for a population of netlists.

    `packed_u64` is `(n_inputs, W)` shared or `(P, n_inputs, W)`
    per-individual uint64 words (`S = 64 W`), or the same planes as int32
    tensors of uint32 words (`S = 32 W`, e.g. packed on the device by
    `circuit_sim.pack_bits32`).  The population axis splits across
    `devices`; a raw plan's schedule is built on the card per call.
    """
    outs = [CK.fused_eval_uint(*shard, words, n_inputs).cpu()
            for shard, words in _population_shards(
                op, in0, in1, outputs, packed_u64, n_inputs,
                _devices(devices))]
    return torch.cat(outs, dim=0).numpy().astype(np.int64)


def population_eval_pop(pop, packed_u64, devices=None) -> np.ndarray:
    """`population_eval_uint` over a population object (`op`, `in0`, `in1`,
    `outputs`, `n_inputs` attributes, e.g. `NetlistPopulation`)."""
    return population_eval_uint(pop.op, pop.in0, pop.in1, pop.outputs,
                                packed_u64, pop.n_inputs, devices=devices)


def population_simulate(pop, packed_u64: np.ndarray,
                        devices=None) -> np.ndarray:
    """Raw output words `(P, n_out, W)` uint64 of a population object over
    uint64 packed vectors (`(n_inputs, W)` or `(P, n_inputs, W)`)."""
    outs = [CK.simulate_population(*shard, words, pop.n_inputs).cpu()
            for shard, words in _population_shards(
                pop.op, pop.in0, pop.in1, pop.outputs, packed_u64,
                pop.n_inputs, _devices(devices))]
    w32 = torch.cat(outs, dim=0).numpy().view(np.uint32).astype(np.uint64)
    return np.ascontiguousarray(w32[..., 0::2] | (w32[..., 1::2] << 32))


def population_pc_errors(pop, packed_u64, true,
                         devices=None) -> tuple[np.ndarray, np.ndarray]:
    """Per-individual `(mae, wcae)` float64 of a population of popcount
    circuits against the true counts `true` `(S,)`: CGP's fitness term.

    One launch a device decodes every vector; the absolute errors are
    summed and maximised on the device, and the mean is the exact integer
    sum over S in float64 on the host, as numpy's mean of the reference's
    integer errors gives it.  `packed_u64` and `true` are numpy arrays or
    tensors (words as in `population_eval_uint`), so a caller scoring many
    generations uploads them once.
    """
    stats = []
    for shard, words in _population_shards(
            pop.op, pop.in0, pop.in1, pop.outputs, packed_u64, pop.n_inputs,
            _devices(devices)):
        approx = CK.fused_eval_uint(*shard, words, pop.n_inputs)
        want = torch.as_tensor(true).to(device=approx.device,
                                        dtype=torch.int64)
        if want.shape != approx.shape[1:]:
            raise ValueError(f"true counts {tuple(want.shape)} do not match "
                             f"{approx.shape[1]} decoded vectors")
        err = (approx.long() - want[None, :]).abs()
        stats.append(torch.stack([err.sum(dim=1), err.max(dim=1).values],
                                 dim=1).cpu())
    total, worst = torch.cat(stats).numpy().astype(np.float64).T
    return total / want.shape[0], worst


def program_eval_words(op, in0, in1, outputs, words32, n_inputs: int,
                       devices=None) -> np.ndarray:
    """Single-program serving dispatch: `(n_inputs, W)` words -> `(P, W*32)`
    int64 decoded outputs.

    `words32` is a uint32 numpy plane or an int32 bit-pattern tensor
    (e.g. packed on the device by `CircuitProgram.pack_input_bits`).  The
    word axis splits round-even across `devices` and the shards'
    results concatenate on the host.
    """
    plan = check_plan(op, in0, in1, outputs, n_inputs)
    if words32.ndim != 2:
        raise ValueError("program_eval_words wants a shared (n_inputs, W) "
                         "word plane")
    devs = _devices(devices)
    outs = []
    for sl, dev in zip(_device_slices(words32.shape[1], len(devs)), devs):
        words = CS.words_tensor(words32[:, sl], dev)
        outs.append(CK.fused_eval_uint(*_to(plan, dev), words,
                                       n_inputs).cpu())
    return torch.cat(outs, dim=1).numpy().astype(np.int64)


def fleet_eval_words(plans: list, words_list: list,
                     device=None) -> list[np.ndarray]:
    """Whole-manifest serving dispatch: T tenants' circuits in ONE launch.

    `plans` holds one `(op, in0, in1, outputs, n_inputs)` plan per tenant
    (flat or `(1, G)` rows), `words_list` the matching `(n_inputs_t, W_t)`
    word planes (uint32 numpy or int32 tensors).  The padded plans and
    their level schedule are validated and built on the first dispatch of
    a set of plans and reused by every later one
    (`cuda_circuit_sim.fleet_plan`).  Returns one `(W_t * 32,)` int64
    array per tenant, equal to dispatching each tenant through
    `program_eval_words` on its own.
    """
    dev = resolve_device(device)
    words = [CS.words_tensor(w, dev) for w in words_list]
    return [o.cpu().numpy().astype(np.int64)
            for o in CK.fleet_eval_words(plans, words)]
