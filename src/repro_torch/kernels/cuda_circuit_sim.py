"""Wrappers of the hand-written CUDA gate-walk kernels (`csrc/circuit_sim.cu`).

Replace the Pallas kernels of `repro/kernels/pallas_circuit_sim.py`:

  * `fused_eval_uint` — `_fused_kernel`: gate walk, output taps and the
    LSB-first decode in one launch, `(P, W*32)` int32;
  * `simulate_population` — `_kernel`: the same walk, raw output words
    `(P, n_out, W)` int32;
  * `fleet_eval_words` — the multi-tenant megakernel: T tenants' plans
    padded to one gate budget and run as one `fused_eval_uint` launch.

`plan(n_nodes, G, W, P, depth, width, n_out)` routes a shape to one of
two designs (a pure function, so the routing is tested on the CPU):

* `shared_plane` — the level walk: a block keeps C word columns' whole
  node plane in shared memory and evaluates the gates level by level, one
  barrier a level, by the plan's level `Schedule`.  C (at most 32, as
  shared memory allows) gives the fewest waves of resident blocks, then
  the fewest warps walking levels on one SM;
* `global_scratch` — plans whose plane and schedule do not fit in shared
  memory even for one column (about 25 k gates and up): one thread per
  column walks the gates in plan order over a global scratch plane.

The route is chosen by shape; nothing falls back from one design to the
other.  A `Schedule` is built once per plan (`schedule`): a
`CircuitProgram` holds its own, `fleet_plan` pads a set of tenants' plans
and builds theirs once and keeps them for later dispatches (a
`FleetPlan`), and a wrapper called without one on a plan that routes to
the level walk builds it on the device for that call (on the card by
`circuit_levels_kernel` and `circuit_schedule_kernel`).
What bounds each design and what it does about it is set out at the top
of the CUDA source.  The tensor's device picks the executor: a CPU tensor
runs the plain version in `circuit_sim`, a CUDA tensor launches a kernel,
anything else raises.  Each wrapper counts its own launches in
`LAUNCHES`, and each launch adds one to its design's count in
`VARIANT_LAUNCHES`; the schedule kernels count in `SCHEDULE_LAUNCHES`.
The counts are taken under a lock, so launches from several threads are
counted exactly.

Contract on values (checked by the callers that build plans, not here,
because checking device tensors would stall the stream): opcodes in
[0, 13) and a feed-forward plan — `in0`/`in1` of gate g below
`n_inputs + g`, `outputs` below `n_inputs + G`.  `circuit_sim.check_plan`
and `Netlist.validate` enforce it; a given `Schedule` must come from
`schedule` on the same plan rows, which validates given levels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.hw.egfet import Gate
from repro_torch.kernels import circuit_sim as CS

SOURCE = "circuit_sim.cu"
LAUNCHES = {"fused_eval_uint": 0, "simulate_population": 0,
            "fleet_eval_words": 0}
VARIANTS = ("shared_plane", "global_scratch")
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
SCHEDULE_LAUNCHES = {"gate_levels": 0, "schedule": 0}
_COUNT_LOCK = threading.Lock()
MAX_GRID_Y = 65535

SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448         # dynamic shared memory a block can opt into
SMEM_SM = 233472          # shared memory of an SM...
SMEM_RESERVED = 1024      # ...of which each resident block holds this much
THREADS_SM = 2048         # resident threads an SM
BLOCKS_SM = 32            # resident blocks an SM
MAX_COLUMNS = 32          # word columns per level-walk block
LEVEL_MIN_THREADS = 128   # enough threads to stage the schedule quickly
LEVEL_MAX_THREADS = 512
GLOBAL_THREADS = 128      # columns per global-scratch block
FLEET_CACHE = 32          # padded fleets kept for reuse: every
                          # subset of a five-tenant manifest


class Plan(NamedTuple):
    """How one launch runs: the design, the word columns a block owns, the
    threads that walk the levels and the threads a block (equal for the
    global-scratch walk), the grid `(column blocks, P)`, the dynamic shared
    memory in bytes (0 for the global-scratch walk), the waves of resident
    blocks the grid takes and the warps that walk levels on one SM."""
    variant: str
    columns: int
    level_threads: int
    threads: int
    grid: tuple[int, int]
    smem_bytes: int
    waves: int
    walking_warps: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round(n: int, m: int) -> int:
    return _cdiv(n, m) * m


def row_words(G: int, depth: int) -> int:
    """Words of one plan row's schedule buffer (`Schedule.program`): the
    `depth + 1` level offsets padded to 4, one entry a slot padded to 4,
    and a byte of opcode bits a slot padded to 16."""
    return _round(depth + 1, 4) + _round(G, 4) + _round(G, 16) // 4


def level_smem_bytes(n_nodes: int, G: int, depth: int, n_out: int,
                     columns: int) -> int:
    """Shared memory of the level walk: the `[node][column]` plane (padded
    to 4 words), the row's schedule buffer, the output taps' plane offsets,
    and the row's level count and widest level."""
    return 4 * (_round(n_nodes * columns, 4) + row_words(G, depth) + n_out
                + 2)


def _level_threads(columns: int, width: int) -> tuple[int, int]:
    """(threads that walk the levels, threads a block): a (gate, column)
    pair of the widest level each where 512 allow, in whole warps; at
    least `LEVEL_MIN_THREADS` a block for staging the schedule."""
    walk = min(LEVEL_MAX_THREADS, _cdiv(columns * max(width, 1), 32) * 32)
    walk = max(walk, _cdiv(columns, 32) * 32)
    return walk, max(walk, LEVEL_MIN_THREADS)


@functools.lru_cache(maxsize=4096)
def plan(n_nodes: int, G: int, W: int, P: int, depth: int, width: int,
         n_out: int) -> Plan:
    """The design, columns per block and launch shape for P plan rows of
    `n_nodes = n_inputs + G` nodes and n_out taps over W word columns,
    whose schedule has `depth` levels of at most `width` gates.

    The level walk takes every plan whose one-column plane fits in shared
    memory.  Its blocks are latency-bound chains of one barrier a level, so
    C is chosen for the fewest waves of resident blocks (several blocks
    share an SM where their shared memory allows), then for the fewest
    warps walking levels on one SM (they contend for its shared memory),
    then for the fewest columns."""
    best, best_key = None, None
    for C in range(1, min(MAX_COLUMNS, max(W, 1)) + 1):
        smem = level_smem_bytes(n_nodes, G, depth, n_out, C)
        if smem > SMEM_MAX:
            break
        walk, threads = _level_threads(C, width)
        resident = min(SMEM_SM // (smem + SMEM_RESERVED),
                       THREADS_SM // threads, BLOCKS_SM)
        blocks = _cdiv(W, C) * P
        waves = _cdiv(blocks, SMS * resident)
        warps = min(resident, _cdiv(blocks, SMS)) * walk // 32
        if best_key is None or (waves, warps) < best_key:
            best_key = (waves, warps)
            best = Plan("shared_plane", C, walk, threads, (_cdiv(W, C), P),
                        smem, waves, warps)
    if best is None:
        blocks = _cdiv(W, GLOBAL_THREADS) * P
        resident = THREADS_SM // GLOBAL_THREADS
        best = Plan("global_scratch", GLOBAL_THREADS, GLOBAL_THREADS,
                    GLOBAL_THREADS, (_cdiv(W, GLOBAL_THREADS), P), 0,
                    _cdiv(blocks, SMS * resident),
                    min(resident, _cdiv(blocks, SMS)) * GLOBAL_THREADS // 32)
    return best


class Schedule(NamedTuple):
    """A plan's level schedule on its device, in the form the level walk
    reads, with the depth, the widest level and the host milliseconds the
    build took.  Gates are laid out by schedule slot: input id i is plane
    row i and the gate in slot k row `n_inputs + k`.  `rank` `(P, G)` int32
    is each gate's slot; `program` `(P, row_words(G, depth))` int32 is each
    row's buffer, one 16-byte copy for the kernel: `starts` padded to 4,
    then per slot `ent` = (plane row of in0) | (plane row of in1) << 16
    padded to 4, then per slot a byte of ANF coefficient bits (c0, ca, cb,
    cab in bits 0-3) padded to 16.  `order` and `starts` are the schedule
    as `circuit_sim.level_schedule` gives it."""
    depth: int
    width: int
    build_ms: float
    rank: torch.Tensor
    program: torch.Tensor

    @property
    def _offsets(self) -> tuple[int, int]:
        return _round(self.depth + 1, 4), _round(self.rank.shape[1], 4)

    @property
    def order(self) -> torch.Tensor:
        """`(P, G)` gates by slot: the inverse of `rank`."""
        return torch.argsort(self.rank, dim=1).to(torch.int32)

    @property
    def starts(self) -> torch.Tensor:
        """`(P, depth + 1)` level offsets, a view into `program`."""
        return self.program[:, : self.depth + 1]

    @property
    def ent(self) -> torch.Tensor:
        """`(P, Ge)` int32 slot entries, a view into `program`."""
        s0, ge = self._offsets
        return self.program[:, s0:s0 + ge]

    @property
    def bits(self) -> torch.Tensor:
        """`(P, Gb)` uint8 ANF bits of the slots, a view into `program`."""
        s0, ge = self._offsets
        return self.program[:, s0 + ge:].view(torch.uint8)

    def take(self, rows) -> "Schedule":
        """The schedule of plan rows `rows` (with repetition), gathered on
        the schedule's device with no build: a library's schedule serves
        any row selection (`NetlistPopulation.take` of the same rows).
        `depth` and `width` stay the library's, which bound every row's;
        `build_ms` is the library's one build."""
        idx = torch.as_tensor(rows, dtype=torch.int64).to(self.rank.device)
        return self._replace(rank=self.rank.index_select(0, idx),
                             program=self.program.index_select(0, idx))


def _anf_bits() -> np.ndarray:
    """Per opcode, the ANF coefficients (c0, ca, cb, cab) as bits 0-3."""
    nonzero = (CS.ANF_MASKS != 0).numpy().astype(np.uint8)     # (4, N_OPS)
    return (nonzero << np.arange(4, dtype=np.uint8)[:, None]).sum(
        axis=0).astype(np.uint8)


ANF_BITS = _anf_bits()


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _levels_launch(in0: torch.Tensor, in1: torch.Tensor, n_inputs: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """`circuit_levels_kernel` on CUDA int32 `(P, G)` rows, P and G > 0:
    `(levels, meta)`, the deepest level in `meta[0]`."""
    P, G = in0.shape
    dev = in0.device
    if 4 * G > SMEM_MAX:
        raise ValueError(f"{G} gates exceed the level kernel's shared "
                         "memory; such plans take the global-scratch walk")
    levels = torch.empty((P, G), dtype=torch.int32, device=dev)
    meta = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().circuit_levels(in0.data_ptr(), in1.data_ptr(),
                                    levels.data_ptr(), meta.data_ptr(), P, G,
                                    n_inputs, 4 * G, _stream(dev))
    if err:
        raise RuntimeError(f"gate levels launch failed: CUDA error {err}")
    _count(SCHEDULE_LAUNCHES, "gate_levels")
    return levels, meta


def gate_levels(in0: torch.Tensor, in1: torch.Tensor, n_inputs: int
                ) -> torch.Tensor:
    """Logic levels `(P, G)` int32 of feed-forward plan rows on their
    device: inputs at 0, gate g at `1 + max(level(in0), level(in1))`.

    A CPU tensor runs the plain version (`circuit_sim.gate_levels`, which
    also refuses a plan that is not feed-forward), a CUDA tensor launches
    `circuit_levels_kernel` (the plan must be feed-forward, as for the
    walks), anything else raises.
    """
    if in0.device.type == "cpu":
        return torch.from_numpy(CS.gate_levels(in0.numpy(), in1.numpy(),
                                               n_inputs))
    if in0.device.type != "cuda":
        raise ValueError(f"no executor for device {in0.device}")
    if not in0.numel():
        return torch.zeros(in0.shape, dtype=torch.int32, device=in0.device)
    return _levels_launch(*(a.to(torch.int32).contiguous()
                            for a in (in0, in1)), n_inputs)[0]


def _schedule_on_card(op, in0, in1, n_inputs: int) -> Schedule:
    """A raw plan's schedule from `circuit_levels_kernel` and
    `circuit_schedule_kernel`, on CUDA int32 `(P, G)` rows, P and G > 0:
    the same `Schedule` as the tensor-op build, with two waits (the depth,
    then the widest level)."""
    t0 = time.perf_counter()
    P, G = op.shape
    dev = op.device
    levels, meta = _levels_launch(in0, in1, n_inputs)
    depth = int(meta[0])
    smem = 4 * (depth + 1 + G)
    if smem > SMEM_MAX:
        raise ValueError(f"a schedule of {G} gates in {depth} levels "
                         "exceeds the schedule kernel's shared memory")
    s0, ge = _round(depth + 1, 4), _round(G, 4)
    rank = torch.empty((P, G), dtype=torch.int32, device=dev)
    program = torch.zeros((P, row_words(G, depth)), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _lib().circuit_schedule(
            op.data_ptr(), in0.data_ptr(), in1.data_ptr(), levels.data_ptr(),
            rank.data_ptr(), program.data_ptr(), meta.data_ptr(), P, G,
            n_inputs, depth, program.shape[1], s0, ge, smem, _stream(dev))
    if err:
        raise RuntimeError(f"schedule launch failed: CUDA error {err}")
    _count(SCHEDULE_LAUNCHES, "schedule")
    width = int(meta[1])
    return Schedule(depth, width, (time.perf_counter() - t0) * 1e3, rank,
                    program)


def schedule(op, in0, in1, n_inputs: int, levels=None, outputs=None,
             device=None) -> Schedule:
    """Build the level schedule of `(P, G)` plan rows on `device` (None:
    the current CUDA device, raising without one; the CPU when named).

    Given `levels` `(P, G)` (a `CircuitIR`'s, a fleet padding's) are
    validated against the plan and `outputs` on the host before use
    (`circuit_sim.check_levels`) and grouped in tensor ops on `device`:
    once per program or fleet.  Without them, on a CUDA device, the levels
    and the schedule come from two kernels (`circuit_levels_kernel`,
    `circuit_schedule_kernel`), since such a plan is scheduled per call;
    on the CPU the levels come from the plain version and the grouping from
    the same tensor ops.  `build_ms` is the host time of the build, which
    waits for the depth and the widest level.
    """
    t0 = time.perf_counter()
    if levels is not None:
        if outputs is None:
            raise ValueError("validating given levels needs the outputs")
        levels = torch.from_numpy(CS.check_levels(
            _host(in0), _host(in1), _host(outputs), n_inputs, _host(levels)))
    device = resolve_device(device)
    op, in0, in1 = (torch.as_tensor(a).to(device=device, dtype=torch.int32)
                    .contiguous() for a in (op, in0, in1))
    P, G = op.shape
    if levels is None and device.type == "cuda" and P and G:
        return _schedule_on_card(op, in0, in1, n_inputs)
    levels = gate_levels(in0, in1, n_inputs) if levels is None else \
        levels.to(device)
    order, starts, depth, width = CS.level_schedule(levels)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(G, device=device).expand(P, G))

    def plane_row(ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long().gather(1, order)
        gate = rank.gather(1, (ids - n_inputs).clamp(0, max(G - 1, 0)))
        return torch.where(ids < n_inputs, ids, n_inputs + gate) & 0xFFFF

    s0, ge = _round(depth + 1, 4), _round(G, 4)
    program = torch.zeros((P, row_words(G, depth)), dtype=torch.int32,
                          device=device)
    program[:, : depth + 1] = starts
    if P and G:
        ent = plane_row(in0) | (plane_row(in1) << 16)
        program[:, s0:s0 + G] = ent - ((ent >> 31) << 32)   # int32 pattern
        anf = torch.from_numpy(ANF_BITS).to(device)
        program[:, s0 + ge:].view(torch.uint8)[:, :G] = anf[
            op.long().gather(1, order)]
    return Schedule(depth, width, (time.perf_counter() - t0) * 1e3,
                    rank.to(torch.int32), program)


def _count(counts: dict, key: str) -> None:
    with _COUNT_LOCK:
        counts[key] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, VARIANT_LAUNCHES, SCHEDULE_LAUNCHES):
            for k in counts:
                counts[k] = 0


def build_before_spawn(devices) -> None:
    """Build the gate walk's library if any of `devices` (None: the
    current CUDA device) is a card, before a caller spawns processes that
    will launch it there: they then load one library instead of racing
    nvcc on `build/`."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    if any(resolve_device(d).type == "cuda" for d in devices):
        _build.build([SOURCE])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' C signatures declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.circuit_walk.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, ci, ci, ci,
                                 ci, ci, ci, vp]
    lib.circuit_walk.restype = ci
    lib.circuit_level_walk.argtypes = [vp] * 4 + [ci, vp] + [ci] * 14 + [vp]
    lib.circuit_level_walk.restype = ci
    lib.circuit_levels.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.circuit_levels.restype = ci
    lib.circuit_schedule.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.circuit_schedule.restype = ci
    return lib


def _check(op, in0, in1, outputs, words, n_inputs: int) -> tuple:
    """Shape/dtype/device/contiguity checks; returns (P, G, n_out, W)."""
    tensors = {"op": op, "in0": in0, "in1": in1, "outputs": outputs,
               "words": words}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on "
                             f"{words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if op.dim() != 2 or in0.shape != op.shape or in1.shape != op.shape:
        raise ValueError(f"op/in0/in1 must share one (P, G) shape, got "
                         f"{tuple(op.shape)}, {tuple(in0.shape)}, "
                         f"{tuple(in1.shape)}")
    P, G = op.shape
    if outputs.dim() != 2 or outputs.shape[0] != P:
        raise ValueError(f"outputs must be (P={P}, n_out), got "
                         f"{tuple(outputs.shape)}")
    if words.dim() == 2:
        ok = words.shape[0] == n_inputs
    elif words.dim() == 3:
        ok = words.shape[:2] == (P, n_inputs)
    else:
        ok = False
    if not ok:
        raise ValueError(f"words must be ({n_inputs}, W) or ({P}, "
                         f"{n_inputs}, W), got {tuple(words.shape)}")
    return P, G, outputs.shape[1], words.shape[-1]


def _launch(op, in0, in1, outputs, words, n_inputs: int, decode: bool,
            sched: Schedule | None, p: Plan, n_out: int) -> torch.Tensor:
    P, G = op.shape
    W = words.shape[-1]
    if P > MAX_GRID_Y:
        raise ValueError(f"P={P} exceeds the kernel's grid limit "
                         f"{MAX_GRID_Y}")
    if decode and n_out > 32:
        raise ValueError(f"the decode packs at most 32 output bits, got "
                         f"{n_out}")
    dev = words.device
    shape = (P, W * 32) if decode else (P, n_out, W)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if P == 0 or W == 0:
        return out
    per_individual = int(words.dim() == 3)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        if p.variant == "shared_plane":
            s0, ge = sched._offsets
            err = _lib().circuit_level_walk(
                sched.program.data_ptr(), sched.rank.data_ptr(),
                outputs.data_ptr(), words.data_ptr(), per_individual,
                out.data_ptr(), P, G, sched.program.shape[1], s0, ge,
                n_inputs, n_out, W, sched.depth, p.columns, p.level_threads,
                p.threads, p.smem_bytes, int(decode), stream)
        else:
            vals = torch.empty((P, n_inputs + G, W), dtype=torch.int32,
                               device=dev)
            err = _lib().circuit_walk(
                op.data_ptr(), in0.data_ptr(), in1.data_ptr(),
                outputs.data_ptr(), words.data_ptr(), per_individual,
                vals.data_ptr(), out.data_ptr(), P, G, n_inputs, n_out, W,
                int(decode), stream)
    if err:
        raise RuntimeError(f"circuit walk ({p.variant}) launch failed: CUDA "
                           f"error {err}")
    return out


def route(P: int, G: int, W: int, n_inputs: int, n_out: int,
          sched: Schedule | None) -> Plan:
    """The plan of a launch: by the schedule's depth and width where there
    is one, else as the level walk would take a schedule of no levels —
    which fits exactly when some schedule of the plan could."""
    depth, width = (sched.depth, sched.width) if sched else (0, 0)
    return plan(n_inputs + G, G, W, P, depth, width, n_out)


def _run(name: str, decode: bool, op, in0, in1, outputs, words,
         n_inputs: int, sched: Schedule | None) -> torch.Tensor:
    P, G, n_out, W = _check(op, in0, in1, outputs, words, n_inputs)
    if words.device.type == "cpu":
        fn = CS.population_eval_uint if decode else CS.simulate_population
        return fn(op, in0, in1, outputs, words, n_inputs)
    if words.device.type != "cuda":
        raise ValueError(f"no executor for device {words.device}")
    if sched is not None and (sched.rank.shape != (P, G)
                              or sched.rank.device != words.device
                              or sched.program.device != words.device):
        raise ValueError(f"schedule {tuple(sched.rank.shape)} on "
                         f"{sched.rank.device} does not fit the ({P}, {G}) "
                         f"plan on {words.device}")
    p = route(P, G, W, n_inputs, n_out, sched)
    if p.variant == "shared_plane" and sched is None and P and W:
        sched = schedule(op, in0, in1, n_inputs, device=words.device)
        p = route(P, G, W, n_inputs, n_out, sched)
    out = _launch(op, in0, in1, outputs, words, n_inputs, decode, sched, p,
                  n_out)
    if P and W:
        _count(LAUNCHES, name)
        _count(VARIANT_LAUNCHES, p.variant)
    return out


def fused_eval_uint(op, in0, in1, outputs, words, n_inputs: int,
                    schedule: Schedule | None = None) -> torch.Tensor:
    """Fused gate walk + LSB-first decode: `(P, W*32)` int32.

    op/in0/in1 `(P, G)`, outputs `(P, n_out)`, words `(n_inputs, W)` shared
    or `(P, n_inputs, W)` per individual, all int32 on one device.
    `schedule` is the plan's level schedule (`schedule(...)`), built for
    this call when the level walk needs one and none is given.
    """
    return _run("fused_eval_uint", True, op, in0, in1, outputs, words,
                n_inputs, schedule)


def simulate_population(op, in0, in1, outputs, words, n_inputs: int,
                        schedule: Schedule | None = None) -> torch.Tensor:
    """Raw output words `(P, n_out, W)` int32 of the same gate walk."""
    return _run("simulate_population", False, op, in0, in1, outputs, words,
                n_inputs, schedule)


class FleetPlan(NamedTuple):
    """T single-program plans padded into one per-individual launch, on
    one device: `(T, G_max + 1)` op/in0/in1, `(T, n_out_max)` outputs, the
    padded input rows `n_in_max`, each tenant's `n_inputs`, and the padded
    rows' `Schedule`.  Built once per set of plans (`fleet_plan`); each
    dispatch pads only its word planes (`pad_words`)."""
    op: torch.Tensor
    in0: torch.Tensor
    in1: torch.Tensor
    outputs: torch.Tensor
    n_in_max: int
    n_inputs: tuple[int, ...]
    schedule: Schedule

    def pad_words(self, words_list: list[torch.Tensor]
                  ) -> tuple[torch.Tensor, list[int]]:
        """The tenants' word planes zero-padded to `(T, n_in_max, W_max)`
        on their device, and each tenant's W."""
        if len(words_list) != len(self.n_inputs):
            raise ValueError(f"{len(self.n_inputs)} plans but "
                             f"{len(words_list)} word planes")
        for i, (n_in, w) in enumerate(zip(self.n_inputs, words_list)):
            if w.dim() != 2 or w.shape[0] != n_in:
                raise ValueError(f"plan {i}: word plane {tuple(w.shape)} "
                                 f"does not match n_inputs={n_in}")
        W_list = [int(w.shape[1]) for w in words_list]
        words = torch.zeros((len(W_list), self.n_in_max, max(W_list)),
                            dtype=torch.int32, device=words_list[0].device)
        for t, w in enumerate(words_list):
            words[t, : w.shape[0], : w.shape[1]] = w
        return words, W_list


def pad_plans(plans: list, device) -> FleetPlan:
    """Validate T single-program plans and pad them to one gate budget,
    with their schedule, on `device`.

    `plans` holds `(op, in0, in1, outputs, n_inputs)` numpy plans (flat or
    `(1, G)` rows), each checked by `circuit_sim.check_plan`.  Host-side
    padding of `repro.kernels.pallas_circuit_sim.fleet_eval_words`: gate
    budgets padded to `G_max + 1` with a trailing CONST0 gate (a
    known-zero node), gate node ids shifted past the padded input rows
    (`+ n_in_max - n_in`), padded output taps pointed at the zero node.
    The schedule holds each row's own gates by their levels and the zero
    node at level 1 and leaves the padding gates out, so rows of different
    depth end their walks at their own depth.
    """
    T = len(plans)
    n_in_max = max(int(p[4]) for p in plans)
    G_max = max(np.asarray(p[0]).size for p in plans) + 1
    n_out_max = max(np.asarray(p[3]).size for p in plans)

    zero_node = n_in_max + G_max - 1
    op_t = np.full((T, G_max), int(Gate.CONST0), dtype=np.int32)
    in0_t = np.zeros((T, G_max), dtype=np.int32)
    in1_t = np.zeros((T, G_max), dtype=np.int32)
    out_t = np.full((T, n_out_max), zero_node, dtype=np.int32)
    lev_t = np.zeros((T, G_max), dtype=np.int64)
    lev_t[:, -1] = 1

    def remap(idx: np.ndarray, n_in: int) -> np.ndarray:
        return np.where(idx >= n_in, idx + (n_in_max - n_in), idx)

    for t, (op, in0, in1, outputs, n_in) in enumerate(plans):
        op, in0, in1, outputs = CS.check_plan(
            *(np.reshape(a, (1, -1)) for a in (op, in0, in1, outputs)),
            int(n_in))
        G = op.shape[1]
        op_t[t, :G] = op[0]
        in0_t[t, :G] = remap(in0[0], n_in)
        in1_t[t, :G] = remap(in1[0], n_in)
        out_t[t, : outputs.shape[1]] = remap(outputs[0], n_in)
        lev_t[t, :G] = CS.gate_levels(in0, in1, int(n_in))[0]
    sched = schedule(op_t, in0_t, in1_t, n_in_max, levels=lev_t,
                     outputs=out_t, device=device)
    plan_t = [torch.from_numpy(a).to(device)
              for a in (op_t, in0_t, in1_t, out_t)]
    return FleetPlan(*plan_t, n_in_max, tuple(int(p[4]) for p in plans),
                     sched)


_FLEETS: OrderedDict[tuple, FleetPlan] = OrderedDict()
_FLEETS_LOCK = threading.Lock()


def fleet_plan(plans: list, device) -> FleetPlan:
    """`pad_plans` of `plans` on `device`, built on the first call with
    these plans and returned from a cache, keyed by the plans' contents,
    on later ones (the last `FLEET_CACHE` sets are kept).  Safe to call
    from several dispatch threads: a set of plans is padded once."""
    h = hashlib.blake2b(digest_size=16)
    for p in plans:
        h.update(repr(int(p[4])).encode())
        for a in p[:4]:
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(memoryview(a).cast("B"))
    key = (str(torch.device(device)), h.hexdigest())
    with _FLEETS_LOCK:
        fleet = _FLEETS.get(key)
        if fleet is None:
            fleet = _FLEETS[key] = pad_plans(plans, device)
            while len(_FLEETS) > FLEET_CACHE:
                _FLEETS.popitem(last=False)
        else:
            _FLEETS.move_to_end(key)
    return fleet


def fleet_eval_words(plans: list, words_list: list[torch.Tensor]
                     ) -> list[torch.Tensor]:
    """T tenants' circuits over T word planes in ONE kernel launch.

    `plans` holds `(op, in0, in1, outputs, n_inputs)` numpy plans (flat or
    `(1, G)` rows), `words_list` each tenant's `(n_inputs_t, W_t)` int32
    word plane, all on one device.  The padded plans and their schedule
    come from `fleet_plan`: built once per set of plans, reused by every
    later dispatch.  Returns one `(W_t * 32,)` int32 tensor per tenant,
    equal to running each plan through `fused_eval_uint` alone.
    """
    if not plans:
        return []
    if len(plans) != len(words_list):
        raise ValueError(f"{len(plans)} plans but {len(words_list)} word "
                         "planes")
    fleet = fleet_plan(plans, words_list[0].device)
    words, W_list = fleet.pad_words(words_list)
    out = _run("fleet_eval_words", True, *fleet[:4], words, fleet.n_in_max,
               fleet.schedule)
    return [out[t, : W_list[t] * 32] for t in range(len(W_list))]
