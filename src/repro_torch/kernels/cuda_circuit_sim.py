"""Wrappers of the hand-written CUDA gate-walk kernel (`csrc/circuit_sim.cu`).

Replaces the Pallas kernels of `repro/kernels/pallas_circuit_sim.py`:

  * `fused_eval_uint` — `_fused_kernel`: gate walk, output taps and the
    LSB-first decode in one launch, `(P, W*32)` int32;
  * `simulate_population` — `_kernel`: the same walk, raw output words
    `(P, n_out, W)` int32;
  * `fleet_eval_words` — the multi-tenant megakernel: T tenants' plans
    padded to one gate budget and run as one `fused_eval_uint` launch.

What bounds the kernel and what its design does about it is set out at the
top of the CUDA source.  The tensor's device picks the executor: a CPU
tensor runs the plain version in `circuit_sim`, a CUDA tensor launches the
kernel, anything else raises.  Each wrapper counts its own launches in
`LAUNCHES`.

Contract on values (checked by the callers that build plans, not here,
because checking device tensors would stall the stream): opcodes in
[0, 13) and a feed-forward plan — `in0`/`in1` of gate g below
`n_inputs + g`, `outputs` below `n_inputs + G`.  `dispatch.check_plan`
and `Netlist.validate` enforce it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.hw.egfet import Gate
from repro_torch.kernels import circuit_sim as CS

SOURCE = "circuit_sim.cu"
LAUNCHES = {"fused_eval_uint": 0, "simulate_population": 0,
            "fleet_eval_words": 0}
MAX_GRID_Y = 65535


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with `circuit_walk`'s C signature declared."""
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.circuit_walk.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, ci, ci, ci,
                                 ci, ci, ci, vp]
    lib.circuit_walk.restype = ci
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
            P: int, G: int, n_out: int, W: int) -> torch.Tensor:
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
    with torch.cuda.device(dev):
        vals = torch.empty((P, n_inputs + G, W), dtype=torch.int32,
                           device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().circuit_walk(
            op.data_ptr(), in0.data_ptr(), in1.data_ptr(),
            outputs.data_ptr(), words.data_ptr(), int(words.dim() == 3),
            vals.data_ptr(), out.data_ptr(), P, G, n_inputs, n_out, W,
            int(decode), stream)
    if err:
        raise RuntimeError(f"circuit_walk launch failed: CUDA error {err}")
    return out


def _run(name: str, decode: bool, op, in0, in1, outputs, words,
         n_inputs: int) -> torch.Tensor:
    P, G, n_out, W = _check(op, in0, in1, outputs, words, n_inputs)
    if words.device.type == "cpu":
        fn = CS.population_eval_uint if decode else CS.simulate_population
        return fn(op, in0, in1, outputs, words, n_inputs)
    if words.device.type != "cuda":
        raise ValueError(f"no executor for device {words.device}")
    out = _launch(op, in0, in1, outputs, words, n_inputs, decode, P, G,
                  n_out, W)
    if P and W:
        LAUNCHES[name] += 1
    return out


def fused_eval_uint(op, in0, in1, outputs, words, n_inputs: int
                    ) -> torch.Tensor:
    """Fused gate walk + LSB-first decode: `(P, W*32)` int32.

    op/in0/in1 `(P, G)`, outputs `(P, n_out)`, words `(n_inputs, W)` shared
    or `(P, n_inputs, W)` per individual, all int32 on one device.
    """
    return _run("fused_eval_uint", True, op, in0, in1, outputs, words,
                n_inputs)


def simulate_population(op, in0, in1, outputs, words, n_inputs: int
                        ) -> torch.Tensor:
    """Raw output words `(P, n_out, W)` int32 of the same gate walk."""
    return _run("simulate_population", False, op, in0, in1, outputs, words,
                n_inputs)


def pad_fleet(plans: list, words_list: list[torch.Tensor]) -> tuple:
    """Pad T single-program plans into one per-individual launch.

    Host-side padding of `repro.kernels.pallas_circuit_sim.fleet_eval_words`:
    gate budgets padded to `G_max + 1` with a trailing CONST0 gate (a
    known-zero node), gate node ids shifted past the padded input rows
    (`+ n_in_max - n_in`), padded output taps pointed at the zero node,
    word planes zero-padded to `(T, n_in_max, W_max)` on the words'
    device.  Returns `(op, in0, in1, outputs, words, n_in_max, W_list)`.
    """
    T = len(plans)
    dev = words_list[0].device
    n_in_max = max(int(p[4]) for p in plans)
    G_max = max(np.asarray(p[0]).size for p in plans) + 1
    n_out_max = max(np.asarray(p[3]).size for p in plans)
    W_list = [int(w.shape[1]) for w in words_list]
    W_max = max(W_list)

    zero_node = n_in_max + G_max - 1
    op_t = np.full((T, G_max), int(Gate.CONST0), dtype=np.int32)
    in0_t = np.zeros((T, G_max), dtype=np.int32)
    in1_t = np.zeros((T, G_max), dtype=np.int32)
    out_t = np.full((T, n_out_max), zero_node, dtype=np.int32)
    words_t = torch.zeros((T, n_in_max, W_max), dtype=torch.int32,
                          device=dev)

    def remap(idx: np.ndarray, n_in: int) -> np.ndarray:
        return np.where(idx >= n_in, idx + (n_in_max - n_in), idx)

    for t, ((op, in0, in1, outputs, n_in), w) in enumerate(
            zip(plans, words_list)):
        op = np.asarray(op).reshape(-1)
        G = op.shape[0]
        op_t[t, :G] = op
        in0_t[t, :G] = remap(np.asarray(in0).reshape(-1), n_in)
        in1_t[t, :G] = remap(np.asarray(in1).reshape(-1), n_in)
        outputs = np.asarray(outputs).reshape(-1)
        out_t[t, : outputs.shape[0]] = remap(outputs, n_in)
        words_t[t, :n_in, : w.shape[1]] = w
    plan = [torch.from_numpy(a).to(dev) for a in (op_t, in0_t, in1_t, out_t)]
    return (*plan, words_t, n_in_max, W_list)


def fleet_eval_words(plans: list, words_list: list[torch.Tensor]
                     ) -> list[torch.Tensor]:
    """T tenants' circuits over T word planes in ONE kernel launch.

    `plans` holds `(op, in0, in1, outputs, n_inputs)` numpy plans (flat or
    `(1, G)` rows), `words_list` each tenant's `(n_inputs_t, W_t)` int32
    word plane, all on one device.  Returns one `(W_t * 32,)` int32 tensor
    per tenant, equal to running each plan through `fused_eval_uint` alone.
    """
    if not plans:
        return []
    if len(plans) != len(words_list):
        raise ValueError(f"{len(plans)} plans but {len(words_list)} word "
                         "planes")
    for i, ((*_, n_in), w) in enumerate(zip(plans, words_list)):
        if w.dim() != 2 or w.shape[0] != n_in:
            raise ValueError(f"plan {i}: word plane {tuple(w.shape)} does "
                             f"not match n_inputs={n_in}")
    op, in0, in1, outputs, words, n_in_max, W_list = pad_fleet(
        plans, words_list)
    out = _run("fleet_eval_words", True, op, in0, in1, outputs, words,
               n_in_max)
    return [out[t, : W_list[t] * 32] for t in range(len(plans))]
