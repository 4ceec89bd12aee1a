"""`CircuitProgram`: batched bit-packed execution of a compiled circuit.

The port's `repro.compile.program.CircuitProgram`.  A program lives on one
device (`device=None` is the current CUDA device, and raises without one).
Raw sensor floats are compared with the ABC thresholds in float64 on that
device (the reference promotes float32 readings to float64 the same way),
packed 32 readings per int32 word on the device, and evaluated through
`kernels.dispatch.program_eval_words`: the CUDA fused gate-walk kernel on
the card, the plain PyTorch version on the CPU.  Labels come back to the
host as numpy arrays, bit-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.compile.ir import CircuitIR
from repro_torch.device import resolve_device
from repro_torch.kernels import circuit_sim as CS
from repro_torch.kernels import cuda_circuit_sim as CK
from repro_torch.kernels import dispatch as D


@dataclass
class CircuitProgram:
    """An executable compiled circuit (optionally a full classifier)."""

    ir: CircuitIR
    thresholds: np.ndarray | None = None   # (F,) ABC V_q — classifier only
    n_classes: int | None = None
    device: torch.device | str | None = None
    _plan: tuple = field(default=(), repr=False)
    _thr: torch.Tensor | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ir.to_netlist()    # feed-forward check before any kernel runs
        self._plan = D.check_plan(self.ir.op[None], self.ir.in0[None],
                                  self.ir.in1[None], self.ir.outputs[None],
                                  self.ir.n_inputs)
        if self.thresholds is not None:
            self.thresholds = np.asarray(self.thresholds, dtype=np.float64)
            self._thr = torch.from_numpy(self.thresholds).to(self.device)

    @classmethod
    def from_classifier(cls, cc, device=None) -> "CircuitProgram":
        """From any object with `ir`, `thresholds` and `n_classes` (the
        reference `CompiledClassifier` fields)."""
        return cls(ir=cc.ir, thresholds=cc.thresholds,
                   n_classes=cc.n_classes, device=device)

    # -- plan access ---------------------------------------------------------
    def plan(self) -> tuple:
        """`(op, in0, in1, outputs, n_inputs)` flat plan arrays — the tuple
        `kernels.dispatch.fleet_eval_words` takes."""
        return (self.ir.op.astype(np.int16), self.ir.in0.astype(np.int32),
                self.ir.in1.astype(np.int32),
                self.ir.outputs.astype(np.int32), self.ir.n_inputs)

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def pack_input_bits(self, xbin) -> torch.Tensor:
        """Binarized readings `(S, F)` -> packed `(F, ceil(S/32))` int32
        words on the program's device (the kernels' word-plane layout)."""
        return CS.pack_bits32(self._on_device(xbin))

    def binarize(self, x) -> torch.Tensor:
        """Raw readings `(S, F)` -> 0/1 uint8 on the program's device via
        the ABC thresholds (strict `>`, compared in float64)."""
        if self._thr is None:
            raise ValueError("program has no ABC thresholds")
        x = self._on_device(x).to(torch.float64)
        return (x > self._thr[None, :]).to(torch.uint8)

    # -- execution ----------------------------------------------------------
    def _eval_words32(self, words) -> np.ndarray:
        out = D.program_eval_words(*self._plan, words, self.ir.n_inputs,
                                   devices=(self.device,))
        return out[0]

    def eval_uint(self, packed_u64: np.ndarray) -> np.ndarray:
        """`(n_inputs, W)` uint64 packed vectors -> `(W*64,)` int64 decoded
        outputs (LSB-first)."""
        return self._eval_words32(CS.pack_words32(packed_u64))

    def eval_bits(self, bits) -> np.ndarray:
        """`(S, n_inputs)` 0/1 matrix -> `(S,)` int64 decoded outputs."""
        S = bits.shape[0]
        return self._eval_words32(self.pack_input_bits(bits))[:S]

    # -- classifier inference ----------------------------------------------
    def predict_bits(self, xbin) -> np.ndarray:
        """Binarized readings `(S, F)` -> class labels `(S,)` int32."""
        if self.n_classes is None:
            raise ValueError("not a classifier program")
        return self.eval_bits(xbin).astype(np.int32)

    def predict(self, x) -> np.ndarray:
        """Raw sensor readings `(S, F)` -> class labels `(S,)` int32."""
        return self.predict_bits(self.binarize(x))

    def scores(self, xbin) -> np.ndarray:
        """Per-class XNOR-match scores `(S, C)` int64 from the score taps.

        Runs the words-only kernel (`simulate_population`) re-rooted at the
        `(C, j)` score tap plane, then decodes each class's j bits LSB-first.
        """
        if "score" not in self.ir.taps:
            raise ValueError("program has no score taps")
        tap = np.asarray(self.ir.taps["score"], dtype=np.int32)   # (C, j)
        Cc, j = tap.shape
        S = xbin.shape[0]
        plan = D.check_plan(self._plan[0], self._plan[1], self._plan[2],
                            tap.reshape(1, -1), self.ir.n_inputs)
        plan = [torch.from_numpy(a).to(self.device) for a in plan]
        words = self.pack_input_bits(xbin)
        outw = CK.simulate_population(*plan, words, self.ir.n_inputs)
        ints = CS.decode_words(outw.reshape(Cc, j, -1))          # (C, W*32)
        return ints[:, :S].T.cpu().numpy().astype(np.int64)
