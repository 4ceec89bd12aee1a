"""`CircuitProgram`: batched bit-packed execution of a compiled circuit.

The port's `repro.compile.program.CircuitProgram`.  A program lives on one
device (`device=None` is the current CUDA device, and raises without one).
Raw sensor floats are compared with the ABC thresholds in float64 on that
device (the reference promotes float32 readings to float64 the same way),
packed 32 readings per int32 word on the device, and evaluated by
`kernels.cuda_circuit_sim.fused_eval_uint`: the CUDA level walk on the
card, the plain PyTorch version on the CPU.  The program checks its plan
once, keeps it on its device, and holds its level `schedule` (built once
from `ir.levels`, which are validated first), so a dispatch uploads and
builds nothing.  Labels come back to the host as numpy arrays,
bit-identical to the reference's.
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
    _score_taps: torch.Tensor | None = field(default=None, repr=False)
    _thr: torch.Tensor | None = field(default=None, repr=False)
    schedule: CK.Schedule | None = field(default=None, init=False,
                                         repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ir.to_netlist()    # feed-forward check before any kernel runs
        plan = D.check_plan(self.ir.op[None], self.ir.in0[None],
                            self.ir.in1[None], self.ir.outputs[None],
                            self.ir.n_inputs)
        self._plan = tuple(self._on_device(a) for a in plan)
        self.schedule = CK.schedule(*plan[:3], self.ir.n_inputs,
                                    levels=self.ir.levels[None],
                                    outputs=plan[3], device=self.device)
        if "score" in self.ir.taps:
            tap = np.asarray(self.ir.taps["score"], dtype=np.int32)
            taps = D.check_plan(*plan[:3], tap.reshape(1, -1),
                                self.ir.n_inputs)[3]
            self._score_taps = self._on_device(taps)
        if self.thresholds is not None:
            self.thresholds = np.asarray(self.thresholds, dtype=np.float64)
            self._thr = torch.from_numpy(self.thresholds).to(self.device)

    @classmethod
    def from_netlist(cls, nl, device=None) -> "CircuitProgram":
        """Compile a bare netlist (DCE + levelize) into a program."""
        from repro_torch.compile.ir import lower_netlist
        return cls(ir=lower_netlist(nl), device=device)

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
    def eval_words(self, words32) -> np.ndarray:
        """Packed `(n_inputs, W)` words (uint32 numpy or an int32 tensor) ->
        `(W*32,)` int64 decoded outputs (LSB-first), through the plan and
        schedule the program holds on its device."""
        if words32.ndim != 2:
            raise ValueError("eval_words wants a shared (n_inputs, W) word "
                             "plane")
        words = CS.words_tensor(words32, self.device)
        out = CK.fused_eval_uint(*self._plan, words, self.ir.n_inputs,
                                 schedule=self.schedule)
        return out[0].cpu().numpy().astype(np.int64)

    def eval_uint(self, packed_u64: np.ndarray) -> np.ndarray:
        """`(n_inputs, W)` uint64 packed vectors -> `(W*64,)` int64 decoded
        outputs (LSB-first)."""
        return self.eval_words(CS.pack_words32(packed_u64))

    def eval_bits(self, bits) -> np.ndarray:
        """`(S, n_inputs)` 0/1 matrix -> `(S,)` int64 decoded outputs."""
        S = bits.shape[0]
        return self.eval_words(self.pack_input_bits(bits))[:S]

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
        if self._score_taps is None:
            raise ValueError("program has no score taps")
        Cc, j = np.shape(self.ir.taps["score"])
        S = xbin.shape[0]
        words = self.pack_input_bits(xbin)
        outw = CK.simulate_population(*self._plan[:3], self._score_taps,
                                      words, self.ir.n_inputs,
                                      schedule=self.schedule)
        ints = CS.decode_words(outw.reshape(Cc, j, -1))          # (C, W*32)
        return ints[:, :S].T.cpu().numpy().astype(np.int64)
