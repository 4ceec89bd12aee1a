"""Baselines the paper compares against (Tables 2-3).

The port of `repro.core.baselines`.

* Exact bespoke MLP [Mubarik et al., MICRO'20]: 4-bit inputs, 8-bit weights,
  hardwired multipliers (shift-add trees), ReLU, argmax.
* Power-of-2 Ax MLP [Afentaki et al., ICCAD'23/DATE'24]: weights constrained
  to ±2^k (multiplication = rewiring), truncated accumulation, low-precision
  activation.

Both are (a) trained with QAT on the same synthetic datasets, on the
caller's device (`device=None` is the current CUDA device), and (b) costed
with the same EGFET gate model used for the TNNs, via an adder-tree area
estimator for bespoke MAC hardware.  The cost half is the reference's numpy
code as it is.  Training keeps the reference's numpy RNG streams (the
initial weights, then one permutation an epoch), its straight-through
quantizers (`w + (q - w).detach()`, round half to even) and its optimizer
(`optim.adamw`); every epoch's permutation goes up to the device once, and
a step never waits for the host.  The published Table-3 numbers are
carried verbatim (`PAPER_TABLE3`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.tabular import TabularDataset
from repro_torch.device import resolve_device
from repro_torch.hw.egfet import Gate, HwCost, gate_cost, interface_cost
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

BATCH = 64


# ---------------------------------------------------------------------------
# Area model for bespoke arithmetic (EGFET)
# ---------------------------------------------------------------------------
_FA = (gate_cost(Gate.XOR).scale(2) + gate_cost(Gate.AND).scale(2)
       + gate_cost(Gate.OR))           # full adder


def adder_cost(width: int) -> HwCost:
    """Ripple adder of `width` bits (bespoke, carry chain of FAs)."""
    return _FA.scale(max(width, 1))


def shift_add_multiplier_cost(w: int, in_bits: int) -> HwCost:
    """Hardwired multiply of an `in_bits` input by constant w: one shifted
    add per set bit beyond the first (bespoke constant multiplier)."""
    ones = bin(abs(int(w))).count("1")
    if ones <= 1:
        return HwCost(0.0, 0.0)        # power of two: pure rewiring
    width = in_bits + max(abs(int(w)).bit_length(), 1)
    return adder_cost(width).scale(ones - 1)


def accumulator_tree_cost(n_addends: int, width: int) -> HwCost:
    """Adder tree over n addends of `width` bits (width grows up the tree)."""
    total = HwCost(0.0, 0.0)
    level_w = width
    n = n_addends
    while n > 1:
        total = total + adder_cost(level_w).scale(n // 2)
        n = (n + 1) // 2
        level_w += 1
    return total


def relu_cost(width: int) -> HwCost:
    # sign check + AND gating per bit
    return gate_cost(Gate.AND).scale(width)


def mlp_hw_cost(weights: list[np.ndarray], in_bits: int, w_bits: int,
                pow2: bool, interface: str | None) -> HwCost:
    """Bespoke MLP cost: hardwired multipliers + accumulation + ReLU/argmax."""
    total = HwCost(0.0, 0.0)
    bits = in_bits
    for li, W in enumerate(weights):
        fan_in, n_out = W.shape
        acc_w = bits + int(np.ceil(np.log2(max(fan_in, 2)))) + w_bits
        for o in range(n_out):
            col = W[:, o]
            nz = col[col != 0]
            if not pow2:
                for w in nz:
                    total = total + shift_add_multiplier_cost(int(w), bits)
            total = total + accumulator_tree_cost(max(len(nz), 1), acc_w)
            if li < len(weights) - 1:
                total = total + relu_cost(acc_w)
        bits = min(acc_w, 8)           # low-precision inter-layer activation
    # argmax comparators over the last layer
    n_cls = weights[-1].shape[1]
    cmp_w = bits
    total = total + (adder_cost(cmp_w) + gate_cost(Gate.AND).scale(cmp_w)
                     ).scale(max(n_cls - 1, 1))
    if interface:
        total = total + interface_cost(weights[0].shape[0], interface)
    return total


# ---------------------------------------------------------------------------
# QAT training for the two baselines
# ---------------------------------------------------------------------------
def _quant_input_4bit(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, 0, 1) * 15.0) / 15.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """`x` as a float32 scalar filled on `like`'s device: a tensor divisor
    keeps CUDA from multiplying by a reciprocal, and a fill waits for no
    copy from the host."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _int_ste(w: torch.Tensor, bits: int) -> torch.Tensor:
    lim = 2.0 ** (bits - 1) - 1
    q = torch.clamp(torch.round(w * lim), -lim, lim) / _f32(lim, w)
    return w + (q - w).detach()


# The float32 values at which the reference's `round(log2(mag))` steps up
# to -2, -1 and 0 over [2^-3, 1]: found by scanning every float32 there
# through XLA's float32 `log2` on the CPU, whose result is monotone.  The
# true steps 2^(k + 1/2) are irrational; XLA's last bits put its first two
# steps one float32 off them (at 2^-2.5 its log2 reads -2.5 and the tie
# goes to -2; just above 2^-1.5 it reads -1.5 and goes to -2).
_POW2_STEPS = (float.fromhex("0x1.6a09e6p-3"),     # 0.17677669 -> -2
               float.fromhex("0x1.6a09eap-2"),     # 0.35355344 -> -1
               float.fromhex("0x1.6a09e8p-1"))     # 0.70710683 -> 0


def _pow2_exponent(mag: torch.Tensor) -> torch.Tensor:
    """`round(log2(mag))` for float32 `mag` in [2^-3, 1], decided by
    comparison with the reference's steps rather than through a float32
    `log2`, whose last-bit errors differ between libraries and devices:
    bit for bit the reference's exponent, on every device."""
    k = torch.full_like(mag, -3.0)
    for step in _POW2_STEPS:
        k = k + (mag >= step).to(mag.dtype)
    return k


def _pow2_ste(w: torch.Tensor) -> torch.Tensor:
    mag = torch.clamp(w.abs(), 2.0 ** -3, 1.0)
    q = torch.sign(w) * torch.exp2(_pow2_exponent(mag))
    q = torch.where(w.abs() < 2.0 ** -4, torch.zeros_like(q), q)
    return w + (q - w).detach()


def quantizer(pow2: bool, w_bits: int = 8):
    """The straight-through weight quantizer of one baseline."""
    return _pow2_ste if pow2 else (lambda w: _int_ste(w, w_bits))


def forward(params: dict[str, torch.Tensor], x: torch.Tensor,
            pow2: bool, w_bits: int = 8) -> torch.Tensor:
    """Logits of the quantized MLP: `relu(x @ q(w1)) @ q(w2)`."""
    quant = quantizer(pow2, w_bits)
    h = torch.relu(x @ quant(params["w1"]))
    return h @ quant(params["w2"])


def loss_and_grads(params: dict[str, torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor, pow2: bool, w_bits: int = 8
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The mean negative log-softmax at the label, and its gradients with
    respect to each latent weight."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    lp = torch.log_softmax(forward(leaves, x, pow2, w_bits), dim=-1)
    loss = -torch.mean(torch.take_along_dim(lp, y[:, None].long(), dim=1))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@dataclass
class TrainedMLP:
    weights_int: list[np.ndarray]    # integer (or pow2-integer) hardware weights
    test_acc: float
    pow2: bool
    in_bits: int
    w_bits: int

    def cost(self, interface: str | None = "adc4") -> HwCost:
        return mlp_hw_cost(self.weights_int, self.in_bits, self.w_bits,
                           self.pow2, interface)


def train_mlp_latents(ds: TabularDataset, hidden: int, *, pow2: bool = False,
                      epochs: int = 15, lr: float = 5e-3, seed: int = 0,
                      w_bits: int = 8, device=None
                      ) -> dict[str, torch.Tensor]:
    """The QAT loop of `train_mlp_baseline`: the latent weights
    `{"w1": (F, hidden), "w2": (hidden, C)}` on the device after `epochs`
    epochs of batches of 64 (the last of an epoch short).

    The quantized training set, the labels and every epoch's permutation
    live on the device, and the loop never waits for the host.  Float32
    products must run in full float32 (TF32 off), as the reference's do.
    """
    dev = resolve_device(device)
    F, C = ds.spec.n_features, ds.spec.n_classes
    rng = np.random.default_rng(seed)
    params = {k: torch.as_tensor(a).to(device=dev, dtype=torch.float32)
              for k, a in (("w1", rng.normal(0, 0.3, (F, hidden))),
                           ("w2", rng.normal(0, 0.3, (hidden, C))))}
    ocfg = AdamWConfig(lr=lr)
    state = adamw.init(params)
    x = torch.from_numpy(np.asarray(_quant_input_4bit(ds.x_train),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(ds.y_train.astype(np.int64)).to(dev)
    n = x.shape[0]
    perms = torch.from_numpy(np.stack(
        [rng.permutation(n) for _ in range(epochs)])).to(dev)
    for epoch in range(epochs):
        for s in range(0, n, BATCH):
            idx = perms[epoch, s:s + BATCH]
            _, grads = loss_and_grads(params, x[idx], y[idx], pow2, w_bits)
            params, state = adamw.apply_updates(params, grads, state, ocfg)
    return params


def train_mlp_baseline(ds: TabularDataset, hidden: int, *, pow2: bool = False,
                       epochs: int = 15, lr: float = 5e-3, seed: int = 0,
                       w_bits: int = 8, device=None) -> TrainedMLP:
    """QAT of one baseline MLP on `device` (None: the current CUDA device),
    then its test accuracy and integer hardware weights on the host."""
    dev = resolve_device(device)
    params = train_mlp_latents(ds, hidden, pow2=pow2, epochs=epochs, lr=lr,
                               seed=seed, w_bits=w_bits, device=dev)
    xq_te = _quant_input_4bit(ds.x_test)
    with torch.no_grad():
        x_te = torch.from_numpy(np.asarray(xq_te, dtype=np.float32)).to(dev)
        logits = forward(params, x_te, pow2, w_bits).cpu().numpy()
        quant = quantizer(pow2, w_bits)
        wq = [quant(params[k]).cpu().numpy() for k in ("w1", "w2")]
    acc = float((np.argmax(logits, axis=-1) == ds.y_test).mean())
    lim = 2 ** (w_bits - 1) - 1

    def to_int(w):
        if pow2:
            return np.round(w * 8).astype(np.int32)   # pow2 grid, 1/8 lsb
        return np.round(w * lim).astype(np.int32)

    return TrainedMLP(weights_int=[to_int(w) for w in wq], test_acc=acc,
                      pow2=pow2, in_bits=4, w_bits=w_bits)


# ---------------------------------------------------------------------------
# Published Table 3 rows (reference comparison values from the paper)
# area cm^2 / power mW, w/o interface cost
# ---------------------------------------------------------------------------
PAPER_TABLE3 = {
    "arrhythmia": {"exact_mlp": (62, 266.00, 998.00),
                   "ax_mlp": (60, 13.51, 12.80),
                   "our_exact_tnn": (60, 8.87, 8.09),
                   "our_ax_tnn": (60, 7.73, 7.12)},
    "breast_cancer": {"exact_mlp": (98, 12.00, 40.00),
                      "ax_mlp": (94, 0.03, 0.03),
                      "our_exact_tnn": (98, 0.29, 0.31),
                      "our_ax_tnn": (98, 0.05, 0.04)},
    "cardio": {"exact_mlp": (88, 33.40, 124.20),
               "ax_mlp": (87, 1.46, 1.70),
               "our_exact_tnn": (85, 0.75, 0.91),
               "our_ax_tnn": (85, 0.36, 0.42)},
    "redwine": {"exact_mlp": (56, 17.60, 73.50),
                "ax_mlp": (55, 0.03, 0.02),
                "our_exact_tnn": (56, 0.08, 0.09),
                "our_ax_tnn": (56, 0.03, 0.03)},
    "whitewine": {"exact_mlp": (54, 31.20, 126.40),
                  "ax_mlp": (51, 0.23, 0.25),
                  "our_exact_tnn": (50, 0.16, 0.18),
                  "our_ax_tnn": (50, 0.11, 0.12)},
}
