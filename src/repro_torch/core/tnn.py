"""Bespoke ternary neural networks (Sec. 3.2): QAT and the circuit path.

The port of `repro.core.tnn`: quantization-aware training (`train_tnn`, on
the device it is given), the exact integer path, the exact hidden-neuron
PCC netlists, circuit-accurate inference through chosen netlists, the EGFET
system cost and the NSGA-II integration problem of Phase 3.  A
`TrainedTNN` comes from `train_tnn`, or from arrays (`tnn_from_arrays`,
`load_tnn` of a `<name>_tnn.npz` file that `tools/emit_golden_tnn.py`
wrote from the reference's trainer).

Training draws its parameters and every epoch's permutation from one
`np.random.default_rng(cfg.seed)` in the reference's order and computes
the reference's float32 expressions with autograd and `optim.adamw`.  The
two frameworks sum matrix products in different orders, so a gradient
entry that cancels to the noise floor can take another sign, and AdamW's
first step `g / (|g| + eps)` turns that into a step of up to ~0.2 lr: a
trained TNN equals the reference's where the trajectory holds, and is
held to an accuracy tolerance where it does not.  Everything downstream of
a given `TrainedTNN` is bit-exact.

Semantics (and the invariant the tests pin down):

  hidden neuron i :  h'_i = +1  iff  sum_{w=+1} x - sum_{w=-1} x >= 0
                     == PCC( x[w=+1], x[w=-1] )            (Eq. 2)
  output neuron o :  score_o = #XNOR matches = (logits_o + nnz_o) / 2
                     where logits_o = sum_i w_io h'_i
  With zero counts balanced across output neurons (same N), nnz_o is the
  same constant, so  argmax(score) == argmax(logits).

`TNNApproxProblem` keeps its fitness on `device`: the hidden neurons'
candidate outputs over the training set are computed once (one launch a
neuron) and stay there, and `objective` scores a whole population's
output neurons in ONE launch of the gate walk over P x C rows, gathering
the output library's plan and level schedule by gene.  Estimated areas
are summed on the host in the reference's order, so the objectives equal
the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import circuits as C
from repro_torch.core.nsga2 import NSGA2Config, NSGA2Result, nsga2
from repro_torch.core.pcc import PCCEntry, PCCLibrary
from repro_torch.core.ternary import (
    TERNARY_THRESHOLD,
    abc_binarize,
    abc_fit_thresholds,
    binary_step_ste,
    ternarize,
    ternary_ste,
)
from repro_torch.data.tabular import TabularDataset
from repro_torch.device import resolve_device
from repro_torch.hw.egfet import Gate, HwCost, gate_cost, interface_cost
from repro_torch.kernels import circuit_sim as CS
from repro_torch.kernels import cuda_circuit_sim as CK
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# Training (QAT)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TNNTrainConfig:
    n_hidden: int
    epochs: int = 15            # paper: 10-20
    lr: float = 5e-3            # paper: 1e-3..1e-2 (Bayesian-opt'd)
    batch_size: int = 64
    seed: int = 0
    threshold: float = TERNARY_THRESHOLD
    weight_decay: float = 0.0


@dataclass
class TrainedTNN:
    w1t: np.ndarray             # (F, H) int8 ternary codes
    w2t: np.ndarray             # (H, C) int8, zero-balanced columns
    thresholds: np.ndarray      # (F,) ABC V_q per feature
    train_acc: float
    test_acc: float
    name: str = ""

    @property
    def topology(self) -> tuple[int, int, int]:
        return (self.w1t.shape[0], self.w1t.shape[1], self.w2t.shape[1])

    def hidden_sizes(self) -> list[tuple[int, int]]:
        return [(int((self.w1t[:, i] == 1).sum()), int((self.w1t[:, i] == -1).sum()))
                for i in range(self.w1t.shape[1])]

    @property
    def out_nnz(self) -> int:
        """Non-zero inputs per output neuron (equal across neurons)."""
        nnz = (self.w2t != 0).sum(axis=0)
        assert (nnz == nnz[0]).all(), "output zero counts not balanced"
        return int(nnz[0])


def _sqrt_f32(n: int, like: torch.Tensor) -> torch.Tensor:
    """sqrt(n) in float32 on `like`'s device, as `jnp.sqrt(float(n))`.  A
    tensor divisor on the device keeps CUDA from multiplying by a
    reciprocal, and `torch.full` fills it there with no host copy (a copy
    from pageable memory would wait for the stream)."""
    return torch.sqrt(torch.full((), float(n), dtype=torch.float32,
                                 device=like.device))


def _forward_logits(params, xbin, threshold):
    w1q = ternary_ste(params["w1"], threshold)
    a = xbin @ w1q
    # surrogate-gradient window scaled to the integer popcount-sum magnitude,
    # otherwise hidden units saturate and w1 receives no learning signal
    h = binary_step_ste(a, grad_width=_sqrt_f32(xbin.shape[-1], a))
    w2q = ternary_ste(params["w2"], threshold)
    return h @ w2q, h


def _loss_fn(params, xbin, y, threshold, n_hidden):
    logits, _ = _forward_logits(params, xbin, threshold)
    logits = logits / _sqrt_f32(n_hidden, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logp, y[:, None].long(), dim=1))


def params_from_arrays(arrays: dict, device=None) -> dict[str, torch.Tensor]:
    """The latent weights `{"w1": (F, H), "w2": (H, C)}` as float32 tensors
    on `device` (None: the current CUDA device), e.g. the reference's."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(arrays[k])).to(
        device=dev, dtype=torch.float32) for k in ("w1", "w2")}


def loss_and_grads(params: dict[str, torch.Tensor], xbin: torch.Tensor,
                   y: torch.Tensor, threshold: float, n_hidden: int
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """`_loss_fn` and its gradients with respect to each latent weight."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = _loss_fn(leaves, xbin, y, threshold, n_hidden)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params, ostate, xbin, y, cfg: TNNTrainConfig,
               ocfg: adamw.AdamWConfig):
    """One QAT step on a batch: returns (params, ostate, loss), all on the
    batch's device, with no wait for the host."""
    loss, grads = loss_and_grads(params, xbin, y, cfg.threshold,
                                 cfg.n_hidden)
    params, ostate = adamw.apply_updates(params, grads, ostate, ocfg)
    return params, ostate, loss


def balance_zero_counts(w2_latent: np.ndarray, threshold: float) -> np.ndarray:
    """Ternarize output weights and equalize per-column zero counts.

    The paper requires the same number N of zero-valued connections in every
    output neuron so the +N/2 correction term cancels in the argmax.  We
    project to N* = median zero count, moving the least-important weights:
      * columns with too few zeros: demote smallest-|latent| nonzeros to 0,
      * columns with too many zeros: promote largest-|latent| zeros to +-1.

    The codes come from the latents cast to float32 (the reference's
    `ternarize(jnp.asarray(...))` without x64); the orders and signs read
    the latents in the dtype they were given, as the reference's do.
    """
    w2_latent = np.asarray(w2_latent)
    codes = ternarize(torch.from_numpy(w2_latent.astype(np.float32)),
                      threshold).numpy().astype(np.int8)
    zeros = (codes == 0).sum(axis=0)
    N = int(np.median(zeros))
    for o in range(codes.shape[1]):
        delta = N - int(zeros[o])
        if delta > 0:        # need more zeros: demote weakest nonzeros
            nz = np.where(codes[:, o] != 0)[0]
            order = nz[np.argsort(np.abs(w2_latent[nz, o]), kind="stable")]
            codes[order[:delta], o] = 0
        elif delta < 0:      # need fewer zeros: promote strongest zeros
            z = np.where(codes[:, o] == 0)[0]
            order = z[np.argsort(-np.abs(w2_latent[z, o]), kind="stable")]
            for r in order[: -delta]:
                s = np.sign(w2_latent[r, o])
                codes[r, o] = np.int8(s if s != 0 else 1)
    return codes


def train_latents(ds: TabularDataset, cfg: TNNTrainConfig, device=None
                  ) -> tuple[dict[str, torch.Tensor], np.ndarray]:
    """The QAT loop of `train_tnn`: `(latent params on the device, ABC
    thresholds)` after `cfg.epochs` epochs, before quantization.

    The binarized training set, the labels and every epoch's permutation
    live on the device; a step gathers its batch there, and the loop never
    waits for the host.  Float32 products must run in full float32 (TF32
    off), as the reference's do.
    """
    dev = resolve_device(device)
    thresholds = abc_fit_thresholds(ds.x_train)
    xb_tr = abc_binarize(ds.x_train, thresholds, device=dev)
    F, H, Cc = ds.spec.n_features, cfg.n_hidden, ds.spec.n_classes

    rng = np.random.default_rng(cfg.seed)
    params = params_from_arrays({
        "w1": rng.normal(0, 0.7, size=(F, H)),
        "w2": rng.normal(0, 0.7, size=(H, Cc)),
    }, dev)
    ocfg = adamw.AdamWConfig(lr=cfg.lr, weight_decay=cfg.weight_decay,
                             grad_clip=1.0)
    ostate = adamw.init(params)

    n = xb_tr.shape[0]
    perms = torch.from_numpy(np.stack(
        [rng.permutation(n) for _ in range(cfg.epochs)])).to(dev)
    y_tr = torch.from_numpy(ds.y_train.astype(np.int64)).to(dev)
    for epoch in range(cfg.epochs):
        for s in range(0, n, cfg.batch_size):
            idx = perms[epoch, s:s + cfg.batch_size]
            params, ostate, _ = train_step(params, ostate, xb_tr[idx],
                                           y_tr[idx], cfg, ocfg)
    return params, thresholds


def train_tnn(ds: TabularDataset, cfg: TNNTrainConfig,
              device=None) -> TrainedTNN:
    """Quantization-aware training of a (F, H, C) bespoke TNN on `device`
    (None: the current CUDA device); see `train_latents`."""
    params, thresholds = train_latents(ds, cfg, device)
    w1t = ternarize(params["w1"], cfg.threshold).cpu().numpy().astype(np.int8)
    w2t = balance_zero_counts(params["w2"].cpu().numpy(), cfg.threshold)
    tnn = TrainedTNN(w1t=w1t, w2t=w2t, thresholds=thresholds,
                     train_acc=0.0, test_acc=0.0, name=ds.name)
    xb_tr, xb_te = (abc_binarize(x, thresholds, device="cpu").numpy()
                    for x in (ds.x_train, ds.x_test))
    tnn.train_acc = float((predict_exact(tnn, xb_tr) == ds.y_train).mean())
    tnn.test_acc = float((predict_exact(tnn, xb_te) == ds.y_test).mean())
    return tnn


def search_tnn(ds: TabularDataset, hidden_options: list[int],
               lr_options: list[float] | None = None,
               seeds: tuple[int, ...] = (0, 1), epochs: int = 15,
               device=None) -> TrainedTNN:
    """Scaled-down version of the paper's exhaustive/Bayesian hyperparameter
    search (Sec. 5): best test accuracy, ties broken by fewer neurons."""
    lrs = lr_options or [2e-3, 5e-3, 1e-2]
    best: TrainedTNN | None = None
    for h in hidden_options:
        for lr in lrs:
            for seed in seeds:
                t = train_tnn(ds, TNNTrainConfig(n_hidden=h, lr=lr, seed=seed,
                                                 epochs=epochs), device=device)
                if (best is None or t.test_acc > best.test_acc + 1e-9
                        or (abs(t.test_acc - best.test_acc) <= 1e-9
                            and t.w1t.shape[1] < best.w1t.shape[1])):
                    best = t
    assert best is not None
    return best


def tnn_from_arrays(w1t, w2t, thresholds, train_acc: float = 0.0,
                    test_acc: float = 0.0, name: str = "") -> TrainedTNN:
    """A `TrainedTNN` from its weights as arrays: `(F, H)` and `(H, C)`
    ternary codes and `(F,)` ABC thresholds (kept in their dtype, float32
    from the reference's trainer).  Raises `ValueError` on codes outside
    {-1, 0, 1} or mismatched shapes."""
    w1t = np.asarray(w1t)
    w2t = np.asarray(w2t)
    thresholds = np.asarray(thresholds)
    if w1t.ndim != 2 or w2t.ndim != 2 or w2t.shape[0] != w1t.shape[1] \
            or thresholds.shape != (w1t.shape[0],):
        raise ValueError(f"shapes do not chain: w1t {w1t.shape}, w2t "
                         f"{w2t.shape}, thresholds {thresholds.shape}")
    for w in (w1t, w2t):
        if not np.isin(w, (-1, 0, 1)).all():
            raise ValueError("weights are not ternary codes")
    return TrainedTNN(w1t=w1t.astype(np.int8), w2t=w2t.astype(np.int8),
                      thresholds=thresholds, train_acc=float(train_acc),
                      test_acc=float(test_acc), name=name)


def load_tnn(path: str | Path) -> TrainedTNN:
    """Read a `<name>_tnn.npz` file (`tools/emit_golden_tnn.py`), checked
    against its `.sha256` sidecar when there is one."""
    from repro_torch.compile.artifact import verify_program_bundle

    path = Path(path)
    verify_program_bundle(path)
    with np.load(path, allow_pickle=False) as f:
        return tnn_from_arrays(f["w1t"], f["w2t"], f["thresholds"],
                               float(f["train_acc"]), float(f["test_acc"]),
                               str(f["name"]))


# ---------------------------------------------------------------------------
# Circuit-accurate integer inference
# ---------------------------------------------------------------------------
def predict_exact(tnn: TrainedTNN, xbin: np.ndarray) -> np.ndarray:
    """Exact integer path (popcounts + comparators), vectorized in numpy."""
    x = np.asarray(xbin).astype(np.int64)
    w1 = tnn.w1t.astype(np.int64)
    a = x @ w1
    hbit = (a >= 0).astype(np.int64)                      # {0,1}
    w2 = tnn.w2t.astype(np.int64)
    # score_o = sum_{w=+1} h + sum_{w=-1} (1-h)
    score = hbit @ (w2 == 1) + (1 - hbit) @ (w2 == -1)
    return np.argmax(score, axis=1).astype(np.int32)


def hidden_exact_netlist(n_pos: int, n_neg: int) -> C.Netlist:
    """Exact PCC for one hidden neuron, incl. degenerate shapes."""
    if n_neg == 0:
        # sum_pos >= 0 is always true -> constant 1 (zero hardware)
        b = C._Builder(max(n_pos, 1))
        one = b.const(1)
        return b.finish([one], name=f"pcc_{n_pos}x0_const1")
    if n_pos == 0:
        # 0 >= sum_neg  iff  all neg inputs are 0  ->  NOR tree
        b = C._Builder(n_neg)
        acc = 0
        for i in range(1, n_neg):
            acc = b.gate(Gate.OR, acc, i)
        out = b.gate(Gate.NOT, acc) if n_neg > 1 else b.gate(Gate.NOT, 0)
        return b.finish([out], name=f"pcc_0x{n_neg}_nor")
    return C.compose_pcc(C.popcount_netlist(n_pos), C.popcount_netlist(n_neg),
                         n_pos, n_neg)


def _hidden_inputs(tnn: TrainedTNN, xbin: np.ndarray, i: int) -> np.ndarray:
    """Concatenated [pos..., neg...] input matrix (S, n_pos+n_neg) for neuron i."""
    col = tnn.w1t[:, i]
    pos = xbin[:, col == 1]
    neg = xbin[:, col == -1]
    return np.concatenate([pos, neg], axis=1)


def _output_bits(tnn: TrainedTNN, hbits: np.ndarray, o: int) -> np.ndarray:
    """XNOR-simplified input bits (S, nnz) for output neuron o."""
    col = tnn.w2t[:, o]
    plus = hbits[:, col == 1]              # wire
    minus = 1 - hbits[:, col == -1]        # NOT gate
    return np.concatenate([plus, minus], axis=1)


def predict_with_circuits(tnn: TrainedTNN, xbin: np.ndarray,
                          hidden_nls: list[C.Netlist],
                          out_nls: list[C.Netlist],
                          device=None) -> np.ndarray:
    """Inference through explicit (possibly approximate) netlists, each
    simulated on `device` (None: the current CUDA device)."""
    xbin = np.asarray(xbin)
    S = xbin.shape[0]
    H = tnn.w1t.shape[1]
    hbits = np.empty((S, H), dtype=np.uint8)
    for i in range(H):
        sizes = tnn.hidden_sizes()[i]
        if sizes == (0, 0):
            hbits[:, i] = 1
            continue
        inp = _hidden_inputs(tnn, xbin, i)
        packed = C.pack_vectors(inp)
        hbits[:, i] = hidden_nls[i].eval_uint(packed, device=device)[:S].astype(np.uint8)
    Cc = tnn.w2t.shape[1]
    scores = np.empty((S, Cc), dtype=np.int64)
    for o in range(Cc):
        bits = _output_bits(tnn, hbits, o)
        if bits.shape[1] == 0:
            scores[:, o] = 0
            continue
        packed = C.pack_vectors(bits)
        scores[:, o] = out_nls[o].eval_uint(packed, device=device)[:S]
    return np.argmax(scores, axis=1).astype(np.int32)


def exact_netlists(tnn: TrainedTNN) -> tuple[list[C.Netlist], list[C.Netlist]]:
    hidden = [hidden_exact_netlist(p, n) for (p, n) in tnn.hidden_sizes()]
    out = [C.popcount_netlist(max(tnn.out_nnz, 1))] * tnn.w2t.shape[1]
    return hidden, out


# ---------------------------------------------------------------------------
# Hardware cost accounting (EGFET)
# ---------------------------------------------------------------------------
def argmax_cost(n_classes: int, score_bits: int) -> HwCost:
    """(C-1) comparators + (C-1) score-wide 2:1 muxes (value propagation)."""
    cmp_cost = C.comparator_geq_netlist(score_bits).cost()
    mux_bit = gate_cost(Gate.AND) + gate_cost(Gate.ANDN) + gate_cost(Gate.OR)
    total = HwCost(0.0, 0.0)
    for _ in range(n_classes - 1):
        total = total + cmp_cost + mux_bit.scale(score_bits)
    return total


def tnn_hw_cost(tnn: TrainedTNN,
                hidden_nls: list[C.Netlist],
                out_nls: list[C.Netlist],
                interface: str | None = "abc") -> HwCost:
    """Full-system cost: neurons + output NOT gates + argmax + interface."""
    total = HwCost(0.0, 0.0)
    for nl in hidden_nls:
        total = total + nl.cost()
    for nl in out_nls:
        total = total + nl.cost()
    n_not = int((tnn.w2t == -1).sum())          # XNOR -> NOT for w = -1
    total = total + gate_cost(Gate.NOT).scale(n_not)
    total = total + argmax_cost(tnn.w2t.shape[1],
                                C.popcount_width(max(tnn.out_nnz, 1)))
    if interface:
        total = total + interface_cost(tnn.w1t.shape[0], interface)
    return total


# ---------------------------------------------------------------------------
# Phase 3 — NSGA-II integration problem
# ---------------------------------------------------------------------------
def _plan_on(pop: C.NetlistPopulation, device: torch.device
             ) -> list[torch.Tensor]:
    """A population's checked `(P, G)` plan as int32 tensors on `device`."""
    return [torch.from_numpy(a).to(device) for a in CS.check_plan(
        pop.op, pop.in0, pop.in1, pop.outputs, pop.n_inputs)]


@dataclass
class TNNApproxProblem:
    """Integer-chromosome encoding: one gene per non-degenerate hidden neuron
    (PCC library index) + one gene per output neuron (PC library index).

    The gate simulation runs on `device` (None: the current CUDA device; the
    CPU runs the plain versions)."""

    tnn: TrainedTNN
    pcc_lib: PCCLibrary
    pc_out_lib: list[C.Netlist]
    xbin: np.ndarray
    y: np.ndarray
    device: torch.device | str | None = None
    # derived
    hidden_idx: list[int] = field(default_factory=list)     # non-degenerate neurons
    hidden_cands: list[list[PCCEntry]] = field(default_factory=list)
    hidden_bit_cache: list[np.ndarray] = field(default_factory=list)  # (n_cand, S) u8
    fixed_hbits: np.ndarray | None = None                    # (S, H) exact base
    fixed_cost: HwCost = field(default_factory=lambda: HwCost(0, 0))

    def __post_init__(self):
        dev = self.device = resolve_device(self.device)
        if isinstance(self.xbin, torch.Tensor):
            self.xbin = self.xbin.cpu().numpy()
        self.y = np.asarray(self.y.cpu() if isinstance(self.y, torch.Tensor)
                            else self.y)
        S = self.xbin.shape[0]
        H = self.tnn.w1t.shape[1]
        sizes = self.tnn.hidden_sizes()
        self.fixed_hbits = np.empty((S, H), dtype=np.uint8)
        caches = []
        for i, (p, n) in enumerate(sizes):
            if p >= 1 and n >= 1 and (p, n) in self.pcc_lib.entries:
                cands = self.pcc_lib.get(p, n)
                self.hidden_idx.append(i)
                self.hidden_cands.append(cands)
                # every candidate PCC of the neuron over its words: one launch
                inp = C.pack_vectors(_hidden_inputs(self.tnn, self.xbin, i))
                pop = C.NetlistPopulation.from_netlists(
                    [e.compose() for e in cands])
                cache = CK.fused_eval_uint(
                    *_plan_on(pop, dev),
                    CS.words_tensor(CS.pack_words32(inp), dev),
                    pop.n_inputs)[:, :S].to(torch.uint8)
                caches.append(cache)
                self.hidden_bit_cache.append(cache.cpu().numpy())
                self.fixed_hbits[:, i] = self.hidden_bit_cache[-1][0]  # exact = index 0
            else:
                nl = hidden_exact_netlist(p, n)
                self.fixed_cost = self.fixed_cost + nl.cost()
                if (p, n) == (0, 0) or n == 0:
                    self.fixed_hbits[:, i] = 1
                else:
                    inp = C.pack_vectors(_hidden_inputs(self.tnn, self.xbin, i))
                    self.fixed_hbits[:, i] = nl.eval_uint(
                        inp, device=dev)[:S].astype(np.uint8)
        # output candidates: Pareto PC library for size out_nnz
        self.out_cands = self.pc_out_lib
        # fixed costs independent of gene choices
        self.fixed_cost = (self.fixed_cost
                           + gate_cost(Gate.NOT).scale(int((self.tnn.w2t == -1).sum()))
                           + argmax_cost(self.tnn.w2t.shape[1],
                                         C.popcount_width(max(self.tnn.out_nnz, 1))))
        # batched-objective caches: per-gene candidate areas (host) + one
        # padded population over the output PC candidates (row-selected per
        # genome)
        self._hidden_gene_areas = [np.array([e.est_area for e in cands])
                                   for cands in self.hidden_cands]
        self._out_areas = np.array([nl.cost().area_mm2 for nl in self.out_cands])
        self._out_pop = C.NetlistPopulation.from_netlists(self.out_cands)
        self._build_device_state(caches)

    def _build_device_state(self, caches: list[torch.Tensor]) -> None:
        """What `objective` reads on the device, built once: the exact
        hidden bits, the hidden caches stacked `(nh, K_max, S)`, the XNOR
        wiring of the output neurons, the labels, and the output library's
        plan and level schedule (gathered by gene, never rebuilt)."""
        dev = self.device
        S, H = self.fixed_hbits.shape
        self._fixed_dev = torch.from_numpy(self.fixed_hbits).to(dev)
        k_max = max((c.shape[0] for c in caches), default=0)
        self._caches_dev = torch.zeros((len(caches), k_max, S),
                                       dtype=torch.uint8, device=dev)
        for g, c in enumerate(caches):
            self._caches_dev[g, : c.shape[0]] = c
        self._hidden_cols = torch.tensor(self.hidden_idx, dtype=torch.int64,
                                         device=dev)
        # output neuron o reads h[plus] then NOT h[minus] (`_output_bits`)
        idx, neg = [], []
        for o in range(self.tnn.w2t.shape[1]):
            col = self.tnn.w2t[:, o]
            plus, minus = np.flatnonzero(col == 1), np.flatnonzero(col == -1)
            idx.append(np.concatenate([plus, minus]))
            neg.append(np.r_[np.zeros(plus.size), np.ones(minus.size)])
        self._xnor_idx = torch.from_numpy(np.stack(idx)).to(dev)
        self._xnor_neg = torch.from_numpy(np.stack(neg).astype(np.uint8)
                                          ).to(dev)
        self._y_dev = torch.from_numpy(self.y.astype(np.int64)).to(dev)
        self._out_plan = _plan_on(self._out_pop, dev)
        self._out_sched = CK.schedule(*self._out_plan[:3],
                                      self._out_pop.n_inputs, device=dev)

    # -- chromosome layout ---------------------------------------------------
    @property
    def n_genes(self) -> int:
        return len(self.hidden_idx) + self.tnn.w2t.shape[1]

    def domains(self) -> np.ndarray:
        d = [len(c) for c in self.hidden_cands]
        d += [len(self.out_cands)] * self.tnn.w2t.shape[1]
        return np.array(d, dtype=np.int64)

    def decode(self, x: np.ndarray) -> tuple[list[C.Netlist], list[C.Netlist]]:
        """Chromosome -> full netlist selection (for reporting/synthesis)."""
        sizes = self.tnn.hidden_sizes()
        hidden_nls: list[C.Netlist] = []
        gi = 0
        for i, (p, n) in enumerate(sizes):
            if i in self.hidden_idx:
                e = self.hidden_cands[self.hidden_idx.index(i)][int(x[gi])]
                hidden_nls.append(e.compose())
                gi += 1
            else:
                hidden_nls.append(hidden_exact_netlist(p, n))
        out_nls = [self.out_cands[int(g)] for g in x[len(self.hidden_idx):]]
        return hidden_nls, out_nls

    # -- objectives ------------------------------------------------------------
    def _eval_one(self, x: np.ndarray) -> tuple[float, float]:
        """The serial reference path: one chromosome, one output neuron a
        call (`Netlist.eval_uint` on the problem's device)."""
        S = self.xbin.shape[0]
        hbits = self.fixed_hbits.copy()
        est_area = self.fixed_cost.area_mm2
        for g, (i, cands, cache) in enumerate(zip(self.hidden_idx,
                                                  self.hidden_cands,
                                                  self.hidden_bit_cache)):
            k = int(x[g])
            hbits[:, i] = cache[k]
            est_area += cands[k].est_area
        Cc = self.tnn.w2t.shape[1]
        scores = np.empty((S, Cc), dtype=np.int64)
        for o in range(Cc):
            nl = self.out_cands[int(x[len(self.hidden_idx) + o])]
            est_area += nl.cost().area_mm2
            bits = _output_bits(self.tnn, hbits, o)
            if bits.shape[1] == 0:
                scores[:, o] = 0
            else:
                scores[:, o] = nl.eval_uint(C.pack_vectors(bits),
                                            device=self.device)[:S]
        acc = float((np.argmax(scores, axis=1) == self.y).mean())
        return 1.0 - acc, est_area

    def launch_args(self, pop: np.ndarray) -> tuple:
        """The one gate-walk launch that scores `pop` `(P, n_genes)`:
        `(op, in0, in1, outputs, words, n_inputs, schedule)` for
        `cuda_circuit_sim.fused_eval_uint` over P x C rows, row p * C + o
        being individual p's output neuron o.

        The hidden bits are gathered by gene from the device caches, each
        (individual, output neuron) pair's XNOR bits packed on the device
        (`circuit_sim.pack_bits32`), and the output library's plan and
        schedule rows taken by gene (`Schedule.take`): no schedule is built.
        """
        dev = self.device
        genes = torch.from_numpy(np.ascontiguousarray(pop, dtype=np.int64)
                                 ).to(dev)
        P, nh = genes.shape[0], len(self.hidden_idx)
        S, H = self.fixed_hbits.shape
        Cc, nnz = self._xnor_idx.shape
        hbits = self._fixed_dev.expand(P, S, H).clone()          # (P, S, H)
        if nh:
            g = torch.arange(nh, device=dev)
            hbits[:, :, self._hidden_cols] = \
                self._caches_dev[g[None, :], genes[:, :nh]].transpose(1, 2)
        bits = hbits[:, :, self._xnor_idx] ^ self._xnor_neg      # (P, S, C, nnz)
        words = CS.pack_bits32(bits.permute(1, 0, 2, 3).reshape(S, -1))
        words = words.view(P * Cc, nnz, -1)
        k = genes[:, nh:].reshape(-1)
        plan = [a.index_select(0, k) for a in self._out_plan]
        return (*plan, words, nnz, self._out_sched.take(k))

    def objective(self, pop: np.ndarray) -> np.ndarray:
        """Population-parallel objectives: (N, n_genes) int -> (N, 2).

        Every output neuron of every individual is scored in ONE launch of
        the gate walk (`launch_args`); the argmax over classes (first index
        on ties, as numpy's) and the accuracy count run on the device, the
        estimated areas on the host.  Matches `_eval_one` (the serial
        reference) bit-for-bit.
        """
        pop = np.asarray(pop, dtype=np.int64)
        P = pop.shape[0]
        S = self.xbin.shape[0]
        nh = len(self.hidden_idx)
        Cc = self.tnn.w2t.shape[1]
        est = np.full(P, self.fixed_cost.area_mm2)
        for g in range(nh):
            est = est + self._hidden_gene_areas[g][pop[:, g]]
        for o in range(Cc):
            est = est + self._out_areas[pop[:, nh + o]]
        if self._xnor_idx.shape[1]:
            scores = CK.fused_eval_uint(*self.launch_args(pop))
            scores = scores[:, :S].view(P, Cc, S)
        else:   # no output inputs: every score is 0
            scores = torch.zeros((P, Cc, S), dtype=torch.int32,
                                 device=self.device)
        best = scores.max(dim=1, keepdim=True).values
        cls = torch.arange(Cc, device=self.device)[None, :, None]
        pred = torch.where(scores == best, cls, Cc).min(dim=1).values
        correct = (pred == self._y_dev[None, :]).sum(dim=1).cpu().numpy()
        acc = correct.astype(np.float64) / S
        return np.stack([1.0 - acc, est], axis=1)

    def optimize(self, cfg: NSGA2Config) -> NSGA2Result:
        seed = np.zeros((1, self.n_genes), dtype=np.int64)   # all-exact individual
        return nsga2(self.domains(), self.objective, cfg, seed_population=seed)
