"""Beyond-paper extension: ABC threshold variation robustness (Sec. 3.2.1).

The paper notes that printed-process variations perturb the R1/R2 divider
ratio, shifting each ABC's threshold V_q, and defers variation-aware
training to future work.  This benchmark quantifies the exposure the paper
left open, and evaluates the mitigation it proposes:

  * Monte-Carlo perturb the per-feature thresholds (relative sigma on the
    divider ratio) and measure exact-TNN accuracy distributions;
  * variation-aware QAT: re-train with threshold noise *injected during
    training* (fresh binarization noise per epoch) and compare degradation.

Output rows: sigma, mean/p5 accuracy, clean accuracy, for both vanilla and
variation-aware training.  The port of
`benchmarks/variation_robustness.py`: both trainings run on `device`, the
variation-aware one through `core/tnn.py::train_step` and `optim/adamw.py`
in place of the reference's jitted step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tnn as T
from repro_torch.core.ternary import abc_fit_thresholds
from repro_torch.data.tabular import make_dataset
from benchmarks_torch.common import QUICK


def _acc_under_variation(tnn, ds, sigma: float, n_mc: int, rng) -> np.ndarray:
    accs = []
    for _ in range(n_mc):
        thr = tnn.thresholds * (1.0 + rng.normal(0, sigma,
                                                 tnn.thresholds.shape))
        xb = (ds.x_test > thr[None, :]).astype(np.int64)
        accs.append(float((T.predict_exact(tnn, xb) == ds.y_test).mean()))
    return np.array(accs)


def _train_variation_aware(ds, n_hidden: int, sigma: float, seed: int = 0,
                           device=None):
    """QAT with threshold-noise injection: each epoch re-binarizes the
    inputs under a fresh V_q perturbation (DESIGN.md: the 'variation-aware
    training' the paper proposes but does not implement)."""
    from repro_torch import resolve_device
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.core.tnn import (balance_zero_counts, params_from_arrays,
                                      predict_exact, train_step, TrainedTNN,
                                      TNNTrainConfig)
    from repro_torch.core.ternary import ternarize, TERNARY_THRESHOLD

    dev = resolve_device(device)
    thresholds = abc_fit_thresholds(ds.x_train)
    F, H, C = ds.spec.n_features, n_hidden, ds.spec.n_classes
    rng = np.random.default_rng(seed)
    params = params_from_arrays({"w1": rng.normal(0, 0.7, (F, H)),
                                 "w2": rng.normal(0, 0.7, (H, C))}, dev)
    state = adamw.init(params)
    ocfg = AdamWConfig(lr=5e-3, grad_clip=1.0)
    cfg = TNNTrainConfig(n_hidden=H, threshold=TERNARY_THRESHOLD)

    y_j = torch.from_numpy(ds.y_train.astype(np.int64)).to(dev)
    n = ds.x_train.shape[0]
    for epoch in range(12 if QUICK else 18):
        thr = thresholds * (1.0 + rng.normal(0, sigma, thresholds.shape))
        xb = torch.from_numpy(
            (ds.x_train > thr[None, :]).astype(np.float32)).to(dev)
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(0, n, 64):
            idx = perm[s:s + 64]
            params, state, _ = train_step(params, state, xb[idx], y_j[idx],
                                          cfg, ocfg)

    w1t = ternarize(params["w1"], TERNARY_THRESHOLD).cpu().numpy() \
        .astype(np.int8)
    w2t = balance_zero_counts(params["w2"].cpu().numpy(), TERNARY_THRESHOLD)
    tnn = TrainedTNN(w1t=w1t, w2t=w2t, thresholds=thresholds,
                     train_acc=0.0, test_acc=0.0, name=ds.name + "-va")
    xb_te = (ds.x_test > thresholds[None, :]).astype(np.int64)
    tnn.test_acc = float((predict_exact(tnn, xb_te) == ds.y_test).mean())
    return tnn


def run(datasets=None, device=None) -> list[dict]:
    datasets = datasets or (["cardio"] if QUICK else ["cardio", "breast_cancer",
                                                      "redwine"])
    sigmas = [0.02, 0.05, 0.10]
    n_mc = 20 if QUICK else 100
    rng = np.random.default_rng(0)
    rows = []
    for name in datasets:
        ds = make_dataset(name)
        vanilla = T.train_tnn(ds, T.TNNTrainConfig(
            n_hidden=ds.spec.topology[1], epochs=12 if QUICK else 18,
            lr=1e-2, seed=0), device=device)
        for sigma in sigmas:
            aware = _train_variation_aware(ds, ds.spec.topology[1], sigma,
                                           device=device)
            a_v = _acc_under_variation(vanilla, ds, sigma, n_mc, rng)
            a_a = _acc_under_variation(aware, ds, sigma, n_mc, rng)
            rows.append({
                "bench": "variation", "dataset": name, "sigma": sigma,
                "clean_acc": round(vanilla.test_acc, 3),
                "vanilla_mean": round(float(a_v.mean()), 3),
                "vanilla_p5": round(float(np.percentile(a_v, 5)), 3),
                "aware_clean": round(aware.test_acc, 3),
                "aware_mean": round(float(a_a.mean()), 3),
                "aware_p5": round(float(np.percentile(a_a, 5)), 3),
                "aware_helps": bool(a_a.mean() >= a_v.mean() - 1e-9),
            })
    return rows
