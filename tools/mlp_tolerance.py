"""How far the port's MLP baselines follow the reference's, per dataset.

For each Table-2 dataset x {exact, pow2}, at `tools/emit_golden_mlp.py`'s
settings, runs the reference's training loop (its quantizers, loss and
`repro.optim.adamw`, step for step as `repro.core.baselines.
train_mlp_baseline` runs them) beside the port's (`repro_torch.core.
baselines`, on the CPU) on the same batches, and prints one row: the
steps, max |dg| / max |g| of the first step from identical parameters,
max |d latent| after the first step and at the end, the integer weights
that differ from `tests/golden_emit/mlp_baselines.npz`, and both test
accuracies.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/mlp_tolerance.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.core import baselines as RB  # noqa: E402
from repro.data.tabular import DATASETS, make_dataset  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro_torch.core import baselines as PB  # noqa: E402
from repro_torch.data.tabular import make_dataset as port_dataset  # noqa: E402,E501
from repro_torch.optim import adamw as PA  # noqa: E402

GOLDEN = ROOT / "tests" / "golden_emit" / "mlp_baselines.npz"
EPOCHS = 15
LR = 5e-3


def reference_step_fn(pow2: bool):
    quant = RB._pow2_ste if pow2 else (lambda w: RB._int_ste(w, 8))

    def loss(p, x, y):
        h = jax.nn.relu(x @ quant(p["w1"]))
        lp = jax.nn.log_softmax(h @ quant(p["w2"]), axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], 1))

    cfg = RA.AdamWConfig(lr=LR)

    @jax.jit
    def step(p, s, x, y):
        _, g = jax.value_and_grad(loss)(p, x, y)
        return RA.apply_updates(p, g, s, cfg) + (g,)

    return step


def row(name: str, mode: str, pow2: bool, golden) -> dict:
    ds = make_dataset(name)
    H = DATASETS[name].mlp_topology[1]
    F, C = ds.spec.n_features, ds.spec.n_classes
    rng = np.random.default_rng(0)
    w1, w2 = rng.normal(0, 0.3, (F, H)), rng.normal(0, 0.3, (H, C))
    ref = {"w1": jnp.asarray(w1, jnp.float32),
           "w2": jnp.asarray(w2, jnp.float32)}
    port = {"w1": torch.tensor(w1, dtype=torch.float32),
            "w2": torch.tensor(w2, dtype=torch.float32)}
    rstate, pstate = RA.init(ref), PA.init(port)
    step = reference_step_fn(pow2)
    ocfg = PA.AdamWConfig(lr=LR)
    xq = RB._quant_input_4bit(ds.x_train).astype(np.float32)
    y = ds.y_train.astype(np.int32)
    n = xq.shape[0]
    out = {"steps": 0}
    for _ in range(EPOCHS):
        perm = rng.permutation(n)
        for s in range(0, n, 64):
            idx = perm[s:s + 64]
            ref, rstate, rg = step(ref, rstate, jnp.asarray(xq[idx]),
                                   jnp.asarray(y[idx]))
            _, pg = PB.loss_and_grads(port, torch.from_numpy(xq[idx]),
                                      torch.from_numpy(y[idx]).long(), pow2)
            port, pstate = PA.apply_updates(port, pg, pstate, ocfg)
            if out["steps"] == 0:
                gmax = max(float(jnp.abs(rg[k]).max()) for k in rg)
                out["grad_rel"] = max(
                    float(np.abs(np.asarray(rg[k]) - pg[k].numpy()).max())
                    for k in rg) / gmax
                out["latent_step1"] = latent_gap(ref, port)
            out["steps"] += 1
    out["latent_end"] = latent_gap(ref, port)
    mlp = PB.train_mlp_baseline(port_dataset(name), H, pow2=pow2,
                                epochs=EPOCHS, device="cpu")
    key = f"{name}_{mode}"
    out["codes"] = [int((w != golden[f"{key}_{k}"]).sum())
                    for w, k in zip(mlp.weights_int, ("w1", "w2"))]
    out["sizes"] = [w.size for w in mlp.weights_int]
    out["acc"] = (mlp.test_acc, float(golden[f"{key}_test_acc"]))
    return out


def latent_gap(ref: dict, port: dict) -> float:
    return max(float(np.abs(np.asarray(ref[k]) - port[k].numpy()).max())
               for k in ref)


def main() -> None:
    golden = np.load(GOLDEN)
    print("| Dataset | Mode | Steps | max |dg| / max |g|, step 1 | "
          "max |d latent| after step 1 | at the end | Integer weights "
          "against the golden file | Test accuracy, port / golden |")
    for name in sorted(DATASETS):
        for mode, pow2 in (("exact", False), ("pow2", True)):
            r = row(name, mode, pow2, golden)
            codes = ("identical" if not any(r["codes"]) else
                     f"w1 {r['codes'][0]} of {r['sizes'][0]} differ, "
                     f"w2 {r['codes'][1]} of {r['sizes'][1]}")
            print(f"| {name} | {mode} | {r['steps']} | {r['grad_rel']:.1e} "
                  f"| {r['latent_step1']:.1e} | {r['latent_end']:.2g} | "
                  f"{codes} | {r['acc'][0]:.4f} / {r['acc'][1]:.4f} |",
                  flush=True)


if __name__ == "__main__":
    main()
