"""Campaign problem builders: synthetic (tests/CI) and the real Table-2 TNN.

The port of `repro.evolve.problems`.  `build_tnn_problem` runs the paper's
Phase 1/2 pipeline (ternary QAT, CGP popcount libraries + Pareto PCC
combinations) at a configurable budget on a device and wraps the Phase-3
`TNNApproxProblem`, whose objective is one gate-walk launch a call, for
the campaign runner; `compile_archive_winner` closes the loop by lowering
an archive chromosome through `repro_torch.compile.lower_classifier` to a
servable `CompiledClassifier`.

The Phase-1/2 products are cached twice over: an in-process memo keyed by
the content hash (`evolve.phase_cache.phase_key`) makes repeated
`build_tnn_problem` calls with identical args free inside one process,
and the on-disk content-addressed cache (`evolve.phase_cache`) carries
them across processes — autopilot rounds, zoo sweeps, and the spawned
workers of the parallel island executor all skip retraining, and so
score the parent's very products.

`ProblemSpec` is the picklable recipe a spawned executor worker uses to
rebuild the same problem on its side of the process boundary (closures
over numpy state don't pickle; a named builder + kwargs does).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class CampaignProblem:
    """Everything a `Campaign` needs, plus decode hooks for the winner."""

    name: str
    domains: np.ndarray
    objective: Callable[[np.ndarray], np.ndarray]
    seed_population: np.ndarray | None = None
    # TNN problems carry their phase-3 context for compile/emit
    tnn: object | None = None
    approx: object | None = None        # core.tnn.TNNApproxProblem
    dataset: object | None = None       # data.tabular.TabularDataset
    # continuous-evolution hook: `drift(round)` refreshes the data the
    # objective scores against (deterministic in `round`).  Callers that
    # memoize fitness must clear their cache after applying it
    # (`Campaign.mark_drift`).
    drift: Callable[[int], None] | None = None


@dataclass(frozen=True)
class ProblemSpec:
    """Picklable recipe for rebuilding a `CampaignProblem` in a worker.

    The parallel island executor spawns fresh processes; an objective
    closure cannot cross that boundary, but (builder name, kwargs) can.
    `build_problem` dispatches back to the named builder — workers
    rebuilding a TNN problem ride the phase cache, so the rebuild costs a
    cache load, not a retrain.
    """

    kind: str                       # "synth" | "tnn"
    kwargs: dict = field(default_factory=dict)

    def build(self) -> "CampaignProblem":
        return build_problem(self)


def build_problem(spec: ProblemSpec) -> CampaignProblem:
    """Rebuild the problem a `ProblemSpec` names (executor worker entry)."""
    if spec.kind == "synth":
        return build_synth_problem(**spec.kwargs)
    if spec.kind == "tnn":
        return build_tnn_problem(**spec.kwargs)
    raise ValueError(f"unknown problem kind {spec.kind!r} "
                     "(expected 'synth' or 'tnn')")


def build_synth_problem(n_genes: int = 10, domain: int = 6,
                        work: int = 0,
                        wait_ms: float = 0.0) -> CampaignProblem:
    """Deterministic two-objective toy with a known diagonal Pareto front.

    Pure integer arithmetic on the host — no training, no RNG, no device —
    so two processes agree bit-for-bit on every objective value.  Used by
    the CLI's `synth` problem and the resume / seed-determinism tests.

    Two expensive-objective stand-ins (results discarded, objective values
    untouched either way): `work` > 0 burns that many 128x128 matmuls per
    evaluated row (CPU-bound load), `wait_ms` > 0 blocks that long per
    evaluated row (an objective that waits on a device or an RPC).
    """
    domains = np.full(n_genes, domain, dtype=np.int64)
    scale = n_genes * (domain - 1)
    burn = (np.linspace(0.0, 1.0, 128 * 128, dtype=np.float64)
            .reshape(128, 128) if work else None)

    def objective(pop: np.ndarray) -> np.ndarray:
        pop = np.asarray(pop, dtype=np.int64)
        if work:
            acc = burn
            for _ in range(work * pop.shape[0]):
                acc = burn @ acc
                acc *= 1e-4                     # keep magnitudes finite
        if wait_ms > 0.0:
            import time
            time.sleep(wait_ms * pop.shape[0] / 1000.0)
        f0 = pop.sum(1) / scale
        f1 = (domain - 1 - pop).sum(1) / scale
        pen = (pop == 2).sum(1) * 0.2       # middle values are dominated
        return np.stack([f0 + pen, f1 + pen], 1)

    name = (f"synth{n_genes}x{domain}" + (f"w{work}" if work else "")
            + (f"d{wait_ms:g}" if wait_ms else ""))
    return CampaignProblem(name=name, domains=domains, objective=objective)


# in-process memo over phase products, keyed by the content hash — the
# layer in front of the on-disk cache (same process, same args -> the
# exact TNN is trained once, not once per build_tnn_problem call)
_PHASE_MEMO: dict = {}


def clear_phase_memo() -> None:
    """Drop the in-process Phase-1/2 product memo (tests/benchmarks)."""
    _PHASE_MEMO.clear()


def _compute_phase_products(dataset: str, seed: int, epochs: int,
                            cgp_points: int, cgp_iters: int,
                            pcc_samples: int, device):
    """Run Phases 1-2 from scratch on `device` (the cache-miss path)."""
    from repro_torch.core import tnn as T
    from repro_torch.core.cgp import evolve_pc_library
    from repro_torch.core.pcc import build_pcc_library, pc_pareto
    from repro_torch.data.tabular import make_dataset

    ds = make_dataset(dataset)
    tnn = T.train_tnn(ds, T.TNNTrainConfig(
        n_hidden=ds.spec.topology[1], epochs=epochs, lr=1e-2, seed=seed),
        device=device)

    sizes, pcc_sizes = set(), []
    for (p, n) in tnn.hidden_sizes():
        if p >= 1 and n >= 1:
            sizes.update([p, n])
            pcc_sizes.append((p, n))
    sizes.add(max(tnn.out_nnz, 1))
    pc_libs = {n: evolve_pc_library(n, n_points=cgp_points,
                                    max_iters=cgp_iters, device=device)
               for n in sorted(sizes)}
    pcc_lib = build_pcc_library(sorted(set(pcc_sizes)), pc_libs,
                                n_samples=pcc_samples, device=device)
    pc_out = pc_pareto(pc_libs[max(tnn.out_nnz, 1)])
    return tnn, pc_libs, pcc_lib, pc_out


def _phase_products(dataset: str, seed: int, epochs: int, cgp_points: int,
                    cgp_iters: int, pcc_samples: int,
                    cache_dir: str | None, device, key: str | None):
    """Phase-1/2 products via memo -> disk cache -> recompute (+backfill).

    An explicit `key` names an existing entry (one the reference wrote,
    say): it is loaded or the call fails, since the port cannot recompute
    another pipeline's products."""
    from repro_torch.evolve import phase_cache as PC

    named = key is not None
    if not named:
        key = PC.phase_key(dataset, seed, epochs, cgp_points, cgp_iters,
                           pcc_samples, device=device)
    if key in _PHASE_MEMO:
        return _PHASE_MEMO[key]
    root = PC.default_cache_dir() if cache_dir is None else cache_dir
    if named:
        if root is None:
            raise ValueError("phase_key names an entry but the phase cache "
                             "is off (REPRO_TORCH_PHASE_CACHE)")
        products = PC.load_phase(root, key)
        _PHASE_MEMO[key] = products
        return products
    if root is not None:
        try:
            products = PC.load_phase(root, key)
            _PHASE_MEMO[key] = products
            return products
        except FileNotFoundError:
            pass
        except PC.PhaseCacheCorruptError as exc:
            warnings.warn(f"{exc}", RuntimeWarning, stacklevel=3)
            PC.drop_entry(root, key)
    products = _compute_phase_products(dataset, seed, epochs, cgp_points,
                                       cgp_iters, pcc_samples, device)
    if root is not None:
        PC.save_phase(root, key, *products)
    _PHASE_MEMO[key] = products
    return products


def build_tnn_problem(dataset: str, seed: int = 0, epochs: int = 12,
                      cgp_points: int = 3, cgp_iters: int = 500,
                      pcc_samples: int = 30000,
                      device=None,
                      cache_dir: str | None = None,
                      phase_key: str | None = None) -> CampaignProblem:
    """Phases 1-3 setup for one Table-2 dataset at a configurable budget.

    Mirrors the reference's builder: train the exact TNN, evolve
    approximate popcount libraries for every neuron size, build the Pareto
    PCC library, and return the NSGA-II integration problem whose
    objective scores whole populations in one gate-walk launch on `device`
    (None: the current CUDA device; the CPU runs the plain versions).
    Deterministic in (dataset, seed, budgets, device type) — which is why
    the expensive Phase-1/2 half is served from `evolve.phase_cache` (and
    an in-process memo) instead of recomputed per call.  `cache_dir=None`
    resolves the default cache root (``REPRO_TORCH_PHASE_CACHE`` env, else
    ``~/.cache/repro_torch/phase_cache``; set the env to ``off`` to
    disable).  `phase_key` loads the entry of that key under the cache
    root instead of the port's own key — the reference's products, say
    (its `phase_cache.phase_key`) — and never recomputes.  The cheap
    Phase-3 wrapper (`TNNApproxProblem` + its per-candidate bit caches) is
    rebuilt per call so callers can mutate their problem (drift hooks)
    without aliasing each other.
    """
    from repro_torch.core import tnn as T
    from repro_torch.core.ternary import abc_binarize
    from repro_torch.data.tabular import make_dataset
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    tnn, pc_libs, pcc_lib, pc_out = _phase_products(
        dataset, seed, epochs, cgp_points, cgp_iters, pcc_samples, cache_dir,
        dev, phase_key)
    ds = make_dataset(dataset)
    xb_tr = abc_binarize(ds.x_train, tnn.thresholds, device=dev)
    prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                              xbin=xb_tr, y=ds.y_train, device=dev)
    seed_pop = np.zeros((1, prob.n_genes), dtype=np.int64)  # all-exact design
    return CampaignProblem(name=f"tnn_{dataset}", domains=prob.domains(),
                           objective=prob.objective,
                           seed_population=seed_pop,
                           tnn=tnn, approx=prob, dataset=ds)


def attach_tnn_drift(problem: CampaignProblem, rate: float,
                     seed: int = 0) -> CampaignProblem:
    """Arm a TNN problem with a bootstrap-resampling drift hook.

    Each `drift(round)` call replaces `rate` of the objective's sample
    rows with fresh bootstrap draws from the original training pool — a
    cheap, deterministic stand-in for "the sensor stream moved" that
    reuses the cached per-candidate bit planes (the caches are per-sample
    rows, so reindexing them *is* redrawing the data; nothing is
    re-simulated).  Deterministic in `(seed, round)`: two controllers
    replaying the same round sequence score identical objectives.

    The index map is drawn on the host, as the reference draws it, and
    applied twice: to the host arrays `_eval_one` reads, and, by a gather
    on the problem's device, to the device state `objective` reads (the
    exact hidden bits, the stacked hidden caches and the labels), so both
    score the drifted data.
    """
    import torch

    if problem.approx is None:
        raise ValueError("only TNN problems carry a sample plane to drift")
    if not 0.0 < rate <= 1.0:
        raise ValueError("drift rate must be in (0, 1]")
    ap = problem.approx
    orig_hbits = ap.fixed_hbits.copy()
    orig_caches = [c.copy() for c in ap.hidden_bit_cache]
    orig_y = ap.y.copy()
    orig_xbin = ap.xbin.copy()
    orig_fixed_dev = ap._fixed_dev
    orig_caches_dev = ap._caches_dev
    orig_y_dev = ap._y_dev
    S = orig_y.shape[0]
    index_map = np.arange(S)

    def drift(round_idx: int) -> None:
        rng = np.random.default_rng((seed, int(round_idx)))
        k = max(1, int(np.ceil(rate * S)))
        pos = rng.choice(S, size=k, replace=False)
        index_map[pos] = rng.integers(0, S, size=k)
        ap.fixed_hbits = orig_hbits[index_map]
        ap.hidden_bit_cache = [c[:, index_map] for c in orig_caches]
        ap.y = orig_y[index_map]
        ap.xbin = orig_xbin[index_map]
        idx = torch.from_numpy(index_map.copy()).to(ap.device)
        ap._fixed_dev = orig_fixed_dev.index_select(0, idx)
        ap._caches_dev = orig_caches_dev.index_select(2, idx)
        ap._y_dev = orig_y_dev.index_select(0, idx)

    problem.drift = drift
    return problem


def compile_archive_winner(problem: CampaignProblem, x: np.ndarray):
    """Lower one archive chromosome to a `CompiledClassifier` (emit/serve)."""
    if problem.approx is None:
        raise ValueError("only TNN problems can be compiled")
    from repro_torch.compile import lower_classifier
    hidden_nls, out_nls = problem.approx.decode(np.asarray(x, dtype=np.int64))
    return lower_classifier(problem.tnn, hidden_nls, out_nls)
