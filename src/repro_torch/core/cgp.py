"""Phase 1 — Cartesian Genetic Programming for approximate popcount circuits.

The port of `repro.core.cgp`: the search is the reference's, numpy on the
host, with the same random stream, trajectory, `evaluations` count and
library, bit for bit.  What moves is the fitness: every generation's
touched children are scored in one `NetlistPopulation.pc_errors` call on
`device` — one launch of the gate walk over the shared vector set, which
goes to the device once a run.

Implements the paper's Sec. 4.1.1: a (mu+lambda) evolutionary strategy over an
integer, address-based genome.  The initial population contains the *exact*
popcount adder tree; mutants trade arithmetic error for EGFET area under the
constrained fitness of Eq. (3):

    F(c) = area(c)  if  eps(c) <= tau   else  +inf

Error evaluation is the bit-parallel sweep from `circuits.eval_vectors` —
exhaustive for n <= 16 inputs, Hamming-weight-stratified Monte-Carlo above
(the offline stand-in for the paper's BDD-based formal evaluation).

Population-parallel fitness: all lambda children of a generation are scored
in a single `NetlistPopulation` call (batched simulation + batched
active-mask/area accounting), instead of a per-child loop — bit-identical
results and trajectories (`batch_eval=False` keeps the serial path, one
`Netlist.eval_uint` a child on the same device).  On the CPU,
`evolve_pc_library` additionally runs the independent tau-schedule points
concurrently in a thread pool.

Classic CGP efficiency trick: a mutation that touches only *inactive* genes
yields a functionally identical circuit, so the child inherits the parent's
fitness without re-simulation (neutral drift is retained, cf. Miller'11).
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.circuits import (
    Netlist,
    NetlistPopulation,
    eval_vectors,
    popcount_netlist,
    popcount_width,
    truncated_popcount_netlist,
)
from repro_torch.device import resolve_device
from repro_torch.hw.egfet import Gate
from repro_torch.kernels import circuit_sim as CS

# Function set for evolved nodes (2-input ops + unaries).
DEFAULT_FUNCS: tuple[int, ...] = (
    Gate.AND, Gate.OR, Gate.XOR, Gate.NAND, Gate.NOR, Gate.XNOR,
    Gate.NOT, Gate.BUF, Gate.ANDN, Gate.ORN, Gate.CONST0, Gate.CONST1,
)


@dataclass
class CGPConfig:
    n_inputs: int
    n_outputs: int
    n_nodes: int                      # grid size (single row, full levels-back)
    funcs: tuple[int, ...] = DEFAULT_FUNCS
    lam: int = 4                      # lambda children per generation
    mu: int = 1                       # parents kept per generation (mu+lambda)
    mut_genes: int = 5                # genes mutated per child
    seed: int = 0
    max_iters: int = 2000
    time_limit_s: float | None = None
    error_metric: str = "mae"         # "mae" | "wcae"
    tau: float = 0.0                  # error threshold (Eq. 3)
    batch_eval: bool = True           # population-parallel child evaluation


@dataclass
class CGPResult:
    best: Netlist
    best_area: float
    best_error: tuple[float, float]   # (mae, wcae) of the winner
    history: list[tuple[int, float]] = field(default_factory=list)  # (iter, area)
    evaluations: int = 0


class _Genome:
    """func[g], a[g], b[g] int arrays + out[] output addresses."""

    __slots__ = ("n_inputs", "func", "a", "b", "out")

    def __init__(self, n_inputs, func, a, b, out):
        self.n_inputs = n_inputs
        self.func = func
        self.a = a
        self.b = b
        self.out = out

    def copy(self) -> "_Genome":
        return _Genome(self.n_inputs, self.func.copy(), self.a.copy(),
                       self.b.copy(), self.out.copy())

    def to_netlist(self, name: str = "") -> Netlist:
        nl = Netlist(
            n_inputs=self.n_inputs,
            op=self.func.astype(np.int16),
            in0=self.a.astype(np.int32),
            in1=self.b.astype(np.int32),
            outputs=self.out.astype(np.int32),
            name=name,
        )
        nl.validate()
        return nl

    def active_nodes(self) -> np.ndarray:
        """Boolean mask over grid nodes reachable from outputs."""
        n_in = self.n_inputs
        n_nodes = self.func.shape[0]
        live = np.zeros(n_in + n_nodes, dtype=bool)
        live[self.out] = True
        for g in range(n_nodes - 1, -1, -1):
            if live[n_in + g]:
                f = self.func[g]
                if f not in (Gate.CONST0, Gate.CONST1):
                    live[self.a[g]] = True
                    if f not in (Gate.NOT, Gate.BUF):
                        live[self.b[g]] = True
        return live[n_in:]


def _seed_genome(exact: Netlist, n_nodes: int, rng: np.random.Generator,
                 funcs: tuple[int, ...]) -> _Genome:
    """Embed the exact netlist in a larger grid; random-fill the slack."""
    g0 = exact.n_gates
    if n_nodes < g0:
        raise ValueError(f"grid {n_nodes} smaller than exact circuit {g0}")
    n_in = exact.n_inputs
    func = np.empty(n_nodes, dtype=np.int64)
    a = np.empty(n_nodes, dtype=np.int64)
    b = np.empty(n_nodes, dtype=np.int64)
    func[:g0] = exact.op
    a[:g0] = exact.in0
    b[:g0] = exact.in1
    for g in range(g0, n_nodes):
        func[g] = funcs[rng.integers(len(funcs))]
        a[g] = rng.integers(n_in + g)
        b[g] = rng.integers(n_in + g)
    return _Genome(n_in, func, a, b, exact.outputs.astype(np.int64).copy())


def _mutate(parent: _Genome, cfg: CGPConfig, rng: np.random.Generator,
            active: np.ndarray | None = None) -> tuple["_Genome", bool]:
    """Point-mutate `mut_genes` genes; report whether any *active* gene moved.

    `active` lets callers share one liveness sweep across a generation's
    lambda children instead of recomputing it per child.
    """
    child = parent.copy()
    n_nodes = child.func.shape[0]
    n_in = cfg.n_inputs
    active = parent.active_nodes() if active is None else active
    touched_active = False
    n_genes = 3 * n_nodes + child.out.shape[0]
    for _ in range(cfg.mut_genes):
        gi = int(rng.integers(n_genes))
        if gi < 3 * n_nodes:
            g, which = divmod(gi, 3)
            if which == 0:
                child.func[g] = cfg.funcs[rng.integers(len(cfg.funcs))]
            elif which == 1:
                child.a[g] = rng.integers(n_in + g)
            else:
                child.b[g] = rng.integers(n_in + g)
            if active[g]:
                touched_active = True
        else:
            o = gi - 3 * n_nodes
            child.out[o] = rng.integers(n_in + n_nodes)
            touched_active = True
    return child, touched_active


def _population_of(genomes: list[_Genome]) -> NetlistPopulation:
    """Stack same-grid genomes into a structure-of-arrays population."""
    return NetlistPopulation(
        n_inputs=genomes[0].n_inputs,
        op=np.stack([g.func for g in genomes]).astype(np.int16),
        in0=np.stack([g.a for g in genomes]).astype(np.int32),
        in1=np.stack([g.b for g in genomes]).astype(np.int32),
        outputs=np.stack([g.out for g in genomes]).astype(np.int32),
    )


def _area_of(genome: _Genome) -> float:
    return genome.to_netlist().cost().area_mm2


def _errors(genome: _Genome, packed: np.ndarray, true: np.ndarray,
            device: torch.device) -> tuple[float, float]:
    approx = genome.to_netlist().eval_uint(packed, device=device)
    err = np.abs(approx - true)
    return float(err.mean()), float(err.max())


def evolve_popcount(cfg: CGPConfig,
                    exact: Netlist | None = None,
                    eval_set: tuple[np.ndarray, np.ndarray] | None = None,
                    device=None) -> CGPResult:
    """(mu+lambda) CGP search for an approximate popcount under eps <= tau.

    Every generation's children are scored in one batched population call
    on `device` (`cfg.batch_eval`, default) — bit-identical to the serial
    per-child loop, which remains available as the reference path
    (`batch_eval=False`).  Children whose mutations touched only inactive
    genes inherit the parent's error without re-simulation either way.
    `device=None` is the current CUDA device.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_inputs
    exact = exact if exact is not None else popcount_netlist(n)
    assert exact.n_outputs == cfg.n_outputs
    packed, true = eval_set if eval_set is not None else eval_vectors(n)
    # the vector set goes to the device once, not once a generation
    words = CS.words_tensor(CS.pack_words32(packed), device)
    true_dev = torch.from_numpy(np.ascontiguousarray(true)).to(device)

    def fitness(err: tuple[float, float], area: float) -> float:
        e = err[0] if cfg.error_metric == "mae" else err[1]
        return area if e <= cfg.tau else float("inf")

    root = _seed_genome(exact, cfg.n_nodes, rng, cfg.funcs)
    p_err = _errors(root, packed, true, device)
    p_fit = _area_of(root)  # exact circuit always satisfies tau
    evaluations = 1
    history = [(0, p_fit)]
    t0 = time.monotonic()

    mu = max(1, cfg.mu)
    # parents: (genome, fit, err); mu > 1 widens the strategy to mu+lambda
    parents: list[tuple[_Genome, float, tuple[float, float]]] = \
        [(root, p_fit, p_err)] * mu

    best_g, best_fit, best_err = root.copy(), p_fit, p_err
    for it in range(1, cfg.max_iters + 1):
        if cfg.time_limit_s is not None and time.monotonic() - t0 > cfg.time_limit_s:
            break
        # mutate first (sole rng consumer -> identical children either path);
        # one liveness sweep per parent serves all its children
        pmasks = [parents[pi][0].active_nodes() for pi in range(mu)]
        kids: list[tuple[_Genome, bool, int]] = []
        for j in range(cfg.lam):
            pi = j % mu
            child, touched = _mutate(parents[pi][0], cfg, rng, active=pmasks[pi])
            kids.append((child, touched, pi))

        genomes = [k[0] for k in kids]
        errs: list[tuple[float, float]] = [parents[k[2]][2] for k in kids]
        touched_idx = [j for j, k in enumerate(kids) if k[1]]
        if cfg.batch_eval:
            pop = _population_of(genomes)
            areas = pop.areas()
            if touched_idx:
                mae, wc = pop.take(np.array(touched_idx)).pc_errors(
                    words, true_dev, device=device)
                for s, j in enumerate(touched_idx):
                    errs[j] = (float(mae[s]), float(wc[s]))
        else:  # serial reference: the original per-child Netlist loop
            areas = [_area_of(g) for g in genomes]
            for j in touched_idx:
                errs[j] = _errors(genomes[j], packed, true, device)
        evaluations += len(touched_idx)
        fits = [fitness(errs[j], float(areas[j])) for j in range(cfg.lam)]

        if mu == 1:
            j = int(np.argmin(fits))          # first minimum, like min(...)
            c_fit, c_err, child = fits[j], errs[j], genomes[j]
            p_fit = parents[0][1]
            # <= : accept neutral moves (CGP drift)
            if c_fit <= (p_fit if np.isfinite(p_fit) else float("inf")):
                parents = [(child, c_fit, c_err)]
        else:
            # truncation selection over parents+children; children first so
            # equal-fitness ties drift to the new genome
            pool = ([(fits[j], errs[j], genomes[j]) for j in range(cfg.lam)]
                    + [(f, e, g) for (g, f, e) in parents])
            pool.sort(key=lambda t: t[0])
            parents = [(g, f, e) for (f, e, g) in pool[:mu]]
            c_fit, c_err, child = pool[0]
        if c_fit < best_fit:
            best_g, best_fit, best_err = child.copy(), c_fit, c_err
            history.append((it, best_fit))

    name = f"pc{n}_cgp_{cfg.error_metric}{cfg.tau:g}_s{cfg.seed}"
    best_nl = best_g.to_netlist(name=name)
    best_nl.meta.update({"n": n, "tau": cfg.tau, "metric": cfg.error_metric,
                         "mae": best_err[0], "wcae": best_err[1]})
    return CGPResult(best=best_nl, best_area=best_fit, best_error=best_err,
                     history=history, evaluations=evaluations)


def tau_schedule(n: int, n_points: int = 6) -> list[tuple[str, float]]:
    """The paper's error-limit grid: tau_mae log-spaced in [0.1, 0.5*2^m],
    tau_wcae log-spaced in [1, 0.5*2^m], with m = ceil(log2 n)."""
    m = max(1, int(np.ceil(np.log2(n))))
    hi = 0.5 * (1 << m)
    taus_mae = np.geomspace(0.1, hi, n_points)
    taus_wcae = np.geomspace(1.0, hi, n_points)
    return [("mae", float(t)) for t in taus_mae] + [("wcae", float(t)) for t in taus_wcae]


def _truncation_stats(n: int, packed, true, device=None
                      ) -> list[tuple[Netlist, float, float, float]]:
    """(netlist, mae, wcae, area) for every truncation depth, evaluated in a
    single padded population call (shared by all tau points)."""
    nls = [truncated_popcount_netlist(n, drop) for drop in range(1, n - 1)]
    if not nls:
        return []
    pop = NetlistPopulation.from_netlists(nls)
    mae, wcae = pop.pc_errors(packed, true, device=device)
    areas = pop.areas()
    return [(nl, float(mae[i]), float(wcae[i]), float(areas[i]))
            for i, nl in enumerate(nls)]


def _best_feasible_seed(n: int, metric: str, tau: float,
                        packed, true,
                        trunc_stats=None, device=None) -> Netlist:
    """Cheapest known-feasible start: the exact tree or a truncated variant
    already satisfying tau (warm-starting CGP from the truncation baseline
    converges far faster than from the exact circuit alone)."""
    stats = trunc_stats if trunc_stats is not None else _truncation_stats(
        n, packed, true, device)
    best = popcount_netlist(n)
    best_area = best.cost().area_mm2
    for nl, mae, wcae, a in stats:
        err = mae if metric == "mae" else wcae
        if err <= tau and a < best_area:
            best, best_area = nl, a
    return best


def evolve_pc_library(n: int,
                      n_points: int = 4,
                      max_iters: int = 800,
                      n_nodes: int | None = None,
                      seed: int = 0,
                      time_limit_s: float | None = None,
                      parallel: bool = True,
                      n_workers: int | None = None,
                      device=None,
                      results: list[CGPResult] | None = None) -> list[Netlist]:
    """Evolve a small library of approximate n-input popcounts across the tau
    grid.  Always includes the exact circuit as the zero-error member.

    The tau-schedule points are independent (1+lambda) runs with disjoint
    seeds.  On the CPU they execute concurrently in a thread pool
    (`parallel`, default on; the plain gate walk's tensor ops release the
    interpreter lock).  On a CUDA device they run one after another: a
    generation's fitness there is about a millisecond and the rest is numpy
    liveness and area work under the interpreter lock, on which the pool's
    threads queue at every wait for the card — 7x slower than one after
    another at n = 130 on an H100 host.  Results are collected in schedule
    order — the library is deterministic either way.
    Wall-clock-limited runs are the exception: under `time_limit_s` the
    per-point generation counts depend on core contention, so those runs
    stay sequential to preserve the pre-existing (deterministic-per-machine)
    behavior.  `device=None` is the current CUDA device.  `results`, when
    given, receives each point's `CGPResult` in schedule order (its
    `evaluations` count the children simulated).
    """
    device = resolve_device(device)
    exact = popcount_netlist(n)
    exact.meta.update({"mae": 0.0, "wcae": 0.0, "tau": 0.0, "metric": "exact"})
    packed, true = eval_vectors(n)
    grid = n_nodes if n_nodes is not None else max(exact.n_gates + 16, int(exact.n_gates * 1.5))
    trunc_stats = _truncation_stats(n, packed, true, device)
    points = tau_schedule(n, n_points)

    def run_point(i: int, metric: str, tau: float) -> CGPResult:
        seed_nl = _best_feasible_seed(n, metric, tau, packed, true, trunc_stats)
        cfg = CGPConfig(n_inputs=n, n_outputs=popcount_width(n), n_nodes=grid,
                        seed=seed + i, max_iters=max_iters, tau=tau,
                        error_metric=metric, time_limit_s=time_limit_s)
        return evolve_popcount(cfg, exact=seed_nl, eval_set=(packed, true),
                               device=device)

    if parallel and device.type == "cpu" and time_limit_s is None \
            and len(points) > 1:
        workers = n_workers or min(len(points), os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            runs = list(ex.map(lambda a: run_point(*a),
                               [(i, m, t) for i, (m, t) in enumerate(points)]))
    else:
        runs = [run_point(i, m, t) for i, (m, t) in enumerate(points)]
    if results is not None:
        results.extend(runs)

    lib = [exact]
    for res in runs:
        if np.isfinite(res.best_area):
            lib.append(res.best)
    # dedupe by (area, mae) signature
    seen, out = set(), []
    for nl in lib:
        key = (round(nl.cost().area_mm2, 6), round(nl.meta.get("mae", 0.0), 6))
        if key not in seen:
            seen.add(key)
            out.append(nl)
    return out
