"""Phase 3 — NSGA-II multi-objective integration (Deb et al. 2002).

The paper encodes an approximate TNN as an integer chromosome: one gene per
neuron, indexing into that neuron's candidate list (PCC library entries for
hidden neurons, PC library entries for output neurons).  Objectives are
(1 - accuracy, total estimated area), both minimized.  Operators follow the
paper's pymoo setup: simulated-binary crossover + polynomial mutation adapted
to integers (value rounded + clipped to the per-gene domain).

The port of `repro.core.nsga2`, copied as it is: numpy on the host, the
same random stream and the same archives as the reference's, bit for bit.
The objective callback is where the device work happens
(`core.tnn.TNNApproxProblem.objective`).

This module is problem-agnostic: `nsga2(...)` takes per-gene domain sizes and
a vectorized objective callback, so tests can drive it on synthetic problems
and `core.tnn` uses it for the real TNN integration.

Stepwise API
------------
`NSGA2Driver` exposes the same algorithm one generation at a time over an
explicit `NSGA2State` (population, objectives, generation counter, RNG).
Everything the next generation depends on lives in the state, so a driver
rebuilt in a fresh process from a checkpointed state continues the *exact*
generation sequence — the substrate of the reference's resumable
island-model campaigns (`repro.evolve`).  `nsga2()` is a thin wrapper over
the driver.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class NSGA2Config:
    pop_size: int = 40
    n_generations: int = 60
    crossover_prob: float = 0.9
    crossover_eta: float = 15.0
    mutation_eta: float = 20.0
    mutation_prob: float | None = None   # default 1/n_genes
    seed: int = 0
    dedup_eval: bool = True              # memoize duplicate chromosomes


@dataclass
class NSGA2Result:
    pareto_x: np.ndarray     # (P, n_genes) int
    pareto_f: np.ndarray     # (P, 2) objectives
    history: list[tuple[int, float, float]] = field(default_factory=list)
    # history rows: (generation, best obj0 on front, best obj1 on front)


# ---------------------------------------------------------------------------
# Core NSGA-II machinery
# ---------------------------------------------------------------------------
def fast_non_dominated_sort(F: np.ndarray) -> list[np.ndarray]:
    """Return fronts (lists of indices), best first. F: (N, M) minimized."""
    N = F.shape[0]
    # dominates[i, j] = i dominates j
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    dom = le & lt
    n_dominated = dom.sum(0)         # how many dominate each j
    fronts = []
    current = np.where(n_dominated == 0)[0]
    assigned = np.zeros(N, dtype=bool)
    while current.size:
        fronts.append(current)
        assigned[current] = True
        n_dominated = n_dominated - dom[current].sum(0)
        nxt = np.where((n_dominated == 0) & ~assigned)[0]
        current = nxt
    return fronts


def crowding_distance(F: np.ndarray) -> np.ndarray:
    N, M = F.shape
    if N <= 2:
        return np.full(N, np.inf)
    dist = np.zeros(N)
    for m in range(M):
        order = np.argsort(F[:, m], kind="stable")
        fmin, fmax = F[order[0], m], F[order[-1], m]
        dist[order[0]] = dist[order[-1]] = np.inf
        if fmax - fmin > 1e-15:
            dist[order[1:-1]] += (F[order[2:], m] - F[order[:-2], m]) / (fmax - fmin)
    return dist


def _tournament(rank, crowd, rng, k=2):
    cand = rng.integers(rank.shape[0], size=k)
    best = cand[0]
    for c in cand[1:]:
        if (rank[c] < rank[best]) or (rank[c] == rank[best] and crowd[c] > crowd[best]):
            best = c
    return best


def _sbx_int(p1, p2, domains, eta, prob, rng):
    """Integer-adapted simulated binary crossover."""
    c1, c2 = p1.astype(np.float64).copy(), p2.astype(np.float64).copy()
    if rng.random() < prob:
        for i in range(p1.shape[0]):
            if rng.random() < 0.5 and abs(p1[i] - p2[i]) > 1e-12:
                x1, x2 = sorted((float(p1[i]), float(p2[i])))
                u = rng.random()
                beta = (2 * u) ** (1 / (eta + 1)) if u <= 0.5 else (1 / (2 * (1 - u))) ** (1 / (eta + 1))
                c1[i] = 0.5 * ((x1 + x2) - beta * (x2 - x1))
                c2[i] = 0.5 * ((x1 + x2) + beta * (x2 - x1))
    hi = domains.astype(np.float64) - 1
    c1 = np.clip(np.rint(c1), 0, hi).astype(np.int64)
    c2 = np.clip(np.rint(c2), 0, hi).astype(np.int64)
    return c1, c2


def _poly_mutate_int(x, domains, eta, prob, rng):
    y = x.astype(np.float64).copy()
    hi = domains.astype(np.float64) - 1
    for i in range(x.shape[0]):
        if hi[i] <= 0 or rng.random() >= prob:
            continue
        u = rng.random()
        delta = (2 * u) ** (1 / (eta + 1)) - 1 if u < 0.5 else 1 - (2 * (1 - u)) ** (1 / (eta + 1))
        y[i] = y[i] + delta * hi[i]
    return np.clip(np.rint(y), 0, hi).astype(np.int64)


def _memoized(objective: Callable[[np.ndarray], np.ndarray],
              maxsize: int | None = None
              ) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap a batched objective with a bounded chromosome-level LRU cache.

    Integer GAs re-visit identical chromosomes constantly (SBX clones
    parents, elitism carries survivors across generations); with circuit-
    level fitness each duplicate costs a full batched simulation.  Only
    never-seen rows reach the wrapped objective — results are unchanged for
    any row-independent objective (the batched-evaluator contract), and
    LRU eviction (`maxsize`) cannot change them either: an evicted
    chromosome that reappears is simply re-evaluated to the same value.
    `maxsize=None` keeps the cache unbounded (the historical behavior);
    long campaigns should bound it so memory cannot grow with the number
    of distinct chromosomes ever visited.

    `evaluate.cache_info()` reports cumulative hits / misses / evictions
    plus the current size — `Campaign` folds these into its per-epoch
    cache history rows.
    """
    from collections import OrderedDict

    cache: OrderedDict[bytes, np.ndarray] = OrderedDict()
    stats = {"hits": 0, "misses": 0, "evictions": 0}

    def evaluate(X: np.ndarray) -> np.ndarray:
        X = np.ascontiguousarray(X)
        keys = [row.tobytes() for row in X]
        fresh_rows, fresh_keys, seen = [], [], set()
        for i, k in enumerate(keys):
            if k in cache:
                cache.move_to_end(k)
                stats["hits"] += 1
            elif k not in seen:
                seen.add(k)
                fresh_rows.append(i)
                fresh_keys.append(k)
        fresh: dict[bytes, np.ndarray] = {}
        if fresh_rows:
            stats["misses"] += len(fresh_keys)
            F = objective(X[np.array(fresh_rows)])
            for k, f in zip(fresh_keys, F):
                fresh[k] = np.asarray(f, dtype=np.float64)
        # gather BEFORE eviction so a tiny maxsize can never evict a row
        # this very batch still needs
        out = np.stack([cache.get(k, fresh.get(k)) for k in keys])
        cache.update(fresh)
        if maxsize is not None:
            while len(cache) > maxsize:
                cache.popitem(last=False)
                stats["evictions"] += 1
        return out

    def cache_info() -> dict:
        return {**stats, "size": len(cache), "maxsize": maxsize}

    evaluate.cache_clear = cache.clear    # data drifted -> memo is stale
    evaluate.cache_info = cache_info
    return evaluate


# ---------------------------------------------------------------------------
# Stepwise (resumable) API
# ---------------------------------------------------------------------------
def encode_rng_state(rng: np.random.Generator) -> dict:
    """Serialize a Generator's bit-generator state to msgpack-safe types.

    PCG64 carries 128-bit integers, which overflow msgpack's int64 — encode
    every int as a hex string and restore with `decode_rng_state`.
    """
    def enc(v):
        if isinstance(v, dict):
            return {k: enc(x) for k, x in v.items()}
        if isinstance(v, (int, np.integer)):
            return f"0x{int(v):x}"
        return v

    return enc(rng.bit_generator.state)


def decode_rng_state(state: dict) -> np.random.Generator:
    """Inverse of `encode_rng_state`: rebuild a Generator mid-stream."""
    def dec(v):
        if isinstance(v, dict):
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, str) and v.startswith("0x"):
            return int(v, 16)
        return v

    decoded = dec(state)
    bg = getattr(np.random, decoded["bit_generator"])()
    bg.state = decoded
    return np.random.Generator(bg)


@dataclass
class NSGA2State:
    """Everything generation g+1 depends on.  Checkpoint `pop`/`F` as arrays
    and the RNG via `encode_rng_state` for bit-identical resume."""

    pop: np.ndarray          # (pop_size, n_genes) int chromosomes
    F: np.ndarray            # (pop_size, 2) float objectives
    generation: int
    rng: np.random.Generator
    history: list[tuple[int, float, float]] = field(default_factory=list)


def extract_front(pop: np.ndarray, F: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Current Pareto front, deduped by objectives and sorted by obj0."""
    fronts = fast_non_dominated_sort(F)
    fr0 = fronts[0]
    # dedupe identical objective rows for a clean reported front
    _, uniq = np.unique(np.round(F[fr0], 10), axis=0, return_index=True)
    sel = fr0[np.sort(uniq)]
    order = np.argsort(F[sel, 0], kind="stable")
    return pop[sel[order]], F[sel[order]]


class NSGA2Driver:
    """One NSGA-II problem instance, advanced one generation at a time.

    The evaluator (with its dedup cache) lives on the driver, not the state:
    the cache is a pure memoization of a row-independent objective, so a
    resumed driver with a cold cache replays the identical trajectory.
    `on_generation(state)` fires after each completed generation — the
    archive hook a campaign uses to fold island fronts into a global Pareto
    archive without re-evaluating anything.
    """

    def __init__(self, domains: np.ndarray,
                 objective: Callable[[np.ndarray], np.ndarray],
                 cfg: NSGA2Config,
                 evaluate: Callable[[np.ndarray], np.ndarray] | None = None,
                 on_generation: Callable[["NSGA2State"], None] | None = None):
        self.domains = np.asarray(domains)
        self.cfg = cfg
        self.n_genes = int(self.domains.shape[0])
        self.mut_prob = (cfg.mutation_prob if cfg.mutation_prob is not None
                         else 1.0 / max(1, self.n_genes))
        self.evaluate = (evaluate if evaluate is not None
                         else (_memoized(objective) if cfg.dedup_eval
                               else objective))
        self.on_generation = on_generation

    # -- lifecycle -----------------------------------------------------------
    def init_state(self, seed_population: np.ndarray | None = None
                   ) -> NSGA2State:
        rng = np.random.default_rng(self.cfg.seed)
        pop = rng.integers(0, self.domains[None, :],
                           size=(self.cfg.pop_size, self.n_genes))
        if seed_population is not None:
            k = min(seed_population.shape[0], self.cfg.pop_size)
            pop[:k] = seed_population[:k]
        return NSGA2State(pop=pop, F=self.evaluate(pop), generation=0, rng=rng)

    def restore_state(self, pop: np.ndarray, F: np.ndarray, generation: int,
                      rng_state: dict,
                      history: list[tuple[int, float, float]] | None = None
                      ) -> NSGA2State:
        """Rebuild a state from checkpointed pieces (RNG mid-stream)."""
        return NSGA2State(pop=np.asarray(pop, dtype=np.int64),
                          F=np.asarray(F, dtype=np.float64),
                          generation=int(generation),
                          rng=decode_rng_state(rng_state),
                          history=list(history or []))

    # -- one generation ------------------------------------------------------
    def step(self, state: NSGA2State) -> NSGA2State:
        cfg, domains, rng = self.cfg, self.domains, state.rng
        pop, F = state.pop, state.F
        fronts = fast_non_dominated_sort(F)
        rank = np.empty(cfg.pop_size, dtype=np.int64)
        crowd = np.empty(cfg.pop_size)
        for r, fr in enumerate(fronts):
            rank[fr] = r
            crowd[fr] = crowding_distance(F[fr])
        state.history.append((state.generation, float(F[fronts[0], 0].min()),
                              float(F[fronts[0], 1].min())))

        children = []
        while len(children) < cfg.pop_size:
            i1 = _tournament(rank, crowd, rng)
            i2 = _tournament(rank, crowd, rng)
            c1, c2 = _sbx_int(pop[i1], pop[i2], domains, cfg.crossover_eta,
                              cfg.crossover_prob, rng)
            children.append(_poly_mutate_int(c1, domains, cfg.mutation_eta,
                                             self.mut_prob, rng))
            if len(children) < cfg.pop_size:
                children.append(_poly_mutate_int(c2, domains, cfg.mutation_eta,
                                                 self.mut_prob, rng))
        Q = np.stack(children)
        FQ = self.evaluate(Q)

        R = np.concatenate([pop, Q], axis=0)
        FR = np.concatenate([F, FQ], axis=0)
        fronts = fast_non_dominated_sort(FR)
        new_idx: list[int] = []
        for fr in fronts:
            if len(new_idx) + fr.size <= cfg.pop_size:
                new_idx.extend(fr.tolist())
            else:
                cd = crowding_distance(FR[fr])
                order = np.argsort(-cd, kind="stable")
                need = cfg.pop_size - len(new_idx)
                new_idx.extend(fr[order[:need]].tolist())
                break
        state.pop, state.F = R[new_idx], FR[new_idx]
        state.generation += 1
        if self.on_generation is not None:
            self.on_generation(state)
        return state

    def result(self, state: NSGA2State) -> NSGA2Result:
        px, pf = extract_front(state.pop, state.F)
        return NSGA2Result(pareto_x=px, pareto_f=pf, history=state.history)


def nsga2(domains: np.ndarray,
          objective: Callable[[np.ndarray], np.ndarray],
          cfg: NSGA2Config,
          seed_population: np.ndarray | None = None) -> NSGA2Result:
    """Minimize a 2-objective function over integer chromosomes.

    domains:  (n_genes,) number of choices per gene (gene i in [0, domains[i})).
    objective: (N, n_genes) int -> (N, 2) float, both minimized; rows must be
        independent (the population-parallel fitness contract), which lets
        duplicate chromosomes be served from a cache (`cfg.dedup_eval`).
    seed_population: optional known-good individuals (e.g. the all-exact TNN).
    """
    driver = NSGA2Driver(domains, objective, cfg)
    state = driver.init_state(seed_population)
    for _ in range(cfg.n_generations):
        state = driver.step(state)
    return driver.result(state)
