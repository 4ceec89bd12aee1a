"""Island state + deterministic ring migration of Pareto-front elites.

The port of `repro.evolve.islands`, copied as it is: numpy on the host.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.nsga2 import (NSGA2State, crowding_distance,
                                   extract_front, fast_non_dominated_sort)


def select_elites(state: NSGA2State, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Up to `k` Pareto-front members (deduped, sorted by obj0) with their F."""
    X, F = extract_front(state.pop, state.F)
    return X[:k], F[:k]


def _replacement_order(F: np.ndarray) -> np.ndarray:
    """Indices worst-first: highest rank, then lowest crowding, then highest
    index — a total order with no RNG, so migration is deterministic."""
    N = F.shape[0]
    rank = np.empty(N, dtype=np.int64)
    crowd = np.empty(N)
    for r, fr in enumerate(fast_non_dominated_sort(F)):
        rank[fr] = r
        crowd[fr] = crowding_distance(F[fr])
    crowd = np.nan_to_num(crowd, posinf=np.finfo(np.float64).max)
    return np.lexsort((-np.arange(N), crowd, -rank))


def migrate_ring(states: list[NSGA2State], k: int) -> int:
    """Copy each island's top-`k` front elites into its ring successor.

    Elites are chosen from the *pre-migration* snapshot of every island, so
    the result is independent of island iteration order; they overwrite the
    receiver's worst-ranked individuals (objective values travel with the
    chromosomes — no re-evaluation).  Returns the number of migrants placed.
    """
    n = len(states)
    if n < 2 or k < 1:
        return 0
    elites = [select_elites(s, k) for s in states]
    placed = 0
    for dst in range(n):
        ex, ef = elites[(dst - 1) % n]
        if not len(ex):
            continue
        state = states[dst]
        worst = _replacement_order(state.F)[: len(ex)]
        state.pop[worst] = ex
        state.F[worst] = ef
        placed += len(ex)
    return placed


class ParetoArchive:
    """Global non-dominated archive across all islands and epochs.

    Maintains (X, F) pairs: dominated rows are dropped on every update,
    duplicate chromosomes collapse to one row, and the archive is kept in a
    canonical order (obj0, obj1, chromosome bytes) so two campaigns with
    identical trajectories serialize byte-identically.
    """

    def __init__(self, n_genes: int,
                 X: np.ndarray | None = None, F: np.ndarray | None = None):
        self.X = (np.zeros((0, n_genes), dtype=np.int64) if X is None
                  else np.asarray(X, dtype=np.int64))
        self.F = (np.zeros((0, 2), dtype=np.float64) if F is None
                  else np.asarray(F, dtype=np.float64))

    def __len__(self) -> int:
        return int(self.X.shape[0])

    def update(self, X: np.ndarray, F: np.ndarray) -> None:
        X = np.concatenate([self.X, np.asarray(X, dtype=np.int64)], axis=0)
        F = np.concatenate([self.F, np.asarray(F, dtype=np.float64)], axis=0)
        if not X.shape[0]:
            return
        # drop duplicate chromosomes (first occurrence wins)
        _, uniq = np.unique(X, axis=0, return_index=True)
        keep = np.sort(uniq)
        X, F = X[keep], F[keep]
        front = fast_non_dominated_sort(F)[0]
        X, F = X[front], F[front]
        order = np.lexsort(
            (np.array([x.tobytes() for x in X]), F[:, 1], F[:, 0]))
        self.X, self.F = X[order], F[order]

    def rows(self) -> list[dict]:
        """JSON-ready archive rows (chromosome + objectives)."""
        return [{"x": x.tolist(), "f": [float(f0), float(f1)]}
                for x, (f0, f1) in zip(self.X, self.F)]
