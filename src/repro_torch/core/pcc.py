"""Phase 2 — approximate popcount-compare (PCC) circuits + Pareto analysis.

A hidden-layer ternary neuron computes Eq. (2):

    popcount(inputs with w=+1)  >=  popcount(inputs with w=-1)

A PCC circuit = PC(n_pos) + PC(n_neg) + j-bit comparator.  Approximating it
with Hamming distance on the single-bit output is misleading (Sec. 4.1.2), so
the paper defines the *distance metric*:

    D(x, z) = 0      if rel(x,z) == rel'(x,z)
              x - z  otherwise                                   (Eq. 4)

and eps_mde / eps_wcde as mean/max |D| over the input domain G (Eq. 5),
estimated over 1e6 random (x, z) pairs.  Pareto-optimal (eps_mde, est. area)
combinations of approximate PCs form the PCC library used by Phase 3.

Library construction is population-parallel: per (n_pos, n_neg) size one
shared sample domain is drawn, every positive/negative PC candidate is
simulated once through a padded `NetlistPopulation` batch — one launch a
side on `device` — and all candidate *pairs* are scored from the cached
outputs on the host, instead of re-sampling and re-simulating both circuits
for each of the |pos| x |neg| combinations.

The port of `repro.core.pcc`: sampling, pair statistics and the Pareto
selection are the reference's numpy code; the libraries are equal bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.circuits import (
    Netlist,
    NetlistPopulation,
    compose_pcc,
    pack_vectors,
    popcount_netlist,
    popcount_of_packed,
)


@dataclass
class PCCEntry:
    """One approximate PCC candidate (a pair of PC circuits + comparator)."""

    n_pos: int
    n_neg: int
    pc_pos: Netlist
    pc_neg: Netlist
    est_area: float          # sum of PC areas (the paper's Phase-2 proxy)
    mde: float               # eps_mde over the sampled domain
    wcde: float              # eps_wcde
    correct_frac: float      # fraction of error-free PCC decisions
    netlist: Netlist | None = None   # composed circuit (built lazily)

    def compose(self) -> Netlist:
        if self.netlist is None:
            self.netlist = compose_pcc(self.pc_pos, self.pc_neg, self.n_pos, self.n_neg)
        return self.netlist

    @property
    def synth_area(self) -> float:
        """'Post-synthesis' area: cost model applied to the composed netlist
        (includes the comparator the Phase-2 estimate ignores, cf. Fig. 6)."""
        return self.compose().cost().area_mm2


@dataclass
class PCCLibrary:
    """Pareto-optimal PCC entries per (n_pos, n_neg) size."""

    entries: dict[tuple[int, int], list[PCCEntry]] = field(default_factory=dict)

    def sizes(self) -> list[tuple[int, int]]:
        return sorted(self.entries)

    def get(self, n_pos: int, n_neg: int) -> list[PCCEntry]:
        return self.entries[(n_pos, n_neg)]

    def __len__(self) -> int:
        return sum(len(v) for v in self.entries.values())


def _rand_bit_matrix(rng: np.random.Generator, n_samples: int, n: int) -> np.ndarray:
    return (rng.random((n_samples, n)) < 0.5).astype(np.uint8)


def evaluate_pcc_pair(pc_pos: Netlist, pc_neg: Netlist, n_pos: int, n_neg: int,
                      n_samples: int = 100_000, seed: int = 0,
                      device=None) -> tuple[float, float, float]:
    """(eps_mde, eps_wcde, correct_frac) of a PC-pair over random samples,
    both circuits simulated on `device` (None: the current CUDA device).

    x = true popcount of the positive vector, z = of the negative vector;
    rel = (x >= z); rel' = (pc_pos'(v_pos) >= pc_neg'(v_neg)).
    """
    pp, pn, x, z = sample_pair_domain(n_pos, n_neg, n_samples, seed)
    xa = pc_pos.eval_uint(pp, device=device)[: n_samples]
    za = pc_neg.eval_uint(pn, device=device)[: n_samples]
    return pair_distance_stats(xa, za, x, z)


def sample_pair_domain(n_pos: int, n_neg: int, n_samples: int, seed: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Shared random (pos, neg) sample domain for one PCC size.

    Returns (packed_pos, packed_neg, x, z): packed uint64 input words plus
    the true popcounts x, z of each sample pair.
    """
    rng = np.random.default_rng(seed)
    pp = pack_vectors(_rand_bit_matrix(rng, n_samples, n_pos))
    pn = pack_vectors(_rand_bit_matrix(rng, n_samples, n_neg))
    x = popcount_of_packed(pp)[:n_samples]
    z = popcount_of_packed(pn)[:n_samples]
    return pp, pn, x, z


def pair_distance_stats(xa: np.ndarray, za: np.ndarray,
                        x: np.ndarray, z: np.ndarray
                        ) -> tuple[float, float, float]:
    """(eps_mde, eps_wcde, correct_frac) from precomputed approximate
    popcounts xa, za over a shared sample domain with true counts x, z."""
    rel = x >= z
    rel_a = xa >= za
    correct = rel == rel_a
    abs_d = np.where(correct, 0, np.abs(x - z))
    return float(abs_d.mean()), float(abs_d.max()), float(correct.mean())


def _pareto_front(points: list[tuple[float, float, int]]) -> list[int]:
    """Indices of the Pareto front minimizing both coords (mde, area)."""
    order = sorted(range(len(points)), key=lambda i: (points[i][0], points[i][1]))
    front, best_area = [], float("inf")
    for i in order:
        if points[i][1] < best_area - 1e-12:
            front.append(i)
            best_area = points[i][1]
    return front


def build_pcc_library(sizes: list[tuple[int, int]],
                      pc_libs: dict[int, list[Netlist]],
                      n_samples: int = 100_000,
                      seed: int = 0,
                      max_per_size: int = 10,
                      device=None) -> PCCLibrary:
    """For every (n_pos, n_neg) size used by the target TNNs: evaluate all
    combinations of approximate PC circuits and keep the Pareto front on
    (eps_mde, estimated area).  Exact PC circuits are the zero-error members.

    Population-parallel: each candidate circuit is simulated exactly once
    over a shared per-size sample domain (padded `NetlistPopulation` batch,
    one launch a side on `device`; None is the current CUDA device); the
    |pos| x |neg| pair statistics then come from the cached outputs.
    """
    lib = PCCLibrary()
    for (n_pos, n_neg) in sizes:
        pos_cands = pc_libs.get(n_pos) or [popcount_netlist(n_pos)]
        neg_cands = pc_libs.get(n_neg) or [popcount_netlist(n_neg)]
        pp, pn, x, z = sample_pair_domain(
            n_pos, n_neg, n_samples, seed + 7919 * n_pos + 104729 * n_neg)
        xa = NetlistPopulation.from_netlists(pos_cands).eval_uint(
            pp, device=device)[:, :n_samples]
        za = NetlistPopulation.from_netlists(neg_cands).eval_uint(
            pn, device=device)[:, :n_samples]
        pos_areas = [c.cost().area_mm2 for c in pos_cands]
        neg_areas = [c.cost().area_mm2 for c in neg_cands]
        cands: list[PCCEntry] = []
        for i, pc_p in enumerate(pos_cands):
            for k, pc_n in enumerate(neg_cands):
                mde, wcde, cf = pair_distance_stats(xa[i], za[k], x, z)
                est = pos_areas[i] + neg_areas[k]
                cands.append(PCCEntry(n_pos, n_neg, pc_p, pc_n, est, mde, wcde, cf))
        pts = [(c.mde, c.est_area, idx) for idx, c in enumerate(cands)]
        front = _pareto_front(pts)[:max_per_size]
        sel = sorted((cands[i] for i in front), key=lambda c: c.mde)
        # index 0 must be the exact PCC (mde == 0 always exists: exact+exact)
        assert sel and sel[0].mde == 0.0
        lib.entries[(n_pos, n_neg)] = sel
    return lib


def pc_pareto(pc_lib: list[Netlist]) -> list[Netlist]:
    """Pareto filter a PC library on (mae, area) — used for output neurons."""
    pts = [(nl.meta.get("mae", 0.0), nl.cost().area_mm2, i) for i, nl in enumerate(pc_lib)]
    front = _pareto_front(pts)
    sel = sorted((pc_lib[i] for i in front), key=lambda nl: nl.meta.get("mae", 0.0))
    assert sel and sel[0].meta.get("mae", 0.0) == 0.0
    return sel
