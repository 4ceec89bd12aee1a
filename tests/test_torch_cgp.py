"""Phase 1 of the port (`repro_torch.core.cgp`) against the reference.

The search is the reference's numpy code and the fitness goes through the
port's gate walk (its plain version on the CPU here), so the trajectory,
the `evaluations` count and the evolved libraries must equal
`repro.core.cgp`'s bit for bit, in the batched and the serial path and
with the tau points run in a thread pool or one after another.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cgp as RG  # noqa: E402
from repro_torch.core import cgp as PG  # noqa: E402


def _same_netlist(a, b):
    assert (a.n_inputs, a.name, a.meta) == (b.n_inputs, b.name, b.meta)
    for k in ("op", "in0", "in1", "outputs"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


def _same_result(a, b):
    _same_netlist(a.best, b.best)
    assert (a.best_area, a.best_error, a.history, a.evaluations) == \
        (b.best_area, b.best_error, b.history, b.evaluations)


@pytest.mark.parametrize("batch_eval", [True, False])
@pytest.mark.parametrize("n,metric,tau,mu", [(4, "mae", 0.4, 1),
                                             (7, "wcae", 2.0, 1),
                                             (6, "mae", 0.3, 2)])
def test_evolve_popcount_equals_reference(n, metric, tau, mu, batch_eval):
    kw = dict(n_inputs=n, n_outputs=RG.popcount_width(n), n_nodes=24 + 2 * n,
              max_iters=40, tau=tau, error_metric=metric, mu=mu, seed=n,
              batch_eval=batch_eval)
    ref = RG.evolve_popcount(RG.CGPConfig(**kw))
    got = PG.evolve_popcount(PG.CGPConfig(**kw), device="cpu")
    _same_result(ref, got)


def test_evolve_popcount_on_a_sampled_vector_set():
    """n > 16: the stratified vector set and a truncated warm start."""
    n = 18
    packed, true = RG.eval_vectors(n, n_samples=1500)
    kw = dict(n_inputs=n, n_outputs=RG.popcount_width(n), n_nodes=120,
              max_iters=15, tau=1.0, seed=2)
    ref = RG.evolve_popcount(RG.CGPConfig(**kw),
                             exact=RG.popcount_netlist(n),
                             eval_set=(packed, true))
    got = PG.evolve_popcount(PG.CGPConfig(**kw),
                             exact=PG.popcount_netlist(n),
                             eval_set=(packed, true), device="cpu")
    _same_result(ref, got)


@pytest.mark.parametrize("parallel", [True, False])
def test_evolve_pc_library_equals_reference(parallel):
    ref = RG.evolve_pc_library(5, n_points=2, max_iters=25, n_nodes=30,
                               seed=1, parallel=parallel)
    runs = []
    got = PG.evolve_pc_library(5, n_points=2, max_iters=25, n_nodes=30,
                               seed=1, parallel=parallel, device="cpu",
                               results=runs)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        _same_netlist(a, b)
    assert len(runs) == 4 and all(r.evaluations > 0 for r in runs)


def test_tau_schedule_and_seed_equal_reference():
    for n in (3, 52, 130):
        assert PG.tau_schedule(n, 2) == RG.tau_schedule(n, 2)
    packed, true = RG.eval_vectors(9)
    for metric, tau in RG.tau_schedule(9, 2):
        _same_netlist(RG._best_feasible_seed(9, metric, tau, packed, true),
                      PG._best_feasible_seed(9, metric, tau, packed, true,
                                             device="cpu"))
