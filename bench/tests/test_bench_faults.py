"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run (no look for a card; the cell's own
limits; tiny sizes on the CPU in float32, where a sound run reads far
below them) with one fault planted in the program: a served token
altered where the head produces it; half of each prefill group left out
(its rows answered from the other half); every layer skipped, the state
returned unchanged; an optimizer step that returns its state unchanged;
half of each microbatch left out, the mean taken over the rest.  A
sound run of each cell is shown correct beside them.
"""
import pytest
import torch

from bench.devtrace import wrapped
from bench.drivers import serve_calls, train_steps
from bench.tests import tiny

SERVE = ["qwen2.5-14b-ternary.prefill", "rwkv6-7b.prefill"]


def token_altered(TF, L):
    def wrap(head):
        def f(cfg, params, x):
            return head(cfg, params, x).roll(1, dims=-1)
        return f
    return wrapped(TF, "logits_from_hidden", wrap)


def half_group(TF, L):
    def wrap(prefill):
        def f(cfg, params, batch, cache_len):
            tok = batch["tokens"]
            h = max(1, tok.shape[0] // 2)
            x, cache = prefill(cfg, params, dict(batch, tokens=tok[:h]),
                               cache_len)
            idx = torch.arange(tok.shape[0]) % h
            return x[idx], cache
        return f
    return wrapped(TF, "prefill", wrap)


def layers_skipped(TF, L):
    def wrap(block):
        def f(cfg, lp, x, **kw):
            _, aux, entry = block(cfg, lp, x, **kw)
            return x, aux, entry
        return f
    return wrapped(TF, "apply_block", wrap)


def state_unchanged(TF, L):
    def wrap(update):
        def f(cfg, loop_cfg, params, grads, opt_state, err_buf=None):
            return params, opt_state, err_buf
        return f
    return wrapped(L, "update", wrap)


def half_microbatch(TF, L):
    def wrap(grads_of):
        def f(cfg, params, batch):
            h = batch["tokens"].shape[0] // 2
            return grads_of(cfg, params, {k: v[:h] for k, v in
                                          batch.items()})
        return f
    return wrapped(L, "grads_of", wrap)


def modules():
    from repro_torch.models import transformer as TF
    from repro_torch.train import loop as L
    return TF, L


@pytest.mark.parametrize("cell", SERVE)
def test_sound_serving_run_is_correct(cell):
    run = serve_calls.run(tiny.serve_ctx(cell, dtype="float32"))
    assert run.correct, run.checks
    assert run.failed == 0


@pytest.mark.parametrize("fault", [token_altered, half_group, layers_skipped])
@pytest.mark.parametrize("cell", SERVE)
def test_broken_serving_run_is_not_correct(cell, fault):
    with fault(*modules()):
        run = serve_calls.run(tiny.serve_ctx(cell, dtype="float32"))
    assert not run.correct, run.checks


def test_sound_training_run_is_correct():
    run = train_steps.run(tiny.train_ctx(dtype="float32"))
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", [state_unchanged, half_microbatch])
def test_broken_training_run_is_not_correct(fault):
    with fault(*modules()):
        run = train_steps.run(tiny.train_ctx(dtype="float32"))
    assert not run.correct, run.checks
