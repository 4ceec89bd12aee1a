"""Every reference arch served by the port's `ServingEngine` on the CPU,
at reduced size.

* `ServingEngine` against `repro.serve.lm_engine.ServingEngine` on the
  same numpy weights (random packed codes under ternary_packed; the dense
  modes for hymba and RWKV-6, which serve dense only): the same tokens for
  every request, prompts in two buckets with `max_batch` smaller than one,
  the stub frontends (zero vision embeddings and M-RoPE ids, zero frame
  embeddings) built by both engines.  Greedy tokens are decided by the top
  logit, so every step's top-2 margin in the port is asserted above the
  logits tolerance of `tests/test_torch_transformer.py` (1e-4).

The CLI's runs are in `tests/test_torch_lm_families_cli.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import lm_engine as RE  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serve import lm_engine as E  # noqa: E402

from torch_lm_reference import ATOL, cfgs, numpy_tree, ref_params  # noqa: E402,E501

DENSE_ONLY = {"hymba-1.5b", "rwkv6-7b"}


def _requests(module, vocab: int):
    rng = np.random.default_rng(8)
    # 5 <= the reduced sliding window (8), 8 == it; both >= 4 vision tokens
    return [module.Request(uid=i, prompt=rng.integers(1, vocab, n).tolist(),
                           max_new_tokens=4)
            for i, n in enumerate([5, 5, 5, 8])]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_gives_the_reference_tokens(arch, monkeypatch):
    quant = "dense" if arch in DENSE_ONLY else "ternary_packed"
    cfg, rcfg = cfgs(arch, quant)
    tree = numpy_tree(cfg, seed=9)
    margins = []

    def record(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            logits = out[0] if isinstance(out, tuple) else out
            top2 = torch.topk(logits.reshape(-1, logits.shape[-1]), 2).values
            margins.extend((top2[:, 0] - top2[:, 1]).tolist())
            return out
        return wrapped

    monkeypatch.setattr(TF, "decode_step", record(TF.decode_step))
    monkeypatch.setattr(TF, "logits_from_hidden",
                        record(TF.logits_from_hidden))
    got = E.ServingEngine(cfg, P.params_from_reference(tree, device="cpu"),
                          max_batch=2, cache_len=16, device="cpu").run(
        _requests(E, cfg.vocab))
    want = RE.ServingEngine(rcfg, ref_params(tree), max_batch=2,
                            cache_len=16).run(_requests(RE, cfg.vocab))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 4 for r in got)
    assert margins and min(margins) > ATOL
