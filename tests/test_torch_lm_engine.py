"""The port's LM serving engine held against `repro.serve.lm_engine`.

Both engines serve the same requests on the same reduced llama3.2-1b
weights (ternary_packed, float32, random packed codes) and must return the
same tokens.  Prompts come in two lengths and `max_batch` is smaller than
a bucket, so groups split; one request stops at its EOS token.  Greedy
decoding is decided by the top logit, so every step's top-2 margin in the
port is asserted above the logits tolerance of
`test_torch_transformer.py` (1e-4): a near-tie cannot decide the test.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import lm_engine as RE  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serve import lm_engine as E  # noqa: E402

from test_torch_transformer import ATOL, numpy_tree, ref_params, reduced  # noqa: E402,E501

ROOT = Path(__file__).resolve().parents[1]


def _requests(module, eos: dict | None = None):
    rng = np.random.default_rng(4)
    plens = [5, 5, 5, 8, 8]
    eos = eos or {}
    return [module.Request(uid=i, prompt=rng.integers(1, 128, n).tolist(),
                           max_new_tokens=6 if i != 4 else 4,
                           eos_id=eos.get(i))
            for i, n in enumerate(plens)]


def test_engines_give_the_same_tokens(monkeypatch):
    cfg = reduced("ternary_packed")
    tree = numpy_tree(cfg, seed=5)
    port = E.ServingEngine(cfg, P.params_from_reference(tree, device="cpu"),
                           max_batch=2, cache_len=16, device="cpu")
    dry = port.run(_requests(E))
    eos = {0: dry[0].output[2]}

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
                          max_batch=2, cache_len=16,
                          device="cpu").run(_requests(E, eos))
    want = RE.ServingEngine(cfg, ref_params(tree), max_batch=2,
                            cache_len=16).run(_requests(RE, eos))
    assert [r.output for r in got] == [r.output for r in want]
    assert len(got[0].output) == 3 and got[0].output[-1] == eos[0]
    assert [len(r.output) for r in got[1:]] == [6, 6, 6, 4]
    assert margins and min(margins) > ATOL


def test_engine_counts_tokens_and_steps():
    cfg = reduced("ternary_packed")
    tree = numpy_tree(cfg, seed=6)
    eng = E.ServingEngine(cfg, P.params_from_reference(tree, device="cpu"),
                          max_batch=2, cache_len=16, device="cpu")
    eng.run(_requests(E))
    s = eng.stats.summary()
    # groups (plen, B): (5, 2), (5, 1), (8, 2), each decoding until its
    # longest request has its 6 tokens: 5 decode steps a group
    assert s["prefills"] == 3
    assert s["prefill_tokens"] == 5 * 3 + 8 * 2
    assert s["decode_steps"] == 5 + 5 + 5
    assert s["decode_tokens"] == 2 * 5 + 1 * 5 + 2 * 5


def test_serve_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--quant", "ternary_packed", "--requests", "3",
         "--max-new", "4"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "(ternary_packed) on cpu" in out.stdout
