"""The general generator: the same seed gives the same traffic, every
seed the same set of sizes."""
import numpy as np
import pytest
import torch

from bench import gen, harness

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)


def cycles(mix, seed, n=2, vocab=1000):
    it = gen.serve_calls(mix, vocab, seed)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_calls_repeat_for_a_seed(seed):
    mix = harness.load_json(harness.BENCH / "traffic" / "prefill_calls.json")
    assert cycles(mix, seed) == cycles(mix, seed)


def test_serve_calls_differ_by_seed_but_not_in_sizes():
    mix = harness.load_json(harness.BENCH / "traffic" / "prefill_calls.json")
    a, b = cycles(mix, 1, 1)[0], cycles(mix, 2, 1)[0]
    assert a != b
    sizes = [sorted(sorted(len(p) for p in c.prompts) for c in cyc)
             for cyc in (a, b)]
    assert sizes[0] == sizes[1]
    lens = [len(p) for c in a for p in c.prompts]
    n = len(lens)
    for plen, share in zip(mix["prompt_lengths"], mix["length_shares"]):
        assert lens.count(plen) == round(n * share)


def test_quota_keeps_the_count_and_the_shares():
    assert sorted(gen.quota(10, [1, 2, 3], [0.5, 0.3, 0.2])) == \
        [1] * 5 + [2] * 3 + [3] * 2
    assert len(gen.quota(7, [1, 2, 3], [0.5, 0.3, 0.2])) == 7


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_for_a_seed(seed):
    mix = dict(harness.load_json(harness.BENCH / "traffic"
                                 / "train_stage.json"),
               seq_len=16, batch_pool=3)
    a = gen.train_batches(mix, 512, seed, "cpu")
    b = gen.train_batches(mix, 512, seed, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
    rows = torch.cat([x["tokens"] for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)


def test_train_batches_differ_by_seed():
    mix = dict(harness.load_json(harness.BENCH / "traffic"
                                 / "train_stage.json"),
               seq_len=16, batch_pool=1)
    a = gen.train_batches(mix, 512, 1, "cpu")[0]["tokens"]
    b = gen.train_batches(mix, 512, 2, "cpu")[0]["tokens"]
    assert not torch.equal(a, b)


def test_token_copy_equals_the_ports_stream():
    tokens = pytest.importorskip("repro_torch.data.tokens")
    from bench import tokens as frozen
    kw = dict(vocab=300, seq_len=24, global_batch=3, seed=99)
    a = tokens.TokenPipeline(tokens.TokenPipelineConfig(**kw), "cpu")
    b = frozen.TokenPipeline(frozen.TokenPipelineConfig(**kw), "cpu")
    for step in (0, 5):
        assert torch.equal(a.batch_at(step)["tokens"],
                           b.batch_at(step)["tokens"])


@pytest.mark.parametrize("name", ["rwkv6-7b", "qwen2.5-14b-ternary"])
def test_weights_repeat_and_each_layer_draws_alone(name):
    from bench import weights
    from bench.tests import tiny
    config = tiny.config(name)
    a = weights.draw(config, 5, "cpu", 3)
    b = weights.draw(config, 5, "cpu", 3)
    c = weights.draw(config, 6, "cpu", 3)
    lp = weights.draw_layer(config, 5, "cpu", 2)
    from bench.drivers import flat
    fa, fb, fc, fl = flat(a), flat(b), flat(c), flat(lp)
    for k, v in fa.items():
        assert torch.equal(v, fb[k])
        assert not torch.equal(v, fc[k])
        if k.startswith("layers."):
            assert torch.equal(v[2], fl[k[len("layers."):]])


def test_each_request_keeps_its_layout_slot():
    mix = harness.load_json(harness.BENCH / "traffic" / "prefill_calls.json")
    layout = gen.call_layout(mix)
    per = mix["requests_per_call"]
    for cyc in cycles(mix, 5, 2):
        seen = []
        for call in cyc:
            for p, nt, slot in zip(call.prompts, call.new_tokens, call.slots):
                assert (len(p), nt) == layout[slot // per][slot % per]
                seen.append(slot)
        assert sorted(seen) == list(range(per * len(layout)))
