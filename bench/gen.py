"""The general traffic generator: every mix is a data file it reads.

A mix (`traffic/<mix>.json`) names its `kind` and parameters.

  * `serve_calls` — calls of `requests_per_call` requests from one client
    in a closed loop.  A cycle of `calls_per_cycle` calls holds the
    prompt lengths and new-token counts in exactly the mix's shares (the
    largest remainders rounded up), laid out over the calls once from
    `layout_seed`, so every run seed serves the same set of calls; the
    run seed orders the calls of each cycle and the requests of each
    call, and draws the token ids, uniform over the vocabulary.
  * `train_steps` — `batch` x `seq_len` tokens a step from the frozen token
    stream (`tokens.py`) seeded by the run seed; a pool of `batch_pool`
    steps, all rows distinct, drawn on the device during set-up and fed
    in turn.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

M32 = 0xFFFFFFFF


def quota(n: int, values: list, shares: list) -> list:
    """`n` values in the given shares: each value's count floored, the
    remainder to the largest fractional parts (ties to the earlier)."""
    raw = [n * s / sum(shares) for s in shares]
    counts = [int(r) for r in raw]
    rest = sorted(range(len(raw)), key=lambda i: (counts[i] - raw[i], i))
    for i in rest[: n - sum(counts)]:
        counts[i] += 1
    return [v for v, c in zip(values, counts) for _ in range(c)]


@dataclass(frozen=True)
class Call:
    """One call's requests: prompts (token-id lists), new tokens, and
    each request's slot in the cycle's layout (call * requests_per_call
    + place in the call)."""
    prompts: tuple
    new_tokens: tuple
    slots: tuple = ()


def call_layout(mix: dict) -> list[list[tuple[int, int]]]:
    """The calls of one cycle as (prompt length, new tokens) pairs: the
    same for every run seed."""
    per, n_calls = mix["requests_per_call"], mix["calls_per_cycle"]
    n = per * n_calls
    rng = np.random.default_rng(mix["layout_seed"])
    lens = rng.permutation(quota(n, mix["prompt_lengths"],
                                 mix["length_shares"]))
    news = rng.permutation(quota(n, mix["new_tokens"],
                                 mix["new_token_shares"]))
    pairs = [(int(a), int(b)) for a, b in zip(lens, news)]
    return [pairs[i * per:(i + 1) * per] for i in range(n_calls)]


def serve_calls(mix: dict, vocab: int, seed: int):
    """Endless calls of `mix` for `seed`, a cycle at a time: yields
    lists of `Call`."""
    layout = call_layout(mix)
    per = mix["requests_per_call"]
    rng = np.random.default_rng(seed)
    while True:
        cycle = []
        for ci in rng.permutation(len(layout)):
            order = rng.permutation(len(layout[ci]))
            pairs = [layout[ci][j] for j in order]
            prompts = tuple(rng.integers(0, vocab, plen).tolist()
                            for plen, _ in pairs)
            cycle.append(Call(prompts, tuple(nt for _, nt in pairs),
                              tuple(int(ci) * per + int(j) for j in order)))
        yield cycle


def warmup_calls(mix: dict, vocab: int) -> list[Call]:
    """One full call per prompt length of the mix (the shapes its traffic
    uses), drawn from a fixed stream."""
    rng = np.random.default_rng(0)
    per = mix["requests_per_call"]
    return [Call(tuple(rng.integers(0, vocab, plen).tolist()
                       for _ in range(per)),
                 (max(mix["new_tokens"]),) * per)
            for plen in mix["prompt_lengths"]]


def stream_seed(seed: int) -> int:
    """The run seed folded to the 32 bits the token stream's key holds."""
    return (seed ^ (seed >> 32)) & M32


def train_batches(mix: dict, vocab: int, seed: int, device) -> list[dict]:
    """`batch_pool` distinct steps of `mix` on `device`: {"tokens",
    "labels"} (batch, seq_len) int32 each."""
    from bench.tokens import TokenPipeline, TokenPipelineConfig

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=vocab, seq_len=mix["seq_len"], global_batch=mix["batch"],
        seed=stream_seed(seed), zipf_a=mix["zipf_a"],
        bigram_period=mix["bigram_period"]), device=device)
    return [pipe.batch_at(step) for step in range(mix["batch_pool"])]
