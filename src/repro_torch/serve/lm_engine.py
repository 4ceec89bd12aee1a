"""Batched LM serving engine: prefill + greedy decode, bucketed by length.

The port of `repro.serve.lm_engine`.  Requests are bucketed by prompt
length (the decode step is batch-uniform in position), cut into groups of
at most `max_batch`, prefilled once per group and decoded greedily until
`max_new_tokens` or EOS, with the reference's bookkeeping.  A group's
batch (`make_batch`) carries the reference's stub frontends: zero vision
embeddings and M-RoPE positions `(B, 3, S)` for a VLM, zero frame
embeddings `(B, enc_seq, D)` for an encoder-decoder.  An RWKV-6 model
keeps recurrent state instead of a KV cache, so `cache_len` does not
bound it.  Greedy picks
`torch.argmax`, whose ties go to the first index as `jnp.argmax`'s do.

`LMServeStats` counts prefill tokens, decode steps and their wall times
(step times in the circuit engine's bounded ring, so a long-lived engine
holds constant memory); each timed region ends with the step's tokens on
the host, so it includes the card's work.  While a profiler records,
each group records the spans `serve.group` (its rows, prompt length and
request uids) and, inside it, `serve.batch`, `serve.prefill`,
`serve.head` and `serve.to_host` (`repro_torch.trace`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import trace as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.models.params import tree_map
from repro_torch.serve.engine import STATS_WINDOW, _Ring


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = field(default_factory=list)


@dataclass
class LMServeStats:
    prefill_tokens: int = 0          # prompt tokens run through prefill
    prefill_s: float = 0.0
    n_prefills: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0           # batch rows computed by decode steps
    decode_s: float = 0.0
    decode_step_ms: _Ring = field(
        default_factory=lambda: _Ring(STATS_WINDOW))

    def summary(self) -> dict:
        return {
            "prefills": self.n_prefills,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "prefill_tokens_per_s": (self.prefill_tokens / self.prefill_s
                                     if self.prefill_s else 0.0),
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_s": self.decode_s,
            "decode_tokens_per_s": (self.decode_tokens / self.decode_s
                                    if self.decode_s else 0.0),
            "decode_step_p50_ms": self.decode_step_ms.percentile(50),
            "decode_step_p99_ms": self.decode_step_ms.percentile(99),
        }


def make_batch(cfg: ModelConfig, tokens: np.ndarray, device) -> dict:
    """The prefill batch of `tokens` (B, S) on `device`, with the stub
    frontend inputs the reference's `_make_batch` builds."""
    B, S = tokens.shape
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.zeros(
            (B, cfg.n_vision_tokens, cfg.d_model), dtype=torch.float32,
            device=device)
        batch["positions"] = torch.arange(S, device=device)[None, None, :] \
            .expand(B, 3, S)
    if cfg.enc_layers:
        batch["enc_frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                          dtype=torch.float32, device=device)
    return batch


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int = 8,
                 cache_len: int = 256, device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        if cfg.tie_embeddings:
            # one float32 copy of the tied table serves both the embedding
            # gather (cast back to the compute dtype, bit-identical) and the
            # logits, which then need no cast of the table per step
            self.params["embed"] = {
                "tokens": self.params["embed"]["tokens"].float()}
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.stats = LMServeStats()

    def run(self, requests: list[Request]) -> list[Request]:
        """Process all requests; returns them with `.output` filled."""
        buckets: dict[int, list[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        with torch.inference_mode():
            for plen, group in sorted(buckets.items()):
                for s in range(0, len(group), self.max_batch):
                    self._run_group(group[s: s + self.max_batch], plen)
        return requests

    def _run_group(self, group: list[Request], plen: int) -> None:
        with TR.span("serve.group", rows=len(group), prompt_len=plen,
                     uids=[r.uid for r in group]):
            cfg, st = self.cfg, self.stats
            with TR.span("serve.batch"):
                toks = np.zeros((len(group), plen), np.int64)
                for i, r in enumerate(group):
                    toks[i, : len(r.prompt)] = r.prompt
                t0 = time.perf_counter()
                batch = make_batch(cfg, toks, self.device)
            with TR.span("serve.prefill"):
                hidden, cache = TF.prefill(cfg, self.params, batch,
                                           self.cache_len)
            with TR.span("serve.head"):
                logits = TF.logits_from_hidden(cfg, self.params,
                                               hidden[:, -1:, :])
                tok = torch.argmax(logits, dim=-1)                 # (B, 1)
            with TR.span("serve.to_host"):
                toks_np = tok[:, 0].cpu().numpy()
            st.prefill_s += time.perf_counter() - t0
            st.prefill_tokens += toks.size
            st.n_prefills += 1
            max_new = max(r.max_new_tokens for r in group)
            done = np.zeros(len(group), bool)
            for step in range(max_new):
                for i, r in enumerate(group):
                    if not done[i] and len(r.output) < r.max_new_tokens:
                        t = int(toks_np[i])
                        r.output.append(t)
                        if r.eos_id is not None and t == r.eos_id:
                            done[i] = True
                    elif len(r.output) >= r.max_new_tokens:
                        done[i] = True
                if done.all() or step == max_new - 1:
                    break
                t0 = time.perf_counter()
                logits, cache = TF.decode_step(cfg, self.params, cache, tok,
                                               plen + step)
                tok = torch.argmax(logits, dim=-1)
                toks_np = tok[:, 0].cpu().numpy()
                dt = time.perf_counter() - t0
                st.decode_s += dt
                st.decode_steps += 1
                st.decode_tokens += len(group)
                st.decode_step_ms.push(dt * 1e3)
