"""Deterministic, stateless, resumable synthetic token stream.

The port of `repro.data.tokens`.  `batch_at(step)` is a pure function of
(seed, step, shape): a restarted job regenerates exactly the stream it
would have seen, with no iterator state to checkpoint, and host i of n
takes rows `[i * per_host, (i + 1) * per_host)` of the same global batch.
The stream is a Zipf unigram mix with a deterministic bigram every
`bigram_period` tokens, so small LMs have something to learn.

The draw is the reference's, bit for bit: `jax.random.categorical` of
the unigram logits under the key `fold_in(PRNGKey(seed), step)`, which is
argmax over the vocabulary of `gumbel + logits`.  The port carries its
own copy of what that takes, on the pipeline's device:

  * threefry-2x32 (20 rounds, key schedule and rotations as JAX's);
  * `PRNGKey(seed)` = `(0, seed mod 2**32)` and `fold_in(key, data)` =
    threefry of the counter pair `(0, data)`;
  * `random_bits` in JAX's partitionable layout (`jax_threefry_
    partitionable`, the default): element n of the flat output is
    `x0 ^ x1` of threefry(key, (n >> 32, n & 0xFFFFFFFF));
  * the float32 uniform `bitcast((bits >> 9) | 0x3F800000) - 1`, floored
    at `minval = finfo.tiny` for the Gumbel draw, `-log(-log(u))`.

Integers are held in int64 tensors masked to 32 bits (PyTorch's uint32
supports too few operations).  The Gumbel values are float32 logs, so a
`log` that rounds differently from XLA's could flip an argmax whose top
two are within an ulp; the tests hold the tokens equal to the
reference's.  The vocabulary axis is drawn in row blocks so a 128k-wide
vocabulary never holds more than `max_elements` draws at once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    bigram_period: int = 16      # deterministic bigram structure strength


def _unigram_logits(cfg: TokenPipelineConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = 1.0 / np.power(ranks, cfg.zipf_a)
    return np.log(p / p.sum()).astype(np.float32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1) (int64 tensors holding
    uint32 values) under the key (k0, k1): JAX's `threefry2x32_p`."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` as a pair of ints: the seed converted
    to a 32-bit integer (x64 off), high word 0."""
    return 0, seed & M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)`: threefry of the pair (0, data)."""
    x0, x1 = threefry2x32(*key, torch.zeros(1, dtype=torch.int64),
                          torch.full((1,), data & M32, dtype=torch.int64))
    return int(x0), int(x1)


def random_bits(key: tuple[int, int], start: int, n: int,
                device) -> torch.Tensor:
    """Elements [start, start + n) of the flat 32-bit `random_bits` of
    `key` in JAX's partitionable layout, as int64 values in [0, 2**32)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(*key, idx >> 32, idx & M32)
    return x0 ^ x1


def uniform_from_bits(bits: torch.Tensor, minval: float) -> torch.Tensor:
    """JAX's float32 uniform on [minval, 1) from 32 random bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (1.0 - lo) + lo)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 Gumbel draw ("low" mode): -log(-log(u)), u uniform
    on [tiny, 1)."""
    u = uniform_from_bits(bits, float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))


def categorical(key: tuple[int, int], logits: torch.Tensor,
                shape: tuple[int, ...],
                max_elements: int = 1 << 24) -> torch.Tensor:
    """`jax.random.categorical(key, logits, shape=shape)` for 1-D logits
    (V,): argmax over V of `gumbel(shape + (V,)) + logits`, int64."""
    V = logits.shape[0]
    rows = int(np.prod(shape))
    out = torch.empty(rows, dtype=torch.int64, device=logits.device)
    per = max(1, max_elements // V)
    for r0 in range(0, rows, per):
        nr = min(per, rows - r0)
        bits = random_bits(key, r0 * V, nr * V, logits.device)
        g = gumbel_from_bits(bits).view(nr, V)
        out[r0:r0 + nr] = torch.argmax(g + logits, dim=-1)
    return out.view(shape)


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._logits = torch.from_numpy(_unigram_logits(cfg)).to(self.device)
        self._key = prng_key(cfg.seed)

    def batch_at(self, step: int) -> dict:
        """Global batch for `step`: {"tokens", "labels"} (B, S) int32 on
        the pipeline's device."""
        cfg = self.cfg
        key = fold_in(self._key, int(step))
        draw = categorical(key, self._logits,
                           (cfg.global_batch, cfg.seq_len + 1))
        # induce learnable bigram structure: every k-th token repeats a
        # deterministic function of its predecessor
        prev = torch.roll(draw, 1, dims=1)
        idx = torch.arange(cfg.seq_len + 1, device=self.device)[None, :]
        use_bigram = (idx % cfg.bigram_period) == (cfg.bigram_period - 1)
        mapped = (prev * 31 + 7) % cfg.vocab
        seq = torch.where(use_bigram, mapped, draw).to(torch.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def host_batch_at(self, step: int, host_id: int, n_hosts: int) -> dict:
        full = self.batch_at(step)
        per = self.cfg.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in full.items()}
