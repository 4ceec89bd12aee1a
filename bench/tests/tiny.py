"""Cut-down versions of the cells for CPU tests: the cells' own files
with every size cut, the widths too, run on the CPU.  `tiny` sizes (2
layers, d_model 64) drive runs; `small` ones (16 layers, d_model 512,
prompts of 32-128 tokens) are as large as a CPU test holds, and deep
enough that precision shows as it does at the cells' own sizes."""
from __future__ import annotations

import time

import torch

from bench import harness
from bench.harness import Ctx

SEED = 2 ** 31 + 1234567


def config(name: str, dtype: str = "bfloat16", size: str = "tiny") -> dict:
    cfg = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    m = cfg["model"]
    m.update(param_dtype=dtype, compute_dtype=dtype)
    if size == "small":
        m.update(n_layers=16, d_model=512, n_heads=8, d_head=64, vocab=8192)
        if m["family"] == "ssm":
            m.update(n_kv_heads=8, d_ff=1792)
        else:
            m.update(n_kv_heads=1, d_ff=1380, attn_block_k=128)
        return cfg
    if m["family"] == "ssm":
        m.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                 d_ff=128, vocab=128)
        m["ssm"] = dict(m["ssm"], rwkv_head_size=16, lora_rank=4)
    else:
        m.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                 d_ff=128, vocab=128, attn_block_k=16)
    return cfg


def serve_ctx(cell: str, seed: int = SEED, seconds: float = 0.0,
              dtype: str = "bfloat16", size: str = "tiny") -> Ctx:
    spec, cfg, mix = harness.cell_files(cell)
    cfg = config(cfg["name"], dtype, size)
    lens = [32, 64, 128] if size == "small" else [8, 16, 32]
    mix = dict(mix, prompt_lengths=lens, cache_len=lens[-1] + 1)
    n = (4, 4, 4) if size == "small" else (3, 3, 2)
    spec = dict(spec, check=dict(spec["check"], sample={
        str(s): k for s, k in zip(lens, n)}))
    return Ctx(cell, spec, cfg, mix, seed, seconds, False,
               torch.device("cpu"), time.perf_counter())


def train_ctx(cell: str = "rwkv6-7b.train", seed: int = SEED,
              dtype: str = "bfloat16") -> Ctx:
    spec, cfg, mix = harness.cell_files(cell)
    cfg = config(cfg["name"], dtype)
    cfg["model"]["n_layers"] = 2 * mix["pipeline_stages"]
    mix = dict(mix, seq_len=32, batch_pool=4)
    return Ctx(cell, spec, cfg, mix, seed, 0.0, False, torch.device("cpu"),
               time.perf_counter())
