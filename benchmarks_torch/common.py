"""Shared benchmark helpers: timing + TNN/PC library construction.

The port of `benchmarks/common.py`.  Every call takes `device` (None: the
current CUDA device, which raises without one), and the caches are keyed
by the resolved device as well as by dataset, size and seed.
"""
from __future__ import annotations

import os
import time

from repro_torch import resolve_device
from repro_torch.core.cgp import evolve_pc_library
from repro_torch.core.pcc import build_pcc_library, pc_pareto
from repro_torch.core.tnn import TNNTrainConfig, train_tnn
from repro_torch.data.tabular import DATASETS, make_dataset

QUICK = os.environ.get("REPRO_BENCH_FULL", "0") != "1"

_TNN_CACHE: dict = {}
_PC_CACHE: dict = {}


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def device_key(device=None) -> str:
    """The cache key of `device`: the resolved device's name."""
    return str(resolve_device(device))


def get_trained_tnn(dataset: str, seed: int = 0, device=None):
    """Train (and cache) the exact TNN at the paper's topology on
    `device`."""
    key = (device_key(device), dataset, seed)
    if key not in _TNN_CACHE:
        ds = make_dataset(dataset)
        spec = DATASETS[dataset]
        best = None
        lrs = (5e-3, 1e-2) if QUICK else (2e-3, 5e-3, 1e-2)
        for lr in lrs:
            t = train_tnn(ds, TNNTrainConfig(n_hidden=spec.topology[1],
                                             epochs=12 if QUICK else 18,
                                             lr=lr, seed=seed),
                          device=device)
            if best is None or t.test_acc > best.test_acc:
                best = t
        _TNN_CACHE[key] = (ds, best)
    return _TNN_CACHE[key]


def get_pc_library(n: int, *, points: int | None = None,
                   iters: int | None = None, seed: int = 0, device=None):
    points = points if points is not None else (2 if QUICK else 4)
    iters = iters if iters is not None else (300 if QUICK else 1200)
    key = (device_key(device), n, points, iters, seed)
    if key not in _PC_CACHE:
        _PC_CACHE[key] = evolve_pc_library(n, n_points=points,
                                           max_iters=iters, seed=seed,
                                           device=device)
    return _PC_CACHE[key]


def tnn_libraries(dataset: str, seed: int = 0, device=None):
    """(ds, tnn, pcc_lib, pc_out_lib) with budgets scaled by QUICK."""
    ds, tnn = get_trained_tnn(dataset, seed, device=device)
    sizes, pcc_sizes = set(), []
    for (p, n) in tnn.hidden_sizes():
        if p >= 1 and n >= 1:
            sizes.update([p, n])
            pcc_sizes.append((p, n))
    out_n = max(tnn.out_nnz, 1)
    sizes.add(out_n)
    pc_libs = {n: get_pc_library(n, seed=seed, device=device)
               for n in sorted(sizes)}
    pcc_lib = build_pcc_library(sorted(set(pcc_sizes)), pc_libs,
                                n_samples=20000 if QUICK else 100000,
                                seed=seed, device=device)
    pc_out = pc_pareto(pc_libs[out_n])
    return ds, tnn, pcc_lib, pc_out
