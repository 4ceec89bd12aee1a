"""The paper's own bespoke-TNN configurations (Table 2).

One entry per UCI dataset: topology (in, hidden, out), training recipe
bands (epochs 10-20, lr 1e-3..1e-2), and the approximation-run defaults
used by the benchmarks.  These are the `--arch tnn-<dataset>` configs of
the faithful scale; the LM-scale archs live in the sibling modules.

The port of `repro.configs.tnn_paper`, copied as it is.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.data.tabular import DATASETS


@dataclass(frozen=True)
class TNNPaperConfig:
    dataset: str
    topology: tuple[int, int, int]
    epochs: int = 15
    lrs: tuple[float, ...] = (2e-3, 5e-3, 1e-2)
    seeds: tuple[int, ...] = (0, 1)
    # Phase-1 CGP budget (scaled from the paper's 30-300 min limits)
    cgp_points: int = 4
    cgp_iters: int = 800
    # Phase-3 NSGA-II budget (paper: pop from pymoo defaults, 200 gens)
    nsga_pop: int = 32
    nsga_generations: int = 60


TNN_CONFIGS: dict[str, TNNPaperConfig] = {
    name: TNNPaperConfig(dataset=name, topology=spec.topology)
    for name, spec in DATASETS.items()
}


def get_tnn_config(dataset: str) -> TNNPaperConfig:
    return TNN_CONFIGS[dataset]
