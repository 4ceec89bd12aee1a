"""Campaign configuration for resumable island-model NSGA-II searches."""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from repro_torch.core.nsga2 import NSGA2Config


@dataclass(frozen=True)
class CampaignConfig:
    """An island-model evolution campaign (the port of
    `repro.evolve.config.CampaignConfig`, with `device` in place of
    `eval_backend`).

    `n_islands` independent NSGA-II populations evolve `gens_per_epoch`
    generations per epoch; at every epoch boundary each island's Pareto
    front is folded into the global archive and `migrate_k` front elites
    travel one step around the island ring.  Per-island RNG streams are
    derived as `seed + island * island_seed_stride`, so fronts are a pure
    function of (config, objective) — the determinism contract the resume
    and seed-determinism tests pin down.
    """

    n_islands: int = 4
    pop_size: int = 24
    n_epochs: int = 8
    gens_per_epoch: int = 5
    migrate_k: int = 2
    seed: int = 0
    island_seed_stride: int = 9973
    # the device the problem's objective runs on, as recorded in
    # provenance (None: the current CUDA device); the problem itself is
    # built for it (`build_tnn_problem(device=)`).  Excluded from the
    # resume fingerprint: the card and the CPU score bit-identically.
    device: str | None = None
    checkpoint_keep: int = 3
    # process-pool island executor: 0/1 = step islands serially in-process;
    # N>1 spawns N workers that advance islands concurrently within an
    # epoch (bit-identical to serial — islands only interact at migration
    # and archive-fold boundaries, which stay in the parent).  Excluded
    # from the resume fingerprint: a checkpoint written serially resumes
    # under any worker count and vice versa.
    workers: int = 0
    # LRU bound on the shared fitness memo (chromosome keys); None =
    # unbounded.  Pure memoization — eviction re-evaluates to the same
    # value — so this too is excluded from the fingerprint.
    memo_maxsize: int | None = 131072
    base: NSGA2Config = field(default_factory=NSGA2Config)   # operator params

    @property
    def total_generations(self) -> int:
        return self.n_epochs * self.gens_per_epoch

    def island_nsga2(self, island: int) -> NSGA2Config:
        """Per-island NSGA-II config (independent seed stream)."""
        b = self.base
        return NSGA2Config(
            pop_size=self.pop_size,
            n_generations=self.total_generations,
            crossover_prob=b.crossover_prob,
            crossover_eta=b.crossover_eta,
            mutation_eta=b.mutation_eta,
            mutation_prob=b.mutation_prob,
            seed=self.seed + island * self.island_seed_stride,
            dedup_eval=b.dedup_eval,
        )

    def to_dict(self) -> dict:
        return asdict(self)
