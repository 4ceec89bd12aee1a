"""Resumable island-model NSGA-II campaigns.

The port of `repro.evolve.campaign`: numpy orchestration on the host, the
fitness on the problem's device (one gate-walk launch an objective call
for a TNN problem), and checkpoints in the reference's format, so a
campaign either package checkpointed resumes in the other to the same
front.

A `Campaign` owns `n_islands` stepwise `NSGA2Driver`s over one shared
(memoized) objective, a global `ParetoArchive`, and a `CheckpointManager`.
Execution is epoch-structured:

    epoch e:  every island advances `gens_per_epoch` generations
              -> island fronts fold into the archive
              -> ring migration of `migrate_k` front elites
              -> checkpoint (island pops/objectives + archive as arrays,
                 RNG streams + epoch counter in the manifest extra)

`run()` first tries to resume: if the checkpoint directory holds a valid
snapshot for this config, populations, archive, histories and mid-stream
RNG states are restored and the loop continues at the next epoch — a
campaign SIGKILLed between generations replays to a bit-identical final
Pareto front versus an uninterrupted run (pinned by tests/test_evolve.py).
A snapshot truncated by the kill is detected by its checksum and the
previous epoch's snapshot loads instead (`checkpoint.manager`).

The fitness dedup cache is shared across islands: chromosomes are evaluated
once per campaign process no matter how many islands revisit them.  The
cache is pure memoization of a row-independent objective, so a resumed
process with a cold cache follows the identical trajectory.  It is LRU
bounded by `cfg.memo_maxsize`, and its hit/miss/eviction counters are
surfaced per epoch in `cache_history` (one row per `step_epoch`).

With `cfg.workers > 1` and a picklable `problem_spec`, epoch stepping
fans the islands out over `evolve.executor.IslandExecutor`'s process
pool — bit-identical to serial stepping (islands only interact at the
epoch boundary, which stays here) and transparent to checkpoints: the
parent still owns states, archive and manifest, so a campaign stepped
serially resumes parallel and vice versa.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.nsga2 import (NSGA2Driver, NSGA2State, _memoized,
                                    encode_rng_state, extract_front)
from repro_torch.evolve.config import CampaignConfig
from repro_torch.evolve.islands import ParetoArchive, migrate_ring

_CKPT_VERSION = 1


@dataclass
class CampaignResult:
    archive_x: np.ndarray    # (A, n_genes) global Pareto archive
    archive_f: np.ndarray    # (A, 2)
    epochs_run: int          # epochs executed in *this* process
    resumed_from: int | None # epoch of the loaded snapshot, if any
    histories: list[list[tuple[int, float, float]]] = field(
        default_factory=list)
    # one row per epoch stepped in this process: fitness-memo counters
    # (cumulative) + executor metadata — see Campaign.cache_history
    cache_history: list[dict] = field(default_factory=list)


class Campaign:
    """One resumable multi-island search over a fixed objective."""

    def __init__(self, domains: np.ndarray,
                 objective: Callable[[np.ndarray], np.ndarray],
                 cfg: CampaignConfig,
                 checkpoint_dir: str | None = None,
                 seed_population: np.ndarray | None = None,
                 name: str = "campaign",
                 problem_spec=None):
        self.domains = np.asarray(domains)
        self.cfg = cfg
        self.name = name
        self.n_genes = int(self.domains.shape[0])
        self.seed_population = seed_population
        evaluate = (_memoized(objective, maxsize=cfg.memo_maxsize)
                    if cfg.base.dedup_eval else objective)
        self._evaluate = evaluate       # shared memo (see clear_eval_cache)
        self.drivers = [
            NSGA2Driver(self.domains, objective, cfg.island_nsga2(i),
                        evaluate=evaluate)
            for i in range(cfg.n_islands)
        ]
        self.ckpt = (CheckpointManager(checkpoint_dir,
                                       keep=cfg.checkpoint_keep)
                     if checkpoint_dir else None)
        self.states: list[NSGA2State] = []
        self.archive = ParetoArchive(self.n_genes)
        self.next_epoch = 0
        self.resumed_from: int | None = None
        # fitness-memo counters, one row per epoch stepped here (serial
        # rows read the in-process memo; parallel rows aggregate the
        # worker memos reported with each epoch's step results)
        self.cache_history: list[dict] = []
        self.problem_spec = problem_spec
        self._executor = None           # built lazily on first step_epoch
        if cfg.workers > 1 and problem_spec is None:
            raise ValueError(
                f"cfg.workers={cfg.workers} needs a picklable problem_spec "
                "(ProblemSpec) — a bare objective callable cannot cross "
                "the process boundary")

    # -- checkpoint plumbing -------------------------------------------------
    def _state_tree(self) -> dict:
        return {
            "islands": [{"pop": np.ascontiguousarray(s.pop, dtype=np.int64),
                         "F": np.ascontiguousarray(s.F, dtype=np.float64)}
                        for s in self.states],
            "archive": {"X": self.archive.X, "F": self.archive.F},
        }

    def _template(self) -> dict:
        P = self.cfg.pop_size
        return {
            "islands": [{"pop": np.zeros((P, self.n_genes), dtype=np.int64),
                         "F": np.zeros((P, 2), dtype=np.float64)}
                        for _ in range(self.cfg.n_islands)],
            "archive": {"X": np.zeros((0, self.n_genes), dtype=np.int64),
                        "F": np.zeros((0, 2), dtype=np.float64)},
        }

    def _config_fingerprint(self) -> dict:
        """Every config field the generation sequence depends on.

        Deliberately excluded: `n_epochs` (extending a finished campaign is
        the resume feature) and `device` (the card and the CPU score
        bit-identically, so resuming on another device cannot change the
        trajectory).  The keys are the reference's, so a checkpoint
        resumes across frameworks too.
        """
        b = self.cfg.base
        return {"n_islands": self.cfg.n_islands,
                "pop_size": self.cfg.pop_size,
                "gens_per_epoch": self.cfg.gens_per_epoch,
                "migrate_k": self.cfg.migrate_k,
                "seed": self.cfg.seed,
                "island_seed_stride": self.cfg.island_seed_stride,
                "n_genes": self.n_genes,
                "crossover_prob": b.crossover_prob,
                "crossover_eta": b.crossover_eta,
                "mutation_eta": b.mutation_eta,
                "mutation_prob": b.mutation_prob,
                "dedup_eval": b.dedup_eval}

    def fingerprint(self) -> str:
        """sha256 of the trajectory-determining config — the provenance
        stamp emitted into manifest rows so a promotion decision can tell
        which search produced a candidate."""
        blob = json.dumps(self._config_fingerprint(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def _save(self, epoch: int) -> None:
        if self.ckpt is None:
            return
        extra = {
            "version": _CKPT_VERSION,
            "name": self.name,
            "epoch": epoch,
            "rngs": [encode_rng_state(s.rng) for s in self.states],
            "generations": [s.generation for s in self.states],
            "histories": [[list(h) for h in s.history] for s in self.states],
            "config": self._config_fingerprint(),
        }
        self.ckpt.save(epoch, self._state_tree(), extra=extra)

    def _try_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_valid_step() is None:
            return False
        _, tree, extra = self.ckpt.restore(self._template(), to_device=False)
        saved = extra.get("config", {})
        mine = self._config_fingerprint()
        if {k: saved.get(k) for k in mine} != mine:
            raise ValueError(
                f"checkpoint under {self.ckpt.dir} was written by an "
                f"incompatible campaign config: {saved} vs {mine}")
        self.states = [
            self.drivers[i].restore_state(
                isl["pop"], isl["F"], extra["generations"][i],
                extra["rngs"][i],
                [tuple(h) for h in extra["histories"][i]])
            for i, isl in enumerate(tree["islands"])
        ]
        self.archive = ParetoArchive(self.n_genes, tree["archive"]["X"],
                                     tree["archive"]["F"])
        self.resumed_from = int(extra["epoch"])
        self.next_epoch = self.resumed_from + 1
        return True

    # -- execution -----------------------------------------------------------
    def init_or_resume(self) -> None:
        """Populate island states: resume from a valid checkpoint or init."""
        if self.states:
            return
        if not self._try_resume():
            self.states = [d.init_state(self.seed_population)
                           for d in self.drivers]
            self.next_epoch = 0

    def clear_eval_cache(self) -> None:
        """Drop the shared fitness memo between data refreshes.

        The dedup cache assumes a *fixed* objective; a drift hook that
        mutates the underlying data would otherwise keep serving stale
        fitness values for revisited chromosomes.  The autopilot calls
        this after every `CampaignProblem.drift` application.  With a
        live executor, worker memos are invalidated too (lazily, before
        the next row any worker evaluates).
        """
        clear = getattr(self._evaluate, "cache_clear", None)
        if clear is not None:
            clear()
        if self._executor is not None:
            self._executor.clear_eval_cache()

    def mark_drift(self, round_idx: int) -> None:
        """Record a `problem.drift(round_idx)` the caller just applied.

        Clears the in-process memo and, when stepping parallel, tells the
        executor so its workers replay the same deterministic drift round
        on their problem copies before stepping again.  Callers that
        drift must use this (not bare `clear_eval_cache`) if the campaign
        may run with `workers > 1`.
        """
        if self._executor is not None:
            self._executor.mark_drift(round_idx)
        clear = getattr(self._evaluate, "cache_clear", None)
        if clear is not None:
            clear()

    def _ensure_executor(self):
        if self._executor is None and self.cfg.workers > 1:
            from repro_torch.evolve.executor import IslandExecutor
            self._executor = IslandExecutor(self.problem_spec, self.cfg,
                                            n_workers=self.cfg.workers)
        return self._executor

    def _record_cache_row(self, epoch: int, executor_stats: dict | None
                          ) -> None:
        if executor_stats is not None:
            row = {"epoch": epoch, "mode": "parallel", **executor_stats}
        else:
            info = getattr(self._evaluate, "cache_info", lambda: {})()
            row = {"epoch": epoch, "mode": "serial", **info}
        self.cache_history.append(row)

    def step_epoch(self) -> int:
        """Advance exactly one epoch (+checkpoint); returns its index.

        The continuous-evolution API: unlike `run()`, stepping is not
        bounded by `cfg.n_epochs` — a long-running controller keeps
        calling this for as long as it wants candidates, and every epoch
        lands a resumable checkpoint exactly like the batch path.

        With `cfg.workers > 1` the epoch's generations run on the island
        executor's process pool; archive fold, migration and the
        checkpoint stay in this process either way.
        """
        self.init_or_resume()
        epoch = self.next_epoch
        executor = self._ensure_executor()
        stats = None
        if executor is not None:
            self.states, stats = executor.step_islands(
                self.states, self.cfg.gens_per_epoch)
        else:
            for _ in range(self.cfg.gens_per_epoch):
                for i, driver in enumerate(self.drivers):
                    self.states[i] = driver.step(self.states[i])
        for state in self.states:
            self.archive.update(*extract_front(state.pop, state.F))
        migrate_ring(self.states, self.cfg.migrate_k)
        self._record_cache_row(epoch, stats)
        self._save(epoch)
        self.next_epoch = epoch + 1
        return epoch

    def close(self) -> None:
        """Tear down the executor pool, if one was spawned."""
        if self._executor is not None:
            self._executor.close()
            self._executor = None

    def __enter__(self) -> "Campaign":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def best_by_objective(self, obj: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(chromosome, objectives) of the archive entry minimizing `obj`."""
        if not len(self.archive):
            raise ValueError("empty archive — step the campaign first")
        i = int(np.argmin(self.archive.F[:, obj]))
        return self.archive.X[i].copy(), self.archive.F[i].copy()

    def run(self, on_epoch: Callable[[int, "Campaign"], None] | None = None,
            kill_after_epoch: int | None = None) -> CampaignResult:
        """Advance to `cfg.n_epochs`, checkpointing every epoch boundary.

        `kill_after_epoch=e` SIGKILLs the process right after epoch e's
        checkpoint lands — the deterministic stand-in for an external kill
        between generations, used by the resume tests and the CLI's
        `--kill-after-epoch` debug flag.
        """
        self.init_or_resume()
        ran = 0
        while self.next_epoch < self.cfg.n_epochs:
            epoch = self.step_epoch()
            ran += 1
            if on_epoch is not None:
                on_epoch(epoch, self)
            if kill_after_epoch is not None and epoch >= kill_after_epoch:
                os.kill(os.getpid(), signal.SIGKILL)
        return CampaignResult(
            archive_x=self.archive.X.copy(), archive_f=self.archive.F.copy(),
            epochs_run=ran, resumed_from=self.resumed_from,
            histories=[list(s.history) for s in self.states],
            cache_history=[dict(r) for r in self.cache_history])
