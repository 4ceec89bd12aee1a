"""repro_torch.evolve — resumable island-model evolution campaigns.

The port of `repro.evolve`.  `Campaign` runs N independent NSGA-II
islands over one shared memoized objective with periodic ring migration
of Pareto elites, checkpointing the full search state (populations,
objectives, archive, RNG streams) every epoch through
`repro_torch.checkpoint` — a killed campaign resumes to a bit-identical
Pareto front, from its own checkpoints or the reference's.  A TNN
problem's objective is one launch of the gate walk on its device;
`IslandExecutor` steps islands in spawned workers.

CLI:  python -m repro_torch.evolve --problem tnn --dataset cardio ...
"""
from repro_torch.evolve.campaign import Campaign, CampaignResult  # noqa: F401
from repro_torch.evolve.config import CampaignConfig  # noqa: F401
from repro_torch.evolve.executor import IslandExecutor  # noqa: F401
from repro_torch.evolve.islands import ParetoArchive, migrate_ring  # noqa: F401,E501
from repro_torch.evolve.phase_cache import (  # noqa: F401
    PhaseCacheCorruptError,
    default_cache_dir,
    load_phase,
    phase_key,
    save_phase,
)
from repro_torch.evolve.problems import (  # noqa: F401
    CampaignProblem,
    ProblemSpec,
    attach_tnn_drift,
    build_problem,
    build_synth_problem,
    build_tnn_problem,
    compile_archive_winner,
)
