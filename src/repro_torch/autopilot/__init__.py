"""repro_torch.autopilot — continuous evolve→compile→shadow-deploy→promote loop.

The port of `repro.autopilot`, on the port's campaign, compiler and fleet.

The controller (`Autopilot`) keeps a per-tenant evolution `Campaign`
searching, stages every improved winner as a provenance-stamped candidate
bundle, shadow-deploys it against the live `ClassifierFleet` on mirrored
traffic, and promotes or rolls back from the `ShadowComparator` evidence
— journaling every step so a killed controller resumes mid-rollout to
the same decision.  CLI: ``python -m repro_torch.autopilot {run,status,promote,
rollback}``.
"""
from repro_torch.autopilot.controller import (Autopilot, AutopilotConfig,
                                              CampaignSource, Candidate,
                                              PromotionPolicy, ScriptedSource,
                                              dataset_traffic, decide,
                                              sabotage_classifier)
from repro_torch.autopilot.journal import (DecisionJournal,
                                           JournalCorruptError)

__all__ = [
    "Autopilot", "AutopilotConfig", "CampaignSource", "Candidate",
    "DecisionJournal", "JournalCorruptError", "PromotionPolicy",
    "ScriptedSource", "dataset_traffic", "decide", "sabotage_classifier",
]
