"""Append-only decision journal — the autopilot's crash-safe memory.

The port of `repro.autopilot.journal`, copied as it is: the same JSON
lines, so either package's controller replays the other's journal.

Every step of a rollout round (candidate staged, shadow deployed, verdict
evidence, decision, terminal outcome) is appended as one JSON line and
fsynced before the controller acts on it — *journal first, act second*.
That ordering is what makes the continuous-deployment loop resumable: a
controller SIGKILLed between accumulating verdict evidence and executing
the promotion restarts, replays the journal, and recomputes the same
decision from the journaled evidence (`repro_torch.autopilot.controller.decide`
is a pure function of the journaled summary), instead of re-measuring a
different sample of traffic and possibly flipping the call.

Replay is tolerant of exactly one torn tail line (a crash mid-append);
anything else malformed raises, because a journal that lies about
promotions is worse than no journal at all.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path


class JournalCorruptError(RuntimeError):
    """A non-tail journal line failed to parse — history is untrustworthy."""


class DecisionJournal:
    """Append-only JSONL of autopilot events, fsynced per append."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._seq = 0
        for ev in self.replay():            # continue the sequence numbers
            self._seq = max(self._seq, int(ev.get("seq", 0)))

    def append(self, event: str, **fields) -> dict:
        """Durably record one event; returns the full row as written."""
        self._seq += 1
        row = {"seq": self._seq, "event": event,
               "t": round(time.time(), 3), **fields}
        line = json.dumps(row, sort_keys=True) + "\n"
        with open(self.path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        return row

    def replay(self) -> list[dict]:
        """All durable events, in order.

        A torn final line (crash mid-append) is dropped — the event it
        would have recorded never governed any action, because actions
        only ever follow a *successful* append.  A malformed line
        anywhere else raises `JournalCorruptError`.
        """
        if not self.path.exists():
            return []
        lines = self.path.read_text().splitlines()
        events: list[dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break                    # torn tail from a crash
                raise JournalCorruptError(
                    f"{self.path}: line {i + 1} is not valid JSON (only the "
                    "final line may be torn)") from None
        return events

    def rounds(self) -> dict[int, list[dict]]:
        """Events grouped by rollout round (events without a round skipped)."""
        by_round: dict[int, list[dict]] = {}
        for ev in self.replay():
            if "round" in ev:
                by_round.setdefault(int(ev["round"]), []).append(ev)
        return by_round
