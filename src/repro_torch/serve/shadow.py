"""Shadow-deployment comparator: incumbent vs candidate on mirrored traffic.

The port's copy of `repro.serve.shadow`, as it is.

A shadow replica serves a *copy* of every admitted reading (the fleet
mirrors traffic in `fleet.submit`/`submit_many` — see
`ClassifierFleet.deploy_shadow`), and this object is where the two sides
meet: each mirrored request is paired with its primary by the primary's
uid, and when both labels have landed the pair is scored —

  * **bit-exactness** — do incumbent and shadow agree on the label?
  * **accuracy** — when the traffic source knows the ground truth
    (`attach_truth`), which side classified it correctly?  An *improved*
    candidate legitimately disagrees with the incumbent, so agreement
    alone cannot justify a promotion — accuracy deltas can.
  * **latency** — shadow-minus-incumbent request latency, kept in a
    bounded ring so a slow candidate shows up before it is promoted into
    the serving path.

Everything here is passive bookkeeping fed by completion callbacks from
the fleet's dispatch threads; the comparator never blocks a request and
mirrored traffic never touches the incumbent's own `ServeStats` (pinned
by tests/test_autopilot.py).  `summary()` is the JSON-able snapshot the
STATS RPC surfaces and the autopilot journals before deciding — the
promotion policy itself lives in the reference's `autopilot.controller.decide`,
a pure function of that snapshot, which is what makes a killed
controller resume from its journal to the same decision.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.serve.engine import STATS_WINDOW, _Ring

# closed pairs kept around for late-arriving ground truth (the traffic
# generator attaches truth after submit() returns, which can lose the race
# with a fast dispatch); bounded so an unlabeled stream can't grow it
_CLOSED_KEEP = 4 * STATS_WINDOW


class ShadowComparator:
    """Pairs mirrored completions with their primaries and keeps score."""

    def __init__(self, incumbent: str, shadow: str,
                 window: int = STATS_WINDOW):
        self.incumbent = incumbent
        self.shadow = shadow
        self.n_mirrored = 0          # mirror requests actually enqueued
        self.n_dropped = 0           # mirrors dropped (queue cap/retiring)
        self.n_pairs = 0             # both sides completed
        self.n_agree = 0             # ... with identical labels
        self.n_primary_errors = 0
        self.n_shadow_errors = 0
        self.n_truth = 0             # scored pairs with ground truth
        self.n_incumbent_correct = 0
        self.n_shadow_correct = 0
        self.delta_ms = _Ring(window)        # shadow - incumbent latency
        self.incumbent_ms = _Ring(window)
        self.shadow_ms = _Ring(window)
        self._open: dict[int, dict] = {}     # primary uid -> half a pair
        self._truth: dict[int, int] = {}     # uid -> label, pre-close
        self._closed: OrderedDict[int, tuple] = OrderedDict()
        self._lock = threading.Lock()

    # -- feeding (fleet callbacks + traffic generator) -----------------------
    def expect(self, uid: int) -> None:
        """A mirror for primary `uid` was enqueued; a pair will form."""
        with self._lock:
            self.n_mirrored += 1
            self._open.setdefault(uid, {})

    def record_dropped(self, n: int = 1) -> None:
        with self._lock:
            self.n_dropped += n

    def attach_truth(self, uid: int, label: int) -> None:
        """Ground truth for primary `uid` (optional; enables accuracy)."""
        with self._lock:
            if uid in self._closed:
                self._score_truth(label, *self._closed.pop(uid))
            else:
                self._truth[uid] = int(label)

    def observe_primary(self, req) -> None:
        self._observe(req.uid, "primary", req)

    def observe_shadow(self, uid: int, req) -> None:
        self._observe(uid, "shadow", req)

    def _observe(self, uid: int, side: str, req) -> None:
        with self._lock:
            pair = self._open.get(uid)
            if pair is None or side in pair:
                return
            pair[side] = (req.label, req.latency_ms, req.error)
            if len(pair) == 2:
                del self._open[uid]
                self._close(uid, pair)

    # -- scoring (caller holds the lock) -------------------------------------
    def _close(self, uid: int, pair: dict) -> None:
        (p_label, p_lat, p_err) = pair["primary"]
        (s_label, s_lat, s_err) = pair["shadow"]
        if p_err is not None:
            self.n_primary_errors += 1
        if s_err is not None:
            self.n_shadow_errors += 1
        if p_err is not None or s_err is not None:
            self._truth.pop(uid, None)
            return
        self.n_pairs += 1
        if p_label == s_label:
            self.n_agree += 1
        if p_lat is not None and s_lat is not None:
            self.delta_ms.push(s_lat - p_lat)
            self.incumbent_ms.push(p_lat)
            self.shadow_ms.push(s_lat)
        truth = self._truth.pop(uid, None)
        if truth is not None:
            self._score_truth(truth, p_label, s_label)
        else:
            self._closed[uid] = (p_label, s_label)
            while len(self._closed) > _CLOSED_KEEP:
                self._closed.popitem(last=False)

    def _score_truth(self, truth: int, p_label: int, s_label: int) -> None:
        self.n_truth += 1
        self.n_incumbent_correct += int(p_label == truth)
        self.n_shadow_correct += int(s_label == truth)

    # -- reading -------------------------------------------------------------
    @property
    def agreement(self) -> float:
        return self.n_agree / self.n_pairs if self.n_pairs else 0.0

    def summary(self) -> dict:
        """JSON-able snapshot — the STATS payload and the journaled
        evidence the promotion decision is computed from."""
        with self._lock:
            n = self.n_pairs
            return {
                "incumbent": self.incumbent,
                "shadow": self.shadow,
                "n_mirrored": self.n_mirrored,
                "n_dropped": self.n_dropped,
                "n_pairs": n,
                "n_agree": self.n_agree,
                "agreement": round(self.n_agree / n, 6) if n else 0.0,
                "n_primary_errors": self.n_primary_errors,
                "n_shadow_errors": self.n_shadow_errors,
                "n_truth": self.n_truth,
                "incumbent_accuracy": (
                    round(self.n_incumbent_correct / self.n_truth, 6)
                    if self.n_truth else None),
                "shadow_accuracy": (
                    round(self.n_shadow_correct / self.n_truth, 6)
                    if self.n_truth else None),
                "latency_delta_p50_ms": round(self.delta_ms.percentile(50), 4),
                "latency_delta_p99_ms": round(self.delta_ms.percentile(99), 4),
                "incumbent_p50_ms": round(self.incumbent_ms.percentile(50), 4),
                "shadow_p50_ms": round(self.shadow_ms.percentile(50), 4),
            }
