"""Channel-layer crash schedules, the counterpart of the ``FaultPlan`` of
``repro/distributed/fault.py`` (numpy only; copied, not imported).

The training tier's elastic re-mesh (``ElasticMeshSpec``, ``run_elastic``)
is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which participant dies (and possibly revives) at which mutation
    window (DESIGN.md §12, §13).

    ``kills`` maps participant id → the window index *before* which it
    crashes: it never serves that window, its publishes are suppressed, its
    consumer cursor freezes and its heartbeats stop — the plan only silences
    the victim; the :class:`~repro_torch.core.FailureDetector` discovers the
    death from the stalled heartbeat column.  ``revives`` maps participant id
    → the window at which it comes back (the rejoin protocol of §13.3 decides
    snapshot or replay).  A plan is immutable and reusable."""
    kills: "dict[int, int]" = dataclasses.field(default_factory=dict)
    revives: "dict[int, int]" = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "kills",
                           {int(p): int(w) for p, w in self.kills.items()})
        object.__setattr__(self, "revives",
                           {int(p): int(w) for p, w in self.revives.items()})
        for p, w in self.revives.items():
            if p not in self.kills:
                raise ValueError(f"revive for never-killed participant {p}")
            if w <= self.kills[p]:
                raise ValueError(
                    f"participant {p} revives at window {w} but dies at "
                    f"{self.kills[p]} — revive must come after the kill")

    def dead_at(self, window: int) -> set:
        """Participants crashed while window ``window`` is served: kill
        window ≤ ``window`` and not (yet) revived."""
        return {p for p, w in self.kills.items()
                if w <= window and not (
                    p in self.revives and self.revives[p] <= window)}

    def alive_mask(self, P: int, window: int) -> np.ndarray:
        """(P,) bool — False for every participant dead while window
        ``window`` is served."""
        dead = self.dead_at(window)
        return np.asarray([p not in dead for p in range(P)], bool)

    def newly_dead(self, window: int) -> list:
        """Participants whose crash lands exactly before ``window``."""
        return sorted(p for p, w in self.kills.items() if w == window)

    def newly_alive(self, window: int) -> list:
        """Participants whose revival lands exactly at ``window``."""
        return sorted(p for p, w in self.revives.items() if w == window)

    def device_failures(self) -> dict:
        """An ``inject_failure_at``-shaped dict (step → True) for the
        training tier's elastic recovery; a fresh dict per call."""
        return {int(w): True for w in self.kills.values()}
