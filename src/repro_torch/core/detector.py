"""FailureDetector — SST-heartbeat failure detection (DESIGN.md §13.1), the
counterpart of ``repro/core/detector.py``.

Every participant bumps a heartbeat counter in a gathered SST row once per
window (the replicated log's promotion table carries it); every peer watches
the gathered copies, and a counter that stands still for ``threshold``
consecutive observation windows marks its owner dead.  Time is the window
clock, so detection is deterministic.  The per-lane miss counters are folded
through a max over participants before the threshold is applied, so every
lane reaches the same verdict on the same window.  Deadness is sticky until
:meth:`FailureDetector.readmit`, which the rejoin protocol calls once a
revived node holds a consistent state again (§13.3).

Every field carries the leading dimension of the participants held here (P
stacked, 1 on a rank of a process binding, whose max over participants is a
``pmax`` over the ranks).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .channel import Channel
from .runtime import Manager
from .u32 import MASK32

_U32_MAX = 0xFFFFFFFF


class FailureDetectorState(NamedTuple):
    last_hb: torch.Tensor      # (n, P) uint32 last observed heartbeat per peer
    missed: torch.Tensor       # (n, P) uint32 consecutive windows without a bump
    alive: torch.Tensor        # (n, P) bool current (sticky) verdict
    detected_at: torch.Tensor  # (n, P) uint32 window clock at the verdict
    #                          # (0xFFFFFFFF = never)
    windows: torch.Tensor      # (n,) uint32 observation-window clock


class FailureDetector(Channel):
    """Declares a peer dead after ``threshold`` missed heartbeat windows."""

    def __init__(self, parent, name: str, mgr: Manager, *,
                 threshold: int = 2):
        super().__init__(parent, name, mgr)
        if threshold < 1:
            raise ValueError("detector threshold must be >= 1")
        self.threshold = int(threshold)

    def init_state(self) -> FailureDetectorState:
        n, P, dev = self.n_local, self.P, self.device
        z = torch.zeros((n, P), dtype=torch.int64, device=dev)
        return FailureDetectorState(
            last_hb=z, missed=z.clone(),
            alive=torch.ones((n, P), dtype=torch.bool, device=dev),
            detected_at=torch.full((n, P), _U32_MAX, dtype=torch.int64,
                                   device=dev),
            windows=torch.zeros((n,), dtype=torch.int64, device=dev))

    def observe(self, st: FailureDetectorState, heartbeats):
        """Fold one window's gathered heartbeat column ((n viewers, P)
        uint32) into the verdict.  Returns (state, alive (n, P) bool), the
        sticky verdict, identical at every participant.  Bump first, then
        observe, within a window."""
        n = self.n_local
        hb = torch.as_tensor(heartbeats, device=self.device).to(torch.int64) \
            .reshape(n, self.P) & MASK32
        bumped = hb != st.last_hb
        missed = torch.where(bumped, torch.zeros_like(st.missed),
                             (st.missed + 1) & MASK32)
        # the reference's pmax over participants: one verdict everywhere
        missed = self.rt.pmax(missed).expand(n, self.P).clone()
        suspected = missed >= self.threshold
        alive = st.alive & ~suspected          # sticky: dead stays dead
        newly_dead = st.alive & ~alive
        windows = (st.windows + 1) & MASK32
        detected_at = torch.where(newly_dead, windows[:, None],
                                  st.detected_at)
        return FailureDetectorState(last_hb=hb, missed=missed, alive=alive,
                                    detected_at=detected_at,
                                    windows=windows), alive

    def readmit(self, st: FailureDetectorState, node):
        """Re-admit ``node`` (an int or an (n,) tensor) after a completed
        rejoin: alive again, with a clean miss count."""
        loc = self.local_ids()
        node = torch.as_tensor(node, device=self.device).to(torch.int64) \
            .expand(self.n_local)
        alive, missed = st.alive.clone(), st.missed.clone()
        detected_at = st.detected_at.clone()
        alive[loc, node] = True
        missed[loc, node] = 0
        detected_at[loc, node] = _U32_MAX
        return st._replace(alive=alive, missed=missed,
                           detected_at=detected_at)

    def detection_latency(self, st: FailureDetectorState, node):
        """(n,) observation windows from clock zero to the verdict on
        ``node`` (0xFFFFFFFF if never declared dead)."""
        node = torch.as_tensor(node, device=self.device).to(torch.int64) \
            .expand(self.n_local)
        return st.detected_at[self.local_ids(), node]
