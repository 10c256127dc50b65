"""hot_tracker — decayed read-heat counters for the locality tier (§10), the
counterpart of ``repro/core/hottracker.py``.

This slice ports the zero-row :meth:`HotTracker.empty_state` a heat-less
store carries so its state has the reference's structure.  Heat tracking
waits for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class HotTrackerState(NamedTuple):
    heat: torch.Tensor     # (P, rows) float32 — decayed read count per row
    backlog: torch.Tensor  # (P,) int32 — proposals deferred by rebalance()


class HotTracker:
    """Decayed per-(node, slot) read counters; only the zero-row state of a
    heat-less store is ported so far."""

    @staticmethod
    def empty_state(P: int, device) -> HotTrackerState:
        return HotTrackerState(
            heat=torch.zeros((P, 0), dtype=torch.float32, device=device),
            backlog=torch.zeros((P,), dtype=torch.int32, device=device))
