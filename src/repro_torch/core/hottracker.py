"""hot_tracker — decayed read-heat counters for the locality tier (§10), the
counterpart of ``repro/core/hottracker.py``.

:class:`HotTracker` is the evidence placement decisions are made with: a
per-participant vector of exponentially decayed read counters, one per
global (node, slot) row of a backing store, fed from the lane metadata the
store's read path already resolves.  Each participant counts only its own
reads, so ``heat[p, lid]`` is "how hot row ``lid`` is to participant p";
the (readers, rows) heat matrix the reference all-gathers is
:meth:`HotTracker.all_heat` (in the stacked binding the state itself), and
a row's dominant reader is an argmax over its first dimension
(:meth:`KVStore.rebalance_proposals`).

Decay is applied once per observed window on every participant.  The
reference adds +1.0 lane by lane into the decayed float32 counter; the port
counts each line's live lanes as an integer first and adds the count once,
so the card and the CPU agree bit for bit and neither depends on the order
of a scatter.  The two differ from the reference only in float32 rounding
(a line read k times in one window carries k roundings there, one here).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .channel import Channel
from .runtime import Manager


class HotTrackerState(NamedTuple):
    heat: torch.Tensor     # (n, rows) float32 — decayed read count per row
    backlog: torch.Tensor  # (n,) int32 — proposals deferred by rebalance()


def _line_totals(flat, counts):
    """Sort the flat line ids and total ``counts`` per line: (sorted ids,
    each position's line total).  Positions of one line carry the same
    total, so writing them all, duplicates included, is deterministic."""
    sflat, perm = torch.sort(flat)
    start = torch.ones_like(sflat, dtype=torch.bool)
    start[1:] = sflat[1:] != sflat[:-1]
    seg = start.to(torch.int64).cumsum(0) - 1
    tot = torch.zeros_like(seg).scatter_add_(0, seg, counts[perm])
    return sflat, tot[seg]


class HotTracker(Channel):
    """Decayed per-(node, slot) read counters, one row per participant.

    rows = nodes · slots (the backing store's global row count); ``decay``
    is the per-observed-window retention factor (0.9 ≈ a ~10-window
    horizon, DESIGN.md §10.3)."""

    def __init__(self, parent, name: str, mgr: Manager, *, nodes: int,
                 slots: int, decay: float = 0.9):
        super().__init__(parent, name, mgr)
        self.nodes = int(nodes)
        self.slots = int(slots)
        self.rows = self.nodes * self.slots
        self.decay = float(decay)
        if not 0.0 < self.decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        # private memory, ledger-accounted like the kvstore index (§4)
        self.declare_region("heat", (self.rows,), torch.float32)

    def init_state(self, device=None) -> HotTrackerState:
        dev = self.device if device is None else device
        return HotTrackerState(
            heat=torch.zeros((self.n_local, self.rows), dtype=torch.float32,
                             device=dev),
            backlog=torch.zeros((self.n_local,), dtype=torch.int32,
                                device=dev))

    @staticmethod
    def empty_state(P: int, device) -> HotTrackerState:
        """Zero-row state of a heat-less store, for ``P`` participants held
        here: its state keeps the reference's structure whatever the
        knob."""
        return HotTrackerState(
            heat=torch.zeros((P, 0), dtype=torch.float32, device=device),
            backlog=torch.zeros((P,), dtype=torch.int32, device=device))

    # -- verbs (all local, all batched) ---------------------------------------
    def line_of(self, nodes, slots):
        """Global row ids of (node, slot) lanes, clipped into the table."""
        lid = nodes.to(torch.int64) * self.slots + slots.to(torch.int64)
        return lid.clamp(0, self.rows - 1)

    def _flat(self, nodes, slots, preds):
        """(n, R) lanes → flat (n·R,) positions in the (n, rows) table and
        (n·R,) int64 flags."""
        lid = self.line_of(nodes, slots)
        base = torch.arange(lid.shape[0], device=lid.device)[:, None] \
            * self.rows
        return (base + lid).reshape(-1), \
            preds.expand(lid.shape).reshape(-1).to(torch.int64)

    def observe(self, st: HotTrackerState, nodes, slots,
                preds) -> HotTrackerState:
        """Account one (n, R) read window: decay every counter once, then
        add each participant's live lanes, +1 a lane."""
        heat = st.heat * self.decay
        if heat.numel() == 0:
            return st._replace(heat=heat)
        flat, cnt = self._flat(nodes, slots, preds)
        pos, tot = _line_totals(flat, cnt)
        hv = heat.view(-1)
        hv[pos] = hv[pos] + tot.to(torch.float32)
        return st._replace(heat=heat)

    def forget(self, st: HotTrackerState, nodes, slots,
               preds) -> HotTrackerState:
        """Zero the heat lines of vacated rows (DELETE and MOVE free a
        (node, slot)), so a slot's next tenant starts cold."""
        flat, hit = self._flat(nodes, slots, preds)
        pos, tot = _line_totals(flat, hit)
        heat = st.heat.clone()
        hv = heat.view(-1)
        hv[pos] = torch.where(tot > 0, torch.zeros((), device=hv.device),
                              hv[pos])
        return st._replace(heat=heat)

    def all_heat(self, st: HotTrackerState):
        """The (readers, rows) heat matrix: the all-gather of the
        per-participant vectors (in the stacked binding, the state
        itself)."""
        return self.rt.gather(st.heat)
