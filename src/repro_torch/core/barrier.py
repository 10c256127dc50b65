"""Barrier channel — paper Fig. 1a, after Gupta et al.; the counterpart of
``repro/core/barrier.py``.

Each participant increments a private count, broadcasts it through its SST
register, then waits until every row of the SST is at least its own count.
A fence of the caller's scope (global by default, §5.4) comes first, so all
prior remote operations are visible to peers that observe the barrier.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ack import FenceScope
from .channel import Channel
from .runtime import Manager
from .sst import SST, SSTState
from .u32 import MASK32


class BarrierState(NamedTuple):
    count: torch.Tensor  # (P,) uint32 (int64 holder) private counters
    sst: SSTState


class Barrier(Channel):
    def __init__(self, parent, name: str, mgr: Manager,
                 expect_num: int | None = None):
        super().__init__(parent, name, mgr, expect_num=expect_num)
        self.sst = SST(self, "sst", mgr)

    def init_state(self) -> BarrierState:
        return BarrierState(
            count=torch.zeros((self.P,), dtype=torch.int64,
                              device=self.device),
            sst=self.sst.init_state())

    def wait(self, state: BarrierState,
             fence_scope: FenceScope = FenceScope.GLOBAL) -> BarrierState:
        """Enter the barrier; returns once every participant has entered."""
        sst_state = self.mgr.fence(state.sst, scope=fence_scope)
        count = (state.count + 1) & MASK32
        sst_state = self.sst.store_mine(sst_state, count)
        sst_state, _ack = self.sst.push_broadcast(sst_state)
        # wait locally: re-pull while any participant sees a row behind its
        # own count (after a fresh push, none does).  The reference's
        # while_loop on a psum'd flag; here the exit test is one host read
        # an iteration.
        while bool((self.sst.rows(sst_state) < count[:, None]).any()):
            with self.mgr.no_tracking():
                sst_state, _ack = self.sst.pull_all(sst_state)
        return BarrierState(count=count, sst=sst_state)
