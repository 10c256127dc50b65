"""SST — Shared State Table (LOCO §4.1/§5.1.2, after Derecho), the
counterpart of ``repro/core/sst.py``.

An array of single-writer multiple-reader registers, one per participant:
participant i writes row i and reads all rows.  Composed from P owned_var
sub-channels ("<sst>/ov<i>").  This slice ports the scalar uint32 register
table the KVStore tracker acknowledges through: ``push_accumulate`` and
``rows``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import colls
from .ack import ALL_PEERS, AckKey, make_ack
from .channel import Channel
from .ownedvar import OwnedVar, checksum
from .runtime import Manager
from .u32 import MASK32


class SSTState(NamedTuple):
    # cached[p, i]: participant p's cached copy of participant i's register
    cached: torch.Tensor  # (P, P) uint32 (int64 holder)
    csum: torch.Tensor    # (P, P) uint32 (int64 holder)


class SST(Channel):
    """Shared state table of per-participant scalar uint32 registers."""

    def __init__(self, parent, name: str, mgr: Manager):
        super().__init__(parent, name, mgr)
        self.vars = [OwnedVar(self, f"ov{i}", mgr, owner=i, shape=(),
                              dtype=torch.uint32) for i in range(self.P)]
        self.row_nbytes = self.vars[0].nbytes

    def init_state(self, value: int = 0) -> SSTState:
        v = torch.full((self.P, self.P), int(value) & MASK32,
                       dtype=torch.int64, device=self.device)
        return SSTState(cached=v, csum=checksum(v, item_dims=0))

    def store_mine(self, state: SSTState, value, pred=True) -> SSTState:
        """Local store of each participant's own register (row ``me``)."""
        me = self.my_id()
        value = torch.as_tensor(value, device=self.device).to(torch.int64) \
            .expand(self.P) & MASK32
        row = torch.where(torch.as_tensor(pred, device=self.device), value,
                          state.cached[me, me])
        cached = state.cached.clone()
        csum = state.csum.clone()
        cached[me, me] = row
        csum[me, me] = checksum(row, item_dims=0)
        return SSTState(cached=cached, csum=csum)

    def push_accumulate(self, state: SSTState, delta, pred=True):
        """Bump each participant's register by ``delta`` (uint32 wrap) and
        push to all peers in one round — the multi-record acknowledgement of
        the kvstore tracker.  Returns (state, ack)."""
        me = self.my_id()
        bumped = state.cached[me, me] + torch.as_tensor(
            delta, device=self.device).to(torch.int64)
        return self.push_broadcast(self.store_mine(state, bumped, pred=pred))

    def push_broadcast(self, state: SSTState):
        """Push each register to all peers (all owners at once → one
        all-gather): every participant's table becomes the diagonal."""
        me = self.my_id()
        rows = state.cached[me, me]
        csums = state.csum[me, me]
        new = SSTState(cached=colls.gather_rows(rows).clone(),
                       csum=colls.gather_rows(csums).clone())
        ack = AckKey.empty()
        for i, v in enumerate(self.vars):
            ack = ack | make_ack((rows[i], csums[i]), "write", v.full_name,
                                 ALL_PEERS, self.row_nbytes)
        return new, ack

    def rows(self, state: SSTState):
        """All cached rows, (P viewers, P)."""
        return state.cached
