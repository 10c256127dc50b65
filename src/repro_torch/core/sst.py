"""SST — Shared State Table (LOCO §4.1/§5.1.2, after Derecho), the
counterpart of ``repro/core/sst.py``.

An array of single-writer multiple-reader registers, one per participant:
participant i writes row i and reads all rows.  Composed from P owned_var
sub-channels ("<sst>/ov<i>").  The port holds uint32 registers of any
``shape``: the scalar cursors and ack counters of the KVStore tracker and the
ring, and the ``[epoch, cursor, heartbeat]`` rows of the replicated log's
promotion table.
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
    cached: torch.Tensor  # (P, P, *shape) uint32 (int64 holder)
    csum: torch.Tensor    # (P, P) uint32 (int64 holder)


class SST(Channel):
    """Shared state table of per-participant uint32 registers of
    ``shape``."""

    def __init__(self, parent, name: str, mgr: Manager, *, shape=()):
        super().__init__(parent, name, mgr)
        self.shape = tuple(shape)
        self.vars = [OwnedVar(self, f"ov{i}", mgr, owner=i, shape=self.shape,
                              dtype=torch.uint32) for i in range(self.P)]
        self.row_nbytes = self.vars[0].nbytes

    def _csum(self, rows):
        return checksum(rows, item_dims=len(self.shape))

    def init_state(self, value: int = 0, device=None) -> SSTState:
        v = torch.full((self.P, self.P) + self.shape, int(value) & MASK32,
                       dtype=torch.int64,
                       device=self.device if device is None else device)
        return SSTState(cached=v, csum=self._csum(v))

    def store_mine(self, state: SSTState, value, pred=True) -> SSTState:
        """Local store of each participant's own register (row ``me``):
        ``value`` (P, *shape), ``pred`` a (P,) mask or a bool."""
        me = self.my_id()
        value = torch.as_tensor(value, device=self.device).to(torch.int64) \
            .expand((self.P,) + self.shape) & MASK32
        pred = torch.as_tensor(pred, device=self.device).expand(self.P)
        pred = pred.reshape((self.P,) + (1,) * len(self.shape))
        row = torch.where(pred, value, state.cached[me, me])
        cached = state.cached.clone()
        csum = state.csum.clone()
        cached[me, me] = row
        csum[me, me] = self._csum(row)
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
        return new, self.mgr.track(ack)

    def load_row(self, state: SSTState, i):
        """Local read of cached row ``i`` (an int or a (P,) tensor, one row
        per participant) → (value (P, *shape), checksum_ok (P,))."""
        me = self.my_id()
        i = torch.as_tensor(i, device=self.device).to(torch.int64) \
            .expand(self.P)
        val = state.cached[me, i]
        return val, self._csum(val) == state.csum[me, i]

    def rows(self, state: SSTState):
        """All cached rows, (P viewers, P, *shape)."""
        return state.cached

    def pull_all(self, state: SSTState):
        """Refresh all cached rows from their owners (readers' pull)."""
        me = self.my_id()
        rows = state.cached[me, me]
        csums = state.csum[me, me]
        new = SSTState(cached=colls.gather_rows(rows).clone(),
                       csum=colls.gather_rows(csums).clone())
        ack = make_ack((rows, csums), "read", self.full_name, ALL_PEERS,
                       self.row_nbytes * self.P)
        return new, self.mgr.track(ack)
