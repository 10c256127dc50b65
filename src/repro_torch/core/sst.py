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

from .ack import ALL_PEERS, AckKey, make_ack
from .channel import Channel
from .ownedvar import OwnedVar, checksum
from .runtime import Manager
from .u32 import MASK32


class SSTState(NamedTuple):
    # cached[p, i]: held participant p's cached copy of participant i's
    # register (p a local position, i a global id)
    cached: torch.Tensor  # (n, P, *shape) uint32 (int64 holder)
    csum: torch.Tensor    # (n, P) uint32 (int64 holder)


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
        v = torch.full((self.n_local, self.P) + self.shape,
                       int(value) & MASK32,
                       dtype=torch.int64,
                       device=self.device if device is None else device)
        return SSTState(cached=v, csum=self._csum(v))

    def _own(self):
        """(local positions, global ids) of the participants held here: a
        participant's own register is ``cached[loc, me]``."""
        return self.local_ids(), self.my_id()

    def store_mine(self, state: SSTState, value, pred=True) -> SSTState:
        """Local store of each participant's own register (row ``me``):
        ``value`` (n, *shape), ``pred`` an (n,) mask or a bool."""
        loc, me = self._own()
        n = self.n_local
        value = torch.as_tensor(value, device=self.device).to(torch.int64) \
            .expand((n,) + self.shape) & MASK32
        pred = torch.as_tensor(pred, device=self.device).expand(n)
        pred = pred.reshape((n,) + (1,) * len(self.shape))
        row = torch.where(pred, value, state.cached[loc, me])
        cached = state.cached.clone()
        csum = state.csum.clone()
        cached[loc, me] = row
        csum[loc, me] = self._csum(row)
        return SSTState(cached=cached, csum=csum)

    def push_accumulate(self, state: SSTState, delta, pred=True):
        """Bump each participant's register by ``delta`` (uint32 wrap) and
        push to all peers in one round — the multi-record acknowledgement of
        the kvstore tracker.  Returns (state, ack)."""
        loc, me = self._own()
        bumped = state.cached[loc, me] + torch.as_tensor(
            delta, device=self.device).to(torch.int64)
        return self.push_broadcast(self.store_mine(state, bumped, pred=pred))

    def push_broadcast(self, state: SSTState):
        """Push each register to all peers (all owners at once → one
        all-gather): every participant's table becomes the diagonal."""
        new = self._gather_own(state)
        ack = AckKey.empty()
        for i, v in enumerate(self.vars):
            ack = ack | make_ack((new.cached[:, i], new.csum[:, i]), "write",
                                 v.full_name, ALL_PEERS, self.row_nbytes)
        return new, self.mgr.track(ack)

    def load_row(self, state: SSTState, i):
        """Local read of cached row ``i`` (an int or an (n,) tensor, one row
        per participant) → (value (n, *shape), checksum_ok (n,))."""
        loc = self.local_ids()
        i = torch.as_tensor(i, device=self.device).to(torch.int64) \
            .expand(self.n_local)
        val = state.cached[loc, i]
        return val, self._csum(val) == state.csum[loc, i]

    def rows(self, state: SSTState):
        """All cached rows, (n viewers, P, *shape)."""
        return state.cached

    def _gather_own(self, state: SSTState) -> SSTState:
        """Every owner's register gathered into every viewer's table (one
        all-gather of the owners' rows and their checksums)."""
        loc, me = self._own()
        n = self.n_local
        rows, csums = self.rt.gather_many(state.cached[loc, me],
                                          state.csum[loc, me])
        return SSTState(
            cached=rows[None].expand((n,) + tuple(rows.shape)).clone(),
            csum=csums[None].expand((n,) + tuple(csums.shape)).clone())

    def pull_all(self, state: SSTState):
        """Refresh all cached rows from their owners (readers' pull)."""
        new = self._gather_own(state)
        ack = make_ack(tuple(new), "read", self.full_name, ALL_PEERS,
                       self.row_nbytes * self.P)
        return new, self.mgr.track(ack)
