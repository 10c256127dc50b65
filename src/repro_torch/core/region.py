"""shared_region — the basic building block of most LOCO channels (§5.1.1),
the counterpart of ``repro/core/region.py``.

A symmetric region of memory on each participant; every participant can read
and write all other participants' regions at row granularity.  The region
guarantees nothing about consistency — higher channels layer locks, usage
constraints and checksums on top.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import colls
from .ack import ALL_PEERS, make_ack
from .backends import get_backend
from .channel import Channel
from .runtime import Manager


class SharedRegionState(NamedTuple):
    buf: torch.Tensor  # (P, slots, *item)


class SharedRegion(Channel):
    """Symmetric per-participant buffer of ``slots`` rows of ``item_shape``."""

    def __init__(self, parent, name: str, mgr: Manager, *, slots: int,
                 item_shape: Tuple[int, ...] = (), dtype=torch.float32,
                 backend=None):
        super().__init__(parent, name, mgr)
        self.slots = int(slots)
        self.item_shape = tuple(item_shape)
        self.dtype = dtype
        self.backend = get_backend(backend, default=mgr.backend)
        self.declare_region("buf", (self.slots, *self.item_shape), dtype)

    def init_state(self, device=None) -> SharedRegionState:
        return SharedRegionState(buf=torch.zeros(
            (self.P, self.slots, *self.item_shape), dtype=self.dtype,
            device=self.device if device is None else device))

    @property
    def item_nbytes(self) -> int:
        return int(np.prod(self.item_shape, dtype=np.int64) or 1) \
            * self.dtype.itemsize

    def _local_rows(self, index):
        """(P,) row indices of my own buffer, as JAX indexes one: a negative
        index counts from the end."""
        index = colls._per_participant(index, self.P, self.device,
                                       torch.int64)
        return torch.where(index < 0, index + self.slots, index)

    def local_read(self, state: SharedRegionState, index):
        """Each participant's own row ``index`` (no collective), clamped into
        the buffer as a JAX gather clamps.  Returns (P, *item)."""
        rows = self._local_rows(index).clamp(0, self.slots - 1)
        return state.buf[self.my_id(), rows]

    def local_write(self, state: SharedRegionState, index, value,
                    pred=True) -> SharedRegionState:
        """Each participant stores ``value`` (P, *item) into its own row
        ``index`` where ``pred``; a row outside the buffer is dropped, as a
        JAX scatter drops it."""
        rows = self._local_rows(index)
        keep = colls._per_participant(pred, self.P, self.device, torch.bool) \
            & (rows >= 0) & (rows < self.slots)
        value = torch.as_tensor(value, device=self.device).expand(
            (self.P,) + self.item_shape)
        return state._replace(buf=colls.put_rows(
            state.buf, rows.clamp(0, self.slots - 1)[:, None],
            value[:, None], keep[:, None]))

    def local_write_batch(self, state: SharedRegionState, indices, values,
                          preds=None) -> SharedRegionState:
        """Masked batch of local row writes (no collective, one scatter).

        indices (P, R); values (P, R, *item); preds (P, R) bool.  Enabled
        rows must be distinct per participant; disabled lanes are dropped."""
        if preds is None:
            preds = torch.ones(indices.shape, dtype=torch.bool,
                               device=indices.device)
        rows = indices.long().clamp(0, self.slots - 1)
        return state._replace(buf=colls.put_rows(state.buf, rows, values,
                                                 preds))

    def read(self, state: SharedRegionState, target, index, pred=True):
        """One-sided read of row ``index`` at participant ``target``, one per
        participant: (P,) ints or one for all.  Returns (values (P, *item),
        ack)."""
        val = self.backend.read(state.buf, target, index, pred=pred,
                                ledger=self.mgr.traffic,
                                verb=f"{self.full_name}.read")
        ack = make_ack(val, "read", self.full_name, ALL_PEERS,
                       self.item_nbytes)
        return val, self.mgr.track(ack)

    def write(self, state: SharedRegionState, target, index, value,
              pred=True):
        """One-sided write of ``value`` (P, *item) to row ``index`` at
        participant ``target``, one per participant; racy writes to one row
        land in participant order.  Returns (state, ack)."""
        buf = self.backend.write(state.buf, target, index, value, pred=pred,
                                 ledger=self.mgr.traffic,
                                 verb=f"{self.full_name}.write")
        ack = make_ack(buf, "write", self.full_name, ALL_PEERS,
                       self.item_nbytes)
        return state._replace(buf=buf), self.mgr.track(ack)

    def read_batch(self, state: SharedRegionState, targets, indices,
                   preds=None, coalesce=True):
        """Batched one-sided read of (P, R) lanes; ``coalesce`` dedupes
        duplicate (target, index) lanes before the wire (DESIGN.md §8.1)."""
        vals = self.backend.read_batch(state.buf, targets, indices,
                                       preds=preds, ledger=self.mgr.traffic,
                                       verb=f"{self.full_name}.read_batch",
                                       coalesce=coalesce)
        ack = make_ack(vals, "read", self.full_name, ALL_PEERS,
                       self.item_nbytes * int(targets.shape[1]))
        return vals, self.mgr.track(ack)

    def write_batch(self, state: SharedRegionState, targets, indices, values,
                    preds=None, assume_unique=False):
        """Batched one-sided write of (P, R) lanes."""
        buf = self.backend.write_batch(state.buf, targets, indices, values,
                                       preds=preds,
                                       assume_unique=assume_unique,
                                       ledger=self.mgr.traffic,
                                       verb=f"{self.full_name}.write_batch")
        new = state._replace(buf=buf)
        ack = make_ack(buf, "write", self.full_name, ALL_PEERS,
                       self.item_nbytes * int(targets.shape[1]))
        return new, self.mgr.track(ack)
