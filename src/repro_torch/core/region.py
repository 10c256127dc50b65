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
        return vals, ack

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
        return new, ack
