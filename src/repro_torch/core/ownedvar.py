"""owned_var — single-writer multi-reader register (LOCO §5.1.1), the
counterpart of ``repro/core/ownedvar.py``.

Each owned_var has one authoritative copy at its *owner* and cached copies at
every other participant, updated by owner pushes or reader pulls.  Values of
at most the atomic word size are inherently atomic; larger ones carry the
32-bit :func:`checksum` (the one every KVStore row carries too), and
:meth:`OwnedVar.load` reports a mismatch, which the reader answers by
reading again.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import colls
from .ack import ALL_PEERS, make_ack
from .channel import Channel
from .runtime import Manager
from .u32 import MASK32, mul32

_ATOMIC_WORD_BYTES = 4


def value_nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64) or 1) * dtype.itemsize


def checksum(value: torch.Tensor, item_dims: int = 1) -> torch.Tensor:
    """Deterministic 32-bit checksum of the bit pattern of each item: the
    last ``item_dims`` dimensions of ``value`` are one item (0: every
    element is one).  Returns the uint32 checksums (int64 holder) of shape
    ``value.shape[:-item_dims]``.

    A multiply–xor fold (murmur-style finalizer) over 32-bit lanes, bit for
    bit the reference's: floats hash their float32 bits, bools 0/1, integers
    their int32 bits (an int64 uint32 holder hashes its low 32 bits)."""
    v = value
    if v.is_floating_point():
        lanes = v.to(torch.float32).view(torch.int32).to(torch.int64)
    else:
        lanes = v.to(torch.int64)
    lanes = lanes & MASK32
    if item_dims == 0:
        lanes = lanes[..., None]
    else:
        lanes = lanes.reshape(tuple(v.shape[:v.dim() - item_dims]) + (-1,))
    n = lanes.shape[-1]
    idx = torch.arange(1, n + 1, dtype=torch.int64, device=v.device)
    h = (mul32(lanes, 0x9E3779B1) + mul32(idx, 0x85EBCA6B)) & MASK32
    h = h ^ (h >> 15)
    acc = h.sum(-1) & MASK32
    acc = acc ^ (acc >> 13)
    acc = mul32(acc, 0xC2B2AE35)
    return acc ^ (acc >> 16)


class OwnedVarState(NamedTuple):
    cached: torch.Tensor  # (P, *shape) local cached copy
    csum: torch.Tensor    # (P,) uint32 checksum of cached


class OwnedVar(Channel):
    """Single-writer multi-reader register owned by participant ``owner``.
    A ``torch.uint32`` register is held in int64, masked to 32 bits."""

    def __init__(self, parent, name: str, mgr: Manager, *, owner: int,
                 shape: Tuple[int, ...] = (), dtype=torch.float32):
        super().__init__(parent, name, mgr)
        self.owner = int(owner)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.nbytes = value_nbytes(self.shape, dtype)
        self.needs_checksum = self.nbytes > _ATOMIC_WORD_BYTES
        self.declare_region("val", self.shape, dtype)

    def _value(self, value):
        """``value`` as (P, *shape) of the register's type."""
        v = torch.as_tensor(value, device=self.device)
        if self.dtype == torch.uint32:
            v = v.to(torch.int64) & MASK32
        else:
            v = v.to(self.dtype)
        return v.expand((self.P,) + self.shape)

    def _csum(self, cached):
        return checksum(cached, item_dims=len(self.shape))

    def init_state(self, value=None) -> OwnedVarState:
        """Stacked initial state: every copy holds ``value`` (default 0)."""
        v = self._value(0 if value is None else value).clone()
        return OwnedVarState(cached=v, csum=self._csum(v))

    def store_mine(self, state: OwnedVarState, value,
                   pred=True) -> OwnedVarState:
        """Local store into each participant's own copy where ``pred``
        (meaningful at the owner; paper Fig. 1a)."""
        pred = colls._per_participant(pred, self.P, self.device, torch.bool)
        cached = torch.where(colls._lanes(pred, state.cached),
                             self._value(value), state.cached)
        return OwnedVarState(cached=cached, csum=self._csum(cached))

    def _from_owner(self, state: OwnedVarState):
        return OwnedVarState(
            cached=colls.bcast_from(state.cached, self.owner).clone(),
            csum=colls.bcast_from(state.csum, self.owner).clone())

    def push(self, state: OwnedVarState):
        """The owner pushes its copy to every cached copy (one-sided
        write).  Returns (state, ack)."""
        new = self._from_owner(state)
        ack = make_ack(tuple(new), "write", self.full_name, ALL_PEERS,
                       self.nbytes)
        return new, self.mgr.track(ack)

    def pull(self, state: OwnedVarState):
        """Readers refresh their cached copies from the owner (one-sided
        read).  Returns (state, ack)."""
        new = self._from_owner(state)
        ack = make_ack(tuple(new), "read", self.full_name, (self.owner,),
                       self.nbytes)
        return new, self.mgr.track(ack)

    def load(self, state: OwnedVarState):
        """Local load of each cached copy → (value (P, *shape),
        checksum_ok (P,)).  A word-size value is always whole; a larger one
        is checked against its stored checksum, and a mismatch means the
        read raced a torn update and must be retried (§5.1.1)."""
        if not self.needs_checksum:
            return state.cached, torch.ones(self.P, dtype=torch.bool,
                                            device=self.device)
        return state.cached, self._csum(state.cached) == state.csum
