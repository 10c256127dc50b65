"""owned_var — single-writer multi-reader register (LOCO §5.1.1), the
counterpart of ``repro/core/ownedvar.py``.

This slice ports what the KVStore path needs: the 32-bit :func:`checksum`
every encoded row carries, and the :class:`OwnedVar` channel as the SST's
named per-participant register (its push/pull verbs wait for a later slice).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .channel import Channel
from .runtime import Manager
from .u32 import MASK32, mul32


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
    """Single-writer multi-reader register owned by participant ``owner``."""

    def __init__(self, parent, name: str, mgr: Manager, *, owner: int,
                 shape: Tuple[int, ...] = (), dtype=torch.float32):
        super().__init__(parent, name, mgr)
        self.owner = int(owner)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.nbytes = value_nbytes(self.shape, dtype)
        self.declare_region("val", self.shape, dtype)
