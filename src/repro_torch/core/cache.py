"""read_cache — the locality-managed read tier (DESIGN.md §8.2), the
counterpart of ``repro/core/cache.py``.

This slice ports :func:`hash_u32`, the kvstore index's bucket function, and
the zero-line :meth:`ReadCache.empty_state` a cache-less store carries so its
state has the reference's structure.  The cached read tier waits for a later
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .u32 import MASK32, mul32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche hash, uint32 → uint32 (int64 holders)."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class ReadCacheState(NamedTuple):
    tags: torch.Tensor  # (P, N, 2) int32: [node | slot]; node == -1 → invalid
    rows: torch.Tensor  # (P, N, RW) int32 cached encoded rows


class ReadCache:
    """Direct-mapped cache of remote rows, keyed by ``(node, slot)``; only
    the zero-line state of a cache-less store is ported so far."""

    @staticmethod
    def empty_state(P: int, row_width: int, device) -> ReadCacheState:
        return ReadCacheState(
            tags=torch.zeros((P, 0, 2), dtype=torch.int32, device=device),
            rows=torch.zeros((P, 0, row_width), dtype=torch.int32,
                             device=device))
