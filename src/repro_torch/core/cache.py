"""read_cache — the locality-managed read tier's cached channel layer
(DESIGN.md §8.2), the counterpart of ``repro/core/cache.py``.

A small **direct-mapped cache of hot remote rows**, keyed by ``(node,
slot)`` and validated by the per-slot reuse counter the kvstore's rows
already carry.  The cache is private per-participant memory (declared in the
memory ledger, never addressed by peers); consistency is the composing
kvstore's job.  All verbs take lanes led by the participants held here
(P stacked, 1 a rank), as every state and argument is.

State layout (per participant): ``tags`` (N, 2) int32 ``[node | slot]``
(``node == -1`` marks an invalid line) and ``rows`` (N, RW) int32, the cached
full encoded row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .channel import Channel
from .runtime import Manager
from .u32 import MASK32, mul32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche hash, uint32 → uint32 (int64 holders) — the
    kvstore index's bucket function."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class ReadCacheState(NamedTuple):
    tags: torch.Tensor  # (n, N, 2) int32: [node | slot]; node == -1 → invalid
    rows: torch.Tensor  # (n, N, RW) int32 cached encoded rows


class ReadCache(Channel):
    """Direct-mapped cache of remote rows, keyed by ``(node, slot)``.

    The line of a row is its linear id ``node · backing_slots + slot``
    modulo ``lines`` — not hashed: kvstore slots are allocated densely, so
    ``lines ≥ P · backing_slots`` caches every row with no aliasing.  The
    verbs are local and collective-free."""

    def __init__(self, parent, name: str, mgr: Manager, *, lines: int,
                 row_width: int, backing_slots: int):
        super().__init__(parent, name, mgr)
        self.N = int(lines)
        self.RW = int(row_width)
        self.backing_slots = int(backing_slots)
        if self.N <= 0:
            raise ValueError("ReadCache needs at least one line")
        self.declare_region("tags", (self.N, 2), torch.int32)
        self.declare_region("rows", (self.N, self.RW), torch.int32)

    def init_state(self, device=None) -> ReadCacheState:
        dev = self.device if device is None else device
        return ReadCacheState(
            tags=torch.full((self.n_local, self.N, 2), -1, dtype=torch.int32,
                            device=dev),
            rows=torch.zeros((self.n_local, self.N, self.RW),
                             dtype=torch.int32,
                             device=dev))

    @staticmethod
    def empty_state(P: int, row_width: int, device) -> ReadCacheState:
        """Zero-line state for cache-less composers (same structure), for
        ``P`` participants held here."""
        return ReadCacheState(
            tags=torch.zeros((P, 0, 2), dtype=torch.int32, device=device),
            rows=torch.zeros((P, 0, row_width), dtype=torch.int32,
                             device=device))

    # -- line addressing -------------------------------------------------------
    def lines_for(self, nodes, slots):
        """(n, R) (node, slot) lanes → (n, R) int64 line indices, computed
        in uint32 as the reference does."""
        lid = (mul32(nodes.to(torch.int64) & MASK32, self.backing_slots)
               + (slots.to(torch.int64) & MASK32)) & MASK32
        return lid % self.N

    def _lanes(self, x):
        """A lane tensor shared by every participant, (R,), as (n, R)."""
        return x.expand(self.n_local, -1) if x.dim() == 1 else x

    # -- verbs (all local, all batched) ---------------------------------------
    def lookup(self, st: ReadCacheState, nodes, slots):
        """(n, R) lookups → (rows (n, R, RW), tag_hit (n, R)).  A tag hit
        only says the line holds *some* copy of (node, slot); the caller
        validates the cached row's counter (§8.2) before serving it."""
        line = self.lines_for(nodes, slots)
        homes = torch.arange(line.shape[0], device=line.device)[:, None]
        tag = st.tags[homes, line]                               # (P, R, 2)
        hit = (tag[..., 0] == nodes.to(torch.int32)) \
            & (tag[..., 1] == slots.to(torch.int32))
        return st.rows[homes, line], hit

    def fill(self, st: ReadCacheState, nodes, slots, rows, preds):
        """Refill the lines of the enabled (n, R) lanes; lanes that share a
        line resolve last-lane-wins, as the reference's ordered scatter
        does.  Returns the new state (the input state is not modified)."""
        P, R = nodes.shape
        line = self.lines_for(nodes, slots)
        lane = torch.arange(R, device=line.device).expand(P, R)
        last = torch.full((P, self.N + 1), -1, dtype=torch.int64,
                          device=line.device)
        last.scatter_reduce_(1, torch.where(preds, line, self.N), lane,
                             "amax")
        win = preds & (last.gather(1, line) == lane)
        tag = torch.stack([nodes.to(torch.int32), slots.to(torch.int32)], -1)
        return ReadCacheState(tags=self._put(st.tags, line, tag, win),
                              rows=self._put(st.rows, line,
                                             rows.to(torch.int32), win))

    def invalidate(self, st: ReadCacheState, nodes, slots, preds):
        """Drop the lines addressed by the enabled (node, slot) lanes —
        (n, R), or (R,) lanes every participant applies (the gathered
        mutation records).  Conservative: a line that merely shares the
        index is dropped too, which is a miss, never a wrong value."""
        nodes, slots, preds = (self._lanes(t) for t in (nodes, slots, preds))
        line = self.lines_for(nodes, slots)
        return st._replace(tags=self._put(st.tags, line, -1, preds))

    def _put(self, table, line, values, keep):
        """A copy of the (P, N, k) ``table`` with ``values`` stored at the
        kept lanes' lines; kept lanes must not share a line unless they
        store the same value.  Dropped lanes land on a spare line N that is
        cut off again — a masked store with no host read."""
        P, R = line.shape
        out = torch.cat([table, table[:, :1]], dim=1)
        homes = torch.arange(P, device=line.device)[:, None].expand(P, R)
        out[homes, torch.where(keep, line, self.N)] = torch.as_tensor(
            values, dtype=table.dtype, device=table.device).expand(
                (P, R) + tuple(table.shape[2:]))
        return out[:, :self.N].contiguous()
