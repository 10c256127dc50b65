"""Ticket locks over network memory — LOCO §5.4, after Mellor-Crummey &
Scott; the counterpart of ``repro/core/lock.py``.

The port holds the KVStore's lock stripe: :class:`TicketLockArray` with its
windowed acquire (and its prepared form, the reference's surface for a
caller that resolved the ranks itself) and release, and
:func:`window_fifo_ranks`, the fused windowed fetch-and-add that resolves a
whole window's tickets at once.  The scalar :class:`TicketLock` waits for a
later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import colls
from .channel import Channel
from .runtime import Manager
from .u32 import MASK32

# Sentinel ticket for "not holding / not requesting".
NO_TICKET = 0xFFFFFFFF


def window_fifo_ranks(lids, gflags, num_locks):
    """The fused windowed FAA resolution over a gathered (P, B) window.

    ``lids`` (P, B) lock ids and ``gflags`` (P, B) request flags → ``rank``
    (P, B): for every lane, the count of flagged same-lock requests that
    precede it in (participant, window slot) order; and ``totals`` (L,): the
    flagged request count per lock.  ``ticket = next_ticket[lock] + rank``
    and ``next_ticket += totals`` resolve every lane's FAA in one step.  The
    reference's (P, B, B) per-participant masks become one segmented count
    over a stable sort by lock id, shared by all participants."""
    flat = lids.reshape(-1).to(torch.int64)
    flags = gflags.reshape(-1)
    rank = colls.count_before_same(colls.segments(flat), flags[None])[0]
    totals = torch.zeros((num_locks,), dtype=torch.int64, device=lids.device)
    totals.scatter_add_(0, flat, flags.to(torch.int64))
    return rank.reshape(lids.shape), totals


class TicketLockArrayState(NamedTuple):
    next_ticket: torch.Tensor  # (P, L) uint32 (int64 holder), replicated
    now_serving: torch.Tensor  # (P, L) uint32 (int64 holder), replicated


class TicketLockArray(Channel):
    """An array of L ticket locks (the kvstore's lock stripe, LOCO §6).

    Every update flows through the same deterministic resolution, so every
    participant holds a bit-identical replica of all L (next, serving)
    pairs.  ``acquire_window`` lets every participant request B tickets at
    once; per-lock FIFO order over the window is (participant, window slot)
    lexicographic."""

    def __init__(self, parent, name: str, mgr: Manager, *, num_locks: int):
        super().__init__(parent, name, mgr)
        self.L = int(num_locks)
        self.declare_region("next", (self.L,), torch.uint32)
        self.declare_region("serving", (self.L,), torch.uint32)

    def init_state(self, device=None) -> TicketLockArrayState:
        z = torch.zeros((self.P, self.L), dtype=torch.int64,
                        device=self.device if device is None else device)
        return TicketLockArrayState(next_ticket=z, now_serving=z.clone())

    def acquire_window(self, state: TicketLockArrayState, lock_ids, want):
        """FAA on next_ticket[lock_ids] for every wanting request.
        lock_ids (P, B) int; want (P, B) bool.  Returns (state, tickets
        (P, B) uint32) with NO_TICKET where not wanting."""
        rank, totals = window_fifo_ranks(lock_ids, want, self.L)
        return self.acquire_window_prepared(state, lock_ids, want, rank,
                                            totals)

    def acquire_window_prepared(self, state: TicketLockArrayState, lock_ids,
                                want, rank, totals):
        """Apply an already-resolved window acquire: ``(rank (P, B),
        totals (L,))`` as :func:`window_fifo_ranks` computes them.  The
        reference's lock-free window plan (DESIGN.md §11) calls it with the
        ranks its own lane gather resolved; in the stacked port
        :meth:`acquire_window` resolves them once for every participant and
        calls it.  Returns (state, tickets (P, B) uint32) with NO_TICKET
        where not wanting."""
        ticket = (state.next_ticket.gather(1, lock_ids.long()) + rank) \
            & MASK32
        new = state._replace(
            next_ticket=(state.next_ticket + totals[None]) & MASK32)
        return new, torch.where(want, ticket, NO_TICKET)

    def release_window(self, state: TicketLockArrayState, lock_ids,
                       holding):
        """Each holder increments now_serving[lock] for every window slot it
        holds (at most one holder per lock per round)."""
        _rank, totals = window_fifo_ranks(lock_ids, holding, self.L)
        return state._replace(
            now_serving=(state.now_serving + totals[None]) & MASK32)
