"""Ticket locks over network memory — LOCO §5.4, after Mellor-Crummey &
Scott; the counterpart of ``repro/core/lock.py``.

:class:`TicketLock` is the paper's lock: ``next_ticket`` and
``now_serving`` are atomic_vars; acquire is a remote fetch-and-add on
next_ticket, the holder is the participant whose ticket equals now_serving,
and release increments now_serving after a fence of the caller's scope.
Contended requests serialize across rounds in FIFO ticket order.

:class:`TicketLockArray` is the KVStore's lock stripe, with its windowed
acquire (and its prepared form, for a caller that resolved the ranks
itself), release and holds test, whose single-request forms are windows of
one; :func:`window_fifo_ranks` is the fused windowed fetch-and-add that
resolves a whole window's tickets at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import colls
from .ack import FenceScope
from .atomic import AtomicVar, AtomicVarState
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


class TicketLockState(NamedTuple):
    next_ticket: AtomicVarState
    now_serving: AtomicVarState


class TicketLock(Channel):
    """One ticket lock whose two atomic_vars are hosted at ``host``."""

    def __init__(self, parent, name: str, mgr: Manager, *, host: int = 0):
        super().__init__(parent, name, mgr)
        self.next_ticket = AtomicVar(self, "next", mgr, host=host,
                                     dtype=torch.uint32)
        self.now_serving = AtomicVar(self, "serving", mgr, host=host,
                                     dtype=torch.uint32)

    def init_state(self) -> TicketLockState:
        return TicketLockState(next_ticket=self.next_ticket.init_state(0),
                               now_serving=self.now_serving.init_state(0))

    def acquire(self, state: TicketLockState, want=True):
        """Fetch a ticket (remote fetch-and-add).  Returns (state, tickets
        (n,) uint32), NO_TICKET for participants that do not want one."""
        want = colls._per_participant(want, self.n_local, self.device,
                                      torch.bool)
        nt, my_ticket, _ack = self.next_ticket.fetch_add(
            state.next_ticket, 1, pred=want)
        return state._replace(next_ticket=nt), \
            torch.where(want, my_ticket, NO_TICKET)

    def holds(self, state: TicketLockState, ticket):
        """Does each participant hold the lock this round?  (A local read of
        its cached now_serving.)"""
        return torch.as_tensor(ticket, device=self.device) \
            == self.now_serving.load_cached(state.now_serving)

    def refresh(self, state: TicketLockState):
        """Re-pull now_serving from its host (the spin read)."""
        ns, _ack = self.now_serving.pull(state.now_serving)
        return state._replace(now_serving=ns)

    def release(self, state: TicketLockState, holding,
                fence_scope: FenceScope = FenceScope.GLOBAL):
        """Release by the holder: fence prior operations (the caller's
        scope, §5.4), then increment now_serving.  At most one participant
        may pass ``holding=True`` a round."""
        ns_state = self.mgr.fence(state.now_serving, scope=fence_scope)
        ns, _old, _ack = self.now_serving.fetch_add(ns_state, 1,
                                                    pred=holding)
        return state._replace(now_serving=ns)


class TicketLockArrayState(NamedTuple):
    next_ticket: torch.Tensor  # (n, L) uint32 (int64 holder), replicated
    now_serving: torch.Tensor  # (n, L) uint32 (int64 holder), replicated


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
        z = torch.zeros((self.n_local, self.L), dtype=torch.int64,
                        device=self.device if device is None else device)
        return TicketLockArrayState(next_ticket=z, now_serving=z.clone())

    def _resolve(self, lock_ids, flags):
        """The window's gathered (lock, flag) lanes resolved: (my lanes'
        ranks (n, B), totals (L,))."""
        g_lids, g_flags = self.rt.gather_many(lock_ids, flags)
        rank, totals = window_fifo_ranks(g_lids, g_flags, self.L)
        return self.rt.mine(rank), totals

    def acquire_window(self, state: TicketLockArrayState, lock_ids, want):
        """FAA on next_ticket[lock_ids] for every wanting request.
        lock_ids (n, B) int; want (n, B) bool.  Returns (state, tickets
        (n, B) uint32) with NO_TICKET where not wanting."""
        rank, totals = self._resolve(lock_ids, want)
        return self.acquire_window_prepared(state, lock_ids, want, rank,
                                            totals)

    def acquire_window_prepared(self, state: TicketLockArrayState, lock_ids,
                                want, rank, totals):
        """Apply an already-resolved window acquire: ``(rank (n, B),
        totals (L,))`` as :func:`window_fifo_ranks` computes them on the
        gathered window, the rank rows those of the participants held
        here.  The reference's lock-free window plan (DESIGN.md §11) calls
        it with the ranks its own lane gather resolved; in the port
        :meth:`acquire_window` resolves them from one gather and calls it.
        Returns (state, tickets (n, B) uint32) with NO_TICKET where not
        wanting."""
        ticket = (state.next_ticket.gather(1, lock_ids.long()) + rank) \
            & MASK32
        new = state._replace(
            next_ticket=(state.next_ticket + totals[None]) & MASK32)
        return new, torch.where(want, ticket, NO_TICKET)

    def _one(self, x, dtype):
        """A single-request argument as (n, 1) lanes."""
        return colls._per_participant(x, self.n_local, self.device,
                                      dtype)[:, None]

    def acquire(self, state: TicketLockArrayState, lock_id, want):
        """Single-request form, a window of one: lock_id, want (n,).
        Returns (state, tickets (n,))."""
        new, ticket = self.acquire_window(
            state, self._one(lock_id, torch.int64),
            self._one(want, torch.bool))
        return new, ticket[:, 0]

    def holds(self, state: TicketLockArrayState, lock_id, ticket):
        """Does each lane hold its lock?  Elementwise over matching (n, ...)
        ``lock_id`` and ``ticket``."""
        lock_id = torch.as_tensor(lock_id, device=self.device)
        serving = state.now_serving.gather(
            1, lock_id.to(torch.int64).reshape(self.n_local, -1))
        return torch.as_tensor(ticket, device=self.device) \
            == serving.reshape(lock_id.shape)

    def release(self, state: TicketLockArrayState, lock_id, holding):
        """Single-request form, a window of one: lock_id, holding (n,)."""
        return self.release_window(state, self._one(lock_id, torch.int64),
                                   self._one(holding, torch.bool))

    def release_window(self, state: TicketLockArrayState, lock_ids,
                       holding):
        """Each holder increments now_serving[lock] for every window slot it
        holds (at most one holder per lock per round)."""
        _rank, totals = self._resolve(lock_ids, holding)
        return state._replace(
            now_serving=(state.now_serving + totals[None]) & MASK32)
