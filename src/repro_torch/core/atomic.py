"""atomic_var — multi-writer multi-reader word-size register (LOCO §5.1.1),
the counterpart of ``repro/core/atomic.py``.

One "official" copy hosted at one participant, cached copies everywhere,
with the remote atomics RDMA provides (fetch-and-add, compare-and-swap) and
plain load/store.  Concurrent requests within a round are serialized in
participant order (and lane order within a window) — the deterministic
stand-in for NIC arrival order: a fetch-and-add takes its amounts in
participant order, and the lowest contender wins a compare-and-swap or a
store.  The windowed fetch-and-add's per-lock form is the ticket-lock
array's acquire (:func:`repro_torch.core.lock.window_fifo_ranks`).  A
``torch.uint32`` register is held in int64 and wraps modulo 2**32, as the
reference's uint32 does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import colls
from .ack import make_ack
from .channel import Channel
from .runtime import Manager
from .u32 import MASK32


class AtomicVarState(NamedTuple):
    official: torch.Tensor  # (n,) authoritative value (meaningful at host)
    cached: torch.Tensor    # (n,) local cached copy


class AtomicVar(Channel):
    """Word-size atomic register hosted at participant ``host``."""

    def __init__(self, parent, name: str, mgr: Manager, *, host: int = 0,
                 dtype=torch.int32):
        super().__init__(parent, name, mgr)
        self.host = int(host)
        self.dtype = dtype
        # a uint32 register lives in an int64 holder, masked to 32 bits
        self.u32 = dtype == torch.uint32
        self.holder = torch.int64 if self.u32 else dtype
        self.declare_region("word", (), dtype)

    def _wrap(self, x):
        return (x & MASK32) if self.u32 else x.to(self.dtype)

    def init_state(self, value=0) -> AtomicVarState:
        v = torch.full((self.n_local,), value, dtype=self.holder,
                       device=self.device)
        return AtomicVarState(official=self._wrap(v), cached=self._wrap(v))

    def _word(self, x):
        """A scalar or (n,) value as (n,) words of the register's type."""
        x = colls._per_participant(x, self.n_local, self.device)
        return self._wrap(x.to(self.holder))

    def fetch_add(self, state: AtomicVarState, amount, pred=True):
        """Atomic fetch-and-add: every participant may request in the same
        round, and the requests are taken in participant order — the
        :meth:`fetch_add_window` of one lane.  Returns (state, my_old (n,),
        ack); where ``pred`` is False ``my_old`` is the pre-round official
        value."""
        pred = colls._per_participant(pred, self.n_local, self.device,
                                      torch.bool)
        new, old, ack = self.fetch_add_window(
            state, self._word(amount)[:, None], pred[:, None])
        return new, old[:, 0], ack

    def _first_wins(self, old, want, value):
        """The official value after a round in which the lowest wanting
        participant stores its ``value``: (new_val (n,), winner (n,)).  The
        contenders and their values are gathered."""
        g_want, g_value = self.rt.gather(want), self.rt.gather(
            self._word(value))
        first = g_want.to(torch.uint8).argmax()   # lowest wanting id (0: none)
        new_val = torch.where(g_want.any(), g_value[first[None]], old)
        return new_val, want & (self.my_id() == first)

    def compare_swap(self, state: AtomicVarState, expected, desired,
                     pred=True):
        """Atomic compare-and-swap; among same-round contenders whose
        ``expected`` matches, the lowest participant id wins.  Returns
        (state, old (n,), success (n,), ack)."""
        old = colls.bcast_from(state.official, self.host, self.rt)
        want = colls._per_participant(pred, self.n_local, self.device,
                                      torch.bool) \
            & (self._word(expected) == old)
        new_val, success = self._first_wins(old, want, desired)
        new = AtomicVarState(official=new_val, cached=new_val.clone())
        ack = make_ack(new_val, "atomic", self.full_name, (self.host,),
                       self.dtype.itemsize)
        return new, old, success, self.mgr.track(ack)

    def store(self, state: AtomicVarState, value, pred=True):
        """Relaxed store; same-round stores resolve lowest id wins.
        Returns (state, ack)."""
        want = colls._per_participant(pred, self.n_local, self.device,
                                      torch.bool)
        new_val, _won = self._first_wins(
            colls.bcast_from(state.official, self.host, self.rt), want, value)
        new = AtomicVarState(official=new_val, cached=new_val.clone())
        ack = make_ack(new_val, "write", self.full_name, (self.host,),
                       self.dtype.itemsize)
        return new, self.mgr.track(ack)

    def load_cached(self, state: AtomicVarState):
        """Relaxed local read of the cached copy (no network)."""
        return state.cached

    def pull(self, state: AtomicVarState):
        """Refresh the cached copies from the official copy (one-sided
        read).  Returns (state, ack)."""
        val = colls.bcast_from(state.official, self.host, self.rt).clone()
        ack = make_ack(val, "read", self.full_name, (self.host,),
                       self.dtype.itemsize)
        return state._replace(cached=val), self.mgr.track(ack)

    def fetch_add_window(self, state: AtomicVarState, amount, preds):
        """Windowed fetch-and-add: (n, B) requests resolved in ONE ranked
        prefix scan over all P·B lanes in (participant, lane) order.

        amount: scalar or (n, B) added per enabled lane; preds (n, B) bool.
        Returns (new_state, my_old (n, B), ack); disabled lanes report the
        pre-round official value."""
        preds = torch.as_tensor(preds, device=self.device)
        amt = torch.where(preds, torch.as_tensor(amount, dtype=self.holder,
                                                 device=self.device),
                          torch.zeros((), dtype=self.holder,
                                      device=self.device))
        old = colls.bcast_from(state.official, self.host, self.rt)
        excl, total = colls.window_prefix(amt, self.rt)
        my_old = self._wrap(old[:, None] + excl)
        new_val = self._wrap(old + total)
        new = AtomicVarState(official=new_val, cached=new_val.clone())
        ack = make_ack(new_val, "atomic", self.full_name, (self.host,),
                       self.dtype.itemsize * int(preds.shape[1]))
        return new, torch.where(preds, my_old, old[:, None]), \
            self.mgr.track(ack)
