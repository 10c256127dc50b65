"""atomic_var — multi-writer multi-reader word-size register (LOCO §5.1.1),
the counterpart of ``repro/core/atomic.py``.

One "official" copy hosted at one participant, cached copies everywhere.
Concurrent requests within a round are serialized in participant order (and
lane order within a window) — the deterministic stand-in for NIC arrival
order.  The port carries the windowed fetch-and-add, whose per-lock form is
the ticket-lock array's acquire (:func:`repro_torch.core.lock.window_fifo_ranks`)
and whose single-counter form issues the shared queue's tickets.  A
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
    official: torch.Tensor  # (P,) authoritative value (meaningful at host)
    cached: torch.Tensor    # (P,) local cached copy


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
        v = torch.full((self.P,), value, dtype=self.holder,
                       device=self.device)
        return AtomicVarState(official=self._wrap(v), cached=self._wrap(v))

    def fetch_add_window(self, state: AtomicVarState, amount, preds):
        """Windowed fetch-and-add: (P, B) requests resolved in ONE ranked
        prefix scan over all P·B lanes in (participant, lane) order.

        amount: scalar or (P, B) added per enabled lane; preds (P, B) bool.
        Returns (new_state, my_old (P, B), ack); disabled lanes report the
        pre-round official value."""
        preds = torch.as_tensor(preds, device=self.device)
        amt = torch.where(preds, torch.as_tensor(amount, dtype=self.holder,
                                                 device=self.device),
                          torch.zeros((), dtype=self.holder,
                                      device=self.device))
        old = colls.bcast_from(state.official, self.host)
        excl, total = colls.window_prefix(amt)
        my_old = self._wrap(old[:, None] + excl)
        new_val = self._wrap(old + total)
        new = AtomicVarState(official=new_val, cached=new_val.clone())
        ack = make_ack(new_val, "atomic", self.full_name, (self.host,),
                       self.dtype.itemsize * int(preds.shape[1]))
        return new, torch.where(preds, my_old, old[:, None]), ack
