"""Shared FIFO queue — LOCO §5.4 (a cyclic ring queue), the counterpart of
``repro/core/queue.py``.

All participants can push and pop; each pop corresponds to exactly one push.
``head``/``tail`` are uint32 atomic_vars hosted at participant 0; entries are
striped across participants' shared regions (global slot s lives at
participant s mod P, local row s div P).  Each slot stores (seq, payload),
the uint32 seq bit-cast into the payload's int32 lane, so a consumer can
verify the slot it claimed was produced by the matching enqueue ticket.

:meth:`SharedQueue.enqueue_window` / :meth:`dequeue_window` run a (P, B)
lane window of pushes/pops in one round-set: flow control and ticket issue
ride one ranked prefix scan over all P·B lanes in (participant, lane) order,
and slot traffic moves through the batched one-sided verbs with per-lane
``preds``.  :meth:`enqueue` / :meth:`dequeue` are the B=1 wrappers;
:meth:`_enqueue_reference` / :meth:`_dequeue_reference` are the scalar
paths on the atomic_vars' fetch-and-add and the region's scalar verbs, the
executable specification the B=1 windows are pinned against.  Payloads are
int32 (the reference's ``dtype`` knob waits for a channel that needs it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import colls
from .atomic import AtomicVar, AtomicVarState
from .channel import Channel
from .region import SharedRegion, SharedRegionState
from .runtime import Manager
from .u32 import MASK32, i2u, u2i

EMPTY_SEQ = 0xFFFFFFFF


class SharedQueueState(NamedTuple):
    head: AtomicVarState
    tail: AtomicVarState
    slots: SharedRegionState   # (n, slots, 1 + width): [seq bits, payload...]


class SharedQueue(Channel):
    def __init__(self, parent, name: str, mgr: Manager, *,
                 slots_per_node: int, width: int = 1, backend=None):
        super().__init__(parent, name, mgr)
        self.slots_per_node = int(slots_per_node)
        self.width = int(width)
        self.dtype = torch.int32
        self.capacity = self.slots_per_node * self.P
        self.head = AtomicVar(self, "head", mgr, host=0, dtype=torch.uint32)
        self.tail = AtomicVar(self, "tail", mgr, host=0, dtype=torch.uint32)
        self.region = SharedRegion(self, "entries", mgr,
                                   slots=self.slots_per_node,
                                   item_shape=(1 + self.width,),
                                   dtype=self.dtype,
                                   backend=backend)
        self.backend = self.region.backend

    @staticmethod
    def _to_lane(seq_u32):
        """Bit-preserving encode of uint32 seqs into the payload's int32
        lane."""
        return u2i(torch.as_tensor(seq_u32))

    @staticmethod
    def _from_lane(lane):
        return i2u(lane)

    def init_state(self) -> SharedQueueState:
        slots = self.region.init_state()
        buf = slots.buf.clone()
        buf[..., 0] = self._to_lane(EMPTY_SEQ)           # every slot empty
        return SharedQueueState(head=self.head.init_state(0),
                                tail=self.tail.init_state(0),
                                slots=slots._replace(buf=buf))

    def _slot_of(self, ticket):
        """uint32 tickets → (participant, local row) of their global slot
        ``ticket mod capacity`` (flow control guarantees the slot was
        consumed before reuse; the seq check guards ABA)."""
        t = (ticket & MASK32) % self.capacity
        return (t % self.P).to(torch.int32), (t // self.P).to(torch.int32)

    def enqueue_window(self, state: SharedQueueState, values, preds=None):
        """Push an (n, B) lane window of (n, B, width) values in one
        round-set.  Returns (state, grant (P, B)): lanes rank in
        (participant, lane) order and the ranks that fit the queue's space
        get tickets, so rejections are a suffix of that order."""
        values = torch.as_tensor(values, device=self.device).to(self.dtype)
        values = values.reshape(self.n_local, -1, self.width)
        want = torch.ones(values.shape[:2], dtype=torch.bool,
                          device=self.device) if preds is None else \
            torch.as_tensor(preds, device=self.device).reshape(values.shape[:2])
        head_now = colls.bcast_from(state.head.official, 0, self.rt)
        tail_now = colls.bcast_from(state.tail.official, 0, self.rt)
        rank, _total = colls.window_prefix(want.to(torch.int64), self.rt)
        space = self.capacity - u2i(tail_now - head_now).to(torch.int64)
        grant = want & (rank < space[:, None])
        tail_st, tickets, _ack = self.tail.fetch_add_window(state.tail, 1,
                                                            preds=grant)
        node, row = self._slot_of(tickets)
        entries = torch.cat([self._to_lane(tickets)[..., None], values],
                            dim=-1)
        slots, _ack2 = self.region.write_batch(state.slots, node, row,
                                               entries, preds=grant,
                                               assume_unique=True)
        return state._replace(tail=tail_st, slots=slots), grant

    def dequeue_window(self, state: SharedQueueState, preds):
        """Pop an (n, B) lane window in one round-set, FIFO in the same
        (participant, lane) ticket order.  Returns (state, values (n, B,
        width), ok (n, B)); values of failed lanes are zero."""
        want = torch.as_tensor(preds, device=self.device).reshape(
            self.n_local, -1)
        head_now = colls.bcast_from(state.head.official, 0, self.rt)
        tail_now = colls.bcast_from(state.tail.official, 0, self.rt)
        rank, _total = colls.window_prefix(want.to(torch.int64), self.rt)
        avail = u2i(tail_now - head_now).to(torch.int64)
        grant = want & (rank < avail[:, None])
        head_st, tickets, _ack = self.head.fetch_add_window(state.head, 1,
                                                            preds=grant)
        node, row = self._slot_of(tickets)
        entries, _ack2 = self.region.read_batch(state.slots, node, row,
                                                preds=grant)
        ok = grant & (self._from_lane(entries[..., 0]) == tickets)
        values = torch.where(ok[..., None], entries[..., 1:],
                             torch.zeros_like(entries[..., 1:]))
        # clear the consumed slots (ABA safety on wrap)
        empty = torch.zeros_like(entries)
        empty[..., 0] = self._to_lane(EMPTY_SEQ)
        slots, _ack3 = self.region.write_batch(state.slots, node, row, empty,
                                               preds=ok, assume_unique=True)
        return state._replace(head=head_st, slots=slots), values, ok

    def enqueue(self, state: SharedQueueState, value, want=True):
        """Push one (n, width) value per participant: the B=1 window.
        Returns (state, ok (n,))."""
        n = self.n_local
        new, grant = self.enqueue_window(
            state, torch.as_tensor(value).reshape(n, 1, self.width),
            torch.as_tensor(want).expand(n).reshape(n, 1))
        return new, grant[:, 0]

    def dequeue(self, state: SharedQueueState, want=True):
        """Pop one value per participant: the B=1 window.  Returns (state,
        value (n, width), ok (n,))."""
        n = self.n_local
        new, values, ok = self.dequeue_window(
            state, torch.as_tensor(want).expand(n).reshape(n, 1))
        return new, values[:, 0], ok[:, 0]

    def _flow(self, state: SharedQueueState, want):
        """Scalar flow control: (rank (n,), items (n,)) — each request's
        rank in participant order and the queue's item count tail − head."""
        head_now = colls.bcast_from(state.head.official, 0, self.rt)
        tail_now = colls.bcast_from(state.tail.official, 0, self.rt)
        rank, _total, _g = colls.prefix_sums(want.to(torch.int64), self.rt)
        return rank, u2i(tail_now - head_now).to(torch.int64)

    def _enqueue_reference(self, state: SharedQueueState, value, want=True):
        """The scalar enqueue — the executable specification the B=1 window
        is pinned against: the tail's fetch-and-add and one scalar
        one-sided write of (seq, payload).  value (n, width); want (n,).
        Returns (state, grant (n,))."""
        want = colls._per_participant(want, self.n_local, self.device,
                                      torch.bool)
        rank, used = self._flow(state, want)
        grant = want & (rank < self.capacity - used)
        tail_st, ticket, _ack = self.tail.fetch_add(state.tail, 1,
                                                    pred=grant)
        node, row = self._slot_of(ticket)
        entry = torch.cat([self._to_lane(ticket)[:, None],
                           torch.as_tensor(value, device=self.device)
                           .to(self.dtype).reshape(self.n_local,
                                                   self.width)], 1)
        slots, _ack2 = self.region.write(state.slots, node, row, entry,
                                         pred=grant)
        return state._replace(tail=tail_st, slots=slots), grant

    def _dequeue_reference(self, state: SharedQueueState, want=True):
        """The scalar dequeue — the executable specification: the head's
        fetch-and-add, one scalar one-sided read of the claimed slot (a
        non-granted lane costs nothing on the wire) and one write that
        clears it.  Returns (state, value (n, width), ok (n,)); a failed
        pop returns zeros."""
        want = colls._per_participant(want, self.n_local, self.device,
                                      torch.bool)
        rank, avail = self._flow(state, want)
        grant = want & (rank < avail)
        head_st, ticket, _ack = self.head.fetch_add(state.head, 1,
                                                    pred=grant)
        node, row = self._slot_of(ticket)
        entry, _ack2 = self.region.read(state.slots, node, row, pred=grant)
        ok = grant & (self._from_lane(entry[:, 0]) == ticket)
        value = torch.where(ok[:, None], entry[:, 1:],
                            torch.zeros_like(entry[:, 1:]))
        empty = torch.zeros_like(entry)
        empty[:, 0] = self._to_lane(EMPTY_SEQ)
        slots, _ack3 = self.region.write(state.slots, node, row, empty,
                                         pred=ok)
        return state._replace(head=head_st, slots=slots), value, ok


def queue_state_to_numpy(state: SharedQueueState) -> SharedQueueState:
    """The port's queue state with numpy leaves of the JAX state's dtypes
    (uint32 head/tail registers)."""
    from .kvstore import _leaf_out
    return SharedQueueState(
        head=AtomicVarState(*(_leaf_out(t) for t in state.head)),
        tail=AtomicVarState(*(_leaf_out(t) for t in state.tail)),
        slots=SharedRegionState(_leaf_out(state.slots.buf)))
