"""Ringbuffer channel — one-to-many broadcast (LOCO §5.4, after FaRM), the
counterpart of ``repro/core/ringbuffer.py``.

An array of slots owned by a single *producer*, cached at every consumer.
Each slot carries (seq, len, epoch, checksum) beside its payload, and the
checksum covers the payload **and** the metadata, so a torn or corrupted
length, sequence or epoch word never validates.  Consumers acknowledge
through an SST of read cursors, which the producer consults before it reuses
a slot (a slot is free once every *live* consumer's cursor has passed it).

Failure model (DESIGN.md §12): ownership is state (``owner``, changed by
:meth:`Ringbuffer.re_own` at failover), ``alive`` masks crashed participants
out of flow control, and every slot is stamped with the producer's epoch —
a consumer that passes ``expect_epoch`` consumes a valid slot of an older
epoch without delivering it (*fenced*).

Windowed rounds (DESIGN.md §9.2): :meth:`Ringbuffer.publish_window` moves up
to B messages in one round-set, granting the rank-prefix of enabled lanes
that fits the slowest live consumer's window; :meth:`Ringbuffer.recv_window`
drains up to B with one bulk checksum-validated read and one cursor ack.
``send``/``recv_one`` are the scalar paths.

Every method takes and returns tensors led by the participants held here
(``n_local``: P on the stacked binding, 1 on a rank of a process binding);
a scalar argument of the reference is an (n_local,) tensor (or a Python
scalar, the same at every participant).  The owner's push to all consumers
— the reference's ``colls.bcast_from`` of each published value — is the
backend's :meth:`~repro_torch.core.backends.CollsBackend.publish_hop`: the
owner's row on the one-sided and active-message backends (a gather between
ranks), one launch of a remote-copy kernel on ``pallas``.
:attr:`Ringbuffer.publishes` counts the hops.  Ledger rows that the stacked
binding files for every participant at once (the publish's bytes, the
corrupt and fenced tiers) are filed by the lead binding alone, from every
participant's counts (:meth:`~repro_torch.core.runtime.Runtime.lead_rows`),
so that rank 0's ledger is the cluster's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ack import ALL_PEERS, make_ack
from .backends import get_backend
from .channel import Channel
from .colls import put_rows
from .ownedvar import checksum
from .runtime import Manager
from .sst import SST, SSTState
from .u32 import MASK32, i2u, u2i

# sentinel for "never written" seq words and dead-consumer cursor masking
_U32_MAX = 0xFFFFFFFF


class RingbufferState(NamedTuple):
    payload: torch.Tensor  # (n, capacity, width) message words
    seq: torch.Tensor      # (n, capacity) uint32 slot sequence numbers
    length: torch.Tensor   # (n, capacity) int32 message lengths (words)
    epoch: torch.Tensor    # (n, capacity) uint32 producer epoch stamps
    csum: torch.Tensor     # (n, capacity) uint32 payload+metadata checksums
    head: torch.Tensor     # (n,) uint32 producer cursor (cached everywhere)
    owner: torch.Tensor    # (n,) int32 current producer
    alive: torch.Tensor    # (n, P) bool — crashed participants leave flow
    #                      # control
    acks: SSTState         # per-consumer read cursors


def _per_p(x, P, device, dtype=None):
    """A Python scalar or a (P,) tensor as a (P,) tensor (P the
    participants held here)."""
    t = torch.as_tensor(x, device=device)
    if dtype is not None:
        t = t.to(dtype)
    return t.expand(P)


def _lanes(x, P, B, device, dtype=None):
    """A scalar, a (P,) per-participant value or a (P, B) lane tensor as
    (P, B) — the stacked ``broadcast_to(x, (B,))``."""
    t = torch.as_tensor(x, device=device)
    if dtype is not None:
        t = t.to(dtype)
    if t.dim() == 1:
        t = t[:, None]
    return t.expand(P, B)


class Ringbuffer(Channel):
    """One-to-many broadcast ring initially owned by participant ``owner``."""

    def __init__(self, parent, name: str, mgr: Manager, *, owner: int,
                 capacity: int, width: int, dtype=torch.int32, backend=None):
        super().__init__(parent, name, mgr)
        if dtype.itemsize != 4:
            raise TypeError(f"ring slots hold 4-byte words, got {dtype}")
        self.owner = int(owner)          # initial owner; state is authoritative
        self.capacity = int(capacity)
        self.width = int(width)
        self.dtype = dtype
        self.backend = get_backend(backend, default=mgr.backend)
        self.acks = SST(self, "acks", mgr)
        self.declare_region("slots", (capacity, width), dtype)
        self.slot_nbytes = width * dtype.itemsize + 16
        #: publish hops run so far (each is one remote-copy launch on the
        #: ``pallas`` backend)
        self.publishes = 0
        # the hop's exchange windows between ranks (allocated at the first
        # hop on the card; stacked, the hop needs none)
        self.windows = None
        if not self.rt.stacked:
            from ..kernels.remote_dma import PeerWindows
            self.windows = PeerWindows(self.rt)

    def close(self):
        """Release the hop's exchange windows (every rank at the same
        point: the release waits for the peers' mappings to close)."""
        if self.windows is not None:
            self.windows.close()

    def init_state(self) -> RingbufferState:
        n, P, C, dev = self.n_local, self.P, self.capacity, self.device
        return RingbufferState(
            payload=torch.zeros((n, C, self.width), dtype=self.dtype,
                                device=dev),
            seq=torch.full((n, C), _U32_MAX, dtype=torch.int64, device=dev),
            length=torch.zeros((n, C), dtype=torch.int32, device=dev),
            epoch=torch.zeros((n, C), dtype=torch.int64, device=dev),
            csum=torch.zeros((n, C), dtype=torch.int64, device=dev),
            head=torch.zeros((n,), dtype=torch.int64, device=dev),
            owner=torch.full((n,), self.owner, dtype=torch.int32, device=dev),
            alive=torch.ones((n, P), dtype=torch.bool, device=dev),
            acks=self.acks.init_state())

    # -- slot integrity ---------------------------------------------------------
    def _slot_csum(self, msg, seq, length, epoch):
        """Checksum of each slot's payload AND metadata (seq, len, epoch):
        ``msg`` (..., width), the rest (...) → uint32 (...)."""
        msg = torch.as_tensor(msg, device=self.device).to(self.dtype)
        if msg.is_floating_point():
            lanes = i2u(msg.view(torch.int32))
        else:
            lanes = i2u(msg)
        shape = lanes.shape[:-1]
        meta = torch.stack([
            torch.as_tensor(seq, device=self.device).to(torch.int64)
            .expand(shape) & MASK32,
            i2u(torch.as_tensor(length, device=self.device).to(torch.int32)
                .expand(shape)),
            torch.as_tensor(epoch, device=self.device).to(torch.int64)
            .expand(shape) & MASK32], dim=-1)
        return checksum(torch.cat([lanes, meta], dim=-1))

    # -- flow control -----------------------------------------------------------
    def min_ack(self, state: RingbufferState):
        """Slowest LIVE consumer's cursor, (n,): crashed participants
        (masked in ``alive``) never wedge slot reuse."""
        cursors = self.acks.rows(state.acks)
        return torch.where(state.alive, cursors,
                           torch.full_like(cursors, _U32_MAX)).min(-1).values

    def can_send(self, state: RingbufferState):
        """Space check: head may lead the slowest live consumer by
        < capacity."""
        return ((state.head - self.min_ack(state)) & MASK32) < self.capacity

    def _hop(self, state, values):
        self.publishes += 1
        return self.backend.publish_hop(values, state.owner, rt=self.rt,
                                        windows=self.windows)

    def _record_lead(self, *entries):
        """File each (record, name, per-participant count) of ``entries``
        on the lead binding, every participant's rows, gathered in one
        collective (every rank calls this)."""
        rows = self.rt.lead_rows(*(count for _r, _n, count in entries))
        for (record, name, _c), row in zip(entries, rows or ()):
            record(name, row)

    # -- producer ------------------------------------------------------------
    def send(self, state: RingbufferState, msg, msg_len, pred=True,
             epoch=None):
        """Producer broadcasts ``msg`` ((n, width), ``msg_len`` valid words)
        stamped with ``epoch`` (default 0).  Returns (state, sent (n,),
        ack): ``sent`` is False where the caller is not the owner, ``pred``
        is False, or the ring is full."""
        n, dev = self.n_local, self.device
        loc, me = self.local_ids(), self.my_id()
        is_owner = me == state.owner
        do = _per_p(pred, n, dev, torch.bool) & is_owner & self.can_send(state)
        msg = torch.as_tensor(msg, device=dev).to(self.dtype) \
            .reshape(n, self.width)
        msg_len = _per_p(msg_len, n, dev, torch.int32)
        ep = _per_p(0 if epoch is None else epoch, n, dev,
                    torch.int64) & MASK32
        slot = state.head % self.capacity

        payload_row = torch.where(do[:, None], msg, state.payload[loc, slot])
        seq_v = torch.where(do, state.head, state.seq[loc, slot])
        len_v = torch.where(do, msg_len, state.length[loc, slot])
        ep_v = torch.where(do, ep, state.epoch[loc, slot])
        csum_v = torch.where(do, self._slot_csum(msg, state.head, msg_len,
                                                 ep), state.csum[loc, slot])
        head_v = torch.where(do, (state.head + 1) & MASK32, state.head)

        # one-sided push from the owner to all consumers
        sent_any = self.rt.world_any(do)
        payload_row, seq_v, len_v, ep_v, csum_v, head_b, slot_b = self._hop(
            state, [payload_row, seq_v, len_v, ep_v, csum_v, head_v, slot])
        keep = torch.ones((n, 1), dtype=torch.bool, device=dev)
        rows = slot_b[:, None]
        new = state._replace(
            payload=put_rows(state.payload, rows, payload_row[:, None],
                              keep),
            seq=put_rows(state.seq, rows, seq_v[:, None], keep),
            length=put_rows(state.length, rows, len_v[:, None], keep),
            epoch=put_rows(state.epoch, rows, ep_v[:, None], keep),
            csum=put_rows(state.csum, rows, csum_v[:, None], keep),
            head=head_b)
        ack = make_ack((payload_row, head_b), "bcast", self.full_name,
                       ALL_PEERS, self.slot_nbytes)
        return new, do & sent_any, ack

    def publish_window(self, state: RingbufferState, msgs, lens, preds=None,
                       epoch=None):
        """Owner broadcasts up to B messages in ONE round-set.

        msgs (n, B, width); lens (n, B) int32; preds (n, B) bool (default
        all enabled); epoch: a scalar, (n,) or (n, B) uint32 stamps (default
        0).  Returns (state, sent (n, B), ack): ``sent[p, b]`` is True (at
        the owner) iff lane b landed — flow control grants the longest
        rank-prefix of enabled lanes that fits the slowest live consumer's
        window.  Modeled wire bytes (verb ``<name>.publish``) scale with the
        slots moved, per the backend's publish contract."""
        n, dev = self.n_local, self.device
        msgs = torch.as_tensor(msgs, device=dev).to(self.dtype) \
            .reshape(n, -1, self.width)
        B = msgs.shape[1]
        if preds is None:
            preds = True
        me = self.my_id()
        is_owner = me == state.owner
        want = _lanes(preds, n, B, dev, torch.bool) & is_owner[:, None]
        lens = _lanes(lens, n, B, dev, torch.int32)
        eps = _lanes(0 if epoch is None else epoch, n, B, dev,
                     torch.int64) & MASK32
        space = self.capacity - u2i(
            (state.head - self.min_ack(state)) & MASK32).to(torch.int64)
        w = want.to(torch.int64)
        rank = w.cumsum(1) - w                        # owner-local lane rank
        grant = want & (rank < space[:, None])
        seqs = (state.head[:, None] + rank) & MASK32
        slots = seqs % self.capacity
        csums = self._slot_csum(msgs, seqs, lens, eps)
        n_moved = grant.sum(1)
        head_v = (state.head + n_moved) & MASK32

        # one push from the owner: the whole window's slots + new head
        sent_any = self.rt.world_any(grant)
        msgs_b, seqs_b, lens_b, eps_b, csums_b, head_b, slots_b, grant_b = \
            self._hop(state, [msgs, seqs, lens, eps, csums, head_v, slots,
                              grant])
        # granted lanes land in one scatter; rejected lanes are dropped
        new = state._replace(
            payload=put_rows(state.payload, slots_b, msgs_b, grant_b),
            seq=put_rows(state.seq, slots_b, seqs_b, grant_b),
            length=put_rows(state.length, slots_b, lens_b, grant_b),
            epoch=put_rows(state.epoch, slots_b, eps_b, grant_b),
            csum=put_rows(state.csum, slots_b, csums_b, grant_b),
            head=head_b)
        if self.mgr.traffic.enabled:
            self._record_lead((
                lambda verb, moved: self.backend.record_publish(
                    self.mgr.traffic, verb, self.slot_nbytes, moved),
                f"{self.full_name}.publish", n_moved))
        ack = make_ack((msgs_b, head_b), "bcast", self.full_name,
                       ALL_PEERS, self.slot_nbytes * B)
        return new, grant & sent_any[:, None], ack

    # -- failover takeover (DESIGN.md §12.2) ----------------------------------
    def re_own(self, state: RingbufferState, new_owner, alive, head):
        """``new_owner`` claims the ring at cursor ``head`` and the crashed
        participants in ``~alive`` ((n, P)) leave flow control.  Every
        slot's seq is poisoned and its checksum zeroed, so nothing the
        previous owner published validates until the new owner re-publishes
        it; the epoch stamps and the consumer cursors are kept (the
        fence-head rule of §13.2 reads the stamps)."""
        n, P, C, dev = self.n_local, self.P, self.capacity, self.device
        return state._replace(
            seq=torch.full((n, C), _U32_MAX, dtype=torch.int64, device=dev),
            csum=torch.zeros((n, C), dtype=torch.int64, device=dev),
            head=_per_p(head, n, dev, torch.int64) & MASK32,
            owner=_per_p(new_owner, n, dev, torch.int32).clone(),
            alive=torch.as_tensor(alive, device=dev).to(torch.bool)
            .reshape(n, P).clone())

    # -- consumer -------------------------------------------------------------
    def recv_one(self, state: RingbufferState, pred=True):
        """Consume the next unread message if available (and ``pred``).
        Returns (state, msg (n, width), msg_len (n,), got (n,)).  Validates
        seq (staleness) and checksum (tearing, counted in the ledger's
        corrupt tier); a failed validation does not advance the cursor.
        The advanced cursor is acknowledged through the SST."""
        n, dev = self.n_local, self.device
        loc, me = self.local_ids(), self.my_id()
        my_ack = self.acks.rows(state.acks)[loc, me]
        have = _per_p(pred, n, dev, torch.bool) & (my_ack < state.head)
        slot = my_ack % self.capacity
        msg = state.payload[loc, slot]
        seq_ok = state.seq[loc, slot] == my_ack
        ok = seq_ok & (self._slot_csum(msg, state.seq[loc, slot],
                                       state.length[loc, slot],
                                       state.epoch[loc, slot])
                       == state.csum[loc, slot])
        if self.mgr.traffic.enabled:
            self._record_lead((self.mgr.traffic.record_corrupt,
                               self.full_name, have & seq_ok & ~ok))
        got = have & ok
        new_ack = torch.where(got, (my_ack + 1) & MASK32, my_ack)
        acks = self.acks.store_mine(state.acks, new_ack)
        acks, _a = self.acks.push_broadcast(acks)
        msg = torch.where(got[:, None], msg, torch.zeros_like(msg))
        msg_len = torch.where(got, state.length[loc, slot],
                              torch.zeros_like(state.length[loc, slot]))
        return state._replace(acks=acks), msg, msg_len, got

    def recv_window(self, state: RingbufferState, window: int, pred=True,
                    expect_epoch=None):
        """Drain up to ``window`` messages in ONE round-set.

        Returns (state, msgs (n, window, width), lens (n, window), got
        (n, window), fenced (n, window)).  One bulk checksum-validated read
        serves the window and one SST push acknowledges it.  Delivery is a
        contiguous prefix: the cursor stalls at the first slot that fails
        integrity validation.  With ``expect_epoch`` ((n,) or a scalar), a
        valid slot stamped with an older epoch is fenced: consumed, not
        delivered, counted in the ledger's fenced tier."""
        n, dev = self.n_local, self.device
        loc, me = self.local_ids(), self.my_id()
        my_ack = self.acks.rows(state.acks)[loc, me]
        k = torch.arange(window, dtype=torch.int64, device=dev)
        seqs = (my_ack[:, None] + k) & MASK32
        slots = seqs % self.capacity
        rows = state.payload[loc[:, None], slots]         # (n, window, width)
        seq_at = state.seq[loc[:, None], slots]
        len_at = state.length[loc[:, None], slots]
        ep_at = state.epoch[loc[:, None], slots]
        seq_ok = seq_at == seqs
        valid = seq_ok & (self._slot_csum(rows, seq_at, len_at, ep_at)
                          == state.csum[loc[:, None], slots])
        avail = (state.head - my_ack) & MASK32
        pred = _lanes(pred, n, window, dev, torch.bool)
        in_range = pred & (k[None, :] < avail[:, None])
        good = in_range & valid
        # contiguous prefix: a lane is consumed iff no earlier lane failed
        bad = (~good).to(torch.int64)
        consumed = good & ((bad.cumsum(1) - bad) == 0)
        if expect_epoch is None:
            fenced = torch.zeros_like(consumed)
        else:
            exp = _per_p(expect_epoch, n, dev, torch.int64) & MASK32
            fenced = consumed & (ep_at < exp[:, None])
        if self.mgr.traffic.enabled:
            tiers = [(self.mgr.traffic.record_corrupt, self.full_name,
                      (in_range & seq_ok & ~valid).sum(1))]
            if expect_epoch is not None:
                tiers.append((self.mgr.traffic.record_fenced,
                              self.full_name, fenced.sum(1)))
            self._record_lead(*tiers)
        got = consumed & ~fenced
        n_consumed = consumed.sum(1)
        msgs = torch.where(got[..., None], rows, torch.zeros_like(rows))
        lens = torch.where(got, len_at, torch.zeros_like(len_at))
        acks = self.acks.store_mine(state.acks,
                                    (my_ack + n_consumed) & MASK32)
        acks, _a = self.acks.push_broadcast(acks)
        return state._replace(acks=acks), msgs, lens, got, fenced
