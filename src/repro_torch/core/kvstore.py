"""KVStore channel — the paper's linearizable key-value store (§6, App. C),
the counterpart of ``repro/core/kvstore.py``.

Composition, as in the reference: values and their consistency metadata live
in a :class:`SharedRegion` striped across participants, each row
``[payload | counter | valid | checksum]``; every participant keeps a local
open-addressing hash index key → (node, slot, counter) in device memory;
insertions, deletions and updates take ticket locks ``key % NUM_LOCKS``;
index updates travel as tracker records applied by every participant and
acknowledged through an SST; lookups take no locks and validate the row they
read by checksum, counter and valid bit.

:meth:`KVStore.op_window` runs a ``(P, B)`` window of mixed
NOP/GET/INSERT/UPDATE/DELETE lanes in one round-set: GETs linearize at the
window start; mutations linearize in per-lock FIFO order, which is
(participant, window slot) lexicographic; each service round serves every
lock queue's longest conflict-free prefix, so the round count is the
per-lock conflict depth.

The port covers the scheduled implementation whole: the locked window path;
the lock-free fast path (``lockfree=True``, DESIGN.md §11: a window whose
lock-wanting lanes are all UPDATEs is served by one counter-validated
batched write, with no lock, tracker or ack round, and any other window falls
back to the locked schedule); the read tier (``cache_slots > 0``, §8: a
counter-validated cache of remote rows in front of the coalesced read, kept
coherent by invalidations that ride the tracker records); the placement
policies (``placement="local" | "hashed" | "explicit"``, §10.1: non-local
INSERTs allocate at their home through the placed service round's
request/grant round-trip); and the locality migration (§10.2–§10.3): MOVE
lanes (``migrate_window``), read-heat tracking (``track_heat=True``) and
``rebalance``.  It covers the executable specifications too:
``reference_impl=True`` builds a store on the O(C) flat-scan index and the
sequential tracker sweep whose windows serve one ticket per lock a round
(the holds test, released every round), ``_op_round_reference`` is the
scalar round built on the scalar verbs, and ``_migrate_reference`` runs a
migration window one lane at a time.
Every tensor leads with the participants held here: all P on the stacked
binding, one on a rank of the process binding (:mod:`.runtime`).  Where
every participant computes the same quantity from gathered data — the
schedule masks, the tracker records' order, the rebalance proposals — it is
computed once from the gathered window (the stacked tensors themselves, or
an all-gather between ranks) and each participant keeps its own rows.  The
reference's data-dependent ``lax.while_loop``s (service rounds, tracker
waves, GET retries, the all-hit skip of the cached read, the lock-free
gates) become Python loops or branches keyed on world-uniform host reads
(``Runtime.any``), so every rank takes the same number of iterations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import colls
from .ack import AckKey, join
from .backends import get_backend
from .cache import ReadCache, ReadCacheState, hash_u32
from .channel import Channel
from .hottracker import HotTracker, HotTrackerState
from .lock import TicketLockArray, TicketLockArrayState
from .ownedvar import checksum
from .region import SharedRegion, SharedRegionState
from .runtime import Manager, resolve_device
from .sst import SST, SSTState
from .u32 import MASK32, as_u32, i2u, u2i

# op codes (MOVE re-homes a live row — the §10 migration lane)
NOP, GET, INSERT, UPDATE, DELETE, MOVE = 0, 1, 2, 3, 4, 5

# placement policies (DESIGN.md §10.1): who hosts an INSERTed row
PLACEMENTS = ("local", "hashed", "explicit")

# local-index slot states (DESIGN.md §7) and the (C, 5) int32 index row
# [state | key_bits | node | slot | ctr_bits]
_EMPTY, _USED, _TOMB = 0, 1, 2
IDX_STATE, IDX_KEY, IDX_NODE, IDX_SLOT, IDX_CTR = range(5)
MAX_GET_RETRIES = 3
DEFAULT_MAX_PROBE = 32


class KVResult(NamedTuple):
    value: torch.Tensor    # (n, B, W) int32 payload (zeros when not found)
    found: torch.Tensor    # (n, B) bool — GET: key present; mods: succeeded
    retries: torch.Tensor  # (n, B) int32 — GET checksum retries (0 clean)


class KVStoreState(NamedTuple):
    # n = the participants held here: P stacked, 1 a rank
    locks: TicketLockArrayState
    rows: SharedRegionState    # (n, S, W+3) int32: payload|ctr|valid|csum
    slot_ctr: torch.Tensor     # (n, S) uint32 — per-slot reuse counters
    free_stack: torch.Tensor   # (n, S) int32 — host-local free slots
    free_top: torch.Tensor     # (n,) int32
    idx: torch.Tensor          # (n, C, 5) int32 local hash index
    idx_overflow: torch.Tensor  # (n,) bool — a probe window ran out of space
    acks: SSTState             # tracker ack counters
    cache: ReadCacheState      # read tier (zero-line when cache_slots == 0)
    heat: HotTrackerState      # read-heat tier (zero-row when untracked)


def _first_true(mask):
    """Index of the first True along the last dimension (0 if none)."""
    return mask.to(torch.uint8).argmax(-1)


def _tensor(x, dtype, device):
    """A tensor, array or nested list as a ``dtype`` tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def _take(t, i):
    """``t[..., i[...]]`` along the last dimension."""
    return t.gather(-1, i[..., None])[..., 0]


def _refresh_look(recs, applied, key, look):
    """A service round's per-lane index view, refreshed from the round's
    applied tracker records: an applied insert or move re-points its key, an
    applied delete clears it (each live key is in at most one record per
    round)."""
    found, node, slot, ctr = look
    rec_key = i2u(recs[:, 1])
    same = rec_key[None, None, :] == key[:, :, None]             # (P, B, N)
    put = (recs[:, 0] == 1) | (recs[:, 0] == 3)
    m_put = (applied & put)[:, None, :] & same
    hit_put = m_put.any(2)
    hit_del = ((applied & (recs[:, 0] == 2))[:, None, :] & same).any(2)
    r = recs[_first_true(m_put)]                                 # (P, B, 5)
    return (hit_put | (found & ~hit_del),
            torch.where(hit_put, r[..., 2], node),
            torch.where(hit_put, r[..., 3], slot),
            torch.where(hit_put, i2u(r[..., 4]), ctr))


class KVStore(Channel):
    def __init__(self, parent, name: str, mgr: Manager, *,
                 slots_per_node: int, value_width: int = 2,
                 num_locks: int = 8, index_capacity: int | None = None,
                 index_max_probe: int | None = None,
                 cache_slots: int = 0, coalesce_reads: bool = True,
                 placement: str = "local", track_heat: bool = False,
                 heat_decay: float = 0.9, lockfree: bool = False,
                 reference_impl: bool = False, backend=None):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {placement!r}")
        if lockfree and reference_impl:
            raise ValueError("lockfree=True requires the scheduled "
                             "implementation (reference_impl=False)")
        super().__init__(parent, name, mgr)
        self.backend = get_backend(backend, default=mgr.backend)
        self.S = int(slots_per_node)
        self.W = int(value_width)
        self.L = int(num_locks)
        self.C = int(index_capacity or (self.S * self.P * 2))
        self.PROBE = min(self.C, int(index_max_probe or DEFAULT_MAX_PROBE))
        # op_window's default: the §11 lock-free commuting fast path
        self.lockfree = bool(lockfree)
        # the executable specification: O(C) flat-scan index, sequential
        # tracker sweep, one ticket served per lock a round
        self.reference_impl = bool(reference_impl)
        self.coalesce_reads = bool(coalesce_reads)
        self.placement = placement
        self.cache = ReadCache(self, "readcache", mgr, lines=cache_slots,
                               row_width=self.W + 3,
                               backing_slots=self.S) if cache_slots else None
        # the GET paths feed the heat channel rebalance() reads (§10.3)
        self.hot = HotTracker(self, "heat", mgr, nodes=self.P, slots=self.S,
                              decay=heat_decay) if track_heat else None
        self.locks = TicketLockArray(self, "locks", mgr, num_locks=self.L)
        self.rows_region = SharedRegion(self, "data", mgr, slots=self.S,
                                        item_shape=(self.W + 3,),
                                        dtype=torch.int32,
                                        backend=self.backend)
        self.acks = SST(self, "tracker_acks", mgr)
        # the local index is private memory, accounted like a process heap
        self.declare_region("index", (self.C, 5), torch.int32)

    # -- row encoding ------------------------------------------------------------
    def encode_row(self, payload, ctr, valid):
        """(..., W) int32 payload, (...) uint32 ctr, valid → (..., W+3)
        int32 rows ``[payload | ctr | valid | checksum]``."""
        ctr = torch.as_tensor(ctr, device=self.device)
        valid = torch.as_tensor(valid, device=self.device).expand(ctr.shape)
        body = torch.cat([torch.as_tensor(payload, device=self.device)
                          .to(torch.int32).reshape(ctr.shape + (self.W,)),
                          u2i(ctr)[..., None],
                          valid.to(torch.int32)[..., None]], dim=-1)
        return torch.cat([body, u2i(checksum(body))[..., None]], dim=-1)

    def decode_row(self, row):
        """(..., W+3) rows → (payload, ctr, valid, checksum_ok)."""
        payload = row[..., :self.W]
        ctr = i2u(row[..., self.W])
        valid = row[..., self.W + 1] != 0
        csum_ok = checksum(row[..., :self.W + 2]) == i2u(row[..., self.W + 2])
        return payload, ctr, valid, csum_ok

    # -- state ----------------------------------------------------------------
    def init_state(self, device=None) -> KVStoreState:
        """A fresh state of the participants held here on the store's
        device, or on ``device`` (the meta device gives its shapes without
        allocating)."""
        n = self.n_local
        dev = self.device if device is None else device
        return KVStoreState(
            locks=self.locks.init_state(device),
            rows=self.rows_region.init_state(device),
            slot_ctr=torch.zeros((n, self.S), dtype=torch.int64, device=dev),
            free_stack=torch.arange(self.S, dtype=torch.int32, device=dev)
            .expand(n, self.S).clone(),
            free_top=torch.full((n,), self.S, dtype=torch.int32, device=dev),
            idx=torch.zeros((n, self.C, 5), dtype=torch.int32, device=dev),
            idx_overflow=torch.zeros((n,), dtype=torch.bool, device=dev),
            acks=self.acks.init_state(device=device),
            cache=(self.cache.init_state(device) if self.cache is not None
                   else ReadCache.empty_state(n, self.W + 3, dev)),
            heat=(self.hot.init_state(device) if self.hot is not None
                  else HotTracker.empty_state(n, dev)))

    def _lanes_in(self, ops, keys, values=None):
        """Caller's (n, B) window → device tensors of the store's types."""
        ops = _tensor(ops, torch.int32, self.device)
        B = ops.shape[1]
        keys = as_u32(keys, self.device).reshape(self.n_local, B)
        if values is None:
            return ops, keys
        values = _tensor(values, torch.int32, self.device)
        return ops, keys, values.reshape(self.n_local, B, self.W)

    # -- local index (open-addressing hash table, DESIGN.md §7) ------------------
    def _probe_window(self, key):
        """Probe positions for ``key`` (any shape): the PROBE-length linear
        window starting at ``hash(key) % C``, wrapping.  (..., PROBE)."""
        h = hash_u32(key) % self.C
        return (h[..., None] + torch.arange(self.PROBE, device=key.device)) \
            % self.C

    def _probe(self, idx, keys):
        """One bounded linear-probe pass for (n, B) ``keys`` over each
        participant's (C, 5) index → (has_match, match_pos, has_free,
        free_pos), each (n, B).

        A *match* is a USED position holding the key with no EMPTY position
        before it in the window (tombstones do not end a chain); a *free*
        position is EMPTY or tombstone, and an insert takes the first one."""
        pos_w = self._probe_window(keys)                         # (n, B, PROBE)
        homes = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        w = idx[homes, pos_w]                                    # (n, B, PROBE, 5)
        states = w[..., IDX_STATE]
        emp = (states == _EMPTY).to(torch.int64)
        before_empty = (emp.cumsum(-1) - emp) == 0
        match = before_empty & (states == _USED) \
            & (w[..., IDX_KEY] == u2i(keys)[..., None])
        free = (states == _EMPTY) | (states == _TOMB)
        return (match.any(-1), _take(pos_w, _first_true(match)),
                free.any(-1), _take(pos_w, _first_true(free)))

    def _index_lookup(self, st: KVStoreState, keys):
        """(n, B) keys → (found, pos, node, slot, ctr); the O(PROBE) hash
        probe, or the O(C) flat scan on a reference-impl store.  A missing
        key reports position 0 in both, as argmax over all-False does."""
        if self.reference_impl:
            return self._index_lookup_reference(st, keys)
        return self._index_lookup_hash(st, keys)

    def _index_row(self, st: KVStoreState, found, pos):
        pos = torch.where(found, pos, torch.zeros_like(pos))
        homes = torch.arange(pos.shape[0], device=pos.device)[:, None]
        row = st.idx[homes, pos]                                 # (n, B, 5)
        return (found, pos, row[..., IDX_NODE], row[..., IDX_SLOT],
                i2u(row[..., IDX_CTR]))

    def _index_lookup_hash(self, st: KVStoreState, keys):
        found, mpos, _hf, _fp = self._probe(st.idx, keys)
        return self._index_row(st, found, mpos)

    def _index_lookup_reference(self, st: KVStoreState, keys):
        """The flat associative scan — O(C) per key, the executable
        specification the hash probe is pinned against: the first USED
        position holding the key."""
        match = (st.idx[:, None, :, IDX_STATE] == _USED) \
            & (st.idx[:, None, :, IDX_KEY] == u2i(keys)[..., None])  # (n,B,C)
        return self._index_row(st, match.any(-1), _first_true(match))

    # -- lock-free GET (paper Fig. 3 read path) -------------------------------------
    def _get(self, st: KVStoreState, key, pred):
        """The scalar read path — part of the ``_op_round_reference`` spec:
        key, pred (n,) → (value (n, W), found (n,), tries).  Each live lane
        reads its row with the scalar one-sided verb, re-read while any lane
        anywhere read a torn row (at most :data:`MAX_GET_RETRIES` times).  A
        cache-enabled store routes it through the read tier as a window of
        one (its refills are dropped: this path returns no state)."""
        key = as_u32(key, self.device).reshape(self.n_local, 1)
        pred = torch.as_tensor(pred, device=self.device).expand(self.n_local)
        if self.cache is not None:
            values, found, tries, _st = self._get_window(st, key,
                                                         pred[:, None])
            return values[:, 0], found[:, 0], tries
        found_idx, _pos, node, slot, ctr = (
            x[:, 0] for x in self._index_lookup(st, key))
        live = pred & found_idx

        def read_once():
            row = self.backend.read(st.rows.buf, node, slot, pred=live,
                                    ledger=self.mgr.traffic,
                                    verb=f"{self.full_name}.get", rt=self.rt)
            return self.decode_row(row)

        payload, row_ctr, valid, csum_ok = read_once()
        tries = 0
        while tries < MAX_GET_RETRIES and self.rt.any(live & ~csum_ok):
            payload, row_ctr, valid, csum_ok = read_once()
            tries += 1
        # the Appendix C case analysis
        found = live & csum_ok & (row_ctr == ctr) & valid
        value = torch.where(found[:, None], payload,
                            torch.zeros_like(payload))
        return value, found, tries

    def _get_window(self, st: KVStoreState, keys, pred, look=None):
        """(n, B) lock-free GETs through the read tier → (values (n, B, W),
        found (n, B), tries, state).  The returned state carries this
        window's heat observations on a heat-tracked store and its refills
        on a cached one, and nothing else."""
        if look is None:
            found_idx, _pos, node, slot, ctr = self._index_lookup(st, keys)
            look = (found_idx, node, slot, ctr)
        if self.hot is not None:
            st = st._replace(heat=self.hot.observe(
                st.heat, look[1], look[2], pred & look[0]))
        if self.cache is None:
            values, found, tries = self._get_window_reference(st, keys, pred,
                                                              look)
            return values, found, tries, st
        values, found, tries, cache = self._get_window_cached(st, keys, pred,
                                                              look)
        return values, found, tries, st._replace(cache=cache)

    def _get_window_reference(self, st: KVStoreState, keys, pred, look):
        """The uncached read path (Fig. 3 / §7): every live GET lane pays the
        one-sided read, the Appendix C case analysis is applied per lane, and
        the whole window re-reads while any lane anywhere read a torn row
        (at most :data:`MAX_GET_RETRIES` times).  ``look`` is the lanes'
        (found, node, slot, ctr) index view.  Returns (values, found,
        tries)."""
        found_idx, node, slot, ctr = look
        live = pred & found_idx

        def read_all():
            rows = self.backend.read_batch(
                st.rows.buf, node.to(torch.int32), slot.to(torch.int32),
                preds=live, ledger=self.mgr.traffic,
                verb=f"{self.full_name}.get_batch",
                coalesce=self.coalesce_reads, rt=self.rt)        # (n, B, W+3)
            return self.decode_row(rows)

        payload, row_ctr, valid, csum_ok = read_all()
        tries = 0
        while tries < MAX_GET_RETRIES and self.rt.any(live & ~csum_ok):
            payload, row_ctr, valid, csum_ok = read_all()
            tries += 1
        found = live & csum_ok & (row_ctr == ctr) & valid
        values = torch.where(found[..., None], payload,
                             torch.zeros_like(payload))
        return values, found, tries

    def _get_window_cached(self, st: KVStoreState, keys, pred, look):
        """The cached read path (DESIGN.md §8.2).  A remote lane whose
        (node, slot) tag-matches a line whose row re-validates — checksum
        clean, valid bit set, row counter equal to the index's — is served
        from local memory at zero modeled wire bytes.  Miss lanes take the
        coalesced one-sided read and refill their lines with the rows they
        accept (no negative caching); the fetch retries while any lane
        anywhere read a torn row.  A window with no miss anywhere issues no
        read at all — the reference's zero-iteration loop, one host read
        here.  Returns (values, found, tries, cache)."""
        P, B = keys.shape
        me = self.my_id()[:, None]
        found_idx, node, slot, ctr = look
        node = node.to(torch.int32)
        slot = slot.to(torch.int32)
        live = pred & found_idx
        remote = live & (node != me)
        crows, tag_hit = self.cache.lookup(st.cache, node, slot)
        cpay, cctr, cvalid, cok = self.decode_row(crows)
        hit = remote & tag_hit & cok & (cctr == ctr) & cvalid
        miss = live & ~hit
        cache = st.cache
        payload = torch.zeros((P, B, self.W), dtype=torch.int32,
                              device=keys.device)
        row_ctr = torch.zeros((P, B), dtype=torch.int64, device=keys.device)
        valid = torch.zeros_like(miss)
        csum_ok = ~miss
        rounds = 0
        while rounds < 1 + MAX_GET_RETRIES and self.rt.any(miss & ~csum_ok):
            rows = self.backend.read_batch(
                st.rows.buf, node, slot, preds=miss, ledger=self.mgr.traffic,
                verb=f"{self.full_name}.get_batch",
                coalesce=self.coalesce_reads, rt=self.rt)        # (n, B, W+3)
            payload, row_ctr, valid, ok = self.decode_row(rows)
            acc = miss & ok & (row_ctr == ctr) & valid & (node != me)
            cache = self.cache.fill(cache, node, slot, rows, acc)
            csum_ok = ok | ~miss
            rounds += 1
        found_miss = miss & csum_ok & (row_ctr == ctr) & valid
        found = hit | found_miss
        zero = torch.zeros_like(payload)
        values = torch.where(hit[..., None], cpay,
                             torch.where(found_miss[..., None], payload, zero))
        if self.mgr.traffic.enabled:
            self.mgr.traffic.record_cache(f"{self.full_name}.readcache",
                                          hit.sum(1), remote.sum(1))
        return values, found, max(rounds - 1, 0), cache

    # -- tracker application ----------------------------------------------------------
    def _apply_tracker(self, st: KVStoreState, recs):
        """Apply the gathered (N, 5) tracker records at every participant:
        the wave scheduler, or the sequential sweep on a reference-impl
        store (each pairs its own index placement with its own lookup).
        Returns (state, applied (n, N))."""
        if self.reference_impl:
            return self._apply_tracker_reference(st, recs)
        return self._apply_tracker_vectorized(st, recs)

    def _apply_tracker_reference(self, st: KVStoreState, recs):
        """The sequential sweep — the executable specification.  The live
        records go first in their order (the reference's stable live-first
        partition) and apply one at a time at every participant at once:
        an insert takes the first EMPTY position anywhere (O(C)), a delete
        clears its entry back to EMPTY (the flat scan needs no tombstones)
        and the hosting node frees the slot, a MOVE re-points its entry in
        place while the old host frees the vacated slot, bumps its reuse
        counter and forgets its heat.  The records are the same at every
        participant, so they are read to the host once and the sweep takes
        one step per live record."""
        N, S = recs.shape[0], self.S
        dev = recs.device
        ar, me = self.local_ids(), self.my_id()
        applied = torch.zeros((self.n_local, N), dtype=torch.bool,
                              device=dev)
        idx, free_stack = st.idx.clone(), st.free_stack.clone()
        free_top, slot_ctr = st.free_top, st.slot_ctr
        overflow, heat = st.idx_overflow, st.heat
        for n, (kind, key_b, node, slot, ctr_b) in enumerate(
                recs.cpu().tolist()):
            if kind not in (1, 2, 3):
                continue
            state, keys = idx[..., IDX_STATE], idx[..., IDX_KEY]
            if kind == 1:
                free = state == _EMPTY                              # (n, C)
                do = free.any(1)
                overflow = overflow | ~do
                pos = _first_true(free)
            else:
                match = (state == _USED) & (keys == key_b)
                do = match.any(1)
                pos = _first_true(match)
            old = idx[ar, pos]                                      # (n, 5)
            new = torch.tensor([_USED, key_b, node, slot, ctr_b],
                               dtype=torch.int32,
                               device=dev).expand(self.n_local, 5)
            if kind == 2:
                new = torch.cat([torch.zeros_like(old[:, :2]), old[:, 2:]], 1)
            idx[ar, pos] = torch.where(do[:, None], new, old)
            # slot GC at the hosting node; a MOVE frees the vacated slot
            if kind == 3:
                gone_node, gone_slot = old[:, IDX_NODE], old[:, IDX_SLOT]
            else:
                gone_node = torch.full_like(old[:, 0], node)
                gone_slot = torch.full_like(old[:, 0], slot)
            frees = do & (gone_node == me) if kind != 1 \
                else torch.zeros_like(do)
            top = free_top.long().clamp(0, S - 1)
            free_stack[ar, top] = torch.where(frees, gone_slot,
                                              free_stack[ar, top])
            free_top = torch.where(frees, free_top + 1, free_top)
            if kind == 3:
                slot_ctr = colls.put_rows(
                    slot_ctr, gone_slot[:, None].clamp(0, S - 1), 1,
                    (frees & (gone_slot >= 0) & (gone_slot < S))[:, None],
                    accumulate=True) & MASK32
            if self.hot is not None and kind != 1:
                heat = self.hot.forget(heat, gone_node[:, None],
                                       gone_slot[:, None], do[:, None])
            applied[:, n] = do
        return st._replace(idx=idx, free_stack=free_stack,
                           free_top=free_top.to(torch.int32),
                           slot_ctr=slot_ctr, idx_overflow=overflow,
                           heat=heat), applied

    def _apply_tracker_vectorized(self, st: KVStoreState, recs):
        """Apply the gathered (N, 5) tracker records in record order at every
        participant: rec = [kind (0/1=ins/2=del/3=move), key_bits, node,
        slot, ctr_bits], participant-major, so record order IS
        participant-then-window order.  Returns (state, applied (n, N)).

        Wave-scheduled as in the reference: per wave, a record is eligible
        when no earlier record of its key is still pending (and no blocked
        record precedes it); eligible deletes hit distinct USED positions,
        eligible inserts race for free positions with the earliest record
        winning, and the losers retry next wave against the updated table.
        Each wave's winners touch distinct positions and commit in one row
        scatter.  The records are the same at every participant, so their
        order and same-key precedence are computed once, by one stable sort
        — no (N, N) mask.  The waves run while any participant has a pending
        record; a participant with none is left as it is (nothing is
        eligible, so nothing is written or retired), which is what the
        reference's per-participant loop does for it.  That test is
        world-uniform, so every rank runs as many waves."""
        n, N = self.n_local, recs.shape[0]
        dev = recs.device
        me = self.my_id()[:, None]
        kind, key_b, node, slot, ctr_b = recs.unbind(1)
        key = i2u(key_b)
        live = kind != 0
        is_ins, is_del, is_mov = kind == 1, kind == 2, kind == 3
        is_put = is_ins | is_mov      # records that place a [USED|key|...] row
        applied = torch.zeros((n, N), dtype=torch.bool, device=dev)
        if not bool(live.any()):
            # a dead round (UPDATE/GET only): no wave, and every commit
            # below would be a no-op
            return st, applied
        pending = live[None].expand(n, N).clone()
        pos_w = self._probe_window(key)[None].expand(n, N, self.PROBE)
        homes = torch.arange(n, device=dev)[:, None, None]
        # inserts and move-reinserts place [USED|key|node|slot|ctr] (the
        # record's new location), deletes [TOMB|0|node|slot|ctr]
        upd = torch.stack(
            [torch.where(is_put, _USED, _TOMB).to(torch.int32),
             torch.where(is_put, key_b, torch.zeros_like(key_b)), node, slot,
             ctr_b], dim=-1)
        key_seg = colls.segments(key)
        idx = st.idx.clone()          # the waves commit into this copy
        old_node = torch.zeros((n, N), dtype=torch.int32, device=dev)
        old_slot = torch.zeros((n, N), dtype=torch.int32, device=dev)
        while self.rt.any(pending):
            blocked = colls.count_before_same(key_seg, pending) > 0
            elig = pending & ~blocked & ~colls.exclusive_any(blocked)
            w = idx[homes, pos_w]                                # (n, N, PROBE, 5)
            states = w[..., IDX_STATE]
            emp = (states == _EMPTY).to(torch.int64)
            before_empty = (emp.cumsum(-1) - emp) == 0
            m = before_empty & (states == _USED) \
                & (w[..., IDX_KEY] == key_b[None, :, None])
            free = (states == _EMPTY) | (states == _TOMB)
            am = _first_true(m)
            mpos = _take(pos_w, am)
            fpos = _take(pos_w, _first_true(free))
            # a MOVE reinserts at its first free-or-own position
            fpos_m = _take(pos_w, _first_true(free | m))
            tgt = torch.where(is_ins, fpos, torch.where(is_mov, fpos_m, mpos))
            valid_tgt = torch.where(is_ins, free.any(-1), m.any(-1))
            cand = elig & valid_tgt
            # placement races: the earliest candidate wins, losers retry
            lost = is_put & (colls.count_before_same(
                colls.segments(tgt), cand & is_put) > 0)
            win = cand & ~lost
            fail = elig & ~valid_tgt \
                & (is_del | is_mov | ~colls.exclusive_any(pending))
            mrow = w.gather(2, am[..., None, None].expand(n, N, 1, 5))[:, :, 0]
            mwin = win & is_mov
            old_node = torch.where(mwin, mrow[..., IDX_NODE], old_node)
            old_slot = torch.where(mwin, mrow[..., IDX_SLOT], old_slot)
            # movers' tombstones first, then everyone's committed rows (a
            # mover landing in place is tombstoned, then overwritten)
            tomb = torch.stack(
                [torch.full_like(mrow[..., 0], _TOMB),
                 torch.zeros_like(mrow[..., 0]), mrow[..., IDX_NODE],
                 mrow[..., IDX_SLOT], mrow[..., IDX_CTR]], dim=-1)
            colls.put_rows_(idx, mpos, tomb, mwin)
            colls.put_rows_(idx, tgt, upd, win)
            pending = pending & ~(win | fail)
            applied = applied | win

        # ---- post-loop commits: slot GC at the hosting node, in record
        # order (deletes free the record's slot, moves the vacated one)
        host_free = applied & ((is_del & (node == me))
                               | (is_mov & (old_node == me)))
        gc_slot = torch.where(is_mov, old_slot, slot)
        hf = host_free.to(torch.int64)
        back = (st.free_top[:, None] + hf.cumsum(1) - hf).clamp(0, self.S - 1)
        # §10.2 self-invalidation: the old home bumps the vacated slot's
        # reuse counter
        bump = applied & is_mov & (old_node == me)
        st = st._replace(
            idx=idx,
            idx_overflow=st.idx_overflow | (live & is_ins & ~applied).any(1),
            free_stack=colls.put_rows(st.free_stack, back, gc_slot,
                                      host_free),
            free_top=(st.free_top + hf.sum(1)).to(torch.int32),
            slot_ctr=colls.put_rows(st.slot_ctr, old_slot, 1, bump,
                                    accumulate=True) & MASK32)
        if self.hot is not None:
            # vacated rows start cold for their next tenant (§10.3)
            st = st._replace(heat=self.hot.forget(
                st.heat, torch.where(is_mov, old_node, node), gc_slot,
                applied & (is_del | is_mov)))
        return st, applied

    # -- the scalar service round (the executable specification) ---------------------
    def _service_round(self, st: KVStoreState, op, key, value, lock_id,
                       ticket, pending):
        """One scalar service round — part of the ``_op_round_reference``
        spec.  Every participant whose ticket its lock serves executes its
        one operation: an INSERT allocates a local slot and writes the row
        invalid, every participant applies the round's P tracker records and
        acknowledges them through the SST, an UPDATE or DELETE writes its
        row with the scalar one-sided verb, the INSERT sets its row valid
        once every peer acknowledged, and the holder releases its lock.
        op, key, lock_id, ticket, pending (n,); value (n, W).  Returns
        (state, pending, holding, success)."""
        S = self.S
        ar, me = self.local_ids(), self.my_id()
        holding = pending & self.locks.holds(st.locks, lock_id, ticket)
        found, _pos, node, slot, ctr = (
            x[:, 0] for x in self._index_lookup(st, key[:, None]))
        do_ins = holding & (op == INSERT) & ~found
        do_upd = holding & (op == UPDATE) & found
        do_del = holding & (op == DELETE) & found

        # ---- INSERT phase 1: allocate a local slot, write the row invalid
        do_ins = do_ins & (st.free_top > 0)
        my_slot = st.free_stack[ar, (st.free_top.long() - 1).clamp(min=0)]
        free_top = torch.where(do_ins, st.free_top - 1, st.free_top)
        new_ctr = (st.slot_ctr[ar, my_slot.long()] + 1) & MASK32
        st = st._replace(
            rows=self.rows_region.local_write(
                st.rows, my_slot, self.encode_row(value, new_ctr, False),
                pred=do_ins),
            slot_ctr=colls.put_rows(st.slot_ctr, my_slot[:, None],
                                    new_ctr[:, None], do_ins[:, None]),
            free_top=free_top)

        # ---- the tracker: P records, one a participant, applied by all
        kind = torch.where(do_ins, 1, torch.where(do_del, 2, 0))
        rec = torch.stack(
            [kind.to(torch.int32), u2i(key),
             torch.where(do_ins, me, node).to(torch.int32),
             torch.where(do_ins, my_slot, slot).to(torch.int32),
             u2i(torch.where(do_ins, new_ctr, ctr))], dim=-1)    # (n, 5)
        recs, inval = self.rt.gather_many(rec, do_upd | do_del)  # (P, 5)
        if self.cache is not None:
            # read-tier coherence (§8.3) on the scalar spec path too
            st = st._replace(cache=self.cache.invalidate(
                st.cache, recs[:, 2], recs[:, 3], inval))
        n_recs = (recs[:, 0] != 0).sum()
        st, applied = self._apply_tracker(st, recs)
        acks, _a = self.acks.push_accumulate(st.acks, n_recs)
        table = self.acks.rows(acks)
        all_acked = (table >= table[ar, me][:, None]).all(1)
        st = st._replace(acks=acks)

        # ---- index overflow: an un-indexed insert fails, returns its slot
        ins_ok = do_ins & applied[ar, me]
        fail = do_ins & ~applied[ar, me]
        top = st.free_top.long().clamp(0, S - 1)
        free_stack = st.free_stack.clone()
        free_stack[ar, top] = torch.where(fail, my_slot, free_stack[ar, top])
        st = st._replace(free_stack=free_stack,
                         free_top=torch.where(fail, st.free_top + 1,
                                              st.free_top))

        # ---- UPDATE: the full row (value, same ctr, valid); DELETE: the
        # payload cleared and valid unset, ctr kept — two scalar writes
        rows, _ = self.rows_region.write(
            st.rows, node, slot, self.encode_row(value, ctr, True),
            pred=do_upd)
        rows, _ = self.rows_region.write(
            rows, node, slot,
            self.encode_row(torch.zeros_like(value), ctr, False),
            pred=do_del)

        # ---- INSERT phase 2: valid once every peer acknowledged
        gate = join(AckKey([acks]), ins_ok & all_acked)
        st = st._replace(rows=self.rows_region.local_write(
            rows, my_slot, self.encode_row(value, new_ctr, True), pred=gate))

        # ---- release, after the critical section's effects
        st = st._replace(locks=self.locks.release(st.locks, lock_id,
                                                  holding))
        return st, pending & ~holding, holding, ins_ok | do_upd | do_del

    # -- the precomputed service schedule ---------------------------------------------
    def _service_schedule(self, op, key, lock_id, ticket, want):
        """Each lane's service round, computed once per window from the
        gathered lane metadata: (round_no (n, B) int32 — 0 for lanes that
        take no lock, write_winner (n, B) bool — False for an UPDATE whose
        row write a later same-key UPDATE in the same round supersedes,
        the window's round count, a 0-d tensor).  The gathered metadata is
        the same at every participant, so the (P·B)² masks are built once
        for all of them, and the round count is world-uniform."""
        g = self.rt.gather_many(lock_id, ticket, key, op, want)
        shape = g[0].shape
        g_lock, g_tick, g_key, g_op, g_want = (t.reshape(-1) for t in g)
        queued = g_want[None, :] & (g_lock[None, :] == g_lock[:, None])
        later = queued & (g_tick[None, :] > g_tick[:, None])     # [i,j]: j>i
        round_all, winner_all = self._schedule_core(g_key, g_op, g_want,
                                                    queued, later)
        return (self.rt.mine(round_all.reshape(shape)),
                self.rt.mine(winner_all.reshape(shape)), round_all.max())

    @staticmethod
    def _schedule_core(g_key, g_op, g_want, queued, later):
        """The schedule arithmetic over all N = P·B gathered lanes.

        Two lanes on one lock conflict and serialize in ticket order when
        they share a key and are not both UPDATEs, or when an allocating
        lane (INSERT, MOVE) queues behind a freeing one (DELETE, MOVE).  A
        lane is *bad* when it conflicts with an earlier lane of its queue;
        its round is 1 + the number of bad lanes at or before it.
        ``queued[i, j]``: lane j wants lane i's lock; ``later`` ⊆ ``queued``.
        Returns (round_all (N,) int32, winner_all (N,) bool)."""
        N = g_key.shape[0]
        eye = torch.eye(N, dtype=torch.bool, device=g_key.device)
        at_or_before = queued & ~later
        before = at_or_before & ~eye
        both_upd = (g_op[:, None] == UPDATE) & (g_op[None, :] == UPDATE)
        alloc_i = (g_op[:, None] == INSERT) | (g_op[:, None] == MOVE)
        free_j = (g_op[None, :] == DELETE) | (g_op[None, :] == MOVE)
        same_key = g_key[None, :] == g_key[:, None]
        conflict = (same_key & ~both_upd) | (alloc_i & free_j)
        bad = (before & conflict).any(1)
        round_all = torch.where(
            g_want, 1 + (at_or_before & bad[None, :]).sum(1),
            torch.zeros((), dtype=torch.int64, device=g_key.device)
        ).to(torch.int32)
        same_round = round_all[None, :] == round_all[:, None]
        superseded = both_upd & same_key & same_round & later
        return round_all, ~superseded.any(1)

    # -- one service round over the whole (P, B) window ---------------------------------
    def _serving(self, st: KVStoreState, pending, serve, write_winner,
                 lock_id, ticket):
        """(holding, write_winner) of a service round: the lanes the
        schedule serves (``serve``), or with ``serve=None`` — the
        specification's serving — each lane whose ticket its lock serves
        now, one a lock, so no two same-key writes share a round."""
        if serve is None:
            holding = pending & self.locks.holds(st.locks, lock_id, ticket)
            return holding, torch.ones_like(holding)
        return pending & serve, write_winner

    def _release_round(self, st: KVStoreState, serve, lock_id, holding):
        """The specification's release at the end of every round
        (``serve=None``), after the round's effects; the scheduled path
        releases once, at the end of its window."""
        if serve is None:
            st = st._replace(locks=self.locks.release_window(
                st.locks, lock_id, holding))
        return st

    def _service_window(self, st: KVStoreState, op, key, value, pending,
                        look, serve, write_winner, lock_id=None,
                        ticket=None):
        """One service round: every pending lane served this round
        executes — the writer-local branch of the reference.  The schedule
        says which lanes (``serve``); with ``serve=None`` (a reference-impl
        store) the lanes whose tickets their locks serve do, and release
        their locks at the end of the round.  Concurrent mutations hold
        distinct locks, hence act on distinct keys and live slots, which
        makes the batched allocation, the (P·B, 5) tracker sweep and the
        single batched write race-free.

        ``look`` is each lane's (found, node, slot, ctr) view of the index;
        it is refreshed from this round's applied records and returned for
        the next round.  Returns (state, pending, holding, success, look)."""
        n, B = op.shape
        S = self.S
        ar, me = self.local_ids(), self.my_id()[:, None]
        holding, write_winner = self._serving(st, pending, serve,
                                              write_winner, lock_id, ticket)
        found, node, slot, ctr = look
        do_ins = holding & (op == INSERT) & ~found
        do_upd = holding & (op == UPDATE) & found
        do_del = holding & (op == DELETE) & found

        # ---- INSERT phase 1: allocate local slots, write rows with valid=0.
        # Insert lane j takes the (rank_j)-th slot from the top of the free
        # stack; ranks past the stack depth fail (capacity exhaustion).
        ins = do_ins.to(torch.int32)
        ins_rank = ins.cumsum(1, dtype=torch.int32) - ins
        do_ins = do_ins & (ins_rank < st.free_top[:, None])
        my_slot = st.free_stack.gather(
            1, (st.free_top[:, None] - 1 - ins_rank).clamp(0, S - 1).long())
        free_top = (st.free_top - do_ins.sum(1)).to(torch.int32)
        new_ctr = (st.slot_ctr.gather(1, my_slot.long()) + 1) & MASK32
        rows_inv = self.rows_region.local_write_batch(
            st.rows, my_slot, self.encode_row(value, new_ctr, False),
            preds=do_ins)
        st = st._replace(
            rows=rows_inv, free_top=free_top,
            slot_ctr=colls.put_rows(st.slot_ctr, my_slot, new_ctr, do_ins))

        # ---- tracker broadcast: B records per participant, one sweep
        kind = torch.where(do_ins, 1, torch.where(do_del, 2, 0))
        rec = torch.stack(
            [kind.to(torch.int32), u2i(key),
             torch.where(do_ins, me, node).to(torch.int32),
             torch.where(do_ins, my_slot, slot).to(torch.int32),
             u2i(torch.where(do_ins, new_ctr, ctr))], dim=-1)   # (n, B, 5)
        # the gather, participant-major
        g_rec, g_inval = self.rt.gather_many(rec, do_upd | do_del)
        recs = g_rec.reshape(-1, 5)                               # (P·B, 5)
        if self.cache is not None:
            # read-tier coherence (§8.3): an UPDATE/DELETE lane's record
            # names the row it is about to write; every participant drops
            # its cached copy (INSERTs need none: slot reuse bumps the
            # counter the hit protocol validates)
            st = st._replace(cache=self.cache.invalidate(
                st.cache, recs[:, 2], recs[:, 3], g_inval.reshape(-1)))
        n_recs = (recs[:, 0] != 0).sum()
        st, applied = self._apply_tracker(st, recs)
        my_applied = applied.reshape(n, self.P, B)[ar, me[:, 0]]
        # acknowledge all applied records through the SST in one push;
        # inserters require every peer caught up before setting valid
        acks, _a = self.acks.push_accumulate(st.acks, n_recs)
        table = self.acks.rows(acks)
        all_acked = (table >= table[ar, me[:, 0]][:, None]).all(1)
        st = st._replace(acks=acks)

        # ---- index overflow: un-indexed inserts fail and return their slots
        ins_ok = do_ins & my_applied
        fails = do_ins & ~my_applied
        f = fails.to(torch.int64)
        back = (st.free_top[:, None] + f.cumsum(1) - f).clamp(0, S - 1)
        st = st._replace(
            free_stack=colls.put_rows(st.free_stack, back, my_slot, fails),
            free_top=(st.free_top + f.sum(1)).to(torch.int32))

        # ---- UPDATE / DELETE: every row write of the round in ONE batched
        # one-sided write; superseded same-key UPDATEs are masked out, so
        # the batch is collision-free
        row_upd = self.encode_row(value, ctr, True)
        row_del = self.encode_row(torch.zeros_like(value), ctr, False)
        rows2, _ = self.rows_region.write_batch(
            st.rows, node, slot, torch.where(do_upd[..., None], row_upd,
                                             row_del),
            preds=(do_upd & write_winner) | do_del, assume_unique=True)
        st = st._replace(rows=rows2)

        # ---- INSERT phase 2: mark valid after every peer acknowledged
        gate = join(AckKey([acks]), ins_ok & all_acked[:, None])
        st = st._replace(rows=self.rows_region.local_write_batch(
            st.rows, my_slot, self.encode_row(value, new_ctr, True),
            preds=gate))
        st = self._release_round(st, serve, lock_id, holding)

        success = ins_ok | do_upd | do_del
        return (st, pending & ~holding, holding, success,
                _refresh_look(recs, applied, key, look))

    # -- the placed service round (explicit locality tier, DESIGN.md §10) -------
    def _service_window_placed(self, st: KVStoreState, op, key, value,
                               pending, look, serve, write_winner, homes,
                               any_alloc, has_move, lock_id=None,
                               ticket=None):
        """One service round under non-local placement: INSERT slots are
        allocated at each lane's *home* (P, B) through a request/grant
        round-trip, the rows travel on the batched one-sided write, and
        MOVE lanes re-home live rows (§10.2).  Each home grants its requests
        in global (participant, lane) order from its own free stack, so
        homes equal to the writers land the writer-local path's slot
        choices.  The round-trip runs in every round of a window with an
        allocating lane anywhere (``any_alloc``, from the window's lanes)
        and in no round of any other window.

        A MOVE lane holds its key's lock, so one clean pre-read of the row
        at its old home suffices; it rides the round-trip.  The mover
        allocates at the destination, emits one kind-3 tracker record naming
        the new location (every participant applies it as tombstone and
        reinsert in one wave; the old home frees the vacated slot and bumps
        its reuse counter), and once every peer acknowledged it writes the
        row at the destination and clears the old one, both in the round's
        batched write (2B lanes in a window with a MOVE lane,
        ``has_move``).  A MOVE whose destination is the current home
        succeeds with no effect.  ``serve=None`` serves and releases as in
        :meth:`_service_window`.  Returns (state, pending, holding, success,
        look) as :meth:`_service_window` does."""
        n, B = op.shape
        P, S = self.P, self.S
        ar, me = self.local_ids(), self.my_id()[:, None]
        holding, write_winner = self._serving(st, pending, serve,
                                              write_winner, lock_id, ticket)
        found, node, slot, ctr = look
        node = node.to(torch.int32)
        slot = slot.to(torch.int32)
        do_ins = holding & (op == INSERT) & ~found
        do_upd = holding & (op == UPDATE) & found
        do_del = holding & (op == DELETE) & found
        is_move = holding & (op == MOVE) & found
        do_move = is_move & (homes != node)
        move_noop = is_move & (homes == node)

        # ---- the MOVE pre-read and the allocation at the home nodes: one
        # (P·B, 2) request gather, one (P·B, 3) grant psum
        N = P * B
        alloc_want = do_ins | do_move
        grant = torch.zeros((n, N), dtype=torch.bool, device=op.device)
        a_slot = torch.zeros((n, N), dtype=torch.int32, device=op.device)
        aok = torch.zeros_like(do_ins)
        my_slot = torch.zeros((n, B), dtype=torch.int32, device=op.device)
        new_ctr = torch.zeros((n, B), dtype=torch.int64, device=op.device)
        moved = torch.zeros_like(value)
        if any_alloc:
            moved = self.backend.read_batch(
                st.rows.buf, node, slot, preds=do_move,
                ledger=self.mgr.traffic, verb=f"{self.full_name}.move_read",
                coalesce=False, rt=self.rt)[..., :self.W]
            g_want, g_home = (t.reshape(-1) for t in self.rt.gather_many(
                alloc_want, homes))
            mine = g_want[None, :] & (g_home[None, :] == me)       # (n, N)
            mn = mine.to(torch.int64)
            rank = mn.cumsum(1) - mn
            grant = mine & (rank < st.free_top[:, None])
            a_slot = st.free_stack.gather(
                1, (st.free_top[:, None] - 1 - rank).clamp(0, S - 1))
            a_ctr = (st.slot_ctr.gather(1, a_slot.long()) + 1) & MASK32
            tbl = torch.where(grant[..., None], torch.stack(
                [torch.ones_like(a_slot), a_slot, u2i(a_ctr)], -1),
                torch.zeros((), dtype=torch.int32, device=op.device))
            tbl = self.rt.psum_scatter(tbl.reshape(n, P, B, 3))   # the psum
            colls.record_rounds(self.mgr.traffic, f"{self.full_name}.alloc",
                                self.backend.alloc_rounds)
            st = st._replace(
                slot_ctr=colls.put_rows(st.slot_ctr, a_slot, a_ctr, grant),
                free_top=(st.free_top - grant.sum(1)).to(torch.int32))
            aok, my_slot, new_ctr = tbl[..., 0] != 0, tbl[..., 1], \
                i2u(tbl[..., 2])
        do_ins = do_ins & aok
        do_move = do_move & aok
        placed = do_ins | do_move

        # ---- INSERT phase 1: the writer one-sided-writes the invalid row
        # at its home (a self lane is a local store, zero wire bytes)
        rows_inv, _ = self.rows_region.write_batch(
            st.rows, homes, my_slot, self.encode_row(value, new_ctr, False),
            preds=do_ins, assume_unique=True)
        st = st._replace(rows=rows_inv)

        # ---- tracker broadcast: kind-1/3 records name the NEW location, a
        # kind-3's old one is recovered from the index at apply time
        kind = torch.where(do_ins, 1, torch.where(
            do_del, 2, torch.where(do_move, 3, 0)))
        rec = torch.stack(
            [kind.to(torch.int32), u2i(key),
             torch.where(placed, homes, node).to(torch.int32),
             torch.where(placed, my_slot, slot).to(torch.int32),
             u2i(torch.where(placed, new_ctr, ctr))], dim=-1)    # (n, B, 5)
        # the gather, participant-major, with the lanes' pre-mutation views
        g_rec, g_node, g_slot, g_inval = self.rt.gather_many(
            rec, node, slot, do_upd | do_del | do_move)
        recs = g_rec.reshape(N, 5)
        if self.cache is not None:
            # §8.3: invalidate the PRE-mutation location of every mutated
            # row (the lane's index view; a MOVE vacates its old home)
            st = st._replace(cache=self.cache.invalidate(
                st.cache, g_node.reshape(-1), g_slot.reshape(-1),
                g_inval.reshape(-1)))
        n_recs = (recs[:, 0] != 0).sum()
        st, applied = self._apply_tracker(st, recs)
        my_applied = applied.reshape(n, P, B)[ar, me[:, 0]]
        acks, _a = self.acks.push_accumulate(st.acks, n_recs)
        table = self.acks.rows(acks)
        all_acked = (table >= table[ar, me[:, 0]][:, None]).all(1)
        st = st._replace(acks=acks)

        # ---- failed placements return their slots to the HOME stacks (the
        # grant table is global, so each home sees its own failures)
        fail = grant & ~applied
        f = fail.to(torch.int64)
        back = (st.free_top[:, None] + f.cumsum(1) - f).clamp(0, S - 1)
        st = st._replace(
            free_stack=colls.put_rows(st.free_stack, back, a_slot, fail),
            free_top=(st.free_top + f.sum(1)).to(torch.int32))
        ins_ok = do_ins & my_applied
        move_ok = do_move & my_applied

        # ---- the round's one-sided row writes in ONE batched write: UPDATE
        # winners and DELETE clears, the ack-gated INSERT valid rows and MOVE
        # destination rows, and (a window with a MOVE lane) the ack-gated
        # clears of the moved rows' old slots
        row_upd = self.encode_row(value, ctr, True)
        row_del = self.encode_row(torch.zeros_like(value), ctr, False)
        row_ins = self.encode_row(value, new_ctr, True)
        row_mov = self.encode_row(moved, new_ctr, True)
        gate = join(AckKey([acks]), (ins_ok | move_ok) & all_acked[:, None])
        prim = torch.where(do_upd[..., None], row_upd, torch.where(
            do_del[..., None], row_del,
            torch.where(do_ins[..., None], row_ins, row_mov)))
        tgt = torch.where(placed, homes, node)
        idx = torch.where(placed, my_slot, slot)
        preds = (do_upd & write_winner) | do_del | gate
        if has_move:
            tgt, idx = torch.cat([tgt, node], 1), torch.cat([idx, slot], 1)
            prim = torch.cat([prim, row_del], 1)
            preds = torch.cat([preds, gate & do_move], 1)
        rows2, _ = self.rows_region.write_batch(
            st.rows, tgt, idx, prim, preds=preds, assume_unique=True)
        st = self._release_round(st._replace(rows=rows2), serve, lock_id,
                                 holding)
        success = ins_ok | do_upd | do_del | move_ok | move_noop
        return (st, pending & ~holding, holding, success,
                _refresh_look(recs, applied, key, look))

    def _lane_homes(self, ops, keys, targets):
        """(n, B) int32 home nodes under the store's placement policy, or
        ``None`` for the writer-local path (placement ``"local"`` with no
        explicit targets).  MOVE lanes home at their explicit target when
        one is given, else at the policy home."""
        if targets is None and self.placement == "local":
            return None
        t = None if targets is None else _tensor(
            targets, torch.int32, self.device).reshape(ops.shape).clamp(
                0, self.P - 1)
        if self.placement == "hashed":
            ph = (keys % self.P).to(torch.int32)
        elif self.placement == "explicit":
            if t is None:
                raise ValueError(
                    "placement='explicit' stores need per-lane targets=")
            ph = t
        else:
            ph = self.my_id()[:, None].expand(ops.shape).to(torch.int32)
        return ph if t is None else torch.where(ops == MOVE, t, ph)

    # -- windows --------------------------------------------------------------------
    def op_window(self, st: KVStoreState, ops, keys, values, targets=None,
                  targets_are_homes=False, lockfree=None):
        """Every participant submits a window of mixed operations; the whole
        (P, B) window executes in one round-set.  Service rounds run until
        every mutation completed.  Returns (state, KVResult).

        ops (P, B) int in {NOP, GET, INSERT, UPDATE, DELETE, MOVE}; keys
        (P, B) uint32 (nonzero); values (P, B, W) int32.  ``targets`` (P, B)
        int: per-lane placement hints (§10.1), the home of INSERT lanes
        under ``placement="explicit"`` and the destination of MOVE lanes.
        MOVE lanes need the placed path (a non-local placement or explicit
        ``targets``); under the writer-local path they take their lock and
        fail (``found=False``) with no effect.  ``targets_are_homes=True``
        (the replay entry point) bypasses the placement policy: ``targets``
        ARE the per-lane homes.

        ``lockfree`` (default: the store's constructor knob) runs the §11
        fast path: a window whose lock-wanting lanes are all UPDATEs
        (pure-GET windows included) is served by one batched
        counter-validated write, with no service round, tracker sweep or
        SST push; any other window falls back to the locked schedule.  Both
        paths commit identical state bits for identical windows.  The
        window's uniform flags (a MOVE or allocating lane anywhere, a
        lock-wanting lane anywhere, the fast classification) cost one
        world-uniform host read together."""
        lockfree = self.lockfree if lockfree is None else bool(lockfree)
        if lockfree and self.reference_impl:
            raise ValueError("lockfree op_window requires the scheduled "
                             "implementation (reference_impl=False)")
        ops, keys, values = self._lanes_in(ops, keys, values)
        want_lock = (ops == INSERT) | (ops == UPDATE) | (ops == DELETE) \
            | (ops == MOVE)
        has_move, any_alloc, any_want, any_slow = self.rt.any_flags(
            ops == MOVE, (ops == INSERT) | (ops == MOVE), want_lock,
            want_lock & (ops != UPDATE))
        win_fast = not any_slow
        if targets_are_homes:
            homes = _tensor(targets, torch.int32, self.device).reshape(
                ops.shape).clamp(0, self.P - 1)
        else:
            homes = self._lane_homes(ops, keys, targets)
        n, B = ops.shape
        lock_id = (keys % self.L).to(torch.int32)
        # one index probe for the whole window; the service rounds keep the
        # per-lane view current from the tracker records
        found0, _pos, node0, slot0, ctr0 = self._index_lookup(st, keys)
        look = (found0, node0, slot0, ctr0)

        # the locked path acquires and schedules every window; the §11
        # path only a window with a lock-wanting lane anywhere; the
        # specification acquires and serves one ticket a lock a round,
        # releasing as it goes, and its placed rounds make the allocation
        # round-trip whether or not a lane allocates
        lock_totals = ticket = write_winner = None
        if any_want or not lockfree:
            lstate, ticket = self.locks.acquire_window(st.locks, lock_id,
                                                       want_lock)
            if not self.reference_impl:
                # every acquired ticket completes within this window, so the
                # end-of-window release bumps now_serving by the acquire
                # totals
                lock_totals = (lstate.next_ticket - st.locks.next_ticket) \
                    & MASK32
                round_no, write_winner, max_round = self._service_schedule(
                    ops, keys, lock_id, ticket, want_lock)
            st = st._replace(locks=lstate)
        any_alloc = any_alloc or self.reference_impl

        # lock-free GETs against the pre-window state
        get_val, get_found, retries, st = self._get_window(
            st, keys, ops == GET, look=look)

        pending = want_lock
        succ = torch.zeros_like(want_lock)
        fast = lockfree and win_fast
        if lockfree:
            # a found UPDATE of a fast window succeeds whether or not its
            # write wins, as in the locked round
            do_upd_fast = (ops == UPDATE) & found0 & win_fast
            if any_want and win_fast:
                if self.cache is not None:
                    # the §8.3 invalidation the locked round's tracker
                    # records would carry: an UPDATE overwrites the live row
                    # its index view names
                    g_node, g_slot, g_upd = self.rt.gather_many(
                        node0.to(torch.int32), slot0.to(torch.int32),
                        (ops == UPDATE) & found0)
                    st = st._replace(cache=self.cache.invalidate(
                        st.cache, g_node.reshape(-1), g_slot.reshape(-1),
                        g_upd.reshape(-1)))
                # the fast serve: commuting UPDATEs are ONE batched
                # counter-validated write of the rows the index view names;
                # superseded same-key lanes are winner-masked as in the
                # locked round
                rows, _ = self.rows_region.write_batch(
                    st.rows, node0.to(torch.int32), slot0.to(torch.int32),
                    self.encode_row(values, ctr0, True),
                    preds=do_upd_fast & write_winner, assume_unique=True)
                st = st._replace(rows=rows)
            pending = want_lock & (not win_fast)
            succ = do_upd_fast
            # one count a window: the classification is the same at every
            # participant, and the reference records it once
            colls.record_fastpath(self.mgr.traffic, self.full_name,
                                  float(win_fast), 1.0)
        def serve_round(st, pending, look, serve):
            kw = dict(serve=serve, write_winner=write_winner,
                      lock_id=lock_id, ticket=ticket)
            if homes is None:
                return self._service_window(st, ops, keys, values, pending,
                                            look, **kw)
            return self._service_window_placed(
                st, ops, keys, values, pending, look, homes=homes,
                any_alloc=any_alloc, has_move=has_move, **kw)

        if self.reference_impl:
            # rounds while any lane anywhere is pending: a world-uniform
            # host read a round
            while self.rt.any(pending):
                st, pending, _held, s_now, look = serve_round(
                    st, pending, look, None)
                succ = succ | s_now
        else:
            # the reference loops while any lane anywhere is pending; every
            # pending lane is served in its scheduled round, so that is
            # exactly max(round_no) rounds, from the gathered schedule
            n_rounds = int(max_round) if any_want and not fast else 0
            for r in range(1, n_rounds + 1):
                st, pending, _held, s_now, look = serve_round(
                    st, pending, look, round_no == r)
                succ = succ | s_now

        # deferred batched release, after every critical-section effect
        # (program order is the release fence, §5.4)
        if lock_totals is not None:
            st = st._replace(locks=st.locks._replace(
                now_serving=(st.locks.now_serving + lock_totals) & MASK32))
        is_get = ops == GET
        return st, KVResult(
            value=torch.where(is_get[..., None], get_val,
                              torch.zeros_like(get_val)),
            found=torch.where(is_get, get_found, succ),
            retries=torch.full((n, B), retries, dtype=torch.int32,
                               device=ops.device))

    def op_round(self, st: KVStoreState, op, key, value):
        """Every participant submits one operation: the B=1 window.
        op (n,), key (n,), value (n, W) → (state, KVResult of (n,) lanes)."""
        n = self.n_local
        st, res = self.op_window(
            st, _tensor(op, torch.int32, self.device).reshape(n, 1),
            as_u32(key, self.device).reshape(n, 1),
            _tensor(value, torch.int32, self.device).reshape(n, 1, self.W))
        return st, KVResult(value=res.value[:, 0], found=res.found[:, 0],
                            retries=res.retries[:, 0])

    def _op_round_reference(self, st: KVStoreState, op, key, value):
        """The scalar op_round — the executable specification :meth:`op_round`
        is pinned against bit for bit: a ticket from the lock stripe's
        scalar acquire, the scalar lock-free GET (:meth:`_get`) against the
        pre-round state, then scalar service rounds (:meth:`_service_round`)
        until no participant is pending, a world-uniform host read a round.
        op, key (n,); value (n, W) → (state, KVResult of (n,) lanes)."""
        n = self.n_local
        op = _tensor(op, torch.int32, self.device).reshape(n)
        key = as_u32(key, self.device).reshape(n)
        value = _tensor(value, torch.int32, self.device).reshape(n, self.W)
        lock_id = key % self.L
        want_lock = (op == INSERT) | (op == UPDATE) | (op == DELETE)
        lstate, ticket = self.locks.acquire(st.locks, lock_id, want_lock)
        st = st._replace(locks=lstate)
        get_val, get_found, retries = self._get(st, key, op == GET)
        pending, succ = want_lock, torch.zeros_like(want_lock)
        while self.rt.any(pending):
            with self.mgr.no_tracking():
                st, pending, _held, s_now = self._service_round(
                    st, op, key, value, lock_id, ticket, pending)
            succ = succ | s_now
        is_get = op == GET
        return st, KVResult(
            value=torch.where(is_get[:, None], get_val,
                              torch.zeros_like(get_val)),
            found=torch.where(is_get, get_found, succ),
            retries=torch.full((n,), retries, dtype=torch.int32,
                               device=self.device))

    # -- online migration and rebalancing (the §10 locality tier) ----------------
    def migrate_window(self, st: KVStoreState, keys, dests, preds=None):
        """Re-home an (n, B) lane window of live rows in one round-set: lane
        (p, b) moves ``keys[p, b]`` to node ``dests[p, b]``.  MOVE lanes of
        :meth:`op_window`, so migrations take the key's ticket lock and
        linearize with concurrent windows like any mutation.  Returns
        (state, moved (n, B) bool): a lane fails when the key is absent,
        the destination's free stack is exhausted or ``preds`` masks it; a
        move to the key's current home succeeds with no effect."""
        n = self.n_local
        keys = as_u32(keys, self.device).reshape(n, -1)
        B = keys.shape[1]
        if preds is None:
            preds = torch.ones((n, B), dtype=torch.bool, device=self.device)
        preds = torch.as_tensor(preds, device=self.device).to(torch.bool) \
            .reshape(n, B)
        ops = torch.where(preds, MOVE, NOP).to(torch.int32)
        st, res = self.op_window(
            st, ops, keys,
            torch.zeros((n, B, self.W), dtype=torch.int32,
                        device=self.device),
            targets=_tensor(dests, torch.int32, self.device).reshape(n, B))
        return st, res.found

    def _migrate_reference(self, st: KVStoreState, keys, dests, preds=None):
        """The migration specification: the (n, B) lanes run as B
        single-lane MOVE windows one after the other, lane b of every
        participant in window b.  :meth:`migrate_window` is pinned against
        it result for result (slot choices may differ when several lanes
        target one destination).  Returns (state, moved (n, B))."""
        n = self.n_local
        keys = as_u32(keys, self.device).reshape(n, -1)
        B = keys.shape[1]
        dests = _tensor(dests, torch.int32, self.device).reshape(n, B)
        preds = torch.ones((n, B), dtype=torch.bool, device=self.device) \
            if preds is None else torch.as_tensor(
                preds, device=self.device).to(torch.bool).reshape(n, B)
        moved = []
        for b in range(B):
            st, ok = self.migrate_window(st, keys[:, b:b + 1],
                                         dests[:, b:b + 1],
                                         preds=preds[:, b:b + 1])
            moved.append(ok[:, 0])
        return st, torch.stack(moved, 1)

    def rebalance_proposals(self, st: KVStoreState, max_moves: int,
                            min_heat: float = 1.0, with_alts: bool = False):
        """Up to ``max_moves`` MOVE proposals for rows whose dominant reader
        is remote (§10.3), from the HotTracker's decayed counters; needs
        ``track_heat=True``.  Every live index entry is scored by
        (dominant-reader heat − current-home heat) and the top ones are
        taken, ties to the lower index position as ``lax.top_k`` breaks
        them.  The list is the same for every participant, so it is
        computed once from the all-gathered heat (the index is identical
        everywhere) and dealt round-robin: proposal j rides lane j // P of
        participant j % P.

        Returns (keys (n, B), dests (n, B), valid (n, B)) with
        B = ceil(max_moves / P); invalid lanes are padding.  ``with_alts``
        adds (alts (n, B), alt_valid (n, B)): each row's second-hottest
        reader, for the backlog spill, valid where it improves locality
        (heat ≥ ``min_heat``, above the current home's, another node)."""
        if self.hot is None:
            raise ValueError("rebalance needs a heat-tracked store "
                             "(track_heat=True)")
        P = self.P
        B = -(-int(max_moves) // P)
        M = min(B * P, self.C)
        B = -(-M // P)
        g = self.hot.all_heat(st.heat)                     # (P, P·S)
        dom = g.argmax(0)                                  # dominant reader
        dom_heat = g.amax(0)
        idx = st.idx[0]
        node = idx[:, IDX_NODE].clamp(0, P - 1).long()
        lid = self.hot.line_of(node, idx[:, IDX_SLOT])
        home_heat = g[node, lid]
        want = (idx[:, IDX_STATE] == _USED) & (dom[lid] != node) \
            & (dom_heat[lid] >= min_heat)
        score = torch.where(want, dom_heat[lid] - home_heat,
                            torch.full((), -1.0, device=g.device))
        top_score, top_pos = torch.sort(score, descending=True, stable=True)
        top_score, top_pos = top_score[:M], top_pos[:M]
        lane = self.my_id()[:, None] \
            + torch.arange(B, device=g.device)[None, :] * P
        sel = lane.clamp(0, M - 1)
        # the caller's bound is exact even where the P-lane grid rounds
        # past it
        valid = (top_score > 0.0)[sel] & (lane < min(int(max_moves), M))
        keys = i2u(idx[top_pos, IDX_KEY])[sel]
        dests = dom[lid[top_pos]].to(torch.int32)[sel]
        if not with_alts:
            return keys, dests, valid
        # the second-hottest reader: the argmax with the dominant one's
        # heat masked out
        g_wo = torch.where(torch.arange(P, device=g.device)[:, None]
                           == dom[None, :],
                           torch.full((), -torch.inf, device=g.device), g)
        alt, alt_heat = g_wo.argmax(0), g_wo.amax(0)
        l_top = lid[top_pos]
        alts = alt[l_top].to(torch.int32)
        altv = (alt_heat[l_top] >= min_heat) \
            & (alt_heat[l_top] > home_heat[top_pos]) \
            & (alt[l_top] != node[top_pos])
        return keys, dests, valid, alts[sel], altv[sel]

    def rebalance(self, st: KVStoreState, max_moves: int,
                  min_heat: float = 1.0):
        """Propose and execute one migration window: rows whose dominant
        reader is remote move to it.  A proposal that fails (destination
        full, key gone) spills to its second-hottest reader in a second
        window when that one improves locality; what still fails is
        deferred, not dropped (its heat persists), and counted in
        ``st.heat.backlog``.  Returns (state, n_moved (n,) int32 — the
        cluster-wide count of executed moves, on every participant)."""
        keys, dests, valid, alts, altv = self.rebalance_proposals(
            st, max_moves, min_heat=min_heat, with_alts=True)
        st, moved = self.migrate_window(st, keys, dests, preds=valid)
        st, spilled = self.migrate_window(st, keys, alts,
                                          preds=valid & ~moved & altv)
        moved, spilled, valid = self.rt.gather_many(moved, spilled, valid)
        n_moved = (moved.sum() + spilled.sum()).to(torch.int32)
        backlog = valid.sum().to(torch.int32) - n_moved
        n = self.n_local
        st = st._replace(heat=st.heat._replace(backlog=backlog.repeat(n)))
        return st, n_moved.repeat(n)

    # -- replication records (the ReplicatedLog's entries, DESIGN.md §9.3) --
    @property
    def record_width(self) -> int:
        """int32 words of one exported mutation record:
        ``[op | key_bits | value…W | home]``."""
        return 3 + self.W

    def export_window_records(self, ops, keys, values, targets=None):
        """Encode an (n, B) window as replication records: (n, B,
        record_width) int32 rows ``[op | key_bits | value… | home]`` with
        non-mutating lanes (NOP/GET) masked to NOP.  The last column is the
        lane's home resolved under the store's placement policy, so a
        replica replays the leader's placement whatever its own policy."""
        ops = _tensor(ops, torch.int32, self.device)
        P, B = ops.shape
        keys = as_u32(keys, self.device).reshape(P, B)
        values = _tensor(values, torch.int32, self.device).reshape(P, B,
                                                                   self.W)
        mut = (ops == INSERT) | (ops == UPDATE) | (ops == DELETE) \
            | (ops == MOVE)
        homes = self._lane_homes(ops, keys, targets)
        if homes is None:
            # writer-local: home IS the writer, and MOVE lanes are no-ops
            # there, so their records are masked too
            mut = mut & (ops != MOVE)
            homes = self.my_id()[:, None].expand(P, B).to(torch.int32)
        return torch.cat([
            torch.where(mut, ops, torch.full_like(ops, NOP))[..., None],
            u2i(keys)[..., None], values, homes.to(torch.int32)[..., None]],
            dim=-1)

    def replay_window_records(self, st: KVStoreState, recs, pred=True):
        """Apply one exported (n, B, record_width) record window through
        :meth:`op_window` with the records' homes as the per-lane homes
        (``targets_are_homes``).  ``pred`` ((n,) or a bool) False masks a
        participant's whole window to NOP — an absent log entry replays as
        the identity.  Returns (state, KVResult)."""
        recs = _tensor(recs, torch.int32, self.device)
        pred = torch.as_tensor(pred, device=self.device).to(torch.bool) \
            .expand(self.n_local)
        ops = torch.where(pred[:, None], recs[..., 0],
                          torch.full_like(recs[..., 0], NOP))
        return self.op_window(st, ops, i2u(recs[..., 1]),
                              recs[..., 2:2 + self.W],
                              targets=recs[..., 2 + self.W],
                              targets_are_homes=True)

    def get_batch(self, st: KVStoreState, keys, pred=None):
        """R lock-free GETs per participant in one collective round.
        keys (n, R) uint32; ``pred`` optional (n, R) bool lane mask.
        Returns (state, values (n, R, W), found (n, R))."""
        keys = as_u32(keys, self.device)
        if pred is None:
            pred = torch.ones(keys.shape, dtype=torch.bool, device=self.device)
        else:
            pred = torch.as_tensor(pred, device=self.device)
        values, found, _tries, st = self._get_window(st, keys, pred)
        return st, values, found


# ---------------------------------------------------------------------------
# state exchange with numpy (the JAX package's state, leaf for leaf)
# ---------------------------------------------------------------------------

_NESTED = {"locks": TicketLockArrayState, "rows": SharedRegionState,
           "acks": SSTState, "cache": ReadCacheState,
           "heat": HotTrackerState}


def _leaf_in(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def _leaf_out(t):
    a = t.detach().cpu().numpy()
    if a.dtype == np.int64:      # the port's uint32 holders
        a = (a & MASK32).astype(np.uint32)
    return a


def _map_state(fn, state):
    out = {}
    for name in KVStoreState._fields:
        leaf = getattr(state, name)
        if name in _NESTED:
            cls = _NESTED[name]
            out[name] = cls(*(fn(getattr(leaf, f)) for f in cls._fields))
        else:
            out[name] = fn(leaf)
    return KVStoreState(**out)


def state_from_numpy(np_state, device=None) -> KVStoreState:
    """A KVStore state whose leaves are numpy arrays — the JAX package's
    ``KVStoreState`` after ``jax.tree.map(np.asarray, ...)`` or the output
    of :func:`state_to_numpy` — as the port's state on ``device``."""
    dev = resolve_device(device)
    return _map_state(lambda a: _leaf_in(a, dev), np_state)


def state_to_numpy(state: KVStoreState) -> KVStoreState:
    """The port's state with numpy leaves of the JAX state's dtypes (uint32
    where the reference has uint32, bool where it has bool)."""
    return _map_state(_leaf_out, state)
