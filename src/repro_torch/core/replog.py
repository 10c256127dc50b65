"""ReplicatedLog — a kvstore replication log composed from channel objects,
the counterpart of ``repro/core/replog.py`` (DESIGN.md §9.3, §12, §13).

* a :class:`~repro_torch.core.ringbuffer.Ringbuffer` owned by the *leader*
  carries one log entry per kvstore mutation window: the gathered
  (P·B, record_width) mutation records (``KVStore.export_window_records``);
* the ring's SST of read cursors is the replication-progress table
  (``lag``), and ring reuse is commit acknowledgement;
* followers drain entries with one checksum-validated read per sync and
  replay them through ``KVStore.replay_window_records``, so every follower
  replica converges bitwise to the leader store;
* a second SST, the **ptable** (``[epoch, cursor, heartbeat]`` per
  participant), makes the log survive the leader's death: entries carry the
  leader's epoch, followers fence older epochs at delivery, and
  :meth:`ReplicatedLog.promote` elects the most caught-up live participant
  from one gather of the table.  The heartbeat column feeds a
  :class:`~repro_torch.core.detector.FailureDetector`.

Promotion is restartable: gather → fence (burns the new epoch and records the
log head in ``fence_heads``) → re-publish the unacked suffix, re-stamping
exactly the slots the fence-head rule proves legitimate, so a crash at any
step is recovered by promoting again.  A revived participant whose cursor gap
exceeds the ring rejoins by **snapshot transfer**
(:meth:`ReplicatedLog.rejoin_step`): the leader image flattened leaf by leaf
into uint32 words, pulled in checksum-validated, version- and epoch-stamped
chunks through the backend's ``read_batch``; :meth:`ReplicatedLog.readmit`
is the cheap path when the gap still fits the ring.

Every method takes and returns tensors led by the participants held here
(``n_local``: P on the stacked binding, 1 on a rank of a process binding,
one participant a rank), and an (n_local,) tensor where the reference has a
per-participant scalar.  What the reference computes on the gathered table
(the window's records, the election from the ptable, the rejoin chunk) it
computes here on the runtime's gather; its ``psum(x) > 0`` and ``pmax`` over
the participants are the runtime's device-valued :meth:`~repro_torch.core.
runtime.Runtime.world_any` and :meth:`~repro_torch.core.runtime.Runtime.
pmax`.  uint32 values are held in int64 masked to 32 bits (``core/u32.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import colls
from .backends import get_backend
from .channel import Channel
from .kvstore import KVStore, KVStoreState
from .ownedvar import checksum
from .ringbuffer import Ringbuffer, RingbufferState
from .runtime import Manager
from .sst import SST, SSTState
from .u32 import MASK32, from_words, i2u, to_words, u2i

_U32_MAX = 0xFFFFFFFF

# Epoch ceiling of the durable fence-head table (§13.2): beyond it the last
# row is reused.
MAX_EPOCHS = 32

# Attempt-indexed retry histogram width: successes on attempt i land in
# bucket min(i, RETRY_STAGES - 1).
RETRY_STAGES = 8

# KVStoreState fields that are local policy, not replicated data — the §9.3
# skip-list of the convergence check and the §13.3 snapshot.
_LOCAL_POLICY_FIELDS = ("cache", "heat")


def _leaves(tree):
    """The leaves of a (nested) NamedTuple in field order — the reference's
    ``jax.tree.leaves`` of a state field."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    """Rebuild ``like``'s NamedTuple structure from ``leaves`` in order."""
    if isinstance(like, tuple):
        out = []
        for v in like:
            sub, leaves = _unflatten(v, leaves)
            out.append(sub)
        return type(like)(*out), leaves
    return leaves[0], leaves[1:]


def diverging_leaves(a: KVStoreState, b: KVStoreState,
                     skip: Sequence[str] = _LOCAL_POLICY_FIELDS,
                     lanes=None, rt=None):
    """Names of the KVStoreState fields on which two states differ bitwise,
    outside ``skip`` (the read ``cache`` and the ``heat`` tracker are local
    policy).  ``lanes`` ((P,) bool) restricts the comparison to those
    participants: a dead process's copy legitimately goes stale.  On a rank
    of a process binding ``rt`` cuts ``lanes`` to the rank's block, and the
    answer is the block's."""
    out = []
    for name, la, lb in zip(a._fields, a, b):
        if name in skip:
            continue
        for xa, xb in zip(_leaves(la), _leaves(lb)):
            if lanes is not None:
                sel = torch.as_tensor(lanes, dtype=torch.bool,
                                      device=xa.device)
                if rt is not None:
                    sel = rt.mine(sel)
                xa, xb = xa[sel], xb[sel]
            if not torch.equal(xa, xb):
                out.append(name)
                break
    return out


class ReplicatedLogState(NamedTuple):
    ring: RingbufferState
    ptable: SSTState              # (n, P, 3): [accepted_epoch, applied_cursor,
    #                             # heartbeat] per participant
    published: torch.Tensor       # (n,) uint32 entries appended to the log
    dropped: torch.Tensor         # (n,) uint32 appends rejected by flow control
    fenced: torch.Tensor          # (n,) uint32 stale-epoch entries rejected
    fenced_writes: torch.Tensor   # (n,) uint32 publishes a deposed leader
    #                             # suppressed
    failovers: torch.Tensor       # (n,) uint32 promotions executed
    retries: torch.Tensor         # (n,) uint32 re-append attempts
    retries_by_attempt: torch.Tensor  # (n, RETRY_STAGES) uint32 appends that
    #                                 # succeeded on attempt i
    fence_heads: torch.Tensor     # (n, MAX_EPOCHS) uint32 log head recorded
    #                             # when each epoch was fenced (0xFFFFFFFF:
    #                             # not yet)


class RejoinState(NamedTuple):
    """Progress of one §13.3 snapshot transfer (one per revived node)."""
    staged: torch.Tensor       # (n, n_chunks * chunk) uint32 validated words
    cursor: torch.Tensor       # (n,) int32 next chunk to pull
    active: torch.Tensor       # (n,) bool a transfer is staged
    base_cursor: torch.Tensor  # (n,) uint32 log head the image matches
    base_epoch: torch.Tensor   # (n,) uint32 cluster epoch at staging
    restarts: torch.Tensor     # (n,) uint32 stagings abandoned mid-transfer
    done: torch.Tensor         # (n,) bool transfer complete and installed


class ReplicatedLog(Channel):
    """Replication log for ``store``-shaped mutation windows.

    window: the B of the windows it carries (one entry = the gathered
    (P·B, record_width) record block); capacity: ring entries between the
    leader and the slowest follower; leader: the initial ring owner."""

    def __init__(self, parent, name: str, mgr: Manager, *, store: KVStore,
                 window: int, capacity: int = 4, leader: int = 0,
                 rejoin_chunk: int = 256, backend=None):
        super().__init__(parent, name, mgr)
        # execution protocol of the log's data verbs: the ring publishes and
        # the rejoin snapshot reads (DESIGN.md §14)
        self.backend = get_backend(backend, default=mgr.backend)
        self.store = store
        self.window = int(window)
        self.leader = int(leader)
        self.rejoin_chunk = int(rejoin_chunk)
        self.rec_width = store.record_width
        self.entry_width = self.P * self.window * self.rec_width
        self.ring = Ringbuffer(self, "log", mgr, owner=self.leader,
                               capacity=int(capacity),
                               width=self.entry_width, dtype=torch.int32,
                               backend=self.backend)
        self.ptable = SST(self, "ptable", mgr, shape=(3,))
        self._snap_total = None

    def close(self):
        """Release the ring's exchange windows (every rank at once)."""
        self.ring.close()

    def init_state(self) -> ReplicatedLogState:
        n, dev = self.n_local, self.device
        z = torch.zeros((n,), dtype=torch.int64, device=dev)
        return ReplicatedLogState(
            ring=self.ring.init_state(),
            ptable=self.ptable.init_state(),
            published=z, dropped=z.clone(), fenced=z.clone(),
            fenced_writes=z.clone(), failovers=z.clone(), retries=z.clone(),
            retries_by_attempt=torch.zeros((n, RETRY_STAGES),
                                           dtype=torch.int64, device=dev),
            fence_heads=torch.full((n, MAX_EPOCHS), _U32_MAX,
                                   dtype=torch.int64, device=dev))

    # -- small helpers on the participants held here ---------------------------
    def _my_row(self, st):
        """Each held participant's own ptable row, (n, 3)."""
        return self.ptable.rows(st.ptable)[self.local_ids(), self.my_id()]

    def _my_cursor(self, ring: RingbufferState):
        return self.ring.acks.rows(ring.acks)[self.local_ids(), self.my_id()]

    def _alive(self, alive):
        """An (n, P) liveness view: (n, P) as given, or one (P,) mask for
        every held participant."""
        alive = torch.as_tensor(alive, device=self.device).to(torch.bool)
        if alive.dim() == 1:
            alive = alive.expand(self.n_local, self.P)
        return alive.reshape(self.n_local, self.P)

    def _node(self, node):
        return torch.as_tensor(node, device=self.device).to(torch.int64) \
            .expand(self.n_local)

    def _any(self, *xs):
        """The reference's ``psum(x) > 0`` over participants of each of
        ``xs``, (n,) each, on the device (one collective between ranks)."""
        return self.rt.world_any(*xs)

    # -- epoch/leadership accessors (§12.1) ------------------------------------
    def epoch(self, st: ReplicatedLogState):
        """(n,) cluster epoch: max accepted epoch of each cached table."""
        return self.ptable.rows(st.ptable)[..., 0].max(-1).values

    def current_leader(self, st: ReplicatedLogState):
        """The ring-owning participant (client-redirect target), (n,)."""
        return st.ring.owner

    # -- liveness (DESIGN.md §13.1) --------------------------------------------
    def heartbeat(self, st: ReplicatedLogState, pred=True):
        """Bump my heartbeat counter (and refresh my cursor column) and push
        the row; ``pred`` ((P,) or a bool) is the physical liveness: a dead
        participant's row stops moving."""
        mine = self._my_row(st)
        my_row = torch.stack([mine[:, 0], self._my_cursor(st.ring),
                              (mine[:, 2] + 1) & MASK32], dim=-1)
        pt = self.ptable.store_mine(st.ptable, my_row, pred=pred)
        pt, _ack = self.ptable.push_broadcast(pt)
        return st._replace(ptable=pt)

    def heartbeat_and_detect(self, st: ReplicatedLogState, det_st, detector,
                             pred=True):
        """One liveness window: bump, then observe the gathered heartbeat
        column, and evict detected-dead participants from ring flow control.
        Returns (state, detector_state, alive (n, P))."""
        st = self.heartbeat(st, pred=pred)
        det_st, alive = detector.observe(
            det_st, self.ptable.rows(st.ptable)[..., 2])
        ring = st.ring._replace(alive=st.ring.alive & alive)
        return st._replace(ring=ring), det_st, alive

    def readmit(self, st: ReplicatedLogState, node):
        """Re-admit revived ``node`` whose gap still fits the ring: back in
        flow control, its fence row refreshed to the cluster epoch with a
        fresh heartbeat; ring-tail replay (:meth:`sync`) catches it up."""
        me = self.my_id()
        node = self._node(node)
        mine = self._my_row(st)
        my_row = torch.stack([self.epoch(st), self._my_cursor(st.ring),
                              (mine[:, 2] + 1) & MASK32], dim=-1)
        pt = self.ptable.store_mine(st.ptable, my_row, pred=me == node)
        pt, _ack = self.ptable.push_broadcast(pt)
        alive = st.ring.alive.clone()
        alive[self.local_ids(), node] = True
        return st._replace(ring=st.ring._replace(alive=alive), ptable=pt)

    # -- leader side -----------------------------------------------------------
    def _block(self, ops, keys, values, targets):
        """The window's records gathered into one ring entry per
        participant (the reference's ``all_gather`` of the (B, rw)
        records): ((n, 1, entry_width) int32, (n, 1) live-record count)."""
        recs = self.rt.gather(self.store.export_window_records(
            ops, keys, values, targets=targets))           # (P, B, rw)
        n = self.n_local
        block = recs.reshape(1, 1, self.entry_width).expand(n, 1, -1)
        n_live = (recs[..., 0] != 0).sum().to(torch.int32)
        return block, n_live.expand(n, 1)

    def append(self, st: ReplicatedLogState, ops, keys, values,
               targets=None, pred=True):
        """Publish one (n, B) mutation window to the log as ONE ring entry
        stamped with the leader's accepted epoch.  A leader whose cached
        table already shows a higher epoch has been deposed and suppresses
        the publish (``fenced_writes``).  Returns (state, ok (n,)): False
        everywhere when the ring had no space or the publish was
        suppressed; the drop is counted."""
        dev = self.device
        me = self.my_id()
        my_epoch = self._my_row(st)[:, 0]
        deposed = self.epoch(st) > my_epoch
        pred = torch.as_tensor(pred, device=dev).to(torch.bool) \
            .expand(self.n_local)
        do = pred & ~deposed
        block, n_live = self._block(ops, keys, values, targets)
        ring, sent, _ack = self.ring.publish_window(
            st.ring, block, n_live, preds=do[:, None], epoch=my_epoch)
        is_owner = me == st.ring.owner
        ok, tried, fenced_w = self._any(sent[:, 0], do & is_owner,
                                        pred & deposed & is_owner)
        return st._replace(
            ring=ring,
            published=(st.published + ok.to(torch.int64)) & MASK32,
            dropped=(st.dropped + (tried & ~ok).to(torch.int64)) & MASK32,
            fenced_writes=(st.fenced_writes + fenced_w.to(torch.int64))
            & MASK32), ok

    def append_with_retry(self, st: ReplicatedLogState, ops, keys, values,
                          followers, follower_states, targets=None,
                          max_attempts: int = 3, pred=True, sync_pred=True):
        """:meth:`append` with a deterministic bounded exponential backoff:
        a failed attempt i is followed by ``min(2**i, capacity)`` sync
        windows before re-appending, and a final drain sync follows the last
        attempt.  Every attempt's round-set is issued, as in the reference's
        static trace.  Returns (state, follower_states, ok, applied)."""
        single = isinstance(followers, KVStore)
        fls = [followers] if single else list(followers)
        fsts = [follower_states] if single else list(follower_states)
        n, dev = self.n_local, self.device
        pred = torch.as_tensor(pred, device=dev).to(torch.bool).expand(n)
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        applied = torch.zeros((n,), dtype=torch.int32, device=dev)
        for i in range(int(max_attempts)):
            pending = pred & ~done
            if i:
                st = st._replace(retries=(st.retries + pending.to(
                    torch.int64)) & MASK32)
            st, ok = self.append(st, ops, keys, values, targets=targets,
                                 pred=pending)
            stage = min(i, RETRY_STAGES - 1)
            rba = st.retries_by_attempt.clone()
            rba[:, stage] = (rba[:, stage] + (ok & pending).to(torch.int64)) \
                & MASK32
            st = st._replace(retries_by_attempt=rba)
            done = done | ok
            if i < int(max_attempts) - 1:
                for _ in range(min(2 ** i, self.ring.capacity)):
                    st, out, n = self.sync(st, fls, fsts, max_entries=1,
                                           pred=sync_pred)
                    fsts = list(out)
                    applied = applied + n
        st, out, n = self.sync(st, fls, fsts, max_entries=1, pred=sync_pred)
        fsts = list(out)
        applied = applied + n
        return st, (fsts[0] if single else tuple(fsts)), done, applied

    def zombie_publish(self, st: ReplicatedLogState, ops, keys, values, *,
                       zombie, stale_epoch, targets=None):
        """A deposed leader's delayed publish landing after promotion: the
        entry is stamped ``stale_epoch`` and lands in every consumer's
        cached slots (one-sided writes ask no permission); followers whose
        accepted epoch moved on fence it at delivery.  Returns (state,
        landed (n,))."""
        block, n_live = self._block(ops, keys, values, targets)
        ring_z = st.ring._replace(owner=torch.full(
            (self.n_local,), int(zombie), dtype=torch.int32,
            device=self.device))
        ring_z, sent, _ack = self.ring.publish_window(
            ring_z, block, n_live, epoch=int(stale_epoch) & MASK32)
        landed = self._any(sent[:, 0])
        return st._replace(ring=ring_z._replace(owner=st.ring.owner)), landed

    # -- follower side ---------------------------------------------------------
    def sync(self, st: ReplicatedLogState, followers, follower_states,
             max_entries: int = 1, pred=True):
        """Drain up to ``max_entries`` entries and replay each into every
        follower store, in log order; entries of an epoch older than my
        accepted one are fenced (consumed, not replayed, counted).  ``pred``
        masks crashed consumers.  Returns (state, follower_states, applied
        (n,))."""
        single = isinstance(followers, KVStore)
        fls = [followers] if single else list(followers)
        fsts = [follower_states] if single else list(follower_states)
        n, P = self.n_local, self.P
        loc, me = self.local_ids(), self.my_id()
        my_epoch = self._my_row(st)[:, 0]
        ring, entries, _lens, got, fenced = self.ring.recv_window(
            st.ring, max_entries, pred=pred, expect_epoch=my_epoch)
        for k in range(max_entries):
            block = entries[:, k].reshape(n, P, self.window, self.rec_width)
            mine = block[loc, me]                   # my (B, rw) lane slice
            for i, fl in enumerate(fls):
                fsts[i], _res = fl.replay_window_records(fsts[i], mine,
                                                         pred=got[:, k])
        applied = got.sum(1, dtype=torch.int32)
        n_fenced = self.rt.pmax(fenced.sum(1)).expand(n)
        out_states = fsts[0] if single else tuple(fsts)
        return st._replace(ring=ring,
                           fenced=(st.fenced + n_fenced) & MASK32), \
            out_states, applied

    # -- failover (DESIGN.md §12.2, restartable per §13.2) ---------------------
    def _election(self, st: ReplicatedLogState, alive):
        """(winner, cur_epoch), each (n,): the highest applied cursor among
        the living (lowest rank breaks ties) and the max live epoch, from
        each held participant's gathered ptable."""
        rows = self.ptable.rows(st.ptable)
        epochs_g, cursors_g = rows[..., 0], rows[..., 1]
        zero = torch.zeros_like(cursors_g)
        best = torch.where(alive, cursors_g, zero).max(-1).values
        winner = (alive & (cursors_g == best[:, None])).to(torch.uint8) \
            .argmax(-1).to(torch.int32)
        cur_epoch = torch.where(alive, epochs_g, zero).max(-1).values
        return winner, cur_epoch

    def _true_head(self, st: ReplicatedLogState):
        """The log's high-water mark, robust to a crashed re-publish: the
        latest of the ring head and every recorded fence head."""
        fh = st.fence_heads
        recorded = torch.where(fh != _U32_MAX, fh,
                               torch.zeros_like(fh)).max(-1).values
        return torch.maximum(st.ring.head, recorded)

    def promote_gather(self, st: ReplicatedLogState, alive):
        """Promotion step 1: every live participant refreshes and pushes its
        ``[epoch, cursor, heartbeat]`` row."""
        alive = self._alive(alive)
        mine = self._my_row(st)
        pt = self.ptable.store_mine(
            st.ptable, torch.stack([mine[:, 0], self._my_cursor(st.ring),
                                    mine[:, 2]], dim=-1),
            pred=alive[self.local_ids(), self.my_id()])
        pt, _ack = self.ptable.push_broadcast(pt)
        return st._replace(ptable=pt)

    def promote_fence(self, st: ReplicatedLogState, alive):
        """Promotion step 2: every live participant accepts
        ``cur_epoch + 1`` before any ring mutation, and the log head is
        recorded durably for the new epoch in ``fence_heads``."""
        loc, me = self.local_ids(), self.my_id()
        alive = self._alive(alive)
        _winner, cur_epoch = self._election(st, alive)
        new_epoch = (cur_epoch + 1) & MASK32
        fh_idx = new_epoch.clamp(max=MAX_EPOCHS - 1)
        fence_heads = st.fence_heads.clone()
        fence_heads[loc, fh_idx] = self._true_head(st)
        mine = self._my_row(st)
        pt = self.ptable.store_mine(
            st.ptable, torch.stack([new_epoch, self._my_cursor(st.ring),
                                    mine[:, 2]], dim=-1),
            pred=alive[loc, me])
        pt, _ack = self.ptable.push_broadcast(pt)
        return st._replace(ptable=pt, fence_heads=fence_heads)

    def promote_republish(self, st: ReplicatedLogState, alive, limit=None):
        """Promotion step 3: the winner re-owns the ring at the slowest live
        cursor and re-publishes the unacked suffix from its cached slots.
        A slot stamped ``e`` is re-stamped to the new epoch iff
        ``seq < fence_heads[e + 1]`` (the fence-head rule); zombie residue
        keeps its stale stamp and stays fenced.  ``limit`` re-publishes only
        the first ``limit`` suffix lanes (the winner dying mid-re-publish).
        Returns (state, winner (n,))."""
        cap = self.ring.capacity
        loc = self.local_ids()
        alive = self._alive(alive)
        winner, new_epoch = self._election(st, alive)
        old = st.ring
        true_head = self._true_head(st)
        cursors = self.ring.acks.rows(old.acks)
        min_live = torch.where(alive, cursors,
                               torch.full_like(cursors, _U32_MAX)) \
            .min(-1).values
        suffix = (true_head - min_live) & MASK32
        ring = self.ring.re_own(old, winner, alive, head=min_live)
        k = torch.arange(cap, dtype=torch.int64, device=self.device)
        seqs = (min_live[:, None] + k) & MASK32
        slots = seqs % cap
        stamps = old.epoch[loc[:, None], slots]
        fh_next = st.fence_heads[
            loc[:, None], ((stamps + 1) & MASK32).clamp(max=MAX_EPOCHS - 1)]
        legit = seqs < fh_next
        lane_ep = torch.where(legit, new_epoch[:, None], stamps)
        preds = k[None, :] < suffix[:, None]
        if limit is not None:
            preds = preds & (k[None, :] < int(limit))
        ring, _sent, _ack = self.ring.publish_window(
            ring, old.payload[loc[:, None], slots],
            old.length[loc[:, None], slots], preds=preds, epoch=lane_ep)
        return st._replace(
            ring=ring, failovers=(st.failovers + 1) & MASK32), winner

    def promote(self, st: ReplicatedLogState, alive):
        """Elect and install a replacement leader after a crash: ``alive``
        ((P,) or (n, P) bool) marks the crashed participants False.  Returns
        (state, winner (n,))."""
        alive = self._alive(alive)
        st = self.promote_gather(st, alive)
        st = self.promote_fence(st, alive)
        return self.promote_republish(st, alive)

    # -- follower rejoin (DESIGN.md §13.3) -------------------------------------
    def _snap_flatten(self, fstate: KVStoreState):
        """The replicated leaves (local policy skipped) as one (n, total)
        uint32 word stream in the reference's leaf order, bit-pattern
        preserving (:func:`~.u32.to_words`)."""
        words = [i2u(to_words(leaf))
                 for name, field in zip(fstate._fields, fstate)
                 if name not in _LOCAL_POLICY_FIELDS
                 for leaf in _leaves(field)]
        if not words:
            return torch.zeros((self.n_local, 0), dtype=torch.int64,
                               device=self.device)
        return torch.cat(words, dim=1)

    def _snap_unflatten(self, fstate: KVStoreState, words):
        """``fstate`` with its replicated leaves rebuilt from (n, total)
        words; local-policy fields pass through."""
        new_fields = []
        off = 0
        for name, field in zip(fstate._fields, fstate):
            if name in _LOCAL_POLICY_FIELDS:
                new_fields.append(field)
                continue
            out = []
            for leaf in _leaves(field):
                n = leaf[0].numel()
                out.append(from_words(u2i(words[:, off:off + n]), leaf))
                off += n
            new_fields.append(_unflatten(field, out)[0])
        return type(fstate)(*new_fields)

    def snapshot_words(self) -> int:
        """Per-follower word count of the §13.3 snapshot stream, from the
        store's state shapes (a state on the meta device: nothing is
        allocated)."""
        if self._snap_total is None:
            spec = self.store.init_state(device=torch.device("meta"))
            self._snap_total = sum(
                leaf[0].numel() for name, field in zip(spec._fields, spec)
                if name not in _LOCAL_POLICY_FIELDS
                for leaf in _leaves(field))
        return self._snap_total

    def _snap_chunks(self):
        """(total_words, n_chunks) of one snapshot stream."""
        total = max(self.snapshot_words(), 1)
        return total, -(-total // self.rejoin_chunk)

    def needs_snapshot(self, st: ReplicatedLogState, node):
        """(n,) True iff revived ``node``'s cursor gap exceeds the ring
        capacity, so ring-tail replay cannot catch it up."""
        node = self._node(node)
        gap = (st.ring.head - self.ring.acks.rows(st.ring.acks)[
            self.local_ids(), node]) & MASK32
        return gap > self.ring.capacity

    def rejoin_init(self) -> RejoinState:
        """Fresh transfer-progress state for one rejoining node's snapshot
        (staging padded to whole chunks)."""
        n, dev = self.n_local, self.device
        _total, n_chunks = self._snap_chunks()
        z = torch.zeros((n,), dtype=torch.int64, device=dev)
        f = torch.zeros((n,), dtype=torch.bool, device=dev)
        return RejoinState(
            staged=torch.zeros((n, n_chunks * self.rejoin_chunk),
                               dtype=torch.int64, device=dev),
            cursor=torch.zeros((n,), dtype=torch.int32, device=dev),
            active=f, base_cursor=z, base_epoch=z.clone(),
            restarts=z.clone(), done=f.clone())

    def rejoin_step(self, st: ReplicatedLogState, rst: RejoinState,
                    leader_state: KVStoreState, followers, follower_states,
                    node):
        """One §13.3 snapshot-transfer window; call until ``rst.done``.

        The revived ``node`` pulls one ``rejoin_chunk``-word chunk of its
        lane of the flattened leader image through the backend's
        ``read_batch``, with three stamp words: the chunk's checksum, the
        log head the image matches (its version) and the epoch, the stamps
        read from the current leader.  A chunk is accepted iff its checksum
        validates and both stamps equal those staged when the transfer
        began; a stamp change restarts the staging, a checksum failure
        retries the chunk.  On the final chunk the image is installed into
        the node's lane of every follower, its cursor restored, its fence
        row refreshed, and it re-enters flow control.  Returns (state,
        rejoin_state, follower_states)."""
        single = isinstance(followers, KVStore)
        fls = [followers] if single else list(followers)
        fsts = [follower_states] if single else list(follower_states)
        n, dev = self.n_local, self.device
        loc, me = self.local_ids(), self.my_id()
        node = self._node(node)
        chunk = self.rejoin_chunk
        total, n_chunks = self._snap_chunks()
        padded_total = n_chunks * chunk

        # every lane lays out its serve buffer from ITS lane of the leader
        # store: [image words | per-chunk csums | version | epoch]
        words = self._snap_flatten(leader_state)
        padded = torch.zeros((n, padded_total), dtype=torch.int64,
                             device=dev)
        padded[:, :words.shape[1]] = words
        csums = checksum(padded.reshape(n, n_chunks, chunk))
        src = torch.cat([padded, csums, torch.stack(
            [st.ring.head, self.epoch(st)], dim=-1)], dim=1)

        leader = st.ring.owner.to(torch.int64)
        version = st.ring.head
        cur_epoch = self.epoch(st)
        fresh = ~rst.active
        base_cursor = torch.where(fresh, version, rst.base_cursor)
        base_epoch = torch.where(fresh, cur_epoch, rst.base_epoch)
        c = torch.where(fresh, torch.zeros_like(rst.cursor),
                        rst.cursor).to(torch.int64)

        # one chunked window: the rejoiner reads chunk c + stamps, then
        # shares what it saw
        idx = torch.cat([
            c[:, None] * chunk + torch.arange(chunk, device=dev),
            torch.stack([padded_total + c,
                         torch.full_like(c, padded_total + n_chunks),
                         torch.full_like(c, padded_total + n_chunks + 1)],
                        dim=-1)], dim=1)
        tgt = torch.cat([node[:, None].expand(n, chunk + 1),
                         leader[:, None].expand(n, 2)], dim=1)
        # the reference reads a uint32 buffer: the wire moves its 4-byte bits
        got = self.backend.read_batch(
            u2i(src), tgt, idx,
            preds=(me == node)[:, None].expand(n, chunk + 3),
            ledger=self.mgr.traffic, verb=f"{self.full_name}.rejoin",
            rt=self.rt)
        got = colls.bcast_from(i2u(got), node, self.rt)
        data, r_csum = got[:, :chunk], got[:, chunk]
        r_version, r_epoch = got[:, chunk + 1], got[:, chunk + 2]

        stamps_ok = (r_version == base_cursor) & (r_epoch == base_epoch)
        csum_ok = checksum(data) == r_csum
        if self.mgr.traffic.enabled:
            self.ring._record_lead((self.mgr.traffic.record_corrupt,
                                    f"{self.full_name}.rejoin",
                                    stamps_ok & ~csum_ok))
        advance = stamps_ok & csum_ok & ~rst.done
        restart = ~stamps_ok & ~fresh & ~rst.done

        start = (c * chunk).clamp(0, padded_total - chunk)
        cols = start[:, None] + torch.arange(chunk, device=dev)
        staged = rst.staged.clone()
        staged.scatter_(1, cols, torch.where(advance[:, None], data,
                                             rst.staged.gather(1, cols)))
        c_next = torch.where(restart, torch.zeros_like(c),
                             c + advance.to(torch.int64)).to(torch.int32)
        done_now = advance & (c + 1 == n_chunks)

        # fused install on the finishing round: follower leaves, ring
        # cursor, fence row + heartbeat, flow-control membership
        install = done_now & (me == node)
        for i in range(len(fls)):
            new_fst = self._snap_unflatten(fsts[i], staged[:, :total])
            fsts[i] = type(fsts[i])(*_select(install, new_fst, fsts[i]))
        acks = self.ring.acks.store_mine(st.ring.acks, base_cursor,
                                         pred=install)
        acks, _ack = self.ring.acks.push_broadcast(acks)
        mine = self._my_row(st)
        my_row = torch.stack([base_epoch, base_cursor,
                              (mine[:, 2] + 1) & MASK32], dim=-1)
        pt = self.ptable.store_mine(st.ptable, my_row, pred=install)
        pt, _ack = self.ptable.push_broadcast(pt)
        readmitted = st.ring.alive.clone()
        readmitted[loc, node] = True
        ring_alive = torch.where(done_now[:, None], readmitted,
                                 st.ring.alive)
        st = st._replace(ring=st.ring._replace(acks=acks, alive=ring_alive),
                         ptable=pt)
        rst = RejoinState(
            staged=staged,
            cursor=c_next,
            active=(rst.active | ~rst.done) & ~done_now,
            base_cursor=torch.where(restart, version, base_cursor),
            base_epoch=torch.where(restart, cur_epoch, base_epoch),
            restarts=(rst.restarts + restart.to(torch.int64)) & MASK32,
            done=rst.done | done_now)
        return st, rst, (fsts[0] if single else tuple(fsts))

    # -- progress --------------------------------------------------------------
    def lag(self, st: ReplicatedLogState):
        """(n,) int32 entries the slowest live follower is behind the head."""
        return u2i((st.ring.head - self.ring.min_ack(st.ring)) & MASK32)

    def entry_nbytes(self) -> int:
        """Wire bytes of one full log entry (the ring's slot size)."""
        return self.ring.slot_nbytes


def _select(pred, new, old):
    """Field by field, ``where(pred[p], new, old)`` over the stacked leaves
    of two NamedTuple states."""
    out = []
    for a, b in zip(new, old):
        if isinstance(a, tuple):
            out.append(type(a)(*_select(pred, a, b)))
        else:
            out.append(torch.where(
                pred.reshape((-1,) + (1,) * (a.dim() - 1)), a, b))
    return out
