"""ServingEngine: continuous batching on LOCO channels, the counterpart of
``repro/serving/engine.py``.

The engine's KV-cache page table is a :class:`~repro_torch.core.KVStore`:

* request admission INSERTs (request_id, page_no) → (slot, page) entries
  under the striped ticket locks, each page homed (``placement="explicit"``)
  on the node whose decode lane re-reads it every round (§10.1);
* every decode round looks up the active requests' pages with lock-free
  ``get_batch`` reads through the store's read tier (§8), which serves the
  repeats from its counter-validated page cache;
* completion DELETEs the pages.

Requests are admitted through a :class:`~repro_torch.core.queue.SharedQueue`.
The model is any family :func:`repro_torch.models.build_model` builds — a
dense LM, recurrentgemma (hybrid), rwkv6 (ssm), llama4-maverick or
deepseek-v3 (moe), llama-3.2-vision (vlm) or whisper (audio) — and the
engine is family-agnostic, as the reference's is: it hands the model's
prefill caches back to its decode step.  A vlm or audio model gets, at each
prefill, the reference's stand-in for its frontend: a zero context of
``(max_batch, n_context_tokens, d_model)`` in the model dtype.  On the card
prefill and decode run the port's kernels (attention, RG-LRU, WKV6, the
grouped matmul).  The P participants are the port's
stacked binding on one device.

With ``replicas=N`` the engine keeps N follower copies of the page table fed
by a :class:`~repro_torch.core.ReplicatedLog` (DESIGN.md §9.3): every
mutation window is published to the log after it commits on the leader and
replayed into each follower, so the followers stay bitwise converged
(``replica_divergence()``, ``stats()["replication"]``).  A ``fault_plan``
(:class:`~repro_torch.distributed.FaultPlan`) kills and revives participants
at mutation windows; a :class:`~repro_torch.core.FailureDetector` on the
log's heartbeat column reaches the death verdict, the log promotes a new
leader, the windows buffered meanwhile are flushed through it, and a revived
participant rejoins by ring-tail replay or snapshot transfer (§12–§13).
``backend`` picks the execution protocol of every engine channel (§14); on
``"pallas"`` the page table's windows run the remote-DMA kernels and the log's
ring broadcast runs the remote-copy kernel.

As in the reference, prompts of a batch are left-padded with token 0 and run
with no padding mask; the port reproduces that.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import (DELETE, GET, INSERT, NOP, FailureDetector, KVStore,
                    ReplicatedLog, diverging_leaves, make_manager)
from ..core.queue import SharedQueue
from ..core.runtime import resolve_device
from ..distributed.fault import FaultPlan
from ..models import build_model

# int32 words of one page-table row: value_width=2 payload + 3 metadata
_ROW_NBYTES = (2 + 3) * 4

PAGE = 128          # tokens per logical page
P_NODES = 4         # simulated serving nodes (channel participants)
MAX_WINDOW = 32     # max KV ops per participant per collective round-set


class ServingEngine:
    def __init__(self, cfg: ArchConfig, max_batch: int = 4,
                 max_seq: int = 256, replicas: int = 0,
                 fault_plan: FaultPlan | None = None,
                 detect_threshold: int = 2, backend=None, params=None,
                 device=None):
        """``params``: the model's weights (default: drawn on ``device`` from
        a ``torch.Generator`` seeded with 0, as the reference draws them
        from ``PRNGKey(0)``); ``device`` defaults to the card."""
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.replicas = int(replicas)
        if fault_plan is not None and not self.replicas:
            raise ValueError("fault_plan requires replicas >= 1: a leader "
                             "crash without a replicated page table loses "
                             "the serving state it would fail over to")
        self.fault_plan = fault_plan
        self.detect_threshold = int(detect_threshold)
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = self.model.init(gen)
        self.params = params
        self.mgr = make_manager(P_NODES, device=self.device, backend=backend)
        self.backend = self.mgr.backend
        self._row_read_bytes = self.backend.row_read_bytes(_ROW_NBYTES)
        pages_per_node = max(
            8, max_batch * (max_seq // PAGE + 1) * 2 // P_NODES)
        # lock stripe sized to the outstanding (P_NODES, MAX_WINDOW) window;
        # page cache sized to hold every provisioned page; explicit
        # placement homes each request's pages on its decode reader
        self.pages = KVStore(None, "pagetable", self.mgr,
                             slots_per_node=pages_per_node, value_width=2,
                             num_locks=P_NODES * MAX_WINDOW,
                             index_capacity=4 * pages_per_node * P_NODES,
                             cache_slots=2 * pages_per_node * P_NODES,
                             placement="explicit")
        self.queue = SharedQueue(None, "admission", self.mgr,
                                 slots_per_node=64, width=1)
        self._kv_state = self.pages.init_state()
        self._q_state = self.queue.init_state()
        if self.replicas:
            self._init_replication(pages_per_node)
        self._prefill = self.model.prefill
        self._decode = self.model.decode_step
        self.op_counts = collections.Counter()
        # locality bookkeeping (§10.1): per page key, (explicit home,
        # writer-local home); bytes saved count one avoided remote read per
        # inserted page
        self.loc_counts = collections.Counter()
        self._page_home: Dict[int, tuple] = {}
        self._saved_keys: set = set()

    # -- §9.3/§12/§13 replication -----------------------------------------------
    def _init_replication(self, pages_per_node):
        """Follower page tables fed by a ReplicatedLog of the leader's
        mutation windows, and the heartbeat failure detector.  Followers are
        cache-less (the read cache is local policy, not replicated data).
        The ring covers the detection gap: up to ``detect_threshold`` windows
        buffered while the leader is dead but undetected, plus one in
        flight."""
        self.page_log = ReplicatedLog(
            None, "pagelog", self.mgr, store=self.pages, window=MAX_WINDOW,
            capacity=max(2, self.detect_threshold + 1))
        self.replica_tables = [
            KVStore(None, f"pagetable_replica{i}", self.mgr,
                    slots_per_node=pages_per_node, value_width=2,
                    num_locks=P_NODES * MAX_WINDOW,
                    index_capacity=4 * pages_per_node * P_NODES,
                    placement="explicit")
            for i in range(self.replicas)]
        self._log_state = self.page_log.init_state()
        self._rep_states = tuple(t.init_state() for t in self.replica_tables)
        self.detector = FailureDetector(None, "pagedetector", self.mgr,
                                        threshold=self.detect_threshold)
        self._det_state = self.detector.init_state()
        self.rep_counts = collections.Counter()
        self._alive = np.ones(P_NODES, bool)       # physical (the plan)
        self._det_alive = np.ones(P_NODES, bool)   # the detector's verdict
        self._log_leader = self.page_log.leader
        self._pending: List[tuple] = []            # unpublished windows
        # node → detector window clock at its death verdict (kept across
        # readmissions)
        self._detections: Dict[int, int] = {}

    def _alive_t(self):
        return torch.from_numpy(self._alive.copy()).to(self.device)

    def _publish_window(self, pw, pk, pv, pt):
        """Append one padded mutation window to the log and sync the
        followers.  The append is predicated on the CURRENT owner being
        alive (after a promotion it goes through the new leader), with the
        bounded-backoff retry; dead lanes stop draining their replica
        copies.  A failed append is buffered, not dropped — the leader page
        table already applied it — and flushed after the next promotion."""
        alive = self._alive_t()
        (self._log_state, self._rep_states, ok,
         applied) = self.page_log.append_with_retry(
            self._log_state, pw, pk, pv, self.replica_tables,
            self._rep_states, targets=pt, max_attempts=2,
            pred=alive[self._log_state.ring.owner.long()], sync_pred=alive)
        lag = self.page_log.lag(self._log_state)
        ok, applied, lag = (int(x) for x in torch.stack(
            [ok[0].to(torch.int64), applied[0].to(torch.int64),
             lag[0].to(torch.int64)]).tolist())
        if ok:
            self.rep_counts["published"] += 1
            self.rep_counts["applied"] += applied
            self.rep_counts["wire_bytes"] += self.page_log.entry_nbytes()
        else:
            self._pending.append((pw, pk, pv, pt))
            self.rep_counts["buffered"] += 1
        self.rep_counts["lag"] = lag
        return bool(ok)

    def _flush_pending(self):
        """Re-publish the windows buffered during a detection gap, in
        submission order, through the (new) leader."""
        pending, self._pending = self._pending, []
        for win in pending:
            if self._publish_window(*win):
                self.rep_counts["flushed"] += 1

    def _handle_revive(self, p: int):
        """§13.3 rejoin of revived participant ``p``: a snapshot transfer
        of the leader image, chunk by chunk, when its cursor gap exceeds the
        ring, else a plain readmission and ring-tail replay.  The detector
        readmits last."""
        self._alive[p] = True
        self._flush_pending()   # the image's version must match the log head
        node = torch.full((P_NODES,), p, dtype=torch.int64,
                          device=self.device)
        if bool(self.page_log.needs_snapshot(self._log_state, node)[0]):
            rst = self.page_log.rejoin_init()
            chunks = 0
            while not bool(rst.done[0]):
                self._log_state, rst, f_sts = self.page_log.rejoin_step(
                    self._log_state, rst, self._kv_state,
                    self.replica_tables, self._rep_states, node)
                self._rep_states = tuple(f_sts)
                chunks += 1
            self.rep_counts["rejoin_chunks"] += chunks
            self.rep_counts["rejoin_restarts"] += int(rst.restarts[0])
            self.rep_counts["rejoins_snapshot"] += 1
        else:
            self._log_state = self.page_log.readmit(self._log_state, node)
            self.rep_counts["rejoins_replay"] += 1
        self._det_state = self.detector.readmit(self._det_state, p)
        self._det_alive[p] = True

    def _replicate(self, op, key, val, tgt, w):
        """The §13 window protocol after a mutation window committed on the
        leader: (1) heartbeat + observe — the detector, not the plan, decides
        who is dead; (2) when the verdict covers the log leader, promote
        among the verdict-alive and flush the buffered windows; (3) publish
        this window, padded to the log's MAX_WINDOW entry (padding lanes are
        NOPs, the replay identity)."""
        self._log_state, self._det_state, verdict = \
            self.page_log.heartbeat_and_detect(
                self._log_state, self._det_state, self.detector,
                pred=self._alive_t())
        new_verdict = verdict[0].cpu().numpy().copy()
        clock = int(self._det_state.windows[0])
        for p in np.where(self._det_alive & ~new_verdict)[0]:
            self._detections[int(p)] = clock
        self._det_alive = new_verdict
        if not self._det_alive[self._log_leader]:
            self._log_state, winner = self.page_log.promote(
                self._log_state, torch.from_numpy(self._det_alive.copy())
                .to(self.device))
            self._log_leader = int(winner[0])
            self.rep_counts["detected_failovers"] += 1
            self._flush_pending()
        pw = np.full((P_NODES, MAX_WINDOW), NOP, np.int32)
        pk = np.ones((P_NODES, MAX_WINDOW), np.uint32)
        pv = np.zeros((P_NODES, MAX_WINDOW, 2), np.int32)
        pt = np.zeros((P_NODES, MAX_WINDOW), np.int32)
        pw[:, :w], pk[:, :w], pv[:, :w], pt[:, :w] = op, key, val, tgt
        self.rep_counts["windows"] += 1
        self._publish_window(pw, pk, pv, pt)

    # -- channel helpers (windowed round-sets over the P simulated nodes) ---
    def _kv_ops(self, ops: List[tuple]):
        """ops: list of (op_code, key, (v0, v1), home), executed as (P, B)
        windows: op i → (live participant i % n_live, window slot
        i // n_live), B padded to a power of two (≤ MAX_WINDOW); a dead
        participant accepts no requests, so its slice stays NOP.  Ops in one
        call must not conflict (admission and eviction batch distinct page
        keys).  With replicas, each mutation window first applies the fault
        plan's injections and then runs the replication protocol."""
        results = []
        faulty = self.replicas and self.fault_plan is not None
        for start in range(0, len(ops), P_NODES * MAX_WINDOW):
            chunk = ops[start:start + P_NODES * MAX_WINDOW]
            mutating = any(c[0] != NOP for c in chunk)
            if faulty and mutating:
                # kills silence the victim (heartbeats, RPCs); revives run
                # the rejoin; detection stays with the detector
                w_idx = self.rep_counts["windows"]
                for p in self.fault_plan.newly_dead(w_idx):
                    self._alive[p] = False
                for p in self.fault_plan.newly_alive(w_idx):
                    self._handle_revive(p)
            live = np.where(self._alive)[0] if faulty \
                else np.arange(P_NODES)
            nl = len(live)
            w = -(-len(chunk) // nl)
            w = 1 << (w - 1).bit_length()
            n = nl * w
            chunkp = chunk + [(NOP, 1, (0, 0), 0)] * (n - len(chunk))
            # (n,) submission order → (nl, w) live-participant-major windows
            # in the (P, w) layout, dead lanes NOP
            op = np.full((P_NODES, w), NOP, np.int32)
            key = np.ones((P_NODES, w), np.uint32)
            val = np.zeros((P_NODES, w, 2), np.int32)
            tgt = np.zeros((P_NODES, w), np.int32)
            op[live] = np.asarray([c[0] for c in chunkp],
                                  np.int32).reshape(w, nl).T
            key[live] = np.asarray([c[1] for c in chunkp],
                                   np.uint32).reshape(w, nl).T
            val[live] = np.asarray([c[2] for c in chunkp], np.int32) \
                .reshape(w, nl, 2).transpose(1, 0, 2)
            tgt[live] = np.asarray([c[3] for c in chunkp],
                                   np.int32).reshape(w, nl).T
            self._kv_state, res = self.pages.op_window(
                self._kv_state, op, key, val, targets=tgt)
            if self.replicas and mutating:
                self._replicate(op, key, val, tgt, w)
            for c in chunk:
                self.op_counts[c[0]] += 1
            found = res.found.cpu().numpy()[live].T.reshape(n)
            value = res.value.cpu().numpy()[live].transpose(1, 0, 2) \
                .reshape(n, -1)
            # a failed INSERT placed nothing and registers no home
            for j, c in enumerate(chunk):
                if c[0] == INSERT and found[j]:
                    self._page_home[c[1]] = (c[3], int(live[j % nl]))
                    self._saved_keys.discard(c[1])
                elif c[0] == DELETE:
                    self._page_home.pop(c[1], None)
                    self._saved_keys.discard(c[1])
            results.extend(zip(found, value))
        return results[:len(ops)]

    def _kv_reads(self, keys: List[int]):
        """Lock-free page lookups: one ``get_batch`` per (P, B) chunk, real
        lanes enabled by ``pred`` and padding lanes disabled."""
        results = []
        for start in range(0, len(keys), P_NODES * MAX_WINDOW):
            chunk = keys[start:start + P_NODES * MAX_WINDOW]
            for j, k in enumerate(chunk):
                homes = self._page_home.get(k)
                if homes is None:
                    continue
                reader = j % P_NODES
                local = homes[0] == reader
                self.loc_counts["local_reads" if local
                                else "remote_reads"] += 1
                if local and homes[1] != reader and k not in self._saved_keys:
                    self.loc_counts["modeled_bytes_saved"] += \
                        self._row_read_bytes
                    self._saved_keys.add(k)
            w = -(-len(chunk) // P_NODES)
            w = 1 << (w - 1).bit_length()
            n = P_NODES * w
            kk = np.ones(n, np.uint32)
            kk[:len(chunk)] = chunk
            pred = np.zeros(n, bool)
            pred[:len(chunk)] = True
            self._kv_state, vals, found = self.pages.get_batch(
                self._kv_state, kk.reshape(w, P_NODES).T.copy(),
                pred=torch.from_numpy(pred.reshape(w, P_NODES).T.copy()))
            self.op_counts[GET] += len(chunk)
            found = found.cpu().numpy().T.reshape(n)
            vals = vals.cpu().numpy().transpose(1, 0, 2).reshape(n, -1)
            results.extend(zip(found, vals))
        return results[:len(keys)]

    def _q_step(self, val, enq_want, deq_want):
        """One admission round: every participant may enqueue one request
        id, then the dequeue lanes pop."""
        st, _eok = self.queue.enqueue(self._q_state, val, want=enq_want)
        self._q_state, v, ok = self.queue.dequeue(st, want=deq_want)
        return v, ok

    @staticmethod
    def _page_key(request_id: int, page_no: int) -> int:
        return ((request_id + 1) << 8) | (page_no & 0xFF)

    # -- the serving loop ----------------------------------------------------
    def generate(self, prompts: List[np.ndarray], gen_len: int):
        """Continuous batching: admit → prefill → decode rounds → evict.
        Returns each request's ``gen_len`` greedy tokens."""
        waiting = collections.deque(enumerate(prompts))
        for i in range(0, len(prompts), P_NODES):
            ids = [rid for rid, _ in list(waiting)[i:i + P_NODES]]
            ids += [-1] * (P_NODES - len(ids))
            self._q_step(torch.tensor(ids, dtype=torch.int32)[:, None],
                         torch.tensor([r >= 0 for r in ids]),
                         torch.zeros((P_NODES,), dtype=torch.bool))

        outputs: Dict[int, List[int]] = {i: [] for i in range(len(prompts))}
        active: List[tuple] = []    # (request_id, prompt)
        done = set()
        while len(done) < len(prompts):
            # ---- admit up to max_batch (dequeue from the channel)
            while len(active) < self.max_batch and waiting:
                vals, ok = self._q_step(
                    torch.zeros((P_NODES, 1), dtype=torch.int32),
                    torch.zeros((P_NODES,), dtype=torch.bool),
                    torch.tensor([True] + [False] * (P_NODES - 1)))
                if not bool(ok[0]):
                    break
                rid = int(vals[0, 0])
                _, prompt = waiting.popleft()
                slot = len(active)
                # INSERT the prompt's pages, homed on the node whose decode
                # lane re-reads them (batch slot k reads through k % P)
                n_pages = (len(prompt) + gen_len + PAGE - 1) // PAGE
                self._kv_ops([(INSERT, self._page_key(rid, p),
                               (slot, p), slot % P_NODES)
                              for p in range(n_pages)])
                active.append((rid, prompt))

            # ---- prefill the admitted batch (left-padded, no padding mask)
            plen = max(len(p) for _r, p in active)
            toks = np.zeros((self.max_batch, plen), np.int32)
            for j, (_r, p) in enumerate(active):
                toks[j, -len(p):] = p
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            if self.cfg.family in ("vlm", "audio"):
                batch["context"] = torch.zeros(
                    (self.max_batch, self.cfg.cross.n_context_tokens,
                     self.cfg.d_model), dtype=self.cfg.dtype_,
                    device=self.device)
            logits, cache, pos = self._prefill(self.params, batch,
                                               self.max_seq)
            next_tok = logits.argmax(-1).to(torch.int32)

            # ---- decode rounds for this batch; pos is plen + step at every
            # batch row, so the host tracks it without a read
            for step in range(gen_len):
                toks_now = next_tok.tolist()
                for j, (rid, _p) in enumerate(active):
                    outputs[rid].append(toks_now[j])
                page_no = (plen + step) // PAGE
                self._kv_reads([self._page_key(rid, min(page_no, 0xFF))
                                for (rid, _p) in active])
                if step == gen_len - 1:
                    break
                logits, cache = self._decode(self.params, next_tok[:, None],
                                             cache, pos, batch)
                pos = pos + 1
                next_tok = logits.argmax(-1).to(torch.int32)

            # ---- evict: DELETE the finished requests' pages
            for (rid, prompt) in active:
                n_pages = (len(prompt) + gen_len + PAGE - 1) // PAGE
                self._kv_ops([(DELETE, self._page_key(rid, p), (0, 0), 0)
                              for p in range(n_pages)])
                done.add(rid)
            active = []
        return [outputs[i] for i in range(len(prompts))]

    def replica_divergence(self):
        """Per-replica count of page-table state fields that differ from the
        leader's (:func:`~repro_torch.core.diverging_leaves`; the read cache
        is local policy), over the live lanes: a dead process's copy goes
        stale until its rejoin.  All zero ⇔ every follower is bitwise
        converged."""
        lanes = self._alive if self.fault_plan is not None else None
        return [len(diverging_leaves(self._kv_state, f_st, lanes=lanes))
                for f_st in self._rep_states]

    def _replication_stats(self):
        st, det = self._log_state, self._det_state
        lane0 = {k: v[0].tolist() for k, v in (
            ("failovers", st.failovers), ("retries", st.retries),
            ("retries_by_attempt", st.retries_by_attempt),
            ("fenced", st.fenced), ("fenced_writes", st.fenced_writes),
            ("det_alive", det.alive), ("det_windows", det.windows),
            ("detected_at", det.detected_at))}
        return {"replication": dict(self.rep_counts) | {
            "replicas": self.replicas,
            "diverged_leaves": self.replica_divergence(),
            "leader": self._log_leader,
            "epoch": int(st.ptable.cached[0, :, 0].max()),
            "failovers": lane0["failovers"],
            "retries": lane0["retries"],
            "retries_by_attempt": lane0["retries_by_attempt"],
            "fenced": lane0["fenced"],
            "fenced_writes": lane0["fenced_writes"],
            # windows never delivered to the followers: buffered windows
            # awaiting a flush (zero acked-window loss keeps it empty)
            "dropped": len(self._pending),
            "alive": self._alive.tolist(),
            "detector": {
                "threshold": self.detect_threshold,
                "alive": lane0["det_alive"],
                "windows": lane0["det_windows"],
                "detected_at": [None if v == 0xFFFFFFFF else int(v)
                                for v in lane0["detected_at"]],
                "detections": dict(self._detections)}}}

    def stats(self):
        loc_reads = self.loc_counts["local_reads"]
        rem_reads = self.loc_counts["remote_reads"]
        rep = self._replication_stats() if self.replicas else {}
        return {"kv_ops": dict(self.op_counts),
                "locality": {
                    "local_reads": loc_reads,
                    "remote_reads": rem_reads,
                    "local_fraction": (loc_reads / (loc_reads + rem_reads)
                                       if loc_reads + rem_reads else 0.0),
                    "moves": self.loc_counts["moves"],
                    "migration_backlog": int(
                        self._kv_state.heat.backlog[0]),
                    "modeled_bytes_saved":
                        self.loc_counts["modeled_bytes_saved"]},
                **rep,
                "registered_region_bytes": self.mgr.memory_ledger_bytes(),
                "modeled_wire_bytes": self.mgr.traffic_ledger_bytes(),
                "traffic_by_verb": self.mgr.traffic.summary(),
                "backend": self.backend.name,
                "modeled_rounds": self.mgr.traffic.total_rounds(),
                "rounds_by_verb": self.mgr.traffic.rounds_summary(),
                "read_cache": self.mgr.traffic.cache_summary()}
