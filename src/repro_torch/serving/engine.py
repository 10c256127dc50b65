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
dense LM, recurrentgemma (hybrid), rwkv6 (ssm) or llama4-maverick (moe) —
and the engine is family-agnostic, as the reference's is: it hands the
model's prefill caches back to its decode step.  On the card prefill and
decode run the port's kernels (attention, RG-LRU, WKV6, the grouped
matmul).  The P participants are the port's
stacked binding on one device.

Replication (``replicas``) and fault injection (``fault_plan``) wait for the
ReplicatedLog and FailureDetector (ROADMAP Queue A item 8) and are refused.
As in the reference, prompts of a batch are left-padded with token 0 and run
with no padding mask; the port reproduces that.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import DELETE, GET, INSERT, NOP, KVStore, make_manager
from ..core.queue import SharedQueue
from ..core.runtime import resolve_device
from ..models import build_model

# int32 words of one page-table row: value_width=2 payload + 3 metadata
_ROW_NBYTES = (2 + 3) * 4

PAGE = 128          # tokens per logical page
P_NODES = 4         # simulated serving nodes (channel participants)
MAX_WINDOW = 32     # max KV ops per participant per collective round-set


class ServingEngine:
    def __init__(self, cfg: ArchConfig, max_batch: int = 4,
                 max_seq: int = 256, replicas: int = 0, fault_plan=None,
                 params=None, device=None):
        """``params``: the model's weights (default: drawn on ``device`` from
        a ``torch.Generator`` seeded with 0, as the reference draws them
        from ``PRNGKey(0)``); ``device`` defaults to the card."""
        if replicas or fault_plan is not None:
            raise NotImplementedError(
                "replicas/fault_plan: the ReplicatedLog, FailureDetector and "
                "fault injection are not ported yet (ROADMAP Queue A item 8)")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = self.model.init(gen)
        self.params = params
        self.mgr = make_manager(P_NODES, device=self.device)
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
        self._prefill = self.model.prefill
        self._decode = self.model.decode_step
        self.op_counts = collections.Counter()
        # locality bookkeeping (§10.1): per page key, (explicit home,
        # writer-local home); bytes saved count one avoided remote read per
        # inserted page
        self.loc_counts = collections.Counter()
        self._page_home: Dict[int, tuple] = {}
        self._saved_keys: set = set()

    # -- channel helpers (windowed round-sets over the P simulated nodes) ---
    def _kv_ops(self, ops: List[tuple]):
        """ops: list of (op_code, key, (v0, v1), home), executed as (P, B)
        windows: op i → (participant i % P, window slot i // P), B padded to
        a power of two (≤ MAX_WINDOW).  Ops in one call must not conflict
        (admission and eviction batch distinct page keys)."""
        results = []
        live = np.arange(P_NODES)
        for start in range(0, len(ops), P_NODES * MAX_WINDOW):
            chunk = ops[start:start + P_NODES * MAX_WINDOW]
            nl = len(live)
            w = -(-len(chunk) // nl)
            w = 1 << (w - 1).bit_length()
            n = nl * w
            chunkp = chunk + [(NOP, 1, (0, 0), 0)] * (n - len(chunk))
            op = np.asarray([c[0] for c in chunkp], np.int32).reshape(w, nl).T
            key = np.asarray([c[1] for c in chunkp],
                             np.uint32).reshape(w, nl).T
            val = np.asarray([c[2] for c in chunkp],
                             np.int32).reshape(w, nl, 2).transpose(1, 0, 2)
            tgt = np.asarray([c[3] for c in chunkp], np.int32).reshape(w, nl).T
            self._kv_state, res = self.pages.op_window(
                self._kv_state, op, key, val, targets=tgt)
            for c in chunk:
                self.op_counts[c[0]] += 1
            found = res.found.cpu().numpy().T.reshape(n)
            value = res.value.cpu().numpy().transpose(1, 0, 2).reshape(n, -1)
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

    def stats(self):
        loc_reads = self.loc_counts["local_reads"]
        rem_reads = self.loc_counts["remote_reads"]
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
                "registered_region_bytes": self.mgr.memory_ledger_bytes(),
                "modeled_wire_bytes": self.mgr.traffic_ledger_bytes(),
                "traffic_by_verb": self.mgr.traffic.summary(),
                "backend": self.backend.name,
                "modeled_rounds": self.mgr.traffic.total_rounds(),
                "rounds_by_verb": self.mgr.traffic.rounds_summary(),
                "read_cache": self.mgr.traffic.cache_summary()}
