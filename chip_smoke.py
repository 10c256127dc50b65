#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It imports neither JAX nor the JAX package.  Phases, in order; any failure
exits non-zero and prints no result:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (eight
   sources) with nvcc, one process per source, all at once, and check with
   ``cuobjdump -sass`` that the bf16 flash and grouped-matmul kernels run on
   the tensor cores (HMMA instructions), and from ``-Xptxas -v`` that the
   tensor-core flash and grouped-matmul ones do not spill (the flash
   backward kernels' registers and spills are printed);
2. hold each kernel against its plain PyTorch version on the card: the
   remote-DMA kernels at the KVStore path's shapes (outputs and measured
   bytes bitwise equal, scatter collisions included), on the argument forms
   the verbs pass them (bool masks, the read verb's index one vector
   broadcast to every home with ``expand``) and on int32 masks and
   contiguous indices, all three on the verbs' forms one device operation
   per call (``torch.profiler``), the row commit also with 1-word rows,
   homes of a word count not a multiple of four, a base off 16 bytes and
   indices outside [0, slots) (one in [-slots, 0) wraps, any other is
   dropped, as the reference's oracle does), the remote-copy kernel at the ring hop's shapes (P=4 with 648 words, P=8
   with 20,488) and the bare ring entries (640 and 20,480 words) and at odd
   ones (a width not a multiple of four, a misaligned view, zero words, no
   senders, every receiver from one sender, a permutation; int64 maps,
   values an int32 cast would wrap among them), outputs and both byte
   vectors bitwise equal, and one device operation per call (no fill,
   memset or cast, by ``torch.profiler``), the attention kernels
   at the serving paths' full-width shapes (head_dim 128, and 256 with a
   2048-token window and one kv head; flash inputs as the models pass
   them, (B, H, S, D) views of (B, S, H, D) projections) and at odd ones —
   views at head_dim 64, 128, 160, 200 and 256, Sq and Sk not multiples of
   the tile, bf16 rows off 16 bytes (the flash kernel's CUDA-core route; each
   flash case checks the route taken), decode lengths 0, 1, 64, 65 and S in
   one batch, S not a multiple of the split's chunk, a sequence with one
   live chunk, a group of 20 query heads (two group tiles) — and at
   deepseek-v3's MLA shapes: the expanded prefill (4 prompts of 512 tokens,
   128 heads, q and k 192 wide, v zero-padded from 128 to 192; the padded
   output columns must be zero) and the absorbed decode (128 query heads on
   one kv head of the 576-wide latent cache, 544 slots, lengths 0, 1, 64, 65
   and S, full-width and one-live-split batches, bf16; float32 at D = 576
   must be refused) and at the cross-attention paths' (whisper's
   bidirectional encoder, 20 heads of 64 over 1,500 frames; its cross
   prefill, 224 queries over 1,500 keys; its cross decode over the full
   1,500-slot context and its self decode at lengths 224, 225, 256 and 1;
   llama-3.2-vision's cross prefill, 512 queries over 1,601 keys, 32 heads
   on 8 of 128, and its cross decode at every length 1,601: non-causal
   with Sq != Sk and a ragged last key tile) — (float32 within 2e-5,
   bfloat16 within 2e-2 of the
   float32 plain result on the same inputs), then every decode arrival
   counter is checked to be 0,
   the RG-LRU and WKV6 kernels at their serving shapes and at odd ones
   (RG-LRU also with runs of log_a = 0, strong decays, 4096 steps at full
   width, D = 2568 and a base off 16 bytes; WKV6 also with strong decays,
   w exactly 0 and 2048 steps), in float32 and bfloat16, outputs and final
   states (tolerances at ``REC_TOL``; each RG-LRU case on the copies it
   should take: 16-byte ones where every row starts on 16 bytes, else one
   element at a time; each WKV6 case on the kernel it should take: bf16 on
   the chunked tensor-core one, float32 on the sequential one), and the
   grouped matmul at llama4-maverick's expert shapes
   (prefill: 3072 slot rows in blocks of 24; decode: 1024 rows in blocks of
   8; 128 experts of 5120 x 8192 and 8192 x 5120), every row counted and
   with per-block row counts (a decode step's 4 live blocks of 128, partial
   prefill counts), at deepseek-v3's (256 experts of 7168 x 2048 and 2048 x
   7168; prefill: 20,480 slot rows in blocks of 80; decode: 2,048 in blocks
   of 8, a step's 4 tokens routed top-8), and at odd ones (all-zero
   counts, partial counts over garbage rows), in float32 and bfloat16 (tolerances at ``GMM_TOL``; each
   case on the kernel it should take, rows past the counts exactly zero);
2b. hold flash attention's backward (``csrc/flash_attention_bwd.cu``)
   against its plain version: D 64, 128, 192 (v zero-padded from 128, as
   MLA's, whose padded columns must get zero gradient) and 256, groups of
   1, 3, 5 and 8, causal, a 2048-token window, Sq != Sk, S 1, 17 and
   4096, bidirectional, D 40 and 96 (zero-filled on the tensor cores),
   bf16 rows off 16 bytes, bf16 and float32 (tolerance ``ATTN_TOL``
   relative to the plain gradient's max), each case on the route
   ``_bwd_variant`` picks (bf16 rows on 16 bytes at D <= 128 on the
   tensor cores, the rest on the CUDA cores), the forward's log-sum-exp
   against the plain one's, two calls bitwise equal, and a call's device
   operations (the three kernels once each) under ``torch.profiler``;
3. run the same work on the card and on the CPU: a P=4 store through 20
   windows (states and results bitwise equal after every window), a P=4
   lock-free store through the same windows and then all-UPDATE and
   pure-GET ones (its fastpath ledger rows equal too), a P=4 heat-tracked
   store under skewed readers through a rebalance and a mixed window (heat
   counters bitwise equal too), the
   smoke engine of every served architecture (llama3.2-3b, gemma-2b,
   internlm2-20b, recurrentgemma-2b, rwkv6-7b, llama4-maverick,
   deepseek-v3, whisper-large-v3 and llama-3.2-vision-11b: nine) in
   float32 with one set of weights each (equal tokens, bitwise equal
   page-table state), the smoke llama-3.2-vision and whisper models with
   the vlm's gates seeded non-zero and a random seeded context (prefill,
   three decode steps and every cache leaf within 1e-4; another context
   must move the logits), and the smoke llama3.2-3b engine with
   two page-table replicas on the remote-DMA backend, its log leader killed
   and revived (equal tokens; page table, replicas, log and detector
   bitwise equal), and one float32 training step of the smoke llama3.2-3b
   with AdamW, with Adafactor and with AdamW over 2 microbatches (loss,
   parameters and optimizer state within 1e-4);
4. the KVStore path — ``KVStore.op_window`` on the remote-DMA backend — at a
   deployment's size: P=8 participants, K=2**22 keys, 8-byte values,
   windows of 512 lanes per participant; prefill 80% of K, then 20 windows
   of 60/20/10/10 GET/UPDATE/INSERT/DELETE over distinct uniform keys and
   20 windows of 95/5 GET/UPDATE over zipf(0.99) keys; every GET and every
   ``found`` is checked against a numpy oracle of the window semantics;
4a. from the prefilled state on, a lock-free twin (``lockfree=True``, a
   copy of the state) runs the same windows: bitwise equal to the locked
   store after every one, oracle-checked, the fast path taken by every zipf
   window and by no mixed one (the ledger's fastpath rows), and a fast
   window's launches exactly one read verb and one write verb;
4c. the migration scenario of ``benchmarks/bench_locality.py`` on the
   final state: a heat-tracked twin with a fresh heat leaf, 10 skewed read
   windows (reader r reads zipf(0.99) keys of its shard k = r mod P, 10%
   uniform noise), up to 4 ``rebalance(max_moves=4096)`` passes (moves and
   backlog consistent with the proposals), the first read window again
   (its modeled wire bytes must fall), every GET and a mixed window after
   the migration oracle-checked;
4b. the failover scenario of ``benchmarks/bench_failover.py`` on that
   store shape: a leader and two follower stores behind a ReplicatedLog,
   the prefill and 20 mixed windows each appended and synced, the leader
   killed (detected, a follower promoted, the in-flight window retried, a
   zombie publish fenced) and revived (replay rejoin); the leader's results
   against the oracle, every follower bitwise equal to the leader at the
   end;
4d. the channel objects' scalar verbs on the remote-DMA backend (each
   scalar read is one descriptor and one row-gather launch, each write one
   descriptor and one row-commit launch), once on the card and once on the
   CPU, bitwise equal: ``benchmarks/bench_lock.py``'s single contended
   TicketLock (P=8, 12 rounds, one holder a round) and its transfer
   transactions (P=8, 2,728 accounts in a SharedRegion, 341 locks, 12
   rounds with the lock the account's and 12 with it the account // 8's:
   balances conserved, each completed transfer moved exactly 1, exactly
   4/2/2 descriptor/gather/commit launches a round),
   ``benchmarks/bench_barrier.py``'s crossings at P = 2, 4, 8 (count =
   crossings), OwnedVar push/pull and AtomicVar fetch_add/compare_swap, the
   queue's scalar reference paths (= its B=1 windows), and
   ``repro_torch.examples.kvstore_app`` on the card on the remote-DMA
   backend with its online oracle (every map kernel launched);
4e. ``benchmarks/bench_kvstore.py``'s reference variant (P=8, 1,024 keys,
   index 4,096, 132 slots, 256 locks, windows of 32): a hash store and a
   ``reference_impl=True`` store in step through the 80% prefill, 10 mixed
   and 10 zipf(0.99) windows (results lane for lane equal, every key on
   the same home with the same value), the spec store bitwise equal on the
   card and the CPU after every window, ``op_round`` bitwise
   ``_op_round_reference`` over 6 rounds, ``migrate_window`` result for
   result ``_migrate_reference`` on a placed store; the prefill time of
   each store and their ratio are printed;
5. the serving paths — ``ServingEngine.generate`` at full published width,
   bf16, random weights drawn on the card from a seeded generator, 8
   requests of 32 generated tokens in batches of 4 — on llama3.2-3b
   (512-token prompts), then llama3.2-3b again with two page-table replicas
   on the remote-DMA backend, 24 requests of 16 tokens, its log leader
   killed and revived (detection, promotion, the flush of buffered windows
   and a snapshot rejoin), recurrentgemma-2b (2304-token prompts, so its
   2048-token window and ring-buffer cache bind), rwkv6-7b (512-token
   prompts) at full depth, llama4-maverick-400b-a17b (512-token prompts)
   cut to 4 of its 48 layers, two [dense, MoE] periods, so that its bf16
   weights (65.3 GiB) fit the card, gemma-2b and internlm2-20b (512-token
   prompts) at full depth, and deepseek-v3-671b (512-token prompts) cut to
   5 of its 61 layers, [mla_dense] x 3 + [mla_moe] x 2 (50.9 GiB of bf16
   with its MTP weights: MLA prefill on the flash kernel, the absorbed
   decode on the decode kernel at D = 576, 256 experts top-8 on the
   grouped matmul), whisper-large-v3 at full width and depth (32 encoder
   and 32 decoder layers, 224-token prompts, half its 448-token text
   context, over 1,500 zero frames: flash per encoder layer and for each
   decoder layer's self and cross attention, decode attention twice per
   decoder layer a step) and llama-3.2-vision-11b at full width and depth
   (40 layers, [attn x 4, cross] x 8, 512-token prompts over 1,601 zero
   context tokens; its cross layers on the same kernels); one after the
   other, each engine freed before the next; page-table, locality, logit
   and launch-count checks
   (recurrentgemma-2b's RG-LRU launches all on 16-byte copies, rwkv6-7b's WKV6 launches all on the chunked kernel),
   and on the replicated path the replication checks;
7. the training path — ``repro_torch.launch.train.run``, the code of
   ``python -m repro_torch.launch.train`` — on llama3.2-3b at full width
   and depth (28 layers, 3,212,749,824 parameters), bf16, 2 x 4096 tokens
   a step, ``remat="block"``, AdamW, 6 steps on one repeated
   SyntheticTokens batch: every loss finite, the last below the first,
   exactly 56 flash forward launches (each layer's forward and its
   recompute) and 28 backward calls a step and no other model kernel;
   step p50 / p99, tokens/s and peak memory; one more step under
   ``torch.profiler`` (device busy share, the flash forward's and
   backward's shares); each kernel wrapper without a backward (``gmm``,
   ``rglru_scan``, ``wkv6``, ``decode_attention``) refusing a
   grad-requiring input on the card; and a checkpoint round trip of the
   smoke model's bf16 state on the card, bitwise;
6. report the end-to-end numbers of every path, each kernel's launches on
   its path, its time beside its plain version's, one PyTorch call's and
   its bound (every row also with the kernel's device time per call from
   ``torch.profiler``, which tells host-bound rows from kernel-bound ones,
   the remote-DMA and recurrent rows with their device operations per
   call, the remote-DMA rows timed on the verbs' argument forms, WKV6's
   with the sequential form's bound beside the chunked one's, the
   attention rows with SDPA's, and the attention and grouped-matmul rows
   with an entry at deepseek-v3's MLA and expert shapes, the attention
   rows also at whisper's encoder and cross-decode shapes and
   llama-3.2-vision's cross prefill; the flash
   backward's row at the training shape, with the backward of SDPA's
   output beside it), the card's name and power limit, and last the
   result line.

Kernel launch counts are set to 0 just before each path and read just after
it, so the checks of phases 2, 2b and 3 and the timings of phase 6 count
nowhere;
the map kernels' rows carry phase 4d's and 4e's counts beside the KVStore
path's.
On every replicated path the remote-copy kernel's launches must equal the
ring's publishes.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# KVStore op codes (checked against repro_torch.core's at start-up)
NOP, GET, INSERT, UPDATE, DELETE, MOVE = 0, 1, 2, 3, 4, 5

# the main path's configuration (benchmarks/bench_kvstore.py's store shape)
P = 8
KEYS = 2 ** 22
B = 512
W = 2
FILL = 0.8
MIX_WINDOWS = 20
ZIPF_WINDOWS = 20
ZIPF_THETA = 0.99
SEED = 0
# phase 4c, the migration scenario of benchmarks/bench_locality.py at the
# main path's size: skewed read windows, then rebalance passes
MIGRATION_READS = 10
READ_NOISE = 0.10
REBALANCE_MOVES = 4096
REBALANCE_PASSES = 4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# a profiler session's counted calls: PREROLL_S of host time after the
# session starts, then LEAD_MARKS marker kernels (torch.cuda._sleep), the
# calls, one marker.  On the card a session loses a prefix of its device
# records, never a later one: most often its first record, now and then a
# few milliseconds' worth, now and then all of them.  The preroll puts the
# calls past most such losses; a lead marker seen shows that the loss
# stopped before the calls.  A session that is not whole is run again, up
# to PROFILER_SESSIONS times
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1000
LEAD_MARKS = 128
PREROLL_S = 0.1
PROFILER_SESSIONS = 5
# the most lead markers one profiler session lost this run, and the
# sessions that were not whole
MARKS_LOST = [0]
SESSIONS_RUN_AGAIN = [0]
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM float32 peak outside the tensor cores

# the serving paths' configurations (phase 5)
SERVE_ARCH = "llama3.2-3b"
SERVE_REQUESTS = 8
SERVE_PROMPT = 512
SERVE_GEN = 32
SERVE_BATCH = 4
RG_PROMPT = 2304               # recurrentgemma: past its 2048-token window
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_LAYERS = 4                 # of 48: two [attn_dense, attn_moe] periods
DS_ARCH = "deepseek-v3-671b"
DS_LAYERS = 5                  # of 61: [mla_dense] x 3 + [mla_moe] x 2
# whisper: 224-token prompts, half of its published 448-token text context
# (the most text it conditions on), over its 1,500 frames; llama-3.2-vision:
# 512-token prompts over its 1,601 context tokens (cross_shape reads both)
WHISPER_ARCH, WHISPER_PROMPT = "whisper-large-v3", 224
VISION_ARCH = "llama-3.2-vision-11b"
# the replicated paths: the failover phase (participant 0, the log leader,
# dies before mixed window FO_KILL and comes back before FO_REVIVE — its
# cursor gap is then the ring's capacity, so the replay rejoin runs) and
# phase 5's replicated llama3.2-3b path (48 mutation windows for 24 requests
# in batches of 4; killed before window REP_KILL, revived at REP_REVIVE, a
# gap past the engine's 3-entry ring, so the snapshot rejoin runs)
LOG_CAPACITY = 4
DETECT_THRESHOLD = 2
FO_KILL, FO_REVIVE = 8, 10
REP_REQUESTS, REP_GEN, REP_KILL, REP_REVIVE = 24, 16, 5, 13
SERVE_PATHS = [
    dict(arch=SERVE_ARCH, prompt=SERVE_PROMPT),
    dict(arch=SERVE_ARCH, prompt=SERVE_PROMPT, requests=REP_REQUESTS,
         gen=REP_GEN, replicas=2, backend="pallas",
         plan=dict(kills={0: REP_KILL}, revives={0: REP_REVIVE})),
    dict(arch="recurrentgemma-2b", prompt=RG_PROMPT),
    dict(arch="rwkv6-7b", prompt=SERVE_PROMPT),
    dict(arch=MOE_ARCH, prompt=SERVE_PROMPT, n_layers=MOE_LAYERS),
    dict(arch="gemma-2b", prompt=SERVE_PROMPT),
    dict(arch="internlm2-20b", prompt=SERVE_PROMPT),
    dict(arch=DS_ARCH, prompt=SERVE_PROMPT, n_layers=DS_LAYERS),
    dict(arch=WHISPER_ARCH, prompt=WHISPER_PROMPT),
    dict(arch=VISION_ARCH, prompt=SERVE_PROMPT),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# phase 7, the training path: llama3.2-3b at full width and depth, bf16,
# batches of TRAIN_BATCH x TRAIN_SEQ tokens (the train_4k shape's length),
# remat per block, AdamW, TRAIN_STEPS steps on one repeated batch
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6
# RG-LRU and WKV6 against their plain versions, as max abs error over
# max(1, max |plain|).  float32 rglru: the same operations per step (the
# square root the hardware's, within an ulp), but the kernel's tiled scan
# adds each run's start state through the run's product of a (y = hl +
# A·h_in, runs of 8 or 16 steps, 8 runs folded a tile), a few more
# roundings of the size of h a step, and the recurrence contracts
# (|a| < 1), so rounding does not grow; float32 wkv6: every output sums 64
# products in another order, over a state summed across up to 512 steps;
# bfloat16 outputs add one rounding to bf16 (2^-8 relative).  Final states
# are float32 on both sides, so they take the float32 tolerance.
REC_TOL = {("rglru_scan", "float32"): 1e-5, ("wkv6", "float32"): 1e-4,
           ("rglru_scan", "bfloat16"): 1e-2, ("wkv6", "bfloat16"): 1e-2}
# The grouped matmul against its plain version on the same inputs and dtype,
# as max abs error over max(1, max |plain|): both sum up to 8192 float32
# products in other orders (rounding walks of ~2^-24·sqrt(8192) of the
# output's size); in bfloat16 each side then rounds once, so the outputs may
# differ by one bfloat16 step (2^-8 relative).
GMM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# llama4-maverick's expert shapes: d_model 5120, d_ff_expert 8192, 128
# experts; capacity 24 slots for a 4 x 512-token prefill, 8 for a decode step
MOE_D, MOE_F, MOE_E, MOE_C_PREFILL, MOE_C_DECODE = 5120, 8192, 128, 24, 8
# deepseek-v3's: d_model 7168, d_ff_expert 2048, 256 experts, top-8;
# capacity 80 slots for a 4 x 512-token prefill, 8 for a decode step; MLA
# with 128 heads: prefill q and k 128 + 64 wide, v 128; decode over the
# kv_lora 512 + rope 64 latent cache
DS_D, DS_F, DS_E, DS_K, DS_C_PREFILL, DS_C_DECODE = 7168, 2048, 256, 8, 80, 8
DS_HEADS, DS_DQK, DS_DV, DS_DLAT, DS_DROPE = 128, 192, 128, 576, 64


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sass_mma_count(_nvcc, name, kernel):
    """HMMA (tensor-core) instructions in the SASS of each function of
    ``csrc/<name>.cu``'s library whose name holds ``kernel``, by
    ``cuobjdump -sass``."""
    lib = _nvcc.build(name)[name]
    tool = os.path.join(os.path.dirname(_nvcc._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def ptxas_usage(_nvcc, name, kernel):
    """Registers and spill bytes (stores, loads) of each function of
    ``csrc/<name>.cu`` whose name holds ``kernel``, from ``nvcc -Xptxas -v``:
    this process's build log, or a fresh build into a temporary file when
    the library was already built."""
    out = _nvcc.BUILD_LOGS.get(name)
    if out is None:
        tmp = _nvcc.BUILD / f"ptxas-{name}-{os.getpid()}.so"
        try:
            out = subprocess.run(
                [_nvcc._nvcc(), *_nvcc.FLAGS, "-o", str(tmp),
                 str(_nvcc.CSRC / f"{name}.cu")], capture_output=True,
                text=True, check=True, timeout=600).stdout
        finally:
            tmp.unlink(missing_ok=True)
    return parse_ptxas(out, kernel)


def parse_ptxas(out, kernel):
    """{function: [registers, spill store bytes, spill load bytes]} of the
    functions whose name holds ``kernel`` in ``-Xptxas -v`` output."""
    usage, fn = {}, None
    for line in out.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
            fn = fn if kernel in fn else None
        elif fn and "spill stores" in line:
            parts = line.replace(",", "").split()
            usage[fn] = [None, int(parts[parts.index("spill") - 2]),
                         int(parts[parts.index("loads") - 3])]
        elif fn and "Used" in line and "registers" in line:
            usage[fn][0] = int(line.split("Used", 1)[1].split()[0])
            fn = None
    return usage


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_calls(torch, fn, iters):
    """One ``torch.profiler`` session of ``iters`` calls of ``fn()``, after
    :data:`PREROLL_S` and :data:`LEAD_MARKS` marker kernels and before one:
    ({name: [count, total µs]} of the device operations (kernels, copies,
    fills) but the markers, lead markers seen, tail marker seen)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(PREROLL_S)
        for _ in range(LEAD_MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    ops, marks, first = {}, [], float("inf")
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if MARK_KERNEL in e.name:
            marks.append(e.time_range.start)
            continue
        n, us = ops.get(e.name, (0, 0.0))
        ops[e.name] = (n + 1, us + e.time_range.elapsed_us())
        first = min(first, e.time_range.start)
    lead = sum(t < first for t in marks)
    return ops, lead, len(marks) - lead


def whole_session(torch, fn, iters):
    """The operations of the first of up to :data:`PROFILER_SESSIONS`
    sessions of :func:`profiled_calls` that is whole: a lead marker and the
    tail marker seen, each operation's count a positive multiple of
    ``iters``.  Each session that is not logs its counts; when none is, the
    check fails."""
    for _session in range(PROFILER_SESSIONS):
        ops, lead, tail = profiled_calls(torch, fn, iters)
        MARKS_LOST[0] = max(MARKS_LOST[0], LEAD_MARKS - lead)
        counts = {k[:60]: n for k, (n, _us) in ops.items()}
        if lead and tail and ops \
                and not any(n % iters for n, _us in ops.values()):
            return ops
        SESSIONS_RUN_AGAIN[0] += 1
        log(f"  profiler: session of {iters} calls not whole ({lead} of "
            f"{LEAD_MARKS} lead markers, {tail} of 1 tail marker seen): "
            f"{json.dumps(counts)}")
    raise SmokeFailure(f"torch.profiler lost device records in each of "
                       f"{PROFILER_SESSIONS} sessions of {iters} calls; "
                       f"the last: {counts}")


def device_ops(torch, fn, iters):
    """The device operations of ``iters`` calls of ``fn()`` under
    ``torch.profiler``, as {name: count}, from a whole session
    (:func:`whole_session`)."""
    fn()
    return {name: n for name, (n, _us) in
            whole_session(torch, fn, iters).items()}


def device_ms(fn, iters):
    """Device time of one ``fn()`` call from ``torch.profiler`` over
    ``iters`` calls: for each kernel, copy or fill the calls ran on the
    card, its mean duration times the number of times one call runs it —
    without the host time between launches that :func:`cuda_ms` also sees
    when the calls are host-bound."""
    import torch
    for _ in range(3):
        fn()
    return sum(us / n * max(1, round(n / iters)) for n, us in
               whole_session(torch, fn, iters).values()) / 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(torch, rdma, slots):
    """Inputs at the main path's shapes: R = B request lanes per
    participant for descriptors, N = P·B served/committed lanes per home on
    a (P, slots, W+3) int32 row buffer.  Each kernel's first cases are the
    argument forms the verbs pass (``colls._serve_scatter`` and
    ``remote_write_batch``): int32 targets and indices, bool masks, the
    read verb's ``wire`` left to default to ``en``, and one index vector
    broadcast to every home with ``expand`` (row stride 0); the first case
    is the one phase 6 times.  Then int32 masks and contiguous indices,
    the row commit's indices outside [0, slots) and its odd layouts on the
    write verb's forms."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    N = P * B
    width = W + 3

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def bools(shape):
        return ints(0, 2, shape) != 0

    def verb_masks(targets, en):
        """The read verb's home mask: lane l of the P·B flattened lanes is
        served by home h iff it targets h and rides the wire."""
        homes = torch.arange(P, dtype=torch.int32, device=dev)[:, None]
        return (targets.reshape(-1)[None, :] == homes) & en.reshape(-1)[None, :]

    buf = ints(-2 ** 31, 2 ** 31 - 1, (P, slots, width))
    tg, ix = ints(0, P, (P, B)), ints(0, slots, (P, B))
    preds, remote = bools((P, B)), bools((P, B))
    cases = {
        "build_descriptors": [
            ("write verb: bool en and wire",
             (tg, ix, preds), dict(wire=preds & remote, op=rdma.OP_WRITE,
                                   row_nbytes=4 * width)),
            ("read verb: bool en, wire defaults to en",
             (tg, ix, remote), dict(op=rdma.OP_READ, row_nbytes=4 * width)),
            ("int32 masks", (ints(0, P, (P, B)), ints(0, slots, (P, B)),
                             ints(0, 2, (P, B))),
             dict(wire=ints(0, 2, (P, B)), op=rdma.OP_WRITE,
                  row_nbytes=4 * width)),
            ("bool en, int32 wire", (tg, ix, preds),
             dict(wire=ints(0, 2, (P, B)), op=rdma.OP_WRITE,
                  row_nbytes=4 * width)),
            ("no wire lane", (tg, ix, torch.zeros((P, B), dtype=torch.bool,
                                                  device=dev)),
             dict(op=rdma.OP_READ, row_nbytes=4 * width))],
        "gather_rows": [
            ("read verb: broadcast index, bool mask",
             (buf, ints(0, slots, (N,))[None, :].expand(P, -1),
              verb_masks(tg, remote)), {}),
            ("read verb: all masked",
             (buf, ints(0, slots, (N,))[None, :].expand(P, -1),
              torch.zeros((P, N), dtype=torch.bool, device=dev)), {}),
            ("int32 mask, contiguous index",
             (buf, ints(0, slots, (P, N)), ints(0, 2, (P, N))), {}),
            ("all masked, int32",
             (buf, ints(0, slots, (P, N)),
              torch.zeros((P, N), dtype=torch.int32, device=dev)), {})],
        "scatter_rows": [],
    }
    vals = ints(-2 ** 31, 2 ** 31 - 1, (P, N, width))
    # the write verb's forms: one index vector broadcast to every home,
    # bool apply and wire masks
    win = verb_masks(tg, preds)
    cases["scatter_rows"].append(
        ("write verb: broadcast index, bool masks",
         (buf, ints(0, slots, (N,))[None, :].expand(P, -1), vals, win,
          win & bools((P, N))), {}))
    for name, idx in [("random", ints(0, slots, (P, N))),
                      ("all lanes one row", torch.full((P, N), 7,
                                                       dtype=torch.int32,
                                                       device=dev)),
                      ("random duplicates", ints(0, 64, (P, N)))]:
        apply = ints(0, 2, (P, N))
        cases["scatter_rows"].append(
            (name, (buf, idx, vals, apply, apply * ints(0, 2, (P, N))), {}))
    # odd layouts on the write verb's forms: rows one word wide (the log's
    # rejoin); homes of 1023 x 5 words, not a multiple of 4, so that home
    # starts fall off 16 bytes; a buffer whose base is off 16 bytes (the
    # word-by-word route); duplicates in each
    # indices outside [0, slots): one in [-slots, 0) wraps to the end of the
    # buffer, one >= slots or < -slots is dropped; the edges -1, -slots,
    # slots, slots + 3 and -slots - 1 in every home, the rest drawn from
    # [-2 slots, 2 slots), on an int32 index and bool masks
    odd = ints(-2 * slots, 2 * slots, (P, N))
    odd[:, :5] = torch.tensor([-1, -slots, slots, slots + 3, -slots - 1],
                              dtype=torch.int32, device=dev)
    apply = bools((P, N))
    cases["scatter_rows"].append(
        ("indices outside [0, slots)",
         (buf, odd, vals, apply, apply & bools((P, N))), {}))
    for name, n_slots, width, off in [("1-word rows", slots, 1, 0),
                                      ("home words % 4 == 3", 1023, 5, 0),
                                      ("base off 16 bytes", 4099, 5, 1)]:
        flat = ints(-2 ** 31, 2 ** 31 - 1, (P * n_slots * width + off,))
        b = flat[off:].view(P, n_slots, width)
        apply = bools((P, N))
        cases["scatter_rows"].append(
            (f"write verb, {name}",
             (b, ints(0, min(n_slots, 512), (N,))[None, :].expand(P, -1),
              ints(-2 ** 31, 2 ** 31 - 1, (P, N, width)), apply,
              apply & bools((P, N))), {}))
    return cases


#: Phase-2 cases on the verbs' argument forms whose calls must each be one
#: device operation: the kernel's launch and nothing else (no cast, copy or
#: fill), by ``torch.profiler``.
ONE_OP = {"build_descriptors": ("build_desc_kernel", 2),
          "gather_rows": ("gather_rows_kernel", 2),
          "scatter_rows": ("scatter_rows_kernel", 1)}


PLAIN = {"build_descriptors": "_build_desc_ref", "gather_rows": "_gather_ref",
         "scatter_rows": "_scatter_ref"}


def plain_call(torch, rdma, name, args, kw):
    """The kernel's plain PyTorch version on the same (card) tensors."""
    if name == "build_descriptors":
        tg, ix, en = args
        return rdma._build_desc_ref(tg, ix, en, kw.get("wire", en),
                                    kw["op"], kw["row_nbytes"])
    buf = args[0]
    row_nbytes = buf.shape[2] * buf.element_size()
    return getattr(rdma, PLAIN[name])(*args, row_nbytes)


def max_abs_err(torch, got, exp):
    err = 0.0
    for a, b in zip(got, exp):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
              f"{tuple(b.shape)} {b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def phase_kernels(torch, rdma, slots):
    cases = kernel_cases(torch, rdma, slots)
    errs = {}
    for name, runs in cases.items():
        kern = getattr(rdma, name)
        errs[name] = 0.0
        for label, args, kw in runs:
            before = kern.launches
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} did not launch")
            exp = plain_call(torch, rdma, name, args, kw)
            e = max_abs_err(torch, got, exp)
            check(e == 0.0, f"{name} ({label}) differs from its plain "
                            f"version: max abs err {e}")
            errs[name] = max(errs[name], e)
            log(f"  {name} [{label}]: bitwise equal to the plain version")
    for name, (kernel, n_cases) in ONE_OP.items():
        kern = getattr(rdma, name)
        for label, args, kw in cases[name][:n_cases]:
            ops = device_ops(torch, lambda: kern(*args, **kw), 50)
            check(list(ops.values()) == [50] and kernel in next(iter(ops)),
                  f"{name} ({label}): 50 calls ran {ops} on the card, not "
                  f"one kernel each")
            log(f"  {name} [{label}]: one device operation per call "
                f"(torch.profiler, 50 calls)")
    return cases, errs


def copy_cases(torch):
    """(label, src, dst, sender) at the ring hop's shapes — the packed
    publish of the engine's log (P = 4, a 640-word entry and its metadata,
    648 words) and of the failover phase's (P = 8, 20,480 + 8 words) — at
    the bare entries, and at odd ones."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def words(n_rows, n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n_rows, n), generator=g,
                             device="cuda", dtype=torch.int32)

    def bcast(n_rows, owner):
        s = torch.full((n_rows,), owner, dtype=torch.int32, device="cuda")
        s[owner] = -1
        return s

    cases = []
    for n_rows, n in [(4, 648), (8, 20488), (4, 640), (8, 20480), (4, 643)]:
        cases.append((f"broadcast P={n_rows} n={n}", words(n_rows, n),
                      words(n_rows, n), bcast(n_rows, 1)))
    flat_s, flat_d = words(1, 4 * 101 + 1)[0], words(1, 4 * 101 + 1)[0]
    cases.append(("misaligned view P=4 n=101", flat_s[1:].view(4, 101),
                  flat_d[1:].view(4, 101), bcast(4, 2)))
    cases.append(("n=0", words(4, 0), words(4, 0), bcast(4, 0)))
    full = (words(8, 20480), words(8, 20480))
    cases.append(("no senders", *full,
                  torch.full((8,), -1, dtype=torch.int32, device="cuda")))
    cases.append(("every receiver from one sender", *full,
                  torch.full((8,), 3, dtype=torch.int32, device="cuda")))
    cases.append(("permutation", *full,
                  torch.randperm(8, generator=g, device="cuda").to(
                      torch.int32)))
    # int64 maps, taken as they are: the hop shapes, and values that an
    # int32 cast would wrap into [0, P)
    for n_rows, n in [(8, 20488), (4, 648)]:
        cases.append((f"int64 map broadcast P={n_rows} n={n}",
                      words(n_rows, n), words(n_rows, n),
                      bcast(n_rows, 2).to(torch.int64)))
    cases.append(("int64 map past int32", *full, torch.tensor(
        [2 ** 32 + 1, -1, 2 ** 33, 1, -2 ** 32 + 3, 0, 5, 2 ** 31],
        dtype=torch.int64, device="cuda")))
    return cases


def phase_copy_kernel(torch, rdma):
    """remote_copy against _remote_copy_ref on the same card tensors:
    outputs and both byte vectors bitwise equal.  Returns the cases and
    each case's measured max abs err by label."""
    cases = copy_cases(torch)
    errs = {}
    for label, src, dst, sender in cases:
        before = rdma.remote_copy.launches
        got = rdma.remote_copy(src, dst, sender)
        torch.cuda.synchronize()
        check(rdma.remote_copy.launches == before + 1,
              "remote_copy did not launch")
        exp = rdma._remote_copy_ref(src, dst, sender)
        e = max_abs_err(torch, got, exp)
        check(e == 0.0, f"remote_copy ({label}) differs from its plain "
                        f"version: max abs err {e}")
        errs[label] = e
        log(f"  remote_copy [{label}]: bitwise equal to the plain version, "
            f"bytes included")
    for label, src, dst, sender in cases[:2] + cases[-3:-1]:
        ops = device_ops(torch, lambda: rdma.remote_copy(src, dst, sender),
                         50)
        check(list(ops.values()) == [50] and "remote_copy_kernel" in
              next(iter(ops)), f"remote_copy ({label}): 50 calls ran "
                               f"{ops} on the card, not one kernel each")
        log(f"  remote_copy [{label}]: one device operation per call "
            f"(torch.profiler, 50 calls)")
    return cases, errs


def copy_nbytes(sender, n):
    """Bytes remote_copy must move for ``sender`` over (P, n) int32 rows:
    each distinct row read once — a sender's row of src, and dst's row of
    each receiver that keeps its own — all P rows written once, the sender
    map read and the two (P,) byte counters written."""
    s = sender.tolist()
    P = len(s)
    peers = [v for q, v in enumerate(s) if 0 <= v < P and v != q]
    rows_read = len(set(peers)) + P - len(peers)
    return (rows_read + P) * n * 4 + 4 * P + 2 * 4 * P


def cross_shape(arch):
    """(query heads, kv heads, head dim, context tokens) of a cross family's
    published config, the shapes phase 5 serves it at."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.cross.n_context_tokens)


def attention_cases(torch):
    """(label, args, kw) per attention case: the serving paths' full-width
    shapes in bf16 and float32 — llama3.2-3b (24 query heads, 8 kv heads,
    head_dim 128; prefill of 4 prompts of 512 tokens, decode against a
    544-slot cache) and recurrentgemma-2b's local attention (10 query heads
    on 1 kv head, head_dim 256; prefill of 4 prompts of 2304 tokens with a
    2048-token window, decode against the 2048-slot ring) — then odd shapes
    and masks, then the cross-attention paths': whisper's bidirectional
    encoder (20 heads of 64 over 1,500 frames, G 1), its decoder's cross
    prefill (224 queries over 1,500 keys) and both its decodes (the full
    1,500-slot context cache; the 256-slot self cache at lengths 224, 225,
    256 and 1), and llama-3.2-vision's cross prefill (512 queries over
    1,601 context keys, 32 heads on 8) and cross decode (every length
    1,601) — non-causal with Sq ≠ Sk and a ragged last key tile (1,500 =
    11·128 + 92, 1,601 = 12·128 + 65)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    wh, wkv, wd, wctx = cross_shape(WHISPER_ARCH)
    vh, vkv, vd, vctx = cross_shape(VISION_ARCH)

    def rn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    def lens(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def bhsd(B, H, S, D, dt):
        """(B, H, S, D) view of a (B, S, H, D) projection, as the models
        pass q, k and v."""
        return rn((B, S, H, D), dt).transpose(1, 2)

    def misaligned(B, H, S, D, dt):
        """(B, H, S, D) one element into its buffer: bf16 rows off 16
        bytes, for the CUDA-core route."""
        flat = rn((B * H * S * D + 1,), dt)
        return flat[1:].view(B, H, S, D)

    def mla_v(B, H, S, D, dt):
        """MLA's prefill v: (B, H, S, 192) view of a (B, S, H, 128)
        projection zero-padded to 192, as ``mla_attention`` passes it."""
        return torch.nn.functional.pad(rn((B, S, H, DS_DV), dt),
                                       (0, D - DS_DV)).transpose(1, 2)

    flash, decode = [], []
    Bf, Hq, Hkv, D = SERVE_BATCH, 24, 8, 128
    for label, (B, hq, hkv, sq, sk, d), kw, make in [
            ("full width", (Bf, Hq, Hkv, SERVE_PROMPT, SERVE_PROMPT, D),
             dict(causal=True), bhsd),
            ("D=256 window full width", (Bf, 10, 1, RG_PROMPT, RG_PROMPT, 256),
             dict(causal=True, window=2048), bhsd),
            ("D=256 odd", (2, 10, 1, 140, 140, 200), dict(causal=True,
                                                          window=50), None),
            ("offset causal", (2, 6, 2, 100, 300, D), dict(causal=True), None),
            ("window", (2, 8, 4, 200, 200, 64), dict(causal=True, window=48),
             None),
            ("padded Sk", (1, 4, 2, 130, 130, D), dict(causal=True), None),
            ("Sq not a tile multiple", (3, 4, 4, 77, 77, 16),
             dict(causal=False), None),
            ("rows with no key", (1, 2, 1, 16, 8, 8), dict(causal=True), None),
            ("views D=64 Sq=200", (2, 8, 2, 200, 200, 64), dict(causal=True),
             bhsd),
            ("views D=128 Sq=100", (2, 8, 4, 100, 100, 128), dict(causal=True),
             bhsd),
            ("views D=256 window Sq=333", (1, 10, 1, 333, 333, 256),
             dict(causal=True, window=100), bhsd),
            ("views D=200", (2, 4, 2, 150, 150, 200), dict(causal=True), bhsd),
            ("views D=160", (2, 8, 2, 150, 150, 160), dict(causal=True), bhsd),
            ("Sk ragged", (2, 8, 4, 70, 190, 128), dict(causal=False), bhsd),
            ("Sk ragged causal", (2, 8, 4, 64, 150, 128), dict(causal=True),
             bhsd),
            ("misaligned rows", (2, 8, 4, 100, 100, 128), dict(causal=True),
             misaligned),
            ("MLA prefill full width", (Bf, DS_HEADS, DS_HEADS, SERVE_PROMPT,
                                        SERVE_PROMPT, DS_DQK),
             dict(causal=True, sm_scale=DS_DQK ** -0.5), bhsd),
            ("whisper encoder", (Bf, wh, wkv, wctx, wctx, wd),
             dict(causal=False), bhsd),
            ("whisper cross", (Bf, wh, wkv, WHISPER_PROMPT, wctx, wd),
             dict(causal=False), bhsd),
            ("vision cross", (Bf, vh, vkv, SERVE_PROMPT, vctx, vd),
             dict(causal=False), bhsd)]:
        for dt in (torch.bfloat16, torch.float32):
            if make is None:
                args = (rn((B, hq, sq, d), dt), rn((B, hkv, sk, d), dt),
                        rn((B, hkv, sk, d), dt))
            else:
                args = (make(B, hq, sq, d, dt), make(B, hkv, sk, d, dt),
                        (mla_v if label.startswith("MLA") else make)(
                            B, hkv, sk, d, dt))
            flash.append((f"{label} {str(dt)[6:]}", args, kw))
    S = SERVE_PROMPT + SERVE_GEN
    for label, (B, hq, hkv, s, d), ln in [
            ("full width", (Bf, Hq, Hkv, S, D), [0, 1, S, 300]),
            ("D=256 ring full width", (Bf, 10, 1, 2048, 256),
             [2048, 2048, 1, 1000]),
            ("D=256 odd", (3, 10, 1, 70, 136), [70, 0, 33]),
            ("smoke shapes", (2, 4, 2, 48, 12), [48, 5]),
            ("group of 16", (3, 16, 1, 100, 64), [100, 63, 64]),
            ("lengths 0 1 64 65 S, S=300", (5, 8, 2, 300, 128),
             [0, 1, 64, 65, 300]),
            ("S=1000 not a chunk multiple", (1, 10, 1, 1000, 256), [1000]),
            ("one live chunk", (2, 10, 1, 2048, 256), [50, 64]),
            ("group of 20", (3, 40, 2, 130, 128), [130, 0, 65]),
            ("MLA lengths 0 1 64 65 S", (5, DS_HEADS, 1, S, DS_DLAT),
             [0, 1, 64, 65, S]),
            ("MLA full width", (Bf, DS_HEADS, 1, S, DS_DLAT),
             [S, S - 16, 300, 1]),
            ("MLA one live chunk", (2, DS_HEADS, 1, S, DS_DLAT), [50, 64]),
            ("MLA D=300 group of 20", (2, 20, 1, 100, 300), [100, 7]),
            ("whisper cross", (Bf, wh, wkv, wctx, wd), [wctx] * Bf),
            ("whisper self", (Bf, wh, wkv, WHISPER_PROMPT + SERVE_GEN, wd),
             [WHISPER_PROMPT, WHISPER_PROMPT + 1,
              WHISPER_PROMPT + SERVE_GEN, 1]),
            ("vision cross", (Bf, vh, vkv, vctx, vd), [vctx] * Bf)]:
        # float32 past D = 256 is refused (mla_decode_f32_refused)
        for dt in (torch.bfloat16,) if d > 256 else (torch.bfloat16,
                                                     torch.float32):
            kw = dict(sm_scale=DS_DQK ** -0.5) if label.startswith("MLA") \
                else {}
            decode.append((f"{label} {str(dt)[6:]}",
                           (rn((B, hq, d), dt), rn((B, hkv, s, d), dt),
                            rn((B, hkv, s, d), dt), lens(ln)), kw))
    return {"flash_attention": flash, "decode_attention": decode}


def mla_decode_f32_refused(torch, kernels):
    """The decode kernel takes float32 only up to D = 256 (its two 64-key
    float32 tiles at D = 576 would not fit a block's shared memory): the
    wrapper must refuse MLA's latent shape in float32 with a clear error,
    and launch nothing."""
    from repro_torch.kernels import decode_attention as dec
    kern = kernels["decode_attention"]
    q = torch.zeros((1, DS_HEADS, DS_DLAT), device="cuda")
    kc = torch.zeros((1, 1, 64, DS_DLAT), device="cuda")
    ln = torch.ones(1, dtype=torch.int32, device="cuda")
    before = kern.launches
    try:
        kern(q, kc, kc, ln)
    except ValueError as e:
        check(kern.launches == before and f"<= {dec.MAX_HEAD_DIM_F32}" in
              str(e), f"decode_attention's float32 refusal: {e}")
        log(f"  decode_attention [MLA float32]: refused ({e})")
        return
    raise SmokeFailure("decode_attention took float32 at D = 576")


def flash_route(args):
    """The flash kernel the wrapper picks for these inputs."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    return fa._variant(q.dtype, q.shape[3],
                       (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]),
                       (q.data_ptr(), k.data_ptr(), v.data_ptr()))


def attention_plain(name, args, kw):
    """The kernel's plain PyTorch version, in float32, on the same (card)
    inputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    if name == "flash_attention":
        q, k, v = (t.float() for t in args)
        offset = fa._padded(k.shape[2]) - fa._padded(q.shape[2])
        return ref.mha(q, k, v, offset=offset, **kw)
    q, kc, vc, ln = args
    return ref.decode_attention(q.float(), kc.float(), vc.float(), ln, **kw)


def phase_attention_kernels(torch, kernels):
    cases = attention_cases(torch)
    errs = {}
    for name, runs in cases.items():
        kern = kernels[name]
        errs[name] = 0.0
        for label, args, kw in runs:
            before = kern.launches
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} did not launch")
            check(got.dtype == args[0].dtype and got.shape == args[0].shape,
                  f"{name} ({label}): {got.dtype} {tuple(got.shape)}")
            exp = attention_plain(name, args, kw)
            e = float((got.float() - exp).abs().max())
            tol = ATTN_TOL[str(got.dtype)[6:]]
            check(e <= tol, f"{name} ({label}) differs from its plain "
                            f"version: max abs err {e} > {tol}")
            if label.startswith("rows with no key"):
                check(not got[:, :, :8].any(), f"{name} ({label}): rows "
                                               f"with no visible key not 0")
            if label.startswith("MLA prefill"):
                check(not got[..., DS_DV:].any(), f"{name} ({label}): the "
                      f"zero-padded v gave non-zero output columns")
            route = ""
            if name == "decode_attention":
                check(not got[args[3] == 0].any(),
                      f"{name} ({label}): length-0 rows not zero")
            else:
                route = flash_route(args)
                want = "simt" if "float32" in label or "misaligned" in label \
                    or args[0].shape[3] % 8 else "mma"
                check(route == want, f"{name} ({label}) took the {route} "
                                     f"kernel, not {want}")
                route = f", {route} kernel"
            errs[name] = max(errs[name], e)
            log(f"  {name} [{label}]: max abs err {e:.3g} (tolerance {tol})"
                f"{route}")
    mla_decode_f32_refused(torch, kernels)
    from repro_torch.kernels import decode_attention as dec
    check(dec._ARRIVALS and all(not bool(b.any())
                                for b in dec._ARRIVALS.values()),
          "decode_attention left an arrival counter non-zero")
    log(f"  decode_attention arrival counters all zero "
        f"({sum(b.numel() for b in dec._ARRIVALS.values())} counters)")
    return cases, errs


def recurrent_cases(torch):
    """(label, args) per recurrent case, in bf16 and float32: the serving
    paths' full-width shapes — recurrentgemma-2b's RG-LRU over 4 prompts of
    2304 tokens and 2560 channels, rwkv6-7b's WKV over 4 prompts of 512
    tokens and 64 heads of 64, its inputs (B, H, S, D) views of (B, S, H, D)
    projections as the model passes them — then odd shapes (S not a
    multiple of any chunk; D = 100 channels; head sizes 16, 32 and 48), and
    for RG-LRU runs of log_a = 0 (a fifth of it, and steps 100-399 all 0:
    a = 1, gate 0), strong decays (log_a in [-30, -10]), 4096 steps at full
    width, D = 2568 (no multiple of the kernel's 32 channels a block, but of
    16 bytes) and x and log_a one element past 16 bytes (one-element
    copies), for WKV6 strong decays (w = exp(-exp(2 + δ))), w exactly 0 (a
    fifth of it, and one whole step) and 2048 steps at full width.  Inputs
    otherwise follow the models' ranges: log_a = -8·softplus(Λ)·r lies in
    (-0.106, 0); the decay w = exp(-exp(w0 + δ)) with w0 = -4."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def log_a(*shape):
        return -0.106 * torch.rand(shape, generator=g, device="cuda")

    def bhsd(B, H, S, D, fn=rn):
        return fn(B, S, H, D).transpose(1, 2)

    def decay(*shape):
        return torch.exp(-torch.exp(-4.0 + 0.5 * rn(*shape)))

    def strong(*shape):              # w ~ e^-7.4, from ~0.2 down to 0
        return torch.exp(-torch.exp(2.0 + 0.5 * rn(*shape)))

    def zeros(*shape):               # a fifth of w exactly 0, a step all 0
        w = decay(*shape)
        w = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.2,
                        torch.zeros_like(w), w)
        w[:, 9] = 0.0
        return w

    def log_a_zeros(*shape):         # a fifth of log_a 0, a run of steps 0
        la = log_a(*shape)
        la = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.2,
                         torch.zeros_like(la), la)
        la[:, 100:400] = 0.0
        return la

    def log_a_strong(*shape):        # a from e^-10 down to e^-30
        return -10.0 - 20.0 * torch.rand(shape, generator=g, device="cuda")

    def off16(t):                    # the same values one element past 16 B
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    rglru, wkv = [], []
    for label, (B, S, D), fn, place in [
            ("full width", (SERVE_BATCH, RG_PROMPT, 2560), log_a, None),
            ("S=37 D=100", (3, 37, 100), log_a, None),
            ("log_a = 0 runs S=600", (2, 600, 2560), log_a_zeros, None),
            ("strong decays S=300", (2, 300, 2560), log_a_strong, None),
            ("full width S=4096", (SERVE_BATCH, 4096, 2560), log_a, None),
            ("S=129 D=2568", (2, 129, 2568), log_a, None),
            ("base off 16 bytes S=200 D=256", (2, 200, 256), log_a, off16)]:
        x, la = rn(B, S, D), fn(B, S, D)
        for dt in (torch.bfloat16, torch.float32):
            args = (x.to(dt), la.to(dt))
            if place is not None:
                args = tuple(place(t) for t in args)
            rglru.append((f"{label} {str(dt)[6:]}", args))
    for label, (B, H, S, D), fn in [
            ("full width", (SERVE_BATCH, 64, 512, 64), decay),
            ("S=37", (2, 3, 37, 64), decay),
            ("S=45 D=16", (2, 4, 45, 16), decay),
            ("S=70 D=32", (2, 3, 70, 32), decay),
            ("S=23 D=48", (2, 3, 23, 48), decay),
            ("strong decays S=200", (2, 16, 200, 64), strong),
            ("w = 0 S=200", (2, 16, 200, 64), zeros),
            ("full width S=2048", (SERVE_BATCH, 64, 2048, 64), decay)]:
        r, k, v = (bhsd(B, H, S, D) for _ in range(3))
        w = bhsd(B, H, S, D, fn)
        u = 0.1 * rn(H, D)
        for dt in (torch.bfloat16, torch.float32):
            wkv.append((f"{label} {str(dt)[6:]}",
                        tuple(t.to(dt) for t in (r, k, v, w, u))))
    return {"rglru_scan": rglru, "wkv6": wkv}


def recurrent_plain(name, args):
    """The kernel's plain PyTorch version, in float32, on the same (card)
    inputs."""
    from repro_torch.kernels import ref
    fn = ref.rglru if name == "rglru_scan" else ref.wkv6
    return fn(*(t.float() for t in args))


def rel_err(got, exp):
    """max |got - exp| over max(1, max |exp|)."""
    scale = max(1.0, float(exp.abs().max()))
    return float((got.float() - exp).abs().max()) / scale


def phase_recurrent_kernels(torch, kernels):
    cases = recurrent_cases(torch)
    errs = {}
    for name, runs in cases.items():
        kern = kernels[name]
        errs[name] = 0.0
        for label, args in runs:
            before = kern.launches
            routes = dict(getattr(kern, "routes", {}))
            out, state = kern(*args)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} did not launch")
            if name == "wkv6":
                want = "chunked" if args[0].dtype == torch.bfloat16 \
                    else "simt"
            else:        # 16-byte copies where every row starts on 16 bytes
                row = args[0].shape[2] * args[0].element_size()
                want = "scalar" if row % 16 or any(
                    t.data_ptr() % 16 for t in (*args, out)) else "vector"
            check(kern.routes[want] == routes[want] + 1,
                  f"{name} ({label}) did not take the {want} route")
            route = f", {want} route"
            exp_out, exp_state = recurrent_plain(name, args)
            check(out.dtype == args[0].dtype and out.shape == args[0].shape
                  and state.dtype == torch.float32
                  and state.shape == exp_state.shape,
                  f"{name} ({label}): {out.dtype} {tuple(out.shape)}, "
                  f"{state.dtype} {tuple(state.shape)}")
            e_out, e_state = rel_err(out, exp_out), rel_err(state, exp_state)
            tol = REC_TOL[(name, str(out.dtype)[6:])]
            tol_state = REC_TOL[(name, "float32")]
            check(e_out <= tol and e_state <= tol_state,
                  f"{name} ({label}) differs from its plain version: output "
                  f"{e_out} (tolerance {tol}), final state {e_state} "
                  f"(tolerance {tol_state}), relative to max(1, max |plain|)")
            errs[name] = max(errs[name],
                             float((out.float() - exp_out).abs().max()),
                             float((state - exp_state).abs().max()))
            log(f"  {name} [{label}]: relative err output {e_out:.3g} "
                f"(tolerance {tol}), final state {e_state:.3g} (tolerance "
                f"{tol_state}){route}")
    return cases, errs


def gmm_cases():
    """(label, E, Din, Dout, T, block_t, block_expert, misaligned w, counts)
    per grouped-matmul case: llama4-maverick's expert products as its MoE
    layers make them (gate/up: 5120 -> 8192, wo: 8192 -> 5120; prefill: 128
    experts x 24 slots; decode: x 8; block i on expert i), every row counted
    and with the row counts the model passes (a decode step's 4 tokens on 4
    of the 128 blocks, one row each; partial prefill counts), then odd ones
    — ragged Din and Dout, Dout not a multiple of the 16-byte vector, a
    block of more than one chunk of rows, one-row blocks, a weight tensor
    off 16-byte alignment (the CUDA-core kernel in bf16), Din = 0, counts
    that are all zero and partial counts over garbage rows — with unsorted
    block experts that repeat.  x holds random values past every count."""
    cases = []
    for din, dout in ((MOE_D, MOE_F), (MOE_F, MOE_D)):
        for phase, c in (("prefill", MOE_C_PREFILL), ("decode", MOE_C_DECODE)):
            cases.append((f"{phase} {din}->{dout}", MOE_E, din, dout,
                          MOE_E * c, c, "arange", False, None))
    for din, dout in ((DS_D, DS_F), (DS_F, DS_D)):
        for phase, c, kind in (("prefill", DS_C_PREFILL, None),
                               ("prefill", DS_C_PREFILL, "partial"),
                               ("decode", DS_C_DECODE, "top-8 decode")):
            cases.append((f"deepseek {phase} {din}->{dout}"
                          + (f" {kind} counts" if kind else ""), DS_E, din,
                          dout, DS_E * c, c, "arange", False, kind))
    cases += [("decode 5120->8192 model counts", MOE_E, MOE_D, MOE_F,
               MOE_E * MOE_C_DECODE, MOE_C_DECODE, "arange", False,
               "model decode"),
              ("prefill 8192->5120 partial counts", MOE_E, MOE_F, MOE_D,
               MOE_E * MOE_C_PREFILL, MOE_C_PREFILL, "arange", False,
               "partial"),
              ("Din 100 Dout 77 block_t 7", 3, 100, 77, 35, 7, "random",
               False, None),
              ("Din 37 Dout 264 block_t 40", 4, 37, 264, 120, 40, "random",
               False, None),
              ("block_t 1", 5, 513, 136, 9, 1, "random", False, None),
              ("misaligned w", 3, 64, 512, 48, 8, "random", True, None),
              ("Din 0", 2, 0, 16, 16, 8, "random", False, None),
              ("all-zero counts", 4, 64, 256, 64, 16, "random", False,
               "zero"),
              ("partial counts block_t 24", 5, 136, 264, 120, 24, "random",
               False, "partial"),
              ("partial counts block_t 100", 3, 128, 136, 300, 100, "random",
               False, "partial"),
              ("partial counts Din 100 Dout 77 block_t 7", 3, 100, 77, 35, 7,
               "random", False, "partial"),
              ("partial counts misaligned w", 3, 64, 512, 48, 8, "random",
               True, "partial")]
    return cases


def gmm_counts(torch, g, kind, E, nb, bt):
    """The (nb,) int32 row counts of a case, on the card: None, all zero,
    the model's decode step (llama4: 4 blocks of one row; deepseek-v3,
    ``"top-8 decode"``: each of the step's 4 tokens on 8 distinct experts)
    or partial (0, a third, block_t, block_t - 1, then drawn)."""
    if kind is None:
        return None
    counts = torch.zeros(nb, dtype=torch.int32, device="cuda")
    if kind == "model decode":
        counts[torch.randperm(nb, generator=g, device="cuda")[:4]] = 1
    elif kind == "top-8 decode":
        for _ in range(SERVE_BATCH):
            counts[torch.randperm(nb, generator=g, device="cuda")[:DS_K]] += 1
    elif kind == "partial":
        counts = torch.randint(0, bt + 1, (nb,), generator=g, device="cuda",
                               dtype=torch.int32)
        counts[:4] = torch.tensor([0, max(1, bt // 3), bt, bt - 1])[:nb]
    return counts


def gmm_route(x, w, out):
    """The grouped-matmul kernel the wrapper picks for these tensors."""
    from repro_torch.kernels import moe_gmm
    return moe_gmm._variant(x.dtype, w.shape[1], w.shape[2],
                            (x.data_ptr(), w.data_ptr(), out.data_ptr()))


def phase_gmm_kernel(torch, kernels):
    """The grouped matmul against its plain version, on the same inputs in
    the same dtype, each case on the kernel it should take (bf16 with
    widths and pointers 16-byte copies can take on the tensor cores, the
    rest on the CUDA cores), rows past a count exactly zero; the weights of
    a full-width case (21.5 GB in float32) live only while their case
    runs."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    kern = kernels["gmm"]
    err = 0.0
    for label, E, din, dout, T, bt, order, misaligned, kind in gmm_cases():
        w32 = torch.randn((E, din, dout), generator=g, device="cuda")
        w32.mul_(1.0 / max(din, 1) ** 0.5)
        x32 = torch.randn((T, din), generator=g, device="cuda")
        be = torch.arange(E, dtype=torch.int32, device="cuda") \
            if order == "arange" else torch.randint(
                0, E, (T // bt,), generator=g, device="cuda",
                dtype=torch.int32)
        counts = gmm_counts(torch, g, kind, E, T // bt, bt)
        for dt in (torch.bfloat16, torch.float32):
            x, w = x32.to(dt), w32.to(dt)
            if misaligned:      # the same values one element into a buffer
                buf = torch.empty(w.numel() + 1, dtype=dt, device="cuda")
                buf[1:].copy_(w.view(-1))
                w = buf[1:].view(E, din, dout)
            before = kern.launches
            got = kern(x, w, be, bt, counts)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, "gmm did not launch")
            exp = ref.gmm(x, w, be, bt, counts)
            what = f"gmm ({label} {str(dt)[6:]})"
            check(got.dtype == dt and got.shape == (T, dout),
                  f"{what}: {got.dtype} {tuple(got.shape)}")
            route = gmm_route(x, w, got)
            want = "mma" if dt == torch.bfloat16 and din % 8 == 0 \
                and dout % 8 == 0 and not misaligned else "simt"
            check(route == want, f"{what} took the {route} kernel, not "
                                 f"{want}")
            if counts is not None:
                past = torch.arange(bt, device="cuda")[None, :] \
                    >= counts[:, None]
                check(not got[past.reshape(-1)].any(),
                      f"{what}: rows past the counts not zero")
            e = rel_err(got, exp)
            tol = GMM_TOL[str(dt)[6:]]
            check(e <= tol, f"{what} differs from its plain version: {e} "
                            f"relative to max(1, max |plain|) > {tol}")
            err = max(err, float((got.float() - exp.float()).abs().max()))
            log(f"  gmm [{label} {str(dt)[6:]}]: relative err {e:.3g} "
                f"(tolerance {tol}), {route} kernel")
            del x, w, got, exp
        del w32, x32
        torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# phase 2b: flash attention's backward against its plain version
# ---------------------------------------------------------------------------

def flash_bwd_cases():
    """(label, (B, Hq, Hkv, Sq, Sk, D), masks and scale, v's width): the
    training shape's head width and group at S = 4096, D 64 / 128 / 192
    (MLA: v zero-padded from 128) / 256, groups of 1, 3, 5 and 8, causal,
    a 2048-token window, Sq != Sk, S = 1 and 17, bidirectional; D 40 and
    96, which the tensor-core instances at 64 and 128 take zero-filled;
    and rows one element into their buffer (bf16 rows off 16 bytes, for
    the CUDA-core route)."""
    return [
        ("train shape G=3 S=4096", (1, 6, 2, 4096, 4096, 128),
         dict(causal=True), 128),
        ("D=64 G=1", (2, 4, 4, 300, 300, 64), dict(causal=True), 64),
        ("D=128 G=8 window 2048 S=4096", (1, 8, 1, 4096, 4096, 128),
         dict(causal=True, window=2048), 128),
        ("D=256 G=5 window 2048", (1, 10, 2, 2304, 2304, 256),
         dict(causal=True, window=2048), 256),
        ("MLA D=192 v padded from 128", (2, 4, 4, 512, 512, DS_DQK),
         dict(causal=True, sm_scale=DS_DQK ** -0.5), DS_DV),
        ("Sq != Sk", (2, 6, 2, 100, 300, 128), dict(causal=True), 128),
        ("S=1", (2, 4, 2, 1, 1, 64), dict(causal=True), 64),
        ("S=17 bidirectional", (1, 5, 1, 17, 17, 128), dict(causal=False),
         128),
        ("D=256 ragged Sk bidirectional", (1, 3, 1, 70, 190, 256),
         dict(causal=False), 256),
        ("D=96 G=2 zero-filled", (2, 4, 2, 200, 200, 96),
         dict(causal=True), 96),
        ("D=40 G=4 zero-filled Sq != Sk", (1, 8, 2, 60, 130, 40),
         dict(causal=True), 40),
        ("misaligned rows D=128 G=2", (2, 8, 4, 100, 100, 128),
         dict(causal=True), 128)]


def bwd_rel_err(got, exp, floor):
    """max |got - exp| over the plain gradient's max |exp|, or over
    ``floor`` where that is smaller: a gradient that vanishes exactly (at
    S = 1, P = 1 and dP = Dsum, so dq = dk = 0) leaves both sides with
    rounding noise alone."""
    return float((got.float() - exp).abs().max()) / max(
        float(exp.abs().max()), floor)


def phase_flash_bwd_kernel(torch):
    """Each case in bf16 and float32, inputs (B, H, S, D) views of (B, S, H,
    D) projections as the models pass them: the forward with ``lse`` (the
    training call, offset Sk - Sq) against ``ref.mha_lse``, then the
    backward kernel against ``ref.flash_attention_bwd`` on the same q, k,
    v, out, lse and dout (tolerance ``ATTN_TOL`` relative to the plain
    gradient's max), a second call bitwise equal to the first, MLA's padded
    v columns' gradient zero; and the device operations of one backward
    call under ``torch.profiler``, on each route.  Each call runs on the
    route ``_bwd_variant`` picks (``flash_attention_bwd.routes``): every
    bf16 case at D <= 128 with rows on 16 bytes on the tensor cores
    (``"mma"``; D 40 and 96 zero-filled to an instance's width), against
    both the plain version that rounds P and dS to bf16 as the kernels do
    and the unrounded one; float32, bf16 at D 192 and 256 and bf16 rows
    off 16 bytes on the CUDA cores (``"simt"``, against the unrounded
    one).  The floor of the relative error's denominator is 1e-2
    of the largest |dO|·|v| product, a term of dP and Dsum; it binds only
    where a gradient vanishes (each case logs both).  Returns the largest
    relative errors."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def proj(B, S, H, width, D, dt, misaligned):
        t = torch.randn((B, S, H, width), generator=g, device="cuda").to(dt)
        t = F.pad(t, (0, D - width))
        if misaligned:
            flat = torch.empty(t.numel() + 1, dtype=dt, device="cuda")
            t = flat[1:].view(t.shape).copy_(t)
        return t.transpose(1, 2)

    errs = {"lse": 0.0, "grad": 0.0}
    ops = {}
    for label, (B, Hq, Hkv, Sq, Sk, D), kw, width in flash_bwd_cases():
        for dt in (torch.bfloat16, torch.float32):
            tag = f"{label} {str(dt)[6:]}"
            tol = ATTN_TOL[str(dt)[6:]]
            odd = "misaligned" in label
            q = proj(B, Sq, Hq, D, D, dt, odd)
            k = proj(B, Sk, Hkv, D, D, dt, odd)
            v = proj(B, Sk, Hkv, width, D, dt, odd)
            dout = proj(B, Sq, Hq, width, D, dt, odd)
            mask = dict(causal=kw["causal"], window=kw.get("window"),
                        sm_scale=kw.get("sm_scale") or D ** -0.5,
                        offset=Sk - Sq)
            before = fa.flash_attention.launches
            out, lse = fa._forward(q, k, v, mask["causal"], mask["window"],
                                   mask["sm_scale"], mask["offset"], True)
            torch.cuda.synchronize()
            check(fa.flash_attention.launches == before + 1,
                  f"flash_attention with lse ({tag}) did not launch")
            _o, lse_plain = ref.mha_lse(q.float(), k.float(), v.float(),
                                        **mask)
            live = lse_plain > -1e29
            check(torch.equal(live, lse > -1e29), f"flash lse ({tag}): rows "
                  f"with no visible key differ")
            e_lse = float((lse - lse_plain)[live].abs().max()) / max(
                1.0, float(lse_plain[live].abs().max())) if live.any() \
                else 0.0
            check(e_lse <= tol, f"flash lse ({tag}) differs from its plain "
                                f"version: {e_lse} > {tol}")

            def bwd():
                return fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                              **mask)
            route = "mma" if dt == torch.bfloat16 and D <= 128 \
                and not odd else "simt"
            picked = fa._bwd_variant(
                dt, D, [st for t in (q, k, v, out, dout)
                        for st in t.stride()[:3]],
                [t.data_ptr() for t in (q, k, v, out, dout)])
            check(picked == route, f"flash_attention_bwd ({tag}): "
                  f"_bwd_variant picked {picked}, not {route}")
            before = fa.flash_attention_bwd.launches
            routes = dict(fa.flash_attention_bwd.routes)
            got = bwd()
            torch.cuda.synchronize()
            check(fa.flash_attention_bwd.launches == before + 1,
                  f"flash_attention_bwd ({tag}) did not launch")
            check(fa.flash_attention_bwd.routes[route] == routes[route] + 1,
                  f"flash_attention_bwd ({tag}) did not run on {route}: "
                  f"{routes} -> {fa.flash_attention_bwd.routes}")
            again = bwd()
            check(all(torch.equal(a.view(torch.int16) if a.dtype ==
                                  torch.bfloat16 else a,
                                  b.view(torch.int16) if b.dtype ==
                                  torch.bfloat16 else b)
                      for a, b in zip(got, again)),
                  f"flash_attention_bwd ({tag}): two calls differ")
            plain = ref.flash_attention_bwd(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **mask)
            rounded = ref.flash_attention_bwd(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **mask, round_p=torch.bfloat16) \
                if route == "mma" else plain
            es, es_unrounded = [], []
            floor = 1e-2 * float(dout.abs().max()) * float(v.abs().max())
            for name, a, b, c, like in zip(("dq", "dk", "dv"), got, rounded,
                                           plain, (q, k, v)):
                check(a.dtype == dt and a.shape == like.shape,
                      f"flash_attention_bwd ({tag}) {name}: {a.dtype} "
                      f"{tuple(a.shape)}")
                es.append(bwd_rel_err(a, b, floor))
                es_unrounded.append(bwd_rel_err(a, c, floor))
                check(max(es[-1], es_unrounded[-1]) <= tol,
                      f"flash_attention_bwd ({tag}) {name} differs from its "
                      f"plain version: {es[-1]} (rounding P and dS as the "
                      f"route does), {es_unrounded[-1]} (unrounded) > {tol}")
            if width < D:
                check(not got[2][..., width:].any(), f"flash_attention_bwd "
                      f"({tag}): the padded v columns got a gradient")
            if route not in ops:
                ops[route] = device_ops(torch, bwd, 5)
                check(sum(ops[route].values()) == 15
                      and len(ops[route]) == 3,
                      f"flash_attention_bwd ({route}): device operations "
                      f"of 5 calls {ops[route]}, expected the 3 kernels "
                      f"once a call")
            errs["lse"] = max(errs["lse"], e_lse)
            errs["grad"] = max(errs["grad"], *es, *es_unrounded)
            peaks = "/".join(f"{float(b.abs().max()):.3g}" for b in plain)
            unrounded = "" if route == "simt" else (
                " (unrounded plain: " + "/".join(
                    f"{e:.3g}" for e in es_unrounded) + ")")
            log(f"  flash_attention_bwd [{tag}, {route}]: lse err "
                f"{e_lse:.3g}, dq/dk/dv err {es[0]:.3g}/{es[1]:.3g}/"
                f"{es[2]:.3g}{unrounded} of the plain max {peaks} (floor "
                f"{floor:.3g}; tolerance {tol}), two calls bitwise equal")
    log(f"  flash_attention_bwd: device operations of 5 calls "
        f"{json.dumps(ops)}")
    errs["device_ops_per_call"] = {
        route: {k: n / 5 for k, n in o.items()} for route, o in ops.items()}
    return errs


# ---------------------------------------------------------------------------
# phase 3: the same windows on the card and on the CPU
# ---------------------------------------------------------------------------

def parity_run(torch, pt, label, cfg, steps, ledger=False):
    """Run ``steps`` — callables (store, state) -> (state, outputs) — on a
    P=4 store of ``cfg`` on the remote-DMA backend, once on the card and
    once on the CPU: every state leaf and every output bitwise equal after
    every step.  Returns {device: (store, state, manager)}."""
    stores = {}
    for dev in ("cuda", "cpu"):
        mgr = pt.make_manager(4, device=dev, backend="pallas")
        if ledger:
            mgr.traffic.enable()
        kv = pt.KVStore(None, "kv", mgr, **cfg)
        stores[dev] = [kv, kv.init_state(), mgr]
    for i, step in enumerate(steps):
        out = {}
        for dev, s in stores.items():
            s[1], res = step(s[0], s[1])
            out[dev] = (pt.state_to_numpy(s[1]), res)
        for name in pt.KVStoreState._fields:
            a = getattr(out["cuda"][0], name)
            b = getattr(out["cpu"][0], name)
            for x, y in zip(a if isinstance(a, tuple) else [a],
                            b if isinstance(b, tuple) else [b]):
                check(x.dtype == y.dtype and np.array_equal(x, y),
                      f"{label} step {i}: state leaf {name} differs cuda vs "
                      f"cpu")
        for x, y in zip(out["cuda"][1], out["cpu"][1]):
            check(torch.equal(x.cpu(), y),
                  f"{label} step {i}: result differs cuda vs cpu")
    return {dev: tuple(s) for dev, s in stores.items()}


def window_step(ops, ks, vals, **kw):
    return lambda kv, st: kv.op_window(st, ops, ks, vals, **kw)


def phase_parity(torch, pt):
    """Phase 3's map stores on the card and on the CPU: the locked store
    through 20 windows; a lock-free store through the same 20, then
    all-UPDATE and pure-GET windows (the fast path), its fastpath ledger
    rows equal too; a heat-tracked store under skewed readers, one
    rebalance, then a mixed window."""
    Pp, Bp, keys = 4, 8, np.arange(1, 41, dtype=np.uint32)
    cfg = dict(slots_per_node=8, value_width=W, num_locks=8,
               index_capacity=48)
    rng = np.random.default_rng(SEED + 1)
    windows = []
    for w in range(20):
        if w % 5 == 4:       # every lane hammers one key
            ks = np.full((Pp, Bp), keys[w % keys.size], np.uint32)
        else:
            ks = rng.choice(keys, size=(Pp, Bp)).astype(np.uint32)
        ops = rng.choice([GET, UPDATE, INSERT, DELETE, NOP],
                         size=(Pp, Bp), p=[.3, .2, .3, .1, .1]).astype(np.int32)
        vals = rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32)
        windows.append((ops, ks, vals))
    stores = parity_run(torch, pt, "locked store", cfg,
                        [window_step(*w) for w in windows])
    st = pt.state_to_numpy(stores["cpu"][1])
    log(f"  20 windows bitwise equal on cuda and cpu (free slots left per "
        f"participant: {st.free_top.tolist()}, index overflow: "
        f"{st.idx_overflow.tolist()})")

    # the lock-free store: the same windows, then commuting ones
    live = keys[:16]
    fast = [(np.full((Pp, Bp), UPDATE, np.int32),
             rng.choice(live, size=(Pp, Bp)).astype(np.uint32),
             rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32)),
            (np.full((Pp, Bp), GET, np.int32),
             rng.choice(keys, size=(Pp, Bp)).astype(np.uint32),
             np.zeros((Pp, Bp, W), np.int32)),
            (np.where(rng.random((Pp, Bp)) < .5, UPDATE, GET).astype(
                np.int32), np.full((Pp, Bp), live[3], np.uint32),
             rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32))]
    stores = parity_run(torch, pt, "lock-free store",
                        dict(cfg, lockfree=True),
                        [window_step(*w) for w in windows + fast],
                        ledger=True)
    rows = {dev: s[2].traffic.fastpath_summary() for dev, s in stores.items()}
    check(rows["cuda"] == rows["cpu"], f"fastpath rows differ: {rows}")
    r = rows["cuda"]["kv"]
    check(r["windows"] == len(windows) + len(fast) and
          r["fast_windows"] >= len(fast),
          f"lock-free store's fastpath rows {r}")
    log(f"  lock-free store: {len(windows) + len(fast)} windows bitwise "
        f"equal on cuda and cpu; fastpath rows equal, {r}")

    # the heat-tracked store: skewed readers, a rebalance, a mixed window
    hcfg = dict(slots_per_node=16, value_width=W, num_locks=16,
                index_capacity=128, track_heat=True)
    hkeys = np.arange(1, Pp * Bp + 1, dtype=np.uint32)
    steps = [window_step(np.full((Pp, Bp), INSERT, np.int32),
                         hkeys.reshape(Pp, Bp),
                         np.stack([hkeys * 3, hkeys * 5], -1).astype(
                             np.int32).reshape(Pp, Bp, W))]
    for _ in range(4):
        # reader r reads keys k = r mod 4, now and then another one
        rk = np.stack([rng.choice(hkeys[hkeys % Pp == r], Bp)
                       for r in range(Pp)]).astype(np.uint32)
        noise = rng.random((Pp, Bp)) < READ_NOISE
        rk[noise] = rng.choice(hkeys, int(noise.sum()))

        def read(kv, st, rk=rk):
            st, values, found = kv.get_batch(st, rk)
            return st, (values, found)
        steps.append(read)
    moved = []

    def rebalance(kv, st):
        st, n = kv.rebalance(st, 16)
        moved.append(int(n[0]))
        return st, (n,)
    steps.append(rebalance)
    mix = rng.choice([GET, UPDATE, INSERT, DELETE], size=(Pp, Bp)).astype(
        np.int32)
    steps.append(window_step(
        mix, rng.choice(np.arange(1, 49, dtype=np.uint32), (Pp, Bp)),
        rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32)))
    parity_run(torch, pt, "heat-tracked store", hcfg, steps)
    check(moved[0] == moved[1] > 0, f"rebalance moved {moved} rows")
    log(f"  heat-tracked store: prefill, 4 skewed read windows, a rebalance "
        f"({moved[0]} moves) and a mixed window bitwise equal on cuda and "
        f"cpu, heat counters included")


def phase_serving_parity(torch, pt):
    for arch in dict.fromkeys(path["arch"] for path in SERVE_PATHS):
        serving_parity(torch, pt, arch)


def serving_parity(torch, pt, arch):
    """The smoke engine of ``arch`` from the CPU tests, float32, one set of
    weights: generated tokens equal and the page-table state bitwise equal
    on the card and on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(1, cfg.vocab, size=(12,)).astype(np.int32)
               for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, max_batch=2, max_seq=48, device=dev,
                            params=tree_to(params, dev))
        out[dev] = (eng.generate(prompts, gen_len=4),
                    pt.state_to_numpy(eng._kv_state), eng.stats())
    check(out["cuda"][0] == out["cpu"][0],
          f"smoke {arch} engine tokens differ: cuda {out['cuda'][0]} vs cpu "
          f"{out['cpu'][0]}")
    for name in pt.KVStoreState._fields:
        a, b = getattr(out["cuda"][1], name), getattr(out["cpu"][1], name)
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"smoke {arch} engine page-table leaf {name} differs cuda "
                  f"vs cpu")
    check(out["cuda"][2]["kv_ops"] == out["cpu"][2]["kv_ops"],
          f"smoke {arch} engine kv_ops differ")
    log(f"  smoke {arch} engine: tokens {out['cuda'][0]} equal on cuda and "
        f"cpu, page table bitwise equal, kv_ops {out['cuda'][2]['kv_ops']}")


def cross_model_parity(torch):
    """The smoke llama-3.2-vision and whisper models in float32 on the card
    and on the CPU from one set of weights, with the vlm's gates set to
    seeded non-zero values (at the init's 0 a cross layer adds nothing) and
    a random seeded context: prefill's logits, three decode steps' logits
    and every cache leaf within 1e-4; and another context must move the
    card's logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.tree import flatten
    for arch in (VISION_ARCH, WHISPER_ARCH):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED + 12)
        for layer in params.get("layers", []):
            for name in ("gate_attn", "gate_ffn"):
                if name in layer:
                    layer[name] = torch.tensor(
                        float(rng.uniform(0.3, 1.2) * rng.choice([-1, 1])))
        B, S, s_max = 2, 10, 16
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
        ctx, other_ctx = (torch.from_numpy(rng.standard_normal(
            (B, cfg.cross.n_context_tokens, cfg.d_model)).astype(np.float32))
            for _ in range(2))
        steps = [torch.from_numpy(rng.integers(1, cfg.vocab, (B, 1))
                                  .astype(np.int32)) for _ in range(3)]
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_to(params, dev)
            lg, cache, pos = model.prefill(
                p, {"tokens": tokens.to(dev), "context": ctx.to(dev)}, s_max)
            outs = [lg]
            for tok in steps:
                lg, cache = model.decode_step(p, tok.to(dev), cache, pos)
                pos = pos + 1
                outs.append(lg)
            res[dev] = (outs, flatten(cache))
            if dev == "cuda":
                other, _c, _p = model.prefill(
                    p, {"tokens": tokens.to(dev),
                        "context": other_ctx.to(dev)}, s_max)
                moved = float((other - outs[0]).abs().max())
                check(moved > 1e-3, f"smoke {arch}: another context moved "
                                    f"the card's logits by only {moved}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(res["cuda"][0], res["cpu"][0])):
            d = float((a.cpu() - b).abs().max())
            check(d <= 1e-4, f"smoke {arch} logits {i}: cuda and cpu differ "
                             f"by {d}")
            worst = max(worst, d)
        for (path, a), (_p, b) in zip(res["cuda"][1], res["cpu"][1]):
            d = float((a.cpu() - b).abs().max())
            check(a.device.type == "cuda" and d <= 1e-4,
                  f"smoke {arch} cache {path}: {a.device}, cuda and cpu "
                  f"differ by {d}")
            worst = max(worst, d)
        log(f"  smoke {arch} model (seeded gates, random context): prefill, "
            f"3 decode steps and {len(res['cuda'][1])} cache leaves within "
            f"{worst:.3g} cuda vs cpu; another context moves the logits by "
            f"{moved:.3g}")


def np_tree(x):
    """A (nested) NamedTuple of tensors as numpy leaves, the port's int64
    uint32 holders back as uint32."""
    if isinstance(x, tuple):
        vals = [np_tree(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    a = x.detach().cpu().numpy()
    return (a & 0xFFFFFFFF).astype(np.uint32) if a.dtype == np.int64 else a


def trees_equal(a, b):
    """Bitwise equality of two numpy trees: same structure, dtypes, bits."""
    if isinstance(a, tuple):
        return type(a) is type(b) and len(a) == len(b) and all(
            trees_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def phase_replicated_parity(torch, pt, devices=("cuda", "cpu")):
    """The smoke llama3.2-3b engine with two page-table replicas on the
    remote-DMA backend, its log leader killed before mutation window 1 and
    revived at window 6 (a cursor gap past the 3-entry ring: the snapshot
    rejoin runs), float32, one set of weights, on the card and on the CPU:
    equal tokens, and the page table, every replica, the log and the
    detector bitwise equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import FaultPlan
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config(SERVE_ARCH).replace(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(1, cfg.vocab, size=(12,)).astype(np.int32)
               for _ in range(4)]
    out = {}
    for dev in devices:
        eng = ServingEngine(cfg, max_batch=2, max_seq=48, replicas=2,
                            fault_plan=FaultPlan(kills={0: 1},
                                                 revives={0: 6}),
                            backend="pallas", device=dev,
                            params=tree_to(params, dev))
        toks = eng.generate(prompts, gen_len=4)
        out[dev] = (toks, np_tree((eng._kv_state, eng._rep_states,
                                   eng._log_state, eng._det_state)),
                    eng.stats()["replication"], eng.page_log.ring.publishes)
    card, cpu = (out[d] for d in devices)
    check(card[0] == cpu[0], f"replicated smoke engine tokens differ: cuda "
                             f"{card[0]} vs cpu {cpu[0]}")
    for i, part in enumerate(("page table", "replicas", "log", "detector")):
        check(trees_equal(card[1][i], cpu[1][i]),
              f"replicated smoke engine: {part} state differs cuda vs cpu")
    rep = card[2]
    check(rep == cpu[2] and card[3] == cpu[3],
          "replication stats differ cuda vs cpu")
    check(rep["detected_failovers"] == 1 and rep["rejoins_snapshot"] == 1
          and rep["diverged_leaves"] == [0, 0] and rep["dropped"] == 0,
          f"replicated smoke engine: {rep}")
    log(f"  replicated smoke {SERVE_ARCH} engine (pallas, kill 1, revive 6): "
        f"tokens {card[0]} equal on cuda and cpu; page table, replicas, log "
        f"and detector bitwise equal; {card[3]} ring publishes; replication "
        f"{rep}")


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def train_parity(torch):
    """One float32 training step of the smoke llama3.2-3b from one set of
    weights and one batch, on the card and on the CPU, with AdamW, with
    Adafactor and with AdamW over 2 microbatches: the loss, every parameter
    and every optimizer-state leaf within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten, tree_map
    cfg = get_smoke_config(TRAIN_ARCH).replace(dtype="float32")
    params0 = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    batch = SyntheticTokens(cfg, 4, 32, SEED).get_batch(0)
    for label, tkw in (("AdamW", {}),
                       ("Adafactor", dict(optimizer="adafactor")),
                       ("AdamW, microbatch=2", dict(microbatch=2))):
        res = {}
        for dev in ("cuda", "cpu"):
            _model, opt, step = make_train_step(
                cfg, TrainConfig(lr=1e-3, **tkw), dev)
            params = tree_map(lambda t: t.detach().to(dev, copy=True),
                              params0)
            params, state, met = step(params, opt.init(params), batch)
            res[dev] = (flatten({"params": params, "opt": state}),
                        float(met["loss"]))
        worst = 0.0
        for (path, a), (_p, b) in zip(*(res[d][0] for d in ("cuda", "cpu"))):
            check(a.device.type == "cuda" and a.shape == b.shape,
                  f"train step ({label}) {path}: {a.device} "
                  f"{tuple(a.shape)} vs {tuple(b.shape)}")
            d = float((a.detach().cpu().float() - b.detach().float())
                      .abs().max()) if a.numel() else 0.0
            check(d <= 1e-4, f"train step ({label}) {path}: cuda and cpu "
                             f"differ by {d}")
            worst = max(worst, d)
        check(abs(res["cuda"][1] - res["cpu"][1]) <= 1e-4 * abs(
            res["cpu"][1]), f"train step ({label}): loss {res['cuda'][1]} "
            f"vs {res['cpu'][1]}")
        log(f"  smoke {TRAIN_ARCH} train step ({label}): loss "
            f"{res['cuda'][1]:.6f} / {res['cpu'][1]:.6f}, "
            f"{len(res['cuda'][0])} parameter and state leaves within "
            f"{worst:.3g} cuda vs cpu")


# ---------------------------------------------------------------------------
# phase 4: the main path at a deployment's size
# ---------------------------------------------------------------------------

class Oracle:
    """Sequential replay of the window semantics: GETs see the state at the
    window start; mutations apply in (participant, lane) order; an INSERT
    takes a slot of its writer's node and fails on a present key or a full
    node."""

    def __init__(self, keys, slots):
        self.present = np.zeros(keys + 1, dtype=bool)
        self.value = np.zeros((keys + 1, W), dtype=np.int32)
        self.home = np.zeros(keys + 1, dtype=np.int64)
        self.free = np.full(P, slots, dtype=np.int64)

    def window(self, ops, keys, vals):
        """Expected (GET values, found) of one (P, B) window."""
        flat_k = keys.reshape(-1).astype(np.int64)
        exp_found = np.zeros(P * B, dtype=bool)
        exp_val = np.zeros((P * B, W), dtype=np.int32)
        is_get = ops.reshape(-1) == GET
        exp_found[is_get] = self.present[flat_k[is_get]]
        exp_val[is_get] = np.where(exp_found[is_get, None],
                                   self.value[flat_k[is_get]], 0)
        flat_v = vals.reshape(-1, W)
        for n in np.flatnonzero(~is_get & (ops.reshape(-1) != NOP)):
            op, k, p = ops.reshape(-1)[n], flat_k[n], n // B
            if op == INSERT:
                ok = not self.present[k] and self.free[p] > 0
                if ok:
                    self.present[k], self.home[k] = True, p
                    self.free[p] -= 1
            else:
                ok = bool(self.present[k])
                if ok and op == DELETE:
                    self.present[k] = False
                    self.free[self.home[k]] += 1
            if ok and op in (INSERT, UPDATE):
                self.value[k] = flat_v[n]
            exp_found[n] = ok
        return exp_val.reshape(P, B, W), exp_found.reshape(P, B)


def zipf_sampler(rng):
    ranks = np.arange(1, KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** ZIPF_THETA)
    cdf /= cdf[-1]
    scramble = rng.permutation(KEYS) + 1          # rank → key
    return lambda n: scramble[np.minimum(np.searchsorted(cdf, rng.random(n)),
                                         KEYS - 1)].astype(np.uint32)


def mixed_window(rng, w):
    """The examples/kvstore_app.py mix: 60/20/10/10 GET/UPDATE/INSERT/DELETE
    over P·B distinct uniform keys."""
    span = P * B
    ks = rng.choice(KEYS, size=span, replace=False).astype(np.uint32) + 1
    ops = rng.choice([GET, UPDATE, INSERT, DELETE], size=span,
                     p=[.6, .2, .1, .1]).astype(np.int32)
    vals = np.stack([ks.astype(np.int32) * 5 + w,
                     np.full(span, w, np.int32)], 1)
    return ops.reshape(P, B), ks.reshape(P, B), vals.reshape(P, B, W)


def zipf_window(zipf, rng, w):
    """YCSB-B: 95/5 GET/UPDATE over zipf keys, duplicates allowed."""
    span = P * B
    ks = zipf(span)
    ops = np.where(rng.random(span) < 0.95, GET, UPDATE).astype(np.int32)
    vals = np.stack([ks.astype(np.int32) * 7 + w,
                     np.full(span, -w, np.int32)], 1)
    return ops.reshape(P, B), ks.reshape(P, B), vals.reshape(P, B, W)


def profiled_windows(torch, kv, st, oracle, windows, label):
    """Run ``windows`` under torch.profiler: the device's busy share of the
    wall time (kernels, copies and fills on the card), the host reads
    (``item``/``bool``, ``nonzero``) per window and the busiest device
    operations.  Every window is oracle-checked."""
    from torch.profiler import ProfilerActivity, profile
    results = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for ops, ks, vals in windows:
            st, res = kv.op_window(st, ops, ks, vals)
            results.append(res)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for i, ((ops, ks, vals), res) in enumerate(zip(windows, results)):
        verify(res, oracle.window(ops, ks, vals), f"profiled {label} {i}")
    device_us, by_name, host_reads = 0.0, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            device_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        elif e.name in ("aten::_local_scalar_dense", "aten::nonzero"):
            host_reads[e.name] = host_reads.get(e.name, 0) + 1
    n = len(windows)
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]
    out = dict(windows=n, wall_ms_per_window=wall_us / n / 1e3,
               device_busy_share=(device_us / wall_us) if device_us else None,
               host_reads_per_window={k: v / n for k, v in host_reads.items()},
               top_device_ms_per_window={k[:60]: v / n / 1e3 for k, v in top})
    log(f"  profile ({label}): {json.dumps(out)}")
    return st, out


def timed_window(torch, kv, st, ops, keys, vals):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, res = kv.op_window(st, ops, keys, vals)
    torch.cuda.synchronize()
    return st, res, time.perf_counter() - t0


def verify(res, exp, what):
    exp_val, exp_found = exp
    found = res.found.cpu().numpy()
    check(np.array_equal(found, exp_found),
          f"{what}: {int((found != exp_found).sum())} lanes' found differ "
          f"from the oracle")
    check(np.array_equal(res.value.cpu().numpy(), exp_val),
          f"{what}: GET values differ from the oracle")


def tree_clone(tree):
    """A copy of every tensor of a (nested) NamedTuple state."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_clone(v) for v in tree))
    return tree.clone()


def differing_leaves(torch, a, b, prefix=""):
    """Paths of the leaves on which two states differ (bitwise, on the
    device)."""
    if isinstance(a, tuple):
        out = []
        for f in a._fields:
            out += differing_leaves(torch, getattr(a, f), getattr(b, f),
                                    f"{prefix}{f}.")
        return out
    same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return [] if same else [prefix.rstrip(".")]


def kernel_counts(rdma):
    return {k.__name__: k.launches for k in rdma.KERNELS}


def window_stats(times, span):
    return dict(p50_ms=float(np.percentile(times, 50)) * 1e3,
                p99_ms=float(np.percentile(times, 99)) * 1e3,
                ops_per_s=span * len(times) / float(np.sum(times)))


def phase_main_path(torch, pt, rdma, slots):
    """The KVStore path: the locked store and, from the prefilled state on
    (phase 4a), its lock-free twin run the same windows, the twin bitwise
    equal to the locked store after every one; then the migration scenario
    (phase 4c) on the final state.  The timed and profiled windows run with
    the traffic ledger off on both stores; the twin's fast-path rows come
    from an untimed replay of the same windows with its ledger on.  Returns
    the metrics and the remote-DMA kernels' launches, counted from 0 over
    this path alone."""
    cfg = dict(slots_per_node=slots, value_width=W, num_locks=4096,
               index_capacity=4 * KEYS)
    mgr = pt.make_manager(P, backend="pallas")
    kv = pt.KVStore(None, "kv", mgr, **cfg)
    st = kv.init_state()
    torch.cuda.synchronize()
    log(f"  store: P={P} K={KEYS} slots/node={slots} index={4 * KEYS} "
        f"locks=4096 window={B}/participant; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    rng = np.random.default_rng(SEED + 2)
    oracle = Oracle(KEYS, slots)
    span = P * B
    n_fill = int(KEYS * FILL)
    fill_keys = np.arange(1, n_fill + 1, dtype=np.uint32)
    for k in rdma.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # -- prefill: 80% of K through INSERT windows
    t_fill = 0.0
    n_windows = 0
    for i in range(0, n_fill, span):
        chunk = fill_keys[i:i + span]
        ops = np.full(span, NOP, np.int32)
        ks = np.ones(span, np.uint32)
        vals = np.zeros((span, W), np.int32)
        ops[:chunk.size] = INSERT
        ks[:chunk.size] = chunk
        vals[:chunk.size, 0] = chunk.astype(np.int32) * 3
        ops, ks, vals = ops.reshape(P, B), ks.reshape(P, B), \
            vals.reshape(P, B, W)
        st, res, dt = timed_window(torch, kv, st, ops, ks, vals)
        t_fill += dt
        n_windows += 1
        verify(res, oracle.window(ops, ks, vals),
               f"prefill window {i // span}")
    check(int(oracle.present.sum()) == n_fill, "prefill lost keys")
    log(f"  prefill: {n_fill} inserts in {n_windows} windows, oracle-checked")
    # the locked store's peak over its prefill, before any twin exists
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # -- 4a: the lock-free twin, from a copy of the prefilled state
    lf_mgr = pt.make_manager(P, backend="pallas")
    lf = pt.KVStore(None, "kv", lf_mgr, lockfree=True, **cfg)
    lst = tree_clone(st)
    torch.cuda.synchronize()
    log(f"  4a: lock-free twin from the prefilled state; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")

    def both(ops, ks, vals, what, counts=None, record=None):
        """The window on the locked store, then on the twin: both
        oracle-checked, the twin's state bitwise the locked one's."""
        nonlocal st, lst
        exp = oracle.window(ops, ks, vals)
        if record is not None:
            record.append(((ops, ks, vals), exp))
        st, res, dt = timed_window(torch, kv, st, ops, ks, vals)
        verify(res, exp, what)
        before = kernel_counts(rdma)
        lst, lres, ldt = timed_window(torch, lf, lst, ops, ks, vals)
        after = kernel_counts(rdma)
        verify(lres, exp, f"lock-free {what}")
        diff = differing_leaves(torch, st, lst)
        check(not diff, f"{what}: the lock-free twin differs from the locked "
                        f"store on {diff}")
        if counts is not None:
            counts.append({k: after[k] - before[k] for k in after})
        return dt, ldt

    def fastpath_replay(start, recorded, what):
        """The recorded windows again on a copy of the twin's state from
        before them, untimed and with the twin's ledger on: every result
        oracle-checked, the end state bitwise the timed twin's.  Returns
        the twin's fastpath row over these windows."""
        lf_mgr.traffic.reset()
        lf_mgr.traffic.enable()
        rst = start
        for i, (win, exp) in enumerate(recorded):
            rst, res = lf.op_window(rst, *win)
            verify(res, exp, f"ledger replay of {what} {i}")
        lf_mgr.traffic.disable()
        diff = differing_leaves(torch, rst, lst)
        check(not diff, f"the ledger replay of the {what}s ends off the timed "
                        f"twin on {diff}")
        return lf_mgr.traffic.fastpath_summary()["kv"]

    # -- the examples/kvstore_app.py mix over distinct uniform keys
    mix_t, lf_mix_t, recorded = [], [], []
    start = tree_clone(lst)
    for w in range(MIX_WINDOWS):
        dt, ldt = both(*mixed_window(rng, w), f"mixed window {w}",
                       record=recorded)
        mix_t.append(dt)
        lf_mix_t.append(ldt)
    mix_fast = fastpath_replay(start, recorded, "mixed window")
    check(mix_fast["windows"] == MIX_WINDOWS and mix_fast["fast_rate"] == 0.0,
          f"every mixed window holds INSERT and DELETE lanes, so none may "
          f"take the fast path: {mix_fast}")
    log(f"  {MIX_WINDOWS} mixed windows oracle-checked; the lock-free twin "
        f"bitwise equal after each, fastpath {mix_fast}")

    # -- YCSB-B: 95/5 GET/UPDATE over zipf keys, duplicates allowed
    zipf = zipf_sampler(rng)
    zipf_t, lf_zipf_t, lf_counts, recorded = [], [], [], []
    start = tree_clone(lst)
    for w in range(ZIPF_WINDOWS):
        dt, ldt = both(*zipf_window(zipf, rng, w), f"zipf window {w}",
                       counts=lf_counts, record=recorded)
        zipf_t.append(dt)
        lf_zipf_t.append(ldt)
    zipf_fast = fastpath_replay(start, recorded, "zipf window")
    del start, recorded
    check(zipf_fast["windows"] == ZIPF_WINDOWS
          and zipf_fast["fast_rate"] == 1.0,
          f"every zipf window must take the fast path: {zipf_fast}")
    # a fast window's launches: the GETs' read verb (descriptors + row
    # gather) and ONE write verb (descriptors + row commit), nothing else
    one_write = {"build_descriptors": 2, "gather_rows": 1, "scatter_rows": 1}
    check(all(c == one_write for c in lf_counts),
          f"a fast zipf window's launches differ from one read verb and one "
          f"write verb: {lf_counts}")
    log(f"  {ZIPF_WINDOWS} zipf windows oracle-checked; the lock-free twin "
        f"bitwise equal after each, fastpath {zipf_fast}, launches a window "
        f"{lf_counts[0]}")

    # -- where a window's time goes: two more windows of each mix under
    # the profiler on each store (untimed above, oracle-checked, the twin
    # bitwise equal at the end)
    profiles, lf_profiles = {}, {}
    for label, gen in [("mixed", lambda w: mixed_window(rng, w)),
                       ("zipf", lambda w: zipf_window(zipf, rng, w))]:
        wins = [gen(100 + w) for w in range(2)]
        probe = Oracle.__new__(Oracle)
        probe.__dict__ = {k: v.copy() for k, v in oracle.__dict__.items()}
        st, profiles[label] = profiled_windows(torch, kv, st, oracle, wins,
                                               label)
        lst, lf_profiles[label] = profiled_windows(
            torch, lf, lst, probe, wins, f"lock-free {label}")
        diff = differing_leaves(torch, st, lst)
        check(not diff, f"profiled {label}: the twin differs on {diff}")

    # -- a final read of random keys through get_batch
    probe = rng.integers(1, KEYS + 1, size=(P, B)).astype(np.uint32)
    _st, values, found = kv.get_batch(st, probe)
    exp_found = oracle.present[probe.astype(np.int64)]
    check(np.array_equal(found.cpu().numpy(), exp_found),
          "get_batch found differs from the oracle")
    check(np.array_equal(values.cpu().numpy(),
                         np.where(exp_found[..., None],
                                  oracle.value[probe.astype(np.int64)], 0)),
          "get_batch values differ from the oracle")
    log(f"  get_batch of {P * B} random keys oracle-checked")
    del lst, _st
    torch.cuda.synchronize()
    peak_twin = torch.cuda.max_memory_allocated()

    # -- 4c: the migration scenario on the final state
    migration = phase_migration(torch, pt, cfg, st, oracle, slots)
    torch.cuda.synchronize()
    launches = kernel_counts(rdma)
    zs, lzs = window_stats(zipf_t, span), window_stats(lf_zipf_t, span)
    ms, lms = window_stats(mix_t, span), window_stats(lf_mix_t, span)
    return dict(
        prefill_ops=n_fill, prefill_windows=n_windows, prefill_s=t_fill,
        prefill_ops_per_s=n_fill / t_fill,
        mix_window_p50_ms=ms["p50_ms"], mix_window_p99_ms=ms["p99_ms"],
        mix_ops_per_s=ms["ops_per_s"],
        zipf_window_p50_ms=zs["p50_ms"], zipf_window_p99_ms=zs["p99_ms"],
        zipf_ops_per_s=zs["ops_per_s"],
        peak_device_gib=peak / 2 ** 30,
        peak_device_gib_with_twin=peak_twin / 2 ** 30, profile=profiles,
        lockfree=dict(mix=dict(lms, fastpath=mix_fast),
                      zipf=dict(lzs, fastpath=zipf_fast,
                                launches_per_window=lf_counts[0]),
                      profile=lf_profiles),
        migration=migration), launches


def reader_keys(rng, n_keys):
    """One (P, B) skewed read window (benchmarks/bench_locality.py): reader
    r draws zipf(0.99) ranks from its shard {k = r mod P}, rank i being key
    (i - 1)·P + r (key 0 read as P), and 10% of the lanes are uniform
    noise."""
    shard = n_keys // P
    ranks = np.arange(1, shard + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** ZIPF_THETA)
    cdf /= cdf[-1]
    rank = np.minimum(np.searchsorted(cdf, rng.random((P, B))), shard - 1)
    keys = rank.astype(np.int64) * P + np.arange(P)[:, None]
    keys = np.where(keys == 0, P, keys)
    noise = rng.random((P, B)) < READ_NOISE
    keys[noise] = rng.integers(1, n_keys + 1, size=int(noise.sum()))
    return keys.astype(np.uint32)


def phase_migration(torch, pt, cfg, st, oracle, slots):
    """Phase 4c: a heat-tracked twin of the store gets the final state's
    leaves and a fresh heat leaf; MIGRATION_READS skewed read windows feed
    the HotTracker; ``rebalance(REBALANCE_MOVES)`` runs up to
    REBALANCE_PASSES times (moves plus backlog must equal the proposals
    each pass made); the first read window is read again and its modeled
    wire bytes must fall; every GET, and a mixed window after the
    migration, are oracle-checked."""
    mgr = pt.make_manager(P, backend="pallas")
    mgr.traffic.enable()
    kv = pt.KVStore(None, "kv", mgr, track_heat=True, **cfg)
    hst = st._replace(heat=kv.hot.init_state())
    rng = np.random.default_rng(SEED + 9)
    reads = [reader_keys(rng, KEYS) for _ in range(MIGRATION_READS)]

    def read(keys, what):
        nonlocal hst
        hst, values, found = kv.get_batch(hst, keys)
        k = keys.astype(np.int64)
        exp = oracle.present[k]
        check(np.array_equal(found.cpu().numpy(), exp),
              f"{what}: found differs from the oracle")
        check(np.array_equal(values.cpu().numpy(), np.where(
            exp[..., None], oracle.value[k], 0)),
            f"{what}: values differ from the oracle")

    def wire_bytes(keys):
        """Modeled wire bytes of one read window (its state is dropped)."""
        mgr.traffic.reset()
        kv.get_batch(hst, keys)
        return mgr.traffic.total_bytes()

    wire_before = wire_bytes(reads[0])
    for i, keys in enumerate(reads):
        read(keys, f"skewed read window {i}")
    passes = []
    for i in range(REBALANCE_PASSES):
        _k, _d, valid, _a, _av = kv.rebalance_proposals(
            hst, REBALANCE_MOVES, with_alts=True)
        n_prop = int(valid.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hst, n_moved = kv.rebalance(hst, REBALANCE_MOVES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved, backlog = int(n_moved[0]), int(hst.heat.backlog[0])
        check(0 <= moved <= n_prop and moved + backlog == n_prop
              and (n_moved == moved).all(),
              f"rebalance pass {i}: {moved} moves and backlog {backlog} for "
              f"{n_prop} proposals")
        passes.append(dict(proposals=n_prop, moves=moved, backlog=backlog,
                           ms=dt * 1e3))
        if n_prop == 0:
            break
    check(sum(p["moves"] for p in passes) > 0, "rebalance moved no row")
    # the oracle follows the moves: homes and free slots from the index,
    # once the index holds exactly the oracle's keys, each in one entry
    # with a home on the cluster, and every home's free stack is its slots
    # less the rows it homes
    idx = hst.idx[0].cpu().numpy()
    used = idx[:, 0] == 1
    homes = idx[used]
    keys = homes[:, 1].astype(np.uint32).astype(np.int64)
    check(np.array_equal(np.sort(keys), np.flatnonzero(oracle.present)),
          "the index's keys differ from the oracle's across migration")
    check(bool(((homes[:, 2] >= 0) & (homes[:, 2] < P)).all()),
          "an index entry names a home off the cluster")
    free = slots - np.bincount(homes[:, 2], minlength=P)
    check(np.array_equal(hst.free_top.cpu().numpy(), free),
          f"the homes' free stacks differ from their rows: "
          f"{hst.free_top.tolist()} vs {free.tolist()}")
    oracle.home[keys] = homes[:, 2]
    oracle.free = free
    wire_after = wire_bytes(reads[0])
    read(reads[0], "skewed read window 0 after migration")
    check(wire_after < wire_before,
          f"the skewed read window's modeled wire bytes did not fall: "
          f"{wire_before} -> {wire_after}")
    ops, ks, vals = mixed_window(rng, 200)
    hst, res = kv.op_window(hst, ops, ks, vals)
    verify(res, oracle.window(ops, ks, vals), "mixed window after migration")
    out = dict(read_windows=MIGRATION_READS, passes=passes,
               moves=sum(p["moves"] for p in passes),
               backlog=passes[-1]["backlog"],
               rebalance_ms=[p["ms"] for p in passes],
               wire_bytes_before=wire_before, wire_bytes_after=wire_after)
    log(f"  4c migration: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 4b: the failover scenario on the KVStore path's store
# ---------------------------------------------------------------------------

def phase_failover(torch, pt, rdma, slots):
    """Steps 1-7 of benchmarks/bench_failover.py at the KVStore path's size,
    on the remote-DMA backend: a leader store, two follower stores and a
    ReplicatedLog(window=B, capacity=4), a FailureDetector(threshold=2).
    Prefill 80% of K and run MIX_WINDOWS mixed windows, each appended and
    synced.  Participant 0, the leader, dies before mixed window FO_KILL:
    the window before it is acked but unsynced; heartbeat windows run until
    the detector's verdict; a follower is promoted; the followers catch up;
    the in-flight window is retried through the new leader; a zombie publish
    at the stale epoch is fenced.  Participant 0 comes back before window
    FO_REVIVE with a cursor gap of the ring's capacity and rejoins by
    ring-tail replay.  A participant's slice of a window is NOP while it is
    dead or behind the log, and in the window before its death: a slice
    replayed late would commit in another order than on the leader.  Every
    GET and ``found`` of the leader is checked against the oracle; the
    followers must equal the leader bitwise at the end.  Returns the
    metrics and the launches of the path's kernels."""
    from repro_torch.core import (FailureDetector, ReplicatedLog,
                                  diverging_leaves)
    mgr = pt.make_manager(P, backend="pallas")
    mgr.traffic.enable()
    kw = dict(slots_per_node=slots, value_width=W, num_locks=4096,
              index_capacity=4 * KEYS)
    lead = pt.KVStore(None, "fo_lead", mgr, **kw)
    fols = [pt.KVStore(None, f"fo_foll{i}", mgr, **kw) for i in range(2)]
    rlog = ReplicatedLog(None, "fo_log", mgr, store=lead, window=B,
                         capacity=LOG_CAPACITY)
    det = FailureDetector(None, "fo_det", mgr, threshold=DETECT_THRESHOLD)
    st = dict(lead=lead.init_state(),
              fols=tuple(f.init_state() for f in fols),
              log=rlog.init_state(), det=det.init_state())
    torch.cuda.synchronize()
    log(f"  three stores of P={P} K={KEYS} and a log of {rlog.entry_width}-"
        f"word entries; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    alive = np.ones(P, bool)
    oracle = Oracle(KEYS, slots)
    rng = np.random.default_rng(SEED + 7)
    kernels = rdma.KERNELS + (rdma.remote_copy,)
    for k in kernels:
        k.launches = 0
    rlog.ring.publishes = 0
    torch.cuda.reset_peak_memory_stats()

    def mask():
        return torch.from_numpy(alive.copy()).cuda()

    def apply(ops, ks, vals, what):
        st["lead"], res = lead.op_window(st["lead"], ops, ks, vals)
        verify(res, oracle.window(ops, ks, vals), what)

    def heartbeat():
        st["log"], st["det"], verdict = rlog.heartbeat_and_detect(
            st["log"], st["det"], det, pred=mask())
        return verdict[0].cpu().numpy()

    def append(ops, ks, vals):
        a = mask()
        st["log"], ok = rlog.append(st["log"], ops, ks, vals,
                                    pred=a[st["log"].ring.owner.long()])
        return bool(ok[0])

    def sync():
        st["log"], st["fols"], n = rlog.sync(st["log"], fols, st["fols"],
                                             max_entries=1, pred=mask())
        return int(n.cpu().numpy()[alive].min())   # at every live lane

    def lag():
        return int(rlog.lag(st["log"])[0])

    def converged(lanes=None):
        sel = None if lanes is None else torch.from_numpy(lanes).cuda()
        return all(diverging_leaves(st["lead"], f, lanes=sel) == []
                   for f in st["fols"])

    def window(w, quiet=()):
        ops, ks, vals = mixed_window(rng, w)
        for p in quiet:
            ops[p] = NOP
        return ops, ks, vals

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 1. prefill through the log, each window appended and synced
    span = P * B
    n_fill = int(KEYS * FILL)
    fill_keys = np.arange(1, n_fill + 1, dtype=np.uint32)
    t_fill = time.perf_counter()
    n_fill_windows = 0
    for i in range(0, n_fill, span):
        chunk = fill_keys[i:i + span]
        ops = np.full(span, NOP, np.int32)
        ks = np.ones(span, np.uint32)
        vals = np.zeros((span, W), np.int32)
        ops[:chunk.size] = INSERT
        ks[:chunk.size] = chunk
        vals[:chunk.size, 0] = chunk.astype(np.int32) * 3
        ops, ks, vals = ops.reshape(P, B), ks.reshape(P, B), \
            vals.reshape(P, B, W)
        apply(ops, ks, vals, f"replicated prefill window {i // span}")
        check(append(ops, ks, vals), "a prefill window was not acked")
        check(sync() == 1, "a prefill window was not replayed")
        n_fill_windows += 1
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t_fill
    acked = n_fill_windows
    log(f"  replicated prefill: {n_fill} inserts in {n_fill_windows} windows "
        f"in {t_fill:.1f} s, each appended and synced, oracle-checked")

    # -- steady state: apply, heartbeat, append, sync
    def steady(w, quiet=()):
        ops, ks, vals = window(w, quiet)

        def step():
            apply(ops, ks, vals, f"mixed window {w}")
            heartbeat()
            ok = append(ops, ks, vals)
            return ok, sync()
        (ok, n), dt = timed(step)
        check(ok and n == 1 and lag() == 0,
              f"mixed window {w}: ok {ok}, replayed {n}, lag {lag()}")
        return dt

    steady_t = [steady(w) for w in range(FO_KILL - 1)]
    acked += FO_KILL - 1

    # -- 2. the last window before the crash: acked, not synced
    ops, ks, vals = window(FO_KILL - 1, quiet=(0,))
    apply(ops, ks, vals, f"mixed window {FO_KILL - 1}")
    heartbeat()
    check(append(ops, ks, vals), "the pre-crash window must be acked")
    acked += 1
    check(lag() == 1, "the pre-crash window must stay unsynced")

    # -- 3a. participant 0 dies: heartbeat windows until the verdict
    alive[0] = False
    detect = 0
    verdict = np.ones(P, bool)
    while verdict[0]:
        verdict = heartbeat()
        detect += 1
        check(detect <= 2 * DETECT_THRESHOLD, "no verdict on participant 0")
    check(detect == DETECT_THRESHOLD and not verdict[0] and verdict[1:].all(),
          f"verdict {verdict.tolist()} after {detect} windows")

    # -- 3. promotion, driven by the verdict
    (st["log"], winner), promote_s = timed(lambda: rlog.promote(
        st["log"], torch.from_numpy(verdict.copy()).cuda()))
    winner = int(winner[0])
    check(winner == 1, f"equal cursors: rank 1 must win, got {winner}")

    # -- 4. bounded catch-up, then zero acked-window loss on the live lanes
    catchup = 0
    while lag():
        sync()
        catchup += 1
        check(catchup <= LOG_CAPACITY, "catch-up must be bounded by the ring")
    check(converged(lanes=alive), "a follower lost acked windows across the "
                                  "failover")

    # -- 5. the in-flight window retries through the new leader
    ops, ks, vals = window(FO_KILL, quiet=(0,))

    def retry():
        apply(ops, ks, vals, f"retried window {FO_KILL}")
        heartbeat()
        a = mask()
        st["log"], st["fols"], ok, _n = rlog.append_with_retry(
            st["log"], ops, ks, vals, fols, st["fols"], max_attempts=2,
            pred=a[st["log"].ring.owner.long()], sync_pred=a)
        return bool(ok[0])
    ok, retry_s = timed(retry)
    check(ok and lag() == 0, "the retried window must publish and drain")
    acked += 1

    # -- 6. a zombie publish from the dead leader is fenced at delivery
    zops = np.full((P, B), NOP, np.int32)
    zops[1, 0] = UPDATE
    zks = np.ones((P, B), np.uint32)
    zks[1, 0] = 1
    zvals = np.full((P, B, W), -777, np.int32)
    st["log"], landed = rlog.zombie_publish(st["log"], zops, zks, zvals,
                                            zombie=0, stale_epoch=0)
    check(bool(landed[0]), "the zombie write must land in the ring")
    check(sync() == 0, "a fenced entry must not apply")
    fenced = int(st["log"].fenced[0])
    check(fenced >= 1, "the zombie entry must be counted as fenced")

    # -- 7. more windows through the new leader, participant 0 still dead
    steady_t += [steady(w, quiet=(0,)) for w in range(FO_KILL + 1, FO_REVIVE)]
    acked += FO_REVIVE - FO_KILL - 1

    # -- participant 0 comes back: replay rejoin from the ring's tail
    alive[0] = True
    node = torch.zeros((P,), dtype=torch.int64).cuda()
    check(not bool(rlog.needs_snapshot(st["log"], node)[0]),
          "the gap must fit the ring: replay rejoin")
    gap = int((st["log"].ring.head[1] - st["log"].ring.acks.cached[1, 0])
              & 0xFFFFFFFF)

    def rejoin():
        st["log"] = rlog.readmit(st["log"], node)
        st["det"] = det.readmit(st["det"], 0)
        n = 0
        while lag():
            sync()
            n += 1
            check(n <= LOG_CAPACITY, "replay must be bounded by the ring")
        return n
    replayed, rejoin_s = timed(rejoin)
    check(replayed == gap == LOG_CAPACITY,
          f"replayed {replayed} entries for a gap of {gap}")
    check(converged(), "the rejoined participant's replicas differ")

    steady_t += [steady(w) for w in range(FO_REVIVE, MIX_WINDOWS)]
    acked += MIX_WINDOWS - FO_REVIVE
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    publishes = rlog.ring.publishes

    # -- the invariants
    lg = st["log"]
    epoch = int(rlog.epoch(lg)[0])
    check(lag() == 0 and converged(),
          "zero acked-window loss: every follower equals the leader")
    check(epoch == 1 and int(lg.failovers[0]) == 1,
          f"epoch {epoch}, failovers {int(lg.failovers[0])}")
    check(int(lg.dropped[0]) == 0, "an append was dropped")
    check(int(lg.published[0]) == acked,
          f"published {int(lg.published[0])} != acked {acked}")
    ledger_fenced = sum(mgr.traffic.fenced_summary().values())
    check(ledger_fenced >= 1, "the ledger's fenced tier must count the "
                              "zombie")
    check(launches["remote_copy"] == publishes > 0,
          f"remote_copy launched {launches['remote_copy']} times for "
          f"{publishes} ring publishes")
    for name in ("build_descriptors", "gather_rows", "scatter_rows"):
        check(launches[name] > 0, f"{name} was not launched on the failover "
                                  f"path")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  failover: epoch 0 -> 1, winner {winner}, detection in {detect} "
        f"windows, promotion {promote_s * 1e3:.2f} ms, catch-up {catchup} "
        f"syncs, retry {retry_s * 1e3:.2f} ms, fenced {fenced} (ledger "
        f"{ledger_fenced}), replay rejoin of {replayed} entries in "
        f"{rejoin_s * 1e3:.2f} ms; {acked} acked windows, every follower "
        f"bitwise equal to the leader; {publishes} ring publishes; launches "
        f"{launches}")
    return dict(
        prefill_ops=n_fill, prefill_windows=n_fill_windows,
        prefill_s=t_fill, prefill_ops_per_s=n_fill / t_fill,
        steady_windows=len(steady_t),
        steady_window_p50_ms=float(np.percentile(steady_t, 50)) * 1e3,
        steady_window_p99_ms=float(np.percentile(steady_t, 99)) * 1e3,
        detection_windows=detect, promotion_ms=promote_s * 1e3,
        catchup_syncs=catchup, retry_ms=retry_s * 1e3, fenced=fenced,
        ledger_fenced=ledger_fenced, replay_rejoin_entries=replayed,
        replay_rejoin_ms=rejoin_s * 1e3, acked_windows=acked,
        ring_publishes=publishes, epoch=epoch, peak_device_gib=peak), \
        launches


# ---------------------------------------------------------------------------
# phase 4d: the paper's channel objects' scalar verbs
# ---------------------------------------------------------------------------

# benchmarks/bench_lock.py: P = 8, 341 locks over 8 · 341 accounts, 12
# rounds; MPI-style windows couple 8 accounts to one lock
LOCK_P, N_LOCKS, LOCK_ROUNDS = 8, 341, 12
N_ACCOUNTS = LOCK_P * N_LOCKS
MPI_WINDOW = N_ACCOUNTS // N_LOCKS
# benchmarks/bench_barrier.py: crossings at P = 2, 4, 8, 20 each
BARRIER_PS, BARRIER_CROSSINGS = (2, 4, 8), 20


def reset_launches(rdma):
    for k in rdma.KERNELS:
        k.launches = 0


def equal_on_both(label, traces):
    """``traces`` {device: [numpy tree, ...]}: every step bitwise equal on
    the card and on the CPU."""
    card, cpu = traces["cuda"], traces["cpu"]
    check(len(card) == len(cpu), f"{label}: step counts differ")
    for i, (a, b) in enumerate(zip(card, cpu)):
        check(trees_equal(a, b), f"{label} step {i}: differs cuda vs cpu")


def lock_single(torch, pt, dev):
    """bench_lock.py's single contended TicketLock: every participant
    without a ticket takes one, the holder releases (global fence)."""
    mgr = pt.make_manager(LOCK_P, device=dev, backend="pallas")
    lk = pt.TicketLock(None, "single", mgr)
    st = lk.init_state()
    t = torch.full((LOCK_P,), pt.NO_TICKET, dtype=torch.int64,
                   device=mgr.device)
    trace, times = [], []
    for _ in range(LOCK_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, t2 = lk.acquire(st, want=t == pt.NO_TICKET)
        t = torch.where(t == pt.NO_TICKET, t2, t)
        holds = lk.holds(st, t)
        st = lk.release(st, holds)
        t = torch.where(holds, pt.NO_TICKET, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        trace.append(np_tree((st, t, holds)))
    return trace, times


def transfers(torch, pt, rdma, dev, window):
    """bench_lock.py's transfer transactions (``_txn_round``): participant
    p moves 1 from account a to account b under the ticket locks of both,
    with two scalar reads and two scalar writes a round on a SharedRegion
    of the accounts.  ``window`` 1 is LOCO's coupling (the lock is the
    account's), 8 MPI-style (the lock is the account // 8's).  A pair whose
    two locks coincide is drawn again: bench_lock.py's round would wait for
    its own second ticket forever.  Every round: the balances against a
    numpy model of the completed transfers (so their sum never changes and
    each completed transfer moved exactly 1), and on the card the launches
    of the two reads and two writes."""
    P, slots = LOCK_P, N_ACCOUNTS // LOCK_P
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    locks = pt.TicketLockArray(None, "locks", mgr, num_locks=N_LOCKS)
    region = pt.SharedRegion(None, "accts", mgr, slots=slots, item_shape=(),
                             dtype=torch.int32)
    rng = np.random.default_rng(SEED + 11 + window)
    model = rng.integers(0, 1000, (P, slots)).astype(np.int32)
    total = int(model.sum())
    st_l = locks.init_state()
    st_r = region.init_state()._replace(
        buf=torch.from_numpy(model.copy()).to(mgr.device))
    nt = pt.NO_TICKET
    ta = torch.full((P,), nt, dtype=torch.int64, device=mgr.device)
    tb = ta.clone()

    def draw(n):
        a = rng.integers(0, N_ACCOUNTS, n)
        b = (a + 1 + rng.integers(0, N_ACCOUNTS - 1, n)) % N_ACCOUNTS
        same = (a // window) % N_LOCKS == (b // window) % N_LOCKS
        while same.any():
            b[same] = (a[same] + 1 + rng.integers(
                0, N_ACCOUNTS - 1, int(same.sum()))) % N_ACCOUNTS
            same = (a // window) % N_LOCKS == (b // window) % N_LOCKS
        return a, b

    aa, ab = draw(P)
    one_round = {"build_descriptors": 4, "gather_rows": 2, "scatter_rows": 2}
    trace, times, done_total = [], [], 0
    for rnd in range(LOCK_ROUNDS):
        acct_a, acct_b = aa // window, ab // window      # bench_lock.py's
        A = torch.from_numpy(acct_a).to(mgr.device)
        Bc = torch.from_numpy(acct_b).to(mgr.device)
        la, lb = A % N_LOCKS, Bc % N_LOCKS
        before = kernel_counts(rdma)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        need = ta == nt
        st_l, t1 = locks.acquire(st_l, la, need)
        st_l, t2 = locks.acquire(st_l, lb, need)
        ta, tb = torch.where(need, t1, ta), torch.where(need, t2, tb)
        holds = locks.holds(st_l, la, ta) & locks.holds(st_l, lb, tb)
        bal_a, _ = region.read(st_r, A % P, A // P)
        bal_b, _ = region.read(st_r, Bc % P, Bc // P)
        st_r, _ = region.write(st_r, A % P, A // P, bal_a - 1, pred=holds)
        st_r, _ = region.write(st_r, Bc % P, Bc // P, bal_b + 1, pred=holds)
        st_l = locks.release(st_l, la, holds)
        st_l = locks.release(st_l, lb, holds & (la != lb))
        ta = torch.where(holds, nt, ta)
        tb = torch.where(holds, nt, tb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if dev == "cuda":
            got = {k: n - before[k] for k, n in kernel_counts(rdma).items()}
            check(got == one_round, f"transfer round {rnd} (window "
                  f"{window}): launches {got}, not one read verb and one "
                  f"write verb twice {one_round}")
        done = holds.cpu().numpy()
        for p in np.flatnonzero(done):
            model[acct_a[p] % P, acct_a[p] // P] -= 1
            model[acct_b[p] % P, acct_b[p] // P] += 1
        buf = st_r.buf.cpu().numpy()
        check(np.array_equal(buf, model) and int(buf.sum()) == total,
              f"transfer round {rnd} (window {window}): balances off the "
              f"completed transfers (sum {int(buf.sum())}, was {total})")
        done_total += int(done.sum())
        trace.append(np_tree((st_l, st_r, ta, tb, holds)))
        if done.any():
            fa, fb = draw(P)
            aa, ab = np.where(done, fa, aa), np.where(done, fb, ab)
    check(done_total > 0, f"no transfer completed (window {window})")
    return trace, times, done_total


def barrier_crossings(torch, pt, dev, P):
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    bar = pt.Barrier(None, f"bar{P}", mgr)
    st = bar.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BARRIER_CROSSINGS):
        st = bar.wait(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [np_tree(st)], dt / BARRIER_CROSSINGS


def registers(torch, pt, dev):
    """OwnedVar push and pull and AtomicVar fetch_add and compare_swap at
    P = 8 from seeded words: a 4-word owned var (checksummed) and a uint32
    atomic near its wrap."""
    P = LOCK_P
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    ov = pt.OwnedVar(None, "ov", mgr, owner=3, shape=(4,), dtype=torch.int32)
    av = pt.AtomicVar(None, "av", mgr, host=5, dtype=torch.uint32)
    rng = np.random.default_rng(SEED + 12)
    me = mgr.runtime.my_id()
    ost, ast = ov.init_state(), av.init_state(2 ** 32 - 20)
    trace = []
    for _ in range(4):
        v = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (P, 4)).astype(
            np.int32)).to(mgr.device)
        ost = ov.store_mine(ost, v, pred=me == 3)
        ost, _ = ov.push(ost)
        trace.append(np_tree((ost,) + ov.load(ost)))
        ost = ov.store_mine(ost, v + 1, pred=me == 3)
        ost, _ = ov.pull(ost)
        trace.append(np_tree((ost,) + ov.load(ost)))
        amt = torch.from_numpy(rng.integers(0, 9, P)).to(mgr.device)
        pred = torch.from_numpy(rng.random(P) < .7).to(mgr.device)
        ast, old, _ = av.fetch_add(ast, amt, pred=pred)
        exp = torch.where(pred, ast.official, old)
        ast, old2, ok, _ = av.compare_swap(ast, exp, old + 7, pred=~pred)
        check(int(ok.sum()) <= 1, "compare_swap: more than one winner")
        trace.append(np_tree((ast, old, old2, ok)))
    return trace


def queue_paths(torch, pt, dev, scalar):
    """SharedQueue at P = 8 through 16 rounds of pushes and pops: its scalar
    reference paths (``scalar``) or its B=1 windows."""
    P = LOCK_P
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    q = pt.SharedQueue(None, "q", mgr, slots_per_node=2, width=2)
    enq = q._enqueue_reference if scalar else q.enqueue
    deq = q._dequeue_reference if scalar else q.dequeue
    rng = np.random.default_rng(SEED + 13)
    st, trace = q.init_state(), []
    for rnd in range(16):
        ew = torch.from_numpy(rng.random(P) < (.9 if rnd < 4 else .5))
        dw = torch.from_numpy(rng.random(P) < (.1 if rnd < 4 else .7))
        ev = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (P, 2)).astype(
            np.int32))
        st, g = enq(st, ev.to(mgr.device), ew.to(mgr.device))
        st, v, ok = deq(st, dw.to(mgr.device))
        trace.append(np_tree((st, g, v, ok)))
    return trace


def phase_channels(torch, pt, rdma):
    """The channel objects' scalar verbs on the remote-DMA backend, each
    run once on the card and once on the CPU with bitwise-equal states and
    results: bench_lock.py's single contended TicketLock and its transfer
    transactions in both couplings (exact launches a round, balances
    conserved), bench_barrier.py's crossings, OwnedVar and AtomicVar, the
    queue's scalar paths against its B=1 windows, and the KV-store example
    on the remote-DMA backend with its online oracle.  Returns the metrics and the remote-DMA
    kernels' launches, counted from 0 over this phase."""
    import contextlib
    import io
    from repro_torch.examples import kvstore_app
    reset_launches(rdma)
    out = {}
    traces = {}
    for dev in ("cuda", "cpu"):
        traces[dev], t = lock_single(torch, pt, dev)
        if dev == "cuda":
            out["lock_single_round_ms_p50"] = float(np.median(t)) * 1e3
    equal_on_both("single TicketLock", traces)
    served = sum(int(tr[2].sum()) for tr in traces["cuda"])
    check(all(int(tr[2].sum()) == 1 for tr in traces["cuda"]),
          "single TicketLock: a round without exactly one holder")
    log(f"  single TicketLock, P={LOCK_P}, {LOCK_ROUNDS} rounds: one holder "
        f"a round ({served} served), bitwise equal on cuda and cpu; round "
        f"p50 {out['lock_single_round_ms_p50']:.3f} ms")

    for name, window in (("loco", 1), ("mpi", MPI_WINDOW)):
        traces = {}
        for dev in ("cuda", "cpu"):
            traces[dev], t, done = transfers(torch, pt, rdma, dev, window)
            if dev == "cuda":
                out[f"txn_{name}"] = dict(
                    done=done, txn_per_round=done / LOCK_ROUNDS,
                    round_ms_p50=float(np.median(t)) * 1e3)
        equal_on_both(f"{name} transfers", traces)
        r = out[f"txn_{name}"]
        log(f"  {name} transfers (lock = account // {window}): {r['done']} "
            f"done in {LOCK_ROUNDS} rounds, balances conserved, each moved "
            f"1, launches a round 4/2/2, bitwise equal on cuda and cpu; "
            f"round p50 {r['round_ms_p50']:.3f} ms")

    for P in BARRIER_PS:
        traces = {}
        for dev in ("cuda", "cpu"):
            traces[dev], per = barrier_crossings(torch, pt, dev, P)
            if dev == "cuda":
                out[f"barrier_p{P}_ms"] = per * 1e3
        equal_on_both(f"barrier P={P}", traces)
        count = traces["cuda"][0].count
        check(np.array_equal(count, np.full(P, BARRIER_CROSSINGS)),
              f"barrier P={P}: count {count}")
    log(f"  barrier crossings ({BARRIER_CROSSINGS} each) bitwise equal on "
        f"cuda and cpu, count = crossings; ms a crossing: " + ", ".join(
            f"P={P} {out[f'barrier_p{P}_ms']:.3f}" for P in BARRIER_PS))

    equal_on_both("OwnedVar and AtomicVar",
                  {dev: registers(torch, pt, dev) for dev in ("cuda", "cpu")})
    traces = {dev: queue_paths(torch, pt, dev, True) for dev in ("cuda", "cpu")}
    equal_on_both("queue scalar paths", traces)
    equal_on_both("queue scalar paths vs B=1 windows",
                  {"cuda": traces["cuda"],
                   "cpu": queue_paths(torch, pt, "cuda", False)})
    log(f"  OwnedVar push/pull and AtomicVar fetch_add/compare_swap at "
        f"P={LOCK_P}, and the queue's scalar paths (= its B=1 windows), "
        f"bitwise equal on cuda and cpu")

    buf = io.StringIO()
    before = kernel_counts(rdma)
    with contextlib.redirect_stdout(buf):
        kvstore_app.main(device="cuda", backend="pallas")
    text = buf.getvalue()
    got = {k: n - before[k] for k, n in kernel_counts(rdma).items()}
    check("linearizability holds." in text, f"kvstore_app: {text}")
    check(all(n > 0 for n in got.values()),
          f"kvstore_app on pallas left a map kernel unlaunched: {got}")
    log("  repro_torch.examples.kvstore_app on the card (pallas): "
        + " / ".join(text.strip().splitlines()) + f"; launches {got}")
    torch.cuda.synchronize()
    return out, kernel_counts(rdma)


# ---------------------------------------------------------------------------
# phase 4e: the map's executable specification store
# ---------------------------------------------------------------------------

# benchmarks/bench_kvstore.py's reference variant: P = 8, keyspace 1024,
# index_capacity 4 · keyspace, keyspace // P + 4 slots, max(64, P · window)
# locks, windows of 32.  The flat scan is O(C) a lane, which is why the
# reference's benchmark holds the spec store at this size.
SPEC_KEYS, SPEC_B = 1024, 32
SPEC_CFG = dict(slots_per_node=SPEC_KEYS // P + 4, value_width=W,
                num_locks=max(64, P * SPEC_B), index_capacity=4 * SPEC_KEYS)
SPEC_MIX, SPEC_ZIPF = 10, 10


def spec_windows(rng):
    """(kind, ops, keys, values) windows: the 80% prefill in windows of
    P · 32 inserts, then 10 mixed (60/20/10/10 GET/UPDATE/INSERT/DELETE,
    distinct uniform keys) and 10 zipf(0.99) 95/5 GET/UPDATE."""
    span = P * SPEC_B
    out = []
    fill = np.arange(1, int(SPEC_KEYS * FILL) + 1, dtype=np.uint32)
    for i in range(0, fill.size, span):
        chunk = fill[i:i + span]
        ops = np.full(span, NOP, np.int32)
        ks = np.ones(span, np.uint32)
        ops[:chunk.size], ks[:chunk.size] = INSERT, chunk
        vals = np.stack([ks.astype(np.int32) * 3, np.zeros(span, np.int32)],
                        1)
        out.append(("prefill", ops, ks, vals))
    for w in range(SPEC_MIX):
        ks = rng.choice(SPEC_KEYS, span, replace=False).astype(np.uint32) + 1
        ops = rng.choice([GET, UPDATE, INSERT, DELETE], span,
                         p=[.6, .2, .1, .1]).astype(np.int32)
        out.append(("mixed", ops, ks, np.stack(
            [ks.astype(np.int32) * 5 + w, np.full(span, w, np.int32)], 1)))
    ranks = np.arange(1, SPEC_KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** ZIPF_THETA)
    cdf /= cdf[-1]
    scramble = rng.permutation(SPEC_KEYS) + 1
    for w in range(SPEC_ZIPF):
        ks = scramble[np.minimum(np.searchsorted(cdf, rng.random(span)),
                                 SPEC_KEYS - 1)].astype(np.uint32)
        ops = np.where(rng.random(span) < .95, GET, UPDATE).astype(np.int32)
        out.append(("zipf", ops, ks, np.stack(
            [ks.astype(np.int32) * 7 + w, np.full(span, -w, np.int32)], 1)))
    return [(kind, o.reshape(P, SPEC_B), k.reshape(P, SPEC_B),
             v.reshape(P, SPEC_B, W)) for kind, o, k, v in out]


def phase_spec_store(torch, pt, rdma):
    """bench_kvstore.py's reference variant on the remote-DMA backend: a
    hash store and a reference-impl store (flat-scan index, sequential
    tracker sweep, one ticket served per lock a round) in step on the card
    through the prefill, the mixed and the zipf windows — results equal
    lane for lane, logical contents equal by the flat-scan lookup of every
    key — and the reference-impl store again on the CPU, bitwise equal to
    the card's after every window; then ``_op_round_reference`` against
    ``op_round`` and ``_migrate_reference`` against ``migrate_window``.
    Returns the metrics and the remote-DMA kernels' launches, counted from
    0 over this phase."""
    rng = np.random.default_rng(SEED + 14)
    windows = spec_windows(rng)
    stores = {}
    for label, dev, ref in (("hash", "cuda", False), ("spec", "cuda", True),
                            ("spec cpu", "cpu", True)):
        mgr = pt.make_manager(P, device=dev, backend="pallas")
        kv = pt.KVStore(None, "kv", mgr, reference_impl=ref, **SPEC_CFG)
        stores[label] = [kv, kv.init_state()]
    reset_launches(rdma)
    prefill_s = {"hash": 0.0, "spec": 0.0}
    for i, (kind, ops, ks, vals) in enumerate(windows):
        res = {}
        for label, s in stores.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s[1], r = s[0].op_window(s[1], ops, ks, vals)
            torch.cuda.synchronize()
            if kind == "prefill" and label in prefill_s:
                prefill_s[label] += time.perf_counter() - t0
            res[label] = np_tree(r)
        check(trees_equal(res["hash"], res["spec"]),
              f"spec store {kind} window {i}: results differ from the hash "
              f"store's")
        check(trees_equal(res["spec"], res["spec cpu"]),
              f"spec store {kind} window {i}: results differ cuda vs cpu")
        check(trees_equal(pt.state_to_numpy(stores["spec"][1]),
                          pt.state_to_numpy(stores["spec cpu"][1])),
              f"spec store {kind} window {i}: state differs cuda vs cpu")
        if kind == "prefill":
            check(bool(res["hash"].found[ops == INSERT].all()),
                  "a prefill insert failed")
    # the logical contents: every key on the same home in both indexes,
    # with the same value (slot choices differ by design)
    every = torch.arange(1, SPEC_KEYS + 1, device=stores["spec"][0].device) \
        .expand(P, SPEC_KEYS)
    looks = {label: [x.cpu().numpy() for x in stores[label][0]
                     ._index_lookup_reference(stores[label][1], every)]
             for label in ("hash", "spec")}
    fh, fs = looks["hash"][0], looks["spec"][0]
    check(np.array_equal(fh, fs) and np.array_equal(
        looks["hash"][2][fh], looks["spec"][2][fs]),
        "the flat-scan lookup of every key differs hash vs spec store")
    gets = {label: np_tree(stores[label][0].get_batch(stores[label][1],
                                                      every)[1:])
            for label in ("hash", "spec")}
    check(trees_equal(gets["hash"], gets["spec"]),
          "get_batch of every key differs hash vs spec store")
    live = int(fh[0].sum())
    ratio = prefill_s["spec"] / prefill_s["hash"]
    log(f"  {len(windows)} windows (prefill, {SPEC_MIX} mixed, {SPEC_ZIPF} "
        f"zipf) of {SPEC_B}/participant: results lane for lane the hash "
        f"store's, {live} live keys the same in both indexes, the spec "
        f"store bitwise equal on cuda and cpu after every window")
    log(f"  prefill of {int(SPEC_KEYS * FILL)} keys: hash "
        f"{prefill_s['hash'] * 1e3:.1f} ms, spec "
        f"{prefill_s['spec'] * 1e3:.1f} ms, spec/hash {ratio:.2f} "
        f"({card_line()})")

    # _op_round_reference against op_round from the hash store's state
    kv, st = stores["hash"]
    st_a = st_b = st
    for rnd in range(6):
        op = rng.choice([NOP, GET, INSERT, UPDATE, DELETE], P,
                        p=[.1, .3, .3, .15, .15]).astype(np.int32)
        key = rng.integers(1, SPEC_KEYS + 1, P).astype(np.uint32)
        val = rng.integers(-2 ** 31, 2 ** 31, (P, W)).astype(np.int32)
        st_a, ra = kv.op_round(st_a, op, key, val)
        st_b, rb = kv._op_round_reference(st_b, op, key, val)
        check(not differing_leaves(torch, st_a, st_b)
              and trees_equal(np_tree(ra), np_tree(rb)),
              f"op_round differs from _op_round_reference in round {rnd}: "
              f"{differing_leaves(torch, st_a, st_b)}")

    # _migrate_reference against migrate_window on a placed store
    mgr = pt.make_manager(P, device="cuda", backend="pallas")
    pkv = pt.KVStore(None, "kv_placed", mgr, placement="hashed", **SPEC_CFG)
    keys = np.arange(1, P * SPEC_B + 1, dtype=np.uint32).reshape(P, SPEC_B)
    pst, r = pkv.op_window(pkv.init_state(),
                           np.full((P, SPEC_B), INSERT, np.int32), keys,
                           np.stack([keys * 3, keys * 5], -1).astype(
                               np.int32))
    mk = keys[:, :4]
    dests = rng.integers(0, P, mk.shape).astype(np.int32)
    st_w, moved_w = pkv.migrate_window(pst, mk, dests)
    st_r, moved_r = pkv._migrate_reference(pst, mk, dests)
    got_w = np_tree(pkv.get_batch(st_w, keys)[1:])
    got_r = np_tree(pkv.get_batch(st_r, keys)[1:])
    check(torch.equal(moved_w, moved_r) and trees_equal(got_w, got_r),
          "migrate_window and _migrate_reference disagree")
    log(f"  op_round = _op_round_reference bitwise over 6 rounds; "
        f"migrate_window = _migrate_reference on a placed store "
        f"({int(moved_w.sum())} of {mk.size} moved)")
    torch.cuda.synchronize()
    return dict(prefill_s=prefill_s, prefill_spec_over_hash=ratio,
                windows=len(windows), live_keys=live), kernel_counts(rdma)


# ---------------------------------------------------------------------------
# phase 5: the serving path at full width
# ---------------------------------------------------------------------------

class ServeProbe:
    """Wraps a ServingEngine's prefill, decode step and page lookups: host
    clock around each call (synchronised), finite-logit checks, the
    lookups' ``found`` lanes, and ``torch.profiler`` over one decode round
    (its page lookups and its decode step)."""

    def __init__(self, torch, eng, profile_round):
        self.torch = torch
        self.prefill_s, self.decode_s, self.reads_s = [], [], []
        self.finite, self.found = [], []
        self.rounds = 0
        self.profile_round = profile_round
        self.prof = None
        self.busy = None
        p, d, r = eng._prefill, eng._decode, eng._kv_reads
        eng._prefill = lambda *a: self._timed(p, self.prefill_s, a)
        eng._decode = lambda *a: self._decode(d, a)
        eng._kv_reads = lambda keys: self._reads(r, keys)

    def _timed(self, fn, sink, args):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        self.finite.append(bool(torch.isfinite(out[0]).all()))
        return out

    def _reads(self, fn, keys):
        self.rounds += 1
        if self.rounds == self.profile_round:
            from torch.profiler import ProfilerActivity, profile
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(keys)
        self.reads_s.append(time.perf_counter() - t0)
        self.found += [bool(f) for f, _v in res]
        return res

    def _decode(self, fn, args):
        out = self._timed(fn, self.decode_s, args)
        if self.prof is not None and self.busy is None:
            self.torch.cuda.synchronize()
            wall_us = (time.perf_counter() - self.t0) * 1e6
            self.prof.__exit__(None, None, None)
            cuda = self.torch.autograd.DeviceType.CUDA
            device_us, dev_by, host_by = 0.0, {}, {}
            for e in self.prof.events():
                if e.device_type == cuda:
                    us = e.time_range.elapsed_us()
                    device_us += us
                    dev_by[e.name[:50]] = dev_by.get(e.name[:50], 0.0) + us
            for e in self.prof.key_averages():
                if e.self_cpu_time_total > 0:
                    host_by[e.key[:50]] = (e.count,
                                           e.self_cpu_time_total / 1e3)
            self.busy = dict(
                wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
                device_busy_share=device_us / wall_us,
                top_device_ms={k: v / 1e3 for k, v in sorted(
                    dev_by.items(), key=lambda kv: -kv[1])[:6]},
                top_host_ops_count_ms=dict(sorted(
                    host_by.items(), key=lambda kv: -kv[1][1])[:8]))
        return out


def expected_launches(cfg, requests, gen):
    """Each model kernel's launches on one ``generate`` of ``requests``
    prompts in batches of SERVE_BATCH: one prefill per batch (flash per
    attention layer, a vlm's cross layers among them, rglru per recurrent
    layer, wkv6 per rwkv layer; whisper: flash per encoder layer and twice
    per decoder layer, self and cross), then gen - 1 decode steps (decode
    attention per attention layer; whisper twice per decoder layer), and
    three grouped matmuls (gate, up, wo) per MoE layer in each of both."""
    from repro_torch.models.transformer import layer_kinds
    prefills = -(-requests // SERVE_BATCH)
    steps = prefills * (gen - 1)
    if cfg.family == "ssm":
        return {"wkv6": cfg.n_layers * prefills}
    if cfg.family == "audio":
        return {"flash_attention": (cfg.n_enc_layers + 2 * cfg.n_layers)
                * prefills, "decode_attention": 2 * cfg.n_layers * steps}
    kinds = layer_kinds(cfg)
    n_rec = kinds.count("rec")
    n_moe = sum(kind.endswith("_moe") for kind in kinds)
    n_attn = len(kinds) - n_rec
    out = {"flash_attention": n_attn * prefills,
           "decode_attention": n_attn * steps}
    if n_rec:
        out["rglru_scan"] = n_rec * prefills
    if n_moe:
        out["gmm"] = 3 * n_moe * (prefills + steps)
    return out


def path_label(path):
    return path["arch"] + (" replicated" if path.get("replicas") else "")


def replication_probe(torch, eng):
    """Host clock (synchronised) around the replicated engine's promotions
    and rejoins."""
    times = {"promote": [], "rejoin": []}

    def wrap(obj, name, sink):
        fn = getattr(obj, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out
        setattr(obj, name, timed)

    wrap(eng.page_log, "promote", times["promote"])
    wrap(eng, "_handle_revive", times["rejoin"])
    return times


def phase_serving(torch, kernels, path, rdma):
    """One serving path: ``path["arch"]`` at full published width and depth
    (or ``path["n_layers"]`` layers, where given), bf16, random weights
    drawn on the card, ``path["requests"]`` (default SERVE_REQUESTS) prompts
    of ``path["prompt"]`` tokens, ``path["gen"]`` (SERVE_GEN) tokens each.
    With ``path["replicas"]`` the page table is replicated behind the log on
    ``path["backend"]``, and ``path["plan"]`` kills and revives the log
    leader.  Returns its metrics and every model kernel's launches (and, on
    a replicated path, the remote-DMA and remote-copy kernels'), counted
    from 0 over this path."""
    from repro_torch.configs import get_config
    from repro_torch.core.kvstore import DELETE, GET, INSERT
    from repro_torch.distributed import FaultPlan
    from repro_torch.serving import ServingEngine
    arch, prompt = path["arch"], path["prompt"]
    requests = path.get("requests", SERVE_REQUESTS)
    gen = path.get("gen", SERVE_GEN)
    replicas = path.get("replicas", 0)
    label = path_label(path)
    cfg = get_config(arch)
    if "n_layers" in path:
        cfg = cfg.replace(n_layers=path["n_layers"])
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, max_batch=SERVE_BATCH, max_seq=prompt + gen,
                        replicas=replicas,
                        fault_plan=(FaultPlan(**path["plan"])
                                    if "plan" in path else None),
                        detect_threshold=DETECT_THRESHOLD,
                        backend=path.get("backend"))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    m = cfg.mla
    heads = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}"
             if m is None else
             f"MLA {cfg.n_heads} heads (q, k {m.qk_nope_head_dim} + "
             f"{m.qk_rope_head_dim}, v {m.v_head_dim}, latent "
             f"{m.kv_lora_rank} + {m.qk_rope_head_dim})")
    if cfg.cross is not None:
        heads += (f", {cfg.n_enc_layers} encoder layers over"
                  if cfg.n_enc_layers else ", cross layers over") + \
            f" a zero context of {cfg.cross.n_context_tokens} positions"
    log(f"  {arch}: {cfg.n_layers} layers, d={cfg.d_model}, {heads}, "
        f"{cfg.dtype}, {n_params:,} parameters "
        f"({n_params * cfg.dtype_.itemsize / 2 ** 30:.1f} GiB) drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab, size=(prompt,)).astype(np.int32)
               for _ in range(requests)]
    probe = ServeProbe(torch, eng, profile_round=10)
    rep_times = replication_probe(torch, eng) if replicas else None
    torch.cuda.reset_peak_memory_stats()
    dma = rdma.KERNELS + (rdma.remote_copy,) if replicas else ()
    for k in list(kernels.values()) + list(dma):
        k.launches = 0
    routes = {name: dict(getattr(kernels[name], "routes", {}))
              for name in ("rglru_scan", "wkv6")}
    t0 = time.perf_counter()
    outs = eng.generate(prompts, gen_len=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    for name, want in (("rglru_scan", "vector"), ("wkv6", "chunked")):
        if routes[name]:
            n = kernels[name].routes[want] - routes[name][want]
            check(n == launches[name], f"{label}: {n} of {launches[name]} "
                  f"{name} launches took the {want} route")
    dma_launches = {k.__name__: k.launches for k in dma}
    expected = expected_launches(cfg, requests, gen)
    stats = eng.stats()
    for name, n in launches.items():
        check(n == expected.get(name, 0) and (n > 0) == (name in expected),
              f"{label}: {name} launched {n} times, expected "
              f"{expected.get(name, 0)}")
    check(len(outs) == requests and all(len(o) == gen for o in outs),
          "wrong output shape")
    check(all(0 <= t < cfg.vocab for o in outs for t in o),
          "a token lies outside the vocabulary")
    check(all(probe.finite), "a logit is not finite")
    check(stats["kv_ops"][INSERT] == stats["kv_ops"][DELETE],
          f"kv_ops INSERT != DELETE: {stats['kv_ops']}")
    check(stats["kv_ops"][GET] == requests * gen
          and len(probe.found) == requests * gen
          and all(probe.found), "a decode page lookup was not found")
    check(stats["locality"]["local_fraction"] == 1.0,
          f"local fraction {stats['locality']['local_fraction']}")
    check(probe.busy is not None, "the decode round was not profiled")
    n_prefill_tok = requests * prompt
    n_decode_tok = len(probe.decode_s) * SERVE_BATCH
    log(f"  {requests} requests x {gen} tokens in {wall:.2f} s; "
        f"kv_ops {stats['kv_ops']}, locality "
        f"{stats['locality']['local_fraction']}, all {len(probe.found)} "
        f"decode page lookups found, every logit finite; "
        f"launches {launches | dma_launches}")
    rep_metrics = {}
    if replicas:
        rep = stats["replication"]
        publishes = eng.page_log.ring.publishes
        check(rep["detected_failovers"] == 1 and rep["rejoins_snapshot"] >= 1
              and rep["dropped"] == 0 and rep["lag"] == 0
              and rep["diverged_leaves"] == [0, 0]
              and eng.replica_divergence() == [0, 0],
              f"{label}: replication {rep}")
        check(dma_launches["remote_copy"] == publishes > 0,
              f"{label}: remote_copy launched "
              f"{dma_launches['remote_copy']} times for {publishes} ring "
              f"publishes")
        for name, n in dma_launches.items():
            check(n > 0, f"{label}: {name} was not launched")
        kill = path["plan"]["kills"][0]
        rep_metrics = dict(
            replication=rep, ring_publishes=publishes,
            dma_launches=dma_launches,
            detection_windows=rep["detector"]["detections"][0] - kill,
            promotion_ms=[1e3 * t for t in rep_times["promote"]],
            snapshot_rejoin_ms=[1e3 * t for t in rep_times["rejoin"]],
            rejoin_chunks=rep["rejoin_chunks"])
        log(f"  replication: detection in "
            f"{rep_metrics['detection_windows']} windows, promotion "
            f"{rep_metrics['promotion_ms']} ms, snapshot rejoin "
            f"{rep_metrics['snapshot_rejoin_ms']} ms in "
            f"{rep['rejoin_chunks']} chunks, {publishes} ring publishes, "
            f"diverged leaves {rep['diverged_leaves']}")
    metrics = dict(
        arch=arch, n_layers=cfg.n_layers, dtype=cfg.dtype, params=n_params,
        requests=requests, prompt_len=prompt, gen_len=gen,
        max_batch=SERVE_BATCH, replicas=replicas,
        backend=stats["backend"], generate_s=wall,
        tokens_per_s=requests * gen / wall,
        prefill_calls=len(probe.prefill_s),
        prefill_tokens_per_s=n_prefill_tok / sum(probe.prefill_s),
        prefill_ms_per_call=1e3 * float(np.mean(probe.prefill_s)),
        prefill_ms_p50=1e3 * float(np.percentile(probe.prefill_s, 50)),
        prefill_ms_p99=1e3 * float(np.percentile(probe.prefill_s, 99)),
        decode_steps=len(probe.decode_s),
        decode_tokens_per_s=n_decode_tok / sum(probe.decode_s),
        decode_step_p50_ms=1e3 * float(np.percentile(probe.decode_s, 50)),
        decode_step_p99_ms=1e3 * float(np.percentile(probe.decode_s, 99)),
        page_lookup_p50_ms=1e3 * float(np.percentile(probe.reads_s, 50)),
        peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        decode_round_profile=probe.busy,
        read_cache=stats["read_cache"], locality=stats["locality"],
        **rep_metrics)
    return metrics, {name: launches[name] for name in expected} \
        | dma_launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# phase 7: the training path at full width and depth
# ---------------------------------------------------------------------------

class RepeatedBatch:
    """A pipeline that hands the trainer ``pipe``'s step-0 batch at every
    step, so the loss must fall as the model learns it."""

    def __init__(self, pipe):
        self.batch, self.seq = pipe.batch, pipe.seq
        self._tokens = pipe.get_batch(0)

    def get_batch(self, step):
        return self._tokens


def profiled_step(torch, train_step, params, state, batch):
    """One training step under ``torch.profiler``: its wall time, the
    device's busy share of it, and the flash kernels' forward and backward
    shares of the device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        params, state, met = train_step(params, state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            device_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    fwd = sum(us for n, us in by_name.items() if "::flash_fwd" in n)
    bwd = sum(us for n, us in by_name.items()
              if any(k in n for k in ("::dsum_kernel", "::dkdv_kernel",
                                      "::dq_kernel", "::dkdv_mma_kernel",
                                      "::dq_mma_kernel")))
    check(device_us > 0, "the profiled training step recorded no device "
                         "time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return params, state, dict(
        wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
        device_busy_share=device_us / wall_us,
        flash_fwd_ms=fwd / 1e3, flash_fwd_share=fwd / device_us,
        flash_bwd_ms=bwd / 1e3, flash_bwd_share=bwd / device_us,
        top_device_ms={k[:60]: v / 1e3 for k, v in top})


def guard_refusals(torch, kernels):
    """Each kernel wrapper without a ported backward refuses, on the card,
    an input that requires grad while grad is enabled (its output would
    carry no gradient), and launches nothing."""
    def rn(*shape, grad=False):
        return torch.randn(shape, device="cuda").requires_grad_(grad)

    be = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    calls = {
        "gmm": lambda: kernels["gmm"](rn(16, 32), rn(2, 32, 32, grad=True),
                                      be, 8),
        "rglru_scan": lambda: kernels["rglru_scan"](rn(1, 8, 32, grad=True),
                                                    -rn(1, 8, 32).abs()),
        "wkv6": lambda: kernels["wkv6"](rn(1, 2, 8, 16, grad=True),
                                        rn(1, 2, 8, 16), rn(1, 2, 8, 16),
                                        rn(1, 2, 8, 16).sigmoid(),
                                        rn(2, 16)),
        "decode_attention": lambda: kernels["decode_attention"](
            rn(2, 4, 64, grad=True), rn(2, 2, 16, 64), rn(2, 2, 16, 64),
            lens)}
    for name, call in calls.items():
        before = kernels[name].launches
        try:
            call()
        except RuntimeError as e:
            check("no backward" in str(e) and name in str(e)
                  and kernels[name].launches == before,
                  f"{name}'s refusal of a grad-requiring input: {e}")
            continue
        raise SmokeFailure(f"{name} took a grad-requiring input on the card")
    log(f"  {', '.join(calls)}: each refuses a grad-requiring CUDA input")


def checkpoint_round_trip(torch):
    """The smoke llama3.2-3b's bf16 parameters and AdamW state on the card
    after one step: saved async and blocking, ``keep_last`` 1, restored
    onto the card bitwise."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten, leaves
    cfg = get_smoke_config(TRAIN_ARCH)
    model, opt, step = make_train_step(cfg, TrainConfig(), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    params, state, _m = step(params, opt.init(params),
                             SyntheticTokens(cfg, 2, 64, SEED).get_batch(0))
    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep_last=1)
        ck.save(1, tree)
        ck.save(2, tree, blocking=True)
        check(ck.steps() == [2], f"checkpoint steps {ck.steps()}")
        got = ck.restore(2, tree)
    n = 0
    for (path, a), b in zip(flatten(tree), leaves(got)):
        bits = (lambda t: t.view(torch.int16)
                if t.dtype == torch.bfloat16 else t)
        check(b.device == a.device and b.dtype == a.dtype
              and torch.equal(bits(a.detach()), bits(b)),
              f"checkpoint leaf {path} did not round-trip")
        n += 1
    log(f"  checkpoint of the smoke {TRAIN_ARCH} state on the card: {n} "
        f"leaves ({cfg.dtype} parameters, float32 moments) restored "
        f"bitwise")


def phase_train(torch, kernels):
    """``repro_torch.launch.train.run`` on llama3.2-3b at full width and
    depth: bf16, TRAIN_BATCH x TRAIN_SEQ tokens a step, ``remat="block"``,
    AdamW, TRAIN_STEPS steps on one repeated SyntheticTokens batch.  Every
    loss finite and the last below the first; per step exactly two flash
    forward launches a layer (the forward and its recompute) and one
    backward call, on the tensor cores; no other model kernel.  Then one more step under
    ``torch.profiler``, the guard of the kernels without a backward, and a
    checkpoint round trip.  Returns the metrics and the launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch import train as launcher
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(remat="block", optimizer="adamw")
    pipe = RepeatedBatch(SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED))
    counted = dict(kernels, flash_attention_bwd=flash_attention_bwd)
    torch.cuda.reset_peak_memory_stats()
    for k in counted.values():
        k.launches = 0
    flash_attention_bwd.routes = {"mma": 0, "simt": 0}
    t0 = time.perf_counter()
    run = launcher.run(cfg, tcfg, pipe, steps=TRAIN_STEPS, device="cuda",
                       log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counted.items()}
    routes = dict(flash_attention_bwd.routes)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
                "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    for name, n in launches.items():
        check(n == expected.get(name, 0), f"training path: {name} launched "
              f"{n} times, expected {expected.get(name, 0)}")
    check(routes == {"mma": cfg.n_layers * TRAIN_STEPS, "simt": 0},
          f"training path: flash_attention_bwd routes {routes}, expected "
          f"every call on the tensor cores")
    losses = run["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    step_s, n_params, gnorms = run["step_s"], run["n_params"], \
        run["grad_norms"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  {TRAIN_ARCH}: {n_params:,} parameters, {TRAIN_STEPS} "
        f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {wall:.1f} s; "
        f"losses {losses}; launches {launches}; backward routes {routes}; "
        f"peak {peak:.2f} GiB")
    params, state, prof = profiled_step(torch, run["train_step"],
                                        run["params"], run["opt_state"],
                                        pipe.get_batch(0))
    log(f"  profiled step: {json.dumps(prof)}")
    del run, params, state
    gc.collect()
    torch.cuda.empty_cache()
    guard_refusals(torch, kernels)
    checkpoint_round_trip(torch)
    metrics = dict(
        arch=TRAIN_ARCH, n_layers=cfg.n_layers, dtype=cfg.dtype,
        params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, remat=tcfg.remat, optimizer=tcfg.optimizer,
        losses=losses, grad_norms=gnorms,
        first_step_ms=1e3 * step_s[0],
        step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
        step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
        tokens_per_s=tokens / float(np.percentile(step_s, 50)),
        peak_device_gib=peak, step_profile=prof, launches=launches,
        flash_bwd_routes=routes)
    return metrics, launches


# ---------------------------------------------------------------------------
# phase 6: per-kernel numbers
# ---------------------------------------------------------------------------

def footprint(t):
    """Bytes of ``t``'s distinct elements: a dimension of stride 0 (a
    broadcast with ``expand``) is read once, not once per index."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def kernel_bytes(name, args, kw):
    """Least bytes the function must move on these inputs: each input read
    once and each output written once, counting only the rows this data
    needs (served rows of a gather, committed rows of a scatter), a mask at
    its own width (a bool is one byte) and a broadcast index once."""
    if name == "build_descriptors":
        tg, ix, en = args
        wire = kw.get("wire", en)
        masks = footprint(en) + (footprint(wire) if wire is not en else 0)
        return footprint(tg) + footprint(ix) + masks + tg.numel() * 32 + P * 4
    if name == "gather_rows":
        buf, idx, mask = args
        row = buf.shape[2] * buf.element_size()
        served = int((mask != 0).sum())
        return footprint(idx) + footprint(mask) + served * row \
            + idx.numel() * row + P * 4
    buf, idx, vals, apply, wire = args
    row = buf.shape[2] * buf.element_size()
    # the function returns a new buffer: read the old one, write the new
    return 2 * buf.numel() * buf.element_size() + footprint(idx) \
        + footprint(apply) + footprint(wire) \
        + int((apply != 0).sum()) * row + P * 4


def phase_report(torch, rdma, cases, errs, launches, other_paths):
    """Rows of the three map kernels, each timed on its first phase-2 case
    (the arguments the verbs pass; ``build_descriptors`` the write verb's,
    with the read verb's in its ``read_verb`` entry): the wrapper's time,
    the device time and the device operations per call (``torch.profiler``),
    the plain version's time and the bound at the memory rate.  No one
    PyTorch call computes any of the three functions, so there is no
    library yardstick.  ``launches`` are the KVStore path's;
    ``other_paths`` ({path: launches}) are the scalar-verb phases', each
    under ``launches_<path>``."""
    rows = []
    replaces = {"build_descriptors": 94, "gather_rows": 149,
                "scatter_rows": 209}

    def measure(name, args, kw):
        kern = getattr(rdma, name)
        ops = device_ops(torch, lambda: kern(*args, **kw), 50)
        nbytes = kernel_bytes(name, args, kw)
        return dict(
            launches=launches[name], max_abs_err=errs[name],
            ms=cuda_ms(lambda: kern(*args, **kw), 200),
            device_ms=device_ms(lambda: kern(*args, **kw), 200),
            # per operation, its count over the calls, rounded: a profiler run
            # may drop some device records (as device_ms allows for)
            device_ops_per_call=sum(max(1, round(n / 50))
                                    for n in ops.values()),
            plain_ms=cuda_ms(lambda: plain_call(torch, rdma, name, args, kw),
                             10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None)

    for name, runs in cases.items():
        label, args, kw = runs[0]
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/kernels/csrc/remote_dma.cu",
                   replaces=f"src/repro/kernels/remote_dma.py:"
                            f"{replaces[name]}")
        row.update(measure(name, args, kw))
        row["args"] = label
        for path, counts in other_paths.items():
            row[f"launches_{path}"] = counts[name]
        if name == "build_descriptors":
            row["read_verb"] = measure(name, *runs[1][1:])
            row["read_verb"]["args"] = runs[1][0]
        rows.append(row)
        for r in (row, row.get("read_verb")):
            if r is not None:
                log(f"  {name} [{r['args']}]: {r['ms']:.4f} ms/call (device "
                    f"{r['device_ms']:.5f}, {r['device_ops_per_call']} "
                    f"device ops a call), bound {r['bound_ms']:.6f} ms "
                    f"(bytes), plain {r['plain_ms']:.4f} ms, launches "
                    f"{r['launches']}")
    return rows


def attention_timings(torch, kernels, B, Hq, Hkv, D, S, window, slots, L):
    """Per-call times of both attention kernels in bf16 at one serving
    path's shapes: prefill's causal attention over B prompts of S tokens
    (over the last ``window`` keys, if any), and a decode step against
    ``slots``-slot caches holding L positions each.  The library yardstick
    is one ``scaled_dot_product_attention`` call (with a window or length
    mask where the kernel masks); the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = rn(B, Hq, S, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
    fa = kernels["flash_attention"]
    visible = np.arange(1, S + 1) if window is None \
        else np.minimum(np.arange(1, S + 1), window)
    pairs = B * Hq * int(visible.sum())        # visible (query, key) pairs
    iters = 50 if S * S * D <= 2 ** 26 else 10
    if window is None:
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    else:
        pos = torch.arange(S, device="cuda")
        wmask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=wmask,
                                                  enable_gqa=True)
    def kernel():
        return fa(q, k, v, causal=True, window=window)
    flash = dict(
        ms=cuda_ms(kernel, iters), device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: ref.mha(q, k, v, causal=True,
                                         window=window), max(iters // 5, 2)),
        library_ms=cuda_ms(library, iters),
        library_device_ms=device_ms(library, iters),
        flops=4 * D * pairs, nbytes=2 * (2 * q.numel() + k.numel()
                                         + v.numel()))

    qd, kc, vc = rn(B, Hq, D), rn(B, Hkv, slots, D), rn(B, Hkv, slots, D)
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    mask = (torch.arange(slots, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    da = kernels["decode_attention"]

    def sdpa_decode():
        return F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)
    decode = dict(
        ms=cuda_ms(lambda: da(qd, kc, vc, lens), 200),
        device_ms=device_ms(lambda: da(qd, kc, vc, lens), 200),
        plain_ms=cuda_ms(lambda: ref.decode_attention(qd, kc, vc, lens), 20),
        library_ms=cuda_ms(sdpa_decode, 200),
        library_device_ms=device_ms(sdpa_decode, 200),
        flops=4 * Hq * D * B * L,
        nbytes=2 * (2 * B * Hkv * L * D + 2 * qd.numel()) + 4 * B)
    return {"flash_attention": flash, "decode_attention": decode}


def mla_attention_timings(torch, kernels):
    """Per-call times of both attention kernels in bf16 at deepseek-v3's
    MLA shapes: the expanded prefill (4 prompts of 512 tokens, 128 heads, q
    and k 192 wide, v zero-padded from 128 to 192, as ``mla_attention``
    passes them) and the absorbed decode step (128 query heads on one kv
    head of the 576-wide latent cache, 544 slots holding 528 positions,
    scale 1/sqrt(192), the cache passed as keys and values as
    ``mla_decode`` passes it).  Bounds count what the function needs, not
    the port's padding: q and k 192 wide, v and the output 128 wide, QK
    192 and PV 128 deep for the prefill; q, the latent cache rows up to
    each length read once, the output 512 wide, QK 576 and PV 512 deep for
    the decode.  The library yardsticks are one
    ``scaled_dot_product_attention`` call each: causal over the unpadded
    128-wide v, and the decode query against the latent cache, its first
    512 columns as values, with ``enable_gqa`` and a length mask; the port
    never calls them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    B, H, S = SERVE_BATCH, DS_HEADS, SERVE_PROMPT
    scale = DS_DQK ** -0.5
    q, k = (rn(B, S, H, DS_DQK).transpose(1, 2) for _ in range(2))
    v = rn(B, S, H, DS_DV)
    vp = F.pad(v, (0, DS_DQK - DS_DV)).transpose(1, 2)
    v = v.transpose(1, 2)
    fa = kernels["flash_attention"]
    pairs = B * H * S * (S + 1) // 2

    def prefill():
        return fa(q, k, vp, causal=True, sm_scale=scale)

    def prefill_library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)
    flash = dict(
        ms=cuda_ms(prefill, 10), device_ms=device_ms(prefill, 10),
        plain_ms=cuda_ms(lambda: ref.mha(q, k, vp, causal=True,
                                         sm_scale=scale), 2),
        library_ms=cuda_ms(prefill_library, 10),
        library_device_ms=device_ms(prefill_library, 10),
        flops=2 * (DS_DQK + DS_DV) * pairs,
        nbytes=2 * B * H * S * (2 * DS_DQK + 2 * DS_DV))

    slots, L = SERVE_PROMPT + SERVE_GEN, SERVE_PROMPT + SERVE_GEN // 2
    qd, kc = rn(B, H, DS_DLAT), rn(B, 1, slots, DS_DLAT)
    vc = kc[..., :DS_DLAT - DS_DROPE]
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    mask = (torch.arange(slots, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    da = kernels["decode_attention"]

    def step():
        return da(qd, kc, kc, lens, sm_scale=scale)

    def step_library():
        return F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True,
            scale=scale)
    decode = dict(
        ms=cuda_ms(step, 200), device_ms=device_ms(step, 200),
        plain_ms=cuda_ms(lambda: ref.decode_attention(qd, kc, kc, lens,
                                                      sm_scale=scale), 20),
        library_ms=cuda_ms(step_library, 200),
        library_device_ms=device_ms(step_library, 200),
        flops=2 * H * (2 * DS_DLAT - DS_DROPE) * B * L,
        nbytes=2 * (B * L * DS_DLAT + qd.numel() + B * H * vc.shape[-1])
        + 4 * B)
    return {"flash_attention": flash, "decode_attention": decode}


def cross_attention_timings(torch, kernels):
    """Per-call times of both attention kernels in bf16 at the
    cross-attention paths' shapes, inputs as the models pass them ((B, H,
    S, D) views of (B, S, H, D) projections; decode caches contiguous):
    flash ``whisper_encoder`` (4 x 20 heads of 64, 1,500 frames,
    bidirectional), flash ``vision_cross`` (4 x 32 query heads on 8, 512
    queries over 1,601 context keys, head_dim 128, non-causal) and decode
    ``whisper_cross`` (4 x 20 heads of 64 against the full 1,500-slot
    context cache).  The library yardstick is one
    ``scaled_dot_product_attention`` call on the same inputs (no mask:
    every key is visible); the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    def bhsd(B, H, S, D):
        return rn(B, S, H, D).transpose(1, 2)

    out = {}
    fa = kernels["flash_attention"]
    wh, wkv, wd, wctx = cross_shape(WHISPER_ARCH)
    vh, vkv, vd, vctx = cross_shape(VISION_ARCH)
    for key, (B, Hq, Hkv, Sq, Sk, D) in [
            ("whisper_encoder", (SERVE_BATCH, wh, wkv, wctx, wctx, wd)),
            ("vision_cross", (SERVE_BATCH, vh, vkv, SERVE_PROMPT, vctx,
                              vd))]:
        q, k, v = bhsd(B, Hq, Sq, D), bhsd(B, Hkv, Sk, D), bhsd(B, Hkv, Sk, D)

        def kernel(q=q, k=k, v=v):
            return fa(q, k, v, causal=False)

        def library(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        out[key] = dict(
            ms=cuda_ms(kernel, 20), device_ms=device_ms(kernel, 20),
            plain_ms=cuda_ms(lambda: ref.mha(q, k, v, causal=False), 3),
            library_ms=cuda_ms(library, 20),
            library_device_ms=device_ms(library, 20),
            flops=4 * D * B * Hq * Sq * Sk,
            nbytes=2 * (2 * q.numel() + k.numel() + v.numel()))
    B, H, S, D = SERVE_BATCH, wh, wctx, wd
    qd, kc, vc = rn(B, H, D), rn(B, H, S, D), rn(B, H, S, D)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    da = kernels["decode_attention"]

    def step():
        return da(qd, kc, vc, lens)

    def step_library():
        return F.scaled_dot_product_attention(qd[:, :, None], kc, vc)
    out["whisper_cross"] = dict(
        ms=cuda_ms(step, 200), device_ms=device_ms(step, 200),
        plain_ms=cuda_ms(lambda: ref.decode_attention(qd, kc, vc, lens), 20),
        library_ms=cuda_ms(step_library, 200),
        library_device_ms=device_ms(step_library, 200),
        flops=4 * H * D * B * S,
        nbytes=2 * (kc.numel() + vc.numel() + 2 * qd.numel()) + 4 * B)
    return out


def timing_row(m, launches, err, peak):
    """The JSON line's numbers for one kernel at one set of shapes; the
    bound is the larger of bytes at the memory rate and operations at
    ``peak`` (or ``m["ops_ms"]``, for operations of more than one type)."""
    t_ops = m.get("ops_ms", m["flops"] / peak * 1e3)
    t_bytes = m["nbytes"] / HBM_BYTES_PER_S * 1e3
    row = dict(launches=launches, max_abs_err=err, ms=m["ms"],
               plain_ms=m["plain_ms"], bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops > t_bytes else "bytes",
               library_ms=m["library_ms"])
    for key in ("device_ms", "library_device_ms"):
        if key in m:
            row[key] = m[key]
    return row


def attention_report(torch, kernels, errs, launches):
    """Rows of both attention kernels at llama3.2-3b's shapes (head_dim 128:
    4 prompts of 512 tokens; a decode step mid-path, every cache holding 528
    positions of 544), each with a ``d256`` entry of the same numbers at
    recurrentgemma-2b's (head_dim 256, 10 query heads on 1 kv head: 4
    prompts of 2304 tokens under a 2048-token window; a decode step against
    the full 2048-slot ring), and an ``mla`` entry at deepseek-v3's MLA
    shapes (:func:`mla_attention_timings`); the flash row also has
    ``whisper_encoder`` and ``vision_cross`` entries and the decode row a
    ``whisper_cross`` one at the cross-attention paths' shapes
    (:func:`cross_attention_timings`).  ``ms`` and ``library_ms`` are
    wrapper times (CUDA events around a loop of calls, host work included);
    ``device_ms`` and ``library_device_ms`` the device time per call from
    ``torch.profiler``.  A row whose ``ms`` is well above its
    ``device_ms`` is host-bound.  ``launches`` maps each serving path to
    its kernels' launches: the row's are llama3.2-3b's, each entry's its
    model's, and ``launches_paths`` lists every path's."""
    d128 = attention_timings(torch, kernels, SERVE_BATCH, 24, 8, 128,
                             SERVE_PROMPT, None, SERVE_PROMPT + SERVE_GEN,
                             SERVE_PROMPT + SERVE_GEN // 2)
    d256 = attention_timings(torch, kernels, SERVE_BATCH, 10, 1, 256,
                             RG_PROMPT, 2048, 2048, 2048)
    mla = mla_attention_timings(torch, kernels)
    cross = cross_attention_timings(torch, kernels)
    entries = {"flash_attention": [("whisper_encoder", WHISPER_ARCH),
                                   ("vision_cross", VISION_ARCH)],
               "decode_attention": [("whisper_cross", WHISPER_ARCH)]}
    rows = []
    for name, line in [("flash_attention", 82), ("decode_attention", 63)]:
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{name}.cu",
                   replaces=f"src/repro/kernels/{name}.py:{line}")
        row.update(timing_row(d128[name], launches[SERVE_ARCH][name],
                              errs[name], BF16_FLOPS))
        row["d256"] = timing_row(d256[name],
                                 launches["recurrentgemma-2b"][name],
                                 errs[name], BF16_FLOPS)
        row["mla"] = timing_row(mla[name], launches[DS_ARCH][name],
                                errs[name], BF16_FLOPS)
        for key, arch in entries[name]:
            row[key] = timing_row(cross[key], launches[arch][name],
                                  errs[name], BF16_FLOPS)
        row["launches_paths"] = {path: n[name] for path, n in
                                 launches.items() if name in n}
        rows.append(row)
        for label, m, r in [("D=128", d128[name], row),
                            ("D=256", d256[name], row["d256"]),
                            ("MLA", mla[name], row["mla"])] + [
                (key, cross[key], row[key]) for key, _a in entries[name]]:
            log(f"  {name} {label}: {m['ms']:.4f} ms/call (device "
                f"{m['device_ms']:.4f}), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{m['flops'] / 1e9:.2f} GFLOP, {m['nbytes'] / 1e6:.2f} MB),"
                f" plain {m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} "
                f"ms (device {m['library_device_ms']:.4f}), launches "
                f"{r['launches']}")
    return rows


def flash_bwd_report(torch, errs, launches):
    """The backward kernel's row at llama3.2-3b's training shape (B
    TRAIN_BATCH, 24 query heads on 8 kv heads, S TRAIN_SEQ, D 128, bf16,
    causal; q, k, v and dout (B, H, S, D) views of (B, S, H, D) memory, out
    and lse from the forward kernel).  Bound: the five products of the
    backward over the visible half, 10 * D FLOP a visible (query, key) pair
    a head at the bf16 tensor-core peak, against each input read once and
    each gradient written once.  The library yardstick is
    ``torch.autograd.grad`` through one ``scaled_dot_product_attention``
    output (causal, GQA); the port never calls it.  ``variant`` is the
    route the calls took (``flash_attention_bwd.routes``).  One call is
    first held against the plain version that rounds P and dS to bf16 and
    the unrounded one (``ATTN_TOL``, relative to the plain gradient's max,
    floor as in phase 2b): ``max_abs_err`` is that error,
    ``cases_max_rel_err`` phase 2b's largest."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    B, Hq, Hkv, S, D = TRAIN_BATCH, 24, 8, TRAIN_SEQ, 128

    def bhsd(H):
        return torch.randn((B, S, H, D), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, dout = bhsd(Hq), bhsd(Hkv), bhsd(Hkv), bhsd(Hq)
    out, lse = fa._forward(q, k, v, True, None, D ** -0.5, 0, True)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)

    def library():
        return torch.autograd.grad(lib_out, (qg, kg, vg), dout,
                                   retain_graph=True)
    pairs = B * Hq * S * (S + 1) // 2
    routes = dict(fa.flash_attention_bwd.routes)
    got = kernel()
    floor = 1e-2 * float(dout.abs().max()) * float(v.abs().max())
    err = 0.0
    for round_p in (torch.bfloat16, None):
        exp = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(),
                                      causal=True, round_p=round_p)
        for name, a, b in zip(("dq", "dk", "dv"), got, exp):
            e = bwd_rel_err(a, b, floor)
            check(e <= ATTN_TOL["bfloat16"], f"flash_attention_bwd at the "
                  f"training shape: {name} differs from its plain version "
                  f"(round_p {round_p}): {e} > {ATTN_TOL['bfloat16']}")
            err = max(err, e)
        del exp
    del got
    m = dict(ms=cuda_ms(kernel, 5), device_ms=device_ms(kernel, 5),
             plain_ms=cuda_ms(lambda: ref.flash_attention_bwd(
                 q, k, v, out, lse, dout, causal=True,
                 round_p=torch.bfloat16), 1),
             library_ms=cuda_ms(library, 5),
             library_device_ms=device_ms(library, 5),
             flops=10 * D * pairs,
             nbytes=2 * (3 * q.numel() + 2 * out.numel() + 2 * k.numel()
                         + 2 * v.numel()) + 4 * lse.numel())
    variant = [r for r, n in fa.flash_attention_bwd.routes.items()
               if n != routes[r]]
    check(variant == ["mma"], f"flash_attention_bwd at the training shape "
          f"ran on {variant}, not the tensor cores")
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               replaces="src/repro/models/flash_xla.py:112",
               variant=variant[0])
    row.update(timing_row(m, launches, err, BF16_FLOPS))
    row["cases_max_rel_err"] = errs["grad"]
    row["launches_paths"] = {f"{TRAIN_ARCH} train": launches}
    row["device_ops_per_call"] = errs["device_ops_per_call"]
    row["lse_max_rel_err"] = errs["lse"]
    log(f"  flash_attention_bwd train shape ({variant[0]}): dq/dk/dv err "
        f"{err:.3g} of the plain max, rounded and unrounded (tolerance "
        f"{ATTN_TOL['bfloat16']}); {m['ms']:.4f} ms/call (device "
        f"{m['device_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {m['flops'] / 1e9:.1f} GFLOP, "
        f"{m['nbytes'] / 1e6:.1f} MB), plain {m['plain_ms']:.4f} ms, sdpa "
        f"backward {m['library_ms']:.4f} ms (device "
        f"{m['library_device_ms']:.4f}), launches {launches}")
    return [row]


def wkv6_ops(B, H, S, D):
    """(tensor-core, CUDA-core) operations of the chunked WKV6 form on these
    shapes, per chunk of 16 steps and head: the read-out (r ⊙ P)ᵀ S0 and
    the update (k ⊙ Q) vᵀ, 2·16·D² each, and A·V, 2·16²·D, on the tensor
    cores; the scores A in float32, 3 operations (r·k, the product with
    the decays, the next decay) per channel for each of the 120 pairs s < t
    and 16 diagonal ones, and the decay products P and Q, 2 per step and
    channel, on the CUDA cores."""
    chunks = B * H * -(-S // 16)
    return (chunks * (4 * 16 * D * D + 2 * 16 * 16 * D),
            chunks * (3 * 136 * D + 2 * 16 * D))


def recurrent_report(torch, kernels, errs, launches):
    """Rows of the RG-LRU and WKV6 kernels at their serving paths' shapes in
    bf16: recurrentgemma-2b's scan over 4 prompts of 2304 tokens and 2560
    channels, rwkv6-7b's WKV over 4 prompts of 512 tokens and 64 heads of
    64 (inputs as (B, H, S, D) views of (B, S, H, D) projections).  The
    RG-LRU's operations are elementwise, on the CUDA cores, so its bound
    takes the float32 peak (eight operations an element: two exponentials,
    a square root, the update).  WKV6's bound is the least of the two forms
    the card could run: its bytes against the chunked form's operations
    (:func:`wkv6_ops`, tensor-core ones at the bf16 peak plus CUDA-core
    ones at the float32 peak); ``bound_sequential_ms`` beside it is the
    sequential form's 5·D² + 5·D operations per step and head (the
    read-out r·S, the update w·S + k·vᵀ, the bonus) at the float32 peak,
    the bound of the CUDA-core kernel.  Both rows also carry the device
    operations a call (``torch.profiler``).  No PyTorch call computes
    either recurrence, so there is no library yardstick."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    B, S, D = SERVE_BATCH, RG_PROMPT, 2560
    x = rn(B, S, D).to(torch.bfloat16)
    la = (-0.106 * torch.rand((B, S, D), generator=g, device="cuda")).to(
        torch.bfloat16)
    rg = kernels["rglru_scan"]
    m_rg = dict(ms=cuda_ms(lambda: rg(x, la), 50),
                device_ms=device_ms(lambda: rg(x, la), 20),
                ops=device_ops(torch, lambda: rg(x, la), 20),
                plain_ms=cuda_ms(lambda: ref.rglru(x, la), 2),
                library_ms=None, flops=8 * x.numel(),
                nbytes=3 * 2 * x.numel() + 4 * B * D)

    B, H, S, D = SERVE_BATCH, 64, SERVE_PROMPT, 64
    r, k, v = (rn(B, S, H, D).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(-4.0 + 0.5 * rn(B, S, H, D))).to(
        torch.bfloat16).transpose(1, 2)
    u = (0.1 * rn(H, D)).to(torch.bfloat16)
    wk = kernels["wkv6"]
    tc, cc = wkv6_ops(B, H, S, D)
    m_wk = dict(ms=cuda_ms(lambda: wk(r, k, v, w, u), 50),
                device_ms=device_ms(lambda: wk(r, k, v, w, u), 20),
                ops=device_ops(torch, lambda: wk(r, k, v, w, u), 20),
                plain_ms=cuda_ms(lambda: ref.wkv6(r, k, v, w, u), 2),
                library_ms=None, flops=tc + cc,
                ops_ms=(tc / BF16_FLOPS + cc / F32_FLOPS) * 1e3,
                nbytes=5 * 2 * r.numel() + 2 * u.numel() + 4 * B * H * D * D)
    seq_ms = B * H * S * (5 * D * D + 5 * D) / F32_FLOPS * 1e3
    rows = []
    for name, m, arch, line in [
            ("rglru_scan", m_rg, "recurrentgemma-2b", 46),
            ("wkv6", m_wk, "rwkv6-7b", 55)]:
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{name}.cu",
                   replaces=f"src/repro/kernels/{name}.py:{line}")
        row.update(timing_row(m, launches[arch][name], errs[name],
                              F32_FLOPS))
        row["device_ops_per_call"] = sum(max(1, round(n / 20))
                                         for n in m["ops"].values())
        extra = ""
        if name == "wkv6":
            row["bound_sequential_ms"] = seq_ms
            extra = (f"; sequential form {seq_ms:.4f} ms (operations); "
                     f"chunked {tc / 1e9:.2f} GFLOP on tensor cores, "
                     f"{cc / 1e9:.3f} on CUDA cores")
        rows.append(row)
        log(f"  {name}: {m['ms']:.4f} ms/call (device "
            f"{m['device_ms']:.4f}, {row['device_ops_per_call']} device "
            f"ops a call: {m['ops']}), bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}; {m['flops'] / 1e9:.2f} GFLOP, "
            f"{m['nbytes'] / 1e6:.2f} MB{extra}), plain "
            f"{m['plain_ms']:.4f} ms, library none, launches "
            f"{row['launches']}")
    return rows


def gmm_report(torch, kernels, err, launches):
    """The grouped matmul's row at llama4-maverick's gate/up product in
    bf16: 128 experts of 5120 x 8192, block i of the slot rows on expert i.
    The row is the prefill shape (24 slots per expert, every row counted:
    each call reads every expert's weights once, 10.7 GB); its ``decode``
    entry is a decode step as the model makes it (8 slots per expert, the
    step's 4 tokens on 4 experts, one row each, the other slot rows zero and
    past their counts), bound by the bytes of the 4 experts' weights, the
    whole output and the live x rows; its ``decode_full`` entry is the
    decode shape with every row counted, as this row's earlier decode
    entry was timed.  Operations are counted at the bf16 tensor-core peak.
    The library yardstick is one ``torch.bmm`` of the (E, C, 5120) slots by
    the (E, 5120, 8192) weights — the same function when block i takes
    expert i and the rows past the counts are zeros; it reads every expert.
    The port never calls it.  The ``deepseek_prefill`` and
    ``deepseek_decode`` entries are the same numbers at deepseek-v3's gate
    product (256 experts of 7168 x 2048; prefill: 80 slots each, every row
    counted; decode: 8 slots each, the step's 4 tokens on 8 experts each),
    with deepseek-v3's launches."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    kern = kernels["gmm"]
    m = {}
    for arch, E, D, F, phases in (
            (MOE_ARCH, MOE_E, MOE_D, MOE_F,
             (("prefill", MOE_C_PREFILL, None),
              ("decode", MOE_C_DECODE, "model decode"),
              ("decode_full", MOE_C_DECODE, None))),
            (DS_ARCH, DS_E, DS_D, DS_F,
             (("deepseek_prefill", DS_C_PREFILL, None),
              ("deepseek_decode", DS_C_DECODE, "top-8 decode")))):
        w = torch.randn((E, D, F), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(D ** -0.5)
        be = torch.arange(E, dtype=torch.int32, device="cuda")
        for phase, c, kind in phases:
            T = E * c
            x = torch.randn((T, D), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            counts = gmm_counts(torch, g, kind, E, E, c)
            if counts is None:
                rows, experts = T, E
            else:              # zeros past the counts, as dispatch leaves x
                live = torch.arange(c, device="cuda")[None, :] \
                    < counts[:, None]
                x.mul_(live.reshape(-1, 1))
                rows = int(counts.sum())
                experts = int((counts > 0).sum())
            xe = x.view(E, c, D)

            def kernel():
                return kern(x, w, be, c, counts)
            m[phase] = dict(
                ms=cuda_ms(kernel, 20), device_ms=device_ms(kernel, 20),
                plain_ms=cuda_ms(lambda: ref.gmm(x, w, be, c, counts), 2),
                library_ms=cuda_ms(lambda: torch.bmm(xe, w), 20),
                flops=2 * rows * D * F,
                nbytes=2 * (rows * D + experts * D * F + T * F)
                + 4 * E * (1 + (counts is not None)),
                experts=experts, launches=launches[arch]["gmm"])
        del w
        torch.cuda.empty_cache()
    row = dict(name="gmm", route="cuda",
               source="src/repro_torch/kernels/csrc/moe_gmm.cu",
               replaces="src/repro/kernels/moe_gmm.py:37")
    row.update(timing_row(m["prefill"], m["prefill"]["launches"], err,
                          BF16_FLOPS))
    subs = ("decode", "decode_full", "deepseek_prefill", "deepseek_decode")
    for phase in subs:
        row[phase] = timing_row(m[phase], m[phase]["launches"], err,
                                BF16_FLOPS)
    row["launches_paths"] = {path: n["gmm"] for path, n in launches.items()
                             if "gmm" in n}
    for phase, r in (("prefill", row),) + tuple((p, row[p]) for p in subs):
        mm = m[phase]
        log(f"  gmm {phase}: {mm['ms']:.4f} ms/call (device "
            f"{mm['device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {mm['experts']} experts read, "
            f"{mm['flops'] / 1e9:.2f} GFLOP, {mm['nbytes'] / 1e9:.3f} GB), "
            f"plain {mm['plain_ms']:.4f} ms, bmm {mm['library_ms']:.4f} ms, "
            f"launches {mm['launches']}")
    return [row]


def copy_report(torch, rdma, cases, errs, launches):
    """remote_copy's row: at the failover phase's hop (P = 8, a 20,480-word
    entry packed with its metadata into 20,488 words), with a ``serving``
    entry at the replicated engine's (P = 4, 648 words), each a broadcast
    from one owner.  Bound: :func:`copy_nbytes` of the timed sender map
    ((P + 2)·n·4 bytes for a broadcast, plus the map and the counters) at
    the memory rate; max_abs_err is phase 2's at the same case.  The
    library yardstick is ``src.index_select(0, sender.clamp(min=0))``, one
    PyTorch call that moves the same rows; the port never calls it.
    ``launches`` maps each path to the kernel's launches there."""
    m = {}
    for label, src, dst, sender in cases[:2]:
        n_rows, n = src.shape
        m[n_rows] = dict(
            ms=cuda_ms(lambda: rdma.remote_copy(src, dst, sender), 200),
            device_ms=device_ms(lambda: rdma.remote_copy(src, dst, sender),
                                200),
            plain_ms=cuda_ms(lambda: rdma._remote_copy_ref(src, dst, sender),
                             50),
            library_ms=cuda_ms(lambda: src.index_select(
                0, sender.clamp(min=0)), 200),
            nbytes=copy_nbytes(sender, n), flops=0, err=errs[label],
            shape=label)
    row = dict(name="remote_copy", route="cuda",
               source="src/repro_torch/kernels/csrc/remote_copy.cu",
               replaces="src/repro/kernels/remote_dma.py:239")
    row.update(timing_row(m[8], launches["failover"], m[8]["err"],
                          F32_FLOPS))
    row["serving"] = timing_row(m[4], launches["serving"], m[4]["err"],
                                F32_FLOPS)
    for n_rows, r in ((8, row), (4, row["serving"])):
        mm = m[n_rows]
        log(f"  remote_copy {mm['shape']}: {mm['ms']:.4f} ms/call (device "
            f"{mm['device_ms']:.5f}), bound "
            f"{r['bound_ms']:.6f} ms (bytes; {mm['nbytes'] / 1e3:.1f} KB), "
            f"plain {mm['plain_ms']:.4f} ms, index_select "
            f"{mm['library_ms']:.4f} ms, launches {r['launches']}")
    return [row]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import repro_torch.core as pt
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.wkv6 import wkv6
    model_kernels = {"flash_attention": flash_attention,
                     "decode_attention": decode_attention,
                     "rglru_scan": rglru_scan, "wkv6": wkv6, "gmm": gmm}
    if (NOP, GET, INSERT, UPDATE, DELETE, MOVE) != (
            pt.NOP, pt.GET, pt.INSERT, pt.UPDATE, pt.DELETE, pt.MOVE):
        print("chip_smoke: op codes differ from repro_torch.core's",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slots = KEYS // P + 4
    t0 = time.perf_counter()
    try:
        log("phase 1: build")
        _nvcc.build("remote_dma", "flash_attention", "flash_attention_bwd",
                    "decode_attention", "rglru_scan", "wkv6", "moe_gmm",
                    "remote_copy")
        for name, out in _nvcc.BUILD_LOGS.items():
            log(f"  nvcc {name}.cu:\n" + "\n".join(
                "    " + ln for ln in out.strip().splitlines()))
        log(f"  built in {time.perf_counter() - t0:.1f} s")
        hmma = sass_mma_count(_nvcc, "flash_attention", "flash_fwd_mma")
        check(len(hmma) == 4 and all(n > 0 for n in hmma.values()),
              f"the bf16 flash kernels lack tensor-core HMMA: {hmma}")
        log(f"  cuobjdump -sass, HMMA per tensor-core flash kernel: {hmma}")
        usage = ptxas_usage(_nvcc, "flash_attention", "flash_fwd_mma")
        check(len(usage) == 4 and all(u[0] and not u[1] and not u[2]
                                      for u in usage.values()),
              f"the tensor-core flash kernels spill: {usage}")
        log("  -Xptxas -v, tensor-core flash kernels [registers, spill "
            f"stores, spill loads]: {usage}")
        hmma = sass_mma_count(_nvcc, "moe_gmm", "gmm_mma")
        check(len(hmma) == 3 and all(n > 0 for n in hmma.values()),
              f"the bf16 gmm kernels lack tensor-core HMMA: {hmma}")
        log(f"  cuobjdump -sass, HMMA per tensor-core gmm kernel: {hmma}")
        usage = ptxas_usage(_nvcc, "moe_gmm", "gmm_mma")
        check(len(usage) == 3 and all(u[0] and not u[1] and not u[2]
                                      for u in usage.values()),
              f"the tensor-core gmm kernels spill: {usage}")
        log("  -Xptxas -v, tensor-core gmm kernels [registers, spill stores, "
            f"spill loads]: {usage}")
        usage = ptxas_usage(_nvcc, "rglru_scan", "rglru_tile")
        log("  -Xptxas -v, RG-LRU kernels [registers, spill stores, spill "
            f"loads]: {usage}")
        hmma = sass_mma_count(_nvcc, "flash_attention_bwd", "mma_kernel")
        check(len(hmma) == 4 and all(n > 0 for n in hmma.values()),
              f"the bf16 flash backward kernels lack tensor-core HMMA: "
              f"{hmma}")
        log("  cuobjdump -sass, HMMA per tensor-core flash backward kernel: "
            f"{hmma}")
        usage = ptxas_usage(_nvcc, "flash_attention_bwd", "_kernel")
        mma = {fn: u for fn, u in usage.items() if "mma_kernel" in fn}
        check(len(mma) == 4 and all(u[0] and not u[1] and not u[2]
                                    for u in mma.values()),
              f"the tensor-core flash backward kernels spill: {mma}")
        log("  -Xptxas -v, flash backward kernels [registers, spill stores, "
            f"spill loads]: {usage}")
        log("phase 2: kernels against their plain versions")
        cases, errs = phase_kernels(torch, rdma, slots)
        copy_cases_, copy_errs = phase_copy_kernel(torch, rdma)
        _attn_cases, attn_errs = phase_attention_kernels(torch,
                                                         model_kernels)
        _rec_cases, rec_errs = phase_recurrent_kernels(torch, model_kernels)
        gmm_err = phase_gmm_kernel(torch, model_kernels)
        log("phase 2b: flash attention's backward against its plain version")
        bwd_errs = phase_flash_bwd_kernel(torch)
        log("phase 3: the same work on cuda and cpu")
        phase_parity(torch, pt)
        phase_serving_parity(torch, pt)
        cross_model_parity(torch)
        phase_replicated_parity(torch, pt)
        train_parity(torch)
        log("phase 4: the KVStore path (4a: its lock-free twin; 4c: the "
            "migration scenario)")
        t4 = time.perf_counter()
        metrics, launches = phase_main_path(torch, pt, rdma, slots)
        log(f"  KVStore path took {time.perf_counter() - t4:.1f} s")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the KVStore path")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 4b: the failover scenario on the KVStore path's store")
        t4 = time.perf_counter()
        fo_metrics, fo_launches = phase_failover(torch, pt, rdma, slots)
        log(f"  failover path took {time.perf_counter() - t4:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 4d: the channel objects' scalar verbs")
        t4 = time.perf_counter()
        chan_metrics, chan_launches = phase_channels(torch, pt, rdma)
        log(f"  channel phase took {time.perf_counter() - t4:.1f} s; "
            f"launches {chan_launches}")
        log("phase 4e: the map's executable specification store")
        t4 = time.perf_counter()
        spec_metrics, spec_launches = phase_spec_store(torch, pt, rdma)
        log(f"  spec store phase took {time.perf_counter() - t4:.1f} s; "
            f"launches {spec_launches}")
        for label, counts in (("channel", chan_launches),
                              ("spec store", spec_launches)):
            for name, n in counts.items():
                check(n > 0, f"{name} was not launched in the {label} phase")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 5: the serving paths")
        serve_metrics, serve_launches = {}, {}
        for path in SERVE_PATHS:
            t5 = time.perf_counter()
            label = path_label(path)
            serve_metrics[label], serve_launches[label] = phase_serving(
                torch, model_kernels, path, rdma)
            log(f"  {label} serving path took "
                f"{time.perf_counter() - t5:.1f} s")
            gc.collect()                 # the engine's weights go first
            torch.cuda.empty_cache()
        log("phase 7: the training path")
        t7 = time.perf_counter()
        train_metrics, train_launches = phase_train(torch, model_kernels)
        log(f"  training path took {time.perf_counter() - t7:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 6: report")
        kernels = phase_report(torch, rdma, cases, errs, launches,
                               {"channels": chan_launches,
                                "spec_store": spec_launches})
        kernels += attention_report(
            torch, model_kernels, attn_errs,
            serve_launches | {f"{TRAIN_ARCH} train": {
                "flash_attention": train_launches["flash_attention"]}})
        kernels += flash_bwd_report(torch, bwd_errs,
                                    train_launches["flash_attention_bwd"])
        kernels += recurrent_report(torch, model_kernels, rec_errs,
                                    serve_launches)
        kernels += gmm_report(torch, model_kernels, gmm_err, serve_launches)
        kernels += copy_report(torch, rdma, copy_cases_, copy_errs, {
            "failover": fo_launches["remote_copy"],
            "serving": serve_launches[path_label(SERVE_PATHS[1])][
                "remote_copy"]})
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"  profiler: at most {MARKS_LOST[0]} of {LEAD_MARKS} lead marker "
        f"records lost by one session; {SESSIONS_RUN_AGAIN[0]} sessions "
        f"not whole, run again")
    log(json.dumps(dict(kvstore=metrics, failover=fo_metrics,
                        channels=chan_metrics, spec_store=spec_metrics,
                        serving=serve_metrics, training=train_metrics,
                        profiler_marks_lost=MARKS_LOST[0],
                        profiler_sessions_run_again=SESSIONS_RUN_AGAIN[0],
                        card=card,
                        total_s=time.perf_counter() - t0)))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
