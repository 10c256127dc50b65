#!/usr/bin/env python3
"""Two trees of the repository on one card, in turns: parent, change,
change, parent.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit and, beside this checkout, an unpacked copy of the commit to
compare with (``git archive <commit> | tar -x -C <dir>``):

    python3 chip_compare.py [--groups moe,copy,dma,map,rwkv,rglru,bwd,wkvbwd,rglrubwd,gmmbwd] <parent dir> <change dir>

Each turn is one process that imports ``chip_smoke`` and ``repro_torch``
from its tree and builds that tree's kernels, then, with that tree's code,
runs the groups asked for (all ten by default):

* ``moe``: serves llama4-maverick-400b-a17b at full width and 4 layers
  (512-token prompts) as ``chip_smoke.py``'s phase 5 does, with its checks
  and launch counts, and times ``models/moe.py::moe_block_local`` at full
  width on one MoE layer's weights (128 experts of 5120 x 8192, top-1, a
  shared expert; bf16, drawn from a seed) for a decode step's 4 tokens and
  a prefill's 2,048 (4 prompts of 512);
* ``copy``: times ``remote_copy`` at both ring-hop shapes (P = 8 with
  20,488 words, P = 4 with 648; a broadcast) with an int32 and an int64
  sender map, and ``index_select`` of the same rows beside it;
* ``dma``: the map's verbs on the remote-DMA backend at the KVStore
  path's shapes (P = 8, 512 lanes a participant, 2**22 / 8 + 4 slots of
  5 int32 words, a ledger enabled): ``build_descriptors`` and
  ``gather_rows`` on the arguments the verbs pass them (bool masks, the
  read verb's index as a stride-0 broadcast of one vector),
  ``scatter_rows`` on the write verb's (that broadcast index, bool apply
  and wire masks, the home buffer whole), and
  ``PallasDmaBackend().read_batch`` and ``.write_batch`` whole;
* ``map``: the channel layer on the stacked binding at the KVStore path's
  shapes, on the remote-DMA backend: a barrier crossing and a single
  contended ticket lock's round at P = 8 (``chip_smoke.py``'s phase 4d),
  then the KVStore path's store (K = 2**22, index 4·K, 4,096 locks) through
  64 INSERT windows of 512 lanes a participant and 20 each of the main
  path's mixed and zipf windows, each window's host time to its results
  (p50 over the windows; no device time);
* ``rwkv``: times ``wkv6`` in bf16 at rwkv6-7b's prefill shape (4 prompts
  of 512 tokens, 64 heads of 64, inputs as (B, H, S, D) views of
  (B, S, H, D) projections) and serves rwkv6-7b at full width and depth
  (512-token prompts) as ``chip_smoke.py``'s phase 5 does, with its
  checks and launch counts;
* ``rglru``: times ``rglru_scan`` in bf16 at recurrentgemma-2b's prefill
  shape (4 prompts of 2304 tokens, 2560 channels, log_a in the model's
  range) and serves recurrentgemma-2b at full width and depth (2304-token
  prompts) as ``chip_smoke.py``'s phase 5 does, with its checks and launch
  counts;
* ``bwd``: times ``flash_attention_bwd`` at llama3.2-3b's training shape
  (B 2, 24 query heads on 8 kv heads, S 4096, D 128, bf16, causal) and
  at recurrentgemma-2b's (B 2, 10 query heads on 1 kv head, S 4096, D
  256, bf16, a 2,048-token window; q, k, v and dout (B, H, S, D) views of
  (B, S, H, D) memory, out and lse from the forward kernel), then trains
  llama3.2-3b and recurrentgemma-2b at full width and depth for 3 steps
  each of 2 x 4096 tokens (``remat="block"``, AdamW) as
  ``chip_smoke.py``'s phase 7 does, on one repeated batch: step ms and
  tokens/s over the steps after the first, the first step's ms, losses
  finite;
* ``wkvbwd``: times ``wkv6_bwd`` at rwkv6-7b's training shape (B 2, 64
  heads of 64, S 4096, float32; r, k, v, w and dy (B, H, S, D) views of
  (B, S, H, D) memory, ds_final None, as the model passes them) and trains
  rwkv6-7b at full width and depth for 3 steps of 2 x 4096 tokens
  (``remat="block"``, Adafactor) as ``chip_smoke.py``'s phase 7 does, on
  one repeated batch: the same step numbers, and the peak device GiB;
* ``rglrubwd``: times the RG-LRU backward at recurrentgemma-2b's training
  shape (B 2, S 4096, 2560 channels, bf16, log_a in the model's range)
  through the interface both trees share: ``RGLRUScan.apply(x, log_a)``
  once with grad on, then ``torch.autograd.grad`` of y with a seeded dy,
  the graph retained, in the timed loop (the backward kernels and what
  autograd adds); then trains recurrentgemma-2b at full width and depth
  for 3 steps of 2 x 4096 tokens (``remat="block"``, AdamW) as
  ``chip_smoke.py``'s phase 7 does: the same step numbers;
* ``gmmbwd``: times the grouped matmul's backward, ``gmm_dx`` and
  ``gmm_dw``, at ``chip_smoke.py``'s phase-6 shapes (the gate/up product
  at 2 x 4,096 tokens: llama4-maverick's 128 experts of 5120 x 8192, 80
  slots, top-1; deepseek-v3's 256 of 7168 x 2048, 320 slots, top-8; the
  counts of a dispatch, x and dy zero past them; bf16), and
  ``models/moe.py::moe_block_local``'s forward and backward at both
  models' published widths on 2 x 4,096 tokens, as phase 7's full-width
  blocks (weights drawn one expert at a time, the router's column of
  expert 0 zeroed, the loss a fixed random projection of the output).

Times are the wrapper's (CUDA events around a loop of calls), the device
time per call and the device operations (kernels, copies, fills) per call
(both from ``torch.profiler``); training steps are timed on the host clock
to the loss's read.  It prints one ``TURN {json}``
line per turn, a table of every number per turn, and last one JSON object
of all turns.  Imports neither JAX nor the JAX package.  Host-bound numbers
move up to 2x between calls, so only turns of one run compare.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

SERVE_KEYS = ("prefill_ms_p50", "decode_step_p50_ms", "decode_step_p99_ms",
              "tokens_per_s")
# (label, B, S): the MoE block's input, B sequences of S tokens
MOE = [("moe_block 4 tokens", 4, 1), ("moe_block 2048 tokens", 4, 512)]
TIMED = ("ms", "device_ms", "device_ops")
TRAIN_KEYS = ("step_ms_p50", "tokens_per_s", "first_step_ms", "peak_gib")
LEAD_MARKS = 128           # marker kernels before a profiled session's calls
TRAIN_STEPS = 3
# the CUDA sources each group's turn builds
SOURCES = {"moe": ("flash_attention", "decode_attention", "rglru_scan",
                   "wkv6", "moe_gmm", "remote_copy", "remote_dma"),
           "copy": ("remote_copy",), "dma": ("remote_dma",),
           "map": ("remote_dma",),
           "rwkv": ("wkv6",),
           "rglru": ("flash_attention", "decode_attention", "rglru_scan"),
           "bwd": ("flash_attention", "flash_attention_bwd",
                   "flash_attention_bwd_sm90", "rglru_scan"),
           "wkvbwd": ("wkv6", "wkv6_bwd"),
           "rglrubwd": ("flash_attention", "flash_attention_bwd",
                        "rglru_scan"),
           "gmmbwd": ("moe_gmm", "moe_gmm_dx", "moe_gmm_dw")}
GROUPS = tuple(SOURCES)
# the architectures a group serves, each timed by SERVE_KEYS
SERVED = ("llama4-maverick-400b-a17b", "rwkv6-7b", "recurrentgemma-2b")


def turn(root: str, tag: str, groups) -> dict:
    """One tree's numbers, in this process."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import moe
    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"flash_attention": flash_attention,
               "decode_attention": decode_attention,
               "rglru_scan": rglru_scan, "wkv6": wkv6, "gmm": gmm}
    _nvcc.build(*sorted({n for g in groups for n in SOURCES[g]
                         if (_nvcc.CSRC / f"{n}.cu").exists()}))
    res = {"tag": tag, "root": root, "card": cs.card_line()}

    def timed(label, fn, iters):
        res[label] = {"ms": cs.cuda_ms(fn, iters)}
        res[label]["device_ms"], res[label]["device_ops"] = device_time(
            torch, fn, iters)

    if "moe" in groups:
        path = next(p for p in cs.SERVE_PATHS if p["arch"] == cs.MOE_ARCH)
        m, launches = cs.phase_serving(torch, kernels, dict(path, a2a=False),
                                       rdma)
        res[cs.MOE_ARCH] = {k: m[k] for k in SERVE_KEYS}
        res[cs.MOE_ARCH]["gmm launches"] = launches["gmm"]
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(cs.MOE_ARCH)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
        params = moe.init_moe(g, cfg)
        for label, B, S in MOE:
            x = torch.randn((B, S, cfg.d_model), generator=g,
                            device="cuda").to(cfg.dtype_)
            timed(label, lambda: moe.moe_block_local(params, x, cfg),
                  20 if S == 1 else 10)
        del params, x
        gc.collect()
        torch.cuda.empty_cache()

    if "copy" in groups:
        for label, src, dst, sender in cs.copy_cases(torch)[:2]:
            n_rows, n = src.shape
            for dt in (torch.int32, torch.int64):
                s = sender.to(dt)
                timed(f"remote_copy P={n_rows} {str(dt)[6:]} map",
                      lambda: rdma.remote_copy(src, dst, s), 200)
            idx = sender.clamp(min=0)
            timed(f"index_select P={n_rows}",
                  lambda: src.index_select(0, idx), 200)

    if "dma" in groups:
        dma_verbs(torch, cs, rdma, timed)

    if "map" in groups:
        map_windows(torch, cs, timed, res)

    if "rwkv" in groups:
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
        B, H, S, D = cs.SERVE_BATCH, 64, cs.SERVE_PROMPT, 64
        r, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        w = torch.exp(-torch.exp(-4.0 + 0.5 * torch.randn(
            (B, S, H, D), generator=g, device="cuda"))).to(
                torch.bfloat16).transpose(1, 2)
        u = (0.1 * torch.randn((H, D), generator=g, device="cuda")).to(
            torch.bfloat16)
        timed("wkv6 bf16, B=4 H=64 S=512 D=64",
              lambda: wkv6(r, k, v, w, u), 50)
        del r, k, v, w, u
        path = next(p for p in cs.SERVE_PATHS if p["arch"] == "rwkv6-7b")
        m, launches = cs.phase_serving(torch, kernels, path, rdma)
        res["rwkv6-7b"] = {k: m[k] for k in SERVE_KEYS}
        res["rwkv6-7b"]["wkv6 launches"] = launches["wkv6"]
        gc.collect()
        torch.cuda.empty_cache()

    if "rglru" in groups:
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
        B, S, D = cs.SERVE_BATCH, cs.RG_PROMPT, 2560
        x = torch.randn((B, S, D), generator=g, device="cuda").to(
            torch.bfloat16)
        la = (-0.106 * torch.rand((B, S, D), generator=g, device="cuda")).to(
            torch.bfloat16)
        timed(f"rglru_scan bf16, B={B} S={S} D={D}",
              lambda: rglru_scan(x, la), 50)
        del x, la
        path = next(p for p in cs.SERVE_PATHS
                    if p["arch"] == "recurrentgemma-2b")
        m, launches = cs.phase_serving(torch, kernels, path, rdma)
        res["recurrentgemma-2b"] = {k: m[k] for k in SERVE_KEYS}
        res["recurrentgemma-2b"]["rglru_scan launches"] = \
            launches["rglru_scan"]
        gc.collect()
        torch.cuda.empty_cache()

    if "bwd" in groups:
        flash_bwd_and_training(torch, cs, timed, res)
    if "wkvbwd" in groups:
        wkv_bwd_and_training(torch, cs, timed, res)
    if "rglrubwd" in groups:
        rglru_bwd_and_training(torch, cs, timed, res)
    if "gmmbwd" in groups:
        gmm_bwd_and_blocks(torch, cs, timed, res)
    return res


def flash_bwd_and_training(torch, cs, timed, res):
    """Flash attention's backward at llama3.2-3b's and recurrentgemma-2b's
    training shapes, then a few training steps of each model as phase 7
    runs them.  Inputs and weights are made here from a seed, alike in
    both trees."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    B, S = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    for Hq, Hkv, D, window in ((24, 8, 128, None), (10, 1, 256, 2048)):
        def bhsd(H):
            return torch.randn((B, S, H, D), generator=g, device="cuda").to(
                torch.bfloat16).transpose(1, 2)

        q, k, v, dout = bhsd(Hq), bhsd(Hkv), bhsd(Hkv), bhsd(Hq)
        out, lse = fa._forward(q, k, v, True, window, D ** -0.5, 0, True)
        mask = "causal" if window is None else f"window {window}"
        timed(f"flash_attention_bwd bf16, B={B} H={Hq}/{Hkv} S={S} D={D} "
              f"{mask}",
              lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=True, window=window), 10)
        del q, k, v, dout, out, lse
    train_steps(torch, cs, res, cs.TRAIN_ARCH, "adamw")
    train_steps(torch, cs, res, "recurrentgemma-2b", "adamw")


def wkv_bwd_and_training(torch, cs, timed, res):
    """The WKV's backward at rwkv6-7b's training shape, then a few training
    steps of rwkv6-7b as phase 7 runs them (Adafactor).  Inputs and
    weights are made here from a seed, alike in both trees."""
    from repro_torch.kernels.wkv6 import wkv6_bwd
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 16)
    B, H, S, D = cs.TRAIN_BATCH, 64, cs.TRAIN_SEQ, 64

    def bhsd():
        return torch.randn((B, S, H, D), generator=g,
                           device="cuda").transpose(1, 2)

    r, k, v, dy = (bhsd() for _ in range(4))
    w = torch.exp(-torch.exp(-4.0 + 0.5 * bhsd()))
    u = 0.1 * torch.randn((H, D), generator=g, device="cuda")
    timed(f"wkv6_bwd float32, B={B} H={H} S={S} D={D}",
          lambda: wkv6_bwd(r, k, v, w, u, dy), 10)
    del r, k, v, w, u, dy
    train_steps(torch, cs, res, "rwkv6-7b", "adafactor")


def rglru_bwd_and_training(torch, cs, timed, res):
    """The RG-LRU's backward at recurrentgemma-2b's training shape through
    ``RGLRUScan`` (the forward once, then autograd's backward in the loop:
    whatever each tree's Function keeps for it), then a few training steps
    of recurrentgemma-2b as phase 7 runs them (AdamW).  Inputs and weights
    are made here from a seed, alike in both trees."""
    from repro_torch.kernels.rglru_scan import RGLRUScan
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    B, S, D = cs.TRAIN_BATCH, cs.TRAIN_SEQ, 2560
    x, dy = (torch.randn((B, S, D), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    la = (-0.106 * torch.rand((B, S, D), generator=g, device="cuda")).to(
        torch.bfloat16)
    x.requires_grad_(True)
    la.requires_grad_(True)
    y, _h = RGLRUScan.apply(x, la)
    timed(f"RGLRUScan backward bf16, B={B} S={S} D={D}",
          lambda: torch.autograd.grad((y,), (x, la), (dy,),
                                      retain_graph=True), 20)
    del x, dy, la, y, _h
    train_steps(torch, cs, res, "recurrentgemma-2b", "adamw")


def gmm_bwd_and_blocks(torch, cs, timed, res):
    """The grouped matmul's backward kernels at phase 6's shapes, then one
    MoE block's forward and backward at each model's published widths, as
    phase 7 runs it.  Inputs and weights are made here from a seed, alike
    in both trees, through the interfaces both share."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import moe
    from repro_torch.tree import flatten
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
    tokens = cs.TRAIN_BATCH * cs.TRAIN_SEQ
    for tag, E, D, F, C, k in (
            ("llama4", cs.MOE_E, cs.MOE_D, cs.MOE_F, cs.MOE_C_TRAIN, 1),
            ("deepseek", cs.DS_E, cs.DS_D, cs.DS_F, cs.DS_C_TRAIN, cs.DS_K)):
        w = torch.randn((E, D, F), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(D ** -0.5)
        be = torch.arange(E, dtype=torch.int32, device="cuda")
        counts = cs.dispatch_counts(torch, g, E, C, tokens, k, edges=False)
        live = (torch.arange(C, device="cuda")[None, :]
                < counts[:, None]).reshape(-1, 1)
        x = torch.randn((E * C, D), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(live)
        dy = torch.randn((E * C, F), generator=g, device="cuda",
                         dtype=torch.bfloat16).mul_(live)
        timed(f"gmm_dx {tag} {E} x {D}x{F}, C {C}",
              lambda: moe_gmm.gmm_dx(dy, w, be, C, counts), 10)
        timed(f"gmm_dw {tag} {E} x {D}x{F}, C {C}",
              lambda: moe_gmm.gmm_dw(x, dy, be, C, counts, E), 10)
        del w, x, dy
        gc.collect()
        torch.cuda.empty_cache()
    for arch in (cs.MOE_ARCH, cs.DS_ARCH):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 19)
        params = moe.init_moe(gen, cfg)
        params["router"][:, 0] = 0.0
        leaves = [t.requires_grad_(True) for _path, t in flatten(params)]
        B, S = cs.TRAIN_BATCH, cs.TRAIN_SEQ
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.dtype_).requires_grad_(True)
        proj = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")

        def block():
            out, _aux = moe.moe_block_local(params, x, cfg)
            return torch.autograd.grad((out.float() * proj).sum(),
                                       leaves + [x])
        timed(f"moe_block_local {arch} forward + backward, {B} x {S}",
              block, 3)
        del params, leaves, x, proj
        gc.collect()
        torch.cuda.empty_cache()


def train_steps(torch, cs, res, arch, optimizer):
    """``TRAIN_STEPS`` training steps of ``arch`` at full width and depth
    as phase 7 runs them (bf16, TRAIN_BATCH x TRAIN_SEQ tokens,
    ``remat="block"``, ``optimizer``) on one repeated batch: step ms and
    tokens/s over the steps after the first, the first step's ms, the
    peak device GiB, losses finite."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as launcher
    cfg = get_config(arch)
    pipe = cs.RepeatedBatch(SyntheticTokens(cfg, cs.TRAIN_BATCH,
                                            cs.TRAIN_SEQ, cs.SEED))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = launcher.run(cfg, TrainConfig(remat="block", optimizer=optimizer),
                       pipe, steps=TRAIN_STEPS, device="cuda",
                       log_every=TRAIN_STEPS)
    if not all(np.isfinite(run["losses"])):
        raise RuntimeError(f"{arch} training losses {run['losses']}")
    step_s = float(np.percentile(run["step_s"][1:], 50))
    res[f"{arch} train"] = dict(
        step_ms_p50=1e3 * step_s,
        tokens_per_s=cs.TRAIN_BATCH * cs.TRAIN_SEQ / step_s,
        first_step_ms=1e3 * run["step_s"][0],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        losses=run["losses"])
    del run
    gc.collect()
    torch.cuda.empty_cache()


def dma_verbs(torch, cs, rdma, timed):
    """The read verb's and the write verb's wire path at the KVStore path's
    shapes: the three kernels on the arguments the verbs pass them, and the
    verbs whole on the remote-DMA backend with a ledger enabled.  Inputs
    are made here from a seed, alike in both trees."""
    from repro_torch.core.backends import PallasDmaBackend
    from repro_torch.core.runtime import TrafficLedger
    P, R, width = cs.P, cs.B, cs.W + 3
    slots = cs.KEYS // cs.P + 4
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    buf = ints(-2 ** 31, 2 ** 31 - 1, (P, slots, width))
    targets, indices = ints(0, P, (P, R)), ints(0, slots, (P, R))
    preds = ints(0, 2, (P, R)) != 0
    me = torch.arange(P, dtype=torch.int32, device="cuda")[:, None]
    remote = preds & (targets != me)
    timed("build_descriptors, read verb (bool en)",
          lambda: rdma.build_descriptors(targets, indices, remote,
                                         op=rdma.OP_READ,
                                         row_nbytes=4 * width), 200)
    timed("build_descriptors, write verb (bool en, wire)",
          lambda: rdma.build_descriptors(targets, indices, preds,
                                         wire=remote, op=rdma.OP_WRITE,
                                         row_nbytes=4 * width), 200)
    # the read verb's home side: every home sees all P·R lanes, one index
    # vector broadcast to every home, a bool mask of the lanes it serves
    idx = indices.reshape(-1)
    mask = (targets.reshape(-1)[None, :] == me) & remote.reshape(-1)[None, :]
    timed("gather_rows, read verb (broadcast index, bool mask)",
          lambda: rdma.gather_rows(buf, idx[None, :].expand(P, -1), mask),
          200)
    # the write verb's home side: the same broadcast index, every lane's
    # payload, bool masks of the lanes a home applies and of those that
    # came over the wire
    win = (targets.reshape(-1)[None, :] == me) & preds.reshape(-1)[None, :]
    origin = torch.arange(P * R, device="cuda")[None, :] // R
    wire = win & (origin != me)
    payload = ints(-2 ** 31, 2 ** 31 - 1, (P, P * R, width))
    timed("scatter_rows, write verb (broadcast index, bool masks)",
          lambda: rdma.scatter_rows(buf, idx[None, :].expand(P, -1), payload,
                                    win, wire), 200)
    del payload
    values = ints(-2 ** 31, 2 ** 31 - 1, (P, R, width))
    ledger = TrafficLedger().enable()
    backend = PallasDmaBackend()
    timed("PallasDmaBackend.read_batch",
          lambda: backend.read_batch(buf, targets, indices, preds=preds,
                                     ledger=ledger, verb="read"), 50)
    timed("PallasDmaBackend.write_batch",
          lambda: backend.write_batch(buf, targets, indices, values,
                                      preds=preds, ledger=ledger,
                                      verb="write"), 20)


def map_windows(torch, cs, timed, res):
    """The ``map`` group: the barrier crossing and the lock round timed as
    calls, then the KVStore path's store window by window.  Inputs come
    from a seed, alike in both trees."""
    import time

    import numpy as np

    import repro_torch.core as pt
    P, B = cs.P, cs.B
    mgr = pt.make_manager(P, backend="pallas")
    bar = pt.Barrier(None, "bar", mgr)
    bst = [bar.init_state()]

    def cross():
        bst[0] = bar.wait(bst[0])

    timed(f"barrier crossing P={P}", cross, 200)
    lock = pt.TicketLock(None, "lock", mgr)
    lst = [lock.init_state(),
           torch.full((P,), pt.NO_TICKET, dtype=torch.int64, device="cuda")]

    def lock_round():
        st, t = lst
        st, t2 = lock.acquire(st, want=t == pt.NO_TICKET)
        t = torch.where(t == pt.NO_TICKET, t2, t)
        holds = lock.holds(st, t)
        lst[:] = [lock.release(st, holds), torch.where(holds, pt.NO_TICKET,
                                                       t)]

    timed(f"single-lock round P={P}", lock_round, 200)
    kv = pt.KVStore(None, "kv", mgr, slots_per_node=cs.KEYS // P + 4,
                    value_width=cs.W, num_locks=4096,
                    index_capacity=4 * cs.KEYS)
    st = kv.init_state()
    rng = np.random.default_rng(cs.SEED + 16)
    span = P * B

    def fill(i):
        ks = np.arange(i * span + 1, (i + 1) * span + 1, dtype=np.uint32)
        return (np.full((P, B), cs.INSERT, np.int32), ks.reshape(P, B),
                np.zeros((P, B, cs.W), np.int32))

    zipf = cs.zipf_sampler(rng)
    for label, wins in (
            ("map fill window", [fill(i) for i in range(64)]),
            ("map mixed window", [cs.mixed_window(rng, w)
                                  for w in range(20)]),
            ("map zipf window", [cs.zipf_window(zipf, rng, w)
                                 for w in range(20)])):
        times = []
        for ops, ks, vals in wins:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, out = kv.op_window(st, ops, ks, vals)
            out.found.cpu()
            times.append(time.perf_counter() - t0)
        res[label] = {"ms": 1e3 * float(np.median(times)),
                      "device_ms": None, "device_ops": None}
    del st, kv
    gc.collect()
    torch.cuda.empty_cache()


def device_time(torch, fn, iters):
    """(device ms, device operations) of one call under
    ``torch.profiler``: each kernel, copy or fill's mean duration times the
    number of times a call runs it, and the device operations recorded,
    over the calls.  Kept here so that both trees are timed alike; like
    ``chip_smoke.profiled_calls`` it leads the calls with marker kernels,
    not counted, which absorb the device records a session may lose at
    its start."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(LEAD_MARKS):
            torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "spin_kernel" not in e.name:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        return None, None
    return (sum(us / n * max(1, round(n / iters))
                for us, n in by_name.values()) / 1e3,
            sum(n for _us, n in by_name.values()) / iters)


def main(argv) -> int:
    if len(argv) == 5 and argv[1] == "--turn":
        print("TURN " + json.dumps(turn(argv[2], argv[3],
                                        argv[4].split(","))), flush=True)
        return 0
    groups = ",".join(GROUPS)
    if len(argv) == 5 and argv[1] == "--groups":
        groups, argv = argv[2], argv[:1] + argv[3:]
    if len(argv) != 3 or not set(groups.split(",")) <= set(GROUPS):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device is available", file=sys.stderr)
        return 2
    parent, change = (os.path.abspath(p) for p in argv[1:])
    turns = []
    for root, tag in ((parent, "parent"), (change, "change"),
                      (change, "change"), (parent, "parent")):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root, tag, groups],
                             capture_output=True,
                             text=True, timeout=1200)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            print(f"chip_compare: the {tag} turn failed", file=sys.stderr)
            return 1
        turns.append(json.loads(lines[-1][5:]))
        print(lines[-1], flush=True)
    rows = [(f"{arch} {k}", arch, k) for arch in SERVED if arch in turns[0]
            for k in SERVE_KEYS]
    rows += [(f"{group} {k}", group, k) for group in turns[0]
             if isinstance(turns[0][group], dict) and group not in SERVED
             for k in (TRAIN_KEYS if group.endswith(" train") else TIMED)]
    print(f"{'':64s}" + "".join(f"{t['tag']:>12s}" for t in turns))
    for name, group, key in rows:
        print(f"{name:64s}" + "".join(
            f"{t[group][key]:12.4f}" if t[group][key] is not None
            else f"{'-':>12s}" for t in turns))
    print(turns[0]["card"])
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
