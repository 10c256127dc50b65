#!/usr/bin/env python3
"""Planted faults against ``chip_smoke.py``'s phase 2c comparison of the
recurrences' backward kernels, RG-LRU and WKV6, and its phase 2b
comparisons of the grouped matmul's backward, ``gmm_dx`` and ``gmm_dw``,
and of flash attention's backward on its ``wgmma`` route.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_bwd_faults.py

It builds copies of ``src/repro_torch/kernels/csrc/rglru_scan.cu``, of
``wkv6_bwd.cu``, of ``moe_gmm_dx.cu``, of ``moe_gmm_dw.cu`` and of
``flash_attention_bwd_sm90.cu`` (with the headers beside them) in
temporary directories, each with one fault
planted in a backward kernel, and runs each on its phase's cases of that
kernel: the RG-LRU's training-shape, D = 100 and log_a = 0 cases, bf16 and
float32, each on the tile states the kernel as it is kept in its forward
(the faults that cross tiles only on the cases of more than one tile);
the WKV's training-shape and w = 0 cases; the grouped matmul's backward
at its bf16 training shapes and edge cases (rows past the counts hold
random values); flash attention's backward at phase 2b's bf16 cases at D
192 and 256 (a group of 5 under a 2,048-token window; a group of 2 under
a window of 100, where a key tile's last query tile holds a third of its
keys' pairs (under the 2,048-token window one query tile of 33 moves dk
by less than the tolerance); MLA's D 192 with v zero-padded; a group of
3 over a ragged Sk).  Phase 2b holds each ``wgmma`` case within the
tolerance of both the plain version that rounds P and dS to bf16 and the
unrounded one, whose difference is a small part of the tolerance, so no
fault of the rounding alone is planted: the dS fault corrupts dQ's
operand fragments instead.  For each copy, case and output it prints the
reading of the comparison (``chip_smoke.elementwise_err`` under ``BWD_TOL``:
above 1 fails; for flash attention phase 2b's ``bwd_rel_err`` against
both plain versions over ``ATTN_TOL``), for the RG-LRU beside the
max-scaled one it replaced (max |got - plain| over max(1, max |plain|),
held to 1e-4 in float32 and 1e-2 in bf16).  Each kernel as it is runs first.  Exits non-zero if a kernel as
it is fails the comparison or a planted fault passes it in the output it
changes.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
GATE = ("const float q = gate > 0.f ? __fdividef(a * a * xv, gate) : "
        "0.f;")
DX = "put(sx[t][c], gate * g);"
# the RG-LRU backward's fold of the later tiles' aggregates into e after
# the tile, its start state, and the aggregate's product of a
E_FOLD = "    for (int j = n_tiles - 1; j > i_hi; --j)"
H_IN = "        h_next = car[static_cast<long long>(i - 1) * D];"
P_LAST = "      P *= a;\n"
# the RG-LRU cases of more than one tile
TILES = ("train shape bfloat16", "train shape float32",
         "log_a = 0 runs S=600 bfloat16", "log_a = 0 runs S=600 float32")
# the WKV backward: stage 1's G jump, its prefix scan, du's sum, dw's store
JUMP = "      const float wr = sm.W[i0 + r];"
PREFIX = ("for (int t = 0; t < kJ; ++t) {  // r_t . prod_{tau < t} w_tau\n"
          "          sm.a[t][i] *= q;\n"
          "          q *= sm.w[t][i];")
DU = "    for (int c = 0; c < n; ++c)"
DW = "                a.out[kDW][o] = pw[m];"
# the grouped matmul's backward: dw's zeroing of rows past a count, dx's
# live m64 tiles, the rows a dw step takes.  A ring stage reused one phase
# early is not planted: a producer that re-arms a stage's barrier before
# its phase completes breaks the mbarrier protocol and hangs the kernel
# (seen on the card), and a stage handed back before its products finish
# only races the refill against wgmma's reads, which a run may not show
ZERO = "      if (step.rows % 16) {"
TILES_MT = "  t.n_mt = (t.rows + 63) / 64;"
STEP_ROWS = "              meta[s] = {rows, next == nb && j == n_list - 1 && " \
    "r + kK >= b.y};"
# the grouped matmul's phase 2b cases the faults run on
GMM_TRAIN = ("llama4 5120->8192", "deepseek 7168->2048")
GMM_EDGES = ("counts 63 64 65 127 128 129 320 0, block_t 320",
             "counts 63 64 65 127 128 1, block_t 128")
GMM_A2A = ("llama4 a2a Pd=2 5120->8192",
           "a2a Pd=2, experts 0 and 2 counted in their second block only")
# kernel: (source, faults {fault: (line, its faulty form, the cases it runs
# on)}); each kernel as it is runs on every case first
GMM = {
    "gmm_dx": ("moe_gmm_dx.cu", {
        "the last live m64 tile skipped": (
            TILES_MT, "  t.n_mt = (t.rows + 63) / 64 - (t.rows > 64);",
            GMM_TRAIN + GMM_EDGES)}),
    "gmm_dw": ("moe_gmm_dw.cu", {
        "rows past a count in a block's last step not zeroed": (
            ZERO, "      if (false) {", GMM_TRAIN + GMM_EDGES),
        "an expert's blocks after its first skipped": (
            STEP_ROWS, "              meta[s] = {j > 0 ? 0 : rows, "
            "next == nb && j == n_list - 1 && r + kK >= b.y};", GMM_A2A)}),
}
# flash attention's wgmma backward (flash_attention_bwd_sm90.cu): the
# dK/dV walk's steps over the group's heads, its window's query range,
# dQ's dS fragments; phase 2b's bf16 cases the faults run on
FLASH_WINDOW = "D=256 G=5 window 2048"
FLASH_SHORT = "D=256 G=2 window 100"
FLASH_MLA = "MLA D=192 v padded from 128"
FLASH_RAGGED = "D=256 ragged Sk bidirectional"
HEADS = "  const int n_steps = G * qts;"
Q_END = "  if (a.window > 0) q_end = min(q_end, k_last - a.offset + a.window);"
DS_FRAG = "    for (int kk = 0; kk < 4; ++kk) a_frag(f[kk], dp, kk);"
# fault: (line, its faulty form, the outputs it changes (0 dq, 1 dk, 2
# dv), the cases it runs on)
FLASH = {
    "one query head of the group left out of dK/dV": (
        HEADS, "  const int n_steps = (G - 1) * qts;", (1, 2),
        (FLASH_WINDOW, FLASH_SHORT, FLASH_RAGGED)),
    "the last query tile of a window skipped": (
        Q_END, "  if (a.window > 0) q_end = min(q_end, k_last - a.offset + "
        "a.window - kT);", (1, 2), (FLASH_SHORT,)),
    "dQ's dS fragments corrupt: float32 bits read as bf16 pairs": (
        DS_FRAG, "    for (int kk = 0; kk < 4; ++kk)\n"
        "      for (int r = 0; r < 4; ++r)\n"
        "        f[kk][r] = __float_as_uint(dp[8 * kk + 2 * r]);", (0,),
        (FLASH_WINDOW, FLASH_SHORT, FLASH_MLA, FLASH_RAGGED)),
}
# kernel: (source, outputs, cases, {fault: (line, its faulty form, the
# output it changes[, the cases it runs on, if not all])})
KERNELS = {
    "rglru_scan_bwd": ("rglru_scan.cu", ("dx", "dlog_a"), (
        "train shape bfloat16", "train shape float32",
        "S=37 D=100 dh_final bfloat16", "S=37 D=100 dh_final float32",
        "log_a = 0 runs S=600 bfloat16", "log_a = 0 runs S=600 float32"), {
        "gate term dropped": (GATE, "const float q = 0.f;", 1),
        "gate term 1% high": (GATE, "const float q = gate > 0.f ? "
                              "1.01f * __fdividef(a * a * xv, gate) : 0.f;",
                              1),
        "gate term 1% high where b > 1/16": (
            GATE, "const float q = gate > 0.f ? (gate > 0.0625f ? 1.01f : "
            "1.f) * __fdividef(a * a * xv, gate) : 0.f;", 1),
        "dx 1% high": (DX, "put(sx[t][c], 1.01f * gate * g);", 0),
        "e_in folds one tile too few": (
            E_FOLD, "    for (int j = n_tiles - 1; j > i_hi + 1; --j)", 0,
            TILES),
        "h_in from the next tile's state": (
            H_IN, "        h_next = car[static_cast<long long>(i) * D];", 1,
            TILES),
        "P_i without its tile's last a": (
            P_LAST, "      P *= w == kW - 1 && k == kK - 1 ? 1.f : a;\n",
            1, TILES)}),
    "wkv6_bwd": ("wkv6_bwd.cu", ("dr", "dk", "dv", "dw", "du"), (
        "train shape float32", "w = 0 S=200 float32"), {
        "E^c jumps without its chunk's decay": (
            JUMP, "      const float wr = grads ? 1.f : sm.W[i0 + r];", 1),
        "the prefix product P' includes step t": (
            PREFIX, "for (int t = 0; t < kJ; ++t) {\n"
            "          q *= sm.w[t][i];\n          sm.a[t][i] *= q;", 1),
        "du takes only the first chunk's partial": (
            DU, "    for (int c = 0; c < 1; ++c)", 4),
        "dw drops each chunk's last step": (
            DW, "                a.out[kDW][o] = tl == kL - 1 ? 0.f : "
            "pw[m];", 3)}),
}


def planted(csrc, source, src, line, faulty):
    """A temporary directory holding ``source`` with ``line`` replaced by
    ``faulty`` and the headers beside it."""
    assert src.count(line) == 1, line
    tmp = Path(tempfile.mkdtemp())
    (tmp / source).write_text(src.replace(line, faulty))
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, tmp / header.name)
    return tmp


def gmm_faults(torch, cs, _nvcc, mg, ref, tmps, csrc, build):
    """The grouped matmul's backward faults (``GMM``) on phase 2b's cases,
    one case's inputs at a time (a full-width case holds 10.7 GB of
    weights and as much gradient): each kernel as it is (from ``csrc``,
    built into ``build``), then each copy with a planted fault that runs
    on the case; returns the (kernel, fault, case) readings that went the
    wrong way."""
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 17)
    calls = {"gmm_dx": (mg._DX_LIB, lambda x, dy, w, be, bt, n: mg.gmm_dx(
                 dy, w, be, bt, n), lambda x, dy, w, be, bt, n: ref.gmm(
                 dy, w.transpose(1, 2), be, bt, n)),
             "gmm_dw": (mg._DW_LIB, lambda x, dy, w, be, bt, n: mg.gmm_dw(
                 x, dy, be, bt, n, w.shape[0]), lambda x, dy, w, be, bt, n:
                 ref.gmm_dw(x, dy, be, bt, n, w.shape[0]))}
    copies = {}                    # (kernel, fault): its source directory
    for name, (source, faults) in GMM.items():
        src = (csrc / source).read_text()
        copies[(name, "none")] = csrc
        for fault, (line, faulty, _only) in faults.items():
            tmps.append(planted(csrc, source, src, line, faulty))
            copies[(name, fault)] = tmps[-1]
    labels = set(GMM_TRAIN + GMM_EDGES + GMM_A2A)
    bad = []
    try:
        for case in cs.gmm_bwd_cases():
            if case[0] not in labels:
                continue
            label, args = case[0], cs.gmm_bwd_inputs(torch, g, case)
            for name, (lib, call, plain_fn) in calls.items():
                plain = plain_fn(*args)
                for (kernel, fault), where in copies.items():
                    only = labels if fault == "none" else \
                        GMM[kernel][1][fault][2]
                    if kernel != name or label not in only:
                        continue
                    _nvcc.CSRC = where
                    _nvcc.BUILD = build if where is csrc else where / "build"
                    lib._lib = None
                    got = call(*args)
                    torch.cuda.synchronize()
                    e = cs.elementwise_err(torch, got, plain,
                                           *cs.BWD_TOL["bfloat16"])
                    print(f"{name}, {fault} [{label}]: element-wise {e:.3g} "
                          f"of the limit", flush=True)
                    if (fault == "none") == (e > 1):
                        bad.append(f"{name}, {fault} [{label}]")
                    del got
                del plain
            del args
            torch.cuda.empty_cache()
    finally:
        _nvcc.CSRC, _nvcc.BUILD = csrc, build
    return bad


def flash_faults(torch, cs, _nvcc, fa, ref, tmps, csrc, build):
    """The wgmma flash backward's faults (``FLASH``) on phase 2b's cases,
    inputs made as phase 2b makes them ((B, H, S, D) views of (B, S, H, D)
    memory, v and dout zero past v's width, out and lse from the forward
    kernel): the kernels as they are, then each copy with a planted fault
    that runs on the case; returns the (fault, case) readings that went
    the wrong way."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    source = "flash_attention_bwd_sm90.cu"
    src = (csrc / source).read_text()
    copies = {"none": (csrc, None, (0, 1, 2), None)}
    for fault, (line, faulty, outs, only) in FLASH.items():
        tmps.append(planted(csrc, source, src, line, faulty))
        copies[fault] = (tmps[-1], line, outs, only)
    tol = cs.ATTN_TOL["bfloat16"]
    bad = []

    def bhsd(B, S, H, width, D):
        t = torch.randn((B, S, H, width), generator=g, device="cuda").to(
            torch.bfloat16)
        return F.pad(t, (0, D - width)).transpose(1, 2)

    try:
        for label, (B, Hq, Hkv, Sq, Sk, D), kw, width in \
                cs.flash_bwd_cases():
            if label not in (FLASH_WINDOW, FLASH_SHORT, FLASH_MLA,
                             FLASH_RAGGED):
                continue
            q, k = bhsd(B, Sq, Hq, D, D), bhsd(B, Sk, Hkv, D, D)
            v, dout = bhsd(B, Sk, Hkv, width, D), bhsd(B, Sq, Hq, width, D)
            mask = dict(causal=kw["causal"], window=kw.get("window"),
                        sm_scale=kw.get("sm_scale") or D ** -0.5,
                        offset=Sk - Sq)
            out, lse = fa._forward(q, k, v, mask["causal"], mask["window"],
                                   mask["sm_scale"], mask["offset"], True)
            plain = [ref.flash_attention_bwd(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **mask, round_p=r)
                for r in (torch.bfloat16, None)]
            floor = 1e-2 * float(dout.abs().max()) * float(v.abs().max())
            for fault, (where, line, outs, only) in copies.items():
                if only is not None and label not in only:
                    continue
                _nvcc.CSRC = where
                _nvcc.BUILD = build if where is csrc else where / "build"
                fa._BWD_SM90_LIB._lib = None
                routes = dict(fa.flash_attention_bwd.routes)
                got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
                torch.cuda.synchronize()
                if fa.flash_attention_bwd.routes["wgmma"] != \
                        routes["wgmma"] + 1:
                    bad.append(f"flash_attention_bwd, {fault} [{label}]: "
                               f"not on the wgmma route")
                errs = [max(cs.bwd_rel_err(a, p[i], floor) for p in plain)
                        / tol for i, a in enumerate(got)]
                read = ", ".join(f"d{n} {e:.3g}" for n, e in
                                 zip("qkv", errs))
                print(f"flash_attention_bwd, {fault} [{label}]: {read} of "
                      f"the limit", flush=True)
                if (line is None and max(errs) > 1) or (
                        line is not None and min(errs[i] for i in outs) <= 1):
                    bad.append(f"flash_attention_bwd, {fault} [{label}]")
                del got
            del q, k, v, dout, out, lse, plain
            torch.cuda.empty_cache()
    finally:
        _nvcc.CSRC, _nvcc.BUILD = csrc, build
    return bad


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bwd_faults: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _nvcc, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import wkv6 as wk
    print(cs.card_line(), flush=True)
    wrappers = {"rglru_scan_bwd": (rs._LIB, ref.rglru_bwd),
                "wkv6_bwd": (wk._BWD_LIB, ref.wkv6_bwd)}
    all_cases = cs.recurrent_bwd_cases(torch)
    csrc, build = _nvcc.CSRC, _nvcc.BUILD
    bad, tmps = [], []
    try:
        for name, (source, outs, labels, faults) in KERNELS.items():
            lib, plain_fn = wrappers[name]
            cases = [(label, args) for label, args in all_cases[name]
                     if label in labels]
            # the backward as training calls it; the RG-LRU's on the tile
            # states of the forward kernel as it is
            calls = [cs.rglru_bwd_call(torch, args)[0]
                     if name == "rglru_scan_bwd" else
                     (lambda args=args: wk.wkv6_bwd(*args))
                     for _label, args in cases]
            plain = [plain_fn(*(t.float() if t is not None else None
                                for t in args)) for _label, args in cases]
            src = (csrc / source).read_text()
            for fault, (line, faulty, out, *only) in [
                    ("none", (None, None, None)), *faults.items()]:
                _nvcc.CSRC, _nvcc.BUILD = csrc, build
                if line is not None:
                    tmps.append(planted(csrc, source, src, line, faulty))
                    _nvcc.CSRC, _nvcc.BUILD = tmps[-1], tmps[-1] / "build"
                lib._lib = None
                for (label, args), call, exp in zip(cases, calls, plain):
                    if only and label not in only[0]:
                        continue
                    got = call()
                    tol = cs.BWD_TOL[str(args[0].dtype)[6:]]
                    new = [cs.elementwise_err(torch, a, b, *tol)
                           for a, b in zip(got, exp)]
                    read = ", ".join(f"{o} {e:.3g}"
                                     for o, e in zip(outs, new))
                    if name == "rglru_scan_bwd":
                        old = [cs.rel_err(a, b) for a, b in zip(got, exp)]
                        read += "; max-scaled " + ", ".join(
                            f"{o} {e:.3g}" for o, e in zip(outs, old))
                    print(f"{name}, {fault} [{label}]: element-wise {read} "
                          f"of the limit", flush=True)
                    if (out is None and max(new) > 1) or (
                            out is not None and new[out] <= 1):
                        bad.append(f"{name}, {fault} [{label}]")
                    del got
        bad += gmm_faults(torch, cs, _nvcc, mg, ref, tmps, csrc, build)
        bad += flash_faults(torch, cs, _nvcc, fa, ref, tmps, csrc, build)
    finally:
        _nvcc.CSRC, _nvcc.BUILD = csrc, build
        for lib in [lib for lib, _plain in wrappers.values()] + [
                mg._DX_LIB, mg._DW_LIB, fa._BWD_SM90_LIB]:
            lib._lib = None
        for tmp in tmps:
            shutil.rmtree(tmp, ignore_errors=True)
    if bad:
        print(f"chip_bwd_faults FAILED: {bad}", file=sys.stderr)
        return 1
    print("every planted fault fails the comparison; the kernels as they are "
          "pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
