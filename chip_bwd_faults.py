#!/usr/bin/env python3
"""Planted faults against ``chip_smoke.py``'s phase 2c comparison of the
recurrences' backward kernels, RG-LRU and WKV6.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_bwd_faults.py

It builds copies of ``src/repro_torch/kernels/csrc/rglru_scan.cu`` and of
``wkv6_bwd.cu`` in temporary directories, each with one fault planted in
a backward kernel, and runs each on phase 2c's cases of that kernel: the
RG-LRU's training-shape, D = 100 and log_a = 0 cases, bf16 and float32,
each on the tile states the kernel as it is kept in its forward (the
faults that cross tiles only on the cases of more than one tile); the
WKV's training-shape and w = 0 cases.  For each copy, case and
output it prints the reading of phase 2c's comparison
(``chip_smoke.elementwise_err`` under ``BWD_TOL``: above 1 fails), for
the RG-LRU beside the max-scaled one it replaced (max |got - plain| over
max(1, max |plain|), held to 1e-4 in float32 and 1e-2 in bf16).  Each
kernel as it is runs first.  Exits non-zero if a kernel as it is fails
the comparison or a planted fault passes it in the output it changes.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bwd_faults: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _nvcc, ref
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
                    assert src.count(line) == 1, line
                    tmp = Path(tempfile.mkdtemp())
                    tmps.append(tmp)
                    (tmp / source).write_text(src.replace(line, faulty))
                    _nvcc.CSRC, _nvcc.BUILD = tmp, tmp / "build"
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
    finally:
        _nvcc.CSRC, _nvcc.BUILD = csrc, build
        for lib, _plain in wrappers.values():
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
