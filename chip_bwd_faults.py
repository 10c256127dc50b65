#!/usr/bin/env python3
"""Planted faults against ``chip_smoke.py``'s phase 2c comparison of the
RG-LRU backward kernel.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_bwd_faults.py

It builds copies of ``src/repro_torch/kernels/csrc/rglru_scan.cu`` in a
temporary directory, each with one fault planted in the backward kernel,
and runs each on phase 2c's training-shape, D = 100 and log_a = 0 cases,
bf16 and float32.  For each copy, case and output it prints the reading
of phase 2c's comparison (``chip_smoke.elementwise_err`` under
``BWD_TOL``: above 1 fails) beside the max-scaled one it replaced (max
|got - plain| over max(1, max |plain|), held to 1e-4 in float32 and 1e-2
in bf16).  The kernel as it is runs first.  Exits non-zero if the kernel
as it is fails the comparison or a planted fault passes it in the output
it changes.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
GATE = "const float q = gate > 0.f ? a * a * xv / gate : 0.f;"
DX = "put(sx[t][c], gate * g);"
# name: (line replaced, its faulty form, the output it changes)
FAULTS = {
    "gate term dropped": (GATE, "const float q = 0.f;", 1),
    "gate term 1% high": (GATE, "const float q = gate > 0.f ? "
                          "1.01f * a * a * xv / gate : 0.f;", 1),
    "gate term 1% high where b > 1/16": (
        GATE, "const float q = gate > 0.f ? (gate > 0.0625f ? 1.01f : 1.f)"
        " * a * a * xv / gate : 0.f;", 1),
    "dx 1% high": (DX, "put(sx[t][c], 1.01f * gate * g);", 0),
}
CASES = ("train shape bfloat16", "train shape float32",
         "S=37 D=100 dh_final bfloat16", "S=37 D=100 dh_final float32",
         "log_a = 0 runs S=600 bfloat16", "log_a = 0 runs S=600 float32")


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
    print(cs.card_line(), flush=True)
    cases = [(label, args) for label, args in
             cs.recurrent_bwd_cases(torch)["rglru_scan_bwd"]
             if label in CASES]
    plain = [ref.rglru_bwd(*(t.float() if t is not None else None
                             for t in args)) for _label, args in cases]
    src = (_nvcc.CSRC / "rglru_scan.cu").read_text()
    csrc, build = _nvcc.CSRC, _nvcc.BUILD
    bad, tmps = [], []
    try:
        for fault, (line, faulty, out) in [("none", (None, None, None)),
                                           *FAULTS.items()]:
            if line is not None:
                assert src.count(line) == 1, line
                tmp = Path(tempfile.mkdtemp())
                tmps.append(tmp)
                (tmp / "rglru_scan.cu").write_text(src.replace(line, faulty))
                _nvcc.CSRC, _nvcc.BUILD = tmp, tmp / "build"
                rs._LIB._lib = None
            for (label, args), exp in zip(cases, plain):
                got = rs.rglru_scan_bwd(*args)
                tol = cs.BWD_TOL[str(args[0].dtype)[6:]]
                new = [cs.elementwise_err(torch, a, b, *tol)
                       for a, b in zip(got, exp)]
                old = [cs.rel_err(a, b) for a, b in zip(got, exp)]
                print(f"{fault} [{label}]: dx, dlog_a element-wise "
                      f"{new[0]:.3g}, {new[1]:.3g} of the limit; max-scaled "
                      f"{old[0]:.3g}, {old[1]:.3g}", flush=True)
                if (out is None and max(new) > 1) or (
                        out is not None and new[out] <= 1):
                    bad.append(f"{fault} [{label}]")
    finally:
        _nvcc.CSRC, _nvcc.BUILD = csrc, build
        rs._LIB._lib = None
        for tmp in tmps:
            shutil.rmtree(tmp, ignore_errors=True)
    if bad:
        print(f"chip_bwd_faults FAILED: {bad}", file=sys.stderr)
        return 1
    print("every planted fault fails the comparison; the kernel as it is "
          "passes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
