#!/usr/bin/env python3
"""Two trees of the repository on one card, in turns: parent, change,
change, parent.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit and, beside this checkout, an unpacked copy of the commit to
compare with (``git archive <commit> | tar -x -C <dir>``):

    python3 chip_compare.py <parent dir> <change dir>

Each turn is one process that imports ``chip_smoke`` and ``repro_torch``
from its tree, builds that tree's kernels, serves llama3.2-3b (512-token
prompts) and recurrentgemma-2b (2304-token prompts) as ``chip_smoke.py``'s
phase 5 does (with its checks and launch counts), and times both attention
kernels at those paths' shapes in bf16: wrapper time (CUDA events around a
loop of calls) and device time per call (``torch.profiler``).  It prints one
``TURN {json}`` line per turn, a table of every number per turn, and last
one JSON object of all turns.  Imports neither JAX nor the JAX package.
Host-bound numbers move up to 2x between calls, so only turns of one run
compare.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

SERVE_KEYS = ("prefill_ms_p50", "decode_step_p50_ms", "decode_step_p99_ms",
              "tokens_per_s")
# (label, B, Hq, Hkv, S, D, window or cache length): chip_smoke's shapes
FLASH = [("flash D128", 4, 24, 8, 512, 128, None),
         ("flash D256", 4, 10, 1, 2304, 256, 2048)]
DECODE = [("decode D128", 4, 24, 8, 544, 128, 528),
          ("decode D256", 4, 10, 1, 2048, 256, 2048)]


def turn(root: str, tag: str) -> dict:
    """One tree's numbers, in this process."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.wkv6 import wkv6
    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"flash_attention": flash_attention,
               "decode_attention": decode_attention,
               "rglru_scan": rglru_scan, "wkv6": wkv6, "gmm": gmm}
    _nvcc.build("remote_dma", "flash_attention", "decode_attention",
                "rglru_scan", "wkv6", "moe_gmm", "remote_copy")
    res = {"tag": tag, "root": root, "card": cs.card_line()}
    for path in (cs.SERVE_PATHS[0], cs.SERVE_PATHS[2]):
        m, launches = cs.phase_serving(torch, kernels, path, rdma)
        res[path["arch"]] = {k: m[k] for k in SERVE_KEYS}
        res[path["arch"]]["attention launches"] = [
            launches["flash_attention"], launches["decode_attention"]]
        gc.collect()
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    def timed(label, fn, iters):
        res[label] = {"ms": cs.cuda_ms(fn, iters),
                      "device_ms": device_ms(torch, fn, iters)}

    for label, B, Hq, Hkv, S, D, window in FLASH:
        q, k, v = rn(B, Hq, S, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
        timed(label, lambda: flash_attention(q, k, v, causal=True,
                                             window=window),
              50 if D == 128 else 10)
    for label, B, Hq, Hkv, S, D, L in DECODE:
        q, k, v = rn(B, Hq, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
        lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
        timed(label, lambda: decode_attention(q, k, v, lens), 200)
    return res


def device_ms(torch, fn, iters):
    """Device time of one call: each kernel's mean duration under
    ``torch.profiler`` times the number of times a call runs it (the same
    measure as ``chip_smoke.device_ms``, kept here so that both trees are
    timed alike)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        return None
    return sum(us / n * max(1, round(n / iters))
               for us, n in by_name.values()) / 1e3


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--turn":
        print("TURN " + json.dumps(turn(argv[2], argv[3])), flush=True)
        return 0
    if len(argv) != 3:
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
                              "--turn", root, tag], capture_output=True,
                             text=True, timeout=1200)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            print(f"chip_compare: the {tag} turn failed", file=sys.stderr)
            return 1
        turns.append(json.loads(lines[-1][5:]))
        print(lines[-1], flush=True)
    rows = [(f"{arch} {k}", arch, k) for arch in ("llama3.2-3b",
                                                  "recurrentgemma-2b")
            for k in SERVE_KEYS]
    rows += [(f"{label} {k}", label, k) for label, *_ in FLASH + DECODE
             for k in ("ms", "device_ms")]
    print(f"{'':44s}" + "".join(f"{t['tag']:>12s}" for t in turns))
    for name, group, key in rows:
        print(f"{name:44s}" + "".join(f"{t[group][key]:12.4f}"
                                      for t in turns))
    print(turns[0]["card"])
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
