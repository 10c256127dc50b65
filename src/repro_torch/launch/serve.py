"""Serving launcher: continuous batching on the channel substrate, the
counterpart of ``repro/launch/serve.py``.

A SharedQueue admits requests, a KVStore keeps the paged KV cache's page
table, and the model — a dense LM (llama3.2-3b, qwen3-8b, gemma-2b,
internlm2-20b), recurrentgemma, rwkv6, llama4-maverick or deepseek-v3
(``--arch``: any of ``repro_torch.configs.ARCH_IDS``) — runs prefill and
decode with the port's kernels.  Weights are random, drawn on the device
from a seeded generator.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --smoke --device cpu --requests 8 --prompt-len 32 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-maverick-400b-a17b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v3-671b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --smoke --device cpu --replicas 2 --kill-leader-at 1 --revive-at 6 \\
      --backend pallas

``--device`` defaults to the card.  ``--replicas N`` keeps N follower copies
of the page table behind a replicated log; ``--kill-leader-at W`` crashes
the log leader before mutation window W (the failure detector finds it, a
follower is promoted) and ``--revive-at W`` brings it back (snapshot or
replay rejoin).  ``--backend`` picks the channels' execution protocol
(``pallas``: the remote-DMA and remote-copy kernels).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.backends import BACKENDS
from repro_torch.core.kvstore import DELETE, INSERT
from repro_torch.distributed import FaultPlan
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    ap.add_argument("--replicas", type=int, default=0,
                    help="follower page-table replicas behind a "
                         "ReplicatedLog")
    ap.add_argument("--kill-leader-at", type=int, default=None,
                    metavar="WINDOW",
                    help="crash the log leader before mutation window "
                         "WINDOW (needs --replicas >= 1)")
    ap.add_argument("--revive-at", type=int, default=None, metavar="WINDOW",
                    help="revive the killed leader at mutation window "
                         "WINDOW (needs --kill-leader-at)")
    ap.add_argument("--detect-threshold", type=int, default=2,
                    help="missed heartbeat windows before a death verdict")
    ap.add_argument("--backend", default=None, choices=sorted(BACKENDS),
                    help="execution protocol of the engine's channels")
    args = ap.parse_args(argv)

    plan = None
    if args.kill_leader_at is not None:
        plan = FaultPlan(kills={0: args.kill_leader_at},
                         revives=({} if args.revive_at is None
                                  else {0: args.revive_at}))
    elif args.revive_at is not None:
        raise SystemExit("--revive-at requires --kill-leader-at")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(dtype=args.dtype)
    engine = ServingEngine(cfg, max_batch=args.max_batch,
                           max_seq=args.prompt_len + args.gen_len,
                           replicas=args.replicas, fault_plan=plan,
                           detect_threshold=args.detect_threshold,
                           backend=args.backend, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=(args.prompt_len,))
               .astype(np.int32) for _ in range(args.requests)]
    t0 = time.time()
    outs = engine.generate(prompts, gen_len=args.gen_len)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    n_tokens = args.requests * args.gen_len
    print(f"[serve] {args.requests} requests × {args.gen_len} tokens on "
          f"{engine.device} in {dt:.2f}s → {n_tokens / dt:.1f} tok/s")
    print(f"[serve] sample output: {outs[0][:8]}")
    stats = engine.stats()
    rep = stats.pop("replication", None)
    print(f"[serve] page-table (kvstore) stats: {stats}")
    if rep is not None:
        print(f"[serve] replication: {rep}")
        stats["replication"] = rep
    if stats["kv_ops"].get(INSERT, 0) != stats["kv_ops"].get(DELETE, 0):
        raise SystemExit("[serve] every admitted page must be deleted")
    return outs, stats


if __name__ == "__main__":
    main()
