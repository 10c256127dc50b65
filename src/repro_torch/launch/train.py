"""Training launcher, the counterpart of ``repro/launch/train.py``: real
steps of the port's training path (``train_loss`` through the training
stack, flash attention's forward and hand-written backward on the card,
AdamW or Adafactor), the deterministic resumable pipeline and atomic async
checkpoints, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --device cpu --steps 100 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 20 --batch 2 --seq 4096

``--device`` defaults to the card.  The weights are random, drawn on the
device from a generator seeded with ``TrainConfig.seed``; a run with
``--ckpt-dir`` resumes from its latest checkpoint and saves at the end.
The card trains the dense family (llama3.2-3b, qwen3-8b, gemma-2b,
internlm2-20b); the other families' kernels have no backward ported yet
and refuse training there, so they train with ``--device cpu``.  A vlm
or whisper batch carries the pipeline's synthesized ``context`` beside its
tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig, TrainConfig
from repro_torch.core.runtime import resolve_device
from repro_torch.data import FileTokens, SyntheticTokens
from repro_torch.train import make_train_step
from repro_torch.tree import leaves


def run(cfg: ArchConfig, tcfg: TrainConfig, pipe, *, steps: int,
        device=None, ckpt_dir: str = "", ckpt_every: int = 50,
        log_every: int = 10) -> dict:
    """Train ``cfg`` for steps [start, ``steps``) on ``pipe``'s batches,
    where start follows the latest checkpoint in ``ckpt_dir`` (0 without
    one).  Returns the final ``params`` and ``opt_state``, the
    ``train_step``, and each step's ``losses``, ``grad_norms`` and wall
    time ``step_s`` (to the loss's read, which waits for the device)."""
    dev = resolve_device(device)
    print(f"[train] arch={cfg.name} device={dev}")
    model, opt, train_step = make_train_step(cfg, tcfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(tcfg.seed))
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] params: {n_params / 1e6:.2f}M")

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        restored = ckpt.restore(ckpt.latest_step(),
                                {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start = ckpt.latest_step() + 1
        print(f"[train] resumed from step {start - 1}")

    out = {"n_params": n_params, "start": start, "losses": [],
           "grad_norms": [], "step_s": []}
    t0 = time.time()
    tokens_seen = 0
    for step in range(start, steps):
        batch = pipe.get_batch(step)
        t_step = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        out["step_s"].append(time.perf_counter() - t_step)
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        tokens_seen += pipe.batch * pipe.seq
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {out['grad_norms'][-1]:7.3f} "
                  f"tok/s {tokens_seen / max(dt, 1e-9):9.0f}")
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.save(steps - 1, {"params": params, "opt": opt_state},
                  blocking=True)
    print("[train] done")
    out.update(params=params, opt_state=opt_state, train_step=train_step)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-path", default="",
                    help="binary int32 token file (synthetic if empty)")
    ap.add_argument("--dtype", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        ap.error(f"--arch must be one of {list(ARCH_IDS)}")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    tcfg = TrainConfig(lr=args.lr, microbatch=args.microbatch)
    if args.data_path:
        pipe = FileTokens(cfg, args.data_path, args.batch, args.seq)
    else:
        pipe = SyntheticTokens(cfg, args.batch, args.seq, seed=tcfg.seed)
    out = run(cfg, tcfg, pipe, steps=args.steps, device=args.device,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_every=args.log_every)
    if not np.all(np.isfinite(out["losses"])):
        raise SystemExit("[train] a loss is not finite")
    return out


if __name__ == "__main__":
    main()
