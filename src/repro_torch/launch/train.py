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

With ``--mesh DATA,MODEL`` the launcher is one process of a
``torch.distributed`` world that ``torchrun`` describes (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the counterpart of the
reference's ``make_debug_mesh(n_data=n_dev)``: each rank trains its blocks
through ``make_train_step(cfg, tcfg, mesh=ProcessMesh(DATA, MODEL))``
(NCCL on the cards, gloo with ``--device cpu``), ``--zero-stage`` as the
reference's ``TrainConfig``, and checkpoints gather to one writer::

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch llama3.2-3b --mesh 2,1 --steps 10 --batch 2 --seq 4096

Every family trains on the card: the dense one, the hybrid
(recurrentgemma-2b: the RG-LRU's hand-written backward), the ssm
(rwkv6-7b: the WKV's training form and its hand-written backward), the
vlm (llama-3.2-vision-11b) and whisper (whisper-large-v3), both on flash
attention's backward, and the MoE family (llama4-maverick, deepseek-v3)
through the grouped matmul's hand-written backward (``GroupedMatmul``).
Before it allocates anything, :func:`run` reckons what a step must hold on
the card (:func:`memory_reckoning`) and refuses a configuration that does
not fit: the MoE family's published widths, at any depth that holds an
MoE layer (one of llama4's expert leaves is 10.7 GB in bf16), and need a
mesh whose ranks share the experts and the optimizer state; their smoke
configurations train on one card.  A vlm or whisper batch carries the
pipeline's synthesized ``context`` beside its tokens.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig, TrainConfig
from repro_torch.core.runtime import resolve_device
from repro_torch.data import FileTokens, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.model import param_stacks
from repro_torch.optim import make_optimizer
from repro_torch.train import make_train_step
from repro_torch.tree import leaves


def memory_reckoning(cfg: ArchConfig, tcfg: TrainConfig, mesh=None) -> dict:
    """Bytes a training step of ``cfg`` must hold on one device, reckoned
    from the configuration on the meta device: the parameters and their
    gradients in the parameters' dtypes, the optimizer's state in its
    dtypes, and one float32 copy of the largest leaf (the optimizer's
    per-leaf arithmetic runs in float32).  Activations are not counted, so
    the total is a floor.  With ``mesh`` (anything with the mesh's
    ``shape``: a ``StackedMesh`` of the process mesh's sizes will do, a
    (pod, data, model) one too) it is one rank's: its blocks of the
    parameters and gradients (over ``model``, and over the dp axes
    ``("pod", "data")`` at ``zero_stage`` 3) and of the state (ZeRO over
    the dp axes at stage ≥ 2), as the process step lays them out."""
    params = build_model(cfg).init(MetaGenerator())
    stacks = param_stacks(cfg)
    state = make_optimizer(tcfg, stacks).init(params)
    if mesh is None:
        ps, ss = leaves(params), leaves(state)
        sizes = [p.numel() for p in ps]
        st_bytes = sum(t.numel() * t.element_size() for t in ss)
    else:
        from repro_torch.distributed.sharding import local_shape
        from repro_torch.distributed.tensor_parallel import param_layout
        from repro_torch.distributed.zero import ZeroPlan, state_layout
        from repro_torch.tree import tree_map
        layout = param_layout(params, cfg, mesh, tcfg.zero_stage >= 3)
        plan = ZeroPlan(mesh, params, layout, tcfg.zero_stage)
        sizes, st_bytes = [], []
        tree_map(lambda t, sp: sizes.append(
            math.prod(local_shape(t.shape, sp, mesh))), params, layout)
        tree_map(lambda t, sp: st_bytes.append(math.prod(
            local_shape(t.shape, sp, mesh)) * t.element_size()), state,
            state_layout(state, params, plan, stacks))
        ps, st_bytes = leaves(params), sum(st_bytes)
    out = {"params": sum(n * p.element_size() for n, p in zip(sizes, ps)),
           "optimizer_state": st_bytes,
           "largest_leaf_float32": 4 * max(sizes)}
    out["grads"] = out["params"]
    out["total"] = sum(out.values())
    return out


def device_memory(dev) -> int:
    """The card's total memory in bytes."""
    return torch.cuda.get_device_properties(dev).total_memory


def check_fits(cfg: ArchConfig, tcfg: TrainConfig, dev, mesh=None) -> None:
    """Raise ``RuntimeError`` on the card when :func:`memory_reckoning`'s
    floor (one rank's, with ``mesh``) exceeds the card's memory, naming
    the bytes; on the CPU nothing is checked."""
    if dev.type != "cuda":
        return
    need, have = memory_reckoning(cfg, tcfg, mesh), device_memory(dev)
    if need["total"] > have:
        parts = ", ".join(f"{k} {v / 1e9:.1f} GB" for k, v in need.items()
                          if k != "total")
        where = f"a rank of a {mesh.shape} mesh" if mesh is not None \
            else "the card"
        raise RuntimeError(
            f"{cfg.name}: a training step needs at least "
            f"{need['total'] / 1e9:.1f} GB on {where} ({parts}), more than "
            f"its {have / 1e9:.1f} GB; shard it over more ranks (ROADMAP "
            f"item 12: --mesh with a larger model axis, --zero-stage 3), "
            f"or train a smoke config, fewer layers, or with --device cpu")


def run(cfg: ArchConfig, tcfg: TrainConfig, pipe, *, steps: int,
        device=None, ckpt_dir: str = "", ckpt_every: int = 50,
        log_every: int = 10, mesh=None) -> dict:
    """Train ``cfg`` for steps [start, ``steps``) on ``pipe``'s batches,
    where start follows the latest checkpoint in ``ckpt_dir`` (0 without
    one).  Returns the final ``params`` and ``opt_state``, the
    ``train_step``, and each step's ``losses``, ``grad_norms`` and wall
    time ``step_s`` (to the loss's read, which waits for the device).
    With a :class:`~repro_torch.launch.mesh.ProcessMesh` (every rank of its
    world calls it) the rank trains its blocks on its rows of each global
    batch, the losses are the data ranks' mean, the checkpoints gather to
    one writer, and only the rank at coordinate 0 prints."""
    from repro_torch.launch.mesh import StackedMesh
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_fits(cfg, tcfg, dev, None if mesh is None else
               StackedMesh(mesh.sizes, mesh.axis_names))
    lead = mesh is None or not any(mesh.coords.values())
    say = print if lead else (lambda *_a, **_k: None)
    say(f"[train] arch={cfg.name} device={dev}" +
        (f" mesh={mesh.shape}" if mesh is not None else ""))
    shardings = None
    if mesh is None:
        model, opt, train_step = make_train_step(cfg, tcfg, dev)
    else:
        from repro_torch.train.train_step import state_shardings
        model, opt, train_step, _jit = make_train_step(cfg, tcfg,
                                                       mesh=mesh)
        shardings = state_shardings(cfg, tcfg, mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(tcfg.seed))
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in leaves(params))
    say(f"[train] params: {n_params / 1e6:.2f}M" +
        (" on this rank" if mesh is not None else ""))

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        restored = ckpt.restore(ckpt.latest_step(),
                                {"params": params, "opt": opt_state},
                                shardings)
        params, opt_state = restored["params"], restored["opt"]
        start = ckpt.latest_step() + 1
        say(f"[train] resumed from step {start - 1}")

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
            say(f"[train] step {step:5d} loss {loss:8.4f} "
                f"gnorm {out['grad_norms'][-1]:7.3f} "
                f"tok/s {tokens_seen / max(dt, 1e-9):9.0f}")
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state},
                      shardings=shardings)
    if ckpt:
        ckpt.save(steps - 1, {"params": params, "opt": opt_state},
                  blocking=True, shardings=shardings)
    say("[train] done")
    out.update(params=params, opt_state=opt_state, train_step=train_step)
    return out


def mesh_from_env(sizes: str, device: str):
    """Join the world that ``torchrun``'s environment describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; a world of 1 without
    them) and return this rank's ``ProcessMesh`` of ``sizes``
    (``"DATA,MODEL"``): NCCL on the cards, gloo on the CPU."""
    import os

    from repro_torch.launch.mesh import ProcessMesh, init_distributed
    from repro_torch.launch.world import free_port
    dims = tuple(int(x) for x in sizes.split(","))
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT") or str(free_port())
    cpu = device == "cpu"
    init_distributed("gloo" if cpu else "nccl", world, rank,
                     f"tcp://{addr}:{port}", "cpu" if cpu else None)
    return ProcessMesh(*dims)


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
    ap.add_argument("--mesh", default="",
                    help="DATA,MODEL: train as one rank of the torchrun "
                         "world on that process mesh")
    ap.add_argument("--zero-stage", type=int, default=2)
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        ap.error(f"--arch must be one of {list(ARCH_IDS)}")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    tcfg = TrainConfig(lr=args.lr, microbatch=args.microbatch,
                       zero_stage=args.zero_stage)
    mesh = mesh_from_env(args.mesh, args.device) if args.mesh else None
    if args.data_path:
        pipe = FileTokens(cfg, args.data_path, args.batch, args.seq)
    else:
        pipe = SyntheticTokens(cfg, args.batch, args.seq, seed=tcfg.seed)
    out = run(cfg, tcfg, pipe, steps=args.steps, device=args.device,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_every=args.log_every, mesh=mesh)
    if not np.all(np.isfinite(out["losses"])):
        raise SystemExit("[train] a loss is not finite")
    return out


if __name__ == "__main__":
    main()
