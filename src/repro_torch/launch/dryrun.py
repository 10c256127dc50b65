"""The dry run's configuration helpers, the counterpart of the part of
``repro/launch/dryrun.py`` that is not XLA's: the giant-arch threshold,
the per-arch training defaults and the superblock count that its cost
extrapolation rebuilds a config with.

The rest of the reference's file lowers and compiles each (arch × shape ×
mesh) cell with XLA on 512 fake host devices and reads XLA's memory and
cost analyses; that has no counterpart in the port, which compiles no
graph.  This module sets no ``XLA_FLAGS`` and lowers nothing.

A superblock is one repetition of the layer plan's block: the reference's
``layer_plan`` returns (prefix, block, n, suffix); the port's
:func:`~repro_torch.models.transformer.layer_stacks` lists the block's
positions, each with the n layer indices the reference stacks there, and
every layer in none of them is the prefix or suffix.  Whisper and RWKV6
count each layer as one superblock, as the reference does.
"""
from __future__ import annotations

from ..configs.base import ArchConfig, TrainConfig

#: Above this many parameters (``cfg.param_count()``) an arch is a giant:
#: it trains with Adafactor's factored bf16 moments at ZeRO 3 and serves
#: under fsdp.
GIANT_PARAMS = 100e9


def _superblocks(cfg: ArchConfig):
    """(the block's length, n) of the LM family's layer plan."""
    from ..models.transformer import layer_stacks
    stacks = layer_stacks(cfg)
    if not stacks:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers hold no "
                         f"superblock")
    return len(stacks), len(stacks[0])


def n_super_of(cfg: ArchConfig) -> int:
    """The number of superblocks: the layers of whisper and RWKV6, else n
    of the layer plan."""
    if cfg.family in ("audio", "ssm"):
        return cfg.n_layers
    return _superblocks(cfg)[1]


def cfg_with_n_super(cfg: ArchConfig, n: int) -> ArchConfig:
    """The config rebuilt with ``n`` superblocks, the plan's prefix and
    suffix kept (the reduced builds of the cost-extrapolation pass);
    whisper's encoder cut with its decoder."""
    if cfg.family == "audio":
        return cfg.replace(n_layers=n, n_enc_layers=n)
    if cfg.family == "ssm":
        return cfg.replace(n_layers=n)
    block, n0 = _superblocks(cfg)
    return cfg.replace(n_layers=cfg.n_layers - n0 * block + n * block)


def default_tcfg(cfg: ArchConfig, args) -> TrainConfig:
    """Per-arch training config from the dry run's arguments (``args``:
    ``optimizer``, ``zero_stage``, ``remat``, ``microbatch``, ``fence``,
    ``xent_chunks``, ``act_shard``, ``grad_clip``): a giant gets
    Adafactor where ``optimizer`` is ``"auto"``, ZeRO 3 where stage 2 was
    asked (its parameters must shard over the dp axes to fit) and bf16
    moments."""
    giant = cfg.param_count() > GIANT_PARAMS
    opt = args.optimizer
    if opt == "auto":
        opt = "adafactor" if giant else "adamw"
    zero = args.zero_stage
    if zero == 2 and giant:
        zero = 3
    return TrainConfig(
        optimizer=opt, remat=args.remat, zero_stage=zero,
        microbatch=args.microbatch, fence_scope=args.fence,
        xent_chunks=args.xent_chunks, act_shard=args.act_shard,
        grad_clip=args.grad_clip,
        adam_dtype="bfloat16" if giant else "float32")


__all__ = ["GIANT_PARAMS", "cfg_with_n_super", "default_tcfg",
           "n_super_of"]
