"""Serving steps, the counterpart of ``repro/train/serve_step.py``.

``make_serve_steps(cfg, mesh, device, fsdp)`` returns the reference's four
values, ``(model, prefill_step, decode_step, jit_decode)``.  ``fsdp``
None is the reference's default, :func:`default_fsdp`: on for an arch
over 100B parameters (``cfg.param_count()``; llama4-maverick and
deepseek-v3), which cannot hold its weights whole on every dp rank.

With no mesh or a :class:`~repro_torch.launch.mesh.StackedMesh` (one
device holds every shard): an MoE config whose ``router_impl`` is
``"a2a"`` runs its MoE layers expert-parallel over the mesh's stacked
shards (:func:`repro_torch.distributed.moe_ep.make_moe_fn`), as the
reference installs its ``shard_map`` block, and every other layer runs as
without one; ``jit_decode`` binds nothing and returns ``decode_step``.
``fsdp`` changes nothing there: one device holds every shard.

With a :class:`~repro_torch.launch.mesh.ProcessMesh` every rank of the
world runs the steps on its own blocks, the collectives between processes:
the dense layers tensor-parallel and the MoE layers expert-parallel over
``model`` (:mod:`repro_torch.distributed.tensor_parallel`), the batch over
the dp axes where it divides.  ``model.init(generator)`` draws the rank's
parameter blocks and ``model.init_cache(B, s_max)`` its cache blocks of a
global batch of B.  ``prefill_step`` takes the global batch, as the dry
run's ``in_shardings`` place it, and keeps the rank's rows;
``decode_step`` takes the rank's token, cache and pos.  Both return the
rank's rows with the logits over the whole vocabulary.
``jit_decode(params_shape, cache_shape, token_shape)`` — full shapes, meta
tensors will do — binds ``decode_step`` to the shardings, the counterpart
of the reference's ``jax.jit(decode_step, in_shardings=...)``: the step it
returns takes this rank's blocks as the binding lays them out
(``tensor_parallel.param_layout`` / ``cache_layout``: the reference's
specs with heads, not columns, and the cache by heads; the token by the
reference's ``batch_pspecs``; ``tensor_parallel.shard_tree`` cuts the
blocks from full trees), and its first call checks every block's shape
against that layout.

With ``fsdp`` on a process mesh the parameters are laid out by
``param_layout(..., fsdp=True)``: each large leaf also split over the dp
axes ``("pod", "data")``, as the reference's ``param_pspecs(...,
fsdp=True)``.  ``model.init`` draws those blocks; prefill and decode
gather each layer's leaves over the dp axes as the layer runs
(:class:`~repro_torch.distributed.tensor_parallel.FsdpGather`), so one
layer is resident whole at a time, and the leaves outside the layers
once a call — in every family, by the same ``gather``.  The gathered
weights are the whole weights bit for bit, so the logits are those of
``fsdp=False``.  ``jit_decode`` checks the blocks against that layout.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.runtime import resolve_device
from ..data.pipeline import place_batch
from ..launch.dryrun import GIANT_PARAMS
from ..launch.mesh import ProcessMesh
from ..models.model import build_model
from ..tree import leaves, tree_map


def default_fsdp(cfg: ArchConfig) -> bool:
    """The reference's default ``fsdp``: ``cfg.param_count() > 100e9``
    (:data:`repro_torch.launch.dryrun.GIANT_PARAMS`)."""
    return cfg.param_count() > GIANT_PARAMS


def make_serve_steps(cfg: ArchConfig, mesh, device=None, fsdp=None):
    """Returns (model, prefill_step, decode_step, jit_decode) for
    ``device`` (default: the card; a process mesh's own device).

    prefill_step(params, batch, s_max) → (last logits, caches, pos);
    decode_step(params, token, cache, pos[, batch]) → (next token (B, 1)
    int32, the argmax of the logits, logits, cache, pos + 1).  ``fsdp``
    (default :func:`default_fsdp`): on a process mesh, each rank holds its
    dp block of the large leaves and the steps gather each layer's as it
    runs; with no mesh or a stacked one it changes nothing, since one
    device holds every shard."""
    if fsdp is None:
        fsdp = default_fsdp(cfg)
    if isinstance(mesh, ProcessMesh):
        return _process_steps(cfg, mesh, fsdp)
    dev = resolve_device(device)
    moe_fn = None
    if mesh is not None and cfg.moe is not None and \
            cfg.moe.router_impl == "a2a":
        from ..distributed.moe_ep import make_moe_fn
        moe_fn = make_moe_fn(cfg, mesh)
    model = build_model(cfg, moe_fn=moe_fn)

    def prefill_step(params, batch, s_max: int):
        return model.prefill(params, place_batch(batch, dev), s_max)

    def decode_step(params, token, cache, pos, batch=None):
        if batch is not None:
            batch = place_batch(batch, dev)
        logits, cache = model.decode_step(
            params, torch.as_tensor(token).to(dev), cache, pos, batch)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token[:, None], logits, cache, pos + 1

    def jit_decode(params_shape, cache_shape, token_shape):
        return decode_step

    return model, prefill_step, decode_step, jit_decode


def _process_steps(cfg: ArchConfig, mesh: ProcessMesh, fsdp: bool):
    from ..distributed import sharding as SH
    from ..distributed import tensor_parallel as TPL
    from ..models.layers import MetaGenerator
    n_tp = mesh.shape[SH.TP]
    TPL.check_supported(cfg, n_tp)
    dev = mesh.device
    moe_fn = None
    if cfg.moe is not None and cfg.moe.router_impl == "a2a":
        from ..distributed.moe_ep import make_moe_fn
        moe_fn = make_moe_fn(cfg, mesh)
    tp = TPL.TensorParallel(cfg, mesh) if n_tp > 1 else None
    gather = None
    if fsdp and mesh.axis_size(SH.dp_axes(mesh)) > 1:
        full = build_model(cfg).init(MetaGenerator())
        gather = TPL.FsdpGather(mesh, full, TPL.param_layout(
            full, cfg, mesh, fsdp=True))
    model = build_model(cfg, moe_fn=moe_fn, tp=tp, gather=gather)
    full_cache = build_model(cfg).init_cache

    def bind(params):
        if gather is not None:
            gather.bind(params)

    def init(generator: torch.Generator):
        return TPL.init_params(cfg, generator, mesh, fsdp)

    def init_cache(batch_size, s_max, device=None):
        shapes = full_cache(batch_size, s_max, device="meta")
        return TPL.empty_like_layout(shapes, TPL.cache_layout(shapes, cfg,
                                                              mesh),
                                     mesh, dev if device is None else device)

    def rows(batch):
        batch = place_batch(batch, dev)
        return {k: SH.shard(v, spec, mesh).contiguous() for (k, v), spec in
                zip(batch.items(), SH.batch_pspecs(batch, mesh).values())}

    def prefill_step(params, batch, s_max: int):
        bind(params)
        return model.prefill(params, rows(batch), s_max)

    def decode_step(params, token, cache, pos, batch=None):
        if batch is not None:
            batch = rows(batch)
        bind(params)
        logits, cache = model.decode_step(
            params, torch.as_tensor(token).to(dev), cache, pos, batch)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token[:, None], logits, cache, pos + 1

    def jit_decode(params_shape, cache_shape, token_shape):
        want = {"params": (params_shape,
                           TPL.param_layout(params_shape, cfg, mesh, fsdp)),
                "cache": (cache_shape,
                          TPL.cache_layout(cache_shape, cfg, mesh)),
                "token": (token_shape,
                          SH.batch_pspecs({"t": token_shape}, mesh)["t"])}
        checked = []

        def bound(params, token, cache, pos, batch=None):
            if not checked:
                got = {"params": params, "cache": cache,
                       "token": torch.as_tensor(token)}
                for what, (full, layout) in want.items():
                    shapes = []
                    tree_map(lambda f, spec: shapes.append(
                        SH.local_shape(f.shape, spec, mesh)), full, layout)
                    if [tuple(t.shape) for t in leaves(got[what])] != shapes:
                        raise ValueError(
                            f"jit_decode: this rank's {what} blocks are not "
                            f"the layout's {shapes[:4]} ...")
                checked.append(True)
            return decode_step(params, token, cache, pos, batch)

        return bound

    model = model._replace(init=init, init_cache=init_cache)
    return model, prefill_step, decode_step, jit_decode
