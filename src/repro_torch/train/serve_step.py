"""Serving steps, the counterpart of ``repro/train/serve_step.py`` on the
stacked binding.

``make_serve_steps(cfg, mesh, device)`` returns ``(model, prefill_step,
decode_step)``.  With a mesh, an MoE config whose ``router_impl`` is
``"a2a"`` runs its MoE layers expert-parallel over the mesh's shards
(:func:`repro_torch.distributed.moe_ep.make_moe_fn`), as the reference
installs its ``shard_map`` block; every other layer, and every other
config, runs as without one.  The reference's fourth return value,
``jit_decode``, binds the steps to parameter and cache shardings over
devices; it comes with the port's ``torch.distributed`` binding (ROADMAP
item 12).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.runtime import resolve_device
from ..data.pipeline import place_batch
from ..models.model import build_model


def make_serve_steps(cfg: ArchConfig, mesh, device=None):
    """Returns (model, prefill_step, decode_step) for ``device`` (default:
    the card).

    prefill_step(params, batch, s_max) → (last logits, caches, pos);
    decode_step(params, token, cache, pos[, batch]) → (next token (B, 1)
    int32, the argmax of the logits, logits, cache, pos + 1)."""
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

    return model, prefill_step, decode_step
