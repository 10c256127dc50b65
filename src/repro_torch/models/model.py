"""Model factory, the counterpart of ``repro/models/model.py``'s
``build_model`` / ``_build_lm`` for the dense LM family.

``build_model(cfg)`` returns a :class:`Model` of functions:

  init(generator)                      → params (on the generator's device)
  logits(params, batch)                → (B, S, vocab)
  prefill(params, batch, s_max)        → (last_logits, caches, pos)
  decode_step(params, token, caches, pos[, batch]) → (logits, caches)
  init_cache(batch_size, s_max, device=None) → caches

``batch`` is a dict ``{"tokens": (B, S) int}``.  ``train_loss`` waits for the
training slice; the other families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ArchConfig
from ..core.runtime import resolve_device
from . import transformer as T
from .layers import embed, init_embedding, init_rmsnorm, rmsnorm, unembed


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    logits: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; the port "
            f"builds dense models only (the other families are ROADMAP "
            f"Queue A item 11)")
    return _build_lm(cfg)


def _build_lm(cfg: ArchConfig) -> Model:
    def init(generator: torch.Generator):
        """Random weights, drawn from ``generator`` on its device."""
        return {"embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                        cfg.dtype_, cfg.tie_embeddings),
                "layers": T.init_stack(generator, cfg),
                "final_norm": init_rmsnorm(cfg.d_model, generator.device)}

    def _tokens(params, batch):
        return torch.as_tensor(batch["tokens"]).to(
            params["embed"]["table"].device).long()

    def logits(params, batch):
        tokens = _tokens(params, batch)
        x = embed(params["embed"], tokens)
        for p in params["layers"]:
            x, _kv = T.apply_block_train(p, cfg, x)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], h, cfg.tie_embeddings)

    def init_cache(batch_size, s_max, device=None):
        return T.init_stack_cache(cfg, batch_size, s_max,
                                  resolve_device(device))

    def prefill(params, batch, s_max):
        tokens = _tokens(params, batch)
        x = embed(params["embed"], tokens)
        x, caches = T.fill_stack_cache(params["layers"], cfg, x, s_max)
        h = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        lg = unembed(params["embed"], h, cfg.tie_embeddings)[:, 0]
        pos = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=tokens.device)
        return lg, caches, pos

    def decode_step(params, token, caches, pos, batch=None):
        x = embed(params["embed"], _tokens(params, {"tokens": token}))
        x, caches = T.apply_stack_decode(params["layers"], cfg, x, caches,
                                         pos)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        lg = unembed(params["embed"], h, cfg.tie_embeddings)[:, 0]
        return lg, caches

    return Model(cfg, init, logits, prefill, decode_step, init_cache)
