"""Model factory, the counterpart of ``repro/models/model.py``'s
``build_model`` / ``_build_lm`` / ``_build_rwkv``.

``build_model(cfg)`` returns a :class:`Model` of functions:

  init(generator)                      → params (on the generator's device)
  logits(params, batch)                → (B, S, vocab)
  prefill(params, batch, s_max)        → (last_logits, caches, pos)
  decode_step(params, token, caches, pos[, batch]) → (logits, caches)
  init_cache(batch_size, s_max, device=None) → caches

``batch`` is a dict ``{"tokens": (B, S) int}``; ``caches`` is one entry per
layer.  The LM family covers the dense models, the hybrid one
(recurrentgemma) and the MoE family with GQA attention (llama4-maverick)
or MLA (deepseek-v3; as in the reference, a ``family="moe"`` config
without ``moe`` gets the dense plan); rwkv6 (family ``ssm``) has its own
stack.  A config with ``mtp_depth`` (deepseek-v3) also draws the
reference's multi-token-prediction subtree ``mtp`` (``proj``, ``norm_h``,
``norm_e`` and one ``mla_dense`` block), so the two parameter trees line
up leaf for leaf; nothing on the serving path reads it.  ``train_loss``,
the MTP term in it included, waits for the training slice (ROADMAP Queue
A item 10); the vlm and audio families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ArchConfig
from ..core.runtime import resolve_device
from . import rwkv6 as W
from . import transformer as T
from .layers import (dense_init, embed, init_embedding, init_layernorm,
                     init_rmsnorm, layernorm, rmsnorm, unembed)


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    logits: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "hybrid", "moe"):
        return _build_lm(cfg)
    if cfg.family == "ssm":
        return _build_rwkv(cfg)
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported; the port builds "
        f"the dense, hybrid, ssm and moe families (the others are ROADMAP "
        f"Queue A item 11)")


def _tokens(params, batch):
    return torch.as_tensor(batch["tokens"]).to(
        params["embed"]["table"].device).long()


def _last_pos(tokens):
    return torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                      device=tokens.device)


# ---------------------------------------------------------------- LM family
def _build_lm(cfg: ArchConfig) -> Model:
    # the reference multiplies by sqrt(d) cast to the model dtype first (in
    # bf16, 50.5 for d = 2560); the product of two such values is exact in
    # float32, so one rounding to the model dtype gives the reference's bits
    embed_scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype_)) \
        if cfg.scale_embed else None

    def init(generator: torch.Generator):
        """Random weights, drawn from ``generator`` on its device, with the
        ``mtp`` subtree where the config has ``mtp_depth``."""
        p = {"embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                     cfg.dtype_, cfg.tie_embeddings),
             "layers": T.init_stack(generator, cfg),
             "final_norm": init_rmsnorm(cfg.d_model, generator.device)}
        if cfg.mtp_depth:
            dev = generator.device
            p["mtp"] = {
                "proj": dense_init(generator, 2 * cfg.d_model, cfg.d_model,
                                   cfg.dtype_),
                "norm_h": init_rmsnorm(cfg.d_model, dev),
                "norm_e": init_rmsnorm(cfg.d_model, dev),
                "block": T.init_block(generator, cfg, "mla_dense"
                                      if cfg.mla is not None else "attn")}
        return p

    def _embed_in(params, tokens):
        x = embed(params["embed"], tokens)
        return x * embed_scale if embed_scale is not None else x

    def logits(params, batch):
        x = _embed_in(params, _tokens(params, batch))
        for kind, p in zip(T.layer_kinds(cfg), params["layers"]):
            x, _cache = T.apply_block_train(p, cfg, kind, x)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], h, cfg.tie_embeddings)

    def init_cache(batch_size, s_max, device=None):
        return T.init_stack_cache(cfg, batch_size, s_max,
                                  resolve_device(device))

    def prefill(params, batch, s_max):
        tokens = _tokens(params, batch)
        x = _embed_in(params, tokens)
        x, caches = T.fill_stack_cache(params["layers"], cfg, x, s_max)
        h = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        lg = unembed(params["embed"], h, cfg.tie_embeddings)[:, 0]
        return lg, caches, _last_pos(tokens)

    def decode_step(params, token, caches, pos, batch=None):
        x = _embed_in(params, _tokens(params, {"tokens": token}))
        x, caches = T.apply_stack_decode(params["layers"], cfg, x, caches,
                                         pos)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        lg = unembed(params["embed"], h, cfg.tie_embeddings)[:, 0]
        return lg, caches

    return Model(cfg, init, logits, prefill, decode_step, init_cache)


# --------------------------------------------------------------------- rwkv6
def _build_rwkv(cfg: ArchConfig) -> Model:
    def init(generator: torch.Generator):
        """Random weights, drawn from ``generator`` on its device: an untied
        embedding and head, ``ln0`` before the first block."""
        return {"embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                        cfg.dtype_, False),
                "ln0": init_layernorm(cfg.d_model, generator.device),
                "layers": W.init_rwkv_stack(generator, cfg),
                "final_norm": init_rmsnorm(cfg.d_model, generator.device)}

    def _hidden(params, tokens, states=None):
        x = layernorm(params["ln0"], embed(params["embed"], tokens),
                      cfg.norm_eps)
        return W.apply_rwkv_stack(params["layers"], cfg, x, states)

    def logits(params, batch):
        x, _states = _hidden(params, _tokens(params, batch))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, False)

    def init_cache(batch_size, s_max, device=None):
        return W.init_rwkv_caches(cfg, batch_size, resolve_device(device))

    def prefill(params, batch, s_max):
        tokens = _tokens(params, batch)
        x, states = _hidden(params, tokens)
        x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return unembed(params["embed"], x, False)[:, 0], states, \
            _last_pos(tokens)

    def decode_step(params, token, states, pos, batch=None):
        x, states = _hidden(params, _tokens(params, {"tokens": token}),
                            states)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, False)[:, 0], states

    return Model(cfg, init, logits, prefill, decode_step, init_cache)
