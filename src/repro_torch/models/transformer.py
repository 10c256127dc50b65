"""Decoder-only transformer stack, the counterpart of the dense plan of
``repro/models/transformer.py`` (``[attn] × L``).

The reference scans stacked ``(n, …)`` parameters with ``layer_scan``; the
port keeps one parameter dict per layer in a list and loops over it in
Python.  Other layer plans (MoE, MLA, hybrid, cross-attention) wait for their
families (ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import List

import torch

from ..configs.base import ArchConfig
from . import attention as A
from .layers import init_mlp, init_rmsnorm, mlp, rmsnorm


def init_block(gen, cfg: ArchConfig):
    return {"ln1": init_rmsnorm(cfg.d_model, gen.device),
            "ln2": init_rmsnorm(cfg.d_model, gen.device),
            "attn": A.init_attention(gen, cfg),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype_)}


def apply_block_train(params, cfg: ArchConfig, x, positions=None):
    """x (B, S, d) → (x', KVCache).  Where the reference returns an auxiliary
    loss (zero for a dense block), the port returns the block's rotated k/v,
    which prefill stores as the decode cache."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a_out, kv = A.attention(params["attn"], cfg, h, positions=positions)
    x = x + a_out
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h), kv


def apply_block_decode(params, cfg: ArchConfig, x, cache: A.KVCache, pos):
    """x (B, 1, d), pos (B,) → (x', cache), the cache updated in place."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a_out, cache = A.attention_decode(params["attn"], cfg, h, cache, pos)
    x = x + a_out
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h), cache


def init_stack(gen, cfg: ArchConfig) -> List[dict]:
    return [init_block(gen, cfg) for _ in range(cfg.n_layers)]


def init_stack_cache(cfg: ArchConfig, batch: int, s_max: int,
                     device) -> List[A.KVCache]:
    shape = (batch, cfg.n_kv_heads, s_max, cfg.head_dim_)
    return [A.KVCache(torch.zeros(shape, dtype=cfg.dtype_, device=device),
                      torch.zeros(shape, dtype=cfg.dtype_, device=device))
            for _ in range(cfg.n_layers)]


def apply_stack_decode(params, cfg: ArchConfig, x, caches, pos):
    new = []
    for p, c in zip(params, caches):
        x, c = apply_block_decode(p, cfg, x, c, pos)
        new.append(c)
    return x, new


def fill_stack_cache(params, cfg: ArchConfig, x, s_max: int,
                     positions=None):
    """Prefill: run the stack over the prompt, returning the final hidden
    states and every layer's cache padded to ``s_max``."""
    caches = []
    for p in params:
        x, kv = apply_block_train(p, cfg, x, positions)
        caches.append(_block_prefill_cache(kv, s_max))
    return x, caches


def _block_prefill_cache(kv: A.KVCache, s_max: int) -> A.KVCache:
    """The decode cache from the prompt's k/v, zero-padded to ``s_max``: the
    reference recomputes k/v from the block input, the port reuses the
    attention's own (the same values)."""
    B, H, S, D = kv.k.shape
    if S > s_max:
        raise ValueError(f"a {S}-token prompt does not fit a {s_max}-slot "
                         f"cache")
    out = []
    for t in kv:
        c = torch.zeros((B, H, s_max, D), dtype=t.dtype, device=t.device)
        c[:, :, :S] = t
        out.append(c)
    return A.KVCache(*out)
