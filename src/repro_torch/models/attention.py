"""GQA/MQA attention blocks with sliding windows, the counterpart of the GQA
part of ``repro/models/attention.py`` (MLA and cross-attention wait for the
families that use them).

The inner attention is always the port's kernel wrapper: on a CUDA tensor
:func:`~repro_torch.kernels.flash_attention.flash_attention` (prefill) and
:func:`~repro_torch.kernels.decode_attention.decode_attention` (decode)
launch the hand-written kernels; on a CPU tensor they run the kernels' plain
versions.  The reference's ``impl``/``decode_impl`` knobs have no
counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from .layers import apply_rope, dense_init, init_rmsnorm, rmsnorm


def init_attention(gen, cfg: ArchConfig):
    d, hd, dt = cfg.d_model, cfg.head_dim_, cfg.dtype_
    p = {"wq": dense_init(gen, d, cfg.n_heads * hd, dt),
         "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
         "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
         "wo": dense_init(gen, cfg.n_heads * hd, d, dt)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, gen.device)
        p["k_norm"] = init_rmsnorm(hd, gen.device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, Hkv, S, D)
    v: torch.Tensor    # (B, Hkv, S, D)


def _project_qkv(params, cfg: ArchConfig, x):
    """x (B, S, d) → q (B, S, Hq, hd), k and v (B, S, Hkv, hd)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def attention(params, cfg: ArchConfig, x, *, positions=None, window=None):
    """Full-sequence (prefill) causal self-attention, over the last
    ``window`` keys when one is given.  x (B, S, d) → (out (B, S, d), KVCache
    of this call's rotated k and v in (B, Hkv, S, hd) layout — strided views
    of the projections, not copies)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    pos = positions if positions is not None \
        else torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=True, window=window)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ params["wo"], KVCache(kh, vh)


def attention_decode(params, cfg: ArchConfig, x, cache: KVCache, pos, *,
                     window=None):
    """One-token decode.  x (B, 1, d); ``cache`` holds S_max slots; ``pos``
    (B,) — each sequence's current length, the new token's index.

    The new k/v are written **in place** at slot ``pos[b]``, where the
    reference rewrites the whole cache with a masked ``where``; a ``pos``
    past the cache writes nothing, as there.  With a ``window`` the cache is
    a ring buffer (recurrentgemma's local attention): position p lives at
    slot ``p % S_max``.  The query sees ``min(pos + 1, S_max)`` slots.
    Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0]     # (B, Hq, hd)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]     # (B, Hkv, hd)
    v = v[:, 0]
    S_max = cache.k.shape[2]
    slot = pos % S_max if window is not None else pos
    in_range = (slot < S_max)[:, None, None]
    slot = slot.clamp(0, S_max - 1).long()
    rows = torch.arange(B, device=x.device)
    for buf, new in ((cache.k, k), (cache.v, v)):
        buf[rows, :, slot] = torch.where(in_range, new.to(buf.dtype),
                                         buf[rows, :, slot])
    lengths = torch.clamp(pos + 1, max=S_max)
    out = decode_attention(q, cache.k, cache.v, lengths)
    return out.reshape(B, 1, -1) @ params["wo"], cache
