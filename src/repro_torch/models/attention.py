"""GQA/MQA attention blocks with sliding windows, cross-attention and
DeepSeek's MLA, the counterpart of ``repro/models/attention.py``.

The inner attention is always the port's kernel wrapper: on a CUDA tensor
:func:`~repro_torch.kernels.flash_attention.flash_attention` (prefill) and
:func:`~repro_torch.kernels.decode_attention.decode_attention` (decode)
launch the hand-written kernels; on a CPU tensor they run the kernels' plain
versions.  The reference's ``impl``/``decode_impl`` knobs have no
counterpart.

Cross-attention (the vlm's gated cross layers, whisper's decoder) projects
q from the layer's input and k, v from a context ``kv_x`` of its own length
(the stubbed frontend's output, or whisper's encoder output): a
non-causal flash call with Sq ≠ Sk, no RoPE.  Its decode attends a cache
that prefill filled from the context once and that stays as it is, every
sequence seeing all ``n_ctx`` slots.

MLA prefill runs the expanded form: q and k of ``qk_nope + qk_rope`` (192 at
full width) and v of ``v_head_dim`` (128) per head.  The flash kernel takes
one head dimension for q, k and v, so v is zero-padded to q's width and the
output sliced back; zero columns of V give zero columns of the output, so
the result is exact.  MLA decode runs the matrix-absorbed form against the
compressed cache (``ckv ‖ krope``, 512 + 64 = 576 wide): every query head
attends the one latent "kv head", a query-head group of ``n_heads`` (128).

Training: where grad is enabled and q, k or v requires grad, the prefill
attention goes through
:class:`~repro_torch.kernels.flash_attention.FlashAttention` (the same
forward kernels, and the hand-written backward); otherwise, as in serving,
through ``flash_attention``.  MLA's zero-padded v columns get zero
gradient, which the pad's backward drops.

Tensor parallelism (the process binding's ``tp``): a rank holds whole
query heads — ``wq``'s columns and ``wo``'s rows of its heads — and the kv
heads they read (``wk``/``wv``'s columns; :mod:`repro_torch.distributed.
tensor_parallel`), so q, k, v and the cache carry the rank's heads, the
kernels run on them unchanged, and ``tp.psum`` adds the ranks' partial
``wo`` products; in training the projections' input goes through
``tp.copy``, which sums its gradient over the ranks.  Head counts are
read from the weights, not the config.  Cross attention (whisper's
decoder, the vision model's cross layers) takes the rank's heads of the
whole context the same way.  MLA's rank holds its heads of ``wq_b``,
``wkv_b`` and ``wo``; the latents (``wq_a``, ``wkv_a`` and both norms)
are whole on every rank, and so is its compressed cache, which every
head reads: prefill's flash and decode's absorbed call run on the rank's
heads over it, and ``tp.psum`` adds the ``wo`` products.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import FlashAttention, flash_attention
from .layers import apply_rope, dense_init, init_rmsnorm, rmsnorm


def init_attention(gen, cfg: ArchConfig):
    """q, k, v and o projections (+ qk-norm scales); a cross-attention
    layer has the same leaves."""
    d, hd, dt = cfg.d_model, cfg.head_dim_, cfg.dtype_
    p = {"wq": dense_init(gen, d, cfg.n_heads * hd, dt),
         "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
         "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
         "wo": dense_init(gen, cfg.n_heads * hd, d, dt)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, gen.device)
        p["k_norm"] = init_rmsnorm(hd, gen.device)
    return p


def _flash(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Full-sequence attention: :class:`FlashAttention` when autograd needs
    its gradient, else the serving call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, sm_scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           sm_scale=sm_scale)


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, Hkv, S, D)
    v: torch.Tensor    # (B, Hkv, S, D)


def _project_qkv(params, cfg: ArchConfig, x, kv_x=None, tp=None):
    """x (B, S, d) → q (B, S, Hq, hd); k and v (B, Skv, Hkv, hd) from
    ``kv_x`` (B, Skv, d), x itself by default.  With ``tp`` the qk-norm
    scales, replicated over ``model`` but each rank normalising its own
    heads, enter through ``tp.copy``: their gradient is summed over the
    ranks."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    if kv_x is None:
        kv_x = x
    elif tp is not None:
        kv_x = tp.copy(kv_x)
    q = (x @ params["wq"]).reshape(B, S, -1, hd)
    k = (kv_x @ params["wk"]).reshape(B, kv_x.shape[1], -1, hd)
    v = (kv_x @ params["wv"]).reshape(B, kv_x.shape[1], -1, hd)
    if cfg.qk_norm:
        qn, kn = params["q_norm"], params["k_norm"]
        if tp is not None:
            qn, kn = ({"scale": tp.copy(n["scale"])} for n in (qn, kn))
        q = rmsnorm(qn, q, cfg.norm_eps)
        k = rmsnorm(kn, k, cfg.norm_eps)
    return q, k, v


def attention(params, cfg: ArchConfig, x, *, positions=None, causal=True,
              window=None, kv_x=None, use_rope=True, tp=None):
    """Full-sequence (prefill, training, encoder) attention: causal unless
    ``causal`` is False, over the last ``window`` keys when one is given,
    RoPE on q and k where ``use_rope``.  With a context ``kv_x`` (B, Sctx,
    d) it is cross-attention: k and v come from the context, and it is
    neither causal nor rotated.  x (B, S, d) → (out (B, S, d), KVCache of
    this call's k and v in (B, Hkv, Skv, hd) layout — strided views of the
    projections, not copies)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x if tp is None else tp.copy(x),
                           kv_x, tp)
    if use_rope and kv_x is None:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    out = _flash(qh, kh, vh, causal=causal and kv_x is None, window=window)
    out = out.transpose(1, 2).reshape(B, S, -1) @ params["wo"]
    return (out if tp is None else tp.psum(out)), KVCache(kh, vh)


def attention_decode(params, cfg: ArchConfig, x, cache: KVCache, pos, *,
                     window=None, use_rope=True, tp=None):
    """One-token decode.  x (B, 1, d); ``cache`` holds S_max slots; ``pos``
    (B,) — each sequence's current length, the new token's index.

    The new k/v are written **in place** at slot ``pos[b]``, where the
    reference rewrites the whole cache with a masked ``where``; a ``pos``
    past the cache writes nothing, as there.  With a ``window`` the cache is
    a ring buffer (recurrentgemma's local attention): position p lives at
    slot ``p % S_max``.  The query sees ``min(pos + 1, S_max)`` slots.
    ``use_rope`` rotates q and k at ``pos``.  Returns (out (B, 1, d),
    cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]          # (B, Hq | Hkv, hd)
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
    out = out.reshape(B, 1, -1) @ params["wo"]
    return (out if tp is None else tp.psum(out)), cache


def context_lengths(cache: KVCache):
    """(B,) int32 of the context cache's slot count: every sequence sees
    all of it.  Built once a decode step and shared by its cross layers."""
    return torch.full((cache.k.shape[0],), cache.k.shape[2],
                      dtype=torch.int32, device=cache.k.device)


def cross_attention_decode(params, cfg: ArchConfig, x, cache: KVCache,
                           lengths, tp=None):
    """One-token cross-attention over a context cache that prefill filled:
    only q is projected (the reference projects the token's k and v too,
    and drops them), no RoPE, nothing is written.  ``lengths`` is
    :func:`context_lengths` of the cache.  x (B, 1, d) → out (B, 1, d);
    with ``tp`` the rank's heads, summed over ``model``."""
    B = x.shape[0]
    q = (x @ params["wq"]).reshape(B, 1, -1, cfg.head_dim_)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    out = decode_attention(q[:, 0], cache.k, cache.v, lengths)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out if tp is None else tp.psum(out)


# ------------------------------------------------------------------ MLA block
def init_mla(gen, cfg: ArchConfig):
    m, d, H, dt = cfg.mla, cfg.d_model, cfg.n_heads, cfg.dtype_
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, dt),
        "q_a_norm": init_rmsnorm(m.q_lora_rank, gen.device),
        "wq_b": dense_init(gen, m.q_lora_rank, H * qk, dt),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dt),
        "kv_a_norm": init_rmsnorm(m.kv_lora_rank, gen.device),
        "wkv_b": dense_init(gen, m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim), dt),
        "wo": dense_init(gen, H * m.v_head_dim, d, dt),
    }


class MLACache(NamedTuple):
    ckv: torch.Tensor      # (B, S, kv_lora_rank)  compressed latents
    krope: torch.Tensor    # (B, S, qk_rope_head_dim)


def _mla_scale(m) -> float:
    """The reference's softmax scale on both paths: 1/sqrt(qk_nope +
    qk_rope), also where decode attends the wider latent keys."""
    return 1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5


def _mla_query(params, cfg: ArchConfig, x):
    """x (B, S, d) → q (B, S, H, qk_nope + qk_rope), before RoPE; H is
    ``wq_b``'s heads."""
    m = cfg.mla
    B, S, _ = x.shape
    q_a = rmsnorm(params["q_a_norm"], x @ params["wq_a"], cfg.norm_eps)
    return (q_a @ params["wq_b"]).reshape(
        B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)


def _mla_latents(params, cfg: ArchConfig, x, positions):
    """x (B, S, d) → the compressed cache rows: ckv (B, S, kv_lora_rank),
    normed, and krope (B, S, qk_rope), rotated."""
    R = cfg.mla.kv_lora_rank
    kv_a = x @ params["wkv_a"]
    ckv = rmsnorm(params["kv_a_norm"], kv_a[..., :R], cfg.norm_eps)
    krope = apply_rope(kv_a[:, :, None, R:], positions, cfg.rope_theta)
    return ckv, krope[:, :, 0]


def _mla_qkv(params, cfg: ArchConfig, x, positions):
    """Expanded (non-absorbed) q, k, v for prefill.  x (B, S, d) → q, k (B,
    S, H, qk_nope + qk_rope), v (B, S, H, v_head_dim), and the cache rows
    ckv (B, S, kv_lora_rank) and krope (B, S, qk_rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    nope = m.qk_nope_head_dim
    q = _mla_query(params, cfg, x)
    H = q.shape[2]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv, krope = _mla_latents(params, cfg, x, positions)
    kv = (ckv @ params["wkv_b"]).reshape(B, S, H, nope + m.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   krope[:, :, None].expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q[..., :nope], q_rope], dim=-1)
    return q, k, kv[..., nope:], ckv, krope


def mla_attention(params, cfg: ArchConfig, x, *, positions=None, tp=None):
    """Prefill MLA (expanded form), causal.  x (B, S, d) → (out (B, S, d),
    MLACache of this call's ckv and krope).  v is zero-padded to q's width
    for the flash kernel and the output sliced back to ``v_head_dim``.
    With ``tp`` the rank's heads, summed over ``model``."""
    B, S, _ = x.shape
    m = cfg.mla
    if tp is not None:
        x = tp.copy(x)
    pos = positions if positions is not None \
        else torch.arange(S, device=x.device)[None, :]
    q, k, v, ckv, krope = _mla_qkv(params, cfg, x, pos)
    v = F.pad(v, (0, q.shape[-1] - m.v_head_dim))
    out = _flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=True, sm_scale=_mla_scale(m))[..., :m.v_head_dim]
    out = out.transpose(1, 2).reshape(B, S, -1) @ params["wo"]
    return (out if tp is None else tp.psum(out)), MLACache(ckv, krope)


def mla_decode(params, cfg: ArchConfig, x, cache: MLACache, pos, tp=None):
    """Matrix-absorbed MLA decode against the compressed cache.  x (B, 1,
    d); ``pos`` (B,) — the new token's index.  Per head h the score is
    ``q_nope_h · W_UK_h c_t + q_rope_h · k_rope_t``, so the query absorbs
    W_UK into a (kv_lora_rank + qk_rope)-wide row and the cache stays (c_kv
    ‖ k_rope).  The new row is written with the reference's masked
    ``where`` (a new cache; a ``pos`` past the cache writes nothing), then
    every query head attends the one latent kv head through the decode
    kernel with keys ``ckv ‖ krope`` (with ``tp`` the rank's heads, whose
    outputs ``tp.psum`` adds).  The reference's values are ``ckv``
    zero-padded by qk_rope columns; the keys serve as values here, since
    output column c depends on value column c alone and only the first
    kv_lora_rank columns, which are ``ckv`` in both, are kept.  Returns
    (out (B, 1, d), the new MLACache)."""
    m = cfg.mla
    nope, R = m.qk_nope_head_dim, m.kv_lora_rank
    B, H = x.shape[0], params["wkv_b"].shape[1] // (nope + m.v_head_dim)
    if tp is not None:
        x = tp.copy(x)
    ckv_new, krope_new = _mla_latents(params, cfg, x, pos[:, None])
    S = cache.ckv.shape[1]
    mask = (torch.arange(S, device=x.device)[None, :]
            == pos.long()[:, None])[:, :, None]
    cache = MLACache(torch.where(mask, ckv_new.to(cache.ckv.dtype),
                                 cache.ckv),
                     torch.where(mask, krope_new.to(cache.krope.dtype),
                                 cache.krope))
    q = _mla_query(params, cfg, x)
    q_rope = apply_rope(q[..., nope:], pos[:, None], cfg.rope_theta)[:, 0]
    w_kv_b = params["wkv_b"].reshape(R, H, nope + m.v_head_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nope],
                         w_kv_b[..., :nope])                    # (B, H, R)
    q_full = torch.cat([q_abs, q_rope], dim=-1)           # (B, H, R + rope)
    keys = torch.cat([cache.ckv, cache.krope], dim=-1)[:, None]
    ctx = decode_attention(q_full, keys, keys, pos + 1,
                           sm_scale=_mla_scale(m))[..., :R]
    out = torch.einsum("bhr,rhv->bhv", ctx, w_kv_b[..., nope:])
    out = out.reshape(B, 1, -1) @ params["wo"]
    return (out if tp is None else tp.psum(out)), cache
