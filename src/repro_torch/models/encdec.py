"""Whisper-style encoder–decoder backbone, the counterpart of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, n_frames, d) as the batch's ``context``.
The backbone: learned positions (``enc_pos`` of ``n_ctx`` rows, ``dec_pos``
of 4,096 rows, tiled past 4,096 in a long prompt and read at ``pos % 4096``
in decode), pre-LN layernorm blocks, a bidirectional encoder (non-causal
self-attention, no RoPE), a decoder of causal self-attention (no RoPE),
then cross-attention over the encoder's output, then a non-gated GELU FFN,
and an unembedding tied to the bare ``embed`` table.

Parameters: ``{"enc_pos", "dec_pos", "embed" (vocab, d), "enc": [one dict
per encoder layer], "dec": [one dict per decoder layer], "ln_enc",
"ln_dec"}``; the reference stacks ``enc`` and ``dec`` into ``(L, …)``
leaves, the port keeps a list, as its LM stack does.  The decode cache,
:class:`EncDecCache`, holds one self-attention :class:`KVCache` of
``s_max`` slots and one cross-attention :class:`KVCache` of the encoder's
``n_ctx`` positions per decoder layer; prefill projects the cross caches
once from the encoder's output, and decode never writes them.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..configs.base import ArchConfig
from . import attention as A
from .layers import (embed_init, ffn_nogate, init_ffn_nogate,
                     init_layernorm, layernorm, remat_call)
from .transformer import _block_prefill_cache

#: Rows of the decoder's learned position table.
DEC_POSITIONS = 4096


def _init_enc_block(gen, cfg):
    dev = gen.device
    return {"ln1": init_layernorm(cfg.d_model, dev),
            "attn": A.init_attention(gen, cfg),
            "ln2": init_layernorm(cfg.d_model, dev),
            "ffn": init_ffn_nogate(gen, cfg.d_model, cfg.d_ff, cfg.dtype_)}


def _init_dec_block(gen, cfg):
    dev = gen.device
    return {"ln1": init_layernorm(cfg.d_model, dev),
            "self_attn": A.init_attention(gen, cfg),
            "ln_x": init_layernorm(cfg.d_model, dev),
            "cross_attn": A.init_attention(gen, cfg),
            "ln2": init_layernorm(cfg.d_model, dev),
            "ffn": init_ffn_nogate(gen, cfg.d_model, cfg.d_ff, cfg.dtype_)}


def init_encdec(gen: torch.Generator, cfg: ArchConfig):
    """Random weights, drawn from ``gen`` on its device."""
    dev, dt, d = gen.device, cfg.dtype_, cfg.d_model

    def positions(n):
        return (torch.randn((n, d), generator=gen, device=dev,
                            dtype=torch.float32) * 0.01).to(dt)

    return {
        "enc_pos": positions(cfg.cross.n_context_tokens),
        "dec_pos": positions(DEC_POSITIONS),
        "embed": embed_init(gen, cfg.vocab, d, dt),
        "enc": [_init_enc_block(gen, cfg) for _ in range(cfg.n_enc_layers)],
        "dec": [_init_dec_block(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_enc": init_layernorm(d, dev),
        "ln_dec": init_layernorm(d, dev),
    }


def _enc_block(p, cfg, x):
    h, _ = A.attention(p["attn"], cfg, layernorm(p["ln1"], x, cfg.norm_eps),
                       causal=False, use_rope=False)
    x = x + h
    return x + ffn_nogate(p["ffn"], layernorm(p["ln2"], x, cfg.norm_eps))


def _dec_block(p, cfg, x, enc_out):
    """x (B, S, d) → (x', self-attention k/v, cross-attention k/v)."""
    h, self_kv = A.attention(p["self_attn"], cfg,
                             layernorm(p["ln1"], x, cfg.norm_eps),
                             use_rope=False)
    x = x + h
    h, cross_kv = A.attention(p["cross_attn"], cfg,
                              layernorm(p["ln_x"], x, cfg.norm_eps),
                              kv_x=enc_out, use_rope=False)
    x = x + h
    x = x + ffn_nogate(p["ffn"], layernorm(p["ln2"], x, cfg.norm_eps))
    return x, self_kv, cross_kv


def _dec_block_out(p, cfg, x, enc_out):
    return _dec_block(p, cfg, x, enc_out)[0]


def encode(params, cfg: ArchConfig, frames, remat: str = "none"):
    """frames (B, n_ctx, d), the stubbed frame embeddings → the encoder's
    output (B, n_ctx, d); ``remat`` recomputes each block in the backward
    pass (:func:`~repro_torch.models.layers.remat_call`)."""
    x = frames + params["enc_pos"][None, :frames.shape[1]]
    for p in params["enc"]:
        x = remat_call(remat, _enc_block, p, cfg, x)
    return layernorm(params["ln_enc"], x, cfg.norm_eps)


def _embed_tokens(params, tokens):
    """The tokens' embeddings plus the learned positions 0 … S − 1, the
    table tiled where S passes its rows."""
    S = tokens.shape[1]
    table = params["dec_pos"]
    if S > table.shape[0]:       # long prompts pass the learned table
        table = table.repeat(-(-S // table.shape[0]), 1)
    return params["embed"][tokens] + table[None, :S]


def decode_train(params, cfg: ArchConfig, tokens, enc_out,
                 remat: str = "none"):
    """Teacher-forced decoder pass → logits (B, S, vocab)."""
    x = _embed_tokens(params, tokens)
    for p in params["dec"]:
        x = remat_call(remat, _dec_block_out, p, cfg, x, enc_out)
    x = layernorm(params["ln_dec"], x, cfg.norm_eps)
    return x @ params["embed"].T


class EncDecCache(NamedTuple):
    self_kv: List[A.KVCache]      # per decoder layer, (B, Hkv, S_max, hd)
    cross_kv: List[A.KVCache]     # per decoder layer, (B, Hkv, n_ctx, hd)


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device) -> EncDecCache:
    def kv(slots):
        shape = (batch, cfg.n_kv_heads, slots, cfg.head_dim_)
        return A.KVCache(*(torch.zeros(shape, dtype=cfg.dtype_,
                                       device=device) for _ in range(2)))

    n_ctx = cfg.cross.n_context_tokens
    return EncDecCache([kv(s_max) for _ in range(cfg.n_layers)],
                       [kv(n_ctx) for _ in range(cfg.n_layers)])


def prefill(params, cfg: ArchConfig, tokens, frames, s_max: int):
    """Encode, run the decoder over the prompt, and keep its caches: each
    layer's self-attention k/v zero-padded to ``s_max`` slots and its
    cross-attention k/v of the encoder's output.  → (last logits (B,
    vocab), :class:`EncDecCache`).  The reference projects both caches
    again from the block inputs; the port keeps the attention's own (the
    same values)."""
    enc_out = encode(params, cfg, frames)
    x = _embed_tokens(params, tokens)
    self_kv, cross_kv = [], []
    for p in params["dec"]:
        x, skv, ckv = _dec_block(p, cfg, x, enc_out)
        self_kv.append(_block_prefill_cache(skv, s_max, ring=False))
        cross_kv.append(A.KVCache(*(t.contiguous() for t in ckv)))
    x = layernorm(params["ln_dec"], x[:, -1], cfg.norm_eps)
    return x @ params["embed"].T, EncDecCache(self_kv, cross_kv)


def decode_step(params, cfg: ArchConfig, token, cache: EncDecCache, pos):
    """token (B, 1), pos (B,) → (logits (B, vocab), cache): the
    self-attention caches are written in place at ``pos``, the cross
    caches read as they are."""
    table = params["dec_pos"]
    x = params["embed"][token] + table[pos.long() % table.shape[0]][:, None]
    ctx_lengths = A.context_lengths(cache.cross_kv[0])
    for p, skv, ckv in zip(params["dec"], cache.self_kv, cache.cross_kv):
        h, _ = A.attention_decode(p["self_attn"], cfg,
                                  layernorm(p["ln1"], x, cfg.norm_eps), skv,
                                  pos, use_rope=False)
        x = x + h
        x = x + A.cross_attention_decode(
            p["cross_attn"], cfg, layernorm(p["ln_x"], x, cfg.norm_eps), ckv,
            ctx_lengths)
        x = x + ffn_nogate(p["ffn"], layernorm(p["ln2"], x, cfg.norm_eps))
    x = layernorm(params["ln_dec"], x[:, 0], cfg.norm_eps)
    return x @ params["embed"].T, cache


__all__ = ["DEC_POSITIONS", "EncDecCache", "decode_step", "decode_train",
           "encode", "init_cache", "init_encdec", "prefill"]
