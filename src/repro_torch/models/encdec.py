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

Tensor parallelism (the process binding's ``tp``): every attention — the
encoder's, the decoder's self and cross attention — runs on the rank's
heads as the GQA layers do, the FFN on the rank's columns of ``d_ff``
(``wi``'s columns, ``wo``'s rows, summed), and the caches hold the rank's
heads.  The bare ``embed`` table, (model, None) in the reference, is the
rank's vocabulary rows where the vocabulary divides: the lookup goes
through ``tp.embed`` and the tied unembedding's vocabulary slice is
gathered over ``model`` (:func:`~repro_torch.models.layers.embed` /
``unembed`` on ``{"table": embed}``).  Where it does not divide, the table
is whole on every rank, as the reference's rule falls back.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..configs.base import ArchConfig
from . import attention as A
from .layers import (embed, embed_init, ffn_nogate, init_ffn_nogate,
                     init_layernorm, layernorm, remat_call, unembed)
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


def _kept(path, tree):
    return tree


def init_encdec(gen: torch.Generator, cfg: ArchConfig, keep=None):
    """Random weights, drawn from ``gen`` on its device.  ``keep(path,
    tree)``, where given, takes each group of leaves as soon as it is
    drawn — ``("enc_pos",)``, ``("dec_pos",)``, ``("embed",)``, each
    layer (``("enc", i)``, ``("dec", i)``), ``("ln_enc",)`` and
    ``("ln_dec",)`` — and returns what the result holds in its place (the
    process binding's blocks); the draws are the same either way."""
    dev, dt, d = gen.device, cfg.dtype_, cfg.d_model
    keep = _kept if keep is None else keep

    def positions(n):
        return (torch.randn((n, d), generator=gen, device=dev,
                            dtype=torch.float32) * 0.01).to(dt)

    out = {"enc_pos": keep(("enc_pos",),
                           positions(cfg.cross.n_context_tokens))}
    out["dec_pos"] = keep(("dec_pos",), positions(DEC_POSITIONS))
    out["embed"] = keep(("embed",), embed_init(gen, cfg.vocab, d, dt))
    out["enc"] = [keep(("enc", i), _init_enc_block(gen, cfg))
                  for i in range(cfg.n_enc_layers)]
    out["dec"] = [keep(("dec", i), _init_dec_block(gen, cfg))
                  for i in range(cfg.n_layers)]
    out["ln_enc"] = keep(("ln_enc",), init_layernorm(d, dev))
    out["ln_dec"] = keep(("ln_dec",), init_layernorm(d, dev))
    return out


def _whole(gather, tree):
    return tree if gather is None else gather(tree)


def _enc_block(p, cfg, x, gather=None, tp=None):
    p = _whole(gather, p)
    h, _ = A.attention(p["attn"], cfg, layernorm(p["ln1"], x, cfg.norm_eps),
                       causal=False, use_rope=False, tp=tp)
    x = x + h
    return x + ffn_nogate(p["ffn"], layernorm(p["ln2"], x, cfg.norm_eps), tp)


def _dec_block(p, cfg, x, enc_out, tp=None):
    """x (B, S, d) → (x', self-attention k/v, cross-attention k/v)."""
    h, self_kv = A.attention(p["self_attn"], cfg,
                             layernorm(p["ln1"], x, cfg.norm_eps),
                             use_rope=False, tp=tp)
    x = x + h
    h, cross_kv = A.attention(p["cross_attn"], cfg,
                              layernorm(p["ln_x"], x, cfg.norm_eps),
                              kv_x=enc_out, use_rope=False, tp=tp)
    x = x + h
    x = x + ffn_nogate(p["ffn"], layernorm(p["ln2"], x, cfg.norm_eps), tp)
    return x, self_kv, cross_kv


def _dec_block_out(p, cfg, x, enc_out, gather=None, tp=None):
    return _dec_block(_whole(gather, p), cfg, x, enc_out, tp)[0]


def encode(params, cfg: ArchConfig, frames, remat: str = "none",
           gather=None, tp=None):
    """frames (B, n_ctx, d), the stubbed frame embeddings → the encoder's
    output (B, n_ctx, d); ``remat`` recomputes each block in the backward
    pass (:func:`~repro_torch.models.layers.remat_call`); ``gather``
    (fsdp) takes each block's parameters whole inside that region; ``tp``
    the tensor-parallel path.  The parameters outside the layers must be
    whole."""
    x = frames + params["enc_pos"][None, :frames.shape[1]]
    for p in params["enc"]:
        x = remat_call(remat, _enc_block, p, cfg, x, gather, tp)
    return layernorm(params["ln_enc"], x, cfg.norm_eps)


def _embed_tokens(params, tokens, tp=None):
    """The tokens' embeddings plus the learned positions 0 … S − 1, the
    table tiled where S passes its rows."""
    S = tokens.shape[1]
    table = params["dec_pos"]
    if S > table.shape[0]:       # long prompts pass the learned table
        table = table.repeat(-(-S // table.shape[0]), 1)
    return embed({"table": params["embed"]}, tokens, tp) + table[None, :S]


def _logits(params, x, tp=None):
    """``x @ embed.T``, tied to the bare table (with ``tp`` the ranks'
    vocabulary slices gathered)."""
    return unembed({"table": params["embed"]}, x, True, tp)


def decode_train(params, cfg: ArchConfig, tokens, enc_out,
                 remat: str = "none", gather=None, tp=None):
    """Teacher-forced decoder pass → logits (B, S, vocab)."""
    x = _embed_tokens(params, tokens, tp)
    for p in params["dec"]:
        x = remat_call(remat, _dec_block_out, p, cfg, x, enc_out, gather, tp)
    x = layernorm(params["ln_dec"], x, cfg.norm_eps)
    return _logits(params, x, tp)


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


def prefill(params, cfg: ArchConfig, tokens, frames, s_max: int,
            gather=None, tp=None):
    """Encode, run the decoder over the prompt, and keep its caches: each
    layer's self-attention k/v zero-padded to ``s_max`` slots and its
    cross-attention k/v of the encoder's output.  → (last logits (B,
    vocab), :class:`EncDecCache`).  The reference projects both caches
    again from the block inputs; the port keeps the attention's own (the
    same values).  ``gather`` (fsdp) takes each layer's parameters whole
    as it runs; ``tp`` the tensor-parallel path."""
    enc_out = encode(params, cfg, frames, gather=gather, tp=tp)
    x = _embed_tokens(params, tokens, tp)
    self_kv, cross_kv = [], []
    for p in params["dec"]:
        x, skv, ckv = _dec_block(_whole(gather, p), cfg, x, enc_out, tp)
        self_kv.append(_block_prefill_cache(skv, s_max, ring=False))
        cross_kv.append(A.KVCache(*(t.contiguous() for t in ckv)))
    x = layernorm(params["ln_dec"], x[:, -1], cfg.norm_eps)
    return _logits(params, x, tp), EncDecCache(self_kv, cross_kv)


def decode_step(params, cfg: ArchConfig, token, cache: EncDecCache, pos,
                gather=None, tp=None):
    """token (B, 1), pos (B,) → (logits (B, vocab), cache): the
    self-attention caches are written in place at ``pos``, the cross
    caches read as they are; ``gather`` (fsdp) and ``tp`` as
    :func:`prefill`'s."""
    table = params["dec_pos"]
    x = embed({"table": params["embed"]}, token, tp) \
        + table[pos.long() % table.shape[0]][:, None]
    ctx_lengths = A.context_lengths(cache.cross_kv[0])
    for p, skv, ckv in zip(params["dec"], cache.self_kv, cache.cross_kv):
        p = _whole(gather, p)
        h, _ = A.attention_decode(p["self_attn"], cfg,
                                  layernorm(p["ln1"], x, cfg.norm_eps), skv,
                                  pos, use_rope=False, tp=tp)
        x = x + h
        x = x + A.cross_attention_decode(
            p["cross_attn"], cfg, layernorm(p["ln_x"], x, cfg.norm_eps), ckv,
            ctx_lengths, tp)
        x = x + ffn_nogate(p["ffn"], layernorm(p["ln2"], x, cfg.norm_eps), tp)
    x = layernorm(params["ln_dec"], x[:, 0], cfg.norm_eps)
    return _logits(params, x, tp), cache


__all__ = ["DEC_POSITIONS", "EncDecCache", "decode_step", "decode_train",
           "encode", "init_cache", "init_encdec", "prefill"]
