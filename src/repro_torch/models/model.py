"""Model factory, the counterpart of ``repro/models/model.py``'s
``build_model`` / ``_build_lm`` / ``_build_rwkv``.

``build_model(cfg, remat=..., xent_chunks=...)`` returns a :class:`Model` of
functions:

  init(generator)                      → params (on the generator's device)
  train_loss(params, batch)            → (loss, metrics)
  logits(params, batch)                → (B, S, vocab)
  prefill(params, batch, s_max)        → (last_logits, caches, pos)
  decode_step(params, token, caches, pos[, batch]) → (logits, caches)
  init_cache(batch_size, s_max, device=None) → caches
  input_specs(shape)                   → dict of meta tensors

``batch`` is a dict ``{"tokens": (B, S) int}``; ``caches`` is one entry per
layer.  The LM family covers the dense models, the hybrid one
(recurrentgemma) and the MoE family with GQA attention (llama4-maverick)
or MLA (deepseek-v3; as in the reference, a ``family="moe"`` config
without ``moe`` gets the dense plan); rwkv6 (family ``ssm``) has its own
stack.  A config with ``mtp_depth`` (deepseek-v3) also draws the
reference's multi-token-prediction subtree ``mtp`` (``proj``, ``norm_h``,
``norm_e`` and one ``mla_dense`` block), so the two parameter trees line
up leaf for leaf; ``train_loss`` reads it (the MTP term), the serving
path does not.  The vlm and audio families raise ``NotImplementedError``.

``train_loss`` is the reference's: next-token cross-entropy of
``tokens[:, :-1]`` → ``tokens[:, 1:]`` through the training stack
(``remat`` per block), plus ``MOE_AUX_WEIGHT`` × the blocks' load-balance
losses for an MoE config and ``MTP_WEIGHT`` × the MTP head's loss (position
i predicts token i + 2) where ``mtp_depth`` is set; with ``xent_chunks`` >
1 the unembedding and loss run per sequence chunk under
``torch.utils.checkpoint``, so the (B, S, vocab) logits never exist at
once.  ``logits`` runs the same training stack.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.runtime import resolve_device
from . import rwkv6 as W
from . import transformer as T
from .layers import (dense_init, embed, init_embedding, init_layernorm,
                     init_rmsnorm, layernorm, remat_call, rmsnorm, unembed)

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    train_loss: Callable
    logits: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    input_specs: Callable


def build_model(cfg: ArchConfig, *, remat: str = "block",
                xent_chunks: int = 1) -> Model:
    """``remat``: ``"none"``, ``"block"`` or ``"full"`` (each training
    block recomputed in the backward pass; the reference's knob);
    ``xent_chunks``: sequence chunks of the unembedding and loss."""
    if cfg.family in ("dense", "hybrid", "moe"):
        return _build_lm(cfg, remat, xent_chunks)
    if cfg.family == "ssm":
        return _build_rwkv(cfg, remat)
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


def _xent(logits, labels):
    """Mean next-token cross-entropy, log-softmax in float32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, labels[..., None])[..., 0].mean()


def _xent_chunked(embed_params, h, labels, tie, n_chunks):
    """:func:`_xent` of ``unembed(h)`` with the unembedding and loss run per
    sequence chunk, each recomputed in the backward pass, so the (B, S,
    vocab) logits never exist at once.  The same value as :func:`_xent`
    (up to the order of the float32 sum)."""
    B, S, _ = h.shape
    n_chunks = min(n_chunks, S)
    while S % n_chunks:
        n_chunks -= 1

    def chunk_loss(hi, li):
        lg = unembed(embed_params, hi, tie)
        lp = torch.log_softmax(lg.float(), dim=-1)
        return -lp.gather(-1, li[..., None])[..., 0].sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hi, li in zip(h.chunk(n_chunks, dim=1),
                      labels.chunk(n_chunks, dim=1)):
        total = total + remat_call("block", chunk_loss, hi, li)
    return total / (B * S)


def _split_tokens(params, batch):
    """``batch['tokens']`` (B, S + 1) on the params' device → (tokens,
    inputs ``tokens[:, :-1]``, labels ``tokens[:, 1:]``)."""
    tokens = _tokens(params, batch)
    return tokens, tokens[:, :-1], tokens[:, 1:]


def param_stacks(cfg: ArchConfig):
    """The groups of ``params['layers']`` indices the reference stores as
    one stacked ``(n, …)`` leaf (its optimizer's layout): the LM family's
    superblock positions, every rwkv6 block."""
    if cfg.family == "ssm":
        return [list(range(cfg.n_layers))]
    return T.layer_stacks(cfg)


def _input_specs(cfg: ArchConfig, shape: ShapeConfig, init_cache):
    """The inputs of a (config, shape) cell as meta tensors of the
    reference's shapes and dtypes: a train cell's batch is (B, S + 1)
    tokens, a prefill cell's (B, S), a decode cell's one token, each
    sequence's position and a cache of ``seq_len`` slots."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        return {"batch": {"tokens": tok(B, S + 1)}}
    if shape.kind == "prefill":
        return {"batch": {"tokens": tok(B, S)}}
    return {"token": tok(B, 1), "pos": tok(B),
            "cache": init_cache(B, S, device="meta")}


# ---------------------------------------------------------------- LM family
def _build_lm(cfg: ArchConfig, remat: str, xent_chunks: int) -> Model:
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

    def _hidden(params, tokens):
        x, aux = T.apply_stack_train(params["layers"], cfg,
                                     _embed_in(params, tokens), remat)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    def logits(params, batch):
        h, _aux = _hidden(params, _tokens(params, batch))
        return unembed(params["embed"], h, cfg.tie_embeddings)

    def train_loss(params, batch):
        """batch['tokens'] (B, S + 1) → (loss, metrics): next-token
        cross-entropy (+ MoE aux, + MTP), metrics ``xent``, ``moe_aux``
        and, with MTP, ``mtp``."""
        tokens, inputs, labels = _split_tokens(params, batch)
        h, aux = _hidden(params, inputs)
        if xent_chunks > 1:
            loss = _xent_chunked(params["embed"], h, labels,
                                 cfg.tie_embeddings, xent_chunks)
        else:
            loss = _xent(unembed(params["embed"], h, cfg.tie_embeddings),
                         labels)
        metrics = {"xent": loss, "moe_aux": aux}
        if cfg.moe is not None:
            loss = loss + MOE_AUX_WEIGHT * aux
        if cfg.mtp_depth:
            mtp = params["mtp"]
            fused = torch.cat(
                [rmsnorm(mtp["norm_h"], h, cfg.norm_eps),
                 rmsnorm(mtp["norm_e"], _embed_in(params, labels),
                         cfg.norm_eps)], dim=-1)
            x2, _ = T.train_block(mtp["block"], cfg, "mla_dense"
                                  if cfg.mla is not None else "attn",
                                  fused @ mtp["proj"])
            lg2 = unembed(params["embed"],
                          rmsnorm(params["final_norm"], x2, cfg.norm_eps),
                          cfg.tie_embeddings)
            # the MTP head at position i predicts token i + 2
            mtp_loss = _xent(lg2[:, :-1], tokens[:, 2:])
            metrics["mtp"] = mtp_loss
            loss = loss + MTP_WEIGHT * mtp_loss
        return loss, metrics

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

    def input_specs(shape: ShapeConfig):
        return _input_specs(cfg, shape, init_cache)

    return Model(cfg, init, train_loss, logits, prefill, decode_step,
                 init_cache, input_specs)


# --------------------------------------------------------------------- rwkv6
def _build_rwkv(cfg: ArchConfig, remat: str) -> Model:
    def init(generator: torch.Generator):
        """Random weights, drawn from ``generator`` on its device: an untied
        embedding and head, ``ln0`` before the first block."""
        return {"embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                        cfg.dtype_, False),
                "ln0": init_layernorm(cfg.d_model, generator.device),
                "layers": W.init_rwkv_stack(generator, cfg),
                "final_norm": init_rmsnorm(cfg.d_model, generator.device)}

    def _embed_in(params, tokens):
        return layernorm(params["ln0"], embed(params["embed"], tokens),
                         cfg.norm_eps)

    def _hidden(params, tokens, states=None):
        return W.apply_rwkv_stack(params["layers"], cfg,
                                  _embed_in(params, tokens), states)

    def _logits(params, tokens):
        x = W.apply_rwkv_train(params["layers"], cfg,
                               _embed_in(params, tokens), remat)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, False)

    def logits(params, batch):
        return _logits(params, _tokens(params, batch))

    def train_loss(params, batch):
        _tokens_all, inputs, labels = _split_tokens(params, batch)
        loss = _xent(_logits(params, inputs), labels)
        return loss, {"xent": loss}

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

    def input_specs(shape: ShapeConfig):
        return _input_specs(cfg, shape, init_cache)

    return Model(cfg, init, train_loss, logits, prefill, decode_step,
                 init_cache, input_specs)
