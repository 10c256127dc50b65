"""Model factory, the counterpart of ``repro/models/model.py``'s
``build_model`` / ``_build_lm`` / ``_build_encdec`` / ``_build_rwkv``.

``build_model(cfg, remat=..., xent_chunks=...)`` returns a :class:`Model` of
functions:

  init(generator)                      → params (on the generator's device)
  train_loss(params, batch)            → (loss, metrics)
  logits(params, batch)                → (B, S, vocab)
  prefill(params, batch, s_max)        → (last_logits, caches, pos)
  decode_step(params, token, caches, pos[, batch]) → (logits, caches)
  init_cache(batch_size, s_max, device=None) → caches
  input_specs(shape)                   → dict of meta tensors

``batch`` is a dict ``{"tokens": (B, S) int}`` plus, for the vlm and audio
families, ``{"context": (B, n_ctx, d)}``, the stubbed modality frontend's
output in the model dtype; ``caches`` is one entry per layer (whisper's an
:class:`~repro_torch.models.encdec.EncDecCache`).  The LM family covers
the dense models, the hybrid one (recurrentgemma), the MoE family with GQA
attention (llama4-maverick) or MLA (deepseek-v3; as in the reference, a
``family="moe"`` config without ``moe`` gets the dense plan) and the vlm
(llama-3.2-vision: its cross layers read the context at prefill and in
training, and decode attends the cross caches prefill filled); rwkv6
(family ``ssm``) and whisper (family ``audio``, :mod:`.encdec`) have their
own stacks.  A config with ``mtp_depth`` (deepseek-v3) also draws the
reference's multi-token-prediction subtree ``mtp`` (``proj``, ``norm_h``,
``norm_e`` and one ``mla_dense`` block), so the two parameter trees line
up leaf for leaf; ``train_loss`` reads it (the MTP term), the serving
path does not.

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
from . import encdec as E
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
    if cfg.family == "audio":
        return _build_encdec(cfg, remat)
    if cfg.family == "ssm":
        return _build_rwkv(cfg, remat)
    return _build_lm(cfg, remat, xent_chunks)


def _device(params):
    """The parameters' device: the embedding table's (whisper's is a bare
    array, the others' a ``{"table"}`` dict)."""
    e = params["embed"]
    return (e if isinstance(e, torch.Tensor) else e["table"]).device


def _tokens(params, batch):
    return torch.as_tensor(batch["tokens"]).to(_device(params)).long()


def _context(params, batch):
    """``batch["context"]`` on the parameters' device, or None."""
    ctx = batch.get("context")
    return None if ctx is None else torch.as_tensor(ctx).to(_device(params))


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
    sequence's position and a cache of ``seq_len`` slots; the vlm and audio
    families' batches add the context (B, n_ctx, d) in the model dtype (a
    decode cell's as its ``batch``)."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    ctx = {}
    if cfg.family in ("vlm", "audio"):
        ctx["context"] = torch.empty(
            (B, cfg.cross.n_context_tokens, cfg.d_model), dtype=cfg.dtype_,
            device="meta")
    if shape.kind == "train":
        return {"batch": {"tokens": tok(B, S + 1)} | ctx}
    if shape.kind == "prefill":
        return {"batch": {"tokens": tok(B, S)} | ctx}
    specs = {"token": tok(B, 1), "pos": tok(B),
             "cache": init_cache(B, S, device="meta")}
    if ctx:
        specs["batch"] = ctx
    return specs


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

    def _hidden(params, tokens, context):
        x, aux = T.apply_stack_train(params["layers"], cfg,
                                     _embed_in(params, tokens), remat,
                                     context)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    def logits(params, batch):
        h, _aux = _hidden(params, _tokens(params, batch),
                          _context(params, batch))
        return unembed(params["embed"], h, cfg.tie_embeddings)

    def train_loss(params, batch):
        """batch['tokens'] (B, S + 1) → (loss, metrics): next-token
        cross-entropy (+ MoE aux, + MTP), metrics ``xent``, ``moe_aux``
        and, with MTP, ``mtp``."""
        tokens, inputs, labels = _split_tokens(params, batch)
        h, aux = _hidden(params, inputs, _context(params, batch))
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
        x, caches = T.fill_stack_cache(params["layers"], cfg, x, s_max,
                                       context=_context(params, batch))
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


# ------------------------------------------------------------------- whisper
def _build_encdec(cfg: ArchConfig, remat: str) -> Model:
    def init(generator: torch.Generator):
        """Random weights, drawn from ``generator`` on its device."""
        return E.init_encdec(generator, cfg)

    def logits(params, batch):
        enc_out = E.encode(params, cfg, _context(params, batch), remat)
        return E.decode_train(params, cfg, _tokens(params, batch), enc_out,
                              remat)

    def train_loss(params, batch):
        _tokens_all, inputs, labels = _split_tokens(params, batch)
        lg = logits(params, {"tokens": inputs,
                             "context": _context(params, batch)})
        loss = _xent(lg, labels)
        return loss, {"xent": loss}

    def init_cache(batch_size, s_max, device=None):
        return E.init_cache(cfg, batch_size, s_max, resolve_device(device))

    def prefill(params, batch, s_max):
        tokens = _tokens(params, batch)
        lg, cache = E.prefill(params, cfg, tokens, _context(params, batch),
                              s_max)
        return lg, cache, _last_pos(tokens)

    def decode_step(params, token, cache, pos, batch=None):
        return E.decode_step(params, cfg,
                             _tokens(params, {"tokens": token}), cache, pos)

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
