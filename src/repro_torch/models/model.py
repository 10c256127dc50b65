"""Model factory, the counterpart of ``repro/models/model.py``'s
``build_model`` / ``_build_lm`` / ``_build_encdec`` / ``_build_rwkv``.

``build_model(cfg, remat=..., xent_chunks=..., moe_fn=...)`` returns a :class:`Model` of
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
                xent_chunks: int = 1, moe_fn=None, tp=None,
                gather=None) -> Model:
    """``remat``: ``"none"``, ``"block"`` or ``"full"`` (each training
    block recomputed in the backward pass; the reference's knob);
    ``xent_chunks``: sequence chunks of the unembedding and loss;
    ``moe_fn``: the MoE layers' block in training, prefill and decode, in
    place of ``moe_block_local`` (the expert-parallel hook,
    :func:`repro_torch.distributed.moe_ep.make_moe_fn`; the LM family
    only, as in the reference); ``tp``: the process binding's
    tensor-parallel path
    (:class:`~repro_torch.distributed.tensor_parallel.TensorParallel`;
    every family's prefill and decode, and the dense and GQA MoE layers'
    training); ``gather``:
    fsdp's per-layer gather on the process binding (``gather(tree)`` →
    the tree with its dp-sharded leaves whole; every family applies it
    to each layer's parameters as the layer runs — in training inside the
    layer's ``remat`` region, so the backward gathers them again — and to
    the parameters outside the layers once a call: the embeddings,
    positions, norms and head).  Where ``moe_fn`` carries a ``world_aux``
    (the process binding's), ``train_loss`` takes the blocks'
    load-balance loss through it: the mean over the world."""
    if cfg.family == "audio":
        return _build_encdec(cfg, remat, gather, tp)
    if cfg.family == "ssm":
        return _build_rwkv(cfg, remat, gather, tp)
    return _build_lm(cfg, remat, xent_chunks, moe_fn, tp, gather)


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


def _xent_chunked(embed_params, h, labels, tie, n_chunks, tp=None):
    """:func:`_xent` of ``unembed(h)`` with the unembedding and loss run per
    sequence chunk, each recomputed in the backward pass, so the (B, S,
    vocab) logits never exist at once.  The same value as :func:`_xent`
    (up to the order of the float32 sum)."""
    B, S, _ = h.shape
    n_chunks = min(n_chunks, S)
    while S % n_chunks:
        n_chunks -= 1

    def chunk_loss(hi, li):
        lg = unembed(embed_params, hi, tie, tp)
        lp = torch.log_softmax(lg.float(), dim=-1)
        return -lp.gather(-1, li[..., None])[..., 0].sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hi, li in zip(h.chunk(n_chunks, dim=1),
                      labels.chunk(n_chunks, dim=1)):
        total = total + remat_call("block", chunk_loss, hi, li)
    return total / (B * S)


def _as_drawn(path, tree):
    """``init``'s default ``keep``: every group of leaves as it was
    drawn."""
    return tree


def _outside(params, gather, inner=("layers",)):
    """The parameters outside the layers (every top-level entry but
    ``inner``) with fsdp's shards gathered, once a call; the layers gather
    their own as they run."""
    if gather is None:
        return params
    return dict(params, **{k: gather(v) for k, v in params.items()
                           if k not in inner})


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
def _build_lm(cfg: ArchConfig, remat: str, xent_chunks: int,
              moe_fn=None, tp=None, gather=None) -> Model:
    # the reference multiplies by sqrt(d) cast to the model dtype first (in
    # bf16, 50.5 for d = 2560); the product of two such values is exact in
    # float32, so one rounding to the model dtype gives the reference's bits
    embed_scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype_)) \
        if cfg.scale_embed else None

    def init(generator: torch.Generator, experts=None, keep=None):
        """Random weights, drawn from ``generator`` on its device, with the
        ``mtp`` subtree where the config has ``mtp_depth``.

        ``experts`` (lo, hi) keeps each MoE layer's experts lo … hi − 1
        (:func:`moe.init_moe`); ``keep(path, tree)``, where given, takes
        each group of leaves as soon as it is drawn — the embedding
        (``("embed",)``), each layer (``("layers", i)``), the final norm
        and the ``mtp`` subtree — and returns what the result holds in its
        place, so a caller that keeps a block of each holds one group whole
        at a time (:func:`repro_torch.distributed.tensor_parallel.
        init_params`)."""
        keep = keep or _as_drawn
        dev = generator.device
        p = {"embed": keep(("embed",), init_embedding(
            generator, cfg.vocab, cfg.d_model, cfg.dtype_,
            cfg.tie_embeddings))}
        p["layers"] = [keep(("layers", i),
                            T.init_block(generator, cfg, kind, experts))
                       for i, kind in enumerate(T.layer_kinds(cfg))]
        p["final_norm"] = keep(("final_norm",),
                               init_rmsnorm(cfg.d_model, dev))
        if cfg.mtp_depth:
            p["mtp"] = keep(("mtp",), {
                "proj": dense_init(generator, 2 * cfg.d_model, cfg.d_model,
                                   cfg.dtype_),
                "norm_h": init_rmsnorm(cfg.d_model, dev),
                "norm_e": init_rmsnorm(cfg.d_model, dev),
                "block": T.init_block(generator, cfg, "mla_dense"
                                      if cfg.mla is not None else "attn")})
        return p

    def _embed_in(params, tokens):
        x = embed(params["embed"], tokens, tp)
        return x * embed_scale if embed_scale is not None else x

    def _hidden(params, tokens, context):
        x, aux = T.apply_stack_train(params["layers"], cfg,
                                     _embed_in(params, tokens), remat,
                                     context, moe_fn, tp, gather)
        if hasattr(moe_fn, "world_aux"):
            aux = moe_fn.world_aux(aux, tokens.shape[1])
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    def logits(params, batch):
        params = _outside(params, gather)
        h, _aux = _hidden(params, _tokens(params, batch),
                          _context(params, batch))
        return unembed(params["embed"], h, cfg.tie_embeddings, tp)

    def train_loss(params, batch):
        """batch['tokens'] (B, S + 1) → (loss, metrics): next-token
        cross-entropy (+ MoE aux, + MTP), metrics ``xent``, ``moe_aux``
        and, with MTP, ``mtp``."""
        params = _outside(params, gather)
        tokens, inputs, labels = _split_tokens(params, batch)
        h, aux = _hidden(params, inputs, _context(params, batch))
        if xent_chunks > 1:
            loss = _xent_chunked(params["embed"], h, labels,
                                 cfg.tie_embeddings, xent_chunks, tp)
        else:
            loss = _xent(unembed(params["embed"], h, cfg.tie_embeddings,
                                 tp), labels)
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
        params = _outside(params, gather)
        tokens = _tokens(params, batch)
        x = _embed_in(params, tokens)
        x, caches = T.fill_stack_cache(params["layers"], cfg, x, s_max,
                                       context=_context(params, batch),
                                       moe_fn=moe_fn, tp=tp, gather=gather)
        h = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        lg = unembed(params["embed"], h, cfg.tie_embeddings, tp)[:, 0]
        return lg, caches, _last_pos(tokens)

    def decode_step(params, token, caches, pos, batch=None):
        params = _outside(params, gather)
        x = _embed_in(params, _tokens(params, {"tokens": token}))
        x, caches = T.apply_stack_decode(params["layers"], cfg, x, caches,
                                         pos, moe_fn, tp, gather)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        lg = unembed(params["embed"], h, cfg.tie_embeddings, tp)[:, 0]
        return lg, caches

    def input_specs(shape: ShapeConfig):
        return _input_specs(cfg, shape, init_cache)

    return Model(cfg, init, train_loss, logits, prefill, decode_step,
                 init_cache, input_specs)


# ------------------------------------------------------------------- whisper
def _build_encdec(cfg: ArchConfig, remat: str, gather=None,
                  tp=None) -> Model:
    def init(generator: torch.Generator, experts=None, keep=None):
        """Random weights, drawn from ``generator`` on its device;
        ``keep`` as the LM family's (:func:`encdec.init_encdec`), and
        ``experts`` unread (no MoE layer)."""
        return E.init_encdec(generator, cfg, keep)

    def logits(params, batch):
        params = _outside(params, gather, ("enc", "dec"))
        enc_out = E.encode(params, cfg, _context(params, batch), remat,
                           gather, tp)
        return E.decode_train(params, cfg, _tokens(params, batch), enc_out,
                              remat, gather, tp)

    def train_loss(params, batch):
        _tokens_all, inputs, labels = _split_tokens(params, batch)
        lg = logits(params, {"tokens": inputs,
                             "context": _context(params, batch)})
        loss = _xent(lg, labels)
        return loss, {"xent": loss}

    def init_cache(batch_size, s_max, device=None):
        return E.init_cache(cfg, batch_size, s_max, resolve_device(device))

    def prefill(params, batch, s_max):
        params = _outside(params, gather, ("enc", "dec"))
        tokens = _tokens(params, batch)
        lg, cache = E.prefill(params, cfg, tokens, _context(params, batch),
                              s_max, gather, tp)
        return lg, cache, _last_pos(tokens)

    def decode_step(params, token, cache, pos, batch=None):
        params = _outside(params, gather, ("enc", "dec"))
        return E.decode_step(params, cfg,
                             _tokens(params, {"tokens": token}), cache, pos,
                             gather, tp)

    def input_specs(shape: ShapeConfig):
        return _input_specs(cfg, shape, init_cache)

    return Model(cfg, init, train_loss, logits, prefill, decode_step,
                 init_cache, input_specs)


# --------------------------------------------------------------------- rwkv6
def _build_rwkv(cfg: ArchConfig, remat: str, gather=None,
                tp=None) -> Model:
    def init(generator: torch.Generator, experts=None, keep=None):
        """Random weights, drawn from ``generator`` on its device: an untied
        embedding and head, ``ln0`` before the first block.  ``keep`` as
        the LM family's, on ``("embed",)``, ``("ln0",)``, each
        ``("layers", i)`` and ``("final_norm",)``; ``experts`` unread."""
        keep = keep or _as_drawn
        dev = generator.device
        p = {"embed": keep(("embed",), init_embedding(
            generator, cfg.vocab, cfg.d_model, cfg.dtype_, False))}
        p["ln0"] = keep(("ln0",), init_layernorm(cfg.d_model, dev))
        p["layers"] = W.init_rwkv_stack(generator, cfg, keep)
        p["final_norm"] = keep(("final_norm",),
                               init_rmsnorm(cfg.d_model, dev))
        return p

    def _embed_in(params, tokens):
        return layernorm(params["ln0"], embed(params["embed"], tokens, tp),
                         cfg.norm_eps)

    def _hidden(params, tokens, states=None):
        return W.apply_rwkv_stack(params["layers"], cfg,
                                  _embed_in(params, tokens), states, gather,
                                  tp)

    def _logits(params, tokens):
        x = W.apply_rwkv_train(params["layers"], cfg,
                               _embed_in(params, tokens), remat, gather, tp)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, False, tp)

    def logits(params, batch):
        params = _outside(params, gather)
        return _logits(params, _tokens(params, batch))

    def train_loss(params, batch):
        params = _outside(params, gather)
        _tokens_all, inputs, labels = _split_tokens(params, batch)
        loss = _xent(_logits(params, inputs), labels)
        return loss, {"xent": loss}

    def init_cache(batch_size, s_max, device=None):
        return W.init_rwkv_caches(cfg, batch_size, resolve_device(device))

    def prefill(params, batch, s_max):
        params = _outside(params, gather)
        tokens = _tokens(params, batch)
        x, states = _hidden(params, tokens)
        x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return unembed(params["embed"], x, False, tp)[:, 0], states, \
            _last_pos(tokens)

    def decode_step(params, token, states, pos, batch=None):
        params = _outside(params, gather)
        x, states = _hidden(params, _tokens(params, {"tokens": token}),
                            states)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], x, False, tp)[:, 0], states

    def input_specs(shape: ShapeConfig):
        return _input_specs(cfg, shape, init_cache)

    return Model(cfg, init, train_loss, logits, prefill, decode_step,
                 init_cache, input_specs)
