"""Decoder-only transformer stack, the counterpart of the dense, hybrid,
MoE (GQA and MLA) and vlm plans of ``repro/models/transformer.py``.

A stack is a flat list of block kinds (:func:`layer_kinds`), in the
reference's layer order: ``attn × L`` for the dense family; for the hybrid
family (recurrentgemma) ``[rec, rec, local] × n`` followed by the ``rec``
layers left over; for an MoE config, with mixer ``m`` = ``mla`` where the
config has MLA dims and ``attn`` otherwise, ``[m_dense] × (moe_every_k -
1) + [m_moe]`` repeated (llama4: ``[attn_dense, attn_moe] × L/2``), or,
where ``moe_every_k`` is 1, ``[m_dense] × first_k_dense`` followed by
``m_moe`` layers (deepseek-v3: ``[mla_dense] × 3 + [mla_moe] × 58``); for
the vlm family ``[attn × (k − 1), cross] × L/k`` with k =
``cross.every_k`` (llama-3.2-vision: ``[attn × 4, cross] × 8``).  The
reference scans stacked ``(n, …)`` parameters per superblock position with
``layer_scan``; the port keeps one parameter dict per layer in a list and
loops over it in Python.

Kinds: ``attn`` / ``attn_dense`` / ``attn_moe`` (causal GQA attention),
``mla_dense`` / ``mla_moe`` (causal MLA, with an :class:`MLACache` of the
compressed latents; no window), ``local`` (attention over the last
``hybrid.window`` keys, with a ring-buffer decode cache of ``min(s_max,
window)`` slots), ``rec`` (the RG-LRU block with a :class:`RecState`
cache) and ``cross`` (gated cross-attention over the context: k and v
projected from the context, no RoPE, not causal; both sublayers scaled by
``tanh`` of the layer's float32 ``gate_attn`` / ``gate_ffn`` scalars; its
decode cache is the context's k/v, ``n_ctx`` slots filled at prefill and
never written).  Each is followed by its FFN: the MoE block for ``*_moe``
kinds, else the gated MLP (``d_ff_dense`` wide in an MoE config).  Blocks
take the context (``context``, (B, n_ctx, d)) as an argument; only the
cross kind reads it.

Training runs :func:`apply_stack_train`: every block returns its MoE
load-balance loss beside its output, as the reference's
``apply_block_train`` does, and ``remat`` checkpoints each block
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  Serving's
:func:`apply_block_train` and :func:`fill_stack_cache` return the decode
cache in the loss's place.  :func:`layer_stacks` says which layers the
reference stores as one stacked leaf, which its Adafactor sees.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import attention as A
from . import moe as M
from . import rglru as R
from .layers import init_mlp, init_rmsnorm, mlp, remat_call, rmsnorm


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """Every layer's block kind, in order."""
    if cfg.family == "hybrid":
        period = cfg.hybrid.pattern_period
        block = ["rec"] * (period - 1) + ["local"]
        n = cfg.n_layers // period
        return block * n + ["rec"] * (cfg.n_layers - n * period)
    if cfg.family == "vlm":
        k = cfg.cross.every_k
        if cfg.n_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                             f"multiple of cross.every_k {k}")
        return (["attn"] * (k - 1) + ["cross"]) * (cfg.n_layers // k)
    mo = cfg.moe
    if mo is not None:
        mixer = "mla" if cfg.mla is not None else "attn"
        if mo.moe_every_k > 1:
            if cfg.n_layers % mo.moe_every_k:
                raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not "
                                 f"a multiple of moe_every_k "
                                 f"{mo.moe_every_k}")
            block = [f"{mixer}_dense"] * (mo.moe_every_k - 1) \
                + [f"{mixer}_moe"]
            return block * (cfg.n_layers // mo.moe_every_k)
        return [f"{mixer}_dense"] * mo.first_k_dense \
            + [f"{mixer}_moe"] * (cfg.n_layers - mo.first_k_dense)
    return ["attn"] * cfg.n_layers


def layer_stacks(cfg: ArchConfig) -> List[List[int]]:
    """The layers the reference stacks into one ``(n, …)`` leaf per
    parameter (its layer plan's superblock positions, ``n`` ≥ 1), as lists
    of indices into :func:`layer_kinds`; prefix and suffix layers, which
    the reference keeps unstacked, are in none."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        period = cfg.hybrid.pattern_period
        n = L // period
    elif cfg.family == "vlm":
        period = cfg.cross.every_k
        n = L // period
    elif cfg.moe is not None and cfg.moe.moe_every_k > 1:
        period, n = cfg.moe.moe_every_k, L // cfg.moe.moe_every_k
    elif cfg.moe is not None:
        first = cfg.moe.first_k_dense
        return [list(range(first, L))] if L > first else []
    else:
        period, n = 1, L
    return [[pos + period * i for i in range(n)]
            for pos in range(period)] if n > 0 else []


def _is_mla(kind: str) -> bool:
    return kind.startswith("mla")


def _is_moe(kind: str) -> bool:
    return kind.endswith("_moe")


def _window(cfg: ArchConfig, kind: str):
    return cfg.hybrid.window if kind == "local" else None


def _ffn_width(cfg: ArchConfig) -> int:
    """A dense layer's FFN width: ``d_ff_dense`` (else ``d_ff``) in an MoE
    config."""
    if cfg.moe is not None:
        return cfg.moe.d_ff_dense or cfg.d_ff
    return cfg.d_ff


def init_block(gen, cfg: ArchConfig, kind: str, experts=None):
    """One layer's parameters; ``experts`` (lo, hi), where given, keeps an
    MoE layer's experts lo … hi − 1 (:func:`moe.init_moe`)."""
    p = {"ln1": init_rmsnorm(cfg.d_model, gen.device),
         "ln2": init_rmsnorm(cfg.d_model, gen.device)}
    if kind == "rec":
        p["temporal"] = R.init_rglru(gen, cfg)
    elif _is_mla(kind):
        p["attn"] = A.init_mla(gen, cfg)
    elif kind == "cross":
        p["attn"] = A.init_attention(gen, cfg)
        p["gate_attn"] = torch.zeros((), dtype=torch.float32,
                                     device=gen.device)
        p["gate_ffn"] = torch.zeros((), dtype=torch.float32,
                                    device=gen.device)
    else:
        p["attn"] = A.init_attention(gen, cfg)
    if _is_moe(kind):
        p["ffn"] = M.init_moe(gen, cfg, experts)
    else:
        p["ffn"] = init_mlp(gen, cfg.d_model, _ffn_width(cfg),
                            cfg.dtype_)
    return p


def _apply_ffn(params, cfg: ArchConfig, kind: str, h, moe_fn=None,
               tp=None):
    """The block's FFN on h (B, S, d) → (out, the MoE block's load-balance
    loss, or None for a dense FFN).  ``moe_fn(ffn_params, h, cfg)``, where
    given, takes an MoE layer's place of :func:`moe.moe_block_local` (the
    expert-parallel block, :func:`repro_torch.distributed.moe_ep.
    make_moe_fn`); ``tp`` makes the dense FFN tensor-parallel."""
    if _is_moe(kind):
        if moe_fn is not None:
            return moe_fn(params["ffn"], h, cfg)
        return M.moe_block_local(params["ffn"], h, cfg)
    return mlp(params["ffn"], h, cfg.act, tp), None


def _gate(params, name, x, out):
    """A cross layer's sublayer output scaled by ``tanh`` of its float32
    gate, cast to the activations' dtype first, as the reference does."""
    return torch.tanh(params[name]).to(x.dtype) * out


def _block(params, cfg: ArchConfig, kind: str, x, positions, context,
           moe_fn=None, tp=None):
    """x (B, S, d) → (x', the mixer's cache, the FFN's aux loss or None);
    ``tp`` (the process binding's tensor-parallel path) reaches every
    mixer and the dense FFN.  A cross layer's gates scale the summed
    output, so they stay whole."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        out, cache = R.rglru_block(params["temporal"], h, tp)
    elif _is_mla(kind):
        out, cache = A.mla_attention(params["attn"], cfg, h,
                                     positions=positions, tp=tp)
    elif kind == "cross":
        if context is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             f"the batch's context")
        out, cache = A.attention(params["attn"], cfg, h, kv_x=context,
                                 use_rope=False, tp=tp)
        out = _gate(params, "gate_attn", x, out)
    else:
        out, cache = A.attention(params["attn"], cfg, h, positions=positions,
                                 window=_window(cfg, kind), tp=tp)
    x = x + out
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    f_out, aux = _apply_ffn(params, cfg, kind, h, moe_fn, tp)
    if kind == "cross":
        f_out = _gate(params, "gate_ffn", x, f_out)
    return x + f_out, cache, aux


def apply_block_train(params, cfg: ArchConfig, kind: str, x, positions=None,
                      context=None, moe_fn=None, tp=None):
    """x (B, S, d) → (x', cache).  Where the reference returns an auxiliary
    loss, the port's serving block returns what prefill stores as the
    decode cache: the attention's rotated k/v (a cross layer's: the
    context's), MLA's compressed latents, or the recurrent block's final
    :class:`RecState` (:func:`train_block` returns the loss)."""
    x, cache, _aux = _block(params, cfg, kind, x, positions, context,
                            moe_fn, tp)
    return x, cache


def train_block(params, cfg: ArchConfig, kind: str, x, positions=None,
                context=None, moe_fn=None, tp=None, gather=None):
    """x (B, S, d) → (x', aux), the reference's ``apply_block_train``: aux
    is the MoE block's load-balance loss, a float32 zero for the others.
    ``tp``: the tensor-parallel path; ``gather``: fsdp's gather of the
    block's data-sharded parameters, applied first."""
    if gather is not None:
        params = gather(params)
    x, _cache, aux = _block(params, cfg, kind, x, positions, context,
                            moe_fn, tp)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def apply_stack_train(params, cfg: ArchConfig, x, remat: str = "block",
                      context=None, moe_fn=None, tp=None, gather=None):
    """The stack for training: x (B, S, d) → (x', sum of the blocks' aux
    losses).  ``remat`` ``"block"`` or ``"full"`` recomputes each block in
    the backward pass from its input (``torch.utils.checkpoint``,
    non-reentrant), as the reference's ``jax.checkpoint`` of each block;
    ``"none"`` keeps every activation.  ``context`` feeds the cross
    layers; ``moe_fn`` (:func:`_apply_ffn`) the MoE layers; ``tp`` the
    tensor-parallel layers; ``gather`` (fsdp) runs inside each block's
    ``remat`` region, so a block's gathered weights live while it runs
    and are gathered again for its backward."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(layer_kinds(cfg), params):
        x, aux = remat_call(remat, train_block, p, cfg, kind, x, None,
                            context, moe_fn, tp, gather)
        aux_total = aux_total + aux
    return x, aux_total


def apply_block_decode(params, cfg: ArchConfig, kind: str, x, cache, pos,
                       ctx_lengths=None, moe_fn=None, tp=None):
    """x (B, 1, d), pos (B,) → (x', cache); a GQA attention cache is
    updated in place, an MLA cache rewritten as the reference does, a cross
    layer's context cache read (through ``ctx_lengths``,
    :func:`~repro_torch.models.attention.context_lengths`) and returned as
    it is."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        out, cache = R.rglru_block_decode(params["temporal"], h, cache, tp)
    elif _is_mla(kind):
        out, cache = A.mla_decode(params["attn"], cfg, h, cache, pos, tp)
    elif kind == "cross":
        out = A.cross_attention_decode(params["attn"], cfg, h, cache,
                                       ctx_lengths, tp)
        out = _gate(params, "gate_attn", x, out)
    else:
        out, cache = A.attention_decode(params["attn"], cfg, h, cache, pos,
                                        window=_window(cfg, kind), tp=tp)
    x = x + out
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    f_out = _apply_ffn(params, cfg, kind, h, moe_fn, tp)[0]
    if kind == "cross":
        f_out = _gate(params, "gate_ffn", x, f_out)
    return x + f_out, cache


def _cache_slots(cfg: ArchConfig, kind: str, s_max: int) -> int:
    if kind == "cross":
        return cfg.cross.n_context_tokens
    return min(s_max, cfg.hybrid.window) if kind == "local" else s_max


def init_stack_cache(cfg: ArchConfig, batch: int, s_max: int, device):
    """Every layer's empty decode cache; a cross layer's holds
    ``cross.n_context_tokens`` slots."""
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "rec":
            caches.append(R.init_rec_state(cfg, batch, device))
            continue
        if _is_mla(kind):
            m = cfg.mla
            caches.append(A.MLACache(*(
                torch.zeros((batch, s_max, w), dtype=cfg.dtype_,
                            device=device)
                for w in (m.kv_lora_rank, m.qk_rope_head_dim))))
            continue
        shape = (batch, cfg.n_kv_heads, _cache_slots(cfg, kind, s_max),
                 cfg.head_dim_)
        caches.append(A.KVCache(
            torch.zeros(shape, dtype=cfg.dtype_, device=device),
            torch.zeros(shape, dtype=cfg.dtype_, device=device)))
    return caches


def apply_stack_decode(params, cfg: ArchConfig, x, caches, pos,
                       moe_fn=None, tp=None, gather=None):
    """One decode step through every layer; ``gather`` (fsdp) takes each
    layer's parameters whole as it runs, so one layer is resident at a
    time."""
    kinds = layer_kinds(cfg)
    ctx_lengths = A.context_lengths(caches[kinds.index("cross")]) \
        if "cross" in kinds else None
    new = []
    for kind, p, c in zip(kinds, params, caches):
        if gather is not None:
            p = gather(p)
        x, c = apply_block_decode(p, cfg, kind, x, c, pos, ctx_lengths,
                                  moe_fn, tp)
        new.append(c)
    return x, new


def fill_stack_cache(params, cfg: ArchConfig, x, s_max: int,
                     positions=None, context=None, moe_fn=None, tp=None,
                     gather=None):
    """Prefill: run the stack over the prompt, returning the final hidden
    states and every layer's decode cache: the recurrent state, MLA's
    latents zero-padded to ``s_max`` slots, a cross layer's k/v of the
    whole ``context``, or the k/v laid out in ``s_max`` (``min(s_max,
    window)`` for a local layer) slots.  ``gather`` as
    :func:`apply_stack_decode`'s."""
    caches = []
    for kind, p in zip(layer_kinds(cfg), params):
        if gather is not None:
            p = gather(p)
        x, c = apply_block_train(p, cfg, kind, x, positions, context,
                                 moe_fn, tp)
        if _is_mla(kind):
            c = _mla_prefill_cache(c, s_max)
        elif kind == "cross":
            c = A.KVCache(*(t.contiguous() for t in c))
        elif kind != "rec":
            c = _block_prefill_cache(c, _cache_slots(cfg, kind, s_max),
                                     ring=kind == "local")
        caches.append(c)
    return x, caches


def _mla_prefill_cache(c: A.MLACache, slots: int) -> A.MLACache:
    """MLA's decode cache from the prompt's (B, S, ·) latents: zero-padded
    to ``slots`` (MLA layers have no window, so no ring).  The reference
    recomputes the latents from the block input; the port reuses the
    attention's own (the same values)."""
    S = c.ckv.shape[1]
    if S > slots:
        raise ValueError(f"a {S}-token prompt does not fit a {slots}-slot "
                         f"cache")
    return A.MLACache(*(F.pad(t, (0, 0, 0, slots - S)) for t in c))


def _block_prefill_cache(kv: A.KVCache, slots: int, ring: bool) -> A.KVCache:
    """The decode cache from the prompt's k/v: zero-padded to ``slots``, or,
    for a ring buffer (``ring``) holding no more slots than the prompt has
    tokens, its last ``slots`` positions with position p at slot
    ``p % slots``.  The reference recomputes k/v from the block input; the
    port reuses the attention's own (the same values)."""
    B, H, S, D = kv.k.shape
    if ring and S >= slots:
        return A.KVCache(*(torch.roll(t[:, :, S - slots:], S % slots, dims=2)
                           for t in kv))
    if S > slots:
        raise ValueError(f"a {S}-token prompt does not fit a {slots}-slot "
                         f"cache")
    out = []
    for t in kv:
        c = torch.zeros((B, H, slots, D), dtype=t.dtype, device=t.device)
        c[:, :, :S] = t
        out.append(c)
    return A.KVCache(*out)
