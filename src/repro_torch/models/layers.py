"""Shared building blocks, the counterpart of ``repro/models/layers.py``.

Parameters are nested dicts of tensors with the reference's names and
layouts (a dense weight is (d_in, d_out)), so a JAX parameter tree carries
over leaf for leaf (:mod:`.convert`).  Initialisers take an explicit
``torch.Generator`` and allocate on its device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(gen: torch.Generator, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype):
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# ------------------------------------------------------------------- norms
def init_rmsnorm(d, device):
    # gemma-style (1 + w): the scale starts at zero, in float32
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"])).to(x.dtype)


def init_layernorm(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim, theta, device=None):
    """(head_dim/2,) float32 inverse frequencies, computed in float64 as the
    reference's numpy does, on ``device`` (no host-to-device copy, which
    would wait for the card's queue to drain)."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / theta ** (i / head_dim)).float()


def apply_rope(x, positions, theta=10000.0):
    """x (..., S, H, D); ``positions`` broadcastable to the S axis.  Rotates
    the interleaved pairs (x[2i], x[2i+1]) — not the half-split layout —
    with angles computed in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                     # head axis
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# -------------------------------------------------------------- gated MLPs
def init_mlp(gen, d, d_ff, dtype):
    return {"wi_gate": dense_init(gen, d, d_ff, dtype),
            "wi_up": dense_init(gen, d, d_ff, dtype),
            "wo": dense_init(gen, d_ff, d, dtype)}


def mlp(params, x, act="silu"):
    """SwiGLU (``act="silu"``) or GeGLU (``act="gelu"``, tanh-approximate
    GeLU): (act(x W_gate) · x W_up) W_o."""
    gate = x @ params["wi_gate"]
    g = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (g * (x @ params["wi_up"])) @ params["wo"]


def init_ffn_nogate(gen, d, d_ff, dtype):
    """Whisper-style two-matrix FFN."""
    return {"wi": dense_init(gen, d, d_ff, dtype),
            "wo": dense_init(gen, d_ff, d, dtype)}


def ffn_nogate(params, x):
    """gelu(x W_i) W_o with the tanh-approximate GeLU, as the reference's
    ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x @ params["wi"], approximate="tanh") @ params["wo"]


# --------------------------------------------------------------- embeddings
def init_embedding(gen, vocab, d, dtype, tie):
    p = {"table": embed_init(gen, vocab, d, dtype)}
    if not tie:
        p["head"] = dense_init(gen, d, vocab, dtype)
    return p


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x, tie):
    if tie:
        return x @ params["table"].T
    return x @ params["head"]


# -------------------------------------------------------------------- remat
REMAT = ("none", "block", "full")


def remat_call(remat: str, fn, *args):
    """``fn(*args)``; under ``remat`` ``"block"`` or ``"full"`` its
    activations are recomputed in the backward pass from ``args``
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` of a block; ``"none"`` keeps them."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none":
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)
