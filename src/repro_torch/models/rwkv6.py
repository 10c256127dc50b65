"""RWKV-6 "Finch" blocks (arXiv:2404.05892), the counterpart of
``repro/models/rwkv6.py``: attention-free token mixing with a
data-dependent per-channel decay, and squared-ReLU channel mixing.

Time mixing (per layer):
  token shift  x'_t = lerp(x_t, x_{t-1}, μ_*)  per projection
  r, k, v, g   linear projections (g gated through silu)
  w_t          data-dependent decay: w = exp(-exp(w0 + tanh(x'_w A) B))
  wkv          the WKV6 recurrence
  out          groupnorm(per head) → ⊙ silu(g) → output linear

Channel mixing: token shift, k = relu(x' Wk)², out = σ(x' Wr) ⊙ (k Wv).

Prefill runs the WKV through :func:`~repro_torch.kernels.wkv6.wkv6` (the
CUDA kernel on the card, its plain version on the CPU) from a zero state,
as the reference's serving branch (``impl="pallas"``) does: v, w and u are
cast to r's dtype first.  Training (:func:`apply_rwkv_train`, which
``logits`` also runs) follows the reference's training form,
``wkv6_chunked``: r, k and v upcast exactly to float32, w and u float32 as
they are (never rounded to r's dtype), the WKV through
:class:`~repro_torch.kernels.wkv6.WKV6Train` (the float32 sequential kernel
and its hand-written backward on the card), y cast to r's dtype after it.
Decode is the one-token recurrence written out in float32 from the carried
state.

Tensor parallelism (the process binding's ``tp``): the time mix runs on
the rank's heads — ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``w_lora_b``
columns, ``w0``, ``u`` and ``ln_x`` of those heads, the WKV and its
state on them — and ``tp.psum`` adds the ranks' partial ``wo``
products; the channel mix on the rank's columns of ``d_ff`` (``wk``'s
columns, ``wv``'s rows, summed) with the receptance, whose ``wr`` the
rank holds a column block of, gathered whole over ``model`` before it
gates the sum.  The mixing vectors ``mu`` and ``w_lora_a`` are whole, and
so is every input (``tp.copy``) and the shift states.  Head counts are
read from the weights (``u``), not the config.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.wkv6 import WKV6Train, wkv6
from .layers import dense_init, init_layernorm, layernorm, remat_call

_DECAY_LORA = 64


def init_time_mix(gen, cfg: ArchConfig):
    d, dt, dev = cfg.d_model, cfg.dtype_, gen.device
    hd = cfg.n_heads * cfg.head_dim_
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),  # r,k,v,w,g
        "wr": dense_init(gen, d, hd, dt),
        "wk": dense_init(gen, d, hd, dt),
        "wv": dense_init(gen, d, hd, dt),
        "wg": dense_init(gen, d, hd, dt),
        "w0": torch.full((hd,), -4.0, dtype=torch.float32, device=dev),
        "w_lora_a": dense_init(gen, d, _DECAY_LORA, dt),
        "w_lora_b": dense_init(gen, _DECAY_LORA, hd, dt),
        "u": torch.randn((cfg.n_heads, cfg.head_dim_), generator=gen,
                         device=dev, dtype=torch.float32) * 0.1,
        "ln_x": init_layernorm(hd, dev),
        "wo": dense_init(gen, hd, d, dt),
    }


def init_channel_mix(gen, cfg: ArchConfig):
    d, dt = cfg.d_model, cfg.dtype_
    return {
        "mu": torch.full((2, d), 0.5, dtype=dt, device=gen.device),  # k, r
        "wk": dense_init(gen, d, cfg.d_ff, dt),
        "wv": dense_init(gen, cfg.d_ff, d, dt),
        "wr": dense_init(gen, d, d, dt),
    }


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, D, D) float32
    shift_t: torch.Tensor   # (B, d) last input of the time-mix sublayer
    shift_c: torch.Tensor   # (B, d) last input of the channel-mix sublayer


def init_rwkv_state(cfg: ArchConfig, batch: int, device) -> RWKVState:
    hd = cfg.head_dim_
    return RWKVState(
        wkv=torch.zeros((batch, cfg.n_heads, hd, hd), dtype=torch.float32,
                        device=device),
        shift_t=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype_,
                            device=device),
        shift_c=torch.zeros((batch, cfg.d_model), dtype=cfg.dtype_,
                            device=device))


def _groupnorm_heads(params, y, H, hd, eps=64e-5):
    """RWKV's GroupNorm with one group per head."""
    B, S, _ = y.shape
    y4 = y.reshape(B, S, H, hd).float()
    mu = y4.mean(-1, keepdim=True)
    var = y4.var(-1, unbiased=False, keepdim=True)
    yn = (y4 - mu) * torch.rsqrt(var + eps)
    yn = yn * params["scale"].reshape(H, hd) + params["bias"].reshape(H, hd)
    return yn.reshape(B, S, H * hd).to(y.dtype)


def _token_shift(x, prev):
    """x (B, S, d) → x shifted right by one; position 0 sees ``prev``."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _decay(params, xw):
    """Data-dependent decay in (0, 1), float32."""
    delta = torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    return torch.exp(-torch.exp(params["w0"] + delta.float()))


def _wkv6_step(r, k, v, w, u, s):
    """One token of the WKV from state ``s``, in float32.  r, k, v, w (B, H,
    D); u (H, D); s (B, H, D, D).  Returns (y (B, H, D) in r's dtype, new
    s)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    y = torch.einsum("bhi,bhij->bhj", rf, s) \
        + (rf * u.float() * kf).sum(-1, keepdim=True) * vf
    s = wf[..., None] * s + kf[..., None] * vf[..., None, :]
    return y.to(r.dtype), s


def time_mix(params, x, cfg: ArchConfig, state=None, train=False,
             tp=None):
    """x (B, S, d) → (out (B, S, d), wkv state (B, H, D, D), x[:, -1]).
    Without ``state`` the WKV starts from zero: in the serving form
    (prefill) through the kernel at r's dtype, with ``train`` in the
    training form (float32, :class:`WKV6Train`); with ``state`` (decode, S
    = 1) one step runs from ``state``.  With ``tp`` H is the rank's heads
    and the output is summed over ``model``."""
    B, S, d = x.shape
    H, hd = params["u"].shape
    if tp is not None:
        x = tp.copy(x)
    prev = state.shift_t if state is not None else x.new_zeros((B, d))
    xs = _token_shift(x, prev)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = (xr @ params["wr"]).reshape(B, S, H, hd)
    k = (xk @ params["wk"]).reshape(B, S, H, hd)
    v = (xv @ params["wv"]).reshape(B, S, H, hd)
    g = xg @ params["wg"]
    w = _decay(params, xw).reshape(B, S, H, hd)
    if state is None and train:
        rt, kt, vt, wt = (t.transpose(1, 2) for t in (r, k, v, w))
        y, s_fin = WKV6Train.apply(rt.float(), kt.float(), vt.float(), wt,
                                   params["u"])
        y = y.to(r.dtype).transpose(1, 2)
    elif state is None:
        rt, kt, vt, wt = (t.transpose(1, 2) for t in (r, k, v, w))
        y, s_fin = wkv6(rt, kt, vt.to(r.dtype), wt.to(r.dtype),
                        params["u"].to(r.dtype))
        y = y.transpose(1, 2)
    else:
        y, s_fin = _wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                              params["u"], state.wkv)
        y = y[:, None]
    y = _groupnorm_heads(params["ln_x"], y.reshape(B, S, H * hd), H, hd)
    out = (y * F.silu(g)) @ params["wo"]
    return (out if tp is None else tp.psum(out)), s_fin, x[:, -1]


def channel_mix(params, x, state=None, tp=None):
    """x (B, S, d) → (out (B, S, d), x[:, -1]); with ``tp`` the rank's
    columns of ``d_ff`` summed, gated by the receptance gathered whole."""
    B, S, d = x.shape
    if tp is not None:
        x = tp.copy(x)
    prev = state.shift_c if state is not None else x.new_zeros((B, d))
    xs = _token_shift(x, prev)
    mu = params["mu"]
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(xk @ params["wk"]))
    r = torch.sigmoid(xr @ params["wr"])
    kv = k @ params["wv"]
    if tp is not None:
        r, kv = tp.gather(r, -1), tp.psum(kv)
    return r * kv, x[:, -1]


# ------------------------------------------------------------------ the stack
def init_rwkv_block(gen, cfg: ArchConfig):
    return {"ln1": init_layernorm(cfg.d_model, gen.device),
            "time": init_time_mix(gen, cfg),
            "ln2": init_layernorm(cfg.d_model, gen.device),
            "chan": init_channel_mix(gen, cfg)}


def init_rwkv_stack(gen, cfg: ArchConfig, keep=None) -> List[dict]:
    """Every block's parameters; ``keep(path, block)``, where given, takes
    each as soon as it is drawn (path ``("layers", i)``) and returns what
    the list holds in its place."""
    return [init_rwkv_block(gen, cfg) if keep is None else
            keep(("layers", i), init_rwkv_block(gen, cfg))
            for i in range(cfg.n_layers)]


def init_rwkv_caches(cfg: ArchConfig, batch: int, device) -> List[RWKVState]:
    return [init_rwkv_state(cfg, batch, device) for _ in range(cfg.n_layers)]


def apply_rwkv_block(p, cfg: ArchConfig, x, state=None, train=False,
                     gather=None, tp=None):
    """One block over x (B, S, d): prefill from zero state (``state`` None;
    ``train``: the WKV's training form) or one decode step.  Returns (x',
    RWKVState); the shift states are the *normalised* sublayer inputs' last
    tokens.  ``gather`` (fsdp) takes the block's parameters — the time mix
    and the channel mix — whole first; ``tp`` runs both tensor-parallel."""
    if gather is not None:
        p = gather(p)
    h, s_fin, sh_t = time_mix(p["time"], layernorm(p["ln1"], x, cfg.norm_eps),
                              cfg, state, train, tp)
    x = x + h
    h, sh_c = channel_mix(p["chan"], layernorm(p["ln2"], x, cfg.norm_eps),
                          state, tp)
    return x + h, RWKVState(wkv=s_fin, shift_t=sh_t, shift_c=sh_c)


def apply_rwkv_stack(layers, cfg: ArchConfig, x, states=None, gather=None,
                     tp=None):
    """x (B, S, d), already through ``ln0`` → (hidden, per-layer states):
    prefill without ``states``, a decode step with them; ``gather`` (fsdp)
    takes each block's parameters whole as it runs; ``tp`` the
    tensor-parallel path."""
    new = []
    for i, p in enumerate(layers):
        x, st = apply_rwkv_block(p, cfg, x,
                                 None if states is None else states[i],
                                 gather=gather, tp=tp)
        new.append(st)
    return x, new


def _train_block(p, cfg: ArchConfig, x, gather=None, tp=None):
    return apply_rwkv_block(p, cfg, x, train=True, gather=gather, tp=tp)[0]


def apply_rwkv_train(layers, cfg: ArchConfig, x, remat: str = "block",
                     gather=None, tp=None):
    """x (B, S, d), already through ``ln0`` → the final hidden states, each
    block recomputed in the backward pass under ``remat`` ``"block"`` or
    ``"full"`` (the reference's ``apply_rwkv_train``); ``gather`` (fsdp)
    runs inside each block's ``remat`` region, so the block's gathered
    weights are freed after it and gathered again for its backward; ``tp``
    the tensor-parallel path."""
    for p in layers:
        x = remat_call(remat, _train_block, p, cfg, x, gather, tp)
    return x
