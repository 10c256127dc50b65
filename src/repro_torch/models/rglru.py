"""Griffin/RecurrentGemma recurrent block (arXiv:2402.19427), the
counterpart of ``repro/models/rglru.py``.

recurrent branch: linear → causal depthwise conv1d(4) → RG-LRU
gate branch:      linear → GeLU
merged:           gate ⊙ rec → output linear

RG-LRU: r_t = σ(W_a x_t), i_t = σ(W_x x_t),
        log a_t = -c · softplus(Λ) · r_t   (c = 8)
        h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The full-sequence form (prefill and training) runs the scan through
:class:`~repro_torch.kernels.rglru_scan.RGLRUScan`: forward
:func:`~repro_torch.kernels.rglru_scan.rglru_scan` and backward
:func:`~repro_torch.kernels.rglru_scan.rglru_scan_bwd` (the CUDA kernels on
the card, their plain versions on the CPU), the reference's ``kref.rglru``
and its vjp, which its trainer runs; decode is the one-step update written
out in float32.  The reference's
casts are kept: the gates multiply in the model dtype before their float32
cast, the scan's inputs are cast to the model dtype in prefill, and decode
keeps ``log_a`` in float32.

Tensor parallelism (the process binding's ``tp``): a rank holds its
channels of the recurrent width W — ``wx_rec`` / ``wx_gate`` / ``conv_w``
columns, the gates' and conv's vectors, ``wo``'s rows — so the conv, the
gates and the scan run on W / P channels, the state is the rank's
channels, and ``tp.psum`` adds the ranks' partial ``wo`` products; the
input enters through ``tp.copy``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.rglru_scan import RGLRUScan
from .layers import dense_init

_C = 8.0


def init_rglru(gen, cfg: ArchConfig):
    d = cfg.d_model
    w = cfg.hybrid.lru_width or d
    dt, dev = cfg.dtype_, gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    # Λ init so a ∈ [0.9, 0.999] at r = 1 (paper appendix), from the same
    # numpy draw as the reference
    u = np.random.RandomState(0).uniform(0.9 ** 2, 0.999 ** 2, size=(w,))
    lam = np.log(np.expm1(-np.log(u) / (2 * _C)))  # softplus^-1
    return {
        "wx_rec": dense_init(gen, d, w, dt),
        "wx_gate": dense_init(gen, d, w, dt),
        "conv_w": normal((cfg.hybrid.conv_width, w), 0.1),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "w_a": normal((w,), 0.1),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_i": normal((w,), 0.1),
        "b_i": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lam": torch.tensor(lam, dtype=torch.float32, device=dev),
        "wo": dense_init(gen, w, d, dt),
    }


class RecState(NamedTuple):
    h: torch.Tensor       # (B, W) RG-LRU hidden, float32
    conv: torch.Tensor    # (B, conv_width-1, W) trailing inputs


def init_rec_state(cfg: ArchConfig, batch: int, device) -> RecState:
    w = cfg.hybrid.lru_width or cfg.d_model
    return RecState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.hybrid.conv_width - 1, w),
                         dtype=cfg.dtype_, device=device))


def _causal_conv(params, x, history=None):
    """Depthwise causal conv1d.  x (B, S, W); history (B, cw-1, W).  Returns
    (out, the last cw-1 inputs as the next call's history)."""
    cw = params["conv_w"].shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * params["conv_w"][i]
              for i in range(cw))
    return out + params["conv_b"], xp[:, -(cw - 1):]


def _gates(params, xr):
    r = torch.sigmoid((xr * params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid((xr * params["w_i"]).float() + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r
    return log_a, i


def rglru_block(params, x, tp=None):
    """Full-sequence forward.  x (B, S, d) → (y (B, S, d), RecState); with
    ``tp`` the rank's channels, summed over ``model``."""
    if tp is not None:
        x = tp.copy(x)
    xg = F.gelu(x @ params["wx_gate"], approximate="tanh")
    xr, conv_hist = _causal_conv(params, x @ params["wx_rec"])
    log_a, i_gate = _gates(params, xr)
    gated_in = (i_gate * xr.float()).to(x.dtype)
    y, h_fin = RGLRUScan.apply(gated_in, log_a.to(x.dtype))
    out = (y * xg) @ params["wo"]
    return (out if tp is None else tp.psum(out)), \
        RecState(h=h_fin, conv=conv_hist)


def rglru_block_decode(params, x, state: RecState, tp=None):
    """One-token decode.  x (B, 1, d) → (y (B, 1, d), new RecState); with
    ``tp`` as :func:`rglru_block`."""
    if tp is not None:
        x = tp.copy(x)
    xg = F.gelu(x @ params["wx_gate"], approximate="tanh")
    xr, conv_hist = _causal_conv(params, x @ params["wx_rec"],
                                 history=state.conv)
    log_a, i_gate = _gates(params, xr)
    la = log_a[:, 0]
    a = torch.exp(la)
    gate = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=0.0))
    h = a * state.h + gate * (i_gate[:, 0] * xr[:, 0].float())
    y = (h.to(x.dtype) * xg[:, 0])[:, None] @ params["wo"]
    return (y if tp is None else tp.psum(y)), RecState(h=h, conv=conv_hist)
