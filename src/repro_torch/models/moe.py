"""Mixture-of-Experts block, the counterpart of the local path of
``repro/models/moe.py``: top-k routing, capacity dispatch into (E, C) slots,
the expert FFN, combine, an optional shared expert, and the Switch-style
load-balance loss.

The expert FFN runs its three products (gate, up, wo) through the grouped
matmul :func:`~repro_torch.kernels.moe_gmm.gmm` over the (E·C, d) slot rows
with ``block_t = C`` and ``block_expert = arange(E)``: the same function as
the reference's batched einsums, which its module docstring names the
moe_gmm kernel's job.  On a CUDA tensor that is the hand-written kernel; on
a CPU tensor its plain version.  ``moe_block_local`` also hands it each
expert's kept assignments, min(#assigned, C), counted on the device
(:func:`expert_rows`): expert e's slots past that count are zero rows
(``dispatch`` fills only kept slots), so its outputs there are zeros, and
the kernel writes them without reading the weights.  An expert with no
token costs no weight bytes; in a decode step most hold none.

Capacity semantics are the reference's: each expert accepts at most
C = ceil(T·k/E · capacity_factor) tokens, rounded up to 8; an assignment
past its expert's capacity is dropped, goes to the sentinel slot E·C, and
contributes zero.  The expert-parallel ``moe_block_a2a`` comes with
ROADMAP Queue A item 9 on the stacked binding, and across cards with the
port's distributed binding (item 12).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoEConfig
from ..kernels.moe_gmm import gmm
from .layers import dense_init, init_mlp, mlp


def init_moe(gen, cfg: ArchConfig):
    mo = cfg.moe
    d, f, E, dt = cfg.d_model, mo.d_ff_expert, mo.n_experts, cfg.dtype_
    p = {"router": dense_init(gen, d, E, torch.float32),
         "experts": {"wi_gate": _expert_init(gen, E, d, f, dt),
                     "wi_up": _expert_init(gen, E, d, f, dt),
                     "wo": _expert_init(gen, E, f, d, dt)}}
    if mo.n_shared_experts:
        p["shared"] = init_mlp(gen, d, mo.d_ff_shared * mo.n_shared_experts,
                               dt)
    return p


def _expert_init(gen, e, d_in, d_out, dtype):
    """(e, d_in, d_out) normal / sqrt(d_in), drawn one expert at a time into
    the result: the float32 draw of a whole leaf would be 21.5 GB at
    llama4-maverick's widths, twice over with its scaled copy."""
    w = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(e):
        w[i] = dense_init(gen, d_in, d_out, dtype)
    return w


def capacity(T: int, mo: MoEConfig) -> int:
    """Slots per expert for T tokens: the reference's float expression,
    rounded up to a multiple of 8 and at least 8."""
    c = int(np.ceil(T * mo.top_k / mo.n_experts * mo.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(params, x, mo: MoEConfig):
    """x (T, d) → (weights (T, k) in x's dtype, experts (T, k), router logits
    (T, E) float32): top-k of the float32 logits, softmax over the k."""
    logits = x.float() @ params["router"]
    weights, experts = torch.topk(logits, mo.top_k, dim=-1)
    weights = torch.softmax(weights, dim=-1)
    return weights.to(x.dtype), experts, logits


def dispatch(x, experts, weights, E: int, C: int):
    """Scatter tokens into per-expert capacity slots.  x (T, d); experts and
    weights (T, k).  Returns x_send (E, C, d), slot_of (T, k) (E·C ⇒
    dropped) and the kept weights (T, k).  An assignment's position in its
    expert is the exclusive cumulative count in (token, slot) order, so the
    same assignments are dropped as in the reference."""
    T, k = experts.shape
    flat_e = experts.reshape(-1).long()
    onehot = F.one_hot(flat_e, E).to(torch.int32)           # (T·k, E)
    pos_in_e = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    token_of = torch.arange(T, device=x.device).repeat_interleave(k)
    x_send = torch.zeros((E * C + 1, x.shape[1]), dtype=x.dtype,
                         device=x.device)
    # every dropped assignment lands on the sentinel row, sliced off below
    x_send[slot] = x[token_of]
    kept_w = weights * keep.reshape(T, k).to(weights.dtype)
    return x_send[:-1].reshape(E, C, -1), slot.reshape(T, k), kept_w


def combine(y_recv, slot_of, kept_w, T: int):
    """Gather expert outputs back to tokens.  y_recv (E, C, dv) → (T, dv):
    the kept weights times each token's slot rows, summed over its k (a
    dropped assignment reads the zero sentinel row)."""
    E, C, dv = y_recv.shape
    flat = torch.cat([y_recv.reshape(E * C, dv),
                      y_recv.new_zeros((1, dv))])
    picked = flat[slot_of.reshape(-1)].reshape(T, -1, dv)
    return torch.einsum("tkd,tk->td", picked, kept_w)


def expert_rows(slot_of, E: int, C: int):
    """Kept assignments per expert, min(#assigned, C), as an (E,) int32
    tensor on the device: a scatter-add of each assignment's slot // C into
    E + 1 buckets, where the dropped ones (slot E·C) land in the last.  No
    value is read on the host."""
    flat = slot_of.reshape(-1)
    counts = torch.zeros(E + 1, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat // C, torch.ones_like(flat,
                                                      dtype=torch.int32))
    return counts[:E]


def expert_ffn(eparams, x_e, act="silu", rows=None):
    """Batched expert MLP.  x_e (E, N, d) → (E, N, d): three grouped matmuls
    over the E·N slot rows, block i of N rows on expert i.  ``rows`` (E,)
    or None: expert i's rows past ``rows[i]`` come out zero (None: every
    row counts)."""
    E, N, d = x_e.shape
    flat = x_e.reshape(E * N, d)
    experts = torch.arange(E, dtype=torch.int32, device=x_e.device)
    gate = gmm(flat, eparams["wi_gate"], experts, N, rows)
    up = gmm(flat, eparams["wi_up"], experts, N, rows)
    g = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return gmm(g * up, eparams["wo"], experts, N, rows).reshape(E, N, -1)


def moe_block_local(params, x, cfg: ArchConfig):
    """Single-shard MoE forward (all experts local).  x (B, S, d) → (out (B,
    S, d), load-balance loss)."""
    mo = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    w, e, logits = route(params, xt, mo)
    C = capacity(B * S, mo)
    x_send, slot, kept_w = dispatch(xt, e, w, mo.n_experts, C)
    y = expert_ffn(params["experts"], x_send, cfg.act,
                   expert_rows(slot, mo.n_experts, C))
    out = combine(y, slot, kept_w, B * S)
    if mo.n_shared_experts:
        out = out + mlp(params["shared"], xt, cfg.act)
    aux = load_balance_loss(logits, e, mo)
    return out.reshape(B, S, d), aux


def load_balance_loss(logits, experts, mo: MoEConfig):
    """Switch-style auxiliary load-balance loss: E · Σ_e (fraction of tokens
    whose first choice is e) · (mean router probability of e)."""
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(experts[:, 0].long(), mo.n_experts).float().mean(0)
    return mo.n_experts * torch.sum(frac * probs.mean(0))
