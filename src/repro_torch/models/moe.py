"""Mixture-of-Experts block, the counterpart of ``repro/models/moe.py``:
top-k routing, capacity dispatch into (E, C) slots,
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

Training differentiates the block as written: with grad enabled ``gmm``
runs through :class:`~repro_torch.kernels.moe_gmm.GroupedMatmul`, whose
backward launches the input-gradient and weight-gradient kernels with the
same block experts and row counts (dx is zero on the rows past a count,
dw reads none of them); every other op is PyTorch's and differentiable:
``dispatch``'s scatter (its backward a gather; the dropped assignments'
sentinel row is sliced off, so it takes no gradient), ``combine``'s
gather, the a2a path's index gathers (a received slot past its count is
filled from row 0 of the send buffer, and takes the zero dx of a row past
a count) and ``_expert_stack``'s view of the expanded leaf, whose
backward sums over the dp shards once, so each expert leaf gets its
gradient once.

Capacity semantics are the reference's: each expert accepts at most
C = ceil(T·k/E · capacity_factor) tokens, rounded up to 8; an assignment
past its expert's capacity is dropped, goes to the sentinel slot E·C, and
contributes zero.

``moe_block_a2a`` is the expert-parallel path on the stacked binding
(:mod:`repro_torch.core.runtime`): the reference's per-shard program under
``shard_map`` over ``model`` becomes one program over the leading (P_dp,
P_tp) shard dimensions, and each ``all_to_all`` over ``model`` a transpose
of the (source, destination) shard dimensions.  ``route``, ``dispatch``,
``combine``, ``expert_rows`` and ``load_balance_loss`` take any leading
shard dimensions, so each shard's routing and drops are the reference's.
The expert FFN then makes the same three ``gmm`` calls as the local path,
over every shard's experts at once, with each expert's received rows
compacted to the front of its block, so each live expert's weights are
read once a product however many sources sent it tokens.

``moe_block_a2a_rank`` is the same block on the process binding: one
rank's program, its all_to_alls between processes
(:func:`repro_torch.distributed.collectives.all_to_all`, its own adjoint
under autograd), so training differentiates it as written: gradients
flow back through both all_to_alls, the compaction's index gathers and
``GroupedMatmul`` on the rank's experts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoEConfig
from ..kernels.moe_gmm import gmm
from .layers import dense_init, init_mlp, mlp


def init_moe(gen, cfg: ArchConfig, experts=None):
    """The block's parameters; ``experts`` (lo, hi), where given, keeps
    experts lo … hi − 1 of each expert leaf and draws the others only to
    pass them (an expert-parallel rank's share, drawn as the whole block
    would be)."""
    mo = cfg.moe
    d, f, E, dt = cfg.d_model, mo.d_ff_expert, mo.n_experts, cfg.dtype_
    p = {"router": dense_init(gen, d, E, torch.float32),
         "experts": {"wi_gate": _expert_init(gen, E, d, f, dt, experts),
                     "wi_up": _expert_init(gen, E, d, f, dt, experts),
                     "wo": _expert_init(gen, E, f, d, dt, experts)}}
    if mo.n_shared_experts:
        p["shared"] = init_mlp(gen, d, mo.d_ff_shared * mo.n_shared_experts,
                               dt)
    return p


def _expert_init(gen, e, d_in, d_out, dtype, keep=None):
    """(e, d_in, d_out) normal / sqrt(d_in), drawn one expert at a time into
    the result: the float32 draw of a whole leaf would be 21.5 GB at
    llama4-maverick's widths, twice over with its scaled copy.  ``keep``
    (lo, hi) keeps experts lo … hi − 1 only, the others drawn and dropped,
    so the generator ends where the whole leaf's draw ends.  On the meta
    device (shapes only) nothing is drawn."""
    lo, hi = (0, e) if keep is None else keep
    w = torch.empty((hi - lo, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(e if w.device.type != "meta" else 0):
        drawn = dense_init(gen, d_in, d_out, dtype)
        if lo <= i < hi:
            w[i - lo] = drawn
    return w


def capacity(T: int, mo: MoEConfig) -> int:
    """Slots per expert for T tokens: the reference's float expression,
    rounded up to a multiple of 8 and at least 8."""
    c = int(np.ceil(T * mo.top_k / mo.n_experts * mo.capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(params, x, mo: MoEConfig):
    """x (..., T, d) → (weights (..., T, k) in x's dtype, experts (..., T,
    k), router logits (..., T, E) float32): top-k of the float32 logits,
    softmax over the k."""
    logits = x.float() @ params["router"]
    weights, experts = torch.topk(logits, mo.top_k, dim=-1)
    weights = torch.softmax(weights, dim=-1)
    return weights.to(x.dtype), experts, logits


def dispatch(x, experts, weights, E: int, C: int):
    """Scatter tokens into per-expert capacity slots, shard by shard.  x
    (..., T, d); experts and weights (..., T, k), the leading dimensions
    indexing shards.  Returns x_send (..., E, C, d), slot_of (..., T, k)
    (E·C ⇒ dropped) and the kept weights (..., T, k).  An assignment's
    position in its expert is the exclusive cumulative count in (token,
    slot) order within its shard, so the same assignments are dropped as in
    the reference."""
    lead, (T, d), k = x.shape[:-2], x.shape[-2:], experts.shape[-1]
    flat_e = experts.reshape(-1, T * k).long()              # (N, T·k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)           # (N, T·k, E)
    pos_in_e = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    token_of = torch.arange(T, device=x.device).repeat_interleave(k)
    shard = torch.arange(slot.shape[0], device=x.device)[:, None]
    x_send = x.new_zeros((slot.shape[0], E * C + 1, d))
    # every dropped assignment lands on the sentinel row, sliced off below
    x_send[shard, slot] = x.reshape(-1, T, d)[:, token_of]
    kept_w = weights * keep.reshape(weights.shape).to(weights.dtype)
    return (x_send[:, :-1].reshape(*lead, E, C, d),
            slot.reshape(experts.shape), kept_w)


def combine(y_recv, slot_of, kept_w, T: int):
    """Gather expert outputs back to tokens, shard by shard.  y_recv (...,
    E, C, dv) → (..., T, dv): the kept weights times each token's slot rows,
    summed over its k (a dropped assignment reads the zero sentinel row)."""
    lead, (E, C, dv) = y_recv.shape[:-3], y_recv.shape[-3:]
    flat = y_recv.reshape(-1, E * C, dv)
    flat = torch.cat([flat, flat.new_zeros((flat.shape[0], 1, dv))], 1)
    shard = torch.arange(flat.shape[0], device=flat.device)[:, None]
    picked = flat[shard, slot_of.reshape(flat.shape[0], -1)]
    picked = picked.reshape(*lead, T, -1, dv)
    return torch.einsum("...tkd,...tk->...td", picked, kept_w)


def expert_rows(slot_of, E: int, C: int):
    """Kept assignments per expert, min(#assigned, C), shard by shard:
    slot_of (..., T, k) → (..., E) int32 on the device, a scatter-add of
    each assignment's slot // C into E + 1 buckets, where the dropped ones
    (slot E·C) land in the last.  No value is read on the host."""
    flat = slot_of.reshape(-1, slot_of.shape[-2] * slot_of.shape[-1])
    counts = torch.zeros((flat.shape[0], E + 1), dtype=torch.int32,
                         device=flat.device)
    counts.scatter_add_(1, flat // C, torch.ones_like(flat,
                                                      dtype=torch.int32))
    return counts[:, :E].reshape(*slot_of.shape[:-2], E)


def expert_ffn(eparams, x_e, act="silu", rows=None, experts=None):
    """Batched expert MLP.  x_e (G, N, d) → (G, N, d): three grouped matmuls
    over the G·N rows, block i of N rows on expert ``experts[i]`` (default:
    expert i).  ``rows`` (G,) or None: block i's rows past ``rows[i]`` come
    out zero (None: every row counts)."""
    G, N, d = x_e.shape
    flat = x_e.reshape(G * N, d)
    if experts is None:
        experts = torch.arange(G, dtype=torch.int32, device=x_e.device)
    gate = gmm(flat, eparams["wi_gate"], experts, N, rows)
    up = gmm(flat, eparams["wi_up"], experts, N, rows)
    g = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return gmm(g * up, eparams["wo"], experts, N, rows).reshape(G, N, -1)


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


def moe_block_a2a(params, x, cfg: ArchConfig):
    """Expert-parallel MoE forward on the stacked binding: the reference's
    ``moe_block_a2a`` under ``shard_map`` over ``model`` (and the dp axes),
    for every shard at once.

    x (P_dp, P_tp, B_l, S_l, d): shard (i, j)'s tokens.  ``params``:
    ``router`` and ``shared`` as in :func:`moe_block_local`; each
    ``experts`` leaf (P_dp, P_tp, E_local, ...) holds model shard j's
    experts j·E_local … (j + 1)·E_local − 1, one stack broadcast over the
    dp shards (a view, :func:`repro_torch.distributed.moe_ep.expert_views`),
    as the reference replicates the experts over the dp axes.  Returns
    (out (P_dp, P_tp, B_l, S_l, d), each shard's load-balance loss (P_dp,
    P_tp)).

    Each shard routes, sizes C = capacity(B_l·S_l) and dispatches its own
    tokens, as in the reference.  The first all_to_all hands destination
    shard j, from every source s, s's (E_local, C) slots of j's experts:
    the transpose (s, j) → (j, s).  Expert e of shard j then holds P_tp·C
    rows, C from each source, whose kept rows are the first
    ``expert_rows`` of each source's C.  A gather moves them to the front
    of e's block, in source order, and the block's count is their sum, so
    ``gmm`` reads e's weights once for all sources (an expert no source
    sent a token to reads none).  Every output row depends on its own input
    row alone, so the compaction changes no value.  The results go back
    through the same index, then the second all_to_all, the transpose (j,
    s) → (s, j), and each source combines its own."""
    mo = cfg.moe
    Pd, Pt, B, S, d = x.shape
    E = mo.n_experts
    if E % Pt:
        raise ValueError(f"{cfg.name}: {E} experts do not split over "
                         f"{Pt} model shards")
    El, T = E // Pt, B * S
    dev = x.device
    xt = x.reshape(Pd, Pt, T, d)
    w, e, logits = route(params, xt, mo)
    C = capacity(T, mo)
    x_send, slot, kept_w = dispatch(xt, e, w, E, C)    # (Pd, Pt, E, C, d)
    # kept rows of (dp, source, destination, local expert), and the same
    # seen by the destinations (dp, destination, local expert, source)
    kept = expert_rows(slot, E, C).view(Pd, Pt, Pt, El)
    recv = kept.permute(0, 2, 3, 1)
    start = torch.cumsum(recv, -1, dtype=torch.int32) - recv
    block_rows = recv.sum(-1, dtype=torch.int32).reshape(Pd * E)
    # each received slot's row in the compacted (Pd·E, Pt·C) blocks; a
    # slot past its source's count goes to the sentinel row n
    n = Pd * E * Pt * C
    c = torch.arange(C, device=dev)
    block = torch.arange(Pd * E, device=dev).view(Pd, Pt, El, 1, 1)
    dest = torch.where(c < recv[..., None],
                       block * (Pt * C) + start[..., None] + c, n)
    # the all_to_all in: received slot (dp, j, e, s, c) is x_send's row
    # (dp, s, j, e, c)
    src = torch.arange(Pd * Pt * E * C, device=dev).view(
        Pd, Pt, Pt, El, C).permute(0, 2, 3, 1, 4)
    order = torch.zeros(n + 1, dtype=torch.long, device=dev).scatter_(
        0, dest.reshape(-1), src.reshape(-1))[:n]
    x_e = x_send.reshape(-1, d)[order].view(Pd * E, Pt * C, d)
    stack = {k: _expert_stack(v) for k, v in params["experts"].items()}
    experts = torch.arange(E, dtype=torch.int32, device=dev).repeat(Pd)
    y_e = expert_ffn(stack, x_e, cfg.act, block_rows, experts)
    y_e = torch.cat([y_e.reshape(n, -1), y_e.new_zeros((1, y_e.shape[-1]))])
    # back through the same index, then the all_to_all out: source s's
    # slots (dp, s, j, e, c) read received slot (dp, j, e, s, c)
    y_send = y_e[dest.permute(0, 3, 1, 2, 4)].reshape(Pd, Pt, E, C, -1)
    out = combine(y_send, slot, kept_w, T)
    if mo.n_shared_experts:
        out = out + mlp(params["shared"], xt, cfg.act)
    aux = load_balance_loss(logits, e, mo)
    return out.reshape(Pd, Pt, B, S, d), aux


def moe_block_a2a_rank(params, x, cfg: ArchConfig, mesh, shared=None):
    """Expert-parallel MoE forward of one rank of a
    :class:`~repro_torch.launch.mesh.ProcessMesh`: the reference's
    ``moe_block_a2a`` under ``shard_map``, its two ``all_to_all``s over
    ``model`` ``torch.distributed.all_to_all_single`` between the processes
    (:func:`repro_torch.distributed.collectives.all_to_all`).

    x (B, S, d): this rank's tokens.  ``params``: ``router`` as in
    :func:`moe_block_local`; each ``experts`` leaf (E_local, ...) the rank's
    experts, model coordinate j holding j·E_local … (j + 1)·E_local − 1.
    ``shared(xt)``, where given, is the shared expert on the rank's (B·S,
    d) tokens, added after the combine as :func:`moe_block_local` adds it
    (so at one rank the block is the local block's graph, its gradients
    summed in the same order); otherwise the caller runs the shared expert
    (tensor-parallel, on all of S).  Returns (the output (B, S, d), the
    rank's load-balance loss).

    The rank routes, sizes C = capacity(B·S) and dispatches its own tokens,
    as the reference's shard does.  With each (E_local, C) block of slots
    goes its kept-row counts, so destination j learns, for each local
    expert e and source s, how many of s's C slots hold a token; a gather
    moves those rows to the front of e's block of P·C rows, in source
    order, as the stacked :func:`moe_block_a2a` compacts them, and ``gmm``
    reads e's weights once for every source.  The results go back through
    the same index and the second all_to_all, and the rank combines its
    own.  On an axis of size 1 both all_to_alls are the identity."""
    from ..distributed import collectives as CL
    mo = cfg.moe
    E, P = mo.n_experts, mesh.shape["model"]
    El = params["experts"]["wi_gate"].shape[0]
    if El * P != E:
        raise ValueError(f"{cfg.name}: a rank holds {El} of {E} experts on "
                         f"a model axis of {P}")
    B, S, d = x.shape
    T, dev = B * S, x.device
    xt = x.reshape(T, d)
    w, e, logits = route(params, xt, mo)
    C = capacity(T, mo)
    x_send, slot, kept_w = dispatch(xt, e, w, E, C)        # (E, C, d)
    kept = expert_rows(slot, E, C)                          # (E,)
    # rows (local expert, source) that each source kept for this rank
    recv = CL.all_to_all(kept.view(P, El), mesh, "model").T.contiguous()
    x_recv = CL.all_to_all(x_send.reshape(P, El, C, d), mesh, "model")
    start = torch.cumsum(recv, -1, dtype=torch.int32) - recv
    block_rows = recv.sum(-1, dtype=torch.int32)
    # each received slot's row in the compacted (E_local, P·C) blocks; a
    # slot past its source's count goes to the sentinel row n
    n = El * P * C
    c = torch.arange(C, device=dev)
    block = torch.arange(El, device=dev).view(El, 1, 1)
    dest = torch.where(c < recv[..., None],
                       block * (P * C) + start[..., None] + c, n)
    # received slot (e, s, c) is x_recv's row (s, e, c)
    src = torch.arange(P * El * C, device=dev).view(P, El, C).permute(1, 0,
                                                                      2)
    order = torch.zeros(n + 1, dtype=torch.long, device=dev).scatter_(
        0, dest.reshape(-1), src.reshape(-1))[:n]
    x_e = x_recv.reshape(-1, d)[order].view(El, P * C, d)
    experts = torch.arange(El, dtype=torch.int32, device=dev)
    y_e = expert_ffn(params["experts"], x_e, cfg.act, block_rows, experts)
    y_e = torch.cat([y_e.reshape(n, -1), y_e.new_zeros((1, y_e.shape[-1]))])
    # back through the same index: slot (s, e, c) for source s
    y_send = CL.all_to_all(y_e[dest.permute(1, 0, 2)], mesh, "model")
    out = combine(y_send.reshape(E, C, -1), slot, kept_w, T)
    if shared is not None:
        out = out + shared(xt)
    return out.reshape(B, S, -1), load_balance_loss(logits, e, mo)


def _expert_stack(w):
    """The (E, ...) stack a (P_dp, P_tp, E_local, ...) expert leaf views:
    dp shard 0's, which every dp shard shares."""
    if w.shape[0] > 1 and w.stride(0) != 0:
        raise ValueError("moe_block_a2a: an experts leaf must be one stack "
                         "broadcast over the dp shards (expand), as the "
                         "reference replicates the experts over the dp "
                         "axes")
    return w[0].reshape(-1, *w.shape[3:])


def load_balance_loss(logits, experts, mo: MoEConfig):
    """Switch-style auxiliary load-balance loss, shard by shard: E · Σ_e
    (fraction of the shard's tokens whose first choice is e) · (mean router
    probability of e).  logits (..., T, E), experts (..., T, k) → (...)."""
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(experts[..., 0].long(), mo.n_experts).float().mean(-2)
    return mo.n_experts * torch.sum(frac * probs.mean(-2), -1)
