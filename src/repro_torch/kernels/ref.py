"""Plain PyTorch versions of the model kernels, the counterparts of
``repro/kernels/ref.py``'s ``repeat_kv``, ``mha``, ``decode_attention``,
``rglru``, ``wkv6`` and ``gmm``, the split algorithm of the decode kernel
(:func:`decode_attention_split`), the chunked algebras of the RG-LRU
kernel (:func:`rglru_chunked`) and of the bf16 WKV6 kernel
(:func:`wkv6_chunked`), the backward versions of the two recurrences,
:func:`rglru_bwd` and :func:`wkv6_bwd`, the tiled algebra of the RG-LRU
backward kernels (:func:`rglru_bwd_tiled`), and the training pair of the
flash kernels:
:func:`mha_lse` (the forward with each row's log-sum-exp) and
:func:`flash_attention_bwd` (the FlashAttention-2 backward of
``repro/models/flash_xla.py::_flash_bwd``).

They follow the semantics of the reference's **Pallas kernels**
(``repro/kernels/flash_attention.py``, ``decode_attention.py``), because that
is what the port's CUDA kernels compute: scores, probabilities and the PV
product stay in float32, and the result is cast to the query's dtype once.
CPU tensors take these functions through the kernel wrappers
(:mod:`.flash_attention`, :mod:`.decode_attention`, :mod:`.rglru_scan`,
:mod:`.wkv6`, :mod:`.moe_gmm`); ``chip_smoke.py`` calls them directly on the
card to hold the kernels against them.  The recurrences run as Python
loops over time, one step at a time in float32, as the Pallas kernels'
inner loops do.

One deliberate difference from ``repro.kernels.ref``: a query row with no
visible key returns **zeros** here, as the Pallas kernels do (their
``l == 0 → l_safe = 1``), where ``ref.mha`` returns a uniform average of V
(the softmax of a row of equal ``NEG_INF`` scores).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, S, D) → (B, Hkv·n_rep, S, D) for GQA: query head h reads
    kv head h // n_rep."""
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def _masked_softmax_pv(logits, mask, v, with_lse=False):
    """Softmax over the last dimension restricted to ``mask``, then the PV
    product, all in float32; a row with no visible key gives zeros.  With
    ``with_lse`` also each row's natural-log log-sum-exp of the masked
    logits, ``m + log(l)``, which is ``NEG_INF`` for a row with no visible
    key (``flash_xla._fwd_scan``'s ``l == 0 → l_safe = 1``)."""
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, v)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if with_lse:
        return out / l_safe, (m + torch.log(l_safe))[..., 0]
    return out / l_safe


def _attention_mask(sq, sk, causal, window, offset, device):
    """(Sq, Sk) bool: query i sees key j iff ``j <= i + offset`` (causal)
    and ``j > i + offset - window`` (window)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos + offset
    if window is not None:
        mask &= kpos > qpos + offset - window
    return mask


def mha(q, k, v, *, causal=True, window=None, sm_scale=None, offset=None):
    """Multi-head attention.  q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) with
    Hq % Hkv == 0.  Query i sees key j iff ``j <= i + offset`` (causal) and
    ``j > i + offset - window`` (window); ``offset`` defaults to ``Sk - Sq``
    (decode-style alignment).  Returns (B, Hq, Sq, D) in q's dtype."""
    out, _lse = _mha(q, k, v, causal, window, sm_scale, offset, False)
    return out


def mha_lse(q, k, v, *, causal=True, window=None, sm_scale=None,
            offset=None):
    """:func:`mha` and each row's log-sum-exp: (out (B, Hq, Sq, D) in q's
    dtype, lse (B, Hq, Sq) float32), the natural log over ``scale·q·kᵀ``
    after the mask, as ``flash_xla._fwd_scan`` returns it (``NEG_INF`` for
    a row with no visible key)."""
    return _mha(q, k, v, causal, window, sm_scale, offset, True)


def _mha(q, k, v, causal, window, sm_scale, offset, with_lse):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    offset = sk - sq if offset is None else int(offset)
    kf = repeat_kv(k.float(), hq // hkv)
    vf = repeat_kv(v.float(), hq // hkv)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    mask = _attention_mask(sq, sk, causal, window, offset, q.device)
    if with_lse:
        out, lse = _masked_softmax_pv(logits, mask, vf, True)
        return out.to(q.dtype), lse
    return _masked_softmax_pv(logits, mask, vf).to(q.dtype), None


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        window=None, sm_scale=None, offset=None,
                        round_p=None):
    """The FlashAttention-2 backward of :func:`mha_lse`, written out in
    float32 as ``flash_xla._flash_bwd`` computes it: ``Dsum = rowsum(dO∘O)``,
    ``P = exp(S − lse)`` on the visible keys (0 elsewhere) with ``S =
    scale·q·kᵀ``, ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS = P∘(dP − Dsum)``,
    ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``, the G = Hq/Hkv query heads of
    a kv head summed into its dK and dV.  q, out, dout (B, Hq, Sq, D); k, v
    (B, Hkv, Sk, D); lse (B, Hq, Sq) float32.  ``offset`` defaults to ``Sk −
    Sq``.  Returns (dq, dk, dv) in q's, k's and v's dtypes.

    With ``round_p`` (a dtype: ``torch.bfloat16``) P is rounded to it before
    ``Pᵀ·dO`` and dS (made from the unrounded P) before ``dS·K`` and
    ``dSᵀ·Q``, as the tensor-core kernels feed both to their products; the
    sums stay float32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    offset = sk - sq if offset is None else int(offset)
    qf = q.float() * scale
    kf = repeat_kv(k.float(), g)
    vf = repeat_kv(v.float(), g)
    do = dout.float()
    dsum = (do * out.float()).sum(-1, keepdim=True)
    mask = _attention_mask(sq, sk, causal, window, offset, q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    pr = p if round_p is None else p.to(round_p).float()
    dv = torch.matmul(pr.transpose(-1, -2), do)
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - dsum)
    if round_p is not None:
        ds = ds.to(round_p).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dk = dk.reshape(b, hkv, g, sk, d).sum(2)
    dv = dv.reshape(b, hkv, g, sk, v.shape[-1]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale=None):
    """One query token per sequence against a cache.  q (B, Hq, D); caches
    (B, Hkv, S, D); lengths (B,) int — valid cache positions per sequence.
    The G = Hq/Hkv query heads of kv head h are q's heads h·G … h·G+G-1.
    Returns (B, Hq, D) in q's dtype; ``lengths[b] == 0`` gives zeros."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, d)
    logits = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])[:, None, None, :]
    out = _masked_softmax_pv(logits, mask, v_cache.float())   # (B,Hkv,G,D)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_split(q, k_cache, v_cache, lengths, chunk, *,
                           sm_scale=None):
    """:func:`decode_attention` as the CUDA kernel computes it: the S cache
    slots cut into chunks of ``chunk`` keys, each chunk's float32 partial
    (m, l, acc) over its valid keys — m = -1e30 and l = 0 for a chunk with
    none — then one combine per head: the global max M over chunks with
    l > 0, weights exp(m - M), and ``L == 0 → 1`` so length 0 gives zeros.
    Every step is per query head, so the kernel's tiling of a kv head's
    query heads over the grid changes nothing here.  Same arguments as
    :func:`decode_attention`; returns (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    g = hq // hkv
    n = max(1, -(-s // chunk))
    pad = n * chunk - s
    qg = q.float().reshape(b, hkv, g, d)
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad))
    logits = torch.matmul(qg, kf.transpose(-1, -2)) * scale  # (B,Hkv,G,nC)
    valid = (torch.arange(n * chunk, device=q.device)[None, :]
             < lengths.to(q.device).long().clamp(max=s)[:, None])[
                 :, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    logits = logits.reshape(b, hkv, g, n, chunk)
    valid = valid.reshape(b, 1, 1, n, chunk)
    m = logits.amax(-1)                                        # (B,Hkv,G,n)
    p = torch.where(valid, torch.exp(logits - m[..., None]),
                    torch.zeros_like(logits))
    l = p.sum(-1)
    acc = torch.einsum("bhgnc,bhncd->bhgnd", p,
                       vf.reshape(b, hkv, n, chunk, d))
    live = l > 0
    big = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(
        -1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
    total = (w * l).sum(-1, keepdim=True)
    out = (w[..., None] * acc).sum(-2) / torch.where(
        total == 0, torch.ones_like(total), total)
    return out.reshape(b, hq, d).to(q.dtype)


def _acc(t):
    """The dtype the plain recurrences compute in: float64 for float64
    inputs (``torch.autograd.gradcheck``), else float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _rglru_decay(log_a):
    """The RG-LRU's decay ``a = exp(log_a)`` and input gate ``sqrt(max(1 -
    exp(2·log_a), 0))``, the reference's formula in float32 (float64 for
    float64 ``log_a``), as the CUDA kernels take it (``decay()`` in
    ``csrc/rglru_scan.cu``) on every device: ``exp(log_a)`` in float64,
    rounded once, and ``exp(2·log_a)`` as its square in float64, rounded
    once, the difference and the square root in the working dtype.  Near
    log_a = 0 the difference cancels and magnifies the exponential's
    error by ``1 / (1 - exp(2·log_a))`` (500 at log_a = -1e-3); rounded
    once from float64 the terms are the correctly rounded ones, whatever
    accuracy a float32 exponential has in the process (one with ~14 bits
    moves y by 2.6e-4 on the tests' inputs) or on the device."""
    acc = _acc(log_a)
    e = torch.exp(log_a.double())
    gate = torch.sqrt(torch.clamp(1.0 - (e * e).to(acc), min=0.0))
    return e.to(acc), gate


def _rglru_terms(x, log_a):
    """The RG-LRU's decay ``a`` and gated input ``sqrt(max(1 -
    exp(2·log_a), 0))·x`` (:func:`_rglru_decay`)."""
    a, gate = _rglru_decay(log_a)
    return a, gate * x.to(a.dtype)


def rglru(x, log_a):
    """RG-LRU scan (RecurrentGemma, arXiv:2402.19427 eq. 5–6):
    ``h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·x_t`` elementwise, with ``a_t =
    exp(log_a_t)`` and ``h_{-1} = 0`` (the terms as
    :func:`_rglru_terms` takes them).  x, log_a (B, S, D).  Returns (y (B,
    S, D) in x's dtype, h_final (B, D) float32)."""
    a, bx = _rglru_terms(x, log_a)
    h = torch.zeros((x.shape[0], x.shape[2]), dtype=a.dtype,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(h)
    y = torch.stack(ys, 1) if ys else torch.zeros_like(x, dtype=a.dtype)
    return y.to(x.dtype), h


def rglru_bwd(x, log_a, dy, dh_final=None):
    """The vjp of :func:`rglru` (``jax.vjp`` of the reference's
    ``kref.rglru``): given ``dy`` (B, S, D), the gradient of y, and
    ``dh_final`` (B, D) or None (zero), the gradient of h_final, returns
    (dx in x's dtype, dlog_a in log_a's dtype).  With ``g_t`` the
    gradient of h_t, the reverse scan ``g_t = dy_t + a_{t+1}·g_{t+1}``
    seeded by ``g_{S-1} = dy_{S-1} + dh_final``, and ``b_t = sqrt(max(1 -
    a_t², 0))``::

        dx_t     = b_t·g_t
        dlog_a_t = g_t·(a_t·h_{t-1} - a_t²·x_t / b_t)

    h is recomputed in float32 (float64 for float64 inputs) by the
    forward's recurrence, and the terms come from :func:`_rglru_decay`,
    as :func:`rglru` takes them.  Where the clamp binds (``1 -
    exp(2·log_a) <= 0``, b = 0: log_a = 0, a = 1) the gate's term is
    taken as 0, the clamp's flat side: there ``dx = 0`` and ``dlog_a =
    g·a·h_{t-1}``.  The reference's gradient is not finite at log_a = 0
    (sqrt′(0) meets the ``maximum``); the model never reaches it, since
    log_a = -8·softplus(Λ)·r < 0."""
    a, b = _rglru_decay(log_a)
    xf = x.to(a.dtype)
    B, S, D = x.shape
    open_ = b > 0
    q = torch.where(open_, a * a * xf / torch.where(open_, b,
                                                    torch.ones_like(b)),
                    torch.zeros_like(b))
    h = torch.zeros((B, D), dtype=a.dtype, device=x.device)
    h_prev = []
    for t in range(S):
        h_prev.append(h)
        h = a[:, t] * h + b[:, t] * xf[:, t]
    e = torch.zeros_like(h) if dh_final is None else dh_final.to(a.dtype)
    dx, dla = [None] * S, [None] * S
    for t in reversed(range(S)):          # e = a_{t+1}·g_{t+1}
        g = dy[:, t].to(a.dtype) + e
        dx[t] = b[:, t] * g
        dla[t] = g * (a[:, t] * h_prev[t] - q[:, t])
        e = a[:, t] * g
    if S == 0:
        return torch.zeros_like(x), torch.zeros_like(log_a)
    return (torch.stack(dx, 1).to(x.dtype),
            torch.stack(dla, 1).to(log_a.dtype))


def _rglru_runs(x, log_a, tile, sub):
    """x, log_a padded to whole tiles of ``tile`` steps (x = 0, log_a = 0:
    a = 1, gate 0) in the working dtype (:func:`_acc`), with their decay
    terms, each (B, tiles, runs, sub, D): (x, a, gate)."""
    B, S, D = x.shape
    acc = _acc(x)
    pad = -S % tile
    xf = torch.nn.functional.pad(x.to(acc), (0, 0, 0, pad))
    a, gate = _rglru_decay(torch.nn.functional.pad(log_a.to(acc),
                                                   (0, 0, 0, pad)))
    return tuple(t.reshape(B, -1, tile // sub, sub, D) for t in (xf, a, gate))


def rglru_chunked(x, log_a, tile=128, sub=16, keep_states=False):
    """:func:`rglru` as the CUDA kernel computes it, in float32 (float64
    for float64 inputs): time cut
    into tiles of ``tile`` steps (the last one padded with x = 0 and log_a
    = 0, a = 1 and gate 0, which leave the state as it is), each tile into
    runs of ``sub`` steps.  Each run is scanned from h = 0, keeping its
    local states ``hl_t`` and the running products of its a, ``A_t``; the
    runs' end pairs then fold, in order, into the carry from the previous
    tile, ``h_in ← A_end·h_in + h_end``, and ``y_t = hl_t + A_t·h_in`` with
    the h_in before the run.  A_t is a product of a (at most 1), never the
    exp of a sum, so nothing overflows.  Same arguments and results as
    :func:`rglru`; ``sub`` divides ``tile``.  The defaults are the bf16
    kernel's; in float32 it runs tiles of 64 and runs of 8.  With
    ``keep_states`` it also returns the carry before each tile, (B,
    ⌈S/tile⌉, D): what the kernel keeps for the backward."""
    B, S, D = x.shape
    runs = tile // sub
    xf, a, gate = _rglru_runs(x, log_a, tile, sub)
    bx = gate * xf
    hl, ap = torch.empty_like(bx), torch.empty_like(a)
    h, A = torch.zeros_like(bx[:, :, :, 0]), torch.ones_like(a[:, :, :, 0])
    for k in range(sub):                       # every run at once
        h = a[:, :, :, k] * h + bx[:, :, :, k]
        A = A * a[:, :, :, k]
        hl[:, :, :, k], ap[:, :, :, k] = h, A
    carry = torch.zeros((B, D), dtype=a.dtype, device=x.device)
    ys, states = [], []
    for i in range(hl.shape[1]):
        states.append(carry)
        for j in range(runs):
            ys.append(hl[:, i, j] + ap[:, i, j] * carry[:, None])
            carry = ap[:, i, j, -1] * carry + hl[:, i, j, -1]
    y = torch.cat(ys, 1)[:, :S] if ys else torch.zeros_like(x, dtype=a.dtype)
    if not keep_states:
        return y.to(x.dtype), carry
    kept = torch.stack(states, 1) if states else carry.new_zeros((B, 0, D))
    return y.to(x.dtype), carry, kept


def rglru_bwd_tiled(x, log_a, dy, dh_final=None, tile=128, sub=16):
    """:func:`rglru_bwd` as the CUDA kernels compute it (``csrc/
    rglru_scan.cu``'s backward), in float32 (float64 for float64 inputs):
    time cut into the forward's tiles of ``tile`` steps, each into runs
    of ``sub`` (the last tile padded with x = dy = 0 and log_a = 0, a = 1
    and gate 0, which pass h and e = a·g through unchanged), then

    1. the state before each tile, as the forward keeps it
       (:func:`rglru_chunked` with ``keep_states``);
    2. each tile's aggregate: its runs scanned back from e = 0 (``e ←
       a·(dy + e)``, and the run's product of a), their end pairs folded
       last first into ``P_i = Π a`` over the tile and ``ε_i``, e at its
       first step from e = 0 after it;
    3. e after each tile, by the fixed-order fold ``e ← P_j·e + ε_j`` of
       the tiles after it, last first, from ``dh_final``;
    4. each tile's runs: the end pairs of each run forward from h = 0 and
       back from e = 0, folded into each run's h_in and e_in, then the run
       forward from h_in (h_{t-1}) and back from e_in (g_t), with
       :func:`rglru_bwd`'s terms.

    Same arguments and results as :func:`rglru_bwd`; ``sub`` divides
    ``tile``.  The defaults are the bf16 kernels'; in float32 they run
    tiles of 64 and runs of 8."""
    B, S, D = x.shape
    if S == 0:
        return torch.zeros_like(x), torch.zeros_like(log_a)
    runs = tile // sub
    xf, a, gate = _rglru_runs(x, log_a, tile, sub)
    dyf = torch.nn.functional.pad(dy.to(xf.dtype), (0, 0, 0, -S % tile)) \
        .reshape(xf.shape)
    _y, _h, states = rglru_chunked(x, log_a, tile, sub, keep_states=True)
    n = xf.shape[1]

    e_run, p_run = torch.zeros_like(a[:, :, :, 0]), \
        torch.ones_like(a[:, :, :, 0])
    for k in reversed(range(sub)):     # every run back from e = 0 at once
        e_run = a[:, :, :, k] * (dyf[:, :, :, k] + e_run)
        p_run = p_run * a[:, :, :, k]
    h_run, a_run = torch.zeros_like(e_run), torch.ones_like(p_run)
    for k in range(sub):               # and forward from h = 0
        h_run = a[:, :, :, k] * h_run + gate[:, :, :, k] * xf[:, :, :, k]
        a_run = a_run * a[:, :, :, k]
    eps, P = torch.zeros_like(e_run[:, :, 0]), torch.ones_like(p_run[:, :, 0])
    for j in reversed(range(runs)):    # the tiles' aggregates
        eps = p_run[:, :, j] * eps + e_run[:, :, j]
        P = P * p_run[:, :, j]
    e = torch.zeros_like(eps[:, 0]) if dh_final is None \
        else dh_final.to(a.dtype)
    after = [None] * n                 # e at the first step after tile i
    for i in reversed(range(n)):
        after[i] = e
        e = P[:, i] * e + eps[:, i]
    h_in, e_in = torch.empty_like(h_run), torch.empty_like(e_run)
    hc, ec = states.to(a.dtype), torch.stack(after, 1)
    for j in range(runs):
        h_in[:, :, j] = hc
        hc = a_run[:, :, j] * hc + h_run[:, :, j]
    for j in reversed(range(runs)):
        e_in[:, :, j] = ec
        ec = p_run[:, :, j] * ec + e_run[:, :, j]
    open_ = gate > 0
    q = torch.where(open_, a * a * xf / torch.where(open_, gate,
                                                    torch.ones_like(gate)),
                    torch.zeros_like(gate))
    hp = torch.empty_like(xf)
    h = h_in
    for k in range(sub):
        hp[:, :, :, k] = h
        h = a[:, :, :, k] * h + gate[:, :, :, k] * xf[:, :, :, k]
    dx, dla = torch.empty_like(xf), torch.empty_like(xf)
    e = e_in
    for k in reversed(range(sub)):
        g = dyf[:, :, :, k] + e
        dx[:, :, :, k] = gate[:, :, :, k] * g
        dla[:, :, :, k] = g * (a[:, :, :, k] * hp[:, :, :, k] - q[:, :, :, k])
        e = a[:, :, :, k] * g

    def out(t, like):
        return t.reshape(B, n * tile, D)[:, :S].to(like.dtype)
    return out(dx, x), out(dla, log_a)


def wkv6(r, k, v, w, u):
    """RWKV-6 (Finch) WKV (arXiv:2404.05892 eq. 18–19), per head with a
    D×D state S starting at zero:
    ``y_t = r_tᵀ S_{t-1} + (Σ_d r_d u_d k_d)·v_t`` and
    ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``.
    r, k, v, w (B, H, S, D); u (H, D).  Returns (y (B, H, S, D) in r's
    dtype, S_final (B, H, D, D) float32)."""
    B, H, S, D = r.shape
    acc = _acc(r)
    rf, kf, vf, wf, uf = (t.to(acc) for t in (r, k, v, w, u))
    s = torch.zeros((B, H, D, D), dtype=acc, device=r.device)
    ys = []
    for t in range(S):
        r_t, k_t, v_t = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        y = torch.einsum("bhi,bhij->bhj", r_t, s) \
            + (r_t * uf * k_t).sum(-1, keepdim=True) * v_t
        s = wf[:, :, t, :, None] * s + k_t[..., None] * v_t[..., None, :]
        ys.append(y)
    y = torch.stack(ys, 2) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), s


def wkv6_bwd(r, k, v, w, u, dy, ds_final=None, chunk=64):
    """The vjp of :func:`wkv6` (``jax.vjp`` of the reference's
    ``kref.wkv6``, and of its training form ``wkv6_chunked``), in float32
    (float64 for float64 inputs).  Given ``dy`` (B, H, S, D), the gradient
    of y, and ``ds_final`` (B, H, D, D) or None (zero), the gradient of
    S_final, with G_t the gradient of the state S_t (G_{S-1} =
    ``ds_final``) and ``vdy_t = v_t·dy_t``::

        dr_t = S_{t-1}·dy_t + (u ⊙ k_t)·vdy_t
        dk_t = G_t·v_t + (r_t ⊙ u)·vdy_t
        dv_t = G_tᵀ·k_t + (Σ r_t ⊙ u ⊙ k_t)·dy_t
        dw_t = Σ_j S_{t-1}[:, j] ⊙ G_t[:, j]
        du   = Σ_{b,t} r_t ⊙ k_t·vdy_t
        G_{t-1} = diag(w_t)·G_t + r_t·dy_tᵀ

    The states S_{t-1} are recomputed forward from checkpoints every
    ``chunk`` steps, one chunk at a time as the walk back reaches it, as
    ``wkv6_chunked``'s ``jax.checkpoint`` recomputes them.  Returns (dr,
    dk, dv, dw in r's, k's, v's and w's dtypes, du (H, D) in u's)."""
    B, H, S, D = r.shape
    acc = _acc(r)
    rf, kf, vf, wf, dyf = (t.to(acc) for t in (r, k, v, w, dy))
    uf = u.to(acc)
    vdy = (vf * dyf).sum(-1)                                  # (B, H, S)
    bonus = (rf * uf[:, None] * kf).sum(-1)                   # (B, H, S)

    def step(s, t):
        return wf[:, :, t, :, None] * s \
            + kf[:, :, t, :, None] * vf[:, :, t, None, :]

    s = torch.zeros((B, H, D, D), dtype=acc, device=r.device)
    starts = []
    for t in range(S):
        if t % chunk == 0:
            starts.append(s)
        s = step(s, t)
    g = torch.zeros_like(s) if ds_final is None else ds_final.to(acc)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((H, D), dtype=acc, device=r.device)
    for c in reversed(range(len(starts))):
        s, prev = starts[c], []
        for t in range(c * chunk, min(S, (c + 1) * chunk)):
            prev.append(s)
            s = step(s, t)
        for t in reversed(range(c * chunk, min(S, (c + 1) * chunk))):
            s_prev = prev[t - c * chunk]
            r_t, k_t, v_t, dy_t = (x[:, :, t] for x in (rf, kf, vf, dyf))
            dr[:, :, t] = torch.einsum("bhij,bhj->bhi", s_prev, dy_t) \
                + uf * k_t * vdy[:, :, t, None]
            dk[:, :, t] = torch.einsum("bhij,bhj->bhi", g, v_t) \
                + r_t * uf * vdy[:, :, t, None]
            dv[:, :, t] = torch.einsum("bhij,bhi->bhj", g, k_t) \
                + bonus[:, :, t, None] * dy_t
            dw[:, :, t] = (s_prev * g).sum(-1)
            du += (r_t * k_t * vdy[:, :, t, None]).sum(0)
            g = wf[:, :, t, :, None] * g + r_t[..., None] * dy_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype))


def wkv6_bwd_chunked(r, k, v, w, u, dy, ds_final=None, chunk=64):
    """:func:`wkv6_bwd` as the CUDA kernels of ``csrc/wkv6_bwd.cu`` compute
    it: time cut into chunks of ``chunk`` steps (the last one padded with
    r = k = v = dy = 0 and w = 1, which leaves S and G as they are), then

    1. the state before each chunk, S^c, and the gradient of the state
       after it, E^{c+1} (E^{n} = ``ds_final``), by one jump a chunk, with
       the chunk's decay ``W_c = Π_τ w_τ``, its exclusive prefix products
       ``P'_l = Π_{τ<l} w_τ`` and suffix products ``Q_l = Π_{τ>l} w_τ``::

           S^{c+1} = diag(W_c) S^c + Σ_l (k_l ⊙ Q_l) v_lᵀ
           E^c     = diag(W_c) E^{c+1} + Σ_l (r_l ⊙ P'_l) dy_lᵀ

    2. every chunk's gradients at once (batched over chunks): S_{t-1}
       walked forward from S^c and G_t back from E^{c+1} over the chunk's
       own steps, with :func:`wkv6_bwd`'s terms; du summed over b, chunks
       and steps.

    Every factor is a product of decays: w = 0 gives exact zeros, and
    nothing is divided.  Same arguments and results as :func:`wkv6_bwd`
    (float64 for float64 inputs, else float32)."""
    B, H, S, D = r.shape
    acc = _acc(r)
    L = chunk
    pad = -S % L
    n = (S + pad) // L
    if n == 0:
        return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
                torch.empty_like(w), torch.zeros_like(u))

    def chunked(t, value=0.0):
        return torch.nn.functional.pad(t.to(acc), (0, 0, 0, pad),
                                       value=value).reshape(B, H, n, L, D)
    rf, kf, vf, dyf = (chunked(t) for t in (r, k, v, dy))
    wf = chunked(w, 1.0)
    uf = u.to(acc)[:, None]                                   # (H, 1, D)

    def prefix(x):                    # Π_{τ<l} x_τ along the chunk
        return torch.cat([torch.ones_like(x[:, :, :, :1]),
                          torch.cumprod(x[:, :, :, :-1], 3)], 3)

    def suffix(x):                    # Π_{τ>l} x_τ along the chunk
        return torch.flip(prefix(torch.flip(x, [3])), [3])

    decay = torch.prod(wf, 3)[..., None]                      # (B, H, n, D, 1)
    ks = (kf * suffix(wf)).transpose(-1, -2) @ vf
    rs = (rf * prefix(wf)).transpose(-1, -2) @ dyf
    zero = torch.zeros((B, H, D, D), dtype=acc, device=r.device)
    s_c = [zero]
    for c in range(n - 1):
        s_c.append(decay[:, :, c] * s_c[-1] + ks[:, :, c])
    e_c = [zero if ds_final is None else ds_final.to(acc)]
    for c in reversed(range(1, n)):
        e_c.append(decay[:, :, c] * e_c[-1] + rs[:, :, c])
    s = torch.stack(s_c, 2)                                   # S^c
    g = torch.stack(e_c[::-1], 2)                             # E^{c+1}

    vdy = (vf * dyf).sum(-1)                                  # (B, H, n, L)
    bonus = (rf * uf[:, None] * kf).sum(-1)
    prev = []
    for l in range(L):
        prev.append(s)
        s = wf[:, :, :, l, :, None] * s \
            + kf[:, :, :, l, :, None] * vf[:, :, :, l, None, :]
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    for l in reversed(range(L)):
        r_l, k_l, v_l, dy_l = (x[:, :, :, l] for x in (rf, kf, vf, dyf))
        dr[:, :, :, l] = torch.einsum("bhnij,bhnj->bhni", prev[l], dy_l) \
            + uf * k_l * vdy[:, :, :, l, None]
        dk[:, :, :, l] = torch.einsum("bhnij,bhnj->bhni", g, v_l) \
            + r_l * uf * vdy[:, :, :, l, None]
        dv[:, :, :, l] = torch.einsum("bhnij,bhni->bhnj", g, k_l) \
            + bonus[:, :, :, l, None] * dy_l
        dw[:, :, :, l] = (prev[l] * g).sum(-1)
        g = wf[:, :, :, l, :, None] * g + r_l[..., None] * dy_l[..., None, :]
    du = (rf * kf * vdy[..., None]).sum((0, 2, 3))

    def out(x, like):
        return x.reshape(B, H, n * L, D)[:, :, :S].to(like.dtype)
    return (out(dr, r), out(dk, k), out(dv, v), out(dw, w), du.to(u.dtype))


def wkv6_chunked(r, k, v, w, u, chunk=16):
    """:func:`wkv6` as the bf16 CUDA kernel computes it, in float32: time
    cut into chunks of ``chunk`` steps (the last one padded with r = k = v
    = 0 and w = 1, which leaves the state as it is), and per chunk, from
    its starting state S0, with the decays' products within the chunk
    ``P_t = Π_{τ≤t} w_τ`` (reference: the chunk's start) and
    ``Q_s = Π_{s<τ<L} w_τ`` (reference: its end)::

        y_t   = (r_t ⊙ P_{t-1})ᵀ S0 + Σ_{s≤t} A[t, s] v_s
        A[t, s] = Σ_i r_t,i k_s,i Π_{s<τ<t} w_τ,i   (s < t)
        A[t, t] = Σ_i r_t,i u_i k_t,i
        S_end = diag(P_{L-1}) S0 + Σ_s (k_s ⊙ Q_s) v_sᵀ

    The scores are taken in two sub-chunks of L/2 steps: within each, as
    running products of w over the steps from s to t; across them (t ≥ L/2
    > s) as one product of two factors referenced to the middle of the
    chunk, ``(r_t ⊙ Π_{L/2≤τ<t} w_τ) · (k_s ⊙ Π_{s<τ<L/2} w_τ)``.  Every
    factor is a product of decays, at most 1 where w ≤ 1, and w = 0 gives
    exact zeros: no logarithm, no quotient, nothing to overflow.  Same
    arguments and results as :func:`wkv6`; ``chunk`` even."""
    B, H, S, D = r.shape
    L, M = chunk, chunk // 2
    pad = -S % L
    rf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                  for t in (r, k, v))
    wf = torch.nn.functional.pad(w.float(), (0, 0, 0, pad), value=1.0)
    uf = u.float()

    def prefix(x):                    # Π_{τ<t} x_τ along dim 2
        return torch.cat([torch.ones_like(x[:, :, :1]),
                          torch.cumprod(x[:, :, :-1], 2)], 2)

    def suffix(x):                    # Π_{τ>t} x_τ along dim 2
        return torch.flip(prefix(torch.flip(x, [2])), [2])

    s = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, S + pad, L):
        rc, kc, vc, wc = (t[:, :, c0:c0 + L] for t in (rf, kf, vf, wf))
        a = torch.diag_embed((rc * uf[:, None] * kc).sum(-1))   # A[t, t]
        for h0 in (0, M):             # within a sub-chunk, s < t
            for j in range(h0, h0 + M - 1):
                e = prefix(wc[:, :, j + 1:h0 + M])   # Π_{j<τ<t}, t > j
                a[:, :, j + 1:h0 + M, j] = (rc[:, :, j + 1:h0 + M]
                                            * kc[:, :, j:j + 1] * e).sum(-1)
        a[:, :, M:, :M] = (rc[:, :, M:] * prefix(wc[:, :, M:])) \
            @ (kc[:, :, :M] * suffix(wc[:, :, :M])).transpose(-1, -2)
        ys.append((rc * prefix(wc)) @ s + a @ vc)
        s = torch.prod(wc, 2)[..., None] * s \
            + (kc * suffix(wc)).transpose(-1, -2) @ vc
    y = torch.cat(ys, 2)[:, :, :S] if ys else torch.zeros_like(rf)
    return y.to(r.dtype), s


def gmm(x, w, block_expert, block_t, block_rows=None):
    """Grouped matmul: block i of ``block_t`` rows of x times
    ``w[block_expert[i]]`` in float32, cast to x's dtype.  x (T, Din), w (E,
    Din, Dout), block_expert (T // block_t,).  ``block_rows`` (T // block_t,)
    or None: only the first ``block_rows[i]`` rows of block i (clamped to
    [0, block_t]) are products, the rest are zeros whatever x holds there;
    None counts every row.  One product per block: the reference oracle's
    (nb, Din, Dout) float32 gather of w would take 21.5 GB at
    llama4-maverick's widths."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    nb = x.shape[0] // block_t
    counts = [block_t] * nb if block_rows is None else block_rows.tolist()
    for i, (e, n) in enumerate(zip(block_expert.tolist(), counts)):
        rows = slice(i * block_t, i * block_t + min(max(n, 0), block_t))
        if rows.stop > rows.start:
            out[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return out


def gmm_dw(x, dy, block_expert, block_t, block_rows, E):
    """The weight gradient of :func:`gmm`: (E, Din, Dout) in x's dtype,
    whose row e is the sum over every block i on expert e
    (``block_expert[i] == e``), in block order, of ``x_iᵀ @ dy_i`` over
    the block's counted rows (``block_rows`` as in :func:`gmm`), in
    float32 and cast once.  An expert that no block names, or whose blocks
    hold no counted row, is zero.  One float32 product per block and one
    expert's float32 sum at a time: a float32 (E, Din, Dout) sum would take
    15 GB at deepseek-v3's widths."""
    out = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=x.dtype,
                      device=x.device)
    nb = x.shape[0] // block_t
    counts = [block_t] * nb if block_rows is None else block_rows.tolist()
    blocks = {}
    for i, (e, n) in enumerate(zip(block_expert.tolist(), counts)):
        n = min(max(n, 0), block_t)
        if n:
            blocks.setdefault(e, []).append(slice(i * block_t,
                                                  i * block_t + n))
    for e, rows in blocks.items():
        acc = torch.zeros(out.shape[1:], dtype=torch.float32,
                          device=x.device)
        for r in rows:
            acc += x[r].float().T @ dy[r].float()
        out[e] = acc.to(x.dtype)
    return out
