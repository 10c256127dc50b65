"""Flash attention (prefill / full-sequence forward) for Hopper, the
counterpart of ``repro/kernels/flash_attention.py`` and of its wrapper
``repro/kernels/ops.py::flash_attention``.

On a CUDA tensor :func:`flash_attention` launches one of the two
hand-written kernels of ``csrc/flash_attention.cu`` (built with ``nvcc`` for
``sm_90a`` at first use) or raises; on a CPU tensor it runs the kernels'
plain PyTorch version, :func:`repro_torch.kernels.ref.mha`.
``flash_attention.launches`` counts kernel launches.  :func:`_variant` picks
the kernel from the shapes: bfloat16 rows that 16-byte copies can take go
to the tensor-core kernel, everything else (float32, which must stay exact,
and unaligned bf16 rows) to the CUDA-core one.

The reference wrapper pads Sq and Sk up to its tile (``block_q``/``block_k``
= ``min(128, max(S, 8))``), masks the padded keys with ``kv_valid``, and the
kernel aligns the causal diagonal with ``offset = Sk_padded - Sq_padded``.
The port's kernel masks a ragged tile edge itself, so nothing is padded in
memory; the wrapper reproduces the reference's tile choice only to compute
the same ``offset``.  (When Sq ≠ Sk and only one of them is padded, that
offset is not ``Sk - Sq``: the reference's padding shifts the diagonal.  The
port keeps the reference's result; the serving path never meets the case,
since its causal prefill has Sq = Sk.)  The offset places only the causal
diagonal and the window: a non-causal call without a window, as
cross-attention's (Sq ≠ Sk over a ragged last key tile) and whisper's
bidirectional encoder are, sees every key below Sk whatever it is.

Training goes through :class:`FlashAttention`, the counterpart of the
reference's ``repro/models/flash_xla.py::flash_attention_xla`` (the JAX
trainer's ``impl="chunked"``) and its custom VJP: its forward launches the
same kernels with each row's log-sum-exp written beside the output, and its
backward :func:`flash_attention_bwd`, the hand-written kernels of
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_sm90.cu``
(plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd` on the CPU).  Its causal
offset is flash_xla's ``Sk - Sq``, not the serving wrapper's padded one.
``flash_attention_bwd.launches`` counts backward calls;
``flash_attention_bwd.routes`` counts them by route.  :func:`_bwd_variant`
picks the route from dtype, head dimension and alignment, three in all:

* ``"mma"``: bfloat16 rows that 16-byte copies can take at D <= 128, the
  ``mma.sync`` kernels of ``csrc/flash_attention_bwd.cu`` (a ``Dsum``
  pre-pass, a dk/dv walk, a dq walk: three launches);
* ``"wgmma"``: the same rows at 128 < D <= 256, the ``wgmma`` kernels fed
  by TMA of ``csrc/flash_attention_bwd_sm90.cu`` (an lse/``Dsum`` pass, a
  dk/dv walk, a dq walk: three launches);
* ``"simt"``: float32 at any D and bf16 rows off 16 bytes, the CUDA-core
  kernels of ``csrc/flash_attention_bwd.cu`` in float32 arithmetic (three
  launches).

The two tensor-core routes round P and dS to bf16 before their products
(plain version ``ref.flash_attention_bwd(..., round_p=torch.bfloat16)``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

#: Largest head dimension the kernel takes.
MAX_HEAD_DIM = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P] * 4 + [_I] * 6 + [_L] * 9 + [ctypes.c_float] + [_I] * 4 \
    + [_P, _P]
_LIB = _nvcc.Library(
    "flash_attention",
    {"flash_attention_fwd": [_I] + _ARGS, "flash_attention_fwd_mma": _ARGS},
    "flash_error_string")
_BWD_ARGS = [_P] * 10 + [_I] * 6 + [_L] * 15 + [ctypes.c_float] + [_I] * 3 \
    + [_P]
_BWD_LIB = _nvcc.Library(
    "flash_attention_bwd",
    {"flash_attention_bwd": [_I] + _BWD_ARGS,
     "flash_attention_bwd_mma": _BWD_ARGS},
    "flash_bwd_error_string")
# the wgmma route: the same arguments; its scratch's size in floats
_BWD_SM90_LIB = _nvcc.Library(
    "flash_attention_bwd_sm90",
    {"flash_attention_bwd_wgmma": _BWD_ARGS,
     "flash_bwd_wgmma_scratch_floats":
         [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong)]},
    "flash_bwd_wgmma_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _variant(dtype, D, strides, ptrs) -> str:
    """Which kernel takes these inputs: ``"mma"`` (tensor cores) for
    bfloat16 whose every row starts on 16 bytes — D a multiple of 8, each
    element stride of q, k and v (``strides``: their batch, head and
    sequence strides) a multiple of 8 and each base address (``ptrs``) a
    multiple of 16 — else ``"simt"`` (CUDA cores, float32 arithmetic)."""
    if dtype != torch.bfloat16 or D % 8:
        return "simt"
    if any(st % 8 for st in strides) or any(p % 16 for p in ptrs):
        return "simt"
    return "mma"


#: Largest head dimension the ``mma.sync`` backward (route ``"mma"``)
#: takes: at 16 keys a warp, dK's and dV's float32 accumulators are D
#: registers a lane, and at D 192 or 256 they and the tile products'
#: fragments pass the 255-register limit (ptxas spills them).  Wider bf16
#: rows take route ``"wgmma"``, whose warpgroups hold an m64 x D
#: accumulator in D / 2 registers a thread, up to :data:`MAX_HEAD_DIM`.
MMA_BWD_MAX_HEAD_DIM = 128


def _bwd_variant(dtype, D, strides, ptrs) -> str:
    """Which backward kernels take these inputs.  bfloat16 whose every row
    starts on 16 bytes — D a multiple of 8, each element stride of q, k, v,
    out and dout (``strides``) a multiple of 8 and each base address
    (``ptrs``) a multiple of 16 — goes to the tensor cores: ``"mma"``
    (``mma.sync``) at D <= :data:`MMA_BWD_MAX_HEAD_DIM`, ``"wgmma"``
    (``wgmma`` fed by TMA) above it; everything else to ``"simt"`` (CUDA
    cores, float32 arithmetic)."""
    route = _variant(dtype, D, strides, ptrs)
    if route == "mma" and D > MMA_BWD_MAX_HEAD_DIM:
        return "wgmma"
    return route


def _padded(n: int, block: int = 128) -> int:
    """``n`` rounded up to the reference wrapper's tile for it."""
    b = min(block, max(n, 8))
    return -(-n // b) * b


def _check_shapes(q, k, v, what="flash_attention"):
    B, Hq, _Sq, D = q.shape
    if Hq % k.shape[1] or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _check_card(what, D, *tensors):
    """The kernels' dtypes (float32 or bfloat16, all one) and head
    dimension."""
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{what} takes head_dim <= {MAX_HEAD_DIM}, got {D}")


def _row_major(*tensors):
    """Each tensor as it is when its last dimension is contiguous, else a
    contiguous copy."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Attention with GQA, causal and sliding-window masks.  q (B, Hq, Sq,
    D); k, v (B, Hkv, Sk, D) with Hq % Hkv == 0; returns (B, Hq, Sq, D) in
    q's dtype.  Any strides with a contiguous last dimension are taken."""
    _check_shapes(q, k, v)
    D = q.shape[3]
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    offset = _padded(k.shape[2]) - _padded(q.shape[2])
    return _forward(q, k, v, causal, window, scale, offset, False)[0]


def _forward(q, k, v, causal, window, scale, offset, with_lse):
    """(out, lse or None): the kernel on the card (``lse`` (B, Hq, Sq)
    float32 written beside the output when ``with_lse``), the plain version
    on the CPU."""
    if not _nvcc.on_card("flash_attention", q, k, v):
        kw = dict(causal=causal, window=window, sm_scale=scale, offset=offset)
        if with_lse:
            return ref.mha_lse(q, k, v, **kw)
        return ref.mha(q, k, v, **kw), None
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_card("flash_attention", D, q, k, v)
    q, k, v = _row_major(q, k, v)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    args = (*ptrs, out.data_ptr(), B, Hq, Hkv, Sq, Sk, D, *strides,
            float(scale), int(bool(causal)),
            0 if window is None else int(window), Sk, offset,
            None if lse is None else lse.data_ptr(), _nvcc.stream(q))
    if _variant(q.dtype, D, strides, ptrs) == "mma":
        _LIB.call("flash_attention_fwd_mma", *args)
    else:
        _LIB.call("flash_attention_fwd", _DTYPES[q.dtype], *args)
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        window=None, sm_scale=None, offset=None):
    """Gradients (dq, dk, dv) of attention's output ``out`` = attention(q,
    k, v) with row log-sum-exp ``lse`` (B, Hq, Sq) float32, given ``dout``,
    the gradient of ``out``; ``offset`` defaults to ``Sk - Sq``.  On the
    card the kernels of ``csrc/flash_attention_bwd.cu`` or
    ``csrc/flash_attention_bwd_sm90.cu`` (q, k, v, out and dout of one
    dtype, any strides with a contiguous last dimension; dq, dk and dv come
    back contiguous in that dtype) on the route :func:`_bwd_variant` picks,
    counted in ``flash_attention_bwd.routes``; on the CPU the plain
    version."""
    _check_shapes(q, k, v, "flash_attention_bwd")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, Hq, Sq):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)}")
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    offset = Sk - Sq if offset is None else int(offset)
    kw = dict(causal=causal, window=window, sm_scale=scale, offset=offset)
    if not _nvcc.on_card("flash_attention_bwd", q, k, v, out, lse, dout):
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    _check_card("flash_attention_bwd", D, q, k, v, out, dout)
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd takes a float32 lse, got "
                        f"{lse.dtype}")
    q, k, v, out, dout = _row_major(q, k, v, out, dout)
    lse = lse.contiguous()
    ins = (q, k, v, out, dout)
    strides = tuple(st for t in ins for st in t.stride()[:3])
    route = _bwd_variant(q.dtype, D, strides, [t.data_ptr() for t in ins])
    if route == "wgmma":    # the lse/Dsum tiles, sized by the C side
        n = ctypes.c_longlong()
        _BWD_SM90_LIB.call("flash_bwd_wgmma_scratch_floats", B, Hq, Sq,
                           ctypes.byref(n))
        scratch = torch.empty(n.value, dtype=torch.float32, device=q.device)
    else:           # Dsum
        scratch = torch.empty((B, Hq, Sq), dtype=torch.float32,
                              device=q.device)
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    args = (*(t.data_ptr() for t in (*ins, lse, scratch, dq, dk, dv)),
            B, Hq, Hkv, Sq, Sk, D, *strides, float(scale), int(bool(causal)),
            0 if window is None else int(window), offset)
    if route == "wgmma":
        _BWD_SM90_LIB.call("flash_attention_bwd_wgmma", *args,
                           _nvcc.stream(q))
    elif route == "mma":
        _BWD_LIB.call("flash_attention_bwd_mma", *args, _nvcc.stream(q))
    else:
        _BWD_LIB.call("flash_attention_bwd", _DTYPES[q.dtype], *args,
                      _nvcc.stream(q))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = {"mma": 0, "wgmma": 0, "simt": 0}


class FlashAttention(torch.autograd.Function):
    """Differentiable attention for training, the counterpart of
    ``flash_xla.flash_attention_xla``: ``FlashAttention.apply(q, k, v,
    causal, window, sm_scale)`` with the shapes of :func:`flash_attention`
    and the causal offset ``Sk - Sq``.  The forward keeps (q, k, v, out,
    lse); the backward recomputes the probabilities from them
    (:func:`flash_attention_bwd`) instead of storing the Sq × Sk matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, sm_scale=None):
        _check_shapes(q, k, v)
        scale = sm_scale if sm_scale is not None else 1.0 / q.shape[3] ** 0.5
        offset = k.shape[2] - q.shape[2]
        out, lse = _forward(q, k, v, causal, window, scale, offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, sm_scale=scale,
                        offset=offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.args)
        return dq, dk, dv, None, None, None
