"""RWKV-6 WKV for Hopper, the counterpart of ``repro/kernels/wkv6.py`` and of
its wrapper ``repro/kernels/ops.py::wkv6``.

On a CUDA tensor :func:`wkv6` launches one of the two hand-written kernels
of ``csrc/wkv6.cu`` (built with ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs the kernels' plain PyTorch version,
:func:`repro_torch.kernels.ref.wkv6`.  ``wkv6.launches`` counts kernel
launches, and ``wkv6.routes`` how many took each kernel.  :func:`_variant`
picks the kernel: bfloat16 rows that 16-byte copies can take go to the
chunked tensor-core kernel (its algebra is
:func:`repro_torch.kernels.ref.wkv6_chunked`), everything else (float32,
and unaligned bf16) to the sequential CUDA-core one.

The reference wrapper pads S to its time block with ``w = 1`` and zero k,
so the state carries through the padding unchanged; the port's kernel stops
at S instead, which gives the same ``s_final``.

Training goes through :class:`WKV6Train`, the counterpart of the
reference's training form ``repro/models/rwkv6.py::wkv6_chunked`` (which
its trainer runs, ``rec_impl="xla"``, with float32 w and u and every
product in float32): float32 r, k, v, w and u in, its forward the float32
sequential kernel (route ``"simt"``), its backward :func:`wkv6_bwd`, the
hand-written chunk-parallel kernels of ``csrc/wkv6_bwd.cu`` (their algebra
is :func:`repro_torch.kernels.ref.wkv6_bwd_chunked`; plain version
:func:`repro_torch.kernels.ref.wkv6_bwd` on the CPU).  The bare
:func:`wkv6` keeps refusing, on the card, an input that requires grad
(``_nvcc.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

#: Head sizes the kernel takes (a multiple of 16, at most 64).
HEAD_DIMS = (16, 32, 48, 64)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = _nvcc.Library("wkv6",
                     {"wkv6_fwd": [_I] * 2 + [_P] * 7 + [_I] * 4 + [_L] * 15
                      + [_P]},
                     "wkv6_error_string")
_BWD_LIB = _nvcc.Library("wkv6_bwd",
                         {"wkv6_bwd": [_P] * 14 + [_I] * 5 + [_L] * 18
                          + [_P]},
                         "wkv6_bwd_error_string")
#: Steps a chunk of :func:`wkv6_bwd`'s kernels: the spacing of the states
#: and state gradients its first kernel keeps.
BWD_CHUNK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _variant(dtype, strides, ptrs) -> str:
    """Which kernel takes these inputs: ``"chunked"`` (tensor cores) for
    bfloat16 whose every row starts on 16 bytes — each element stride of
    r, k, v and w (``strides``: their batch, head and time strides) a
    multiple of 8 and each base address (``ptrs``) a multiple of 16 — else
    ``"simt"`` (CUDA cores, the sequential form).  D is one of
    :data:`HEAD_DIMS`, which both kernels take."""
    if dtype != torch.bfloat16:
        return "simt"
    if any(st % 8 for st in strides) or any(p % 16 for p in ptrs):
        return "simt"
    return "chunked"


def _bwd_variant(strides, ptrs) -> str:
    """How :func:`wkv6_bwd`'s kernels copy their inputs: ``"vector"``
    (16-byte copies) when every element stride of r, k, v, w and dy
    (``strides``: their batch, head and time strides) is a multiple of 4
    and every base address (``ptrs``) a multiple of 16, else ``"scalar"``
    (4-byte copies)."""
    if any(st % 4 for st in strides) or any(p % 16 for p in ptrs):
        return "scalar"
    return "vector"


def wkv6(r, k, v, w, u):
    """Per head, with a D×D state S starting at zero:
    ``y_t = r_tᵀ S_{t-1} + (Σ r_t·u·k_t)·v_t``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``.
    r, k, v, w (B, H, S, D) and u (H, D), all of one dtype; any strides with
    a contiguous last dimension.  Returns (y (B, H, S, D) in r's dtype,
    s_final (B, H, D, D) float32); on the card y is a (B, H, S, D) view of
    (B, S, H, D) memory, so the caller's transpose back is free."""
    B, H, S, D = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, D):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}")
    if not _nvcc.on_card("wkv6", r, k, v, w, u):
        return ref.wkv6(r, k, v, w, u)
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w, u)):
        raise TypeError(f"wkv6 takes float32 or bfloat16 r, k, v, w, u of "
                        f"one dtype, got {[t.dtype for t in (r, k, v, w, u)]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes head sizes {HEAD_DIMS}, got {D}")
    r, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    u = u.contiguous()
    strides = tuple(x for t in (r, k, v, w) for x in t.stride()[:3])
    route = _variant(r.dtype, strides,
                     tuple(t.data_ptr() for t in (r, k, v, w)))
    y = torch.empty((B, S, H, D), dtype=r.dtype,
                    device=r.device).transpose(1, 2)
    s_fin = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    _LIB.call("wkv6_fwd", _DTYPES[r.dtype], int(route == "chunked"),
              r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
              u.data_ptr(), y.data_ptr(), s_fin.data_ptr(), B, H, S, D,
              *strides, *y.stride()[:3], _nvcc.stream(r))
    wkv6.launches += 1
    wkv6.routes[route] += 1
    return y, s_fin


wkv6.launches = 0
wkv6.routes = {"chunked": 0, "simt": 0}


def wkv6_bwd(r, k, v, w, u, dy, ds_final=None):
    """Gradients (dr, dk, dv, dw, du) of :func:`wkv6`'s (y, s_final) given
    ``dy`` (B, H, S, D), the gradient of y, and ``ds_final`` (B, H, D, D)
    or None (zero), the gradient of s_final: the vjp of ``kref.wkv6``
    (:func:`repro_torch.kernels.ref.wkv6_bwd` gives the terms).  On the
    card the three kernels of ``csrc/wkv6_bwd.cu``, float32 only (the
    training form's dtypes): r, k, v, w and dy with any strides and a
    contiguous last dimension, D one of :data:`HEAD_DIMS`; dr, dk, dv and
    dw come back as (B, H, S, D) views of (B, S, H, D) memory, du (H, D).
    The first kernel keeps the state before, and the state's gradient
    after, each chunk of :data:`BWD_CHUNK` steps (a float32 scratch of
    B·H·⌈S/64⌉·2·DP² floats, DP the head size rounded up to 16, 32 or 64);
    the second takes every chunk's gradients at once from them, with one
    du partial a (b, chunk, h), which the last kernel sums in order: no
    atomics, two calls bitwise equal.  The algebra is
    :func:`repro_torch.kernels.ref.wkv6_bwd_chunked`.
    ``wkv6_bwd.launches`` counts calls, ``wkv6_bwd.routes`` how many
    copied their inputs 16 bytes at a time (``"vector"``) or 4
    (``"scalar"``, :func:`_bwd_variant`); on the CPU the plain version."""
    B, H, S, D = r.shape
    if any(t.shape != r.shape for t in (k, v, w, dy)) or u.shape != (H, D) \
            or (ds_final is not None and ds_final.shape != (B, H, D, D)):
        ds = None if ds_final is None else tuple(ds_final.shape)
        raise ValueError(f"wkv6_bwd: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, dy {tuple(dy.shape)}, ds_final "
                         f"{ds}")
    ins = (r, k, v, w, u, dy) + (() if ds_final is None else (ds_final,))
    if not _nvcc.on_card("wkv6_bwd", *ins):
        return ref.wkv6_bwd(r, k, v, w, u, dy, ds_final)
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"wkv6_bwd takes float32 inputs, got "
                        f"{[t.dtype for t in ins]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6_bwd takes head sizes {HEAD_DIMS}, got {D}")
    r, k, v, w, dy = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (r, k, v, w, dy))
    u = u.contiguous()
    ds = None if ds_final is None else ds_final.contiguous()

    def grad():
        return torch.empty((B, S, H, D), dtype=torch.float32,
                           device=r.device).transpose(1, 2)
    dr, dk, dv, dw = grad(), grad(), grad(), grad()
    du = torch.empty((H, D), dtype=torch.float32, device=r.device)
    dp = next(n for n in (16, 32, 64) if n >= D)
    n_chunks = -(-S // BWD_CHUNK)
    states = torch.empty((B, H, n_chunks, 2, dp, dp), dtype=torch.float32,
                         device=r.device)
    du_part = torch.empty((B, n_chunks, H, dp), dtype=torch.float32,
                          device=r.device)
    strides = tuple(x for t in (r, k, v, w, dy) for x in t.stride()[:3])
    route = _bwd_variant(strides, tuple(t.data_ptr()
                                        for t in (r, k, v, w, dy)))
    _BWD_LIB.call("wkv6_bwd", *(t.data_ptr() for t in (r, k, v, w, u, dy)),
                  None if ds is None else ds.data_ptr(),
                  *(t.data_ptr() for t in (dr, dk, dv, dw, du, states,
                                           du_part)),
                  B, H, S, D, int(route == "vector"), *strides,
                  *dr.stride()[:3], _nvcc.stream(r))
    wkv6_bwd.launches += 1
    wkv6_bwd.routes[route] += 1
    return dr, dk, dv, dw, du


wkv6_bwd.launches = 0
wkv6_bwd.routes = {"vector": 0, "scalar": 0}


class WKV6Train(torch.autograd.Function):
    """The WKV for training, ``WKV6Train.apply(r, k, v, w, u)`` → (y,
    s_final), all float32 (the reference's ``wkv6_chunked`` with float32 w
    and u; float64 on the CPU for ``gradcheck``).  On the card the forward
    runs :func:`wkv6`'s float32 sequential kernel and keeps its inputs; the
    backward recomputes the states from them (:func:`wkv6_bwd`)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        if r.device.type == "cuda" and any(
                t.dtype != torch.float32 for t in (r, k, v, w, u)):
            raise TypeError(f"WKV6Train takes float32 r, k, v, w and u on "
                            f"the card, got "
                            f"{[t.dtype for t in (r, k, v, w, u)]}")
        y, s = wkv6(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return wkv6_bwd(r, k, v, w, u, dy, ds)
