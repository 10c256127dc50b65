"""RG-LRU scan for Hopper, the counterpart of ``repro/kernels/rglru_scan.py``
and of its wrapper ``repro/kernels/ops.py::rglru``.

On a CUDA tensor :func:`rglru_scan` launches the hand-written kernel of
``csrc/rglru_scan.cu`` (built with ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs the kernel's plain PyTorch version,
:func:`repro_torch.kernels.ref.rglru`.  The kernel scans tiles of time in
parallel inside a block; its algebra is
:func:`repro_torch.kernels.ref.rglru_chunked`.  ``rglru_scan.launches``
counts kernel launches, and ``rglru_scan.routes`` how many staged their
tiles each way (:func:`_variant`).

The reference wrapper pads S to its time block with ``log_a = 0`` (a = 1,
gate = 0), so the final state carries through the padding unchanged; the
port's kernel reads the steps past S as those zeros, which gives the same
``h_final``.

Training goes through :class:`RGLRUScan`, whose forward is
:func:`rglru_scan` and whose backward is :func:`rglru_scan_bwd`, the
hand-written reverse scan of the same source (plain version
:func:`repro_torch.kernels.ref.rglru_bwd` on the CPU): the counterpart of
``jax.vjp`` of the reference's ``kref.rglru``, which its trainer runs
(``rec_impl="xla"``).  The bare :func:`rglru_scan` keeps refusing, on the
card, an input that requires grad (``_nvcc.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _nvcc.Library("rglru_scan",
                     {"rglru_scan_fwd": [_I] * 2 + [_P] * 4 + [_I] * 3
                      + [_P],
                      "rglru_scan_bwd": [_I] * 2 + [_P] * 7 + [_I] * 3
                      + [_P]},
                     "rglru_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _variant(dtype, D, ptrs) -> str:
    """How the kernel stages its tiles: ``"vector"`` (16-byte copies in and
    out) when every row starts on 16 bytes — ``D`` elements of ``dtype`` a
    multiple of 16 bytes and each base address (``ptrs``: x, log_a, y) a
    multiple of 16 — else ``"scalar"`` (one element a copy).  Both are the
    same tiled scan (the backward's ``ptrs`` are x, log_a, dy, dx and
    dlog_a)."""
    if D * dtype.itemsize % 16 or any(p % 16 for p in ptrs):
        return "scalar"
    return "vector"


def rglru_scan(x, log_a):
    """``h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·x_t`` with ``a_t = exp(log_a_t)``
    and ``h_{-1} = 0``.  x, log_a (B, S, D) of one dtype.  Returns (y (B, S,
    D) in x's dtype, h_final (B, D) float32)."""
    if x.dim() != 3 or log_a.shape != x.shape:
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}")
    if not _nvcc.on_card("rglru_scan", x, log_a):
        return ref.rglru(x, log_a)
    if x.dtype not in _DTYPES or log_a.dtype != x.dtype:
        raise TypeError(f"rglru_scan takes float32 or bfloat16 x and log_a "
                        f"of one dtype, got {x.dtype}, {log_a.dtype}")
    B, S, D = x.shape
    x, log_a = x.contiguous(), log_a.contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, D), dtype=torch.float32, device=x.device)
    route = _variant(x.dtype, D, (x.data_ptr(), log_a.data_ptr(),
                                  y.data_ptr()))
    _LIB.call("rglru_scan_fwd", _DTYPES[x.dtype], int(route == "vector"),
              x.data_ptr(), log_a.data_ptr(), y.data_ptr(), h.data_ptr(),
              B, S, D, _nvcc.stream(x))
    rglru_scan.launches += 1
    rglru_scan.routes[route] += 1
    return y, h


rglru_scan.launches = 0
rglru_scan.routes = {"vector": 0, "scalar": 0}


def rglru_scan_bwd(x, log_a, dy, dh_final=None):
    """Gradients (dx in x's dtype, dlog_a in log_a's) of :func:`rglru_scan`
    given ``dy`` (B, S, D) in x's dtype, the gradient of y, and
    ``dh_final`` (B, D) float32 or None (zero), the gradient of h_final:
    the vjp of ``kref.rglru`` (:func:`repro_torch.kernels.ref.rglru_bwd`
    says what it returns where log_a = 0).  On the card the kernel
    ``rglru_scan_bwd`` of ``csrc/rglru_scan.cu`` on the copies
    :func:`_variant` picks, counted in ``rglru_scan_bwd.launches`` and
    ``.routes``; it recomputes h in float32 and needs a float32 scratch of
    one state a 128-step tile (64 in float32) and channel; on the CPU the
    plain version."""
    if x.dim() != 3 or log_a.shape != x.shape or dy.shape != x.shape or (
            dh_final is not None and dh_final.shape != (x.shape[0],
                                                        x.shape[2])):
        dh = None if dh_final is None else tuple(dh_final.shape)
        raise ValueError(f"rglru_scan_bwd: x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}, dy {tuple(dy.shape)}, "
                         f"dh_final {dh}")
    ins = (x, log_a, dy) + (() if dh_final is None else (dh_final,))
    if not _nvcc.on_card("rglru_scan_bwd", *ins):
        return ref.rglru_bwd(x, log_a, dy, dh_final)
    if x.dtype not in _DTYPES or log_a.dtype != x.dtype \
            or dy.dtype != x.dtype or (dh_final is not None
                                       and dh_final.dtype != torch.float32):
        raise TypeError(f"rglru_scan_bwd takes float32 or bfloat16 x, log_a "
                        f"and dy of one dtype and a float32 dh_final, got "
                        f"{[t.dtype for t in ins]}")
    B, S, D = x.shape
    x, log_a, dy = x.contiguous(), log_a.contiguous(), dy.contiguous()
    dh = None if dh_final is None else dh_final.contiguous()
    dx, dla = torch.empty_like(x), torch.empty_like(log_a)
    tile = 128 if x.dtype == torch.bfloat16 else 64
    carries = torch.empty((B, max(1, -(-S // tile)), D), dtype=torch.float32,
                          device=x.device)
    route = _variant(x.dtype, D, tuple(t.data_ptr() for t in (
        x, log_a, dy, dx, dla)))
    _LIB.call("rglru_scan_bwd", _DTYPES[x.dtype], int(route == "vector"),
              x.data_ptr(), log_a.data_ptr(), dy.data_ptr(),
              None if dh is None else dh.data_ptr(), dx.data_ptr(),
              dla.data_ptr(), carries.data_ptr(), B, S, D, _nvcc.stream(x))
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.routes[route] += 1
    return dx, dla


rglru_scan_bwd.launches = 0
rglru_scan_bwd.routes = {"vector": 0, "scalar": 0}


class RGLRUScan(torch.autograd.Function):
    """Differentiable RG-LRU scan for training: ``RGLRUScan.apply(x,
    log_a)`` → (y, h_final) as :func:`rglru_scan`.  The forward keeps x
    and log_a; the backward recomputes h from them
    (:func:`rglru_scan_bwd`) instead of keeping it."""

    @staticmethod
    def forward(ctx, x, log_a):
        y, h = rglru_scan(x, log_a)
        ctx.save_for_backward(x, log_a)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, log_a = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return rglru_scan_bwd(x, log_a, dy.to(x.dtype), dh)
