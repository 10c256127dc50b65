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
:func:`rglru_scan` keeping the float32 state before each tile
(:func:`tile_states`) and whose backward is :func:`rglru_scan_bwd`, the
hand-written tile-parallel reverse scan of the same source (plain version
:func:`repro_torch.kernels.ref.rglru_bwd` on the CPU; its algebra
:func:`repro_torch.kernels.ref.rglru_bwd_tiled`): the counterpart of
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
                     {"rglru_scan_fwd": [_I] * 2 + [_P] * 5 + [_I] * 3
                      + [_P],
                      "rglru_scan_bwd": [_I] * 2 + [_P] * 8 + [_I] * 3
                      + [_P]},
                     "rglru_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tile_steps(dtype) -> int:
    """The kernels' tile of time: 128 steps in bf16, 64 in float32."""
    return 128 if dtype == torch.bfloat16 else 64


def tile_states(x):
    """An uninitialised float32 (B, ⌈S/kT⌉, D) buffer on x's device for
    the state before each of the forward's tiles (:func:`tile_steps`):
    :func:`rglru_scan` fills it on the card, and :func:`rglru_scan_bwd`
    starts each tile from it."""
    B, S, D = x.shape
    return torch.empty((B, -(-S // tile_steps(x.dtype)), D),
                       dtype=torch.float32, device=x.device)


def _check_states(x, carries, what):
    B, S, D = x.shape
    shape = (B, -(-S // tile_steps(x.dtype)), D)
    if carries.dtype != torch.float32 or tuple(carries.shape) != shape \
            or not carries.is_contiguous() or carries.device != x.device:
        raise ValueError(f"{what}: carries must be a contiguous float32 "
                         f"{shape} tensor on {x.device} (tile_states), got "
                         f"{carries.dtype} {tuple(carries.shape)} on "
                         f"{carries.device}")


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


def rglru_scan(x, log_a, carries=None):
    """``h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·x_t`` with ``a_t = exp(log_a_t)``
    and ``h_{-1} = 0``.  x, log_a (B, S, D) of one dtype.  Returns (y (B, S,
    D) in x's dtype, h_final (B, D) float32).  ``carries``
    (:func:`tile_states`), on the card, receives the float32 state before
    each tile for :func:`rglru_scan_bwd`; serving passes None, and the
    CPU's plain version leaves it as it is."""
    if x.dim() != 3 or log_a.shape != x.shape:
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}")
    if not _nvcc.on_card("rglru_scan", x, log_a):
        return ref.rglru(x, log_a)
    if x.dtype not in _DTYPES or log_a.dtype != x.dtype:
        raise TypeError(f"rglru_scan takes float32 or bfloat16 x and log_a "
                        f"of one dtype, got {x.dtype}, {log_a.dtype}")
    if carries is not None:
        _check_states(x, carries, "rglru_scan")
    B, S, D = x.shape
    x, log_a = x.contiguous(), log_a.contiguous()
    y = torch.empty_like(x)
    h = torch.empty((B, D), dtype=torch.float32, device=x.device)
    route = _variant(x.dtype, D, (x.data_ptr(), log_a.data_ptr(),
                                  y.data_ptr()))
    _LIB.call("rglru_scan_fwd", _DTYPES[x.dtype], int(route == "vector"),
              x.data_ptr(), log_a.data_ptr(), y.data_ptr(), h.data_ptr(),
              None if carries is None else carries.data_ptr(), B, S, D,
              _nvcc.stream(x))
    rglru_scan.launches += 1
    rglru_scan.routes[route] += 1
    return y, h


rglru_scan.launches = 0
rglru_scan.routes = {"vector": 0, "scalar": 0}


def rglru_scan_bwd(x, log_a, dy, dh_final=None, carries=None):
    """Gradients (dx in x's dtype, dlog_a in log_a's) of :func:`rglru_scan`
    given ``dy`` (B, S, D) in x's dtype, the gradient of y, and
    ``dh_final`` (B, D) float32 or None (zero), the gradient of h_final:
    the vjp of ``kref.rglru`` (:func:`repro_torch.kernels.ref.rglru_bwd`
    says what it returns where log_a = 0).  On the card the two kernels of
    ``csrc/rglru_scan.cu`` (each tile's aggregate, then every tile's
    gradients; none for S = 0) on the copies :func:`_variant` picks,
    counted in ``rglru_scan_bwd.launches`` (calls) and ``.routes``; they
    start each tile from ``carries``, the forward's tile states
    (:func:`tile_states`, filled by ``rglru_scan(x, log_a, carries)``, as
    :class:`RGLRUScan` does), which the card requires, and take a float32
    scratch of two floats a tile and channel.  On the CPU the plain
    version, which ignores ``carries``."""
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
    if carries is None:
        raise ValueError("rglru_scan_bwd on the card starts each tile from "
                         "the forward's tile states: pass carries, filled "
                         "by rglru_scan(x, log_a, carries), or train "
                         "through RGLRUScan, which keeps them")
    _check_states(x, carries, "rglru_scan_bwd")
    B, S, D = x.shape
    x, log_a, dy = x.contiguous(), log_a.contiguous(), dy.contiguous()
    dh = None if dh_final is None else dh_final.contiguous()
    dx, dla = torch.empty_like(x), torch.empty_like(log_a)
    aggs = torch.empty((B, carries.shape[1], 2, D), dtype=torch.float32,
                       device=x.device)
    route = _variant(x.dtype, D, tuple(t.data_ptr() for t in (
        x, log_a, dy, dx, dla)))
    _LIB.call("rglru_scan_bwd", _DTYPES[x.dtype], int(route == "vector"),
              x.data_ptr(), log_a.data_ptr(), dy.data_ptr(),
              None if dh is None else dh.data_ptr(), carries.data_ptr(),
              aggs.data_ptr(), dx.data_ptr(), dla.data_ptr(), B, S, D,
              _nvcc.stream(x))
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.routes[route] += 1
    return dx, dla


rglru_scan_bwd.launches = 0
rglru_scan_bwd.routes = {"vector": 0, "scalar": 0}


class RGLRUScan(torch.autograd.Function):
    """Differentiable RG-LRU scan for training: ``RGLRUScan.apply(x,
    log_a)`` → (y, h_final) as :func:`rglru_scan`.  When a gradient will
    be asked for, the forward keeps x, log_a and the float32 state before
    each tile (:func:`tile_states`, 1/64 of x's bytes in bf16), and the
    backward (:func:`rglru_scan_bwd`) starts each tile from it instead of
    rebuilding h."""

    @staticmethod
    def forward(ctx, x, log_a):
        carries = tile_states(x) if any(ctx.needs_input_grad) else None
        y, h = rglru_scan(x, log_a, carries)
        ctx.save_for_backward(x, log_a, carries)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, log_a, carries = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return rglru_scan_bwd(x, log_a, dy.to(x.dtype), dh, carries)
