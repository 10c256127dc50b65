"""Grouped matmul (MoE expert compute) for Hopper, the counterpart of
``repro/kernels/moe_gmm.py`` and of its wrapper ``repro/kernels/ops.py::gmm``.

On a CUDA tensor :func:`gmm` launches one of the two hand-written kernels of
``csrc/moe_gmm.cu`` (built with ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs the kernels' plain PyTorch version,
:func:`repro_torch.kernels.ref.gmm`.  ``gmm.launches`` counts kernel
launches.  :func:`_variant` picks the kernel from dtype, widths and
alignment: bfloat16 that 16-byte copies can take goes to the tensor-core
kernel, everything else (float32, which must stay exact, and bf16 the
copies cannot take) to the CUDA-core one.

The reference's ``block_n`` / ``block_k`` tiles, and its divisibility
asserts on them, have no counterpart: the kernels mask ragged tiles
themselves.  The optional per-block row counts have no counterpart in the
reference either: there the rows past a count are zeros in x, so its
output rows are zeros too, and the port's kernels write those zeros
without reading the weights.

Training goes through :class:`GroupedMatmul`, which :func:`gmm` takes when
grad is enabled and x or w requires grad; the reference differentiates its
``expert_ffn`` einsums by autodiff.  Its backward is two kernels, each
reading the forward's w as it is (no copy): :func:`gmm_dx`, on the tensor
cores ``csrc/moe_gmm_dx.cu`` (wgmma fed by TMA, each expert's weights read
once a call) and on the CUDA cores the forward's kernel reading w as its
transpose (``csrc/moe_gmm.cu``), and :func:`gmm_dw`, the grouped
weight-gradient kernels of ``csrc/moe_gmm_dw.cu`` (on the tensor cores
wgmma fed by TMA, persistent over the experts' tiles); plain versions
``ref.gmm`` on ``w.transpose(1, 2)`` and ``ref.gmm_dw`` on the CPU.  Both
take the forward's row counts: dx is zero on the rows past a count, whose
outputs do not depend on x, and dw sums none of them.  The tensor-core
kernels are persistent; their C entries size the launch themselves.
``gmm_dx.launches`` and ``gmm_dw.launches`` count launches, and their
``routes`` count them by kernel, picked by :func:`_variant` as the
forward's.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 5 + [_P]
_LIB = _nvcc.Library("moe_gmm", {"gmm_fwd": [_I] + _ARGS,
                                 "gmm_fwd_mma": _ARGS,
                                 "gmm_dx": [_I] + _ARGS},
                     "gmm_error_string")
_DX_LIB = _nvcc.Library("moe_gmm_dx", {"gmm_dx_mma": _ARGS},
                        "gmm_dx_error_string")
_DW_LIB = _nvcc.Library("moe_gmm_dw", {"gmm_dw": [_I] + _ARGS,
                                       "gmm_dw_mma": _ARGS},
                        "gmm_dw_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _variant(dtype, Din, Dout, ptrs) -> str:
    """Which kernel takes these inputs: ``"mma"`` (tensor cores) for
    bfloat16 with Din and Dout multiples of 8 and every base address of x,
    w and out (``ptrs``) a multiple of 16, so that every row starts on 16
    bytes; else ``"simt"`` (CUDA cores, float32 arithmetic)."""
    if dtype != torch.bfloat16 or Din % 8 or Dout % 8:
        return "simt"
    if any(p % 16 for p in ptrs):
        return "simt"
    return "mma"


def _check_blocks(what, T, block_t, block_expert, block_rows):
    if block_t < 1 or T % block_t:
        raise ValueError(f"{what}: block_t {block_t} does not divide T = "
                         f"{T}")
    for name, t in (("block_expert", block_expert), ("block_rows",
                                                     block_rows)):
        if t is not None and (t.shape != (T // block_t,)
                              or t.is_floating_point()
                              or t.dtype == torch.bool):
            raise ValueError(f"{what}: {name} {t.dtype} {tuple(t.shape)}, "
                             f"expected ({T // block_t},) integers")


def _check_dtypes(what, *ts):
    if ts[0].dtype not in _DTYPES or any(t.dtype != ts[0].dtype
                                         for t in ts):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {', '.join(str(t.dtype) for t in ts)}")


def _block_args(block_expert, block_rows):
    """The int32 block experts and row counts (or None) the kernels read."""
    be = block_expert.to(torch.int32).contiguous()
    rows = None if block_rows is None \
        else block_rows.to(torch.int32).contiguous()
    return be, rows


def gmm(x, w, block_expert, block_t, block_rows=None):
    """Block i of ``block_t`` rows of x times ``w[block_expert[i]]``,
    accumulated in float32.  x (T, Din) and w (E, Din, Dout) of one dtype,
    ``block_expert`` (T // block_t,) integers in [0, E).  ``block_rows``,
    (T // block_t,) integers or None, counts the rows of each block that
    hold data: row r of block i is ``x[row] @ w[block_expert[i]]`` for
    ``r < block_rows[i]`` and zero past it, whatever x holds there (None:
    every row counts).  A block whose count is 0 reads no weights.  Returns
    (T, Dout) in x's dtype.  ``block_expert``'s and ``block_rows``' values
    are never read on the host.  Differentiable in x and w through
    :class:`GroupedMatmul` when grad is enabled and either requires it."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    _check_blocks("gmm", x.shape[0], block_t, block_expert, block_rows)
    _check_dtypes("gmm", x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w, block_expert, block_t, block_rows)
    return _gmm(x, w, block_expert, block_t, block_rows)


def _gmm(x, w, block_expert, block_t, block_rows):
    """:func:`gmm` on checked arguments: the kernel or the plain version."""
    counted = () if block_rows is None else (block_rows,)
    if not _nvcc.on_card("gmm", x, w, block_expert, *counted):
        return ref.gmm(x, w, block_expert, block_t, block_rows)
    T, (E, Din, Dout) = x.shape[0], w.shape
    x, w = x.contiguous(), w.contiguous()
    be, rows = _block_args(block_expert, block_rows)
    out = torch.empty((T, Dout), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    args = (x.data_ptr(), w.data_ptr(), be.data_ptr(),
            None if rows is None else rows.data_ptr(), out.data_ptr(), T, E,
            Din, Dout, block_t, _nvcc.stream(x))
    if _variant(x.dtype, Din, Dout, ptrs) == "mma":
        _LIB.call("gmm_fwd_mma", *args)
    else:
        _LIB.call("gmm_fwd", _DTYPES[x.dtype], *args)
    gmm.launches += 1
    return out


gmm.launches = 0


def gmm_dx(dy, w, block_expert, block_t, block_rows=None):
    """The input gradient of :func:`gmm`: block i of ``block_t`` rows of dy
    (T, Dout) times ``w[block_expert[i]]ᵀ``, accumulated in float32, rows
    past ``block_rows[i]`` zero.  w (E, Din, Dout) as the forward took it:
    the kernels read each expert's weights as their transpose, and nothing
    is copied.  Returns (T, Din) in dy's dtype.  On CUDA tensors, on the
    route :func:`_variant` picks (``gmm_dx.routes``), ``csrc/moe_gmm_dx.cu``
    (``"mma"``) or the CUDA-core kernel of ``csrc/moe_gmm.cu`` in its
    transposed instance; on CPU tensors ``ref.gmm(dy, w.transpose(1, 2),
    ...)``."""
    if dy.dim() != 2 or w.dim() != 3 or w.shape[2] != dy.shape[1]:
        raise ValueError(f"gmm_dx: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}")
    _check_blocks("gmm_dx", dy.shape[0], block_t, block_expert, block_rows)
    _check_dtypes("gmm_dx", dy, w)
    counted = () if block_rows is None else (block_rows,)
    if not _nvcc.on_card("gmm_dx", dy, w, block_expert, *counted):
        return ref.gmm(dy, w.transpose(1, 2), block_expert, block_t,
                       block_rows)
    T, (E, Din, Dout) = dy.shape[0], w.shape
    dy, w = dy.contiguous(), w.contiguous()
    be, rows = _block_args(block_expert, block_rows)
    dx = torch.empty((T, Din), dtype=dy.dtype, device=dy.device)
    args = (dy.data_ptr(), w.data_ptr(), be.data_ptr(),
            None if rows is None else rows.data_ptr(), dx.data_ptr(), T, E,
            Din, Dout, block_t)
    route = _variant(dy.dtype, Din, Dout,
                     (dy.data_ptr(), w.data_ptr(), dx.data_ptr()))
    if route == "mma":
        _DX_LIB.call("gmm_dx_mma", *args, _nvcc.stream(dy))
    else:
        _LIB.call("gmm_dx", _DTYPES[dy.dtype], *args, _nvcc.stream(dy))
    gmm_dx.launches += 1
    gmm_dx.routes[route] += 1
    return dx


gmm_dx.launches = 0
gmm_dx.routes = {"mma": 0, "simt": 0}


def gmm_dw(x, dy, block_expert, block_t, block_rows, E):
    """The weight gradient of :func:`gmm`: (E, Din, Dout) in x's dtype,
    expert e's the float32 sum, over its blocks in index order, of
    ``x_iᵀ @ dy_i`` over each block's counted rows, cast once; an expert
    with no counted row is zero.  x (T, Din) and dy (T, Dout) of one
    dtype.  On CUDA tensors one of ``csrc/moe_gmm_dw.cu``'s kernels, on the
    route :func:`_variant` picks (``gmm_dw.routes``): each tile of an
    expert's gradient finds the expert's blocks on the device and sums them
    in a fixed order, so two calls are bitwise equal; on CPU tensors
    ``ref.gmm_dw``."""
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0] or E < 1:
        raise ValueError(f"gmm_dw: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, E {E}")
    _check_blocks("gmm_dw", x.shape[0], block_t, block_expert, block_rows)
    _check_dtypes("gmm_dw", x, dy)
    counted = () if block_rows is None else (block_rows,)
    if not _nvcc.on_card("gmm_dw", x, dy, block_expert, *counted):
        return ref.gmm_dw(x, dy, block_expert, block_t, block_rows, E)
    T, Din, Dout = x.shape[0], x.shape[1], dy.shape[1]
    x, dy = x.contiguous(), dy.contiguous()
    be, rows = _block_args(block_expert, block_rows)
    dw = torch.empty((E, Din, Dout), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), dy.data_ptr(), be.data_ptr(),
            None if rows is None else rows.data_ptr(), dw.data_ptr(), T, E,
            Din, Dout, block_t)
    route = _variant(x.dtype, Din, Dout,
                     (x.data_ptr(), dy.data_ptr(), dw.data_ptr()))
    if route == "mma":
        _DW_LIB.call("gmm_dw_mma", *args, _nvcc.stream(x))
    else:
        _DW_LIB.call("gmm_dw", _DTYPES[x.dtype], *args, _nvcc.stream(x))
    gmm_dw.launches += 1
    gmm_dw.routes[route] += 1
    return dw


gmm_dw.launches = 0
gmm_dw.routes = {"mma": 0, "simt": 0}


class GroupedMatmul(torch.autograd.Function):
    """Differentiable :func:`gmm`: ``GroupedMatmul.apply(x, w,
    block_expert, block_t, block_rows)``.  The forward is :func:`gmm`'s
    call (grad is disabled inside it); it keeps x and w as they are, no
    copy of w, with the block arguments.  The backward is :func:`gmm_dx`
    for x and :func:`gmm_dw` for w, each only where needed."""

    @staticmethod
    def forward(ctx, x, w, block_expert, block_t, block_rows):
        ctx.save_for_backward(x, w, block_expert, block_rows)
        ctx.block_t = block_t
        return _gmm(x, w, block_expert, block_t, block_rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, be, rows = ctx.saved_tensors
        dx = gmm_dx(dy, w, be, ctx.block_t, rows) \
            if ctx.needs_input_grad[0] else None
        dw = gmm_dw(x, dy, be, ctx.block_t, rows, w.shape[0]) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None
