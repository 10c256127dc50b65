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
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 5 + [_P]
_LIB = _nvcc.Library("moe_gmm", {"gmm_fwd": [_I] + _ARGS,
                                 "gmm_fwd_mma": _ARGS},
                     "gmm_error_string")
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


def gmm(x, w, block_expert, block_t, block_rows=None):
    """Block i of ``block_t`` rows of x times ``w[block_expert[i]]``,
    accumulated in float32.  x (T, Din) and w (E, Din, Dout) of one dtype,
    ``block_expert`` (T // block_t,) integers in [0, E).  ``block_rows``,
    (T // block_t,) integers or None, counts the rows of each block that
    hold data: row r of block i is ``x[row] @ w[block_expert[i]]`` for
    ``r < block_rows[i]`` and zero past it, whatever x holds there (None:
    every row counts).  A block whose count is 0 reads no weights.  Returns
    (T, Dout) in x's dtype.  ``block_expert``'s and ``block_rows``' values
    are never read on the host."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    T = x.shape[0]
    if block_t < 1 or T % block_t:
        raise ValueError(f"gmm: block_t {block_t} does not divide T = {T}")
    for name, t in (("block_expert", block_expert), ("block_rows",
                                                     block_rows)):
        if t is not None and (t.shape != (T // block_t,)
                              or t.is_floating_point()
                              or t.dtype == torch.bool):
            raise ValueError(f"gmm: {name} {t.dtype} {tuple(t.shape)}, "
                             f"expected ({T // block_t},) integers")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gmm takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}, {w.dtype}")
    counted = () if block_rows is None else (block_rows,)
    if not _nvcc.on_card("gmm", x, w, block_expert, *counted):
        return ref.gmm(x, w, block_expert, block_t, block_rows)
    E, Din, Dout = w.shape
    x, w = x.contiguous(), w.contiguous()
    be = block_expert.to(torch.int32).contiguous()
    rows = None if block_rows is None \
        else block_rows.to(torch.int32).contiguous()
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
