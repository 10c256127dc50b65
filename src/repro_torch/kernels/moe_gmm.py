"""Grouped matmul (MoE expert compute) for Hopper, the counterpart of
``repro/kernels/moe_gmm.py`` and of its wrapper ``repro/kernels/ops.py::gmm``.

On a CUDA tensor :func:`gmm` launches the hand-written kernel of
``csrc/moe_gmm.cu`` (built with ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs the kernel's plain PyTorch version,
:func:`repro_torch.kernels.ref.gmm`.  ``gmm.launches`` counts kernel
launches.

The reference's ``block_n`` / ``block_k`` tiles, and its divisibility
asserts on them, have no counterpart: the kernel masks ragged tiles itself.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _nvcc.Library("moe_gmm",
                     {"gmm_fwd": [_I] + [_P] * 4 + [_I] * 5 + [_P]},
                     "gmm_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gmm(x, w, block_expert, block_t):
    """Block i of ``block_t`` rows of x times ``w[block_expert[i]]``,
    accumulated in float32.  x (T, Din) and w (E, Din, Dout) of one dtype,
    ``block_expert`` (T // block_t,) integers in [0, E).  Returns (T, Dout)
    in x's dtype.  ``block_expert``'s values are never read on the host."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    T = x.shape[0]
    if block_t < 1 or T % block_t:
        raise ValueError(f"gmm: block_t {block_t} does not divide T = {T}")
    if (block_expert.shape != (T // block_t,)
            or block_expert.is_floating_point()):
        raise ValueError(f"gmm: block_expert {block_expert.dtype} "
                         f"{tuple(block_expert.shape)}, expected "
                         f"({T // block_t},) integers")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gmm takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}, {w.dtype}")
    if not _nvcc.on_card("gmm", x, w, block_expert):
        return ref.gmm(x, w, block_expert, block_t)
    E, Din, Dout = w.shape
    x, w = x.contiguous(), w.contiguous()
    be = block_expert.to(torch.int32).contiguous()
    out = torch.empty((T, Dout), dtype=x.dtype, device=x.device)
    _LIB.call("gmm_fwd", _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
              be.data_ptr(), out.data_ptr(), T, E, Din, Dout, block_t,
              _nvcc.stream(x))
    gmm.launches += 1
    return out


gmm.launches = 0
