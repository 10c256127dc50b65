"""RG-LRU scan for Hopper, the counterpart of ``repro/kernels/rglru_scan.py``
and of its wrapper ``repro/kernels/ops.py::rglru``.

On a CUDA tensor :func:`rglru_scan` launches the hand-written kernel of
``csrc/rglru_scan.cu`` (built with ``nvcc`` for ``sm_90a`` at first use) or
raises; on a CPU tensor it runs the kernel's plain PyTorch version,
:func:`repro_torch.kernels.ref.rglru`.  ``rglru_scan.launches`` counts
kernel launches.

The reference wrapper pads S to its time block with ``log_a = 0`` (a = 1,
gate = 0), so the final state carries through the padding unchanged; the
port's kernel stops at S instead, which gives the same ``h_final``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _nvcc.Library("rglru_scan",
                     {"rglru_scan_fwd": [_I] + [_P] * 4 + [_I] * 3 + [_P]},
                     "rglru_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    _LIB.call("rglru_scan_fwd", _DTYPES[x.dtype], x.data_ptr(),
              log_a.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, D,
              _nvcc.stream(x))
    rglru_scan.launches += 1
    return y, h


rglru_scan.launches = 0
