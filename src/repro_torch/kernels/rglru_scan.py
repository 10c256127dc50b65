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
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _nvcc.Library("rglru_scan",
                     {"rglru_scan_fwd": [_I] * 2 + [_P] * 4 + [_I] * 3
                      + [_P]},
                     "rglru_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _variant(dtype, D, ptrs) -> str:
    """How the kernel stages its tiles: ``"vector"`` (16-byte copies in and
    out) when every row starts on 16 bytes — ``D`` elements of ``dtype`` a
    multiple of 16 bytes and each base address (``ptrs``: x, log_a, y) a
    multiple of 16 — else ``"scalar"`` (one element a copy).  Both are the
    same tiled scan."""
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
