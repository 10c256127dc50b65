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
