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
since its prefill has Sq = Sk.)
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from .ref import mha

#: Largest head dimension the kernel takes.
MAX_HEAD_DIM = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P] * 4 + [_I] * 6 + [_L] * 9 + [ctypes.c_float] + [_I] * 4 + [_P]
_LIB = _nvcc.Library(
    "flash_attention",
    {"flash_attention_fwd": [_I] + _ARGS, "flash_attention_fwd_mma": _ARGS},
    "flash_error_string")
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


def _padded(n: int, block: int = 128) -> int:
    """``n`` rounded up to the reference wrapper's tile for it."""
    b = min(block, max(n, 8))
    return -(-n // b) * b


def flash_attention(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Attention with GQA, causal and sliding-window masks.  q (B, Hq, Sq,
    D); k, v (B, Hkv, Sk, D) with Hq % Hkv == 0; returns (B, Hq, Sq, D) in
    q's dtype.  Any strides with a contiguous last dimension are taken."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    offset = _padded(Sk) - _padded(Sq)
    if not _nvcc.on_card("flash_attention", q, k, v):
        return mha(q, k, v, causal=causal, window=window, sm_scale=scale,
                   offset=offset)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim <= {MAX_HEAD_DIM}, "
                         f"got {D}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    args = (*ptrs, out.data_ptr(), B, Hq, Hkv, Sq, Sk, D, *strides,
            float(scale), int(bool(causal)),
            0 if window is None else int(window), Sk, offset, _nvcc.stream(q))
    if _variant(q.dtype, D, strides, ptrs) == "mma":
        _LIB.call("flash_attention_fwd_mma", *args)
    else:
        _LIB.call("flash_attention_fwd", _DTYPES[q.dtype], *args)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
