"""uint32 arithmetic for the port.

The JAX package computes hashes, checksums, tickets and slot counters in
uint32 with wraparound.  PyTorch's uint32 support is partial, so the port
holds a uint32 value in an int64 tensor, in ``[0, 2**32)``, and masks every
result with :data:`MASK32`.  Where the reference stores an int32 bit pattern
(index rows, encoded rows) the port stores the same int32 bits;
:func:`u2i` and :func:`i2u` are the bit casts between the two.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor, array or number → int64 holding its uint32 bits."""
    if not isinstance(x, torch.Tensor):
        import numpy as np
        x = torch.from_numpy(np.array(x, dtype=np.int64))
    return x.to(device=device, dtype=torch.int64) & MASK32


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for uint32 ``a`` (int64) and a uint32 constant,
    in 16-bit halves so no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def u2i(x: torch.Tensor) -> torch.Tensor:
    """uint32 (int64 holder) → int32 with the same bits."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def i2u(x: torch.Tensor) -> torch.Tensor:
    """int32 bits → uint32 (int64 holder)."""
    return x.to(torch.int64) & MASK32


def to_words(v: torch.Tensor) -> torch.Tensor:
    """A (P, ...) tensor as (P, k) int32 words, bit for bit: uint32 holders
    (int64) keep their low 32 bits, bools become 0/1, floats carry their
    float32 bits and other integers their int32 bits."""
    if v.dtype == torch.bool:
        w = v.to(torch.int32)
    elif v.dtype == torch.int64:
        w = u2i(v)
    elif v.is_floating_point():
        w = v.to(torch.float32).contiguous().view(torch.int32)
    else:
        w = v.to(torch.int32)
    return w.reshape(v.shape[0], -1)


def from_words(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_words` for a tensor shaped like ``like``."""
    w = w.reshape(like.shape)
    if like.dtype == torch.bool:
        return w != 0
    if like.dtype == torch.int64:
        return i2u(w)
    if like.is_floating_point():
        return w.view(torch.float32).to(like.dtype)
    return w.to(like.dtype)
