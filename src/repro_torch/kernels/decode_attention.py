"""Flash-decode for Hopper: one query token per sequence against its KV
cache, the counterpart of ``repro/kernels/decode_attention.py`` and of its
wrapper ``repro/kernels/ops.py::decode_attention``.

On a CUDA tensor :func:`decode_attention` launches the hand-written kernel
of ``csrc/decode_attention.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use) or raises; on a CPU tensor it runs the kernel's plain PyTorch version,
:func:`repro_torch.kernels.ref.decode_attention`.
``decode_attention.launches`` counts kernel launches.

The kernel splits the cache's S slots into chunks across blocks
(:func:`_split`, from the shapes alone: the wrapper never reads ``lengths``
on the host), takes a kv head's query heads in tiles of :data:`GROUP_TILE`
(MLA's absorbed decode has 128 on one latent kv head) and combines the
chunks' partials in the same launch; the plain version of that algorithm is
:func:`repro_torch.kernels.ref.decode_attention_split`.  The combine keeps
one int32 arrival counter per (b, kv head, group tile) in a buffer made
once per device and stream (:data:`_ARRIVALS`); the kernel leaves every
counter at 0.

The reference wrapper pads the cache to its key tile; padded positions lie
past every length, so they change nothing, and the port's kernel stops at
``lengths[b]`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc
from . import ref

#: Largest head dimension the kernel takes: MLA's latent cache (512 + 64)
#: in bfloat16; float32 stops at :data:`MAX_HEAD_DIM_F32`, since its two
#: 64-key tiles at D = 576 would not fit a block's shared memory.
MAX_HEAD_DIM = 576
MAX_HEAD_DIM_F32 = 256
#: Largest query-head group (Hq / Hkv): MLA's 128 heads on one kv head.
MAX_GROUP = 128
#: Query heads a block takes; a larger group is tiled over the grid.
GROUP_TILE = 16

#: Keys a split's chunk holds: a multiple of the kernel's 64-key tile.
CHUNK = 64
#: Blocks the split aims for: two per SM of an H100 (132 SMs).
TARGET_BLOCKS = 2 * 132

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = _nvcc.Library(
    "decode_attention",
    {"decode_attention_fwd": [_I] + [_P] * 7 + [_I] * 8 + [_L] * 6
     + [ctypes.c_float, _P]},
    "decode_error_string")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (device, stream) -> the int32 arrival counters of the split combine.
_ARRIVALS: dict = {}


def _group_tiles(G: int) -> int:
    return max(1, -(-G // GROUP_TILE))


def _split(B: int, Hkv: int, S: int, G: int = 1) -> tuple[int, int]:
    """(splits, chunk) for a (B, Hkv, S, D) cache read by G query heads a
    kv head: chunks of a multiple of :data:`CHUNK` keys, no smaller, so that
    B·Hkv·(group tiles)·splits reaches :data:`TARGET_BLOCKS` where S
    allows; one split when S fits one chunk.  Every split's chunk starts
    below S."""
    want = -(-TARGET_BLOCKS // max(1, B * Hkv * _group_tiles(G)))
    chunk = max(CHUNK, -(-S // (want * CHUNK)) * CHUNK)
    return max(1, -(-S // chunk)), chunk


def _arrivals(device, stream: int, n: int):
    """The zeroed int32 arrival counters of ``device`` and ``stream``, at
    least ``n`` of them; made once and kept (the kernel resets each counter
    it uses)."""
    buf = _ARRIVALS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[(device, stream)] = buf
    return buf


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale=None):
    """q (B, Hq, D); caches (B, Hkv, S, D); lengths (B,) int — valid cache
    positions per sequence.  Returns (B, Hq, D) in q's dtype; a sequence of
    length 0 gets zeros.  Caches may have any strides with a contiguous
    last dimension."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if Hq % Hkv or k_cache.shape != v_cache.shape or \
            k_cache.shape[0] != B or k_cache.shape[3] != D or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    scale = sm_scale if sm_scale is not None else 1.0 / D ** 0.5
    if not _nvcc.on_card("decode_attention", q, k_cache, v_cache, lengths):
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    sm_scale=scale)
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q and "
                        f"caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    max_d = MAX_HEAD_DIM if q.dtype == torch.bfloat16 else MAX_HEAD_DIM_F32
    if D > max_d or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention takes head_dim <= {max_d} in "
                         f"{str(q.dtype)[6:]} and Hq/Hkv <= {MAX_GROUP}, got "
                         f"{D} and {Hq // Hkv}")
    q = q.contiguous()
    k_cache, v_cache = (t if t.stride(-1) == 1 else t.contiguous()
                        for t in (k_cache, v_cache))
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    strides = (*k_cache.stride()[:3], *v_cache.stride()[:3])
    per16 = 16 // q.element_size()
    vec = int(D % per16 == 0 and all(st % per16 == 0 for st in strides)
              and k_cache.data_ptr() % 16 == 0
              and v_cache.data_ptr() % 16 == 0)
    splits, chunk = _split(B, Hkv, S, Hq // Hkv)
    stream = _nvcc.stream(q)
    ws = arrivals = None
    if splits > 1:       # both live until the launch is queued
        arrivals = _arrivals(q.device, stream,
                             B * Hkv * _group_tiles(Hq // Hkv))
        ws = torch.empty((B, Hq, splits, D + 2), dtype=torch.float32,
                         device=q.device)
    _LIB.call("decode_attention_fwd", _DTYPES[q.dtype], q.data_ptr(),
              k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
              out.data_ptr(), 0 if ws is None else ws.data_ptr(),
              0 if arrivals is None else arrivals.data_ptr(), B, Hq, Hkv, S,
              D, chunk, splits, vec, *strides, float(scale), stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
