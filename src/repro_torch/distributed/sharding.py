"""Sharding rules: parameter-tree paths → partition specs, the counterpart
of ``repro/distributed/sharding.py``, ported whole.

Parallelism map (DESIGN.md §6):
  TP  — 'model' axis: attention heads / FFN columns (Megatron),
        vocab-sharded embeddings, EP for MoE experts, channel-sharded
        recurrent widths;
  DP  — ('pod', 'data'): batch;
  SP  — optional: activations seq-sharded over 'model' between blocks;
  ZeRO— optimizer state additionally sharded over the DP axes (stage ≥ 2).

Rules are (regex over the '/'-joined tree path) → dims template, where each
template entry names the mesh axis of that dimension (None = replicated);
'?:axis' shards the dim only if divisible (falls back to None), which keeps
one rule table valid across all ten archs and the smoke configs.

A spec is a plain tuple with one entry per dimension of its leaf: None, an
axis name, or a tuple of axis names (the dp axes, when there are two); the
empty tuple replicates the whole leaf.  A tuple of one axis is written as
the name, as ``jax.sharding.PartitionSpec`` writes it.  Paths are the
port's (:mod:`repro_torch.tree`: ``layers/3/attn/wq``); the rules match the
end of a path, so the port's per-layer leaves take the rule of the
reference's stacked ones, whose leading stack dims the reference leaves
replicated.  Every function takes any mesh with ``shape`` (axis name →
size): a :class:`~repro_torch.launch.mesh.StackedMesh` or a
:class:`~repro_torch.launch.mesh.ProcessMesh`.

:func:`shard` cuts a full tensor into one rank's block by a spec and
:func:`assemble` puts every rank's blocks back together.  A spec entry may
also be a :class:`Blocks`, which the process binding's head-granular
layout uses (:mod:`repro_torch.distributed.tensor_parallel`).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Sequence, Tuple

import torch

from ..tree import flatten, unflatten

DP = ("pod", "data")      # flattened data-parallel axes (pod absent → data)
TP = "model"
#: The reference's fsdp threshold: a leaf of this many elements or more
#: also shards over the dp axes (``leaf_pspec``).
FSDP_MIN_ELEMENTS = 1 << 20

# (path regex, dims template).  First match wins.  Templates align to the
# TRAILING dims of each leaf (leading layer-stack dims are replicated).
PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / unembedding
    (r"embed/table$", (TP, None)),
    (r"embed/head$", (None, TP)),
    (r"(enc_pos|dec_pos)$", (None, None)),
    (r"embed$", (TP, None)),                       # whisper raw table
    # MoE
    (r"ffn/router$", (None, None)),
    (r"ffn/experts/wi_(gate|up)$", (TP, None, None)),   # EP over experts
    (r"ffn/experts/wo$", (TP, None, None)),
    (r"ffn/shared/(wi_gate|wi_up)$", (None, TP)),
    (r"ffn/shared/wo$", (TP, None)),
    # attention (GQA + whisper enc/dec + cross)
    (r"attn/w(q|k|v)$", (None, "?:" + TP)),
    (r"attn/wo$", (TP, None)),
    # MLA
    (r"attn/wq_a$", (None, None)),
    (r"attn/wq_b$", (None, TP)),
    (r"attn/wkv_a$", (None, None)),
    (r"attn/wkv_b$", (None, TP)),
    # RG-LRU recurrent branch (channel-sharded)
    (r"temporal/wx_(rec|gate)$", (None, TP)),
    (r"temporal/conv_w$", (None, TP)),
    (r"temporal/(conv_b|w_a|b_a|w_i|b_i|lam)$", ("?:" + TP,)),
    (r"temporal/wo$", (TP, None)),
    # RWKV6
    (r"time/w(r|k|v|g)$", (None, TP)),
    (r"time/wo$", (TP, None)),
    (r"time/w0$", ("?:" + TP,)),
    (r"time/w_lora_a$", (None, None)),
    (r"time/w_lora_b$", (None, TP)),
    (r"time/u$", ("?:" + TP, None)),
    (r"time/ln_x/(scale|bias)$", ("?:" + TP,)),
    (r"time/mu$", (None, None)),
    (r"chan/wk$", (None, TP)),
    (r"chan/wv$", (TP, None)),
    (r"chan/wr$", (None, TP)),
    (r"chan/mu$", (None, None)),
    # dense FFN
    (r"ffn/(wi_gate|wi_up|wi)$", (None, TP)),
    (r"ffn/wo$", (TP, None)),
    # MTP fusion projection
    (r"mtp/proj$", (None, None)),
    # everything normish / scalar gates
    (r".*", None),
)


@dataclasses.dataclass(frozen=True)
class Blocks:
    """A spec entry: the dimension splits into ``n`` equal blocks, and the
    rank at coordinate c of ``axis`` (of size P, a multiple of n) holds
    block ``c · n // P`` — P / n consecutive ranks share each block.  With
    n = P it is the plain split over ``axis``."""
    axis: str
    n: int


def _axes(names: Sequence[str]):
    """A spec entry for ``names``: the name of one axis, else the tuple."""
    names = tuple(names)
    return names[0] if len(names) == 1 else names


def map_with_path(fn, tree):
    """``fn(path, leaf)`` at every leaf, in a tree of ``tree``'s
    structure."""
    return unflatten(tree, [fn(p, leaf) for p, leaf in flatten(tree)])


def _resolve_template(template, shape, mesh) -> tuple:
    """Align template to trailing dims; honor '?:axis' divisibility."""
    if template is None:
        return ()
    ndim = len(shape)
    dims: list = [None] * ndim
    t = list(template)[-ndim:] if len(template) > ndim else list(template)
    offset = ndim - len(t)
    for i, ax in enumerate(t):
        if ax is None:
            continue
        optional = isinstance(ax, str) and ax.startswith("?:")
        axis = ax[2:] if optional else ax
        if axis not in mesh.shape:
            continue
        if shape[offset + i] % mesh.shape[axis] == 0:
            dims[offset + i] = axis
        # otherwise (optional or not) the dim stays replicated, as the
        # reference falls back rather than crash
    return tuple(dims)


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def leaf_pspec(path: str, shape, mesh, fsdp: bool = False) -> tuple:
    """The spec of one parameter leaf of ``shape`` at ``path``: the first
    rule whose regex matches, resolved against ``mesh``; with ``fsdp`` a
    leaf of ``FSDP_MIN_ELEMENTS`` (2²⁰) elements or more also shards its
    first free dim that divides over the dp axes."""
    spec = ()
    for pat, template in PARAM_RULES:
        if re.search(pat, path):
            spec = _resolve_template(template, tuple(shape), mesh)
            break
    dp = dp_axes(mesh)
    if fsdp and dp and math.prod(shape) >= FSDP_MIN_ELEMENTS:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for i, d in enumerate(dims):
            if d is None and shape[i] % _size(mesh, dp) == 0:
                dims[i] = _axes(dp)
                return tuple(dims)
    return spec


def param_pspecs(params, mesh, fsdp: bool = False) -> Any:
    """Spec tree for a parameter tree.

    fsdp=True (ZeRO-3 / giant archs): large leaves additionally shard their
    first free divisible dim over the data axes — weights are all-gathered
    per layer (one layer resident at a time), which is what lets 400B/671B
    params fit 16 GB chips at TP=16."""
    return map_with_path(
        lambda p, leaf: leaf_pspec(p, tuple(leaf.shape), mesh, fsdp), params)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes ``mesh`` has, pod before data."""
    return tuple(a for a in DP if a in mesh.shape)


def batch_pspecs(batch_tree, mesh, seq_shard: bool = False):
    """tokens (B, S[+1]) over DP; context (B, n, d) over DP (+SP)."""
    dp = dp_axes(mesh)

    def spec(_path, leaf):
        shape = tuple(leaf.shape)
        b_ok = shape[0] % _size(mesh, dp) == 0
        first = _axes(dp) if (dp and b_ok) else None
        if len(shape) == 3 and seq_shard and shape[1] % mesh.shape[TP] == 0:
            return (first, TP, None)
        return tuple([first] + [None] * (len(shape) - 1))

    return map_with_path(spec, batch_tree)


def _cache_dims(path: str, ndim: int):
    """A cache leaf's (batch dim, sharded dim) by its field name, from the
    right, so leading stack dims are skipped:

      KV k/v:      (B, Hkv, S, hd)   → S
      MLA ckv:     (B, S, R)         → S
      rwkv wkv:    (B, H, D, D)      → H
      rec conv:    (B, c, W)         → W
      else         (B, W)            → W."""
    if re.search(r"(\bk$|\bv$|self_kv|cross_kv)", path) and ndim >= 4:
        return ndim - 4, ndim - 2
    if "ckv" in path or "krope" in path:
        return ndim - 3, ndim - 2
    if "wkv" in path and ndim >= 4:
        return ndim - 4, ndim - 3
    if path.endswith("conv") and ndim >= 3:
        return ndim - 3, ndim - 1
    if ndim >= 2:
        return ndim - 2, ndim - 1
    return None


def leaf_cache_pspec(path: str, shape, mesh) -> tuple:
    """The spec of one decode-cache leaf: batch over DP when divisible; the
    long axis (KV seq / heads / channels) over 'model' when divisible
    (:func:`_cache_dims`)."""
    dp = dp_axes(mesh)
    dims: list = [None] * len(shape)
    bs = _cache_dims(path, len(shape))
    if bs is None:
        return tuple(dims)
    b, s = bs
    if dp and shape[b] % _size(mesh, dp) == 0 and shape[b] > 0:
        dims[b] = _axes(dp)
    if shape[s] % mesh.shape[TP] == 0:
        dims[s] = TP
    return tuple(dims)


def cache_pspecs(cache_tree, mesh):
    """Spec tree for a decode-cache tree (:func:`leaf_cache_pspec`)."""
    return map_with_path(
        lambda p, leaf: leaf_cache_pspec(p, tuple(leaf.shape), mesh),
        cache_tree)


# ------------------------------------------------------ blocks of a tensor
def _block_of(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(number of blocks, this coordinate's block) of a spec entry."""
    if isinstance(entry, Blocks):
        size = mesh.shape[entry.axis]
        if size % entry.n:
            raise ValueError(f"{entry} does not divide an axis of {size}")
        return entry.n, coords[entry.axis] * entry.n // size
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    n, index = 1, 0
    for a in axes:
        n, index = n * mesh.shape[a], index * mesh.shape[a] + coords[a]
    return n, index


def _slices(spec, shape, mesh, coords):
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(slice(None))
            continue
        n, i = _block_of(entry, mesh, coords)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} blocks ({entry})")
        w = shape[dim] // n
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under
    ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= _block_of(entry, mesh, rank_coords(mesh, 0))[0]
    return tuple(out)


def shard(x: torch.Tensor, spec: tuple, mesh, coords=None) -> torch.Tensor:
    """The block of the full tensor ``x`` that the rank at ``coords``
    (default: ``mesh.coords``, this rank's) holds under ``spec``: a view."""
    coords = mesh.coords if coords is None else coords
    return x[_slices(spec, x.shape, mesh, coords)]


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """The coordinates of flat ``rank`` (row-major over the mesh's axes)."""
    out = {}
    for a in reversed(mesh.axis_names):
        out[a] = rank % mesh.shape[a]
        rank //= mesh.shape[a]
    return out


def assemble(shards: Sequence[torch.Tensor], spec: tuple,
             mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec``:
    ``shards[r]`` is flat rank r's.  Ranks that hold the same block
    (replicas) must hold equal values."""
    first = shards[0]
    full = list(first.shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            full[dim] *= _block_of(entry, mesh, rank_coords(mesh, 0))[0]
    out = first.new_empty(full)
    seen = set()
    for r, s in enumerate(shards):
        sl = _slices(spec, full, mesh, rank_coords(mesh, r))
        key = tuple((x.start, x.stop) for x in sl)
        if key in seen:
            if not torch.equal(out[sl], s):
                raise ValueError(f"rank {r}'s block differs from its "
                                 f"replica's")
            continue
        seen.add(key)
        out[sl] = s
    return out


# ------------------------------------------------ blocks between processes
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a process mesh: ``spec`` over ``mesh``, the
    counterpart of ``jax.sharding.NamedSharding`` (what the checkpoint's
    ``restore`` cuts a whole leaf by, and ``save`` gathers one by)."""
    mesh: Any
    spec: tuple


def named(like, specs, mesh):
    """A tree of :class:`NamedSharding`, one for each leaf of the tensor
    tree ``like`` from its spec in ``specs`` (a spec is a tuple, so the walk
    follows ``like``)."""
    from ..tree import tree_map
    return tree_map(lambda _t, s: NamedSharding(mesh, s), like, specs)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry splits over, outer first."""
    if entry is None:
        return ()
    if isinstance(entry, Blocks):
        return (entry.axis,)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block ``x`` under ``spec``, on
    every rank of the process ``mesh`` (each split dim all-gathered over
    its axes, the inner axis first; a :class:`Blocks` entry keeps one of
    each run of replicated blocks).  Every rank must call it."""
    from . import collectives as CL
    for dim, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):
            x = CL.all_gather(x, mesh, axis, dim)
        if isinstance(entry, Blocks):
            n_rep = mesh.shape[entry.axis] // entry.n
            w = x.shape[dim] // mesh.shape[entry.axis]
            x = torch.cat([x.narrow(dim, b * n_rep * w, w)
                           for b in range(entry.n)], dim)
    return x
