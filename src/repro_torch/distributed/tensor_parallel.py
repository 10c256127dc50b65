"""Tensor parallelism on the process binding: what GSPMD partitions for the
reference's sharded serving and training steps, written as explicit
collectives.

Each rank of a :class:`~repro_torch.launch.mesh.ProcessMesh` holds its
block of every parameter and runs the model's own code on local tensors,
so the port's kernels (flash and decode attention, ``gmm``) take the
rank's heads and experts as they take a whole model's.  Collectives sit
where the reference's specs put shard boundaries (``TensorParallel``, the
``tp`` argument of :mod:`repro_torch.models`):

* ``embed/table`` is (model, None): the lookup is masked to the rank's
  vocabulary rows and summed over ``model``; the tied unembedding (or
  ``embed/head``, (None, model)) gives the rank's vocabulary slice of the
  logits, gathered over ``model``, so the argmax is taken over all of
  them.  A vocabulary that does not divide stays whole on every rank, as
  the reference's rule falls back;
* attention: ``wq`` / ``wk`` / ``wv`` column-parallel over heads, ``wo``
  row-parallel and summed over ``model``; the KV cache holds the rank's kv
  heads;
* the gated MLP (and an MoE layer's shared expert): ``wi_gate`` /
  ``wi_up`` column-parallel, ``wo`` row-parallel and summed;
* an MoE layer's routed experts run expert-parallel
  (:func:`repro_torch.models.moe.moe_block_a2a_rank`, through
  :func:`repro_torch.distributed.moe_ep.make_moe_fn`).

Heads, not columns.  The reference's ``"?:model"`` on ``attn/w(q|k|v)``
shards columns and may cut inside a head (the smoke configs' ``wk`` of 2
heads of 16 over a model axis of 4 gives each shard half a head).  The
port cuts on whole heads: ``n_heads`` must divide over ``model``; where
``n_kv_heads`` does not divide, the axis must be a multiple of it, and
each rank keeps the one kv head its query heads read (``Blocks(model,
n_kv_heads)``: model ranks c·Hkv/P share kv head c·Hkv // P).
:func:`param_layout` is :func:`~repro_torch.distributed.sharding.
param_pspecs` with that entry on ``wk`` / ``wv``; it differs from the
reference's spec there alone, and only where the reference would cut a
head.  The cache follows the heads (:func:`cache_layout`) where the
reference's ``cache_pspecs`` shards its sequence axis (GSPMD's partitioned
softmax), so the decode kernel runs unchanged on local heads; a
sequence-sharded decode, the flash-decode combine across ranks, is a later
item.

Every family serves over a model axis above 1.  The hybrid family's
RG-LRU branch runs on the rank's channels of the recurrent width
(``wx_rec`` / ``wx_gate`` / ``conv_w`` columns and the gates' vectors,
``wo``'s rows summed); RWKV6's time mix on the rank's heads (``wr`` /
``wk`` / ``wv`` / ``wg`` / ``w_lora_b`` columns, ``w0``, ``u`` and
``ln_x`` by heads, ``wo`` summed) and its channel mix on the rank's
columns of ``d_ff`` (``wk`` columns, ``wv`` rows summed; ``wr``'s column
block of the receptance gathered whole before it gates the sum); MLA on
the rank's heads of ``wq_b`` / ``wkv_b`` / ``wo`` over the latents, which
every rank computes whole (``wq_a``, ``wkv_a`` and both norms
replicated); whisper's and the vision model's attention, cross attention
included, as the GQA layers, whisper's non-gated FFN as ``mlp`` and its
bare ``embed`` table by vocabulary rows.  Widths that must split are
checked whole (:func:`check_supported`): the reference's ``"?:model"``
keeps a width that does not divide whole on every rank, where the port
refuses it.  Training over a model axis above 1 still refuses those five
families (:data:`REFUSED`; ROADMAP item 12(b)'s training half).

Parameters are replicated over the dp axes, except under fsdp (training
at ``zero_stage`` 3, and serving with ``make_serve_steps(...,
fsdp=True)``, the reference's default for archs over 100B parameters),
where ``param_layout(..., fsdp=True)`` adds the reference's split over
the dp axes and the steps gather each layer's shards
(:class:`FsdpGather`) before the layer runs
(:mod:`repro_torch.train.train_step`, :mod:`repro_torch.train.
serve_step`).

Training runs the same layers under autograd: the collectives carry
their adjoints (:class:`TensorParallel`), and a family's kv heads must
split whole over ``model`` (``check_supported(..., training=True)``).
"""
from __future__ import annotations

import re

import torch

from ..configs.base import ArchConfig
from ..tree import flatten, tree_map
from . import collectives as CL
from .sharding import (DP, TP, Blocks, entry_axes, leaf_cache_pspec,
                       leaf_pspec, local_shape, map_with_path, shard)

#: Families whose layers have no tensor-parallel backward yet: refused
#: over a model axis above 1 in training, served there.
REFUSED = {"hybrid": "the RG-LRU recurrence (channel-sharded)",
           "ssm": "the RWKV6 time mix (heads-sharded)",
           "mla": "MLA (wq_b / wkv_b by heads)",
           "audio": "whisper's encoder-decoder",
           "vlm": "the vision model's cross layers"}
_KV = re.compile(r"attn/w(k|v)$")
#: Cache leaves split over ``model`` as the reference's ``cache_pspecs``
#: splits them: the RG-LRU's channels, RWKV's heads.
_CACHE_AS_REF = re.compile(r"(\bh|\bconv|\bwkv)$")
_KV_CACHE = re.compile(r"\b(k|v)$")


def _widths(cfg: ArchConfig) -> dict:
    """The widths a model axis must split whole, by name."""
    if cfg.family == "ssm":
        return {"n_heads * head_dim": cfg.n_heads * cfg.head_dim_,
                "d_ff": cfg.d_ff}
    widths = {"d_ff": cfg.d_ff}
    if cfg.family == "hybrid":
        widths["hybrid.lru_width"] = cfg.hybrid.lru_width or cfg.d_model
    if cfg.moe is not None:
        mo = cfg.moe
        widths = {"d_ff_dense": mo.d_ff_dense or cfg.d_ff,
                  "n_experts": mo.n_experts}
        if mo.n_shared_experts:
            widths["shared width"] = mo.d_ff_shared * mo.n_shared_experts
    return widths


def check_supported(cfg: ArchConfig, n_tp: int,
                    training: bool = False) -> None:
    """Raise ``ValueError`` where ``cfg`` cannot run over a model axis of
    ``n_tp`` ranks: heads that would be cut, or widths and experts that do
    not divide (:func:`_widths`; MLA's heads among the heads); in
    ``training`` also a family of :data:`REFUSED` and kv heads that do
    not split whole (ranks sharing one would each hold part of its
    gradient)."""
    if n_tp == 1:
        return
    why = REFUSED.get("mla" if cfg.mla is not None else cfg.family)
    if training and why is not None:
        raise ValueError(f"{cfg.name}: the tensor-parallel training step "
                         f"does not run {why} over a model axis of {n_tp} "
                         f"yet (ROADMAP item 12(b), its training half); "
                         f"train it at a model axis of 1")
    if training and cfg.n_kv_heads % n_tp:
        raise ValueError(f"{cfg.name}: training over a model axis of {n_tp} "
                         f"splits the {cfg.n_kv_heads} kv heads whole; they "
                         f"do not divide")
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % n_tp or (hkv % n_tp and n_tp % hkv):
        raise ValueError(f"{cfg.name}: {hq} query / {hkv} kv heads do not "
                         f"split whole over a model axis of {n_tp}")
    if cfg.moe is not None and cfg.moe.router_impl != "a2a":
        raise ValueError(f"{cfg.name}: experts over a model axis run "
                         f"the a2a block; router_impl is "
                         f"{cfg.moe.router_impl!r}")
    for name, w in _widths(cfg).items():
        if w % n_tp:
            raise ValueError(f"{cfg.name}: {name} {w} does not split over "
                             f"a model axis of {n_tp}")


def kv_entry(cfg: ArchConfig, n_tp: int):
    """The kv-head dimension's spec entry over a model axis of ``n_tp``."""
    if cfg.n_kv_heads % n_tp == 0:
        return TP
    return Blocks(TP, cfg.n_kv_heads)


def leaf_layout(path: str, shape, cfg: ArchConfig, mesh,
                fsdp: bool = False) -> tuple:
    """The block of a parameter leaf each rank holds: the reference's spec
    (:func:`~repro_torch.distributed.sharding.leaf_pspec`, with ``fsdp``
    its extra split over the dp axes), with :func:`kv_entry` on ``wk`` /
    ``wv`` over a model axis above 1."""
    spec = leaf_pspec(path, shape, mesh, fsdp)
    n_tp = mesh.shape[TP]
    if n_tp > 1 and _KV.search(path):
        return (spec[0] if spec else None, kv_entry(cfg, n_tp))
    return spec


def param_layout(params, cfg: ArchConfig, mesh, fsdp: bool = False):
    """:func:`leaf_layout` of every leaf of ``params`` (full shapes; meta
    tensors will do)."""
    check_supported(cfg, mesh.shape[TP])
    return map_with_path(
        lambda p, leaf: leaf_layout(p, tuple(leaf.shape), cfg, mesh, fsdp),
        params)


def cache_layout(caches, cfg: ArchConfig, mesh):
    """The block of each decode-cache leaf a rank holds: the batch over the
    dp axes where it divides (the reference's ``cache_pspecs``); over
    ``model``, the RG-LRU's ``h`` / ``conv`` by channels and RWKV's
    ``wkv`` by heads, as the reference lays them out; a KV cache
    (whisper's ``self_kv`` / ``cross_kv`` and a cross layer's among them)
    by the rank's kv heads (:func:`kv_entry`) with its sequence whole,
    where the reference shards the sequence; MLA's ``ckv`` / ``krope``,
    which every head reads, and RWKV's ``shift_t`` / ``shift_c``, the last
    whole input, whole on every model rank."""
    n_tp = mesh.shape[TP]
    check_supported(cfg, n_tp)

    def leaf(path, t):
        spec = list(leaf_cache_pspec(path, tuple(t.shape), mesh))
        if not _CACHE_AS_REF.search(path):
            spec = [None if e == TP else e for e in spec]
        if n_tp > 1 and _KV_CACHE.search(path) and t.dim() >= 4:
            spec[-3] = kv_entry(cfg, n_tp)
        return tuple(spec)

    return map_with_path(leaf, caches)


class FsdpGather:
    """fsdp's gather, the ``gather`` hook of :func:`~repro_torch.models.
    build_model`: ``gather(tree)`` is ``tree`` with every leaf whose spec
    splits over the dp axes gathered whole over them, pod-major
    (:func:`~repro_torch.distributed.collectives.gather_param`), its model
    blocks kept.  The layers hand it subtrees, so it knows a leaf by
    identity: :meth:`bind` maps a step's own parameter leaves to their
    specs in ``layout`` (of the whole tree ``full``, by path) as the step
    starts."""

    def __init__(self, mesh, full, layout):
        self.mesh = mesh
        specs = []
        tree_map(lambda _t, spec: specs.append(tuple(spec)), full, layout)
        self.by_path = dict(zip((p for p, _ in flatten(full)), specs))
        self.spec_of = {}

    def bind(self, params) -> None:
        self.spec_of = {id(t): self.by_path[p] for p, t in flatten(params)}

    def __call__(self, tree):
        def one(t):
            for dim, e in enumerate(self.spec_of.get(id(t), ())):
                if set(DP) & set(entry_axes(e)):
                    return CL.gather_param(t, self.mesh, entry_axes(e), dim)
            return t
        return tree_map(one, tree)


def shard_tree(tree, layout, mesh):
    """Every leaf of a full ``tree`` cut to this rank's block (copies)."""
    return tree_map(lambda t, spec: shard(t, spec, mesh).clone(), tree,
                    layout)


def empty_like_layout(tree, layout, mesh, device):
    """Zeros of this rank's block shapes of a full ``tree`` (meta tensors
    will do), on ``device``."""
    return tree_map(lambda t, spec: torch.zeros(
        local_shape(t.shape, spec, mesh), dtype=t.dtype, device=device),
        tree, layout)


class TensorParallel:
    """What a model layer asks of the process mesh on the tensor-parallel
    path: the sum and the gather over ``model``, the column-parallel
    input, and the vocabulary-sharded lookup.  Under autograd each is its
    own adjoint's partner (:mod:`repro_torch.distributed.collectives`):
    the sum passes the gradient through, the input's gradient is summed,
    the gather keeps the rank's slice."""

    def __init__(self, cfg: ArchConfig, mesh):
        self.mesh = mesh
        self.n = mesh.shape[TP]
        self.index = mesh.coord(TP)
        self.vocab_sharded = cfg.vocab % self.n == 0

    def psum(self, x):
        return CL.psum(x, self.mesh, TP)

    def gather(self, x, dim: int):
        return CL.all_gather(x, self.mesh, TP, dim)

    def copy(self, x):
        """``x`` as a column-parallel layer's input."""
        return CL.copy_to(x, self.mesh, TP)

    def embed(self, table, tokens):
        """Rows of the rank's (V / P, d) block of the table for the tokens
        it holds, zeros for the others, summed over ``model``."""
        n = table.shape[0]
        local = tokens - self.index * n
        hit = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        return self.psum(torch.where(hit[..., None], rows,
                                     rows.new_zeros(())))


def init_params(cfg: ArchConfig, generator: torch.Generator, mesh,
                fsdp: bool = False):
    """This rank's parameters, drawn from ``generator`` (on its device) by
    ``build_model(cfg).init``, keeping the rank's block of each group of
    leaves as it is drawn (an MoE layer's experts are drawn one at a time
    and only the rank's kept), so the peak is one layer's leaves drawn
    whole, its routed experts aside, not the model.  ``fsdp``: the blocks
    of ``param_layout(..., fsdp=True)``, split over the dp axes too.
    Every family's ``init`` takes the ``keep`` hook (the encoder-decoder
    and RWKV draw no experts).  The same seed gives every rank its block
    of the same model."""
    from ..models.layers import MetaGenerator
    from ..models.model import build_model
    model = build_model(cfg)
    n_tp = mesh.shape[TP]
    split_dp = fsdp and any(mesh.shape.get(a, 1) > 1 for a in DP)
    if n_tp == 1 and not split_dp:     # every leaf whole on every rank
        return model.init(generator)
    full = model.init(MetaGenerator())
    layout = param_layout(full, cfg, mesh, fsdp)
    e, j = cfg.moe.n_experts if cfg.moe else 0, mesh.coord(TP)
    experts = (j * e // n_tp, (j + 1) * e // n_tp) \
        if cfg.moe and n_tp > 1 else None

    def one(t, f, spec):
        if tuple(t.shape) == tuple(f.shape):
            return shard(t, spec, mesh).clone()
        # drawn as the rank's block over ``model``: cut its dp entries
        model_only = tuple(e if TP in entry_axes(e) else None for e in spec)
        if tuple(t.shape) != local_shape(f.shape, model_only, mesh):
            raise ValueError(f"a leaf of {tuple(t.shape)} is neither "
                             f"whole {tuple(f.shape)} nor a block")
        dp_only = tuple(None if TP in entry_axes(e) else e for e in spec)
        return shard(t, dp_only, mesh).clone() if any(dp_only) else t

    def keep(path, tree):
        f, spec = full, layout
        for k in path:
            f, spec = f[k], spec[k]
        return tree_map(one, tree, f, spec)

    return model.init(generator, experts, keep)
