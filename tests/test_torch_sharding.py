"""The port's sharding rules against the JAX package's, on the CPU with no
process group.

* ``param_pspecs`` (with and without ``fsdp``), ``batch_pspecs`` and
  ``cache_pspecs`` against the reference's, leaf by leaf, for the smoke
  parameter and cache trees of all ten registry architectures, on (2, 4)
  (data, model) and (2, 2, 2) (pod, data, model) meshes: the reference's
  functions on the port's trees (as ``jax.ShapeDtypeStruct`` leaves), and
  the reference's own stacked parameter tree (``jax.eval_shape`` of its
  ``init``), each of its leaves followed through ``params_from_jax`` to the
  port's leaf it becomes, where the port's spec must be the reference's
  without the stack dims (which the reference leaves replicated).  The
  reference's meshes come from ``compat_abstract_mesh``;
* ``shard`` and ``assemble`` round-trip, ``Blocks`` entries (replicated
  blocks) among the specs;
* the process binding's head-granular layout (``param_layout``,
  ``cache_layout``) differs from the reference's specs only where a head
  would be cut — ``wk`` / ``wv`` when the kv heads do not divide over
  ``model`` — and, for the cache, where the reference shards the
  sequence (a KV cache, MLA's latents) or RWKV's shift states' width;
  the RG-LRU's and RWKV's states split as the reference splits them.
  Every family serves over ``model``; the hybrid, ssm, MLA, audio and
  vlm families are refused there in training, and heads and widths that
  do not split are refused;
* each rank's sharded init (``init_params``) is bitwise its block of the
  whole model's init from the same seed, an MoE rank's experts among
  them."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch.mesh import compat_abstract_mesh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import tensor_parallel as TPL  # noqa: E402
from repro_torch.launch.mesh import StackedMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

MESHES = {(2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}
DENSE = ["llama3.2-3b", "qwen3-8b", "gemma-2b", "internlm2-20b",
         "llama4-maverick-400b-a17b"]
#: The families that serve over ``model`` and train only at a model axis
#: of 1 (ROADMAP item 12(b)'s training half).
SERVE_ONLY = ["recurrentgemma-2b", "rwkv6-7b", "deepseek-v3-671b",
              "whisper-large-v3", "llama-3.2-vision-11b"]
PSpec = jax.sharding.PartitionSpec


def _meshes(sizes):
    names = MESHES[sizes]
    return compat_abstract_mesh(sizes, names), StackedMesh(sizes, names)


def _as_jax(tree):
    """A port tree as the same structure of ``jax.ShapeDtypeStruct``s."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_as_jax(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_jax(v) for v in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _ref_specs(specs, like=None):
    """The reference's spec tree as tuples in the port tree ``like``'s leaf
    order (None: in the reference's own)."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PSpec))[0]
    if like is None:
        return [tuple(s) for _p, s in flat]
    by_path = {JSH._path_str(p): tuple(s) for p, s in flat}
    assert len(by_path) == len(flatten(like))
    return [by_path[p] for p, _ in flatten(like)]


def _port_specs(specs, like):
    """The port's spec tree in ``like``'s leaf order (a spec is a tuple, so
    the walk follows ``like``'s structure)."""
    out = []
    tree_map(lambda _t, s: out.append(s), like, specs)
    return out


def _port_tree(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    return cfg, model.init(MetaGenerator()), model.init_cache(4, 16,
                                                              device="meta")


# ------------------------------------------------- the rules, leaf by leaf
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("sizes", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_match_the_reference_on_the_ports_trees(arch, sizes, fsdp):
    jmesh, mesh = _meshes(sizes)
    _cfg, params, cache = _port_tree(arch)
    want = _ref_specs(JSH.param_pspecs(_as_jax(params), jmesh, fsdp=fsdp),
                      params)
    got = _port_specs(SH.param_pspecs(params, mesh, fsdp=fsdp), params)
    paths = [p for p, _ in flatten(params)]
    assert dict(zip(paths, got)) == dict(zip(paths, want))
    assert any(s for s in got), "some leaf is sharded"
    want = _ref_specs(JSH.cache_pspecs(_as_jax(cache), jmesh), cache)
    got = _port_specs(SH.cache_pspecs(cache, mesh), cache)
    paths = [p for p, _ in flatten(cache)]
    assert dict(zip(paths, got)) == dict(zip(paths, want))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("sizes", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_the_references_own_tree(arch, sizes, fsdp):
    """Every leaf of the reference's stacked tree, numbered, goes through
    ``params_from_jax``; each port leaf's spec is its reference leaf's spec
    without the leading stack dims, which are replicated there."""
    jmesh, mesh = _meshes(sizes)
    jshapes = jax.eval_shape(jax_build(jax_smoke(arch)).init,
                             jax.random.PRNGKey(0))
    jflat, treedef = jax.tree_util.tree_flatten(jshapes)
    numbered = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.int32) for i, s in
                  enumerate(jflat)])
    jspecs = _ref_specs(JSH.param_pspecs(jshapes, jmesh, fsdp=fsdp))
    assert len(jspecs) == len(jflat)
    params = params_from_jax(numbered, device="cpu")
    got = _port_specs(SH.param_pspecs(params, mesh, fsdp=fsdp), params)
    seen = set()
    for (path, leaf), spec in zip(flatten(params), got):
        i = int(leaf.reshape(-1)[0]) if leaf.numel() else None
        assert i is not None
        seen.add(i)
        want = jspecs[i]
        stack = len(jflat[i].shape) - leaf.dim()
        if want:
            assert all(d is None for d in want[:stack]), (path, want)
            want = want[stack:]
        assert spec == want, (path, spec, want)
    assert seen == set(range(len(jflat)))


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("B", [8, 3])
@pytest.mark.parametrize("sizes", list(MESHES))
def test_batch_pspecs_match_the_reference(sizes, B, seq_shard):
    jmesh, mesh = _meshes(sizes)
    batch = {"tokens": torch.empty((B, 17), device="meta"),
             "context": torch.empty((B, 8, 64), device="meta"),
             "odd": torch.empty((B, 6, 64), device="meta")}
    want = JSH.batch_pspecs(_as_jax(batch), jmesh, seq_shard=seq_shard)
    got = SH.batch_pspecs(batch, mesh, seq_shard=seq_shard)
    assert {k: tuple(v) for k, v in want.items()} == got


# ------------------------------------------------------------ shard/assemble
CASES = [
    ((2, 4), ("data", "model"), (None, "model")),
    ((2, 4), ("data", "model"), ("model", None)),
    ((2, 4), ("data", "model"), ("data", None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model", None)),
    ((1, 4), ("data", "model"), (None, SH.Blocks("model", 2))),
    ((2, 4), ("data", "model"), ("data", SH.Blocks("model", 1))),
    ((2, 2), ("data", "model"), ()),
]


@pytest.mark.parametrize("sizes, names, spec", CASES)
def test_shard_and_assemble_round_trip(sizes, names, spec):
    mesh = StackedMesh(sizes, names)
    x = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)[
        (slice(None),) * max(len(spec), 2)]
    world = int(np.prod(sizes))
    blocks = [SH.shard(x, spec, mesh, SH.rank_coords(mesh, r))
              for r in range(world)]
    for b in blocks:
        assert tuple(b.shape) == SH.local_shape(x.shape, spec, mesh)
    assert torch.equal(SH.assemble(blocks, spec, mesh), x)
    if len({tuple(b.flatten().tolist()) for b in blocks}) < world:
        bad = [b.clone() for b in blocks]
        bad[-1] += 1
        with pytest.raises(ValueError, match="replica"):
            SH.assemble(bad, spec, mesh)


class _Rank(StackedMesh):
    """A stacked mesh seen from one rank: ``coords`` and ``coord``, as a
    :class:`~repro_torch.launch.mesh.ProcessMesh` has them."""

    def __init__(self, sizes, names, rank):
        super().__init__(sizes, names)
        object.__setattr__(self, "coords", SH.rank_coords(self, rank))

    def coord(self, axis):
        return self.coords[axis]


# --------------------------------------------------- the head-granular layout
def _cache_leaf_layout(path, ref, lay, cut, cfg):
    """A cache leaf's port entries against the reference's: a KV cache by
    kv heads, its sequence whole; MLA's latents and RWKV's shift states
    whole over ``model``; the RG-LRU's and RWKV's states as the
    reference's."""
    tail = path.split("/")[-1]
    if tail in ("k", "v"):
        assert ref[0] == lay[0] and ref[2] == "model" and lay[2] is None
        assert lay[1] == (SH.Blocks("model", cfg.n_kv_heads) if cut
                          else "model"), path
    elif tail in ("ckv", "krope", "shift_t", "shift_c"):
        assert "model" in ref and "model" not in lay, path
        assert lay == tuple(None if e == "model" else e for e in ref), path
    else:
        assert tail in ("h", "conv", "wkv"), path
        assert "model" in lay and lay == ref, path


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", DENSE + SERVE_ONLY)
def test_the_layout_differs_from_the_reference_only_where_a_head_is_cut(
        arch, sizes):
    mesh = StackedMesh(sizes, ("data", "model"))
    cfg, params, cache = _port_tree(arch)
    tp = sizes[1]
    cut = cfg.n_kv_heads % tp != 0
    spec = SH.param_pspecs(params, mesh)
    layout = TPL.param_layout(params, cfg, mesh)
    for (path, leaf), s, lay in zip(flatten(params),
                                    _port_specs(spec, params),
                                    _port_specs(layout, params)):
        if cut and (path.endswith("attn/wk") or path.endswith("attn/wv")):
            assert lay == (None, SH.Blocks("model", cfg.n_kv_heads)), path
            assert s != lay
        else:
            assert lay == s, path
    for (path, leaf), s, lay in zip(flatten(cache),
                                    _port_specs(SH.cache_pspecs(cache, mesh),
                                                cache),
                                    _port_specs(TPL.cache_layout(cache, cfg,
                                                                 mesh),
                                                cache)):
        _cache_leaf_layout(path, s, lay, cut, cfg)
    # every rank's query heads read the kv heads it holds
    G = cfg.n_heads // cfg.n_kv_heads
    for r in range(tp):
        heads = range(r * cfg.n_heads // tp, (r + 1) * cfg.n_heads // tp)
        kv = {h // G for h in heads}
        n, i = SH._block_of(TPL.kv_entry(cfg, tp), mesh, {"model": r})
        per = cfg.n_kv_heads // n
        assert kv == set(range(i * per, (i + 1) * per))


@pytest.mark.parametrize("arch", SERVE_ONLY)
def test_families_without_a_tensor_parallel_form_are_refused(arch):
    """They serve over a model axis of 2 and train only at 1: training
    over ``model`` is item 12(b)'s second half."""
    cfg = get_smoke_config(arch)
    TPL.check_supported(cfg, 1, training=True)
    TPL.check_supported(cfg, 2)
    with pytest.raises(ValueError, match=r"ROADMAP item 12\(b\)"):
        TPL.check_supported(cfg, 2, training=True)


def _smoke(arch, **kw):
    """The smoke config with ``kw`` replaced (``lru_width`` in its hybrid
    block)."""
    cfg = get_smoke_config(arch)
    if "lru_width" in kw:
        return cfg.replace(hybrid=dataclasses.replace(
            cfg.hybrid, lru_width=kw.pop("lru_width")), **kw)
    return cfg.replace(**kw)


@pytest.mark.parametrize("cfg, tp, what", [
    (_smoke("recurrentgemma-2b", lru_width=66), 4, "hybrid.lru_width 66"),
    (_smoke("recurrentgemma-2b", d_ff=130), 4, "d_ff 130"),
    (_smoke("rwkv6-7b", d_ff=130), 4, "d_ff 130"),
    (_smoke("rwkv6-7b"), 8, "heads"),
    (_smoke("deepseek-v3-671b"), 8, "heads"),
    (_smoke("whisper-large-v3", d_ff=130), 4, "d_ff 130"),
    (_smoke("llama-3.2-vision-11b", d_ff=130), 4, "d_ff 130"),
    (get_config("recurrentgemma-2b"), 4, "10 query"),
    (get_config("whisper-large-v3"), 8, "20 query"),
], ids=["rglru-width", "rglru-ff", "rwkv-ff", "rwkv-heads", "mla-heads",
        "whisper-ff", "vision-ff", "recurrentgemma-heads", "whisper-heads"])
def test_widths_that_do_not_split_are_refused_by_name(cfg, tp, what):
    """The reference's ``?:model`` keeps such a width whole; the port
    refuses to serve it, naming it."""
    with pytest.raises(ValueError, match=what) as e:
        TPL.check_supported(cfg, tp)
    assert cfg.name in str(e.value)


@pytest.mark.parametrize("tp, entry", [(2, ("model", None)),
                                       (4, (None, None))])
def test_whispers_bare_table_splits_by_vocabulary_rows_where_they_divide(
        tp, entry):
    """The published 51,866 rows split over a model axis of 2, not of 4:
    there the table is whole on every rank, as the reference's
    ``"?:model"`` falls back, and the lookup and logits run unsharded."""
    cfg = get_config("whisper-large-v3")
    mesh = _Rank((1, tp), ("data", "model"), 1)
    params = build_model(cfg).init(MetaGenerator())
    assert TPL.param_layout(params, cfg, mesh)["embed"] == entry
    assert SH.param_pspecs(params, mesh)["embed"] == entry
    assert TPL.TensorParallel(cfg, mesh).vocab_sharded is (entry[0]
                                                           is not None)


@pytest.mark.parametrize("arch", SERVE_ONLY)
def test_the_published_widths_serve_over_a_model_axis_of_2(arch):
    """Phase 5c's models: every published width splits over 2."""
    TPL.check_supported(get_config(arch), 2)


@pytest.mark.parametrize("arch, tp, what", [
    ("llama3.2-3b", 3, "heads"), ("llama3.2-3b", 8, "heads"),
    ("qwen3-8b", 8, "heads")])
def test_heads_that_would_be_cut_are_refused(arch, tp, what):
    with pytest.raises(ValueError, match=what):
        TPL.check_supported(get_smoke_config(arch), tp)


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["qwen3-8b", "llama4-maverick-400b-a17b"]
                         + SERVE_ONLY)
def test_each_ranks_init_is_its_block_of_the_models(arch, sizes):
    cfg = get_smoke_config(arch)
    full = build_model(cfg).init(torch.Generator().manual_seed(7))
    for r in range(int(np.prod(sizes))):
        mesh = _Rank(sizes, ("data", "model"), r)
        want = TPL.shard_tree(full, TPL.param_layout(full, cfg, mesh), mesh)
        got = TPL.init_params(cfg, torch.Generator().manual_seed(7), mesh)
        assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
        for (path, g), (_p, w) in zip(flatten(got), flatten(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), (r, path)


def test_the_moe_smoke_block_splits_its_experts():
    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    mesh = _Rank((1, 4), ("data", "model"), 2)
    p = TPL.init_params(cfg, torch.Generator().manual_seed(0), mesh)
    experts = p["layers"][1]["ffn"]["experts"]
    assert {k: tuple(v.shape) for k, v in experts.items()} == {
        "wi_gate": (1, 64, 128), "wi_up": (1, 64, 128), "wo": (1, 128, 64)}
    assert cfg.moe.n_experts == 4
