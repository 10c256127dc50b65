"""The serving steps across processes, on the CPU, against the JAX
package's unsharded model.

One module fixture runs ``tests/torch_dist_world.py`` in one child process,
which spawns gloo worlds of 1, 2 and 4 ranks holding the (data, model)
meshes (1, 1); (1, 2), (2, 1) and the (pod, data, model) (2, 1, 1); and
(2, 2) and (1, 4).  On (1, 1), (1, 2), (2, 2) and (1, 4) each rank serves
the prompt through
``make_serve_steps(cfg, ProcessMesh(...))`` with its blocks of the
parameters (carried over from the reference's with ``params_from_jax`` and
cut by the binding's layout): a prefill of the global batch of 2, then 4
greedy decode steps on its own rows.  Held here:

* the smoke configs of every family that serves over ``model`` in
  float32: qwen3-8b, llama4-maverick (its 4 experts over model 2 and 4),
  recurrentgemma-2b (the RG-LRU by channels, its one kv head whole on
  every rank), rwkv6-7b (the time mix by heads, the channel mix by
  columns), deepseek-v3 (MLA by heads over whole latents, 8 experts),
  whisper-large-v3 (encoder, decoder and cross attention by heads, the
  bare table by vocabulary rows where they divide, whole on (1, 4)) and
  llama-3.2-vision (the cross layers' heads over the whole context,
  gates seeded away from the init's zero, which would make a cross layer
  the identity), the MoE ones at a
  capacity that drops nothing, the vlm's and whisper's with a seeded
  context: each rank's logits (whole vocabulary, gathered over
  ``model``) against its rows of the reference's unsharded prefill and 4
  decode steps within ``atol = rtol = 2e-5`` (the reference's own a2a
  tolerance in ``tests/test_distributed.py``), its greedy tokens equal,
  and each cache leaf of the rank within 1e-5 of its block of the
  reference's cache by ``cache_layout`` (row-parallel sums reorder
  float32 adds), which is also the shape of the rank's
  ``model.init_cache`` block;
* the expert-parallel block alone — each rank's ``make_moe_fn`` on its
  experts, the all_to_alls between processes — against the reference's
  ``moe_block_local`` at that capacity, 2e-5, for llama4 and deepseek-v3;
* a world of 1 bitwise equal to the port's unsharded path (logits, tokens
  and every cache leaf);
* the training step's refusal, at a model axis above 1, of a family that
  serves there but has no tensor-parallel backward yet (recurrentgemma;
  ROADMAP item 12(b)'s training half);
* fsdp in the serving steps on (2, 1), (2, 2) and (2, 1, 1): the smoke
  config of every arch that runs on the mesh (all ten at a model axis of
  1, the seven of ``TP_ARCHS`` at 2; float32, ``FSDP_MIN_ELEMENTS``
  lowered to 1),
  its prefill and 4 decode steps' logits with ``fsdp=True`` bit for bit
  those of ``fsdp=False``, each rank holding about half the elements,
  its fsdp blocks its block of the same seed's whole init, and
  ``jit_decode``'s step refusing whole parameters under fsdp; the
  default ``fsdp`` on for exactly the archs over 100B parameters."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import (ARCH_IDS, MoEConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import tensor_parallel as TPL  # noqa: E402
from repro_torch.launch.mesh import StackedMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import layer_stacks  # noqa: E402
from repro_torch.train.serve_step import default_fsdp  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-5)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = {"qwen3": "qwen3-8b", "llama4": "llama4-maverick-400b-a17b",
         "recurrentgemma": "recurrentgemma-2b", "rwkv6": "rwkv6-7b",
         "deepseek": "deepseek-v3-671b", "whisper": "whisper-large-v3",
         "vision": "llama-3.2-vision-11b"}
MOE = ["llama4", "deepseek"]
MESHES = [(1, 2), (2, 2), (1, 4)]
#: The worlds, each the meshes it holds, built one after the other.
WORLDS = [[(1, 1)], [(1, 2), (2, 1), (2, 1, 1)], [(2, 2), (1, 4)]]
FSDP_MESHES = [(2, 1), (2, 2), (2, 1, 1)]
#: The archs of ``ARCHS``, served here on a model axis above 1.
TP_ARCHS = tuple(ARCHS.values())
FSDP_CASES = [(sizes, arch) for sizes in FSDP_MESHES for arch in ARCH_IDS
              if sizes[-1] == 1 or arch in TP_ARCHS]
B, S, S_MAX, N_DECODE = 2, 8, 16, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


#: whisper's vocabulary here: like its published 51,866 it splits over a
#: model axis of 2 and not of 4, so (1, 4) serves the bare table whole.
WHISPER_VOCAB = 258


def _configs(arch):
    """float32 smoke configs; the MoE one at a capacity with no drops,
    whisper's at WHISPER_VOCAB."""
    jcfg = jax_smoke(arch).replace(dtype="float32")
    if arch == "whisper-large-v3":
        jcfg = jcfg.replace(vocab=WHISPER_VOCAB)
    if jcfg.moe is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=float(jcfg.moe.n_experts)))
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab=jcfg.vocab)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    return jcfg, cfg


def _seeded_gates(np_params, rng):
    """The vlm's cross layers' ``gate_attn`` / ``gate_ffn`` drawn from
    ±[0.3, 1.2] in the numpy tree (at the init's zero a cross layer is the
    identity and its heads would go unchecked)."""
    for block in np_params["stack"].super:
        for name in ("gate_attn", "gate_ffn"):
            if name in block:
                g = rng.uniform(0.3, 1.2, block[name].shape)
                sign = rng.choice([-1.0, 1.0], block[name].shape)
                block[name] = (g * sign).astype(np.float32)
    return np_params


def _reference(jcfg, jparams, batch):
    """The reference's prefill and greedy decode steps: logits, tokens and
    the final cache."""
    jm = jax_build(jcfg)
    lg, cache, pos = jax.jit(jm.prefill, static_argnums=2)(
        jparams, jax.tree.map(jnp.asarray, batch), S_MAX)
    logits, toks = [np.asarray(lg)], []
    tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
    dec = jax.jit(jm.decode_step)
    for _ in range(N_DECODE):
        toks.append(np.asarray(tok))
        lg, cache = dec(jparams, tok, cache, pos)
        pos = pos + 1
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
    return logits, toks + [np.asarray(tok)], _np(cache)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worlds")
    rng = np.random.default_rng(11)
    models, refs = {}, {}
    for name, arch in ARCHS.items():
        jcfg, cfg = _configs(arch)
        np_params = _np(jax_build(jcfg).init(jax.random.PRNGKey(3)))
        if cfg.family == "vlm":
            np_params = _seeded_gates(np_params, rng)
        jparams = jax.tree.map(jnp.asarray, np_params)
        tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
        batch = {}
        if cfg.family in ("vlm", "audio"):
            batch["context"] = rng.standard_normal(
                (B, cfg.cross.n_context_tokens, cfg.d_model)).astype(
                    np.float32)
        m = dict(cfg=cfg, params=params_from_jax(np_params, device="cpu"),
                 tokens=tokens, s_max=S_MAX,
                 batch={k: torch.from_numpy(v) for k, v in batch.items()})
        refs[name] = dict(jcfg=jcfg, jparams=jparams, cfg=cfg,
                          serve=_reference(jcfg, jparams,
                                           {"tokens": tokens, **batch}))
        if cfg.moe is not None:
            x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            m.update(moe_x=torch.from_numpy(x), moe_layer=1)
            refs[name]["moe_x"] = x
        models[name] = m
    fsdp_models = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        m = dict(cfg=cfg, s_max=S_MAX, tokens=rng.integers(
            1, cfg.vocab, (B, S)).astype(np.int32))
        if cfg.family in ("vlm", "audio"):
            m["context"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.cross.n_context_tokens, cfg.d_model)).astype(
                    np.float32))
        fsdp_models[arch] = m
    job = dict(models=models, n_decode=N_DECODE, timeout_s=240,
               worlds=WORLDS, serve_meshes=[(1, 1)] + MESHES,
               fsdp_meshes=FSDP_MESHES, fsdp_models=fsdp_models,
               fsdp_cases=[[*sizes, arch] for sizes, arch in FSDP_CASES])
    torch.save(job, tmp / "in.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_world.py"),
                        str(tmp / "in.pt"), str(tmp / "out.pt")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return torch.load(tmp / "out.pt", weights_only=False), refs


def _rows(mesh_sizes, coords):
    """The global batch rows a rank holds."""
    n = B // mesh_sizes[0] if B % mesh_sizes[0] == 0 else B
    dp = coords["data"] if B % mesh_sizes[0] == 0 else 0
    return slice(dp * n, (dp + 1) * n)


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_gathered_logits_and_tokens_match_the_reference(worlds, name, sizes):
    results, refs = worlds
    logits, toks, _cache = refs[name]["serve"]
    ranks = results[sizes]
    assert len(ranks) == sizes[0] * sizes[1]
    for r in ranks:
        rows = _rows(sizes, r["coords"])
        got = r[name]
        assert len(got["logits"]) == N_DECODE + 1
        for i, (g, w) in enumerate(zip(got["logits"], logits)):
            np.testing.assert_allclose(g.numpy(), w[rows], **TOL,
                                       err_msg=f"{r['coords']} call {i}")
        for i, (g, w) in enumerate(zip(got["tokens"], toks)):
            np.testing.assert_array_equal(g.numpy(), w[rows],
                                          err_msg=f"{r['coords']} token {i}")


def _reference_cache(cfg, jcache):
    """The reference's final cache as ``{port path: tensor}``: the LM
    family's prefix layers, then superblock i's positions in order, then
    its suffix (the port's layer order); rwkv6's stacked states and
    whisper's stacked self / cross caches unstacked by layer."""
    jc = _np(jcache)

    def layer_leaves(i, c):
        return {f"{i}/{f}": getattr(c, f) for f in c._fields}

    out = {}
    if cfg.family == "audio":
        layers = []
        out = {f"{name}/{i}/{f}": getattr(getattr(jc, name), f)[i]
               for name in ("self_kv", "cross_kv")
               for i in range(cfg.n_layers) for f in ("k", "v")}
    elif cfg.family == "ssm":
        layers = [jax.tree.map(lambda a, i=i: a[i], jc)
                  for i in range(cfg.n_layers)]
    else:
        n = len(jax.tree.leaves(jc.super[0])[0]) if jc.super else 0
        per_pos = [[jax.tree.map(lambda a, i=i: a[i], pos) for i in range(n)]
                   for pos in jc.super]
        layers = list(jc.prefix) + [c for group in zip(*per_pos)
                                    for c in group] + list(jc.suffix)
    assert len(layers) == (0 if out else cfg.n_layers)
    for i, c in enumerate(layers):
        out.update(layer_leaves(i, c))
    return {p: torch.from_numpy(np.array(a)) for p, a in out.items()}


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_each_ranks_cache_is_its_block_of_the_reference_cache(worlds, name,
                                                              sizes):
    """Every cache leaf, the reference's in the port's layer order: each
    rank holds its block by ``cache_layout`` — its rows; a KV cache's kv
    heads (whisper's self and cross caches, the vlm's cross caches among
    them), the RG-LRU's channels, RWKV's heads of ``wkv``; MLA's latents
    and RWKV's shift states whole."""
    results, refs = worlds
    cfg = refs[name]["cfg"]
    want_full = _reference_cache(cfg, refs[name]["serve"][2])
    mesh = StackedMesh(sizes, ("data", "model"))
    shapes = build_model(cfg).init_cache(B, S_MAX, device="meta")
    layout = dict(zip((p for p, _ in flatten(shapes)), _specs(
        TPL.cache_layout(shapes, cfg, mesh), shapes)))
    for r in results[sizes]:
        got_all = r[name]["cache"]
        assert sorted(got_all) == sorted(want_full) == sorted(layout)
        for path, full in want_full.items():
            want = SH.shard(full, layout[path], mesh, r["coords"])
            got = got_all[path]
            assert got.shape == want.shape, path
            assert r[name]["init_cache"][path] == tuple(want.shape), \
                f"init_cache's block {path}"
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **CACHE_TOL, err_msg=f"{r['coords']} "
                                       f"{path}")


def _specs(specs, like):
    """A spec tree in ``like``'s leaf order (a spec is a tuple, so the walk
    follows ``like``)."""
    out = []
    tree_map(lambda _t, s: out.append(s), like, specs)
    return out


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("name", MOE)
def test_the_expert_parallel_block_matches_moe_block_local(worlds, name,
                                                           sizes):
    results, refs = worlds
    ref = refs[name]
    jparams = ref["jparams"]
    where = {i: (p, n) for p, stack in enumerate(layer_stacks(ref["cfg"]))
             for n, i in enumerate(stack)}
    p, n = where[1]
    ffn = jax.tree.map(lambda a: a[n], jparams["stack"].super[p]["ffn"])
    want, _aux = JM.moe_block_local(ffn, jnp.asarray(ref["moe_x"]),
                                    ref["jcfg"])
    for r in results[sizes]:
        np.testing.assert_allclose(r[name]["moe_out"].numpy(),
                                   np.asarray(want), **TOL,
                                   err_msg=str(r["coords"]))


@pytest.mark.parametrize("name", list(ARCHS))
def test_a_world_of_one_is_bitwise_the_unsharded_path(worlds, name):
    results, _refs = worlds
    (rank,) = results[(1, 1)]
    assert rank[name]["bitwise"] is True


@pytest.mark.parametrize("sizes", MESHES)
def test_a_family_without_a_tensor_parallel_form_is_refused(worlds, sizes):
    """recurrentgemma serves over ``model`` (above) but has no
    tensor-parallel backward yet: ``make_train_step`` on the mesh refuses
    it, naming the RG-LRU and ROADMAP item 12(b)."""
    results, _refs = worlds
    for r in results[sizes]:
        assert r["refusal"] is not None and "RG-LRU" in r["refusal"] and \
            "model axis of" in r["refusal"] and "12(b)" in r["refusal"], \
            r["refusal"]


@pytest.mark.parametrize("sizes", MESHES)
def test_the_bound_decode_refuses_blocks_of_another_layout(worlds, sizes):
    """``jit_decode``'s step checks its first call's blocks: the whole
    cache is not a rank's block on a mesh that splits it, and is one
    where the layout splits no leaf (deepseek's latents, whole over
    ``model``, on a mesh of one data rank)."""
    results, refs = worlds
    mesh = StackedMesh(sizes, ("data", "model"))
    for name in ARCHS:
        cfg = refs[name]["cfg"]
        shapes = build_model(cfg).init_cache(B, S_MAX, device="meta")
        splits = any(SH.local_shape(t.shape, spec, mesh) != tuple(t.shape)
                     for t, spec in zip(leaves(shapes), _specs(
                         TPL.cache_layout(shapes, cfg, mesh), shapes)))
        assert splits or (cfg.mla is not None and sizes[0] == 1), name
        for r in results[sizes]:
            assert r[name]["refused_whole_cache"] is splits, (name,
                                                             r["coords"])


def _coords_along(coords, axis, s):
    return {**coords, axis: s}


def _me(coords, names=("data", "model")):
    return float(sum(coords[a] * 10 ** i for i, a in enumerate(names)))


@pytest.mark.parametrize("sizes", [(1, 1)] + MESHES)
def test_collectives_over_named_axes(worlds, sizes):
    """``all_to_all`` hands block j to coordinate j and stacks what each
    coordinate sent in coordinate order; ``all_gather`` concatenates in
    coordinate order; ``psum`` of bf16 values sums them in float32 and
    rounds once; each is the identity (the same tensor) on an axis of 1."""
    results, _refs = worlds
    ranks = results[sizes]
    for r in ranks:
        c, got = r["coords"], r["collectives"]
        for axis, n in zip(("data", "model"), sizes):
            g = got[axis]
            others = [_me(_coords_along(c, axis, s)) for s in range(n)]
            want = torch.tensor([[o + c[axis]] * 3 for o in others])
            assert torch.equal(g["all_to_all"], want), (axis, c)
            assert torch.equal(g["all_gather"],
                               torch.tensor([others, others])), (axis, c)
            delta = torch.tensor([0, 1 / 256, 1 / 512, 0],
                                 dtype=torch.bfloat16)
            parts = [torch.full((4,), o, dtype=torch.bfloat16) + delta
                     for o in others]
            want = torch.stack([p.float() for p in parts]).sum(0).to(
                torch.bfloat16)
            assert torch.equal(g["psum"], want), (axis, c)
            assert g["identity"] is (n == 1), (axis, c)


# ------------------------------------------------------------ fsdp serving
@pytest.mark.parametrize("sizes, arch", FSDP_CASES,
                         ids=[f"{s}-{a}" for s, a in FSDP_CASES])
def test_fsdp_serving_gives_the_unsharded_layouts_logits_bit_for_bit(
        worlds, sizes, arch):
    """``make_serve_steps(cfg, mesh, fsdp=True)``: each rank draws its dp
    blocks (its block of the same seed's whole init), gathers each layer's
    as the layer runs and the rest once a call, and its prefill and decode
    logits are those of ``fsdp=False`` bit for bit; a rank holds about
    half the elements."""
    results, _refs = worlds
    ranks = results[("fsdp",) + sizes]
    assert len(ranks) == math.prod(sizes)
    for r in ranks:
        got = r[arch]
        assert got["bitwise"] is True
        assert got["init_blocks"] is True
        # every leaf with a dim that divides is split; scalars and a few
        # odd leaves stay whole
        assert 0 < got["elements_True"] <= 0.55 * got["elements_False"]


@pytest.mark.parametrize("sizes", FSDP_MESHES)
def test_the_bound_decode_refuses_whole_parameters_under_fsdp(worlds,
                                                              sizes):
    results, _refs = worlds
    seen = 0
    for r in results[("fsdp",) + sizes]:
        for arch, got in r.items():
            assert got["refused_whole"] is True, arch
            seen += 1
    assert seen


def test_the_default_fsdp_is_on_for_exactly_the_giants():
    """The reference's default, ``cfg.param_count() > 100e9``: llama4-
    maverick (397.7 B) and deepseek-v3 (671.0 B); no smoke config."""
    on = [a for a in ARCH_IDS if default_fsdp(get_config(a))]
    assert on == ["llama4-maverick-400b-a17b", "deepseek-v3-671b"]
    assert not any(default_fsdp(get_smoke_config(a)) for a in ARCH_IDS)
