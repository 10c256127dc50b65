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

* the qwen3-8b and llama4-maverick smoke configs in float32 (llama4 with
  its 4 experts over model 2 and 4, at a capacity that drops nothing):
  each rank's logits (whole vocabulary, gathered over ``model``) against
  its rows of the reference's unsharded prefill and 4 decode steps within
  ``atol = rtol = 2e-5`` (the reference's own a2a tolerance in
  ``tests/test_distributed.py``), its greedy tokens equal, and each rank's
  cache leaf within 1e-5 of its block of the reference's cache (the
  rank's kv heads of its rows; row-parallel sums reorder float32 adds),
  which is also the shape of the rank's ``model.init_cache`` block;
* the expert-parallel block alone — each rank's ``make_moe_fn`` on its
  experts, the all_to_alls between processes — against the reference's
  ``moe_block_local`` at that capacity, 2e-5;
* a world of 1 bitwise equal to the port's unsharded path (logits, tokens
  and every cache leaf);
* the refusal of a family without a tensor-parallel form (recurrentgemma)
  at a model axis of 2;
* fsdp in the serving steps on (2, 1), (2, 2) and (2, 1, 1): the smoke
  config of every arch that runs on the mesh (all ten at a model axis of
  1, qwen3 and llama4 at 2; float32, ``FSDP_MIN_ELEMENTS`` lowered to 1),
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
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import layer_stacks  # noqa: E402
from repro_torch.train.serve_step import default_fsdp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-5)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = {"qwen3": "qwen3-8b", "llama4": "llama4-maverick-400b-a17b"}
MESHES = [(1, 2), (2, 2), (1, 4)]
#: The worlds, each the meshes it holds, built one after the other.
WORLDS = [[(1, 1)], [(1, 2), (2, 1), (2, 1, 1)], [(2, 2), (1, 4)]]
FSDP_MESHES = [(2, 1), (2, 2), (2, 1, 1)]
#: The archs serving on a model axis above 1 (the others are refused).
TP_ARCHS = ("qwen3-8b", "llama4-maverick-400b-a17b")
FSDP_CASES = [(sizes, arch) for sizes in FSDP_MESHES for arch in ARCH_IDS
              if sizes[-1] == 1 or arch in TP_ARCHS]
B, S, S_MAX, N_DECODE = 2, 8, 16, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    """float32 smoke configs; the MoE one at a capacity with no drops."""
    jcfg = jax_smoke(arch).replace(dtype="float32")
    if jcfg.moe is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=float(jcfg.moe.n_experts)))
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    return jcfg, cfg


def _reference(jcfg, jparams, tokens):
    """The reference's prefill and greedy decode steps: logits, tokens and
    the final cache."""
    jm = jax_build(jcfg)
    lg, cache, pos = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, S_MAX)
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
        jparams = jax_build(jcfg).init(jax.random.PRNGKey(3))
        tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
        m = dict(cfg=cfg, params=params_from_jax(_np(jparams), device="cpu"),
                 tokens=tokens, s_max=S_MAX)
        refs[name] = dict(jcfg=jcfg, jparams=jparams, cfg=cfg,
                          serve=_reference(jcfg, jparams, tokens))
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
               fsdp_meshes=FSDP_MESHES, fsdp_models=fsdp_models)
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


@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_each_ranks_cache_is_its_block_of_the_reference_cache(worlds, name,
                                                              sizes):
    """Port layer i is the reference's superblock position p's entry n,
    where ``layer_stacks`` puts i; each rank holds its kv heads of its
    rows (``cache_layout``)."""
    results, refs = worlds
    cfg = refs[name]["cfg"]
    jcache = refs[name]["serve"][2]
    where = {i: (p, n) for p, stack in enumerate(layer_stacks(cfg))
             for n, i in enumerate(stack)}
    mesh = StackedMesh(sizes, ("data", "model"))
    for r in results[sizes]:
        for layer in range(cfg.n_layers):
            p, n = where[layer]
            for leaf in ("k", "v"):
                full = torch.from_numpy(
                    getattr(jcache.super[p], leaf)[n].copy())
                spec = TPL.cache_layout({"k": full}, cfg, mesh)["k"]
                want = SH.shard(full, spec, mesh, r["coords"])
                got = r[name]["cache"][f"{layer}/{leaf}"]
                assert got.shape == want.shape
                assert r[name]["init_cache"][f"{layer}/{leaf}"] == \
                    tuple(want.shape), "init_cache's block"
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           **CACHE_TOL,
                                           err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("sizes", MESHES)
def test_the_expert_parallel_block_matches_moe_block_local(worlds, sizes):
    results, refs = worlds
    ref = refs["llama4"]
    jparams = ref["jparams"]
    where = {i: (p, n) for p, stack in enumerate(layer_stacks(ref["cfg"]))
             for n, i in enumerate(stack)}
    p, n = where[1]
    ffn = jax.tree.map(lambda a: a[n], jparams["stack"].super[p]["ffn"])
    want, _aux = JM.moe_block_local(ffn, jnp.asarray(ref["moe_x"]),
                                    ref["jcfg"])
    for r in results[sizes]:
        np.testing.assert_allclose(r["llama4"]["moe_out"].numpy(),
                                   np.asarray(want), **TOL,
                                   err_msg=str(r["coords"]))


@pytest.mark.parametrize("name", list(ARCHS))
def test_a_world_of_one_is_bitwise_the_unsharded_path(worlds, name):
    results, _refs = worlds
    (rank,) = results[(1, 1)]
    assert rank[name]["bitwise"] is True


@pytest.mark.parametrize("sizes", MESHES)
def test_a_family_without_a_tensor_parallel_form_is_refused(worlds, sizes):
    results, _refs = worlds
    for r in results[sizes]:
        assert r["refusal"] is not None and "RG-LRU" in r["refusal"] and \
            "model axis of" in r["refusal"], r["refusal"]


@pytest.mark.parametrize("sizes", MESHES)
def test_the_bound_decode_refuses_blocks_of_another_layout(worlds, sizes):
    """``jit_decode``'s step checks its first call's blocks: the whole
    cache is not a rank's block on a mesh that splits it."""
    results, _refs = worlds
    for r in results[sizes]:
        for name in ARCHS:
            assert r[name]["refused_whole_cache"] is True, (name,
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
