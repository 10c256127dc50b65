"""The port's expert parallelism on the stacked binding against the JAX
package's, on the CPU in float32.

* ``moe_block_a2a`` with its (P_dp, P_tp) shard dimensions against the
  reference's per-shard ``moe_block_a2a`` under ``jax.vmap(axis_name=
  "model")`` inside ``jax.vmap(axis_name="data")`` (the vmap binding of
  its ``shard_map``), on the llama4-maverick and deepseek-v3 smoke MoE
  blocks with 8 experts, P_tp 1/2/4/8 and P_dp 1/2, at the default
  capacity factor (the inputs share an offset that skews the router, so
  assignments are dropped, and must be the same ones) and at a capacity
  with no drops;
* the grouped matmul's arguments on the a2a path: each expert's block
  holds the rows every source kept for it at its front, in source order,
  and its count is their sum (so ``gmm`` reads each live expert's weights
  once a product);
* ``make_moe_fn`` on (2, 4) and (1, 8) meshes against the reference's
  ``moe_block_local`` with capacity ``n_experts``
  (``tests/test_distributed.py::test_moe_a2a_matches_local``'s oracle),
  with B and S split, and both replicated (a decode step's S = 1);
* one subprocess with 8 host devices runs what the ``shard_map`` binding
  computes — the reference's ``make_moe_fn`` on a (2, 4) device mesh and
  ``make_grad_sync_shardmap`` on (2, 2, 2) — and writes it to an ``.npz``
  the port is held to.  It is the only way to run the reference's
  ``shard_map`` programs: the process's device count is fixed when jax
  first starts;
* ``make_serve_steps`` (prefill and 4 decode steps) on a (1, 4) mesh
  against the port's local model with no drops, and on (1, 1) against the
  reference's ``make_serve_steps``; ``make_train_step`` with a mesh: one
  step against the reference's at (1, 1), and at (1, 2) against the port's
  local path with no drops.

Weights come from the reference's initialisers, inputs from numpy seeds.
Tolerances: the block's output and load-balance loss ``atol = rtol =
2e-5``, as ``tests/test_distributed.py``'s a2a oracle; model logits,
caches and parameters ``atol=1e-4, rtol=1e-5``, as
``tests/test_torch_moe.py``; the loss and grad norm ``rtol=1e-5``;
integer routing and the compacted rows exactly."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.train import make_serve_steps as jax_serve_steps  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import MoEConfig, get_smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed.collectives import make_grad_sync  # noqa: E402
from repro_torch.distributed.moe_ep import (expert_views,  # noqa: E402
                                            make_moe_fn)
from repro_torch.kernels.moe_gmm import gmm  # noqa: E402
from repro_torch.launch.mesh import StackedMesh, make_debug_mesh  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import make_serve_steps, make_train_step  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v3-671b"]
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-5)
E = 8
ROOT = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _configs(arch, **moe):
    """The reference's and the port's float32 smoke configs with 8 experts
    and the ``moe`` changes."""
    jcfg = jax_smoke(arch).replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, n_experts=E,
                                                **moe))
    return jcfg, get_smoke_config(arch).replace(
        dtype="float32", moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))


def _skewed(rng, shape):
    """Normal inputs plus one offset, twice their scale, that every token
    shares: the router's logits share a term, so its choices crowd some
    experts past capacity."""
    return (rng.standard_normal(shape)
            + 2 * rng.standard_normal(shape[-1])).astype(np.float32)


def _dropped(p, x, cfg):
    """How many assignments the port's per-shard dispatch drops for x
    (..., B, S, d), shard by shard."""
    xt = torch.from_numpy(x).reshape(*x.shape[:-3], -1, x.shape[-1])
    w, e, _ = PM.route(p, xt, cfg.moe)
    C = PM.capacity(xt.shape[-2], cfg.moe)
    _xs, slot, _kw = PM.dispatch(xt, e, w, cfg.moe.n_experts, C)
    return int((slot == cfg.moe.n_experts * C).sum())


def _reference_a2a(jp, jcfg, x):
    """The reference's per-shard ``moe_block_a2a`` over x (P_dp, P_tp, B_l,
    S_l, d): vmap over "model" with each shard's slice of the experts,
    inside vmap over "data" with the experts broadcast."""
    Pt = x.shape[1]
    experts = jax.tree.map(lambda w: w.reshape(Pt, -1, *w.shape[1:]),
                           jp["experts"])
    rest = {k: v for k, v in jp.items() if k != "experts"}

    def shard(ex, xl):
        return JM.moe_block_a2a(dict(rest, experts=ex), xl, jcfg, "model")

    f = jax.vmap(jax.vmap(shard, in_axes=(0, 0), axis_name="model"),
                 in_axes=(None, 0), axis_name="data")
    return jax.jit(f)(experts, jnp.asarray(x))


def _stacked(p, Pd, Pt):
    return dict(p, experts=expert_views(p["experts"], Pd, Pt))


# ------------------------------------------------------------ the a2a block
@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("Pd", [1, 2])
@pytest.mark.parametrize("Pt", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_a2a_matches_the_reference_under_vmap(arch, Pt, Pd, drops):
    jcfg, cfg = _configs(arch, **({} if drops else
                                  {"capacity_factor": float(E)}))
    jp = JM.init_moe(jax.random.PRNGKey(1), jcfg)
    p = _torch(_np(jp))
    x = _skewed(np.random.default_rng(10 * Pt + Pd),
                (Pd, Pt, 2, 12, cfg.d_model))
    out, aux = PM.moe_block_a2a(_stacked(p, Pd, Pt), torch.from_numpy(x),
                                cfg)
    jout, jaux = _reference_a2a(jp, jcfg, x)
    assert out.shape == x.shape and aux.shape == (Pd, Pt)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **BLOCK_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **BLOCK_TOL)
    assert (_dropped(p, x, cfg) > 0) == drops


@pytest.mark.parametrize("Pd, Pt", [(1, 4), (2, 2), (2, 8)])
def test_moe_block_a2a_compacts_each_experts_rows_for_gmm(monkeypatch, Pd,
                                                          Pt):
    """Each of the three grouped matmuls gets one block of P_tp·C rows a (dp
    shard, expert), on that expert; the block starts with the rows each
    source kept for the expert, source by source, and its count is their
    sum, so the expert's weights are read once however many sources sent
    it tokens."""
    jcfg, cfg = _configs("deepseek-v3-671b")
    p = _torch(_np(JM.init_moe(jax.random.PRNGKey(1), jcfg)))
    x = _skewed(np.random.default_rng(3), (Pd, Pt, 2, 10, cfg.d_model))
    seen = []

    def spy(x_, w_, be_, bt_, rows_=None):
        seen.append((x_, w_, be_, bt_, rows_))
        return gmm(x_, w_, be_, bt_, rows_)

    monkeypatch.setattr(PM, "gmm", spy)
    PM.moe_block_a2a(_stacked(p, Pd, Pt), torch.from_numpy(x), cfg)
    xt = torch.from_numpy(x).reshape(Pd, Pt, 20, cfg.d_model)
    w, e, _ = PM.route(p, xt, cfg.moe)
    C = PM.capacity(20, cfg.moe)
    x_send, slot, _kw = PM.dispatch(xt, e, w, E, C)
    kept = PM.expert_rows(slot, E, C).numpy()             # (Pd, Pt, E)
    assert _dropped(p, x, cfg) > 0
    assert len(seen) == 3
    for i, (x_, w_, be_, bt_, rows_) in enumerate(seen):
        assert bt_ == Pt * C and rows_.dtype == torch.int32
        np.testing.assert_array_equal(be_.numpy(), np.tile(np.arange(E), Pd))
        np.testing.assert_array_equal(rows_.numpy(),
                                      kept.sum(1).reshape(-1))
        assert w_.shape[0] == E, "one weight stack for every shard"
        if i:
            continue
        blocks = x_.reshape(Pd, E, Pt * C, -1)
        for dp in range(Pd):
            for ex in range(E):
                want = torch.cat([x_send[dp, s, ex, :kept[dp, s, ex]]
                                  for s in range(Pt)])
                assert torch.equal(blocks[dp, ex, :len(want)], want)


# ------------------------------------------------------------- make_moe_fn
@pytest.mark.parametrize("mesh, shape", [((2, 4), (4, 8)), ((1, 8), (4, 8)),
                                         ((2, 4), (3, 1)), ((1, 8), (2, 5))])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_moe_fn_matches_moe_block_local(arch, mesh, shape):
    """With capacity ``n_experts`` nothing drops, so the expert-parallel
    block is the local one, as the reference's own oracle holds it; B
    splits over data where it divides and S over model where it divides,
    else every shard of the axis holds all of it."""
    jcfg, cfg = _configs(arch, capacity_factor=float(E))
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    out, aux = make_moe_fn(cfg, StackedMesh(mesh, ("data", "model")))(
        _torch(_np(jp)), torch.from_numpy(x), cfg)
    jout, _jaux = JM.moe_block_local(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **BLOCK_TOL)
    assert out.shape == x.shape and aux.shape == ()


def test_make_moe_fn_refuses_experts_that_do_not_split():
    _jcfg, cfg = _configs(ARCHS[0])
    with pytest.raises(ValueError, match="do not split"):
        make_moe_fn(cfg, make_debug_mesh(1, 3))


# --------------------------------------------------- the shard_map binding
SHARD_MAP_PROGRAM = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {tests!r})
    from torch_port_ref import reference_core
    reference_core()
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.distributed.collectives import make_grad_sync_shardmap
    from repro.distributed.moe_ep import make_moe_fn
    from repro.launch.mesh import compat_make_mesh
    from repro.models import moe as M

    out = {{}}
    rng = np.random.default_rng(7)
    mesh = compat_make_mesh((2, 4), ("data", "model"))
    for arch in {archs!r}:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts={E}))
        params = M.init_moe(jax.random.PRNGKey(2), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(k.key for k in path)
            out[f"{{arch}}/params/{{key}}"] = np.asarray(leaf)
        moe_fn = jax.jit(lambda p, x: make_moe_fn(cfg, mesh)(p, x, cfg))
        for name, shape in (("prefill", (4, 64)), ("decode", (3, 1))):
            x = (rng.standard_normal((*shape, cfg.d_model))
                 + 2 * rng.standard_normal(cfg.d_model)).astype(np.float32)
            o, aux = moe_fn(params, jnp.asarray(x))
            out[f"{{arch}}/{{name}}/x"] = x
            out[f"{{arch}}/{{name}}/out"] = np.asarray(o)
            out[f"{{arch}}/{{name}}/aux"] = np.asarray(aux)
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
    grads = {{"a": jnp.arange(32.0).reshape(8, 4),
              "b": {{"c": jnp.ones((4, 8)) * 3}},
              "w": jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)}}
    specs = {{"a": P(None, "model"), "b": {{"c": P("model", None)}},
              "w": P(None, None)}}
    for k, g in (("a", grads["a"]), ("b/c", grads["b"]["c"]),
                 ("w", grads["w"])):
        out[f"grads/{{k}}"] = np.asarray(g)
    for fence in ("global", "pair"):
        for compress in ("none", "int8ef"):
            synced = jax.jit(make_grad_sync_shardmap(
                mesh, specs, fence=fence, compress=compress))(grads)
            tag = f"sync/{{fence}}/{{compress}}"
            out[f"{{tag}}/a"] = np.asarray(synced["a"])
            out[f"{{tag}}/b/c"] = np.asarray(synced["b"]["c"])
            out[f"{{tag}}/w"] = np.asarray(synced["w"])
    np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def shard_map_run(tmp_path_factory):
    """What the reference's ``shard_map`` binding computes, from one child
    process with 8 host devices."""
    path = tmp_path_factory.mktemp("shard_map") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    prog = textwrap.dedent(SHARD_MAP_PROGRAM).format(
        tests=str(ROOT / "tests"), archs=ARCHS, E=E, path=str(path))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


def _params_from(run, arch):
    p = {}
    for key, a in run.items():
        if key.startswith(f"{arch}/params/"):
            node = p
            parts = key.split("/")[2:]
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = torch.from_numpy(a)
    return p


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_moe_fn_matches_the_shard_map_binding(shard_map_run, arch,
                                                   step):
    """The reference's ``make_moe_fn`` on a (2, 4) device mesh, at its
    default capacity (the prefill input skewed so assignments drop) and at
    a decode step's S = 1, which both meshes replicate over model."""
    _jcfg, cfg = _configs(arch)
    run = shard_map_run
    p = _params_from(run, arch)
    x = run[f"{arch}/{step}/x"]
    out, aux = make_moe_fn(cfg, make_debug_mesh(2, 4))(
        p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), run[f"{arch}/{step}/out"],
                               **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), run[f"{arch}/{step}/aux"],
                               **BLOCK_TOL)
    if step == "prefill":
        shards = x.reshape(2, 2, 4, 16, -1).transpose(0, 2, 1, 3, 4)
        assert _dropped(p, np.ascontiguousarray(shards), cfg) > 0


@pytest.mark.parametrize("compress", ["none", "int8ef"])
@pytest.mark.parametrize("fence", ["global", "pair"])
def test_make_grad_sync_matches_the_shard_map_binding(shard_map_run, fence,
                                                      compress):
    """The reference's ``make_grad_sync_shardmap`` on a (2, 2, 2) pod mesh
    takes every dp shard's copy of the same gradients, each leaf sharded
    over model by its spec (``a`` by columns, ``b/c`` by rows, ``w``
    replicated), so each int8 scale is a model shard's; the port takes the
    same shards stacked (pod, data, model, ...), and every participant
    leaves with its shard of the reference's result."""
    run = shard_map_run
    mesh = StackedMesh((2, 2, 2), ("pod", "data", "model"))
    split = {"a": 1, "b/c": 0, "w": None}     # the leaf dim over model

    def shards(k):
        g = torch.from_numpy(run[f"grads/{k}"])
        g = torch.stack(g.chunk(2, split[k])) if split[k] is not None \
            else g.expand(2, *g.shape)
        return g.expand(2, 2, *g.shape)

    synced = make_grad_sync(mesh, fence=fence, compress=compress)(
        {"a": shards("a"), "b": {"c": shards("b/c")}, "w": shards("w")})
    got = {"a": synced["a"], "b/c": synced["b"]["c"], "w": synced["w"]}
    for k in split:
        want = run[f"sync/{fence}/{compress}/{k}"]
        for pod in range(2):
            for dp in range(2):
                g = got[k][pod, dp]
                g = torch.cat(list(g), split[k]) if split[k] is not None \
                    else g[1]
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                           err_msg=k)


# ------------------------------------------------------ serve and train steps
def _model_params(arch, jcfg, seed=0):
    from repro.models import build_model as jax_build
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, params_from_jax(_np(jparams), device="cpu")


def _serve(steps, params, tokens, n_decode, s_max):
    _model, prefill, decode, _jit_decode = steps
    lg, caches, pos = prefill(params, {"tokens": tokens}, s_max)
    out = [lg]
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    for _ in range(n_decode):
        tok, lg, caches, pos = decode(params, tok, caches, pos)
        out.append(lg)
    return out, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_on_a_mesh_match_the_local_model(arch):
    """Prefill and 4 greedy decode steps through ``make_serve_steps`` on a
    (1, 4) mesh — the prefill's S splits over model, a decode step's S = 1
    is replicated — against the model without a mesh, nothing dropped."""
    jcfg, cfg = _configs(arch, capacity_factor=float(E))
    _jp, params = _model_params(arch, jcfg)
    tokens = np.random.default_rng(5).integers(1, cfg.vocab, (2, 8)).astype(
        np.int32)
    with torch.no_grad():
        a2a, ca = _serve(make_serve_steps(cfg, make_debug_mesh(1, 4), "cpu"),
                         params, tokens, 4, 16)
        local, cl = _serve(make_serve_steps(cfg, None, "cpu"), params,
                           tokens, 4, 16)
    for i, (g, w) in enumerate(zip(a2a, local)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=f"call {i}")
    for (path, g), (_p, w) in zip(flatten(ca), flatten(cl)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=path)


def test_serve_steps_match_the_reference_at_one_shard():
    """``make_serve_steps`` on (1, 1) meshes, default capacity: the logits
    of a prefill and 4 decode steps, and the greedy tokens."""
    arch = ARCHS[0]
    jcfg = jax_smoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(
        dtype="float32", moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    jparams, params = _model_params(arch, jcfg)
    tokens = np.random.default_rng(6).integers(1, cfg.vocab, (2, 8)).astype(
        np.int32)
    _jm, jprefill, jdecode, _jit = jax_serve_steps(jcfg, jax_debug_mesh(1, 1))
    jlg, jcache, jpos = jax.jit(jprefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, 16)
    jdecode = jax.jit(jdecode)
    _model, prefill, decode, _jit_decode = make_serve_steps(
        cfg, make_debug_mesh(1, 1), "cpu")
    with torch.no_grad():
        lg, caches, pos = prefill(params, {"tokens": tokens}, 16)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        jtok = jnp.asarray(tok.numpy())
        for step in range(4):
            tok, lg, caches, pos = decode(params, tok, caches, pos)
            jtok, jlg, jcache, jpos = jdecode(jparams, jtok, jcache, jpos)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                       err_msg=f"decode step {step}")
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_train_step_on_a_mesh_matches_the_reference():
    """One ``make_train_step`` step of the llama4-maverick smoke model on
    (1, 1) meshes, the reference's expert-parallel block on both sides:
    loss, grad norm and every updated parameter."""
    arch = ARCHS[0]
    jcfg = jax_smoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(
        dtype="float32", moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    jmodel, jopt, jstep, _ = jax_train_step(
        jcfg, JaxTrainConfig(lr=1e-3), jax_debug_mesh(1, 1))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = JaxTokens(jcfg, batch=4, seq=16, seed=0).get_batch(0)
    params = params_from_jax(_np(jparams), device="cpu")
    jparams, _js, jmet = jax.jit(jstep)(
        jparams, jopt.init(jparams), jax.tree.map(jnp.asarray, batch))
    _model, opt, step = make_train_step(cfg, TrainConfig(lr=1e-3), "cpu",
                                        mesh=make_debug_mesh(1, 1))
    params, _state, met = step(params, opt.init(params), batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    want = flatten(params_from_jax(_np(jparams), device="cpu"))
    got = flatten(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_p, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **TOL,
                                   err_msg=path)


def test_train_step_a2a_matches_the_local_path(monkeypatch):
    """One step at a (1, 2) mesh — the batch's S splits over model, the
    gradients flow back through both transposes and the compaction —
    against the step without a mesh, nothing dropped.  The load-balance
    loss is a mean of per-shard losses on the a2a path (the reference's
    ``pmean``), not the whole batch's, so its weight in the loss is 0 on
    both sides here; the blocks' tests hold it to the reference."""
    from repro_torch.models import model as PMODEL
    monkeypatch.setattr(PMODEL, "MOE_AUX_WEIGHT", 0.0)
    jcfg, cfg = _configs(ARCHS[0], capacity_factor=float(E))
    batch = JaxTokens(jcfg, batch=2, seq=16, seed=1).get_batch(0)
    out = []
    for mesh in (make_debug_mesh(1, 2), None):
        _jp, params = _model_params(ARCHS[0], jcfg)
        _m, opt, step = make_train_step(cfg, TrainConfig(lr=1e-3), "cpu",
                                        mesh=mesh)
        params, _s, met = step(params, opt.init(params), batch)
        out.append((params, met))
    (pa, ma), (pl, ml) = out
    for k in ("loss", "grad_norm", "xent"):
        np.testing.assert_allclose(float(ma[k]), float(ml[k]), rtol=1e-5,
                                   err_msg=k)
    for (path, g), (_p, w) in zip(flatten(pa), flatten(pl)):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   **TOL, err_msg=path)
