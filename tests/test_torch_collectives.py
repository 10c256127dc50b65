"""The port's gradient channel, int8 error-feedback compression, stacked
meshes and elastic re-mesh against the JAX package's, on the CPU.

* ``quantize_int8`` / ``dequantize_int8`` bitwise, in float32 and
  bfloat16;
* ``grad_sync`` on stacked (pod, data, ...) leaves against the reference's
  per-participant ``grad_sync`` under ``jax.vmap`` over "pod" and "data"
  (its vmap binding), each participant's gradient and error state drawn
  apart: exact sync, and int8 error feedback on the pod hop, whose int8
  payload must be the reference's bit for bit (recovered from the
  reference's error state, gf − q·scale, q an integer of at most 127 in
  size) and whose outputs agree within ``rtol=1e-6`` (float32 means of 2
  in the same order), the error state within ``rtol=1e-6`` and an ulp of
  the largest |gf| (the error gf − q·scale cancels, and one side may fuse
  its product into the difference);
* the ``global`` and ``pair`` fences give bitwise-equal values;
* compressed against exact sync within the reference's own bound,
  ``0.02·scale + 0.02`` (``tests/test_distributed.py``);
* ``_bucketize``, ``fence_grads``, ``compression_error_init``;
* ``StackedMesh`` and the mesh factories, ``dp_axes``;
* ``run_elastic``: a reused failure plan drives the same history as the
  reference's, ``[(0, 0), (0, 1), (1, 1), (2, 1)]``, and is not drained;
  and ``tests/test_distributed.py``'s re-mesh scenario on the port
  (qwen3-8b smoke, meshes (4, 2) then (2, 2), a checkpoint in
  ``tmp_path``), the degraded mesh's step equal to the step it replays."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.distributed import collectives as JC  # noqa: E402
from repro.distributed.fault import ElasticMeshSpec as JSpec  # noqa: E402
from repro.distributed.fault import run_elastic as jax_run_elastic  # noqa: E402
from repro.optim import compression as JQ  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.distributed import (DeviceFailure,  # noqa: E402
                                     ElasticMeshSpec, run_elastic)
from repro_torch.distributed import collectives as PC  # noqa: E402
from repro_torch.distributed.sharding import DP, TP, dp_axes  # noqa: E402
from repro_torch.launch.mesh import (StackedMesh,  # noqa: E402
                                     make_debug_mesh, make_production_mesh)
from repro_torch.optim import compression as PQ  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

NPOD, NDATA = 2, 2
SHAPES = {"b": {"c": (7,), "d": (3, 5, 4)}, "w": (16, 12)}   # jax.tree order


def _draw(rng, shapes, scale=1.0):
    """A tree of (pod, data, *shape) float32 arrays, one draw each."""
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal((NPOD, NDATA, *shapes))).astype(
        np.float32)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _reference_sync(grads, error, compress, fence="global", n_buckets=4):
    """The reference's per-participant ``grad_sync`` under vmap over "pod"
    (outer) and "data"."""
    def one(g, e):
        return JC.grad_sync(g, data_axis="data", pod_axis="pod",
                            fence=fence, compress=compress,
                            error_state=e, n_buckets=n_buckets)

    f = jax.vmap(jax.vmap(one, axis_name="data"), axis_name="pod")
    return jax.jit(f)(jax.tree.map(jnp.asarray, grads),
                      jax.tree.map(jnp.asarray, error))


def _port_sync(grads, error, compress, fence="global", n_buckets=4):
    return PC.grad_sync(_torch(grads), data_dim=1, pod_dim=0, fence=fence,
                        compress=compress,
                        error_state=None if error is None else _torch(error),
                        n_buckets=n_buckets)


def _pairs(tree, ref):
    return zip((leaf for _p, leaf in flatten(tree)),
               (np.asarray(leaf) for _p, leaf in flatten(ref)))


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_the_references(dtype):
    x = np.random.default_rng(0).standard_normal((33, 17)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = PQ.quantize_int8(tx)
    jq, js = JQ.quantize_int8(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.dtype == tx.dtype
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        PQ.dequantize_int8(q, s).float().numpy(),
        np.asarray(JQ.dequantize_int8(jq, js), np.float32))


def test_quantize_int8_rounds_half_to_even():
    """Both packages round .5 to the even integer."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = PQ.quantize_int8(x)
    jq, _js = JQ.quantize_int8(jnp.asarray(x.numpy()))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2] == np.asarray(jq).tolist()


@pytest.mark.parametrize("with_error", [False, True])
def test_int8_ef_grad_sync_matches_the_reference_under_vmap(with_error):
    rng = np.random.default_rng(1)
    grads = _draw(rng, SHAPES)
    error = _draw(rng, SHAPES, 0.01) if with_error else None
    zeros = jax.tree.map(np.zeros_like, grads)
    synced, err = _port_sync(grads, error, "int8ef")
    jsynced, jerr = _reference_sync(grads, zeros if error is None else error,
                                    "int8ef")
    for (g, w), (e, we), (_p, gin), (_q, ein) in zip(
            _pairs(synced, jsynced), _pairs(err, jerr),
            flatten(_torch(grads)),
            flatten(_torch(zeros if error is None else error))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
        # the payload: gf = the data mean + the error, then q of the one
        # scale over pods; the reference's q is (gf − its error) / scale
        gf = gin.mean(1, keepdim=True).expand(gin.shape) + ein
        # the error gf − q·scale cancels: where one side fuses the product
        # into the difference, the two differ by up to an ulp of gf
        np.testing.assert_allclose(e.numpy(), we, rtol=1e-6,
                                   atol=2.0 ** -23 * float(gf.abs().max()))
        q, scale = PQ.int8_payload(gf, 0, lead=2)
        jq = np.round((gf.numpy() - we) / scale.numpy())
        assert np.abs(jq).max() <= 127
        np.testing.assert_array_equal(q.numpy().astype(np.float64), jq)


def test_int8_ef_allreduce_carries_its_residual():
    """Over steps the error feedback applies what it withheld: the sum of
    the synced outputs tracks the sum of the exact means, within one step's
    quantization."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    err = PQ.compression_error_init(g)
    total, exact = torch.zeros(50), torch.zeros(50)
    for _ in range(20):
        out, err = PQ.int8_ef_allreduce(g, 0, err)
        assert torch.equal(out[0], out[3])
        total += out[0]
        exact += g.mean(0)
    step_q = (g.abs().max() / 127).item()
    assert (total - exact).abs().max() <= 2 * step_q
    assert err.shape == g.shape and err.dtype == torch.float32


@pytest.mark.parametrize("n_buckets", [1, 2, 4, 16])
def test_exact_grad_sync_matches_the_reference_under_vmap(n_buckets):
    rng = np.random.default_rng(3)
    grads = _draw(rng, SHAPES)
    synced, err = _port_sync(grads, None, "none", n_buckets=n_buckets)
    jsynced, _jerr = _reference_sync(grads, None, "none",
                                     n_buckets=n_buckets)
    assert err is None
    for g, w in _pairs(synced, jsynced):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)


@pytest.mark.parametrize("compress", ["none", "int8ef"])
def test_global_and_pair_fences_give_bitwise_equal_values(compress):
    rng = np.random.default_rng(4)
    grads = _draw(rng, SHAPES)
    error = _draw(rng, SHAPES, 0.01) if compress == "int8ef" else None
    out = {f: _port_sync(grads, error, compress, fence=f, n_buckets=2)
           for f in ("global", "pair")}
    for (_p, a), (_q, b) in zip(flatten(out["global"]), flatten(out["pair"])):
        if a is not None:
            assert torch.equal(a, b)


def test_compressed_sync_stays_within_the_references_bound():
    rng = np.random.default_rng(5)
    grads = _draw(rng, {"w": (16, 16)})
    exact, _ = _port_sync(grads, None, "none")
    comp, _ = _port_sync(grads, None, "int8ef")
    err = float((exact["w"] - comp["w"]).abs().max())
    scale = float(exact["w"].abs().max())
    assert 0 < err < 0.02 * scale + 0.02


def test_bucketize_fence_grads_and_error_init():
    for n, b in ((0, 4), (1, 4), (7, 3), (5, 16), (9, 1)):
        assert PC._bucketize(n, b) == JC._bucketize(n, b)
    g = {"a": torch.ones(3), "b": [torch.zeros(2, 2, dtype=torch.bfloat16)]}
    assert PC.fence_grads(g) is g
    e = PQ.compression_error_init(g)
    assert e["a"].dtype == e["b"][0].dtype == torch.float32
    assert not e["a"].any() and e["b"][0].shape == (2, 2)


def test_make_grad_sync_means_over_the_dp_axes_only():
    """On a (data, model) mesh each model shard keeps its own values and the
    data shards leave with their mean."""
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.standard_normal((4, 2, 3, 5)).astype(
        np.float32))
    out = PC.make_grad_sync(make_debug_mesh(4, 2))({"g": g})["g"]
    want = g.mean(0, keepdim=True).expand(g.shape)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6)
    assert not torch.allclose(out[:, 0], out[:, 1])


# ------------------------------------------------------------------- meshes
def test_stacked_meshes_read_as_jax_meshes():
    m = make_debug_mesh(2, 4)
    assert m.shape == {"data": 2, "model": 4}
    assert m.axis_names == ("data", "model")
    assert dp_axes(m) == ("data",) and (DP, TP) == (("pod", "data"), "model")
    p = make_production_mesh(multi_pod=True, dp=64, tp=4)
    assert p.axis_names == ("pod", "data", "model")
    assert p.shape == {"pod": 2, "data": 64, "model": 4}
    assert dp_axes(p) == ("pod", "data")
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    with pytest.raises(AssertionError):
        make_production_mesh(dp=8, tp=8)
    with pytest.raises(ValueError):
        StackedMesh((2, 2), ("data",))
    assert StackedMesh([2], ["data"]) == StackedMesh((2,), ("data",))


# ------------------------------------------------------------------ elastic
class _NoCkpt:
    def latest_step(self):
        return None


def test_run_elastic_does_not_consume_callers_failure_plan():
    """The reference's regression test on both packages: the same plan
    drives the same failure schedule on every run, and the caller's dict
    is left as it was."""
    def build_port(mesh):
        assert isinstance(mesh, StackedMesh)
        return {"x": torch.zeros(())}, \
            lambda s, b: ({"x": s["x"] + b}, None), lambda mesh: None

    def build_ref(mesh):
        return {"x": jnp.zeros(())}, \
            lambda s, b: ({"x": s["x"] + b}, None), lambda mesh: None

    plan = {1: True}
    runs = []
    for fn, spec_t, build in (
            (run_elastic, ElasticMeshSpec, build_port),
            (jax_run_elastic, JSpec, build_ref)):
        spec = spec_t(shapes=[(1, 1), (1, 1)], axis_names=("data", "model"))
        for _run in range(2):
            _state, history = fn(spec, build, _NoCkpt(), total_steps=3,
                                 get_batch=lambda step: 1.0,
                                 inject_failure_at=plan,
                                 log=lambda *_a, **_k: None)
            runs.append(history)
    assert plan == {1: True}, "caller's plan must not be mutated"
    assert runs[0] == runs[1] == runs[2] == runs[3] == \
        [(0, 0), (0, 1), (1, 1), (2, 1)]


def test_run_elastic_gives_up_past_the_last_level():
    spec = ElasticMeshSpec(shapes=[(2, 1)], axis_names=("data", "model"))

    def build(mesh):
        return {}, lambda s, b: (s, None), None

    with pytest.raises(RuntimeError, match="no smaller mesh"):
        run_elastic(spec, build, _NoCkpt(), total_steps=2,
                    get_batch=lambda s: None, inject_failure_at={0: True},
                    log=lambda *_a: None)
    assert issubclass(DeviceFailure, RuntimeError)
    assert DeviceFailure(3).failed_slice == 3


def test_elastic_remesh_recovers_from_failure(tmp_path):
    """``tests/test_distributed.py``'s scenario on the port: two steps on a
    (4, 2) mesh, a checkpoint at step 1, then ``run_elastic`` to step 5
    with a failure injected at step 3: it restores step 1, fails, re-meshes
    to (2, 2), restores step 1 again and finishes there.  Step 2 on the
    degraded mesh replays step 2 from the same state and batch, so its loss
    is step 2's on the full one."""
    cfg = get_smoke_config("qwen3-8b").replace(dtype="float32")
    tcfg = TrainConfig(lr=1e-3)
    pipe = SyntheticTokens(cfg, batch=8, seq=16, seed=0)
    ckpt = CheckpointManager(str(tmp_path), keep_last=2)
    spec = ElasticMeshSpec(shapes=[(4, 2), (2, 2)],
                           axis_names=("data", "model"))
    meshes, losses = [], []

    def build(mesh):
        meshes.append(mesh)
        model, opt, train_step = make_train_step(cfg, tcfg, "cpu",
                                                 mesh=mesh)
        params = model.init(torch.Generator().manual_seed(0))
        state = {"params": params, "opt": opt.init(params)}

        def step_fn(state, batch):
            p, o, m = train_step(state["params"], state["opt"], batch)
            losses.append((len(meshes) - 1, float(m["loss"])))
            return {"params": p, "opt": o}, m

        return state, step_fn, lambda mesh: None

    state, step_fn, _ = build(spec.mesh_for(0))
    for s in range(2):
        state, _m = step_fn(state, pipe.get_batch(s))
    ckpt.save(1, state, blocking=True)
    _state, history = run_elastic(spec, build, ckpt, total_steps=5,
                                  get_batch=pipe.get_batch,
                                  inject_failure_at={3: True},
                                  log=lambda *_a: None)
    assert history == [(2, 0), (2, 1), (3, 1), (4, 1)]
    assert [m.shape for m in meshes] == [{"data": 4, "model": 2}] * 2 + \
        [{"data": 2, "model": 2}]
    # losses: build 0's two steps, build 1's step 2, build 2's steps 2-4
    assert [b for b, _l in losses] == [0, 0, 1, 2, 2, 2]
    assert losses[2][1] == losses[3][1]
    assert all(np.isfinite(v) for _b, v in losses)
