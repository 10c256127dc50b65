"""The training steps across processes, on the CPU, against the port's
one-device step, its stacked binding and the JAX package.

One module fixture runs ``tests/torch_dist_train_world.py`` in one child
process (gloo worlds of 1–4 ranks, each holding several meshes, see its
docstring) and, beside it, one JAX subprocess with 8 host devices that
runs the reference's ``jit_train_step`` on a (2, 2) and a (pod, data,
model) (2, 2, 1) mesh.  Weights are the reference's ``init``, carried over
with ``params_from_jax``; batches the port's ``SyntheticTokens`` (bitwise
the reference's).  Float32 smoke configs, two steps a case.  Held here,
with ``tests/test_torch_train.py``'s tolerances (loss ``rtol`` 1e-5;
parameters and moments ``atol`` 1e-4; the two sides sum float32 products
and reductions in other orders, here also across ranks):

* ``make_train_step(cfg, tcfg, mesh=ProcessMesh(...))`` on (2, 1) at ZeRO
  stages 2 and 3, (1, 2) and (2, 2), AdamW and Adafactor, with and without
  microbatches, for the qwen3-8b and llama4-maverick smoke configs: each
  rank's losses (the data ranks' mean), its parameter and optimizer-state
  blocks assembled by the layout, against the port's one-device step
  (qwen3) or its stacked binding's step on the same mesh shape (llama4,
  whose load-balance loss is the mean of the shards', the reference's
  ``pmean``, and whose capacity is each shard's); stage 3 at smoke size
  runs with ``FSDP_MIN_ELEMENTS`` lowered to 1, so every leaf with a
  dimension that divides is split over ``data`` (the reference's 2²⁰
  leaves none of a smoke model's);
* the smoke whisper and rwkv6 at ZeRO 3 on (2, 1), every leaf fsdp-split
  (their layers gather inside their ``remat`` regions), against the
  one-device step, and on (4, 1) and (pod, data, model) meshes qwen3 at
  stages 2 and 3 with both optimizers, and the smoke llama4 on (2, 1, 1)
  against its stacked binding there;
* pod meshes bit for bit their flat twins in the same world: (2, 1, 1)
  as (2, 1), (2, 2, 1) as (4, 1) — losses, the first gradient's blocks,
  parameters and moments on each rank, the dp groups the same ranks in
  the same order — and the collectives over ``("pod", "data")``;
* a world of 1 bitwise the one-device step (losses, every parameter and
  moment), also as a (1, 1, 1) mesh;
* qwen3 on (2, 2) and on (2, 2, 1) against the reference's
  ``jit_train_step`` on the same mesh (losses, every parameter);
* each collective's gradient against the unsharded function's;
* the process ``make_grad_sync`` on a (2, 2, 1) pod mesh against the
  stacked channel, the int8 payload bit for bit, the fences equal, the
  compressed within the reference's own bound;
* ``param_pspecs`` and ``opt_state_pspecs`` against the reference's for
  all ten archs at stages 0, 2 and 3 on a (2, 4) and a (2, 2, 2) mesh,
  and where the port's moment layout differs from the
  reference's stacked tree (the stack's dim);
* a checkpoint written by a world of 1, restored onto (2, 1) blocks,
  written by that world and restored whole, leaf for leaf, and the
  (2, 1) one restored onto (2, 1, 1) blocks and written again; the
  launcher on a mesh, resuming;
* ``run_elastic`` across processes, as the reference's
  ``test_elastic_remesh_recovers_from_failure``;
* ``memory_reckoning`` per rank against a hand count, on (data, model)
  and (pod, data, model) stacked meshes."""
import dataclasses
import math
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
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch.mesh import compat_abstract_mesh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import optimizer as JO  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import (ARCH_IDS, MoEConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.distributed import collectives as CL  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import tensor_parallel as TPL  # noqa: E402
from repro_torch.distributed.zero import ZeroPlan, state_layout  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.mesh import AXES_2D, AXES_3D  # noqa: E402
from repro_torch.launch.mesh import StackedMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402
from repro_torch.models.model import param_stacks  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim import optimizer as PO  # noqa: E402
from repro_torch.optim.compression import int8_payload  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=0)
TOL = dict(atol=1e-4, rtol=1e-5)
B, S, STEPS = 4, 16, 2
QWEN, LLAMA4 = "qwen3-8b", "llama4-maverick-400b-a17b"
WHISPER, RWKV = "whisper-large-v3", "rwkv6-7b"
ARCHS = (QWEN, LLAMA4, WHISPER, RWKV)


def _case(arch, mesh, stage=2, optimizer="adamw", **kw):
    return dict(arch=arch, mesh=mesh, stage=stage, optimizer=optimizer, **kw)


def _flat_and_pod():
    """qwen3 at ZeRO 2 and 3 with both optimizers on (4, 1) and (2, 2, 1),
    and on (2, 1, 1) beside the (2, 1) cases: each pod case names its flat
    twin, which it must equal bit for bit."""
    out = {}
    for flat, pod in (((2, 1), (2, 1, 1)), ((4, 1), (2, 2, 1))):
        for stage in (2, 3):
            for opt in ("adamw", "adafactor"):
                tail = (" stage 3" if stage == 3 else "") + (
                    " adafactor" if opt == "adafactor" else "")
                kw = dict(fsdp_min=1) if stage == 3 else {}
                twin = f"qwen3 {flat}{tail}"
                if flat == (4, 1):
                    out[twin] = _case(QWEN, flat, stage, opt, **kw)
                elif twin not in ("qwen3 (2, 1)", "qwen3 (2, 1) stage 3",
                                  "qwen3 (2, 1) adafactor"):
                    out[twin] = _case(QWEN, flat, stage, opt, **kw)
                out[f"qwen3 {pod}{tail}"] = _case(
                    QWEN, pod, stage, opt, twin=twin,
                    ckpt="pod" if (pod, stage, opt) == ((2, 1, 1), 2,
                                                        "adamw") else None,
                    **kw)
    return out


CASES = {
    "qwen3 (1, 1)": _case(QWEN, (1, 1), ckpt="write"),
    "llama4 (1, 1)": _case(LLAMA4, (1, 1)),
    "qwen3 (1, 1) adafactor": _case(QWEN, (1, 1), optimizer="adafactor"),
    "qwen3 (1, 1) microbatch": _case(QWEN, (1, 1), microbatch=2),
    "llama4 (1, 1) stage 3": _case(LLAMA4, (1, 1), 3, fsdp_min=1),
    "qwen3 (1, 1, 1)": _case(QWEN, (1, 1, 1)),
    "qwen3 (1, 1, 1) stage 3": _case(QWEN, (1, 1, 1), 3, fsdp_min=1),
    "qwen3 (2, 1)": _case(QWEN, (2, 1), ckpt="reshard"),
    "qwen3 (2, 1) stage 3": _case(QWEN, (2, 1), 3, fsdp_min=1),
    "llama4 (2, 1)": _case(LLAMA4, (2, 1)),
    "llama4 (2, 1) stage 3": _case(LLAMA4, (2, 1), 3, fsdp_min=1),
    "qwen3 (2, 1) adafactor": _case(QWEN, (2, 1), optimizer="adafactor"),
    "qwen3 (1, 2)": _case(QWEN, (1, 2)),
    "llama4 (1, 2)": _case(LLAMA4, (1, 2)),
    "qwen3 (1, 2) adafactor": _case(QWEN, (1, 2), optimizer="adafactor"),
    "qwen3 (2, 2)": _case(QWEN, (2, 2)),
    "llama4 (2, 2)": _case(LLAMA4, (2, 2)),
    "qwen3 (2, 2) stage 3 microbatch": _case(QWEN, (2, 2), 3, fsdp_min=1,
                                             microbatch=2),
    "llama4 (2, 2) stage 3 adafactor": _case(LLAMA4, (2, 2), 3, fsdp_min=1,
                                             optimizer="adafactor"),
    "whisper (2, 1) stage 3": _case(WHISPER, (2, 1), 3, fsdp_min=1),
    "rwkv6 (2, 1) stage 3": _case(RWKV, (2, 1), 3, fsdp_min=1),
    "llama4 (2, 1, 1)": _case(LLAMA4, (2, 1, 1)),
    **_flat_and_pod(),
}
#: The worlds, each the meshes it holds, built one after the other.
WORLDS = [[(1, 1), (1, 1, 1)], [(2, 1), (1, 2), (2, 1, 1)],
          [(2, 2), (4, 1), (2, 2, 1)]]
#: The cases held to the reference's ``jit_train_step`` on their mesh.
REFERENCE_CASES = ("qwen3 (2, 2)", "qwen3 (2, 2, 1)")
LAUNCH = _case(QWEN, (2, 1))
ELASTIC = _case(QWEN, (2, 1))


def _names(mesh):
    return AXES_3D if len(mesh) == 3 else AXES_2D


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, seed=0, n=STEPS):
    pipe = SyntheticTokens(cfg, B, S, seed=seed)
    return [pipe.get_batch(i) for i in range(n)]


REFERENCE_PROGRAM = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {tests!r})
    from torch_port_ref import reference_core
    reference_core()
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.configs.base import TrainConfig
    from repro.data import SyntheticTokens
    from repro.launch.mesh import compat_make_mesh
    from repro.train import make_train_step

    cfg = get_smoke_config({arch!r}).replace(dtype="float32")
    out = {{}}
    for k, sizes in enumerate({meshes!r}):
        names = ("pod", "data", "model")[3 - len(sizes):]
        mesh = compat_make_mesh(sizes, names)
        model, opt, _step, jit_train_step = make_train_step(
            cfg, TrainConfig(lr=1e-3, zero_stage=2), mesh)
        params = model.init(jax.random.PRNGKey(0))
        state = opt.init(params)
        pipe = SyntheticTokens(cfg, batch={B}, seq={S}, seed=0)
        shape = lambda t: jax.tree.map(  # noqa: E731
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)
        batch0 = jax.tree.map(jnp.asarray, pipe.get_batch(0))
        step = jit_train_step(shape(params), shape(state), shape(batch0))
        for i in range({steps}):
            batch = jax.tree.map(jnp.asarray, pipe.get_batch(i))
            params, state, m = step(params, state, batch)
            out[f"{{k}}/loss/{{i}}"] = np.asarray(m["loss"])
        for n, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{{k}}/param/{{n}}"] = np.asarray(leaf)
    np.savez({path!r}, **out)
"""


def _configs(arch):
    jcfg = jax_smoke(arch).replace(dtype="float32")
    moe = None
    if jcfg.moe is not None:
        moe = dataclasses.asdict(jcfg.moe)
    return jcfg, moe


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_worlds")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    ref_path = tmp / "reference.npz"
    prog = textwrap.dedent(REFERENCE_PROGRAM).format(
        tests=str(ROOT / "tests"), arch=QWEN,
        meshes=[tuple(CASES[n]["mesh"]) for n in REFERENCE_CASES], B=B, S=S,
        steps=STEPS, path=str(ref_path))
    ref_proc = subprocess.Popen([sys.executable, "-c", prog],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    params, moe, batches = {}, {}, {}
    for arch in ARCHS:
        jcfg, moe[arch] = _configs(arch)
        params[arch] = params_from_jax(
            _np(jax_build(jcfg).init(jax.random.PRNGKey(0))), device="cpu")
        batches[arch] = _batches(get_smoke_config(arch).replace(
            dtype="float32"))
    cases = {k: dict(v, moe=moe[v["arch"]]) for k, v in CASES.items()}
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((2, 2, 8, 4)).astype(np.float32),
             "b": {"c": 3 * rng.standard_normal((2, 2, 4, 8)).astype(
                 np.float32)},
             "w": rng.standard_normal((2, 2, 16, 16)).astype(np.float32)}
    coll = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in (("x", (4, 8)), ("w", (8, 8)), ("cot", (4, 8)))}
    cfg = get_smoke_config(QWEN).replace(dtype="float32")
    job = dict(params=params, cases=cases, batches=batches,
               batches_elastic=_batches(cfg, n=5), worlds=WORLDS,
               timeout_s=240, grads=tree_map(torch.from_numpy, grads),
               collectives=coll, elastic=dict(ELASTIC, moe=None),
               launch=dict(LAUNCH, moe=None),
               ckpt_a=str(tmp / "ckpt_a"), ckpt_b=str(tmp / "ckpt_b"),
               ckpt_c=str(tmp / "ckpt_c"),
               ckpt_elastic=str(tmp / "ckpt_elastic"),
               ckpt_elastic_silent=str(tmp / "ckpt_elastic_silent"),
               ckpt_launch=str(tmp / "ckpt_launch"))
    torch.save(job, tmp / "in.pt")
    r = subprocess.run([sys.executable,
                        str(ROOT / "tests" / "torch_dist_train_world.py"),
                        str(tmp / "in.pt"), str(tmp / "out.pt")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    out, err = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    results = torch.load(tmp / "out.pt", weights_only=False)
    results["reference"] = dict(np.load(ref_path))
    return results, job


# ------------------------------------------------------------ what to hold
def _cfg_tcfg(case):
    cfg = get_smoke_config(case["arch"]).replace(dtype="float32")
    if case.get("moe"):
        cfg = cfg.replace(moe=MoEConfig(**case["moe"]))
    return cfg, TrainConfig(lr=1e-3, zero_stage=case["stage"],
                            optimizer=case["optimizer"],
                            microbatch=case.get("microbatch", 0))


@pytest.fixture
def fsdp_min(monkeypatch):
    def set_(case):
        monkeypatch.setattr(SH, "FSDP_MIN_ELEMENTS",
                            case.get("fsdp_min", 1 << 20))
    return set_


def _expected(case, params, batches):
    """The port's one-device step (no mesh), or for an MoE config off (1,
    1) its stacked binding's step on the same mesh shape: (losses, params,
    state, the first step's gradients)."""
    cfg, tcfg = _cfg_tcfg(case)
    mesh = None
    if cfg.moe is not None and math.prod(case["mesh"]) > 1:
        mesh = StackedMesh(case["mesh"], _names(case["mesh"]))
    model, opt, step = make_train_step(cfg, tcfg, "cpu", mesh=mesh)
    params = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, _m = model.train_loss(params, batches[0])
    grads = dict(zip((p for p, _ in flatten(params)),
                     torch.autograd.grad(loss, leaves(params))))
    state = opt.init(params)
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, params, state, grads


def _layouts(case):
    """The parameter and state layouts of ``case`` on a stacked mesh of its
    shape, with the whole trees they apply to."""
    cfg, tcfg = _cfg_tcfg(case)
    mesh = StackedMesh(case["mesh"], _names(case["mesh"]))
    full = build_model(cfg).init(MetaGenerator())
    layout = TPL.param_layout(full, cfg, mesh, tcfg.zero_stage >= 3)
    plan = ZeroPlan(mesh, full, layout, tcfg.zero_stage)
    state = make_optimizer(tcfg, param_stacks(cfg)).init(full)
    return mesh, full, layout, state, state_layout(
        state, full, plan, param_stacks(cfg))


def _specs(tree, layout):
    out = []
    tree_map(lambda _t, s: out.append(tuple(s)), tree, layout)
    return out


def _assembled(ranks, key, tree, layout, mesh):
    """Each leaf whole from every rank's block ``key`` (``params`` or
    ``state``), the replicas checked equal."""
    paths = [p for p, _ in flatten(tree)]
    return {p: SH.assemble([r[key][p] for r in ranks], spec, mesh)
            for p, spec in zip(paths, _specs(tree, layout))}


def _cases_of(results, name):
    case = CASES[name]
    return [r["cases"][name] for r in results[tuple(case["mesh"])]]


#: The sharded cases held to the one-device (or stacked) step; a pod case
#: with a flat twin is held to its twin's bits instead.
SHARDED = [k for k, v in CASES.items()
           if math.prod(v["mesh"]) > 1 and not v.get("twin")]
ONE = [k for k, v in CASES.items() if math.prod(v["mesh"]) == 1]
TWINNED = [k for k, v in CASES.items() if v.get("twin")]


def _ill_conditioned(case, grads, path):
    """Where AdamW's step is ill-conditioned: its first update moves a
    parameter by lr·g / (|g| + eps) (eps 1e-8), so at |g| below 10·eps a
    float32 rounding of g, of the size of 1e-7 of the leaf's largest
    gradient, moves the parameter by up to a tenth of lr (qwen3's layer-1
    ``ffn/wi_up`` has an element at |g| = 7.8e-9).  Those elements are held
    to the most two steps can move them, 2·lr·(1 + wd·|p|); the gradients
    themselves are held to 1e-4
    (:func:`test_gradients_match_the_ports_unsharded_step`)."""
    if case["optimizer"] != "adamw":
        return None
    return grads[path].detach().abs().numpy() < 1e-7


@pytest.mark.parametrize("name", SHARDED)
def test_gradients_match_the_ports_unsharded_step(worlds, name, fsdp_min):
    """The first step's dp-mean gradient, each rank's block of it (what
    the ZeRO plan's push handed the optimizer) assembled, against the
    one-device (or stacked) backward: atol 1e-4
    (``tests/test_torch_train.py``'s)."""
    results, job = worlds
    case = dict(CASES[name], moe=job["cases"][name]["moe"])
    fsdp_min(case)
    _l, _p, _s, grads = _expected(case, job["params"][case["arch"]],
                                  job["batches"][case["arch"]][:1])
    mesh, full, _layout, _st, st_layout = _layouts(case)
    got = _assembled(_cases_of(results, name), "grads", full,
                     st_layout.mu, mesh)
    for path, want in grads.items():
        np.testing.assert_allclose(got[path].numpy(), want.numpy(), **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", SHARDED)
def test_train_steps_match_the_ports_unsharded_step(worlds, name, fsdp_min):
    results, job = worlds
    case = dict(CASES[name], moe=job["cases"][name]["moe"])
    fsdp_min(case)
    losses, params, state, grads = _expected(
        case, job["params"][case["arch"]], job["batches"][case["arch"]])
    ranks = _cases_of(results, name)
    for r in ranks:
        np.testing.assert_allclose([float(x) for x in r["losses"]], losses,
                                   **LOSS_TOL)
        assert all(np.isfinite(float(g)) for g in r["grad_norms"])
    mesh, full, layout, state_full, st_layout = _layouts(case)
    got = _assembled(ranks, "params", full, layout, mesh)
    for path, want in flatten(params):
        g, w = got[path].numpy(), want.detach().numpy()
        bad = _ill_conditioned(case, grads, path)
        if bad is not None and bad.any():
            assert np.all(np.abs(g - w)[bad] <= 2e-3 * (1 + 0.1 * np.abs(
                w[bad]))), path
            g, w = g[~bad], w[~bad]
        np.testing.assert_allclose(g, w, **TOL, err_msg=path)
    got = _assembled(ranks, "state", state_full, st_layout, mesh)
    for path, want in flatten(state):
        np.testing.assert_allclose(got[path].float().numpy(),
                                   want.float().numpy(), **TOL, err_msg=path)


@pytest.mark.parametrize("name", ONE)
def test_a_world_of_one_is_bitwise_the_one_device_step(worlds, name):
    results, _job = worlds
    (r,) = _cases_of(results, name)
    assert r["bitwise"] is True


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_one_case_matches_the_references_jit_train_step(worlds, name):
    """qwen3 on a (2, 2) and a (pod, data, model) (2, 2, 1) mesh, ZeRO
    stage 2: the reference's ``jit_train_step`` (GSPMD over 8 host
    devices, 4 used; the batch and the moments over ``("pod", "data")``
    on the pod mesh) and the port's four ranks from the same weights and
    batches."""
    results, job = worlds
    k = REFERENCE_CASES.index(name)
    ref = {key[len(f"{k}/"):]: v for key, v in results["reference"].items()
           if key.startswith(f"{k}/")}
    case = CASES[name]
    ranks = _cases_of(results, name)
    for r in ranks:
        np.testing.assert_allclose([float(x) for x in r["losses"]],
                                   [float(ref[f"loss/{i}"])
                                    for i in range(STEPS)], **LOSS_TOL)
    mesh, full, layout, _s, _l = _layouts(case)
    got = _assembled(ranks, "params", full, layout, mesh)
    jcfg, _moe = _configs(QWEN)
    jshapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    n = len(jax.tree.leaves(jshapes))
    numbered = params_from_jax(jax.tree.unflatten(
        jax.tree.structure(jshapes),
        [np.asarray(ref[f"param/{i}"]) for i in range(n)]), device="cpu")
    for (path, want) in flatten(numbered):
        np.testing.assert_allclose(got[path].numpy(), want.numpy(), **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", TWINNED)
def test_a_pod_mesh_steps_bit_for_bit_as_its_flat_twin(worlds, name):
    """(2, 1, 1) against (2, 1) and (2, 2, 1) against (4, 1) in the same
    world: rank by rank the same dp index, the same dp group (its ranks in
    the same order), and the losses, grad norms, the first dp-mean
    gradient's blocks, the parameters and the moments bit for bit."""
    results, _job = worlds
    case = CASES[name]
    twin = CASES[case["twin"]]
    pod = results[tuple(case["mesh"])]
    flat = results[tuple(twin["mesh"])]
    for p, f in zip(pod, flat):
        assert p["dp_group"] == f["dp_group"] == list(
            range(math.prod(case["mesh"])))
        assert p["coords"]["pod"] * case["mesh"][1] + \
            p["coords"]["data"] == f["coords"]["data"]
        a, b = p["cases"][name], f["cases"][case["twin"]]
        for key in ("losses", "grad_norms"):
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key
        for key in ("grads", "params", "state"):
            assert list(a[key]) == list(b[key]), key
            for path in a[key]:
                assert torch.equal(a[key][path], b[key][path]), (key, path)


def test_collectives_over_the_flattened_dp_axes(worlds):
    """On (2, 2, 1), ``("pod", "data")`` is one axis of 4, pod-major: the
    gathers concatenate the ranks in that order on either dim, the bf16
    sum is taken in float32 and rounded once, the mean divides by 4, and
    a reduce-scatter leaves each rank its block of the sum."""
    results, _job = worlds
    ranks = results[(2, 2, 1)]
    names = [float(10 * p + d) for p in range(2) for d in range(2)]
    delta = torch.tensor([0, 1 / 256, 1 / 512, 0], dtype=torch.bfloat16)
    psum = torch.stack([(torch.full((4,), v, dtype=torch.bfloat16) + delta)
                        .float() for v in names]).sum(0).to(torch.bfloat16)
    total = sum(torch.arange(8.0) * (1 + v) for v in names)
    for r in ranks:
        got = r["dp_collectives"]
        i = 2 * r["coords"]["pod"] + r["coords"]["data"]
        assert got["index"] == i and got["size"] == 4
        assert torch.equal(got["gather0"], torch.cat(
            [torch.full((2, 3), v) for v in names], 0))
        assert torch.equal(got["gather1"], torch.cat(
            [torch.full((2, 3), v) for v in names], 1))
        assert torch.equal(got["psum"], psum)
        assert float(got["pmean"]) == sum(names) / 4
        assert torch.equal(got["reduce_scatter"], total[2 * i:2 * i + 2])


def test_the_bound_step_refuses_blocks_of_another_layout(worlds):
    results, _job = worlds
    seen = 0
    for name in SHARDED + TWINNED:
        for r in _cases_of(results, name):
            assert r["refused_whole"] is True, name
            seen += 1
    assert seen


def test_fsdp_init_draws_each_ranks_block(worlds):
    """At stage 3 ``model.init(generator)`` draws each rank's blocks of
    the whole init from the same seed, split over ``data`` too."""
    results, _job = worlds
    names = [k for k, v in CASES.items() if v["stage"] == 3]
    for name in names:
        for r in _cases_of(results, name):
            assert r["init_blocks_equal"] is True, name


# --------------------------------------------------------- the collectives
def _expected_collective(inp, kind):
    x, w, cot = (inp[k].clone() for k in ("x", "w", "cot"))
    if kind in ("row", "column"):
        xf = x.clone().requires_grad_(True)
        wf = w.clone().requires_grad_(True)
        y = xf @ wf
        gx, gw = torch.autograd.grad((y * cot).sum(), (xf, wf))
        return dict(y=y.detach(), x=gx, w=gw)
    if kind == "slice":
        return dict(x=2 * x * cot[:, :x.shape[1]])
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["row", "column", "slice", "a2a", "fsdp",
                                  "loss_mean"])
def test_each_collectives_gradient_is_the_unsharded_functions(worlds, kind):
    """On the (2, 2) world: the row-parallel sum (psum forward, the
    gradient through), the column-parallel input (``copy_to``: identity,
    the gradient summed) with the gathered output (its gradient the rank's
    slice), a slice over ``model`` gathered back, ``all_to_all`` over
    ``data`` (its own adjoint), fsdp's ``gather_param`` (its gradient
    reduce-scattered, summed over the data ranks' losses) and
    ``loss_mean``."""
    results, job = worlds
    inp = job["collectives"]
    mesh = StackedMesh((2, 2), ("data", "model"))
    for r in results[(2, 2)]:
        c, got = r["coords"], r["collectives"][kind]
        if kind in ("row", "column"):
            want = _expected_collective(inp, kind)
            torch.testing.assert_close(got["y"], want["y"], rtol=1e-5,
                                       atol=1e-5)
            wspec = ("model", None) if kind == "row" else (None, "model")
            torch.testing.assert_close(got["w"], SH.shard(
                want["w"], wspec, mesh, c), rtol=1e-5, atol=1e-5)
            gx = want["x"] if kind == "column" else SH.shard(
                want["x"], (None, "model"), mesh, c)
            torch.testing.assert_close(got["x"], gx, rtol=1e-5, atol=1e-5)
        elif kind == "slice":
            torch.testing.assert_close(
                got["x"], _expected_collective(inp, kind)["x"])
        elif kind == "a2a":
            # rank (d, m) sent row j to data coordinate j; it received row
            # d of each data coordinate s's x
            x = inp["x"]
            want = torch.stack([x[c["data"]] + 10 * s + 100 * c["model"]
                                for s in range(2)])
            assert torch.equal(got["y"], want)
            # its gradient: the cotangent rows its peers applied to its rows
            assert torch.equal(got["x"], inp["cot"][:2, :8][
                [c["data"], c["data"]]])
        elif kind == "fsdp":
            x, w, cot = inp["x"], inp["w"], inp["cot"]
            # the data ranks' losses summed: (x @ w · cot).sum() over all rows
            wf = w.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(((x @ wf) * cot).sum(), wf)
            torch.testing.assert_close(got["w"], SH.shard(
                g, ("data", None), mesh, c), rtol=1e-5, atol=1e-5)
        else:
            v = [float(inp["x"][0, 0]) * (1 + d + 2 * m)
                 for d in range(2) for m in range(2)]
            assert abs(float(got["y"]) - sum(v) / 4) <= 1e-6 * max(
                1.0, abs(sum(v)))
            # the gradient of the world mean, scaled for a model axis of 2
            # that sums the partial gradients: n_data / world
            assert float(got["x"]) == 0.5


# -------------------------------------------------------- the grad channel
def _stacked(tree):
    """(pod, data, ...) → the stacked binding's (pod, data, model=1,
    ...)."""
    return tree_map(lambda g: g[:, :, None].clone(), tree)


@pytest.mark.parametrize("compress", ["none", "int8ef"])
@pytest.mark.parametrize("fence", ["global", "pair"])
def test_process_grad_sync_matches_the_stacked_channel(worlds, fence,
                                                       compress):
    """Two calls (the second carrying the int8 residual) on each rank of
    the (2, 2, 1) world against the stacked ``grad_sync`` on every
    participant's gradients: float32 means of 2 in another order, rtol
    1e-6 (``tests/test_torch_collectives.py``)."""
    results, job = worlds
    grads = _stacked(job["grads"])
    first, err = CL.grad_sync(grads, data_dim=1, pod_dim=0, fence=fence,
                              compress=compress, lead=3)
    second, _err = CL.grad_sync(grads, data_dim=1, pod_dim=0, fence=fence,
                                compress=compress, error_state=err, lead=3)
    for r in results["grad_sync"]:
        p, d = r["coords"]["pod"], r["coords"]["data"]
        for got, want in zip(r[(fence, compress)], (first, second)):
            for (path, g), w in zip(flatten(got), leaves(want)):
                np.testing.assert_allclose(g.numpy(), w[p, d, 0].numpy(),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=path)


def test_fences_give_equal_values_and_the_exact_sync_is_the_dp_mean(worlds):
    """The reference's ``test_grad_sync_hierarchical_and_fence_
    equivalence`` on the process channel: both fences bitwise equal; the
    exact sync each leaf's mean over every (pod, data) participant."""
    results, job = worlds
    for r in results["grad_sync"]:
        for a, b in zip(leaves(r[("global", "none")][0]),
                        leaves(r[("pair", "none")][0])):
            assert torch.equal(a, b)
        for g, full in zip(leaves(r[("global", "none")][0]),
                           leaves(job["grads"])):
            np.testing.assert_allclose(g.numpy(), full.mean((0, 1)).numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_the_int8_payload_is_the_stacked_ones_bit_for_bit(worlds):
    results, job = worlds
    g = job["grads"]["w"].mean(1, keepdim=True)     # after the data mean
    q, scale = int8_payload(g, 0, lead=2)
    for r in results["grad_sync"]:
        p = r["coords"]["pod"]
        got_q, got_scale = r["payload"]["w"]
        assert got_q.dtype == torch.int8
        assert torch.equal(got_q, q[p, 0])
        assert float(got_scale) == float(scale.reshape(-1)[0])


def test_int8_compression_is_close_to_exact(worlds):
    """The reference's ``test_grad_sync_int8_compression_close`` bound."""
    results, _job = worlds
    for r in results["grad_sync"]:
        exact = r[("global", "none")][0]["w"]
        comp = r[("global", "int8ef")][0]["w"]
        err = float((exact - comp).abs().max())
        scale = float(exact.abs().max())
        assert err < 0.02 * scale + 0.02, (err, scale)


# --------------------------------------------------------- ZeRO's layouts
def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_as_jax(v) for v in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _jax_state(state):
    cls = JO.AdamState if isinstance(state, PO.AdamState) else \
        JO.FactoredState
    return cls(**{k: _as_jax(v) for k, v in state._asdict().items()})


def _flat_specs(tree):
    """A JAX spec tree by the port's paths."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {JSH._path_str(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2, 2)])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("stage", [0, 2, 3])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_pspecs_match_the_reference(arch, stage, optimizer,
                                              mesh_shape):
    """The reference's ``param_pspecs`` (fsdp at stage 3) and
    ``opt_state_pspecs`` and the port's on the port's trees, leaf by leaf,
    on a (2, 4) and a (pod, data, model) (2, 2, 2) mesh
    (``compat_abstract_mesh``): on the pod mesh fsdp and ZeRO split over
    ``("pod", "data")``."""
    names = _names(mesh_shape)
    jmesh = compat_abstract_mesh(mesh_shape, names)
    mesh = StackedMesh(mesh_shape, names)
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(MetaGenerator())
    tcfg = TrainConfig(optimizer=optimizer)
    state = make_optimizer(tcfg, param_stacks(cfg)).init(params)
    pspecs = SH.param_pspecs(params, mesh, fsdp=stage >= 3)
    got = PO.opt_state_pspecs(state, pspecs, mesh, stage)
    jspecs = JSH.param_pspecs(_as_jax(params), jmesh, fsdp=stage >= 3)
    want = JO.opt_state_pspecs(_jax_state(state), jspecs, jmesh, stage)
    assert dict(zip((p for p, _ in flatten(params)),
                    _specs(params, pspecs))) == _flat_specs(jspecs)
    flat_g = dict(zip((p for p, _ in flatten(state)), _specs(state, got)))
    assert flat_g == _flat_specs(want)
    dp = SH.dp_axes(mesh)
    if stage >= 2:
        assert any(SH.entry_axes(e) == dp for s in flat_g.values()
                   for e in s)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-8b", "gemma-2b",
                                  "internlm2-20b"])
def test_moments_differ_from_the_references_stacked_tree_only_on_the_stack(
        arch):
    """The port's per-layer leaf splits its moments on its first free dim
    that divides; the reference's stacked (n, …) leaf on the stack's dim
    when n divides over ``data`` (each data rank whole layers).  Every
    other leaf's moment spec is the reference's without the stack dims."""
    jmesh = compat_abstract_mesh((2, 4), ("data", "model"))
    mesh = StackedMesh((2, 4), ("data", "model"))
    jcfg = jax_smoke(arch)
    jshapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    jflat, treedef = jax.tree_util.tree_flatten(jshapes)
    jstate = JO.AdamState(jshapes, jshapes,
                          jax.ShapeDtypeStruct((), jnp.int32))
    jmom = jax.tree.leaves(JO.opt_state_pspecs(
        jstate, JSH.param_pspecs(jshapes, jmesh), jmesh, 2).mu,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    numbered = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.int32) for i, s in
                  enumerate(jflat)])
    params = params_from_jax(numbered, device="cpu")
    state = PO.AdamState(params, params, torch.zeros((), dtype=torch.int32))
    got = _specs(params, PO.opt_state_pspecs(
        state, SH.param_pspecs(params, mesh), mesh, 2).mu)
    on_stack = 0
    for (path, leaf), spec in zip(flatten(params), got):
        i = int(leaf.reshape(-1)[0])
        want = tuple(jmom[i]) + (None,) * (len(jflat[i].shape) -
                                           len(tuple(jmom[i])))
        stack = len(jflat[i].shape) - leaf.dim()
        spec = spec + (None,) * (leaf.dim() - len(spec))
        if stack and want[0] == "data":
            on_stack += 1
            assert "data" in spec, (path, spec)
            assert want[stack:] == tuple(None if e == "data" else e
                                         for e in spec), (path, want, spec)
        else:
            assert want[stack:] == spec, (path, want, spec)
    assert on_stack, "some stacked leaf splits its moments over layers"


# ------------------------------------------------------ checkpoint, elastic
def test_a_checkpoint_round_trips_between_worlds_of_1_and_2(worlds):
    """Written by the world of 1 (whole leaves), restored onto (2, 1)
    blocks — each the block of the whole leaf — written by that world
    (gathered to one writer) and read back whole: leaf for leaf, bitwise,
    in the format of a one-device checkpoint."""
    results, job = worlds
    a = CheckpointManager(job["ckpt_a"])
    b = CheckpointManager(job["ckpt_b"])
    assert a.steps() == [1] and b.steps() == [2]
    case = CASES["qwen3 (2, 1)"]
    cfg, tcfg = _cfg_tcfg(case)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    like = {"params": params,
            "opt": make_optimizer(tcfg, param_stacks(cfg)).init(params)}
    whole_a, whole_b = a.restore(1, like), b.restore(2, like)
    for (path, x), y in zip(flatten(whole_a), leaves(whole_b)):
        assert torch.equal(x, y), path
    mesh, full, layout, state, st_layout = _layouts(dict(case, moe=None))
    specs = _specs(full, layout) + _specs(state, st_layout)
    for r in results[(2, 1)]:
        got = r["cases"]["qwen3 (2, 1)"]["restored"]
        for ((path, x), spec) in zip(flatten(whole_a), specs):
            assert torch.equal(got[path], SH.shard(x, spec, mesh,
                                                   r["coords"])), path


def test_a_checkpoint_from_2_1_restores_onto_a_pod_mesh(worlds):
    """The checkpoint (2, 1) wrote, restored onto (2, 1, 1) blocks — each
    the block of the whole leaf on the pod mesh's layout (ZeRO's moments
    over ``("pod", "data")``) — and written by that world: read back
    whole, leaf for leaf the (2, 1) checkpoint's, bitwise."""
    results, job = worlds
    b = CheckpointManager(job["ckpt_b"])
    c = CheckpointManager(job["ckpt_c"])
    assert c.steps() == [3]
    case = CASES["qwen3 (2, 1, 1)"]
    cfg, tcfg = _cfg_tcfg(case)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    like = {"params": params,
            "opt": make_optimizer(tcfg, param_stacks(cfg)).init(params)}
    whole_b, whole_c = b.restore(2, like), c.restore(3, like)
    for (path, x), y in zip(flatten(whole_b), leaves(whole_c)):
        assert torch.equal(x, y), path
    mesh, full, layout, state, st_layout = _layouts(dict(case, moe=None))
    specs = _specs(full, layout) + _specs(state, st_layout)
    assert any(SH.entry_axes(e) == ("pod", "data") for sp in specs
               for e in sp)
    for r in results[(2, 1, 1)]:
        got = r["cases"]["qwen3 (2, 1, 1)"]["restored"]
        for ((path, x), spec) in zip(flatten(whole_b), specs):
            assert torch.equal(got[path], SH.shard(x, spec, mesh,
                                                   r["coords"])), path


def test_the_launcher_trains_on_a_mesh_and_resumes(worlds, tmp_path):
    """``launch.train.run`` on (2, 1): two steps and a checkpoint, then a
    run to step 3 resuming from it; its losses are the one-device
    launcher's."""
    results, _job = worlds
    cfg, tcfg = _cfg_tcfg(LAUNCH)
    pipe = SyntheticTokens(cfg, B, S, seed=0)
    want = launcher.run(cfg, tcfg, pipe, steps=3, device="cpu",
                        ckpt_dir=str(tmp_path), log_every=10)["losses"]
    for r in results[tuple(LAUNCH["mesh"])]:
        got = r["launch"]
        assert got["start"] == 2
        np.testing.assert_allclose(got["losses"], want, **LOSS_TOL)


def test_run_elastic_across_processes_recovers(worlds):
    """``tests/test_distributed.py``'s scenario on a world of 2: two steps
    on (2, 1), a checkpoint at step 1, then ``run_elastic`` to step 5 with
    a failure at step 3: it restores step 1, runs step 2, fails, shrinks
    the world to (1, 1) — rank 1 leaves — and rank 0 restores step 1 onto
    its new blocks and finishes; its replayed step 2 has step 2's loss."""
    results, _job = worlds
    r0, r1 = results["elastic"]
    assert r0["history"] == [(2, 0), (2, 1), (3, 1), (4, 1)]
    levels = [lv for _s, lv in r0["history"]]
    assert 0 in levels and 1 in levels and r0["history"][-1][0] == 4
    assert r1["left"] and r1["history"] == [(2, 0)]
    assert not r0["left"]
    assert r0["meshes"] == [{"data": 2, "model": 1}] * 2 + \
        [{"data": 1, "model": 1}]
    losses = r0["losses"]
    assert [b for b, _l in losses] == [0, 0, 1, 2, 2, 2]
    np.testing.assert_allclose(losses[2][1], losses[3][1], **LOSS_TOL)
    assert all(np.isfinite(v) for _b, v in losses)
    assert all(torch.isfinite(t).all() for t in leaves(r0["final"]))


def test_run_elastic_recovers_when_the_lost_rank_goes_without_a_word(
        worlds):
    """The same world, but only rank 0 sees the failure at step 3: rank 1
    leaves its world there without a word (no collective, no
    ``shrink_world``), as a rank that died.  Rank 0 re-forms the world
    alone at the address fixed when both were alive, restores step 1 and
    finishes with the history and losses of the announced run."""
    results, _job = worlds
    r0, r1 = results["elastic_silent"]
    told = results["elastic"][0]
    assert r1["gone"] and [b for b, _l in r1["losses"]] == [0, 0, 1]
    assert r0["history"] == told["history"] and not r0["left"]
    assert r0["meshes"] == told["meshes"]
    np.testing.assert_allclose([v for _b, v in r0["losses"]],
                               [v for _b, v in told["losses"]], **LOSS_TOL)
    for a, b in zip(leaves(r0["final"]), leaves(told["final"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ------------------------------------------------------------------ memory
def _hand_count_llama32(n_dp, n_model, stage):
    """llama3.2-3b's smoke config (d 48, 4 heads and 2 kv heads of 12, d_ff
    96, vocab 256 tied, 2 layers) in float32 with AdamW: one rank's
    elements of parameters and moments, by hand, ``n_dp`` the product of
    the dp axes (pod · data); at stage 3 with every leaf fsdp-split."""
    d, hd, f, v = 48, 12, 96, 256
    embed = v * d // n_model
    layer = (2 * d                          # ln1, ln2 (replicated)
             + d * 4 * hd // n_model        # wq: columns over model
             + 2 * d * 2 * hd // n_model    # wk, wv
             + 4 * hd * d // n_model        # wo: rows over model
             + 3 * d * f // n_model)        # wi_gate, wi_up, wo
    params = embed + 2 * layer + d          # + final_norm
    if stage >= 3:     # every leaf has a free dim that divides over dp
        return params // n_dp, 2 * params // n_dp
    # stage 2: every moment leaf here has a dim that divides over dp
    moments = 2 * params // (n_dp if stage >= 2 else 1)
    return params, moments


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2),
                                  (2, 1, 1), (2, 2, 1), (2, 1, 2)])
@pytest.mark.parametrize("stage", [0, 2, 3])
def test_memory_reckoning_per_rank_matches_a_hand_count(mesh, stage,
                                                        monkeypatch):
    """On (data, model) and stacked (pod, data, model) meshes, the dp
    blocks over pod · data; stage 3 with ``FSDP_MIN_ELEMENTS`` lowered to
    1, so every leaf is fsdp-split."""
    monkeypatch.setattr(SH, "FSDP_MIN_ELEMENTS", 1)
    cfg = get_smoke_config("llama3.2-3b").replace(dtype="float32")
    tcfg = TrainConfig(zero_stage=stage)
    got = launcher.memory_reckoning(cfg, tcfg,
                                    StackedMesh(mesh, _names(mesh)))
    params, moments = _hand_count_llama32(math.prod(mesh[:-1]), mesh[-1],
                                          stage)
    assert got["params"] == got["grads"] == 4 * params
    assert got["optimizer_state"] == 4 * moments + 4   # + the int32 count
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


def test_memory_reckoning_lets_llama4_fit_a_rank_of_eight():
    """llama4-maverick at its published widths, 2 layers (one MoE), AdamW:
    244.1 GB on one device; about an eighth a rank of a (1, 8) mesh, which
    fits an 80 GB card."""
    cfg = get_config("llama4-maverick-400b-a17b").replace(n_layers=2)
    one = launcher.memory_reckoning(cfg, TrainConfig())
    eight = launcher.memory_reckoning(cfg, TrainConfig(),
                                      StackedMesh((1, 8), ("data", "model")))
    assert math.isclose(one["total"] / 1e9, 244.1, abs_tol=0.05)
    assert 28e9 < eight["total"] < 33e9 < 80e9 < one["total"]
