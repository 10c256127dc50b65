"""The port's training path against the JAX package's, on the CPU in
float32: ``train_loss`` and every gradient leaf on the smoke configs of
llama3.2-3b, gemma-2b, qwen3-8b, recurrentgemma-2b, rwkv6-7b,
llama4-maverick (the MoE aux term) and deepseek-v3 (MLA, MoE aux and the
MTP term), and llama3.2-3b's with the loss in 4 sequence chunks;
``train_loss`` and every gradient of the llama-3.2-vision (seeded non-zero
gates) and whisper smoke models on the pipeline's context, against
``jax.value_and_grad`` of the reference's ``train_loss``; the
parameters and optimizer moments after two AdamW steps and
one Adafactor step; microbatching; the loss falling on a repeated batch;
the Philox pipeline and its context synthesizer; checkpoints; the launcher
with a resume; and ``input_specs``.

The reference runs as its trainer builds it: ``make_train_step`` on a
(1, 1) mesh (attention ``impl="chunked"``, ``remat="block"``, the MoE
block's expert-parallel form at one shard), imported through
``torch_port_ref``.  Weights come from the reference's ``init`` and cross
with ``params_from_jax``; batches are the reference's ``SyntheticTokens``.
Tolerances: the loss ``rtol=1e-5``; gradients ``atol=1e-4`` (``rtol=1e-5``)
and parameters and moments after the optimizer steps ``atol=1e-4``, as
``tests/test_torch_model.py``'s logits: the two sides sum float32 products
and reductions in other orders through the stack and its backward;
microbatching against the full batch 5e-5, as
``tests/test_train_stack.py``; the pipeline and checkpoints bitwise."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import LM_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.data import FileTokens as JaxFileTokens  # noqa: E402
from repro.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import MoEConfig, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LM_SHAPES, TrainConfig  # noqa: E402
from repro_torch.data import (FileTokens, SyntheticTokens,  # noqa: E402
                              make_pipeline, place_batch)
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import AdamState, FactoredState  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

ARCHS = ["llama3.2-3b", "gemma-2b", "qwen3-8b", "recurrentgemma-2b",
         "rwkv6-7b", "llama4-maverick-400b-a17b", "deepseek-v3-671b"]
GRAD_TOL = dict(atol=1e-4, rtol=1e-5)
B, S = 4, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    jcfg = jax_smoke(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if jcfg.moe is not None:
        # the reference's a2a router at one shard routes as its local block
        cfg = cfg.replace(moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    return jcfg, cfg


def _reference(arch, **tkw):
    jcfg, cfg = _configs(arch)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    jmodel, jopt, jstep, _ = jax_train_step(
        jcfg, JaxTrainConfig(lr=1e-3, **tkw), mesh)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    pipe = JaxTokens(jcfg, batch=B, seq=S, seed=0)
    return jcfg, cfg, jmodel, jopt, jstep, jparams, pipe


@pytest.mark.parametrize("arch,xent_chunks",
                         [(a, 1) for a in ARCHS] + [("llama3.2-3b", 4)])
def test_train_loss_and_grads_match_the_reference(arch, xent_chunks):
    jcfg, cfg, jmodel, _o, _s, jparams, pipe = _reference(
        arch, xent_chunks=xent_chunks)
    batch = pipe.get_batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.train_loss, has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    model = build_model(cfg, xent_chunks=xent_chunks)
    params = params_from_jax(_np(jparams), device="cpu")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, met = model.train_loss(params, batch)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = flatten(params_from_jax(_np(jgrads), device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in flatten(params)]
    for (path, w), g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL,
                                   err_msg=f"{arch} grad {path}")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_cross_families_train_loss_and_grads_match_the_reference(arch):
    """The vlm and audio families' ``train_loss`` and every gradient leaf on
    a pipeline batch with its context, against ``jax.value_and_grad`` of
    the reference model's ``train_loss`` (``impl="chunked"``,
    ``remat="block"``); the vlm's gates are seeded non-zero first (at 0 a
    cross layer's weights get no gradient)."""
    from test_torch_cross import seeded_gates

    from repro.models import build_model as jax_build
    jcfg, cfg = _configs(arch)
    jmodel = jax_build(jcfg, impl="chunked", remat="block")
    jparams = _np(jmodel.init(jax.random.PRNGKey(0)))
    if cfg.family == "vlm":
        jparams = seeded_gates(jparams, np.random.default_rng(27))
    batch = JaxTokens(jcfg, batch=B, seq=S, seed=0).get_batch(0)
    assert batch["context"].shape == (B, cfg.cross.n_context_tokens,
                                      cfg.d_model)
    (jloss, _jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.train_loss, has_aux=True))(
            jax.tree.map(jnp.asarray, jparams),
            jax.tree.map(jnp.asarray, batch))
    model = build_model(cfg)
    params = params_from_jax(jparams, device="cpu")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, met = model.train_loss(
        params, {"tokens": batch["tokens"],
                 "context": torch.from_numpy(batch["context"])})
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["xent"].detach()), float(jloss),
                               rtol=1e-5)
    want = flatten(params_from_jax(_np(jgrads), device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in flatten(params)]
    moved = 0
    for (path, w), g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL,
                                   err_msg=f"{arch} grad {path}")
        moved += bool(g.abs().max() > 0)
    assert moved == len(grads)


def _stacked_state(jtree, port_tree, port_params, shared_cols=False):
    """(path, reference leaf, port leaf) for a dense smoke model's state
    tree: the reference's stacked superblock leaf at the port layer's row;
    with ``shared_cols`` (Adafactor's ``vc``), a per-layer vector's column
    factor is the stack's one shared row."""
    out = []
    for top in ("embed", "final_norm"):
        for (path, p), (_, w) in zip(flatten(port_tree[top]),
                                     flatten(jtree[top])):
            out.append((f"{top}/{path}", np.asarray(w), p))
    sup = jtree["stack"].super[0]
    for i, (layer, player) in enumerate(zip(port_tree["layers"],
                                            port_params["layers"])):
        for (path, p), (_, par) in zip(flatten(layer), flatten(player)):
            w = sup
            for key in path.split("/"):
                w = w[key]
            w = np.asarray(w)
            if not (shared_cols and par.dim() == 1):
                w = w[i]
            out.append((f"layers/{i}/{path}", w, p))
    return out


@pytest.mark.parametrize("optimizer,steps", [("adamw", 2), ("adafactor", 1)])
def test_optimizer_steps_match_the_reference(optimizer, steps):
    jcfg, cfg, _m, jopt, jstep, jparams, pipe = _reference(
        "llama3.2-3b", optimizer=optimizer)
    jstate = jopt.init(jparams)
    jstep = jax.jit(jstep)
    _model, opt, train_step = make_train_step(
        cfg, TrainConfig(lr=1e-3, optimizer=optimizer), "cpu")
    params = params_from_jax(_np(jparams), device="cpu")
    state = opt.init(params)
    for step in range(steps):
        batch = pipe.get_batch(step)
        jparams, jstate, jmet = jstep(jparams, jstate,
                                      jax.tree.map(jnp.asarray, batch))
        params, state, met = train_step(params, state, batch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert int(state.count) == int(jstate.count) == steps
    fields = ["mu", "nu"] if optimizer == "adamw" else ["mu", "vr", "vc"]
    assert isinstance(state, AdamState if optimizer == "adamw"
                      else FactoredState)
    pairs = _stacked_state(_np(jparams), params, params)
    for f in fields:
        pairs += _stacked_state(_np(getattr(jstate, f)), getattr(state, f),
                                params, shared_cols=f == "vc")
    for path, w, p in pairs:
        assert tuple(p.shape) == w.shape, path
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-4,
                                   rtol=0, err_msg=path)


def _smoke_setup(microbatch=0, seed_batch=0):
    cfg = get_smoke_config("llama3.2-3b").replace(dtype="float32")
    model, opt, train_step = make_train_step(
        cfg, TrainConfig(lr=1e-3, microbatch=microbatch), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, opt, train_step, params, opt.init(params), \
        SyntheticTokens(cfg, B, S, seed=seed_batch)


def test_microbatch_accumulation_matches_full_batch():
    _cfg, _opt, step1, p1, s1, pipe = _smoke_setup()
    _cfg, _opt, step2, p2, s2, _pipe = _smoke_setup(microbatch=2)
    batch = pipe.get_batch(0)
    p1, s1, m1 = step1(p1, s1, batch)
    p2, s2, m2 = step2(p2, s2, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        assert float((a - b).abs().max()) < 5e-5


def test_loss_decreases_over_steps_on_a_repeated_batch():
    _cfg, _opt, train_step, params, state, pipe = _smoke_setup()
    losses = []
    for _ in range(8):
        params, state, met = train_step(params, state, pipe.get_batch(0))
        losses.append(float(met["loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_pipelines_are_bitwise_the_reference(tmp_path):
    jcfg, cfg = _configs("llama3.2-3b")
    for seed in (0, 7):
        ours, theirs = SyntheticTokens(cfg, 3, 33, seed), \
            JaxTokens(jcfg, 3, 33, seed)
        for step in range(3):
            a, b = ours.get_batch(step), theirs.get_batch(step)
            assert a.keys() == b.keys() == {"tokens"}
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 10 ** 6, 5000).astype(
        "<i4").tofile(path)
    ours, theirs = FileTokens(cfg, str(path), 4, 50, seed=3), \
        JaxFileTokens(jcfg, str(path), 4, 50, seed=3)
    for step in range(3):
        np.testing.assert_array_equal(ours.get_batch(step)["tokens"],
                                      theirs.get_batch(step)["tokens"])
    pipe = make_pipeline(cfg, LM_SHAPES[0], seed=1)
    assert (pipe.batch, pipe.seq) == (256, 4096)
    placed = place_batch(ours.get_batch(0), "cpu")
    assert placed["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_context_synthesizer_is_bitwise_the_reference(arch, dtype):
    """The vlm and audio families' batches carry the reference's context,
    bit for bit, in the model dtype (a CPU tensor: numpy has no bfloat16);
    ``place_batch`` takes it."""
    from repro.configs import get_smoke_config as jax_smoke
    jcfg = jax_smoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    for seed in (0, 5):
        ours, theirs = SyntheticTokens(cfg, 3, 9, seed), \
            JaxTokens(jcfg, 3, 9, seed)
        for step in range(2):
            a, b = ours.get_batch(step), theirs.get_batch(step)
            assert a.keys() == b.keys() == {"tokens", "context"}
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            ctx = a["context"]
            assert ctx.dtype == cfg.dtype_ and ctx.device.type == "cpu"
            assert tuple(ctx.shape) == b["context"].shape == (
                3, cfg.cross.n_context_tokens, cfg.d_model)
            bits = np.uint16 if dtype == "bfloat16" else np.uint32
            got = ctx.view(torch.int16 if dtype == "bfloat16"
                           else torch.int32).numpy().view(bits)
            np.testing.assert_array_equal(got, b["context"].view(bits))
    placed = place_batch(ours.get_batch(0), "cpu")
    assert placed["context"].dtype == cfg.dtype_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trips_bitwise(tmp_path, dtype):
    cfg = get_smoke_config("llama3.2-3b").replace(dtype=dtype)
    model, opt, train_step = make_train_step(cfg, TrainConfig(), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    state = opt.init(params)
    params, state, _m = train_step(params, state,
                                   SyntheticTokens(cfg, 2, 8).get_batch(0))
    tree = {"params": params, "opt": state}
    snap = tree_map(lambda t: t.detach().clone(), tree)
    ck = CheckpointManager(str(tmp_path), keep_last=2)
    ck.save(1, tree)                     # async: the leaves are copied now
    with torch.no_grad():
        for t in leaves(tree):
            t.add_(1)                    # the trainer updates in place
    ck.save(2, snap, blocking=True)
    ck.save(3, snap)
    ck.wait()
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    like = tree_map(torch.zeros_like, snap)
    for step in (2, 3):
        got = ck.restore(step, like)
        assert isinstance(got["opt"], AdamState)
        for (path, a), b in zip(flatten(snap), leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b), path
    assert any(t.dtype == torch.bfloat16 for t in leaves(snap)) == \
        (dtype == "bfloat16")


def test_launcher_resumes_where_it_stopped(tmp_path, capsys):
    args = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--log-every", "1",
            "--dtype", "float32"]
    whole = launcher.main(args + ["--steps", "5"])
    first = launcher.main(args + ["--steps", "3", "--ckpt-dir",
                                  str(tmp_path)])
    second = launcher.main(args + ["--steps", "5", "--ckpt-dir",
                                   str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    assert out.count("[train] done") == 3
    assert (first["start"], second["start"]) == (0, 3)
    np.testing.assert_array_equal(first["losses"] + second["losses"],
                                  whole["losses"])
    for a, b in zip(leaves(second["params"]), leaves(whole["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-2b",
                                  "rwkv6-7b", "llama-3.2-vision-11b",
                                  "whisper-large-v3"])
def test_input_specs_match_the_reference(arch):
    from repro.models import build_model as jax_build
    jcfg, cfg = _configs(arch)
    jspecs = jax_build(jcfg).input_specs
    specs = build_model(cfg).input_specs
    for jshape, shape in zip(JAX_SHAPES, LM_SHAPES):
        assert dataclasses.asdict(jshape) == dataclasses.asdict(shape)
        want, got = jspecs(jshape), specs(shape)
        assert want.keys() == got.keys()
        for key in ("batch", "token", "pos"):
            if key not in want:
                continue
            if key == "batch":
                assert want[key].keys() == got[key].keys()
                if "context" in want[key]:
                    w, g = want[key]["context"], got[key]["context"]
                    assert g.device.type == "meta"
                    assert tuple(g.shape) == w.shape
                    assert g.dtype == cfg.dtype_ and str(w.dtype) == \
                        str(g.dtype)[6:]
                if "tokens" not in want[key]:
                    continue
            w = want[key]["tokens"] if key == "batch" else want[key]
            g = got[key]["tokens"] if key == "batch" else got[key]
            assert g.device.type == "meta"
            assert tuple(g.shape) == w.shape and g.dtype == torch.int32
        if "cache" in want:
            n_want = sum(int(np.prod(x.shape))
                         for x in jax.tree.leaves(want["cache"]))
            cache = leaves(got["cache"])
            assert all(t.device.type == "meta" for t in cache)
            assert sum(t.numel() for t in cache) == n_want
