"""The port's MoE family against the JAX package's, on the CPU: the grouped
matmul's plain version (which CPU tensors take) against the Pallas kernel
run in interpret mode through ``repro.kernels.ops`` and against
``repro.kernels.ref``; the MoE pieces (``capacity``, ``route``,
``dispatch`` with capacity drops, ``combine``, ``expert_ffn``,
``moe_block_local``) against ``repro/models/moe.py``; the layer plan; the
smoke llama4-maverick model (prefill, ``logits``, three decode steps and
every cache leaf); ``params_from_jax`` on the MoE tree; and seeded init.

Weights come from the reference's initialisers, carried across as numpy;
inputs are made with numpy from a seed.  Tolerances:

* gmm float32 ``atol=rtol=1e-5``: both sides sum the same float32 products
  in other orders (Din ≤ 512 terms of size ~1);
* gmm bfloat16 ``atol=rtol=2e-2``, as ``tests/test_kernels.py::close``:
  each side rounds its float32 sum to bfloat16 once, so the two may differ
  by one bfloat16 step;
* integer routing results (experts, slots) and copies (dispatched rows)
  exactly;
* float32 block and model outputs ``atol=1e-4, rtol=1e-5``, as
  ``tests/test_torch_model.py``: XLA and PyTorch order the products and
  reductions differently through a few layers.

The CUDA kernel runs only on the card; chip_smoke.py holds it against this
plain version there."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.transformer import layer_plan  # noqa: E402
from repro_torch.configs import (MoEConfig, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402

ARCH = "llama4-maverick-400b-a17b"
TOL = dict(atol=1e-4, rtol=1e-5)
GMM_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, ref, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL,
                               err_msg=what)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ----------------------------------------------------------------- the kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E, T, Din, Dout, BT, order", [
    (4, 512, 256, 256, 128, "sorted"),       # tests/test_kernels.py's shapes
    (8, 1024, 512, 256, 128, "sorted"),
    (2, 256, 128, 512, 64, "sorted"),
    (6, 96, 128, 256, 8, "unsorted"),        # the decode block_t
    (5, 168, 256, 128, 24, "unsorted"),      # the prefill block_t
])
def test_gmm_matches_pallas_and_ref(E, T, Din, Dout, BT, order, dtype):
    rng = np.random.default_rng(8 + T + BT)
    jdt = getattr(jnp, dtype)
    x = jnp.asarray(rng.standard_normal((T, Din)).astype(np.float32), jdt)
    w = jnp.asarray(rng.standard_normal((E, Din, Dout)).astype(np.float32)
                    * 0.2, jdt)
    be = rng.integers(0, E, size=(T // BT,))
    be = np.sort(be) if order == "sorted" else be
    assert order == "sorted" or np.any(np.diff(be) < 0)
    be = jnp.asarray(be, jnp.int32)
    tdt = getattr(torch, dtype)
    got = gmm(torch.tensor(_f32(x)).to(tdt), torch.tensor(_f32(w)).to(tdt),
              torch.tensor(np.asarray(be)), BT)
    assert got.dtype == tdt and got.shape == (T, Dout)
    for want in (jops.gmm(x, w, be, block_t=BT, block_n=128, block_k=128),
                 jref.gmm(x, w, be, BT)):
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **GMM_TOL[dtype])


def _counts_and_zeroed(rng, x, BT):
    """Row counts per block with 0, a partial count and block_t among them
    (the rest drawn), and x with its rows past the counts zeroed, as the
    MoE block's dispatch leaves its slots."""
    nb = x.shape[0] // BT
    counts = rng.integers(0, BT + 1, size=nb)
    counts[:3] = [0, max(1, BT // 3), BT][:nb]
    past = np.arange(BT)[None, :] >= counts[:, None]
    x = np.where(past.reshape(-1)[:, None], np.zeros_like(x), x)
    return counts, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E, T, Din, Dout, BT", [
    (4, 512, 256, 256, 128),
    (8, 1024, 512, 256, 128),
    (2, 256, 128, 512, 64),
    (6, 96, 128, 256, 8),                    # the decode block_t
    (5, 168, 256, 128, 24),                  # the prefill block_t
])
def test_gmm_with_row_counts_matches_pallas_and_ref(E, T, Din, Dout, BT,
                                                    dtype):
    """Blocks with no counted row, partial counts and full ones, on x whose
    rows past the counts are zeros: the reference (which has no counts)
    then computes the same function."""
    rng = np.random.default_rng(18 + T + BT)
    x = rng.standard_normal((T, Din)).astype(np.float32)
    counts, x = _counts_and_zeroed(rng, x, BT)
    jdt = getattr(jnp, dtype)
    x = jnp.asarray(x, jdt)
    w = jnp.asarray(rng.standard_normal((E, Din, Dout)).astype(np.float32)
                    * 0.2, jdt)
    be = jnp.asarray(rng.integers(0, E, size=(T // BT,)), jnp.int32)
    tdt = getattr(torch, dtype)
    got = gmm(torch.tensor(_f32(x)).to(tdt), torch.tensor(_f32(w)).to(tdt),
              torch.tensor(np.asarray(be)), BT,
              torch.tensor(counts, dtype=torch.int32))
    assert got.dtype == tdt and got.shape == (T, Dout)
    for want in (jops.gmm(x, w, be, block_t=BT, block_n=128, block_k=128),
                 jref.gmm(x, w, be, BT)):
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **GMM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_zeroes_the_rows_past_the_counts(dtype):
    """Rows past a count come out zero even where x holds values there;
    the counted rows are the products of their own rows."""
    rng = np.random.default_rng(12)
    E, BT, nb, Din, Dout = 3, 8, 5, 24, 16
    x = torch.from_numpy(rng.standard_normal((nb * BT, Din)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, Din, Dout)).astype(
        np.float32)).to(dtype)
    be = torch.tensor([2, 0, 1, 2, 0])
    counts = torch.tensor([0, 3, BT, 1, -2], dtype=torch.int64)
    got = gmm(x, w, be, BT, counts)
    full = gmm(x, w, be, BT)
    for i, n in enumerate([0, 3, BT, 1, 0]):
        rows = slice(i * BT, (i + 1) * BT)
        assert not got[rows][n:].any(), f"block {i}: rows past {n}"
        torch.testing.assert_close(got[rows][:n], full[rows][:n], atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(
            got[rows][:n].float(),
            (x[rows][:n].float() @ w[int(be[i])].float()).to(dtype).float(),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad, match", [
    ("shape", "block_rows"), ("float", "block_rows"), ("device", "CPU")])
def test_gmm_refuses_row_counts_it_cannot_take(bad, match):
    x = torch.zeros((16, 8))
    w = torch.zeros((3, 8, 5))
    be = torch.zeros(2, dtype=torch.int32)
    rows = {"shape": torch.zeros(3, dtype=torch.int32),
            "float": torch.zeros(2),
            "device": torch.zeros(2, dtype=torch.int32, device="meta")}[bad]
    with pytest.raises(ValueError, match=match):
        gmm(x, w, be, 8, rows)


@pytest.mark.parametrize("dtype, Din, Dout, w_off, want", [
    (torch.bfloat16, 5120, 8192, 0, "mma"),       # llama4's gate and up
    (torch.bfloat16, 8192, 5120, 0, "mma"),       # and its wo
    (torch.float32, 5120, 8192, 0, "simt"),       # float32 stays exact
    (torch.bfloat16, 64, 77, 0, "simt"),          # Dout % 8 != 0
    (torch.bfloat16, 100, 64, 0, "simt"),         # Din % 8 != 0
    (torch.bfloat16, 64, 512, 2, "simt"),         # w one element in
])
def test_gmm_variant_routes_by_dtype_width_and_alignment(dtype, Din, Dout,
                                                         w_off, want):
    from repro_torch.kernels.moe_gmm import _variant
    assert _variant(dtype, Din, Dout, (4096, 8192 + w_off, 12288)) == want


@pytest.mark.parametrize("top_k, cf, S", [(1, 1.25, 10), (2, 1.25, 10),
                                          (1, 0.5, 40)])
def test_moe_block_local_passes_the_kept_row_counts(block, monkeypatch,
                                                    top_k, cf, S):
    """Every grouped matmul of the block gets each expert's kept
    assignments, min(#assigned, C), the drops past capacity excluded."""
    cfg, jcfg, _jp, p = block
    cfg, _jcfg = _with_moe(cfg, jcfg, top_k=top_k, capacity_factor=cf)
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    seen = []

    def spy(x_, w_, be_, bt_, rows_=None):
        seen.append(rows_)
        return gmm(x_, w_, be_, bt_, rows_)

    monkeypatch.setattr(PM, "gmm", spy)
    PM.moe_block_local(p, torch.from_numpy(x), cfg)
    _w, e, _l = PM.route(p, torch.from_numpy(x.reshape(2 * S, -1)), cfg.moe)
    E, C = cfg.moe.n_experts, PM.capacity(2 * S, cfg.moe)
    want = np.minimum(np.bincount(e.numpy().ravel(), minlength=E), C)
    assert len(seen) == 3
    for rows in seen:
        assert rows.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), want)
    if cf < 1:
        assert (np.bincount(e.numpy().ravel(), minlength=E) > C).any()


def test_gmm_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((16, 8))
    w = torch.zeros((3, 8, 5))
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not divide"):
        gmm(x, w, be, 5)
    with pytest.raises(ValueError, match="block_expert"):
        gmm(x, w, torch.zeros(3, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="block_expert"):
        gmm(x, w, torch.zeros(2), 8)
    with pytest.raises(ValueError):
        gmm(x, torch.zeros((3, 7, 5)), be, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm(x.half(), w.half(), be, 8)
    with pytest.raises(TypeError, match="one dtype"):
        gmm(x, w.bfloat16(), be, 8)
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        gmm(x, w.to("meta"), be, 8)


def test_gmm_takes_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 12)).astype(np.float32))
    be = torch.tensor([2, 0, 2], dtype=torch.int64)
    before = gmm.launches
    got = gmm(x, w, be, 8)
    assert gmm.launches == before, "CPU tensors launch no kernel"
    assert torch.equal(got, pref.gmm(x, w, be, 8))
    torch.testing.assert_close(got[8:16], x[8:16] @ w[0], atol=1e-5,
                               rtol=1e-5)


# -------------------------------------------------------------- the MoE block
@pytest.fixture(scope="module")
def block():
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jp = JM.init_moe(jax.random.PRNGKey(1), jcfg)
    return cfg, jcfg, jp, _torch(_np(jp))


def _with_moe(cfg, jcfg, **kw):
    """The same MoE change on the port's and the reference's config."""
    return (cfg.replace(moe=dataclasses.replace(cfg.moe, **kw)),
            jcfg.replace(moe=dataclasses.replace(jcfg.moe, **kw)))


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_capacity_matches_the_reference(arch):
    mo = jax_config(arch).moe
    pmo = MoEConfig(**dataclasses.asdict(mo))
    # T·k/E·1.25 not an integer for most of these; 2048 and 4 are the
    # llama4 serving path's prefill (C = 24) and decode (C = 8) token counts
    for T in (1, 4, 7, 20, 100, 2048, 2049, 3000, 12345):
        for cf in (1.25, 0.5, 1.0, 2.0):
            assert PM.capacity(T, dataclasses.replace(pmo,
                                                      capacity_factor=cf)) \
                == JM.capacity(T, dataclasses.replace(mo,
                                                      capacity_factor=cf))
    if arch == ARCH:
        assert (PM.capacity(2048, pmo), PM.capacity(4, pmo)) == (24, 8)


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_the_reference(block, top_k):
    cfg, jcfg, jp, p = block
    cfg, jcfg = _with_moe(cfg, jcfg, top_k=top_k)
    x = np.random.default_rng(3).standard_normal(
        (40, cfg.d_model)).astype(np.float32)
    w, e, logits = PM.route(p, torch.from_numpy(x), cfg.moe)
    jw, je, jl = JM.route(jp, jnp.asarray(x), jcfg.moe)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(w, jw)
    _close(logits, jl)


def test_dispatch_and_combine_drop_past_capacity():
    """Hand-built assignments over capacity, C = 4 slots per expert:
    expert 0 receives 13 of the 28 assignments and experts 1-3 five each,
    so 12 are dropped, each to the sentinel slot E·C, the same ones as in
    the reference."""
    E, C, T, k, d = 4, 4, 14, 2, 6
    rng = np.random.default_rng(6)
    experts = np.array([[0, 1], [0, 2], [0, 3], [1, 0], [0, 2], [0, 1],
                        [2, 3], [0, 3], [0, 1], [0, 2], [3, 0], [0, 1],
                        [0, 2], [0, 3]], np.int32)
    weights = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    xs, slot, kept = PM.dispatch(torch.from_numpy(x),
                                 torch.from_numpy(experts),
                                 torch.from_numpy(weights), E, C)
    jxs, jslot, jkept = JM.dispatch(jnp.asarray(x), jnp.asarray(experts),
                                    jnp.asarray(weights), E, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    dropped = slot.numpy() == E * C
    assert dropped.sum() == 12 and (kept.numpy()[dropped] == 0).all()
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    y = rng.standard_normal((E, C, 5)).astype(np.float32)
    _close(PM.combine(torch.from_numpy(y), slot, kept, T),
           JM.combine(jnp.asarray(y), jslot, jkept, T))


def test_expert_ffn_matches_the_reference(block):
    cfg, _jcfg, jp, p = block
    x = np.random.default_rng(7).standard_normal(
        (cfg.moe.n_experts, 8, cfg.d_model)).astype(np.float32)
    _close(PM.expert_ffn(p["experts"], torch.from_numpy(x), cfg.act),
           JM.expert_ffn(jp["experts"], jnp.asarray(x), cfg.act))


@pytest.mark.parametrize("top_k, cf, S", [(1, 1.25, 10), (2, 1.25, 10),
                                          (1, 0.5, 40)])
def test_moe_block_local_matches_the_reference(block, top_k, cf, S):
    """The last case has 80 tokens on 4 experts and 16 slots each, so some
    assignments must be dropped."""
    cfg, jcfg, jp, p = block
    cfg, jcfg = _with_moe(cfg, jcfg, top_k=top_k, capacity_factor=cf)
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    out, aux = PM.moe_block_local(p, torch.from_numpy(x), cfg)
    jout, jaux = JM.moe_block_local(jp, jnp.asarray(x), jcfg)
    _close(out, jout)
    _close(aux, jaux)
    if cf < 1:
        _w, e, _l = PM.route(p, torch.from_numpy(x.reshape(2 * S, -1)),
                             cfg.moe)
        counts = np.bincount(e.numpy().ravel(), minlength=4)
        assert counts.max() > PM.capacity(2 * S, cfg.moe)


# ------------------------------------------------------------ plan and model
@pytest.mark.parametrize("which", ["smoke", "full", "first_k_dense"])
def test_layer_kinds_follow_the_reference_plan(which):
    if which == "first_k_dense":    # deepseek's plan shape, GQA mixer
        jcfg = jax_smoke("deepseek-v3-671b").replace(mla=None)
        cfg = get_smoke_config(ARCH).replace(
            n_layers=jcfg.n_layers,
            moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    else:
        jcfg = (jax_smoke if which == "smoke" else jax_config)(ARCH)
        cfg = (get_smoke_config if which == "smoke" else get_config)(ARCH)
    prefix, block, n, suffix = layer_plan(jcfg)
    assert layer_kinds(cfg) == prefix + block * n + suffix
    assert [k == "attn_moe" for k in layer_kinds(cfg)] == \
        [cfg.is_moe_layer(i) for i in range(cfg.n_layers)]
    build_model(cfg)
    assert layer_kinds(cfg.replace(moe=None)) == ["attn"] * cfg.n_layers
    build_model(cfg.replace(moe=None))


@pytest.fixture(scope="module")
def smoke_model():
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    return cfg, jm, jparams, build_model(cfg), \
        params_from_jax(_np(jparams), device="cpu")


def test_params_from_jax_places_every_moe_leaf(smoke_model):
    cfg, _jm, jparams, _m, params = smoke_model
    sup = _np(jparams)["stack"].super
    kinds = layer_kinds(cfg)
    assert len(params["layers"]) == cfg.n_layers == 2
    for i, (kind, layer) in enumerate(zip(kinds, params["layers"])):
        ref = jax.tree.map(lambda a: a[i // 2], sup[i % 2])
        flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert len(flat_ref) == len(jax.tree.leaves(_np_tree(layer)))
        for path, leaf in flat_ref:
            got = layer
            for key in path:
                got = got[key.key]
            assert got.dtype == torch.from_numpy(np.array(leaf)).dtype
            np.testing.assert_array_equal(got.numpy(), leaf,
                                          err_msg=f"layer {i} {path}")
    moe = params["layers"][1]["ffn"]
    mo = cfg.moe
    assert kinds == ["attn_dense", "attn_moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["experts"]["wi_gate"].shape == (mo.n_experts, cfg.d_model,
                                               mo.d_ff_expert)
    assert moe["experts"]["wo"].shape == (mo.n_experts, mo.d_ff_expert,
                                          cfg.d_model)
    assert moe["shared"]["wi_up"].shape == (cfg.d_model, mo.d_ff_shared)
    assert params["layers"][0]["ffn"]["wi_gate"].shape == (cfg.d_model,
                                                           mo.d_ff_dense)


def _np_tree(layer):
    return jax.tree.map(lambda t: t.numpy(), layer)


def test_smoke_model_matches_the_reference(smoke_model):
    cfg, jm, jparams, model, params = smoke_model
    rng = np.random.default_rng(4)
    B, S, s_max = 2, 10, 16
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    jlg, jcache, jpos = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, s_max)
    lg, caches, pos = model.prefill(params, {"tokens": tokens}, s_max)
    _close(lg, jlg, "prefill")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _close(model.logits(params, {"tokens": tokens}),
           jm.logits(jparams, {"tokens": jnp.asarray(tokens)}), "logits")
    jdec = jax.jit(jm.decode_step)
    for step in range(3):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        jlg, jcache = jdec(jparams, jnp.asarray(tok), jcache, jpos)
        lg, caches = model.decode_step(params, torch.from_numpy(tok), caches,
                                       pos)
        _close(lg, jlg, f"decode step {step}")
        jpos, pos = jpos + 1, pos + 1
    sup = _np(jcache).super
    assert len(caches) == cfg.n_layers
    for i, c in enumerate(caches):
        _close(c.k, sup[i % 2].k[i // 2], f"layer {i} k")
        _close(c.v, sup[i % 2].v[i // 2], f"layer {i} v")


def test_init_draws_from_the_generator():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(1))
    c = model.init(torch.Generator().manual_seed(2))
    mo = cfg.moe
    experts = a["layers"][1]["ffn"]["experts"]
    assert experts["wi_up"].shape == (mo.n_experts, cfg.d_model,
                                      mo.d_ff_expert)
    assert experts["wi_up"].dtype == torch.bfloat16
    assert a["layers"][1]["ffn"]["router"].dtype == torch.float32
    assert "head" in a["embed"]
    for name in ("wi_gate", "wi_up", "wo"):
        assert torch.equal(experts[name],
                           b["layers"][1]["ffn"]["experts"][name])
        assert not torch.equal(experts[name],
                               c["layers"][1]["ffn"]["experts"][name])
        # one normal draw per expert: experts are not copies of each other
        assert not torch.equal(experts[name][0], experts[name][1])
    std = experts["wi_gate"].float().std().item()
    assert abs(std * np.sqrt(cfg.d_model) - 1) < 0.05
    assert torch.equal(a["layers"][0]["ffn"]["wo"], b["layers"][0]["ffn"]["wo"])
