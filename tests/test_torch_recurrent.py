"""The port's recurrent families against the JAX package's, in float32 on
the CPU: the RG-LRU and WKV6 kernels' plain versions (which CPU tensors
take) against the Pallas kernels run in interpret mode through
``repro.kernels.ops`` and against ``repro.kernels.ref``, and the chunked
algebras of the RG-LRU kernel (``ref.rglru_chunked``, and the tile states
it keeps for the backward) and of the bf16 WKV6 kernel
(``ref.wkv6_chunked``) against them; the
recurrent blocks (``rglru_block``, ``rglru_block_decode``, ``time_mix``,
``channel_mix``) against ``repro.models``; and the smoke recurrentgemma
(as it is, and with five layers so that the plan has a suffix) and rwkv6
models: prefill, ``logits``, four decode steps and every layer's cache leaf.

Weights come from the reference's initialisers (``PRNGKey(0)``), carried
across as numpy; inputs are made with numpy from a seed.  Tolerance
``atol=1e-4, rtol=1e-5`` throughout: both sides run the recurrences in
float32, one step at a time, but XLA and PyTorch round the surrounding
products and reductions in other orders (the WKV's D-long dot products, the
projections, the norms), through a few layers.  The CUDA kernels run only
on the card; chip_smoke.py holds them against these plain versions there."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru as PR  # noqa: E402
from repro_torch.models import rwkv6 as PW  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, ref, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL,
                               err_msg=what)


# --------------------------------------------------------------- the kernels
@pytest.mark.parametrize("B, S, D", [(2, 37, 100), (1, 64, 32), (3, 1, 8)])
def test_rglru_matches_pallas_and_ref(B, S, D):
    rng = np.random.default_rng(S + D)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    log_a = -rng.uniform(1e-3, 2.0, (B, S, D)).astype(np.float32)
    y, h = rglru_scan(torch.from_numpy(x), torch.from_numpy(log_a))
    assert y.dtype == torch.float32 and h.shape == (B, D)
    for ry, rh in (jops.rglru(jnp.asarray(x), jnp.asarray(log_a)),
                   jref.rglru(jnp.asarray(x), jnp.asarray(log_a))):
        _close(y, ry)
        _close(h, rh)


def _coarse_exp(exp):
    """``exp`` with float32 results rounded to 14 significant bits (a
    relative error up to 2^-15, about a math library's fast mode); other
    dtypes go through ``exp`` as they are."""
    def coarse(t):
        if t.dtype != torch.float32:
            return exp(t)
        m, e = np.frexp(np.exp(t.double().numpy()))
        return torch.from_numpy(
            np.ldexp(np.round(m * 2.0 ** 14) / 2.0 ** 14, e).astype(
                np.float32))
    return coarse


@pytest.mark.parametrize("fn", ["rglru", "rglru_chunked"])
@pytest.mark.parametrize("B, S, D", [(2, 37, 100), (1, 64, 32)])
def test_rglru_plain_needs_no_accurate_float32_exp(fn, B, S, D,
                                                   monkeypatch):
    """``1 - exp(2·log_a)`` cancels near log_a = 0 and magnifies the
    exponential's error up to 500× on these inputs, and the decay carries
    it on through the recurrence: with a coarse float32 ``torch.exp`` a
    plain version that took its exponentials in float32 leaves ``TOL``.
    The port's take them in float64 on the CPU, so they hold ``TOL``
    against the reference whatever float32 exponential the process has."""
    rng = np.random.default_rng(S + D)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    log_a = -rng.uniform(1e-3, 2.0, (B, S, D)).astype(np.float32)
    monkeypatch.setattr(torch, "exp", _coarse_exp(torch.exp))
    y, h = getattr(pref, fn)(torch.from_numpy(x), torch.from_numpy(log_a))
    ry, rh = jref.rglru(jnp.asarray(x), jnp.asarray(log_a))
    _close(y, ry)
    _close(h, rh)


def _log_a(rng, kind, shape):
    if kind == "strong decays":                  # a from e^-10 down to e^-30
        return -rng.uniform(10.0, 30.0, shape).astype(np.float32)
    log_a = -rng.uniform(1e-3, 2.0, shape)
    if kind == "log_a = 0 runs":                 # a = 1, gate 0: h carries
        log_a[rng.uniform(size=shape) < 0.2] = 0.0
        log_a[:, 3:40] = 0.0
    return log_a.astype(np.float32)


@pytest.mark.parametrize("kind, B, S, D, tile, sub", [
    ("S off the tile", 2, 37, 32, 128, 16),
    ("S off the tile", 1, 300, 64, 64, 8),
    ("S = 1", 3, 1, 8, 128, 16),
    ("log_a = 0 runs", 2, 200, 32, 64, 8),
    ("strong decays", 2, 150, 32, 128, 16),
    ("D = 100", 2, 37, 100, 32, 8),
    ("tile and sub off S", 2, 50, 16, 24, 6)])
def test_rglru_chunked_matches_the_sequential_form(kind, B, S, D, tile,
                                                   sub):
    """The CUDA kernel's algebra, :func:`ref.rglru_chunked` (tiles of
    ``tile`` steps, runs of ``sub`` scanned from h = 0 and folded through
    their end pairs; the bf16 kernel's 128 and 16 and the float32 one's 64
    and 8 first), against the port's
    sequential plain version and the reference's Pallas kernel (interpret
    mode) and oracle, in float32 within ``TOL``.  Strong decays underflow
    the runs' products of a to 0; log_a = 0 must carry h exactly."""
    rng = np.random.default_rng(S * D + tile)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    log_a = _log_a(rng, kind, (B, S, D))
    y, h = pref.rglru_chunked(torch.from_numpy(x), torch.from_numpy(log_a),
                              tile, sub)
    assert y.shape == (B, S, D) and h.shape == (B, D)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    ry, rh = pref.rglru(torch.from_numpy(x), torch.from_numpy(log_a))
    _close(y, ry)
    _close(h, rh)
    for jy, jh in (jops.rglru(jnp.asarray(x), jnp.asarray(log_a)),
                   jref.rglru(jnp.asarray(x), jnp.asarray(log_a))):
        _close(y, jy)
        _close(h, jh)


@pytest.mark.parametrize("tile, sub, S", [
    (128, 16, 300), (128, 16, 128), (64, 8, 129), (64, 8, 63), (7, 7, 30),
    (1, 1, 5), (128, 16, 1)])
def test_rglru_forward_keeps_each_tiles_state(tile, sub, S):
    """The state the forward keeps before each tile for the backward
    (:func:`ref.rglru_chunked` with ``keep_states``, the kernel's algebra)
    is h at the step before the tile's first: 0 before tile 0, else the
    sequential form's y there; in float64 against the port's sequential
    version within 1e-12 (both are sums of the same products in another
    order), and in float32 against the reference's oracle within
    ``TOL``.  The last tile's state carries on to h_final."""
    rng = np.random.default_rng(S + tile)
    x = rng.standard_normal((2, S, 16))
    log_a = _log_a(rng, "log_a = 0 runs" if S > 40 else "S off the tile",
                   (2, S, 16)).astype(np.float64)
    n = -(-S // tile)
    for dt, (seq_y, _sh), tol in (
            (np.float64, pref.rglru(torch.from_numpy(x),
                                    torch.from_numpy(log_a)),
             dict(atol=1e-12, rtol=0)),
            (np.float32, jref.rglru(jnp.asarray(x, jnp.float32),
                                    jnp.asarray(log_a, jnp.float32)), TOL)):
        y, h, states = pref.rglru_chunked(torch.from_numpy(x.astype(dt)),
                                          torch.from_numpy(log_a.astype(dt)),
                                          tile, sub, keep_states=True)
        assert states.shape == (2, n, 16) and states.dtype == y.dtype
        seq_y = np.asarray(seq_y, dtype=np.float64)
        want = np.stack([np.zeros((2, 16))] + [seq_y[:, i * tile - 1]
                                               for i in range(1, n)], 1)
        np.testing.assert_allclose(states.numpy(), want, **tol)
        np.testing.assert_allclose(h.numpy(), seq_y[:, -1], **tol)


def test_rglru_variant_routes_rows_off_16_bytes_to_scalar_copies():
    """Rows that start on 16 bytes take the kernel's 16-byte copies; a row
    of D elements that is no multiple of 16 bytes, or a base address off
    16 bytes, one-element copies.  CPU tensors count no route."""
    from repro_torch.kernels.rglru_scan import _variant
    aligned = (0, 4096, 8192)
    assert _variant(torch.bfloat16, 2560, aligned) == "vector"
    assert _variant(torch.float32, 2560, aligned) == "vector"
    assert _variant(torch.float32, 100, aligned) == "vector"
    assert _variant(torch.bfloat16, 100, aligned) == "scalar"
    assert _variant(torch.bfloat16, 2560, (2, 4096, 8192)) == "scalar"
    assert _variant(torch.float32, 2560, (0, 4100, 8192)) == "scalar"
    before = dict(rglru_scan.routes)
    rglru_scan(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8)))
    assert rglru_scan.routes == before


@pytest.mark.parametrize("B, H, S, D", [(2, 3, 37, 16), (1, 2, 16, 64),
                                        (1, 1, 1, 8)])
def test_wkv6_matches_pallas_and_ref(B, H, S, D):
    rng = np.random.default_rng(S * H + D)
    r, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, H, S, D)).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    y, s = wkv6(*(torch.from_numpy(t) for t in (r, k, v, w, u)))
    assert y.shape == (B, H, S, D) and s.shape == (B, H, D, D)
    for ry, rs in (jops.wkv6(*map(jnp.asarray, (r, k, v, w, u))),
                   jref.wkv6(*map(jnp.asarray, (r, k, v, w, u)))):
        _close(y, ry)
        _close(s, rs)


def _decays(rng, kind, shape):
    z = rng.standard_normal(shape)
    if kind == "strong decays":                  # w ≈ e^-7.4, down to ~0.2
        return np.exp(-np.exp(2.0 + 0.5 * z)).astype(np.float32)
    w = np.exp(-np.exp(-4.0 + 0.5 * z))          # rwkv6-7b's range
    if kind == "w = 0":
        w[rng.uniform(size=shape) < 0.2] = 0.0
        w[:, :, 5] = 0.0                         # a step that erases S
    return w.astype(np.float32)


@pytest.mark.parametrize("kind, B, H, S, D", [
    ("strong decays", 2, 2, 40, 32), ("w = 0", 1, 2, 48, 64),
    ("S not a multiple of the chunk", 2, 3, 37, 64),
    ("D = 16", 2, 4, 45, 16)])
def test_wkv6_chunked_matches_the_sequential_form(kind, B, H, S, D):
    """The bf16 CUDA kernel's algebra, :func:`ref.wkv6_chunked` (chunks of
    16 steps, decay products referenced to the chunk's start and end),
    against the port's sequential plain version and the reference's Pallas
    kernel (interpret mode) and oracle, in float32 within ``TOL``.  Strong
    decays and exact zeros in w are where a factorisation through
    logarithms or quotients of decays would overflow or divide by 0."""
    rng = np.random.default_rng(S * D + H)
    r, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    w = _decays(rng, kind, (B, H, S, D))
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    y, s = pref.wkv6_chunked(*(torch.from_numpy(t) for t in (r, k, v, w, u)))
    assert y.shape == (B, H, S, D) and s.shape == (B, H, D, D)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ry, rs = pref.wkv6(*(torch.from_numpy(t) for t in (r, k, v, w, u)))
    _close(y, ry)
    _close(s, rs)
    for jy, js in (jops.wkv6(*map(jnp.asarray, (r, k, v, w, u))),
                   jref.wkv6(*map(jnp.asarray, (r, k, v, w, u)))):
        _close(y, jy)
        _close(s, js)


def test_wkv6_variant_routes_aligned_bf16_to_the_chunked_kernel():
    """bf16 rows that 16-byte copies take go to the tensor-core kernel;
    float32, and bf16 with a stride or base off 16 bytes, to the CUDA-core
    one."""
    from repro_torch.kernels.wkv6 import _variant
    model = (512 * 64 * 64, 64, 64 * 64)        # (B, S, H, D) as (B, H, S, D)
    assert _variant(torch.bfloat16, model * 4, (0, 256, 512, 1024)) \
        == "chunked"
    assert _variant(torch.float32, model * 4, (0, 256, 512, 1024)) == "simt"
    assert _variant(torch.bfloat16, model * 3 + (512 * 64 * 64, 64, 4100),
                    (0, 256, 512, 1024)) == "simt"
    assert _variant(torch.bfloat16, model * 4, (0, 256, 514, 1024)) == "simt"


def test_recurrent_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError):
        rglru_scan(x, x[:, :3])
    r = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError):
        wkv6(r, r, r, r, torch.zeros((3, 16)))
    before = (rglru_scan.launches, wkv6.launches)
    rglru_scan(x, x)
    wkv6(r, r, r, r, torch.zeros((2, 16)))
    assert (rglru_scan.launches, wkv6.launches) == before, \
        "CPU tensors take the plain version: no launch is counted"
    y, s = pref.wkv6(r, r, r, r, torch.zeros((2, 16)))
    assert not y.any() and not s.any()


# ---------------------------------------------------------------- the blocks
@pytest.fixture(scope="module")
def rg_block():
    cfg = get_smoke_config("recurrentgemma-2b").replace(dtype="float32")
    jcfg = jax_smoke("recurrentgemma-2b").replace(dtype="float32")
    jp = JR.init_rglru(jax.random.PRNGKey(1), jcfg)
    return cfg, jcfg, jp, _torch(_np(jp))


def test_rglru_block_and_decode_match_the_reference(rg_block):
    cfg, jcfg, jp, p = rg_block
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    out, st = PR.rglru_block(p, torch.from_numpy(x))
    for impl in ("xla", "pallas"):
        jout, jst = JR.rglru_block(jp, jnp.asarray(x), jcfg, impl=impl)
        _close(out, jout, impl)
        _close(st.h, jst.h, impl)
        _close(st.conv, jst.conv, impl)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out, st = PR.rglru_block_decode(p, torch.from_numpy(xt), st)
        jout, jst = JR.rglru_block_decode(jp, jnp.asarray(xt), jst, jcfg)
        _close(out, jout, f"decode {step}")
        _close(st.h, jst.h, f"decode {step}")
        _close(st.conv, jst.conv, f"decode {step}")


@pytest.fixture(scope="module")
def rwkv_block():
    cfg = get_smoke_config("rwkv6-7b").replace(dtype="float32")
    jcfg = jax_smoke("rwkv6-7b").replace(dtype="float32")
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    jt, jc = JW.init_time_mix(k1, jcfg), JW.init_channel_mix(k2, jcfg)
    return cfg, jcfg, jt, jc, _torch(_np(jt)), _torch(_np(jc))


def test_time_mix_and_channel_mix_match_the_reference(rwkv_block):
    cfg, jcfg, jt, jc, pt_, pc = rwkv_block
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    y, s, sh = PW.time_mix(pt_, torch.from_numpy(x), cfg)
    for impl in ("xla", "pallas"):
        jy, js, jsh = JW.time_mix(jt, jnp.asarray(x), jcfg, impl=impl)
        _close(y, jy, impl)
        _close(s, js, impl)
        _close(sh, jsh, impl)
    yc, shc = PW.channel_mix(pc, torch.from_numpy(x))
    jyc, jshc = JW.channel_mix(jc, jnp.asarray(x), jcfg)
    _close(yc, jyc)
    _close(shc, jshc)

    st = PW.RWKVState(s, sh, shc)
    jst = JW.RWKVState(js, jsh, jshc)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y, s, sh = PW.time_mix(pt_, torch.from_numpy(xt), cfg, state=st)
        jy, js, jsh = JW.time_mix(jt, jnp.asarray(xt), jcfg, state=jst)
        _close(y, jy, f"decode {step}")
        _close(s, js, f"decode {step}")
        yc, shc = PW.channel_mix(pc, torch.from_numpy(xt), state=st)
        jyc, jshc = JW.channel_mix(jc, jnp.asarray(xt), jcfg, state=jst)
        _close(yc, jyc, f"decode {step}")
        st = PW.RWKVState(s, sh, shc)
        jst = JW.RWKVState(js, jsh, jshc)


# ----------------------------------------------------------------- the models
def _reference_layers(cfg, jcache):
    """The reference's cache tree → one numpy tree per layer, in the port's
    layer order (superblock i's positions, then the suffix; rwkv6's
    stacked states unstacked)."""
    jc = _np(jcache)
    if cfg.family == "ssm":
        return [jax.tree.map(lambda a, i=i: a[i], jc)
                for i in range(cfg.n_layers)]
    n = cfg.n_layers // cfg.hybrid.pattern_period
    per_pos = [[jax.tree.map(lambda a, i=i: a[i], pos) for i in range(n)]
               for pos in jc.super]
    return [c for group in zip(*per_pos) for c in group] + list(jc.suffix)


def _check_caches(cfg, caches, jcache, what):
    ref = _reference_layers(cfg, jcache)
    assert len(caches) == len(ref) == cfg.n_layers
    for i, (kind, c, r) in enumerate(zip(layer_kinds(cfg) if
                                         cfg.family == "hybrid" else
                                         ["rwkv"] * cfg.n_layers,
                                         caches, ref)):
        assert type(c).__name__ == type(r).__name__, (i, kind)
        assert c._fields == r._fields
        for f in c._fields:
            a, b = getattr(c, f).numpy(), getattr(r, f)
            assert a.shape == b.shape and a.dtype == b.dtype, (i, f)
            _close(a, b, f"{what}: layer {i} ({kind}) {f}")


@pytest.mark.parametrize("S", [14, 20], ids=["pad", "roll"])
@pytest.mark.parametrize("arch, n_layers", [
    ("recurrentgemma-2b", None), ("recurrentgemma-2b", 5), ("rwkv6-7b", None)],
    ids=["recurrentgemma", "recurrentgemma-suffix", "rwkv6"])
def test_smoke_models_match_the_reference(arch, n_layers, S):
    """Prompts of 14 and 20 tokens against recurrentgemma's 16-token window:
    the local cache is padded (and decode wraps the ring at position 16) or
    rolled; rwkv6 carries no window."""
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = jax_smoke(arch).replace(dtype="float32", **kw)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch).replace(dtype="float32", **kw)
    model = build_model(cfg)
    params = params_from_jax(_np(jparams), device="cpu")
    rng = np.random.default_rng(S)
    B, s_max = 2, 24
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)

    jlg, jcache, jpos = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, s_max)
    lg, caches, pos = model.prefill(params, {"tokens": tokens}, s_max)
    _close(lg, jlg, "prefill logits")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _check_caches(cfg, caches, jcache, "prefill")
    _close(model.logits(params, {"tokens": tokens}),
           jm.logits(jparams, {"tokens": jnp.asarray(tokens)}), "logits")

    jdec = jax.jit(jm.decode_step)
    for step in range(4):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        jlg, jcache = jdec(jparams, jnp.asarray(tok), jcache, jpos)
        lg, caches = model.decode_step(params, torch.from_numpy(tok), caches,
                                       pos)
        _close(lg, jlg, f"decode step {step}")
        jpos, pos = jpos + 1, pos + 1
    _check_caches(cfg, caches, jcache, "after decode")


def test_init_draws_the_recurrent_families_from_the_generator():
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        a = model.init(torch.Generator().manual_seed(1))
        b = model.init(torch.Generator().manual_seed(1))
        assert len(a["layers"]) == cfg.n_layers
        assert torch.equal(a["embed"]["table"], b["embed"]["table"])
        assert ("head" in a["embed"]) == (not cfg.tie_embeddings)
        caches = model.init_cache(3, 40, device="cpu")
        assert len(caches) == cfg.n_layers
    rg = get_smoke_config("recurrentgemma-2b")
    caches = build_model(rg).init_cache(3, 40, device="cpu")
    assert [type(c).__name__ for c in caches] == ["RecState", "RecState",
                                                  "KVCache"]
    assert caches[2].k.shape == (3, 1, 16, 16)      # min(s_max, window)
    assert caches[0].h.dtype == torch.float32
    assert caches[0].conv.shape == (3, 3, 64)
