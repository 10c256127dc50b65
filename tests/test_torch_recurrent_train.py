"""The recurrent families' training pieces against the JAX package's, on
the CPU: the plain backward versions ``ref.rglru_bwd`` and ``ref.wkv6_bwd``
against ``jax.vjp`` of the reference's ``kref.rglru``, ``kref.wkv6`` and
its training form ``wkv6_chunked``; ``ref.wkv6_bwd_chunked``, the WKV
backward kernels' chunk-parallel algebra, against ``ref.wkv6_bwd`` in
float64 and against the same vjps; ``torch.autograd.gradcheck`` of the
two autograd Functions, ``RGLRUScan`` and ``WKV6Train``, in float64; the
rwkv training route's WKV in bf16 against the reference's ``time_mix``
(``impl="xla"``), w reaching the Function in float32; the argument lists
the backward wrappers hand their C entry points; ``ref.rglru_bwd_tiled``,
the RG-LRU backward kernels' tile-parallel algebra, against
``ref.rglru_bwd`` in float64 and against ``jax.vjp``; the tile states the
RG-LRU wrappers hand the forward and backward kernels; and the
launcher's memory refusal on the card (the MoE family's published widths
are refused for the bytes a step must hold, its smoke configs pass; it
was a refusal of every MoE arch before the grouped matmul's backward).

Inputs are made with numpy from a seed.  Tolerances, stated per test:

- float32 gradients against ``jax.vjp``: ``RTOL_F32`` relative to each
  element plus ``ATOL_F32`` times the largest |element|.  Both sides run
  the same recurrences in float32 and round in other orders (XLA fuses
  and reorders; the port's WKV sums D-long products with ``einsum``).
  The RG-LRU's ``dlog_a`` holds ``a²·x / b`` with ``b = sqrt(1 - a²)``:
  at log_a = -1e-3, ``1 - exp(2·log_a)`` cancels and magnifies the two
  sides' one-ulp exponentials (XLA's float32 exp, the port's float64 exp
  rounded once) by ``1 / (1 - a²)`` ≈ 500, 3e-5 relative in ``b²``, half
  that in b: hence 1e-4 relative per element;
- bf16 (inputs and outputs in bf16, the arithmetic float32 on both
  sides): the gradients are rounded to bf16 once each, so one bf16 step
  (2^-8 relative) per element, and 2^-8 of the largest element besides;
- ``gradcheck``: float64, its default tolerances (atol 1e-5, rtol 1e-3
  against central differences with eps 1e-6);
- the chunked WKV backward and the tiled RG-LRU backward against the
  sequential ones, both float64: ``CHUNKED_F64_ATOL`` = 1e-10 absolute,
  for sums of O(100) float64 products of order 1 taken in another order
  (rounding ~1e-14; the RG-LRU's a²x/b term, up to ~20x its x at these
  inputs' log_a >= -1e-3, keeps it far under).
"""
import ctypes

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels import _nvcc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.kernels import wkv6 as WK  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import rwkv6 as PW  # noqa: E402
from repro_torch.models.convert import _map, _tensor  # noqa: E402

RTOL_F32, ATOL_F32 = 1e-4, 1e-6
BF16_STEP = 2.0 ** -8
CHUNKED_F64_ATOL = 1e-10


def _close(got, want, dtype, what):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    if dtype == "float32":
        tol = dict(rtol=RTOL_F32, atol=ATOL_F32 * scale)
    else:
        tol = dict(rtol=BF16_STEP, atol=BF16_STEP * scale)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _pt(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


# ------------------------------------------------------------------ RG-LRU
def _rglru_inputs(rng, B, S, D, lo=-8.0, hi=-1e-3):
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    la = rng.uniform(lo, hi, (B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    dh = rng.standard_normal((B, D)).astype(np.float32)
    return x, la, dy, dh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seeded", [True, False], ids=["dh_final", "no_dh"])
@pytest.mark.parametrize("S", [37, 130])
def test_rglru_bwd_matches_the_reference_vjp(dtype, seeded, S):
    """``ref.rglru_bwd`` against ``jax.vjp(kref.rglru)`` with log_a in [-8,
    -1e-3], S off the kernel's tiles of 64 and 128 steps, dh_final seeded
    or zero; tolerances in the module docstring."""
    x, la, dy, dh = _rglru_inputs(np.random.default_rng(S), 2, S, 24)
    jdt = _jdt(dtype)
    jx, jla, jdy = (jnp.asarray(t).astype(jdt) for t in (x, la, dy))
    (_y, _h), vjp = jax.vjp(jref.rglru, jx, jla)
    jdh = jnp.asarray(dh) if seeded else jnp.zeros_like(_h)
    want = vjp((jdy, jdh))
    got = ref.rglru_bwd(_pt(x, dtype), _pt(la, dtype), _pt(dy, dtype),
                        torch.from_numpy(dh) if seeded else None)
    for name, g, w in zip(("dx", "dlog_a"), got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, np.asarray(w.astype(jnp.float32)), dtype, name)


def test_rglru_bwd_at_log_a_zero_takes_the_clamps_flat_side():
    """Where log_a = 0 (a = 1, the gate's clamp at 0) the reference's
    gradient is not finite (sqrt′(0)); the port returns dx = 0 and dlog_a
    = g·h_{t-1}, the gate's term taken as 0, everywhere finite, and its
    other steps as the reference's (float64 recurrence, 1e-12)."""
    rng = np.random.default_rng(3)
    x, la, dy, _dh = _rglru_inputs(rng, 1, 12, 5, -0.5, -0.01)
    la[:, 4:7] = 0.0
    (_y, _h), vjp = jax.vjp(jref.rglru, jnp.asarray(x), jnp.asarray(la))
    jdx, jdla = vjp((jnp.asarray(dy), jnp.zeros_like(_h)))
    assert not np.all(np.isfinite(np.asarray(jdla)))
    xt, lat, dyt = (torch.from_numpy(t).double() for t in (x, la, dy))
    dx, dla = ref.rglru_bwd(xt, lat, dyt)
    assert torch.isfinite(dx).all() and torch.isfinite(dla).all()
    # the float64 recurrence written out: h, then g backward
    a = np.exp(la.astype(np.float64))
    b = np.sqrt(np.maximum(1 - a * a, 0))
    h = np.zeros((1, 5))
    hp = []
    for t in range(12):
        hp.append(h)
        h = a[:, t] * h + b[:, t] * x[:, t]
    g = np.zeros((12, 1, 5))
    e = np.zeros((1, 5))
    for t in reversed(range(12)):
        g[t] = dy[:, t] + e
        e = a[:, t] * g[t]
    for t in range(12):
        q = np.where(b[:, t] > 0, a[:, t] ** 2 * x[:, t] / np.where(
            b[:, t] > 0, b[:, t], 1), 0)
        np.testing.assert_allclose(dx[:, t].numpy(), b[:, t] * g[t],
                                   atol=1e-12)
        np.testing.assert_allclose(dla[:, t].numpy(),
                                   g[t] * (a[:, t] * hp[t] - q[None][0]),
                                   atol=1e-12)
    assert not dx[:, 4:7].any()
    np.testing.assert_allclose(dla[:, 4:7].numpy(), np.stack(
        [g[t] * hp[t] for t in range(4, 7)], 1), atol=1e-12)
    live = np.ones(12, bool)
    live[4:7] = False
    np.testing.assert_allclose(dx[:, live].numpy(), np.asarray(jdx)[:, live],
                               rtol=1e-5, atol=1e-6)


def _tiled_cases():
    """(tile, sub, S) for the tiled RG-LRU backward: the kernels' bf16 tile
    of 128 in runs of 16, and tiles of 1, 7 and 16; S = 0, 1, one short of
    the tile, the tile, one past it, and three tiles and 5 steps."""
    return [(t, sub, S) for t, sub in ((1, 1), (7, 7), (16, 4), (128, 16))
            for S in sorted({0, 1, t - 1, t, t + 1, 3 * t + 5})]


@pytest.mark.parametrize("kind", ["mild", "log_a = 0 runs", "strong"])
@pytest.mark.parametrize("tile,sub,S", _tiled_cases(),
                         ids=[f"tile{t}-S{S}" for t, _s, S in _tiled_cases()])
def test_rglru_bwd_tiled_matches_the_sequential_backward(tile, sub, S, kind):
    """``ref.rglru_bwd_tiled`` (the forward's tile states, each tile's
    aggregate, their fold last first from dh_final, then every tile's runs)
    against ``ref.rglru_bwd`` in float64, dh_final seeded and None: S off
    the tile, S = tile ± 1, S = 1 and 0, log_a in [-8, -1e-3], with runs
    of log_a = 0 (a = 1, gate 0: a fifth of it and steps 2 to 9), or strong
    decays (log_a in [-30, -10]).  Within ``CHUNKED_F64_ATOL``."""
    lo, hi = (-30.0, -10.0) if kind == "strong" else (-8.0, -1e-3)
    x, la, dy, dh = _rglru_inputs(np.random.default_rng(1000 * tile + S), 2,
                                  S, 8, lo, hi)
    if kind == "log_a = 0 runs":
        la[np.random.default_rng(S).random(la.shape) < 0.2] = 0.0
        la[:, 2:10] = 0.0
    xt, lat, dyt, dht = (torch.from_numpy(t).double()
                         for t in (x, la, dy, dh))
    for d in (dht, None):
        want = ref.rglru_bwd(xt, lat, dyt, d)
        got = ref.rglru_bwd_tiled(xt, lat, dyt, d, tile, sub)
        for name, g, w in zip(("dx", "dlog_a"), got, want):
            assert g.dtype == torch.float64 and g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=CHUNKED_F64_ATOL, err_msg=name)


@pytest.mark.parametrize("tile,sub", [(64, 8), (128, 16)],
                         ids=["float32-kernel", "bf16-kernel"])
@pytest.mark.parametrize("seeded", [True, False], ids=["dh_final", "no_dh"])
@pytest.mark.parametrize("S", [37, 130])
def test_rglru_bwd_tiled_matches_the_reference_vjp(tile, sub, seeded, S):
    """``ref.rglru_bwd_tiled`` in float32, at the float32 and the bf16
    kernels' tiles and runs, against ``jax.vjp(kref.rglru)``: log_a in
    [-8, -1e-3], S off both tiles, dh_final seeded or zero; float32
    tolerance of the module docstring."""
    x, la, dy, dh = _rglru_inputs(np.random.default_rng(S + tile), 2, S, 24)
    (_y, _h), vjp = jax.vjp(jref.rglru, jnp.asarray(x), jnp.asarray(la))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(dh) if seeded else jnp.zeros_like(_h)))
    got = ref.rglru_bwd_tiled(torch.from_numpy(x), torch.from_numpy(la),
                              torch.from_numpy(dy),
                              torch.from_numpy(dh) if seeded else None,
                              tile, sub)
    for name, g, w in zip(("dx", "dlog_a"), got, want):
        assert g.dtype == torch.float32
        _close(g, np.asarray(w), "float32", f"tile {tile} {name}")


# -------------------------------------------------------------------- WKV6
def _wkv_inputs(rng, B, H, S, D, decay="mild"):
    r, k, v, dy = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    delta = 0.5 * rng.standard_normal((B, H, S, D))
    if decay == "strong":          # w ~ e^-7.4, from ~0.2 down to 0
        w = np.exp(-np.exp(2.0 + delta))
    else:
        w = np.exp(-np.exp(-4.0 + delta))
    if decay == "zeros":           # a fifth of w exactly 0, a step all 0
        w = np.where(rng.random(w.shape) < 0.2, 0.0, w)
        w[:, :, 9] = 0.0
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    ds = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, dy, ds


WKV_CASES = [(2, 3, 37, 16, "mild", True), (2, 2, 70, 64, "mild", False),
             (1, 2, 45, 64, "strong", True), (2, 2, 40, 32, "zeros", True),
             (1, 3, 23, 48, "mild", True)]
WKV_IDS = ["D16-S37-ds", "D64-S70", "strong-D64", "w0-D32-ds", "D48-S23"]


@pytest.mark.parametrize("form", ["wkv6", "wkv6_chunked"])
@pytest.mark.parametrize("B,H,S,D,decay,seeded", WKV_CASES, ids=WKV_IDS)
def test_wkv6_bwd_matches_the_reference_vjp(form, B, H, S, D, decay,
                                            seeded):
    """``ref.wkv6_bwd`` against ``jax.vjp`` of ``kref.wkv6`` and of the
    reference's training form ``wkv6_chunked`` (chunks of 16, so S is off
    the chunk and the last one padded; float32 w and u): D 16 to 64, mild
    and strong decays, w exactly 0, ds_final seeded or zero; float32
    tolerance of the module docstring."""
    r, k, v, w, u, dy, ds = _wkv_inputs(np.random.default_rng(S * D), B, H,
                                        S, D, decay)
    if form == "wkv6":
        fn = jref.wkv6
    else:
        def fn(r, k, v, w, u):
            return JW.wkv6_chunked(r, k, v, w, u, chunk=16)
    ins = tuple(jnp.asarray(t) for t in (r, k, v, w, u))
    (_y, s_fin), vjp = jax.vjp(fn, *ins)
    want = vjp((jnp.asarray(dy),
                jnp.asarray(ds) if seeded else jnp.zeros_like(s_fin)))
    got = ref.wkv6_bwd(*(torch.from_numpy(t) for t in (r, k, v, w, u, dy)),
                       torch.from_numpy(ds) if seeded else None)
    for name, g, wv in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == torch.float32 and g.shape == wv.shape
        _close(g, np.asarray(wv), "float32", f"{form} {name}")


def test_wkv6_bwd_checkpoint_interval_changes_nothing():
    """The plain backward's chunked recompute of the states gives the same
    gradients whatever the checkpoint interval, S off every interval
    (float64, 1e-12)."""
    r, k, v, w, u, dy, ds = _wkv_inputs(np.random.default_rng(5), 1, 2, 29,
                                        16)
    ins = [torch.from_numpy(t).double() for t in (r, k, v, w, u, dy, ds)]
    want = ref.wkv6_bwd(*ins, chunk=1000)
    for chunk in (1, 7, 16):
        for a, b in zip(ref.wkv6_bwd(*ins, chunk=chunk), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


def _chunked_cases():
    """(chunk, S) for the chunked backward: S = 1, one short of the chunk,
    the chunk, one past it, and three chunks and 5 steps (S = 0 where the
    chunk is 1)."""
    return [(c, S) for c in (1, 7, 16, 64)
            for S in sorted({1, c - 1, c, c + 1, 3 * c + 5})]


@pytest.mark.parametrize("decay", ["mild", "strong", "zeros"])
@pytest.mark.parametrize("chunk,S", _chunked_cases(),
                         ids=[f"chunk{c}-S{S}" for c, S in _chunked_cases()])
def test_wkv6_bwd_chunked_matches_the_sequential_backward(chunk, S, decay):
    """``ref.wkv6_bwd_chunked`` (chunk-boundary states and state gradients
    by one jump a chunk, then every chunk at once) against
    ``ref.wkv6_bwd`` in float64, ds_final seeded: S off the chunk, S = 1
    and S = 0, mild and strong decays, w exactly 0 (a fifth of it and a
    whole step, where S > 9; mild decays below); and with ds_final None.
    Within ``CHUNKED_F64_ATOL``."""
    r, k, v, w, u, dy, ds = (
        torch.from_numpy(t).double() for t in _wkv_inputs(
            np.random.default_rng(100 * chunk + S), 1, 2, S, 16,
            "mild" if decay == "zeros" and S <= 9 else decay))
    for d in (ds, None):
        want = ref.wkv6_bwd(r, k, v, w, u, dy, d)
        got = ref.wkv6_bwd_chunked(r, k, v, w, u, dy, d, chunk=chunk)
        for name, g, wv in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            assert g.dtype == torch.float64 and g.shape == wv.shape, name
            np.testing.assert_allclose(g.numpy(), wv.numpy(), rtol=0,
                                       atol=CHUNKED_F64_ATOL, err_msg=name)


def test_wkv6_bwd_chunked_keeps_a_chunk_of_w_zero_exact():
    """A whole chunk of w = 0 cuts the state and its gradient there: every
    decay product across it is an exact zero, never a quotient, so the
    chunked backward matches the sequential one in float64 (S = 200 over
    chunks of 64, the second chunk all w = 0)."""
    r, k, v, w, u, dy, ds = (
        torch.from_numpy(t).double() for t in _wkv_inputs(
            np.random.default_rng(7), 2, 2, 200, 32))
    w[:, :, 64:128] = 0.0
    want = ref.wkv6_bwd(r, k, v, w, u, dy, ds)
    got = ref.wkv6_bwd_chunked(r, k, v, w, u, dy, ds)
    for name, g, wv in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), wv.numpy(), rtol=0,
                                   atol=CHUNKED_F64_ATOL, err_msg=name)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("form", ["wkv6", "wkv6_chunked"])
@pytest.mark.parametrize("B,H,S,D,decay,seeded", WKV_CASES, ids=WKV_IDS)
def test_wkv6_bwd_chunked_matches_the_reference_vjp(chunk, form, B, H, S, D,
                                                    decay, seeded):
    """``ref.wkv6_bwd_chunked`` in float32 against ``jax.vjp`` of
    ``kref.wkv6`` and of the reference's training form ``wkv6_chunked``
    (its chunks of 16): chunks of 16 and of the kernels' 64 steps, S off
    both, D 16 to 64, strong decays, w exactly 0, ds_final seeded or zero;
    float32 tolerance of the module docstring."""
    r, k, v, w, u, dy, ds = _wkv_inputs(np.random.default_rng(S * D + 1), B,
                                        H, S, D, decay)
    if form == "wkv6":
        fn = jref.wkv6
    else:
        def fn(r, k, v, w, u):
            return JW.wkv6_chunked(r, k, v, w, u, chunk=16)
    (_y, s_fin), vjp = jax.vjp(fn, *(jnp.asarray(t)
                                     for t in (r, k, v, w, u)))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(ds) if seeded else jnp.zeros_like(s_fin)))
    got = ref.wkv6_bwd_chunked(
        *(torch.from_numpy(t) for t in (r, k, v, w, u, dy)),
        torch.from_numpy(ds) if seeded else None, chunk=chunk)
    for name, g, wv in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == torch.float32 and g.shape == wv.shape
        _close(g, np.asarray(wv), "float32", f"{form} chunk {chunk} {name}")


def test_wkv6_bwd_variant_routes_rows_off_16_bytes_to_4_byte_copies():
    """The WKV backward's inputs take 16-byte copies when every (b, h, t)
    stride is a multiple of 4 elements and every base on 16 bytes, else
    4-byte ones."""
    model = (4096 * 64 * 64, 64, 64 * 64)       # (B, S, H, D) as (B, H, S, D)
    ptrs = (0, 256, 512, 1024, 2048)
    assert WK._bwd_variant(model * 5, ptrs) == "vector"
    assert WK._bwd_variant(model * 4 + (4096 * 64 * 64, 64, 4098),
                           ptrs) == "scalar"
    assert WK._bwd_variant(model * 5, (0, 256, 516, 1024, 2048)) == "scalar"
    assert WK._bwd_variant((45 * 3 * 48, 48, 3 * 48) * 5, ptrs) == "vector"


# ------------------------------------------------------ the autograd functions
def test_rglru_scan_function_gradcheck():
    """``RGLRUScan`` (plain forward and ``rglru_scan_bwd`` on the CPU) in
    float64 against central differences, through y and h_final."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3))).requires_grad_()
    la = torch.from_numpy(rng.uniform(-3, -0.05, (2, 9, 3))).requires_grad_()
    assert torch.autograd.gradcheck(RS.RGLRUScan.apply, (x, la))


def test_wkv6_train_function_gradcheck():
    """``WKV6Train`` (plain forward and ``wkv6_bwd`` on the CPU) in float64
    against central differences, through y and s_final, decays in (0,
    1)."""
    rng = np.random.default_rng(12)
    B, H, S, D = 1, 2, 6, 4
    r, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D)))
               .requires_grad_() for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.2, 0.99, (B, H, S, D))) \
        .requires_grad_()
    u = torch.from_numpy(0.3 * rng.standard_normal((H, D))).requires_grad_()
    assert torch.autograd.gradcheck(WK.WKV6Train.apply, (r, k, v, w, u))


def test_the_functions_launch_their_forward_and_backward_wrappers(
        monkeypatch):
    """Each Function's forward goes through its kernel's wrapper and its
    backward through the backward wrapper (the plain versions on the CPU);
    dy that autograd leaves unmaterialised (only h_final or s_final used)
    arrives as zeros."""
    calls = []
    for mod, names in ((RS, ("rglru_scan", "rglru_scan_bwd")),
                       (WK, ("wkv6", "wkv6_bwd"))):
        for name in names:
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _name=name, **kw):
                calls.append(_name)
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((1, 5, 3)).astype(np.float32)) \
        .requires_grad_()
    la = torch.full((1, 5, 3), -0.2, requires_grad=True)
    _y, h = RS.RGLRUScan.apply(x, la)
    gx, gla = torch.autograd.grad(h.sum(), (x, la))
    wx, wla = ref.rglru_bwd(x.detach(), la.detach(), torch.zeros(1, 5, 3),
                            torch.ones(1, 3))
    assert torch.equal(gx, wx) and torch.equal(gla, wla)
    ins = [torch.from_numpy(rng.standard_normal((1, 2, 4, 16))
                            .astype(np.float32)).requires_grad_()
           for _ in range(3)]
    w = torch.full((1, 2, 4, 16), 0.9, requires_grad=True)
    u = torch.zeros((2, 16), requires_grad=True)
    y, _s = WK.WKV6Train.apply(*ins, w, u)
    torch.autograd.grad(y.sum(), (*ins, w, u))
    assert calls == ["rglru_scan", "rglru_scan_bwd", "wkv6", "wkv6_bwd"]


# ------------------------------------------------ the rwkv training route
def test_rwkv_training_wkv_follows_the_reference_training_form(monkeypatch):
    """In bf16, the port's training-form ``time_mix`` hands ``WKV6Train``
    r, k and v upcast from bf16 and w and u in float32 (never rounded to
    bf16), and its WKV output, cast to bf16, matches the reference's
    ``wkv6_chunked`` on the same inputs within one bf16 step of each
    element (the two sum float32 products in other orders before the one
    rounding); the whole ``time_mix`` matches the reference's
    ``time_mix(impl="xla")`` within 2e-2 of its largest output (bf16
    projections rounded in other orders on the two sides).  The serving
    form's rounding of w to bf16 moves the WKV output by more than that
    one step, which is what the training route must not carry."""
    jcfg = jax_smoke("rwkv6-7b").replace(dtype="bfloat16")
    cfg = get_smoke_config("rwkv6-7b").replace(dtype="bfloat16")
    rng = np.random.default_rng(21)
    B, S, d = 2, 64, cfg.d_model
    jp = jax.tree.map(np.asarray, JW.init_time_mix(jax.random.PRNGKey(0),
                                                   jcfg))
    params = _map(lambda a: _tensor(a, "cpu"), jp)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    seen = {}
    apply = WK.WKV6Train.apply

    def spy(*args):
        seen["in"] = args
        seen["out"] = apply(*args)
        return seen["out"]
    monkeypatch.setattr(WK.WKV6Train, "apply", spy)
    out, _s, _last = PW.time_mix(params, _pt(x, "bfloat16"), cfg, train=True)
    r, k, v, w, u = seen["in"]
    assert all(t.dtype == torch.float32 for t in (r, k, v, w, u))
    assert torch.equal(r, r.to(torch.bfloat16).float())
    assert not torch.equal(w, w.to(torch.bfloat16).float())
    assert torch.equal(u, params["u"])
    y_ref, _sf = JW.wkv6_chunked(
        *(jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (r, k, v)),
        jnp.asarray(w.numpy()), jnp.asarray(u.numpy()))
    y_ref = np.asarray(y_ref.astype(jnp.float32))
    y = seen["out"][0].to(torch.bfloat16)
    _close(y, y_ref, "bfloat16", "training-form WKV")
    y_serve, _sf = WK.wkv6(*(t.to(torch.bfloat16) for t in (r, k, v, w, u)))
    served = np.abs(y_serve.float().numpy() - y_ref)
    assert (served > BF16_STEP * (np.abs(y_ref) + np.abs(y_ref).max())).any()
    jout, _js, _jl = JW.time_mix(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(x).astype(jnp.bfloat16), jcfg,
                                 impl="xla")
    jout = np.asarray(jout.astype(jnp.float32))
    assert out.dtype == torch.bfloat16 and out.shape == jout.shape
    np.testing.assert_allclose(out.float().detach().numpy(), jout,
                               atol=2e-2 * np.abs(jout).max(), rtol=0)


# ------------------------------------------------------------- the wrappers
@pytest.mark.parametrize("name", ["rglru_scan_bwd", "wkv6_bwd"])
def test_backward_wrappers_match_their_c_signatures(name, monkeypatch):
    """On the card each backward wrapper hands its C entry point exactly
    the arguments its ctypes signature declares, pointers as ints (or None
    for a missing dh_final / ds_final) and sizes as ints, and counts one
    launch and its route; the RG-LRU's list carries the forward's tile
    states (``tile_states``: one float32 state a 128-step bf16 tile and
    channel) and B, S, D; the WKV's carries B, H, S, D and its copy
    width (1 for 16-byte copies, 0 for a base off 16 bytes) before the
    strides.  Rehearsed on the CPU with ``on_card`` forced true and the
    library call recorded, since no kernel runs here."""
    got = []
    lib = RS._LIB if name == "rglru_scan_bwd" else WK._BWD_LIB
    monkeypatch.setattr(_nvcc, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_nvcc, "stream", lambda t: 7)
    monkeypatch.setattr(lib, "call", lambda fn, *a: got.append((fn, a)))
    if name == "rglru_scan_bwd":
        x = torch.zeros((2, 130, 64), dtype=torch.bfloat16)
        carries = RS.tile_states(x)
        assert carries.shape == (2, 2, 64) and carries.dtype == torch.float32
        fn = RS.rglru_scan_bwd
        before = dict(fn.routes)
        for dh in (None, torch.zeros((2, 64))):
            fn(x, x, x, dh, carries)
        assert fn.routes["vector"] + fn.routes["scalar"] == \
            sum(before.values()) + 2
        assert [a[6] for _fn, a in got] == [carries.data_ptr()] * 2
        assert [a[10:13] for _fn, a in got] == [(2, 130, 64)] * 2
    else:
        t = torch.zeros((2, 70, 3, 16)).transpose(1, 2)
        off = torch.zeros(2 * 70 * 3 * 16 + 1)[1:].view(2, 70, 3, 16) \
            .transpose(1, 2)
        fn = WK.wkv6_bwd
        before = dict(fn.routes)
        for ds in (None, torch.zeros((2, 3, 16, 16))):
            fn(t, t, t, t, torch.zeros((3, 16)), t, ds)
        fn(off, t, t, t, torch.zeros((3, 16)), t, torch.zeros((2, 3, 16, 16)))
        assert fn.routes == {"vector": before["vector"] + 2,
                             "scalar": before["scalar"] + 1}
        assert [a[14:19] for _fn, a in got] == [(2, 3, 70, 16, 1)] * 2 \
            + [(2, 3, 70, 16, 0)]
    sig = lib.signatures[name]
    for i, (fn_name, args) in enumerate(got):
        assert fn_name == name and len(args) == len(sig)
        for a, ty in zip(args, sig):
            if ty is ctypes.c_void_p:
                assert a is None or isinstance(a, int)
            else:
                assert isinstance(a, int)
        assert (args[5 if name == "rglru_scan_bwd" else 6] is None) == (i == 0)


def test_rglru_wrappers_hand_the_kernels_the_tile_states(monkeypatch):
    """On the card ``RGLRUScan``'s forward hands the forward kernel a
    tile-state buffer (float32, one state a 64-step float32 tile and
    channel) and its backward hands the backward kernel that same buffer;
    the bare ``rglru_scan`` (serving) hands it None; and the backward
    without tile states raises, naming ``RGLRUScan``.  Rehearsed on the
    CPU with ``on_card`` forced true and the library calls recorded."""
    got = []
    monkeypatch.setattr(_nvcc, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_nvcc, "stream", lambda t: 7)
    monkeypatch.setattr(RS._LIB, "call", lambda fn, *a: got.append((fn, a)))
    x = torch.zeros((2, 130, 24), requires_grad=True)
    la = torch.full((2, 130, 24), -0.5, requires_grad=True)
    y, _h = RS.RGLRUScan.apply(x, la)
    torch.autograd.grad(y.sum(), (x, la))
    (fwd, fa), (bwd, ba) = got
    assert (fwd, bwd) == ("rglru_scan_fwd", "rglru_scan_bwd")
    assert len(fa) == len(RS._LIB.signatures[fwd]) \
        and len(ba) == len(RS._LIB.signatures[bwd])
    assert isinstance(fa[6], int) and fa[6] == ba[6]
    assert fa[7:10] == (2, 130, 24) == ba[10:13]
    got.clear()
    with torch.no_grad():
        RS.rglru_scan(x, la)
    assert [(fn, a[6]) for fn, a in got] == [("rglru_scan_fwd", None)]
    got.clear()
    with pytest.raises(ValueError, match="RGLRUScan"):
        RS.rglru_scan_bwd(x.detach(), la.detach(), x.detach())
    with pytest.raises(ValueError, match="carries"):
        RS.rglru_scan_bwd(x.detach(), la.detach(), x.detach(), None,
                          torch.zeros((2, 2, 24)))
    assert got == []


def test_the_bare_kernels_keep_refusing_grad_on_the_card(monkeypatch):
    """The bare ``rglru_scan`` and ``wkv6`` still refuse, on the card, an
    input that requires grad (their outputs would carry no gradient); the
    Functions are the training entry points.  Rehearsed with the device
    check forced to the card's branch."""
    real = _nvcc.on_card

    def on_card(what, *t):
        _nvcc.refuse_grad(what, *t)
        return real(what, *t)
    monkeypatch.setattr(_nvcc, "on_card", on_card)
    x = torch.zeros((1, 4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="rglru_scan: no backward"):
        RS.rglru_scan(x, x.detach())
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="wkv6: no backward"):
        WK.wkv6(q, q, q, q, torch.zeros((2, 16)))
    y, _h = RS.RGLRUScan.apply(x, -torch.ones((1, 4, 8)))
    assert y.requires_grad


def test_the_launcher_refuses_an_moe_arch_on_the_card(monkeypatch):
    """``launch.train.run`` refuses the MoE family's published widths on an
    80 GB card for memory, before it builds anything: the message names
    the reckoned bytes (parameters, gradients, optimizer state, one
    float32 copy of the largest leaf) and ROADMAP item 12, at full depth
    and at the least depth that holds an MoE layer (llama4: 2 layers;
    deepseek-v3: 4, its first 3 dense).  The smoke MoE configs pass the
    guard, as does deepseek-v3 cut to its 3 dense layers."""
    monkeypatch.setattr(launcher, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(launcher, "device_memory", lambda dev: 80 * 10 ** 9)
    cuda = torch.device("cuda")
    for arch, n_moe in (("llama4-maverick-400b-a17b", 2),
                        ("deepseek-v3-671b", 4)):
        cfg = get_config(arch)
        for n in (cfg.n_layers, n_moe):
            with pytest.raises(RuntimeError, match=r"needs at least [\d.]+ "
                               r"GB on the card \(params [\d.]+ GB.*"
                               r"ROADMAP item 12"):
                launcher.run(cfg.replace(n_layers=n), TrainConfig(), None,
                             steps=1)
        launcher.check_fits(get_smoke_config(arch), TrainConfig(), cuda)
    launcher.check_fits(get_config("deepseek-v3-671b").replace(n_layers=3),
                        TrainConfig(), cuda)
    need = launcher.memory_reckoning(get_config("llama4-maverick-400b-a17b")
                                     .replace(n_layers=2), TrainConfig())
    assert need["largest_leaf_float32"] == 4 * 128 * 5120 * 8192
    assert need["grads"] == need["params"]
