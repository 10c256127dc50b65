"""The port's training attention against the JAX package's, on the CPU:
``ref.mha_lse`` (the forward with each row's log-sum-exp) and
``ref.flash_attention_bwd`` (the FlashAttention-2 backward, the plain
version of ``csrc/flash_attention_bwd.cu``), and ``FlashAttention``
through ``torch.autograd.grad``, against ``flash_attention_xla`` (its
forward residuals and ``jax.vjp``) on the cases of
``tests/test_flash_xla.py`` — GQA 8/2, Sq 64 ≠ Sk 192 (the ``Sk − Sq``
offset), a window of 32, bidirectional — plus S and D off the 16-tile;
in bf16 also the widths of the ``"wgmma"`` route (D 256 under a window
with a group of 5, MLA's D 192 with v zero-padded from 128, D 200).

Inputs are made with numpy from a seed; the loss is ``sum(sin(o))`` and
the tolerance ``atol=rtol=2e-4``, as the reference's own test: both sides
sum float32 products in other orders (the reference over key blocks of
48, with padding).  Also here: the routing of the model's attention to
``FlashAttention`` when autograd needs it, and the decision of the kernel
wrappers' guard (``_nvcc.refuse_grad``), which the card reaches through
``on_card``.  The CUDA kernels run only on the card; chip_smoke.py holds
them against these plain versions there; here the wrappers' routing,
the wgmma route's C calls and its refusal to fall back are checked with
the launch stubbed."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import flash_xla  # noqa: E402
from repro_torch.kernels import _nvcc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention_bwd)
from repro_torch.models import attention as A  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=2e-4, rtol=2e-4)
CASES = [(1, 4, 4, 64, 64, 32, True, None),
         (2, 8, 2, 128, 128, 32, True, None),      # GQA 8/2
         (1, 2, 2, 64, 192, 32, True, None),       # offset Sk - Sq
         (1, 2, 2, 128, 128, 32, True, 32),        # sliding window
         (1, 2, 2, 96, 96, 32, False, None),       # bidirectional
         (1, 6, 2, 50, 50, 24, True, None)]        # S and D off the tile
IDS = ["mha", "gqa", "offset", "window", "bidirectional", "ragged"]


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32))


def _reference(q, k, v, causal, window):
    """flash_attention_xla's output, lse (B, Hq, Sq) and gradients of
    sum(sin(o))."""
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))

    def f(q, k, v):
        return flash_xla.flash_attention_xla(q, k, v, causal, window, None,
                                             None, 48)

    out, vjp = jax.vjp(f, jq, jk, jv)
    grads = vjp(jnp.cos(out))
    _o, (_q, _k, _v, _of, lse) = flash_xla._flash_fwd(
        jq, jk, jv, causal, window, None, None, 48)
    return (np.asarray(out), np.asarray(lse).reshape(q.shape[:3]),
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", CASES, ids=IDS)
def test_plain_forward_lse_and_backward_match_flash_xla(B, Hq, Hkv, Sq, Sk,
                                                        D, causal, window):
    q, k, v = _inputs(B, Hq, Hkv, Sq, Sk, D)
    jout, jlse, jgrads = _reference(q, k, v, causal, window)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out, lse = ref.mha_lse(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)
    dout = torch.cos(out)
    got = ref.flash_attention_bwd(tq, tk, tv, out, lse, dout, causal=causal,
                                  window=window)
    for g, jg, name in zip(got, jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), jg, **TOL,
                                   err_msg=f"grad d{name}")
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(flash_attention_bwd(tq, tk, tv, out, lse, dout,
                                        causal=causal, window=window), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", CASES, ids=IDS)
def test_flash_attention_function_matches_jax_vjp(B, Hq, Hkv, Sq, Sk, D,
                                                  causal, window):
    q, k, v = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=1)
    jout, _jlse, jgrads = _reference(q, k, v, causal, window)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = FlashAttention.apply(*ts, causal, window, None)
    assert "FlashAttention" in out.grad_fn.name()
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    grads = torch.autograd.grad(torch.sin(out).sum(), ts)
    for g, jg, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), jg, **TOL,
                                   err_msg=f"grad d{name}")


def test_model_attention_takes_flash_attention_only_for_grad():
    """The blocks' attention goes through FlashAttention when autograd
    needs its gradient (its backward is the hand-written kernel on the
    card), and through the serving call otherwise."""
    q, k, v = (torch.from_numpy(t) for t in _inputs(1, 4, 2, 24, 24, 16))
    assert A._flash(q, k, v, causal=True).grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = A._flash(qg, k, v, causal=True, window=8)
    assert "FlashAttention" in out.grad_fn.name()
    with torch.no_grad():
        assert A._flash(qg, k, v, causal=True).grad_fn is None
    torch.testing.assert_close(
        out, ref.mha(q, k, v, causal=True, window=8), rtol=0, atol=0)


def test_the_guard_refuses_only_what_autograd_would_differentiate():
    """``refuse_grad`` is what ``on_card`` asks before a kernel without a
    ported backward launches: it raises, naming the kernel, only when grad
    is enabled and an input requires grad."""
    x = torch.ones(3)
    w = torch.ones(3, requires_grad=True)
    _nvcc.refuse_grad("gmm", x, x)
    with pytest.raises(RuntimeError, match="gmm: no backward"):
        _nvcc.refuse_grad("gmm", x, w)
    with torch.no_grad():
        _nvcc.refuse_grad("gmm", x, w)
    # an autograd.Function's forward runs with grad disabled
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            _nvcc.refuse_grad("probe", t)
            seen.append(torch.is_grad_enabled())
            return t * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    Probe.apply(w)
    assert seen == [False]
    # on the CPU the plain versions run and stay differentiable
    assert _nvcc.on_card("gmm", x, w) is False


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic: P and dS rounded to bf16
# ---------------------------------------------------------------------------

#: Relative to the gradient's largest magnitude.  The tensor-core route
#: rounds P and dS to bf16 once before their products (relative error
#: 2⁻⁹ each), takes Dsum from the bf16 output where the reference takes
#: its float32 output, and both sides round the gradients to bf16 once.
BF16_TOL = 1e-2


#: The same cases, v's width beside each (D: not padded), then the widths
#: the ``"wgmma"`` route takes: D 256 with a group of 5 on 1 under a
#: window (recurrentgemma-2b's form), MLA's D 192 with v zero-padded from
#: 128, causal, and D 200, which the 256 instance takes zero-filled.
BF16_CASES = [c + (c[5],) for c in CASES] + [
    (1, 5, 1, 96, 96, 256, True, 48, 256),
    (1, 2, 2, 80, 80, 192, True, None, 128),
    (1, 4, 2, 40, 72, 200, True, None, 200)]
BF16_IDS = IDS + ["d256-gqa5-window", "mla-d192-v128", "d200-zero-filled"]


def _bf16_inputs(B, Hq, Hkv, Sq, Sk, D, seed, width=None):
    """q, k, v and dout drawn with numpy and rounded to bf16; with
    ``width`` < D, v's and dout's columns from ``width`` on are zeros (MLA's
    v zero-padded to q's width, whose padded output columns get no
    gradient)."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to(torch.bfloat16)
        for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                      (B, Hq, Sq, D)))
    if width is not None and width < D:
        v[..., width:] = 0
        dout[..., width:] = 0
    return [q, k, v, dout]


def _rel(got, exp):
    return float((got.float() - exp.float()).abs().max()) / float(
        exp.float().abs().max())


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,width",
                         BF16_CASES, ids=BF16_IDS)
def test_rounded_plain_backward_matches_jax_vjp_in_bf16(B, Hq, Hkv, Sq, Sk,
                                                        D, causal, window,
                                                        width):
    """``ref.flash_attention_bwd(..., round_p=torch.bfloat16)``, the plain
    version of the tensor-core kernels (routes ``"mma"`` and
    ``"wgmma"``), against ``jax.vjp`` of ``flash_attention_xla`` on the
    same bf16 q, k, v and cotangent."""
    q, k, v, dout = _bf16_inputs(B, Hq, Hkv, Sq, Sk, D, seed=2, width=width)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, dout))

    def f(q, k, v):
        return flash_xla.flash_attention_xla(q, k, v, causal, window, None,
                                             None, 48)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    jgrads = vjp(jdo)
    out, lse = ref.mha_lse(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    got = ref.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                  window=window, round_p=torch.bfloat16)
    for g, jg, name in zip(got, jgrads, "qkv"):
        assert g.dtype == torch.bfloat16
        exp = torch.from_numpy(np.array(jg.astype(jnp.float32)))
        assert _rel(g, exp) <= BF16_TOL, f"grad d{name}: {_rel(g, exp)}"
    if width < D:       # MLA: the padded v columns get no gradient
        assert not got[2][..., width:].any()


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,width",
                         BF16_CASES, ids=BF16_IDS)
def test_rounded_plain_backward_stays_near_the_unrounded_one(B, Hq, Hkv, Sq,
                                                             Sk, D, causal,
                                                             window, width):
    """Rounding P and dS moves each float32 gradient by far less than its
    bf16 tolerance, and does move it (the rounding is not skipped)."""
    q, k, v, dout = (t.float() for t in _bf16_inputs(B, Hq, Hkv, Sq, Sk, D,
                                                     seed=3, width=width))
    out, lse = ref.mha_lse(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    plain = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    rounded = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw,
                                      round_p=torch.bfloat16)
    for a, b, name in zip(rounded, plain, "qkv"):
        assert a.dtype == torch.float32
        assert 0 < _rel(a, b) <= BF16_TOL / 2, f"grad d{name}: {_rel(a, b)}"


def test_bwd_variant_routes_aligned_bf16_to_mma_or_wgmma_by_head_dim():
    """``_bwd_variant``: bf16 with every stride a multiple of 8 elements and
    every base on 16 bytes takes ``"mma"`` at D 64 and 128 (and any D % 8 ==
    0 up to 128) and ``"wgmma"`` above it, at D 192, 200 and 256 (any D %
    8 == 0 up to 256); float32, D % 8 != 0, and a stride or a base off 16
    bytes take ``"simt"`` at every width.  A CPU call runs the plain version
    and counts no route."""
    from repro_torch.kernels.flash_attention import (MMA_BWD_MAX_HEAD_DIM,
                                                     _bwd_variant)
    bf, f32 = torch.bfloat16, torch.float32
    strides = [4096 * 24 * 128, 128, 24 * 128] * 5
    ptrs = [0x7f0000000000 + 4096 * i for i in range(5)]
    assert MMA_BWD_MAX_HEAD_DIM == 128
    for D in (64, 128, 24, 40, 8):
        assert _bwd_variant(bf, D, strides, ptrs) == "mma", D
    for D in (192, 200, 256, 136, 248):
        assert _bwd_variant(bf, D, strides, ptrs) == "wgmma", D
    for D in (128, 192, 256):
        assert _bwd_variant(f32, D, strides, ptrs) == "simt", D
    for D in (100, 196, 252):
        assert _bwd_variant(bf, D, strides, ptrs) == "simt", D
    odd = list(strides)
    odd[13] = 100 * 24 + 4          # dout's sequence stride
    off = list(ptrs)
    off[3] += 8                     # out's base 8 bytes off
    for D in (128, 192, 256):
        assert _bwd_variant(bf, D, odd, ptrs) == "simt", D
        assert _bwd_variant(bf, D, strides, off) == "simt", D
    # the wrapper on CPU tensors takes no kernel and counts no route
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    assert set(flash_attention_bwd.routes) == {"mma", "wgmma", "simt"}
    for D in (64, 256):
        routes = dict(flash_attention_bwd.routes)
        q, k, v, dout = _bf16_inputs(1, 2, 1, 16, 16, D, seed=4)
        out, lse = ref.mha_lse(q, k, v)
        flash_attention_bwd(q, k, v, out, lse, dout)
        assert flash_attention_bwd.routes == routes


def _stub_wgmma_card(monkeypatch, fa, call):
    """Let CPU tensors through the card's path of ``flash_attention_bwd``
    with the ``"wgmma"`` library's ``call`` replaced by ``call``."""
    monkeypatch.setattr(fa._nvcc, "on_card", lambda *a: True)
    monkeypatch.setattr(fa._nvcc, "stream", lambda t: 77)
    monkeypatch.setattr(fa._BWD_SM90_LIB, "call", call)


def _bhsd_bf16(B, S, H, D):
    """A zero (B, H, S, D) bf16 view of (B, S, H, D) memory."""
    return torch.zeros((B, S, H, D), dtype=torch.bfloat16).transpose(1, 2)


def test_wgmma_route_passes_the_c_entry_its_arguments(monkeypatch):
    """The wrapper's calls of the ``"wgmma"`` library as the C side declares
    them (``csrc/flash_attention_bwd_sm90.cu``): first
    ``flash_bwd_wgmma_scratch_floats`` (B, Hq, Sq and where to write the
    scratch's size), then ``flash_attention_bwd_wgmma`` with q, k, v, out,
    dout, lse, a float32 scratch of that size, dq, dk, dv, the six sizes,
    q's, k's, v's, out's and dout's strides of (B, H, S, D) views of (B, S,
    H, D) memory, scale, masks, offset and the stream, the arguments of
    ``flash_attention_bwd_mma``; the route is counted once.  The launch is
    stubbed: this checks the plumbing the card runs."""
    import re
    from pathlib import Path
    from repro_torch.kernels import flash_attention as fa
    src = (Path(fa.__file__).parent / "csrc" /
           "flash_attention_bwd_sm90.cu").read_text()
    for fn in ("flash_attention_bwd_wgmma", "flash_bwd_wgmma_scratch_floats"):
        decl = re.search(rf"int {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
        assert len(decl.split(",")) == len(fa._BWD_SM90_LIB.signatures[fn])
    assert fa._BWD_SM90_LIB.signatures["flash_attention_bwd_wgmma"] == \
        fa._BWD_LIB.signatures["flash_attention_bwd_mma"]
    calls = []

    def call(fn, *args):
        calls.append((fn, args))
        if fn == "flash_bwd_wgmma_scratch_floats":
            args[-1]._obj.value = 12_345
    _stub_wgmma_card(monkeypatch, fa, call)
    made = {}
    empty = torch.empty

    def recorded(*shape, **kw):
        t = empty(*shape, **kw)
        made[t.data_ptr()] = (t.numel(), t.dtype)
        return t
    monkeypatch.setattr(fa.torch, "empty", recorded)
    B, Hq, Hkv, S, D = 2, 10, 1, 200, 256
    q, k, v = _bhsd_bf16(B, S, Hq, D), _bhsd_bf16(B, S, Hkv, D), \
        _bhsd_bf16(B, S, Hkv, D)
    out, dout = _bhsd_bf16(B, S, Hq, D), _bhsd_bf16(B, S, Hq, D)
    lse = torch.zeros((B, Hq, S))
    routes = dict(fa.flash_attention_bwd.routes)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                        window=64)
    assert fa.flash_attention_bwd.routes["wgmma"] == routes["wgmma"] + 1
    (size_fn, size_args), (fn, args) = calls
    assert size_fn == "flash_bwd_wgmma_scratch_floats"
    assert size_args[:3] == (B, Hq, S)
    assert fn == "flash_attention_bwd_wgmma"
    assert len(args) == len(fa._BWD_SM90_LIB.signatures[fn])
    assert args[10:16] == (B, Hq, Hkv, S, S, D)
    assert args[16:31] == (S * Hq * D, D, Hq * D, S * Hkv * D, D, Hkv * D,
                           S * Hkv * D, D, Hkv * D) + (S * Hq * D, D,
                                                       Hq * D) * 2
    assert args[31:] == (pytest.approx(D ** -0.5), 1, 64, 0, 77)
    assert args[0] == q.data_ptr() and args[4] == dout.data_ptr()
    assert made[args[6]] == (12_345, torch.float32)
    assert (dq.shape, dk.shape, dv.shape) == ((B, Hq, S, D), (B, Hkv, S, D),
                                              (B, Hkv, S, D))
    assert all(t.is_contiguous() for t in (dq, dk, dv))


def test_wgmma_route_raises_when_its_launch_is_refused(monkeypatch):
    """No fallback: when the C entry refuses the launch (the library's
    ``call`` raises, as it does on a non-zero ``cudaError_t``), the
    ``"wgmma"`` route raises and neither the plain version nor another
    route runs in its place; nothing is counted."""
    from repro_torch.kernels import flash_attention as fa

    def call(fn, *args):
        if fn == "flash_bwd_wgmma_scratch_floats":
            args[-1]._obj.value = 64
            return
        raise RuntimeError("flash_attention_bwd_sm90 kernel launch failed: "
                           "too many resources requested for launch (7)")
    _stub_wgmma_card(monkeypatch, fa, call)
    monkeypatch.setattr(fa._BWD_LIB, "call", lambda *a: pytest.fail(
        "the refused launch fell back to flash_attention_bwd.cu"))
    monkeypatch.setattr(fa.ref, "flash_attention_bwd", lambda *a, **k: (
        pytest.fail("the refused launch fell back to the plain version")))
    B, Hq, Hkv, S, D = 1, 4, 2, 64, 192
    q, k, v = _bhsd_bf16(B, S, Hq, D), _bhsd_bf16(B, S, Hkv, D), \
        _bhsd_bf16(B, S, Hkv, D)
    out, dout = _bhsd_bf16(B, S, Hq, D), _bhsd_bf16(B, S, Hq, D)
    lse = torch.zeros((B, Hq, S))
    launches = fa.flash_attention_bwd.launches
    routes = dict(fa.flash_attention_bwd.routes)
    with pytest.raises(RuntimeError, match="too many resources"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    assert fa.flash_attention_bwd.launches == launches
    assert fa.flash_attention_bwd.routes == routes
