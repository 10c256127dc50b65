"""The port's vlm path (llama-3.2-vision's gated cross-attention layers)
against the JAX package's, on the llama-3.2-vision-11b smoke config in
float32: cross ``attention(kv_x=)`` and ``cross_attention_decode``,
the layer plan, the smoke model's prefill, ``logits`` and three decode
steps with every cache leaf, and that the context moves the logits.

The reference's init starts every gate at ``tanh(0) = 0``, so a cross layer
adds nothing and a port that skipped cross-attention would pass; here the
gates of the numpy tree are set to seeded non-zero values before both
packages use it, and the context is random and seeded.  Weights otherwise
come from the reference's ``init(PRNGKey(0))`` (imported through
``torch_port_ref``), carried across with ``params_from_jax``.  The
reference runs as its serving engine builds it (``impl="chunked"``
prefill, ``decode_impl="naive"`` decode); the port runs its attention
kernels' plain versions.  Tolerance ``atol=1e-4`` (``rtol=1e-5``), as in
tests/test_torch_model.py: both sides accumulate in float32 in different
orders."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import jax_to_numpy, reference_core  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as ptrans  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-5)
ARCH = "llama-3.2-vision-11b"
B, S, S_MAX = 2, 10, 16


def _close(got, exp, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               err_msg=what, **TOL)


def seeded_gates(np_params, rng):
    """The numpy tree with every cross layer's ``gate_attn`` and
    ``gate_ffn`` drawn from ±[0.3, 1.2] (float32, the reference's dtype and
    shape)."""
    for block in np_params["stack"].super:
        for name in ("gate_attn", "gate_ffn"):
            if name in block:
                g = rng.uniform(0.3, 1.2, block[name].shape)
                sign = rng.choice([-1.0, 1.0], block[name].shape)
                block[name] = (g * sign).astype(np.float32)
    return np_params


@pytest.fixture(scope="module")
def ref():
    """The reference smoke model (as its engine builds it) and its numpy
    parameters with seeded gates, the port's config, model and parameters,
    and a seeded context (B, n_ctx, d)."""
    reference_core()
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import build_model as jax_build
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jm = jax_build(jcfg)
    rng = np.random.default_rng(21)
    np_params = seeded_gates(jax_to_numpy(jm.init(jax.random.PRNGKey(0))),
                             rng)
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    context = rng.standard_normal(
        (B, cfg.cross.n_context_tokens, cfg.d_model)).astype(np.float32)
    return jm, jcfg, np_params, cfg, build_model(cfg), \
        params_from_jax(np_params, device="cpu"), context


def test_layer_plan_and_gate_leaves():
    """``[attn × (k − 1), cross] × L/k``: the smoke model's and the full
    config's (``[attn × 4, cross] × 8``), the layers the reference stacks,
    and a cross layer's float32 0-d gates beside its ``attn`` leaves."""
    cfg = get_config(ARCH)
    kinds = ptrans.layer_kinds(cfg)
    assert kinds == (["attn"] * 4 + ["cross"]) * 8
    assert ptrans.layer_stacks(cfg) == [[p + 5 * i for i in range(8)]
                                        for p in range(5)]
    smoke = get_smoke_config(ARCH)
    assert ptrans.layer_kinds(smoke) == ["attn", "cross"] * 2
    params = build_model(smoke).init(torch.Generator().manual_seed(0))
    cross = params["layers"][1]
    assert set(cross) == {"ln1", "ln2", "attn", "gate_attn", "gate_ffn",
                          "ffn"}
    assert set(cross["attn"]) == set(params["layers"][0]["attn"])
    for name in ("gate_attn", "gate_ffn"):
        assert cross[name].shape == () and cross[name].dtype == torch.float32
        assert float(cross[name]) == 0.0
    cache = build_model(cfg).init_cache(4, 544, device="meta")
    assert cache[4].k.shape == (4, 8, 1601, 128)
    assert cache[3].k.shape == (4, 8, 544, 128)


def test_gates_come_across_in_float32(ref):
    _jm, _jc, np_params, cfg, _m, params, _c = ref
    sup = np_params["stack"].super[1]
    for i, layer in enumerate(params["layers"][1::2]):
        for name in ("gate_attn", "gate_ffn"):
            assert layer[name].dtype == torch.float32
            assert float(layer[name]) == float(sup[name][i]) != 0.0


def test_cross_attention_and_its_decode_match_the_reference(ref):
    """Cross ``attention`` (k, v from the context, non-causal, no RoPE,
    Sq ≠ Sk) and its returned k/v; ``cross_attention_decode`` over a
    context cache (every sequence sees all its slots; the cache stays as it
    was)."""
    from repro.models import attention as jattn
    _jm, jcfg, np_params, cfg, _m, params, context = ref
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["stack"].super[1]["attn"])
    p = params["layers"][1]["attn"]
    x = np.random.default_rng(22).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    out, kv = pattn.attention(p, cfg, torch.from_numpy(x),
                              kv_x=torch.from_numpy(context), use_rope=False)
    jout, jkv = jattn.attention(jp, jcfg, jnp.asarray(x),
                                kv_x=jnp.asarray(context), use_rope=False,
                                impl="chunked")
    _close(out, jout, "cross attention")
    _close(kv.k, jkv.k, "cross k")
    _close(kv.v, jkv.v, "cross v")
    assert kv.k.shape[2] == cfg.cross.n_context_tokens != S
    cache = pattn.KVCache(kv.k.contiguous(), kv.v.contiguous())
    before = [t.clone() for t in cache]
    xt = x[:, :1]
    pos = torch.tensor([3, 7], dtype=torch.int32)
    lengths = pattn.context_lengths(cache)
    assert lengths.tolist() == [cfg.cross.n_context_tokens] * B
    out = pattn.cross_attention_decode(p, cfg, torch.from_numpy(xt), cache,
                                       lengths)
    jout, jnew = jattn.attention_decode(jp, jcfg, jnp.asarray(xt), jkv,
                                        jnp.asarray(pos.numpy()),
                                        use_rope=False, cross=True)
    _close(out, jout, "cross decode")
    assert all(torch.equal(a, b) for a, b in zip(cache, before))
    _close(cache.k, jnew.k, "cross decode cache")


def test_zero_gates_make_a_cross_layer_the_identity(ref):
    """At the reference's init (gates 0) a cross layer returns its input
    exactly, whatever the context: why the tests seed the gates."""
    _jm, _jc, _np, cfg, _m, params, context = ref
    layer = dict(params["layers"][1], gate_attn=torch.tensor(0.0),
                 gate_ffn=torch.tensor(0.0))
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    out, _aux = ptrans.train_block(layer, cfg, "cross", x,
                                   context=torch.from_numpy(context))
    assert torch.equal(out, x)
    out, _aux = ptrans.train_block(params["layers"][1], cfg, "cross", x,
                                   context=torch.from_numpy(context))
    assert (out - x).abs().max() > 1e-2


def test_prefill_and_decode_steps_match_the_reference(ref):
    """Prefill's last logits and ``logits`` over the prompt; every layer's
    cache leaf (self caches padded to ``S_MAX`` slots, cross caches of the
    context's ``n_ctx`` positions); three decode steps, their logits and
    every cache leaf after each."""
    jm, _jc, np_params, cfg, model, params, context = ref
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(24)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "context": jnp.asarray(context)}
    batch = {"tokens": tokens, "context": torch.from_numpy(context)}
    jlg, jcache, jpos = jax.jit(jm.prefill, static_argnums=2)(jp, jbatch,
                                                              S_MAX)
    lg, caches, pos = model.prefill(params, batch, S_MAX)
    _close(lg, jlg, "prefill logits")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _close(model.logits(params, batch), jm.logits(jp, jbatch), "logits")
    kinds = ptrans.layer_kinds(cfg)
    period = cfg.cross.every_k

    def caches_close(what):
        jc = jax_to_numpy(jcache).super
        assert len(caches) == cfg.n_layers
        for i, (kind, c) in enumerate(zip(kinds, caches)):
            slots = cfg.cross.n_context_tokens if kind == "cross" else S_MAX
            assert c.k.shape == (B, cfg.n_kv_heads, slots, cfg.head_dim_)
            want = jc[i % period]
            _close(c.k, want.k[i // period], f"{what} layer {i} k")
            _close(c.v, want.v[i // period], f"{what} layer {i} v")

    caches_close("prefill")
    jdec = jax.jit(jm.decode_step)
    for step in range(3):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        jlg, jcache = jdec(jp, jnp.asarray(tok), jcache, jpos)
        lg, caches = model.decode_step(params, torch.from_numpy(tok),
                                       caches, pos)
        _close(lg, jlg, f"decode step {step}")
        caches_close(f"decode step {step}")
        jpos, pos = jpos + 1, pos + 1


def test_the_context_moves_the_logits(ref):
    """Another context gives other logits at prefill, in ``logits`` and in
    decode (through the cross caches), on both packages alike."""
    jm, _jc, np_params, cfg, model, params, context = ref
    jp = jax.tree.map(jnp.asarray, np_params)
    tokens = np.random.default_rng(25).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)
    other = np.random.default_rng(26).standard_normal(
        context.shape).astype(np.float32)
    outs = []
    for ctx in (context, other):
        batch = {"tokens": tokens, "context": torch.from_numpy(ctx)}
        lg, caches, pos = model.prefill(params, batch, S_MAX)
        dlg, _ = model.decode_step(params, torch.from_numpy(tokens[:, :1]),
                                   caches, pos)
        outs.append((lg, model.logits(params, batch), dlg))
        jlg = jm.logits(jp, {"tokens": jnp.asarray(tokens),
                             "context": jnp.asarray(ctx)})
        _close(outs[-1][1], jlg, "logits")
    for a, b in zip(*outs):
        assert (a - b).abs().max() > 1e-3
