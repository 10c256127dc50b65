"""The port's whisper (encoder–decoder) path against the JAX package's, on
the whisper-large-v3 smoke config in float32: the parameter tree, the
non-gated GELU FFN and the layernorm, the bidirectional encoder, the
teacher-forced decoder's logits, prefill with every ``EncDecCache`` leaf,
three decode steps with their caches, decode past the 4,096-row learned
position table, and that the frames (the batch's context) move the
logits.

Weights come from the reference's ``init(PRNGKey(0))`` (imported through
``torch_port_ref``), carried across with ``params_from_jax``; the frames
and tokens are made with numpy from a seed.  The reference runs as its
serving engine builds it (``impl="chunked"`` prefill, ``decode_impl=
"naive"`` decode); the port runs its attention kernels' plain versions.
Tolerance ``atol=1e-4`` (``rtol=1e-5``), as in tests/test_torch_model.py:
both sides accumulate in float32 in different orders.  The kernels at
whisper's full-width shapes (D 64, 20 heads, 1,500 frames) are held
against these plain versions on the card in ``chip_smoke.py``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import jax_to_numpy, reference_core  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as pencdec  # noqa: E402
from repro_torch.models import layers as players  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-5)
ARCH = "whisper-large-v3"
B, S, S_MAX = 2, 10, 16


def _close(got, exp, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               err_msg=what, **TOL)


@pytest.fixture(scope="module")
def ref():
    """The reference smoke model (as its engine builds it), its numpy
    parameters, the port's config, model and parameters, and seeded frames
    (B, n_ctx, d)."""
    reference_core()
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import build_model as jax_build
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jm = jax_build(jcfg)
    np_params = jax_to_numpy(jm.init(jax.random.PRNGKey(0)))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    frames = np.random.default_rng(11).standard_normal(
        (B, cfg.cross.n_context_tokens, cfg.d_model)).astype(np.float32)
    return jm, jcfg, np_params, cfg, build_model(cfg), \
        params_from_jax(np_params, device="cpu"), frames


def test_parameter_tree_lines_up_leaf_for_leaf(ref):
    """The reference's tree — learned positions, a bare embed array,
    stacked enc/dec blocks, the final layernorms — against the port's, leaf
    for leaf with the stacks unstacked; the port's own init draws the same
    tree."""
    _jm, jcfg, np_params, cfg, model, params, _f = ref
    assert set(params) == set(np_params) == {
        "enc_pos", "dec_pos", "embed", "enc", "dec", "ln_enc", "ln_dec"}
    assert isinstance(params["embed"], torch.Tensor)
    assert params["dec_pos"].shape == (pencdec.DEC_POSITIONS, cfg.d_model)
    assert params["enc_pos"].shape == (cfg.cross.n_context_tokens,
                                       cfg.d_model)
    assert len(params["enc"]) == cfg.n_enc_layers
    assert len(params["dec"]) == cfg.n_layers
    n = 0
    for part in ("enc", "dec"):
        stacked = np_params[part]
        for i, layer in enumerate(params[part]):
            flat = jax.tree_util.tree_flatten_with_path(stacked)[0]
            for path, leaf in flat:
                got = layer
                for key in path:
                    got = got[key.key]
                np.testing.assert_array_equal(got.numpy(), leaf[i])
                n += 1
    top = [k for k in params if k not in ("enc", "dec")]
    for k in top:
        for got, want in zip(jax.tree.leaves(params[k]),
                             jax.tree.leaves(np_params[k])):
            np.testing.assert_array_equal(got.numpy(), want)
            n += 1
    assert n == len(jax.tree.leaves(params))
    own = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, params))
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_ffn_nogate_and_layernorm_match_the_reference(ref):
    """``ffn_nogate`` (tanh-approximate GELU) on the reference's weights,
    and ``layernorm`` on the reference's ``init_layernorm`` leaves (and on
    seeded ones) at whisper's ``norm_eps``."""
    from repro.models import layers as jlayers
    _jm, _jc, np_params, cfg, _m, params, _f = ref
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32) * 3
    jffn = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["dec"]["ffn"])
    _close(players.ffn_nogate(params["dec"][0]["ffn"], torch.from_numpy(x)),
           jlayers.ffn_nogate(jffn, jnp.asarray(x)), "ffn_nogate")
    init = jax.tree.map(np.array, jlayers.init_layernorm(cfg.d_model))
    seeded = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
              "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    for p in (init, seeded):
        _close(players.layernorm({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), cfg.norm_eps),
               jlayers.layernorm(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), cfg.norm_eps), "layernorm")


def test_encoder_and_teacher_forced_logits_match_the_reference(ref):
    from repro.models import encdec as jencdec
    jm, jcfg, np_params, cfg, model, params, frames = ref
    jp = jax.tree.map(jnp.asarray, np_params)
    enc = pencdec.encode(params, cfg, torch.from_numpy(frames))
    jenc = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    _close(enc, jenc, "encode")
    tokens = np.random.default_rng(13).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)
    _close(pencdec.decode_train(params, cfg, torch.from_numpy(tokens), enc),
           jencdec.decode_train(jp, jcfg, jnp.asarray(tokens), jenc),
           "decode_train")
    _close(model.logits(params, {"tokens": tokens,
                                 "context": torch.from_numpy(frames)}),
           jm.logits(jp, {"tokens": jnp.asarray(tokens),
                          "context": jnp.asarray(frames)}), "logits")


def _caches_close(cache, jcache, cfg, what):
    assert len(cache.self_kv) == len(cache.cross_kv) == cfg.n_layers
    for name in ("self_kv", "cross_kv"):
        for i, kv in enumerate(getattr(cache, name)):
            jkv = getattr(jcache, name)
            for leaf in ("k", "v"):
                _close(getattr(kv, leaf), np.asarray(getattr(jkv, leaf))[i],
                       f"{what} {name}[{i}].{leaf}")


def test_prefill_and_decode_steps_match_the_reference(ref):
    """Prefill's last logits and every cache leaf (self caches padded to
    ``S_MAX`` slots, cross caches of the encoder's ``n_ctx`` positions),
    then three decode steps, their logits and every cache leaf after
    each."""
    jm, _jc, np_params, cfg, model, params, frames = ref
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(14)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    jlg, jcache, jpos = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tokens), "context": jnp.asarray(frames)},
        S_MAX)
    lg, cache, pos = model.prefill(
        params, {"tokens": tokens, "context": torch.from_numpy(frames)},
        S_MAX)
    _close(lg, jlg, "prefill logits")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert cache.self_kv[0].k.shape == (B, cfg.n_kv_heads, S_MAX,
                                        cfg.head_dim_)
    assert cache.cross_kv[0].k.shape == (B, cfg.n_kv_heads,
                                         cfg.cross.n_context_tokens,
                                         cfg.head_dim_)
    _caches_close(cache, jcache, cfg, "prefill")
    jdec = jax.jit(jm.decode_step)
    for step in range(3):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        jlg, jcache = jdec(jp, jnp.asarray(tok), jcache, jpos)
        lg, cache = model.decode_step(params, torch.from_numpy(tok), cache,
                                      pos)
        _close(lg, jlg, f"decode step {step}")
        _caches_close(cache, jcache, cfg, f"decode step {step}")
        jpos, pos = jpos + 1, pos + 1


def test_decode_reads_the_position_table_modulo_its_rows(ref):
    """A decode step at positions past the 4,096-row ``dec_pos`` table (the
    reference reads row ``pos % 4096``) against the reference, from a
    seeded cache; and the prefill's tiling of the table, on a 5-row
    table."""
    jm, _jc, np_params, cfg, model, params, _f = ref
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(15)
    s_max = pencdec.DEC_POSITIONS + 8
    jcache = jm.init_cache(B, s_max)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), jcache)
    cache = pencdec.EncDecCache(*(
        [pencdec.A.KVCache(*(torch.from_numpy(np.asarray(t)[i].copy())
                             for t in kv)) for i in range(cfg.n_layers)]
        for kv in jcache))
    pos = np.array([pencdec.DEC_POSITIONS + 3, pencdec.DEC_POSITIONS - 1],
                   np.int32)
    tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
    jlg, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jcache,
                                     jnp.asarray(pos))
    lg, _ = model.decode_step(params, torch.from_numpy(tok), cache,
                              torch.from_numpy(pos))
    _close(lg, jlg, "decode past the position table")
    small = dict(params, dec_pos=params["dec_pos"][:5])
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (B, 12)))
    want = params["embed"][toks] + torch.from_numpy(
        np.tile(small["dec_pos"].numpy(), (3, 1))[:12])[None]
    assert torch.equal(pencdec._embed_tokens(small, toks), want)


def test_the_frames_move_the_logits(ref):
    """Other frames give other logits at prefill and in decode (the cross
    caches carry them), as they do in the reference."""
    _jm, _jc, _np, cfg, model, params, frames = ref
    tokens = np.random.default_rng(16).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)
    outs = []
    for f in (frames, frames[::-1].copy(), np.zeros_like(frames)):
        lg, cache, pos = model.prefill(
            params, {"tokens": tokens, "context": torch.from_numpy(f)},
            S_MAX)
        dlg, _ = model.decode_step(params, torch.from_numpy(tokens[:, :1]),
                                   cache, pos)
        outs.append((lg, dlg))
    for a, b in ((0, 1), (0, 2), (1, 2)):
        for j in range(2):
            assert (outs[a][j] - outs[b][j]).abs().max() > 1e-3


def test_full_config_plan_and_cache():
    """whisper-large-v3's full config: 32 + 32 layers of 20 heads of 64,
    1,500 frames; its cache on the meta device."""
    cfg = get_config(ARCH)
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.head_dim_) == (32, 32, 64)
    cache = build_model(cfg).init_cache(4, 256, device="meta")
    assert len(cache.self_kv) == len(cache.cross_kv) == 32
    assert cache.self_kv[0].k.shape == (4, 20, 256, 64)
    assert cache.cross_kv[0].v.shape == (4, 20, 1500, 64)
    assert cache.cross_kv[0].v.dtype == torch.bfloat16
