"""The port's deepseek-v3 path against the JAX package's: MLA attention
(the expanded prefill and the matrix-absorbed decode over the compressed
cache), the MoE block at top-8 with a shared expert, the smoke model's
prefill and decode with its MTP subtree, and the smoke ServingEngine.

Weights come from the reference's ``init(PRNGKey(0))`` (the JAX engine's
own), carried across with ``params_from_jax``; inputs are made with numpy
from a seed; everything runs in float32 on the CPU.  The reference runs as
its serving engine builds it (``impl="chunked"`` prefill, ``decode_impl=
"naive"`` decode); the port runs its attention kernels' plain versions.
Tolerance ``atol=1e-4`` (``rtol=1e-5``), as in tests/test_torch_model.py:
both sides accumulate in float32 in different orders.  The kernels'
arithmetic at the full MLA decode shape (128 query heads on one 576-wide
latent kv head) is held here through their plain versions; the kernels
themselves against those plain versions on the card in ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import jax_to_numpy, reference_core  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import MoEConfig  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.decode_attention import _split  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-5)
ARCH = "deepseek-v3-671b"
MAX_SEQ = 48


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, exp, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               err_msg=what, **TOL)


def _torch_tree(np_tree):
    return jax.tree.map(_t, np_tree)


@pytest.fixture(scope="module")
def ref():
    """The JAX smoke engine (its jitted prefill and decode step are the
    reference model's), its config and numpy parameters, and the port's
    config and parameters."""
    reference_core()
    from repro.configs import get_smoke_config as jax_smoke
    from repro.serving.engine import ServingEngine as JaxEngine
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jeng = JaxEngine(jcfg, max_batch=2, max_seq=MAX_SEQ)
    np_params = jax_to_numpy(jeng.params)
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    return jeng, jcfg, np_params, cfg, params_from_jax(np_params,
                                                       device="cpu")


def test_parameter_tree_lines_up_leaf_for_leaf(ref):
    """46 reference leaves — embed, final_norm, the stacked MLA stack and
    the mtp subtree (proj, norm_h, norm_e, one mla_dense block) — against
    the port's unstacked tree, leaf for leaf, name for name, and the
    port's own init draws the same tree."""
    _j, _jc, np_params, cfg, params = ref
    assert len(jax.tree.leaves(np_params)) == 46
    stack = np_params["stack"]
    n = len(jax.tree.leaves(stack.super[0])[0])
    expected = {k: np_params[k] for k in ("embed", "final_norm", "mtp")}
    expected["layers"] = list(stack.prefix) + [
        jax.tree.map(lambda a, i=i: a[i], stack.super[0]) for i in range(n)]
    got = jax.tree.map(lambda t: t.numpy(), params)
    flat_exp, def_exp = jax.tree_util.tree_flatten_with_path(expected)
    flat_got, def_got = jax.tree_util.tree_flatten_with_path(got)
    assert def_got == def_exp and len(flat_got) == 62
    for (path, e), (_p, g) in zip(flat_exp, flat_got):
        assert g.dtype == np.asarray(e).dtype, path
        np.testing.assert_array_equal(g, e, err_msg=str(path))
    assert layer_kinds(cfg) == ["mla_dense", "mla_moe", "mla_moe"]
    assert params["layers"][1]["ffn"]["experts"]["wi_gate"].shape == \
        (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda t: 0, params))
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _layer(ref, i=0):
    """Layer ``i``'s MLA parameters on both sides (0: the prefix's
    mla_dense layer; 1, 2: the stacked mla_moe layers)."""
    _j, jcfg, np_params, cfg, params = ref
    stack = np_params["stack"]
    jp = stack.prefix[i] if i < len(stack.prefix) else jax.tree.map(
        lambda a: a[i - len(stack.prefix)], stack.super[0])
    return jcfg, jax.tree.map(jnp.asarray, jp["attn"]), cfg, \
        params["layers"][i]["attn"]


@pytest.mark.parametrize("layer", [0, 2])
def test_mla_prefill_and_cache_match_the_reference(ref, layer):
    """``_mla_qkv`` (q, k, v and the cache rows), then ``mla_attention``'s
    output and both MLACache leaves, against the reference's chunked
    prefill."""
    from repro.models import attention as jattn
    jcfg, jp, cfg, p = _layer(ref, layer)
    rng = np.random.default_rng(11 + layer)
    B, S = 2, 10
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None, :]
    jq = jattn._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    pq = pattn._mla_qkv(p, cfg, _t(x), _t(pos))
    for name, g, e in zip(("q", "k", "v", "ckv", "krope"), pq, jq):
        assert tuple(g.shape) == e.shape, name
        _close(g, e, name)
    jout, jcache = jattn.mla_attention(jp, jcfg, jnp.asarray(x),
                                       impl="chunked")
    out, cache = pattn.mla_attention(p, cfg, _t(x))
    _close(out, jout, "mla_attention output")
    assert cache._fields == jcache._fields == ("ckv", "krope")
    for name in cache._fields:
        _close(getattr(cache, name), getattr(jcache, name), name)


def test_mla_decode_matches_the_reference(ref):
    """The matrix-absorbed decode, three steps from a prefilled cache of 16
    slots, with ragged positions and one sequence stepping past the cache
    (the masked ``where`` writes nothing there, and it attends every
    slot): the output and both MLACache leaves after each step."""
    from repro.models import attention as jattn
    jcfg, jp, cfg, p = _layer(ref, 1)
    rng = np.random.default_rng(12)
    B, S, slots = 2, 10, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    _out, c = pattn.mla_attention(p, cfg, _t(x))
    cache = pattn.MLACache(*(torch.nn.functional.pad(t, (0, 0, 0, slots - S))
                             for t in c))
    jcache = jattn.MLACache(*(jnp.asarray(t.numpy()) for t in cache))
    pos = np.array([10, 15], np.int32)
    for step in range(3):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jattn.mla_decode(jp, jcfg, jnp.asarray(xt), jcache,
                                        jnp.asarray(pos), impl="naive")
        out, cache = pattn.mla_decode(p, cfg, _t(xt), cache, _t(pos))
        _close(out, jout, f"step {step} output")
        for name in cache._fields:
            _close(getattr(cache, name), getattr(jcache, name),
                   f"step {step} {name}")
        pos = pos + 1
    assert not cache.ckv[0, 13:].any(), "slots past a sequence stay zero"


@pytest.mark.parametrize("H, S, Dqk, Dv", [(4, 10, 24, 16), (2, 9, 192, 128)])
def test_zero_padded_v_flash_matches_unpadded_mha(H, S, Dqk, Dv):
    """The prefill's flash call with v zero-padded from Dv to Dqk and the
    output sliced back, against the reference's ``mha`` on the unpadded
    v (Dqk ≠ Dv): zero V columns give zero output columns."""
    from repro.kernels import ref as kref
    rng = np.random.default_rng(13)
    q, k = (rng.standard_normal((2, H, S, Dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, H, S, Dv)).astype(np.float32)
    scale = 1.0 / 192 ** 0.5
    exp = kref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, sm_scale=scale)
    out = flash_attention(_t(q), _t(k), torch.nn.functional.pad(
        _t(v), (0, Dqk - Dv)), causal=True, sm_scale=scale)
    assert not out[..., Dv:].any()
    _close(out[..., :Dv], exp, "padded-v flash")


@pytest.mark.parametrize("chunk", [8, 64])
def test_plain_decode_at_the_full_mla_shape(chunk):
    """The decode kernel's plain version and its split algorithm (group
    tiles of 16 query heads, chunks of ``chunk`` keys) at MLA's full decode
    shape — 128 query heads on one 576-wide kv head, scale 1/sqrt(192) —
    against the reference's ``decode_attention`` oracle; a length-0 row
    gives zeros (the Pallas kernels' rule, which the oracle's uniform
    average does not follow, so it is checked on its own)."""
    from repro.kernels import ref as kref
    rng = np.random.default_rng(14)
    B, H, S, D = 3, 128, 20, 576
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, 1, S, D)).astype(np.float32)
              for _ in range(2))
    lens = np.array([0, 7, S], np.int32)
    scale = 1.0 / 192 ** 0.5
    exp = np.asarray(kref.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        sm_scale=scale))
    args = (_t(q), _t(kc), _t(vc), _t(lens))
    for got in (pref.decode_attention(*args, sm_scale=scale),
                pref.decode_attention_split(*args, chunk, sm_scale=scale)):
        assert got.shape == (B, H, D)
        np.testing.assert_allclose(got[1:].numpy(), exp[1:], **TOL)
        assert not got[0].any()
    assert _split(4, 1, 544, 128) == (9, 64)   # 8 group tiles x 4 x 9


def test_moe_block_local_top8_with_a_shared_expert():
    """``moe_block_local`` at top-8 of 16 experts with a shared expert (the
    deepseek-v3 routing, narrowed), capacity drops included, against the
    reference; and the capacity at full width: 80 slots for a 4 x
    512-token prefill, 8 for a decode step."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import moe as jmoe
    mo = dict(n_experts=16, top_k=8, d_ff_expert=32, n_shared_experts=1,
              d_ff_shared=48, first_k_dense=1, d_ff_dense=128)
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **mo))
    cfg = get_smoke_config(ARCH).replace(
        dtype="float32", moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    p = _torch_tree(jax_to_numpy(jp))
    x = np.random.default_rng(15).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_block_local(jp, jnp.asarray(x), jcfg)
    out, aux = pmoe.moe_block_local(p, _t(x), cfg)
    _close(out, jout, "moe output")
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    full, jfull = get_config(ARCH).moe, jax_config(ARCH).moe
    for T, C in ((4 * 512, 80), (4, 8)):
        assert pmoe.capacity(T, full) == jmoe.capacity(T, jfull) == C


def test_smoke_model_matches_the_reference(ref):
    """The smoke deepseek-v3's prefill logits and every MLACache leaf, then
    three decode steps' logits and caches, against the reference model as
    its engine compiles it (the same batch and cache shapes)."""
    jeng, _jc, _np, cfg, params = ref
    model = build_model(cfg)
    rng = np.random.default_rng(16)
    tokens = rng.integers(1, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    jlg, jcache, jpos = jeng._prefill(jeng.params, batch, MAX_SEQ)
    lg, caches, pos = model.prefill(params, {"tokens": tokens}, MAX_SEQ)
    _close(lg, jlg, "prefill logits")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    for step in range(3):
        tok = rng.integers(1, cfg.vocab, (2, 1)).astype(np.int32)
        jlg, jcache = jeng._decode(jeng.params, jnp.asarray(tok), jcache,
                                   jpos, batch)
        lg, caches = model.decode_step(params, _t(tok), caches, pos)
        _close(lg, jlg, f"decode step {step}")
        jpos, pos = jpos + 1, pos + 1
    jc = jax_to_numpy(jcache)
    ref_caches = list(jc.prefix) + [
        jax.tree.map(lambda a, i=i: a[i], jc.super[0])
        for i in range(cfg.n_layers - len(jc.prefix))]
    assert len(caches) == len(ref_caches) == cfg.n_layers
    for i, (c, e) in enumerate(zip(caches, ref_caches)):
        assert isinstance(c, pattn.MLACache) and c.ckv.shape == (2, MAX_SEQ,
                                                                 16)
        _close(c.ckv, e.ckv, f"layer {i} ckv")
        _close(c.krope, e.krope, f"layer {i} krope")


def test_smoke_engine_tokens_match_the_reference(ref):
    """Four 12-token prompts, 4 generated tokens each, max_batch 2: the
    port's engine on the JAX engine's weights generates the same tokens,
    with the same page-table operations."""
    from repro_torch.serving import ServingEngine
    jeng, _jc, _np, cfg, params = ref
    eng = ServingEngine(cfg, max_batch=2, max_seq=MAX_SEQ, device="cpu",
                        params=params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=(12,)).astype(np.int32)
               for _ in range(4)]
    jouts = jeng.generate(prompts, gen_len=4)
    outs = eng.generate(prompts, gen_len=4)
    assert outs == [[int(t) for t in o] for o in jouts]
    assert eng.stats()["kv_ops"] == jeng.stats()["kv_ops"]
