"""The port's dense LM against the JAX package's, on the smoke configs of
llama3.2-3b, qwen3-8b (qk-norm, explicit head_dim), gemma-2b (GeGLU, MQA,
tied embeddings) and internlm2-20b (GQA) in float32.

Weights come from the reference's ``build_model(cfg).init(PRNGKey(0))``,
carried across with ``params_from_jax``; inputs are made with numpy from a
seed.  The reference runs as the serving engine builds it (``impl="chunked"``
prefill, ``decode_impl="naive"`` decode); the port runs its attention
kernels' plain versions.  Tolerance ``atol=1e-4`` (``rtol=1e-5``) on logits
and caches: the two sides accumulate in float32 in different orders (the
reference's chunked scan against one-pass softmax, XLA's dot against
PyTorch's), through two layers and a 256-wide unembedding."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as players  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-5)
ARCHS = ["llama3.2-3b", "qwen3-8b", "gemma-2b", "internlm2-20b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ARCHS + ["recurrentgemma-2b", "rwkv6-7b",
                                          "llama4-maverick-400b-a17b",
                                          "deepseek-v3-671b",
                                          "llama-3.2-vision-11b",
                                          "whisper-large-v3"])
def test_configs_match_the_reference(arch):
    import dataclasses

    from repro.configs import get_config as jax_config
    for port, ref in [(get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))]:
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim_", "qk_norm",
                  "act", "norm_eps", "rope_theta", "tie_embeddings", "dtype",
                  "scale_embed", "mtp_depth", "n_enc_layers"):
            assert getattr(port, f) == getattr(ref, f), f
        if ref.hybrid is None:
            assert port.hybrid is None
        else:
            for f in ("lru_width", "window", "pattern_period", "conv_width"):
                assert getattr(port.hybrid, f) == getattr(ref.hybrid, f), f
        if ref.moe is None:
            assert port.moe is None
        else:
            fields = [f.name for f in dataclasses.fields(ref.moe)]
            assert [f.name for f in dataclasses.fields(port.moe)] == fields
            for f in fields:
                assert getattr(port.moe, f) == getattr(ref.moe, f), f
            assert [port.is_moe_layer(i) for i in range(port.n_layers)] == \
                [ref.is_moe_layer(i) for i in range(ref.n_layers)]
        if ref.mla is None:
            assert port.mla is None
        else:
            assert dataclasses.asdict(port.mla) == dataclasses.asdict(ref.mla)
        if ref.cross is None:
            assert port.cross is None
        else:
            assert dataclasses.asdict(port.cross) == \
                dataclasses.asdict(ref.cross)
        assert port.dtype_ == torch.bfloat16
        assert port.replace(dtype="float32").dtype_ == torch.float32


def test_rmsnorm_and_rope_match_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    ref = np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                     jnp.asarray(x)))
    got = players.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    for pos in (np.arange(5)[None, :], np.array([[7], [300]])):
        xx = x if pos.shape[1] == 5 else x[:, :1]
        ref = np.asarray(jlayers.apply_rope(jnp.asarray(xx),
                                            jnp.asarray(pos), 5e5))
        got = players.apply_rope(torch.from_numpy(xx), torch.from_numpy(pos),
                                 5e5)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    jcfg = jax_smoke(arch).replace(dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = params_from_jax(_np(jparams), device="cpu")
    rng = np.random.default_rng(4)
    B, S, s_max = 2, 10, 16
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)

    jlg, jcache, jpos = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, s_max)
    lg, caches, pos = model.prefill(params, {"tokens": tokens}, s_max)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(
        model.logits(params, {"tokens": tokens}).numpy(),
        np.asarray(jm.logits(jparams, {"tokens": jnp.asarray(tokens)})),
        **TOL)

    jdec = jax.jit(jm.decode_step)
    for step in range(4):
        tok = rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
        jlg, jcache = jdec(jparams, jnp.asarray(tok), jcache, jpos)
        lg, caches = model.decode_step(params, torch.from_numpy(tok), caches,
                                       pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL,
                                   err_msg=f"{arch} decode step {step}")
        jpos, pos = jpos + 1, pos + 1
    jc = _np(jcache).super[0]
    assert len(caches) == cfg.n_layers
    for i, c in enumerate(caches):
        np.testing.assert_allclose(c.k.numpy(), jc.k[i], **TOL)
        np.testing.assert_allclose(c.v.numpy(), jc.v[i], **TOL)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_unported_families_are_refused(family, capsys):
    """The two families the port refused until it carried them (vlm:
    llama-3.2-vision, audio: whisper) are refused no longer: the smoke
    model builds and ``launch.serve --arch <id> --smoke --device cpu``
    serves it (a zero context, as in the reference), every admitted page
    deleted."""
    from repro_torch.core.kvstore import DELETE, INSERT
    from repro_torch.launch.serve import main
    arch = {"vlm": "llama-3.2-vision-11b", "audio": "whisper-large-v3"}[
        family]
    cfg = get_smoke_config(arch)
    assert cfg.family == family
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert ("enc" in params) == (family == "audio")
    outs, stats = main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "8",
                        "--gen-len", "3", "--max-batch", "2"])
    assert len(outs) == 3 and all(len(o) == 3 for o in outs)
    assert all(0 <= t < cfg.vocab for o in outs for t in o)
    assert stats["kv_ops"][INSERT] == stats["kv_ops"][DELETE] > 0
    assert "[serve] 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "gemma-2b",
                                  "internlm2-20b"])
def test_new_configs_build_and_serve_through_the_launcher(arch, capsys):
    """The smoke model builds (deepseek-v3: MLA, the MoE prefix and the MTP
    subtree) and ``launch.serve --arch <id> --smoke --device cpu`` serves,
    every admitted page deleted."""
    from repro_torch.core.kvstore import DELETE, INSERT
    from repro_torch.launch.serve import main
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert ("mtp" in params) == bool(cfg.mtp_depth)
    outs, stats = main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "8",
                        "--gen-len", "3", "--max-batch", "2"])
    assert len(outs) == 3 and all(len(o) == 3 for o in outs)
    assert all(0 <= t < cfg.vocab for o in outs for t in o)
    assert stats["kv_ops"][INSERT] == stats["kv_ops"][DELETE] > 0
    assert "[serve] 3 requests" in capsys.readouterr().out


def test_init_draws_from_the_generator():
    cfg = get_smoke_config("qwen3-8b")
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(1))
    assert len(a["layers"]) == cfg.n_layers
    assert a["layers"][0]["attn"]["wq"].shape == (64, 4 * 16)
    assert a["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert a["layers"][0]["attn"]["q_norm"]["scale"].dtype == torch.float32
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])
    assert ("head" in a["embed"]) == (not cfg.tie_embeddings)
    caches = model.init_cache(3, 20, device="cpu")
    assert len(caches) == cfg.n_layers
    assert caches[0].k.shape == (3, 2, 20, 16)
    assert caches[0].v.dtype == torch.bfloat16
