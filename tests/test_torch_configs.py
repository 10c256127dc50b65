"""The port's configuration helpers against the JAX package's:
``ArchConfig.param_count`` (both ``active_only`` values), the capability
flags and ``shape_applicable`` over ``LM_SHAPES``, and the dry run's
config policy — ``n_super_of``, ``cfg_with_n_super`` and
``default_tcfg`` with ``GIANT_PARAMS`` — for all ten archs, published and
smoke.

``repro/launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices when it
is imported; the import here restores the variable as it was, so no later
subprocess of the same pytest worker inherits it."""
import argparse
import os

import pytest

pytest.importorskip("jax")
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import LM_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs import shape_applicable as jax_applicable  # noqa: E402
from repro_torch.configs import (ARCH_IDS, LM_SHAPES,  # noqa: E402
                                 get_config, get_smoke_config,
                                 shape_applicable)
from repro_torch.launch import dryrun as D  # noqa: E402


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` put back as it
    was."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


JD = _reference_dryrun()
CONFIGS = [(arch, kind) for arch in ARCH_IDS for kind in ("full", "smoke")]


def _pair(arch, kind):
    if kind == "full":
        return get_config(arch), jax_config(arch)
    return get_smoke_config(arch), jax_smoke(arch)


def test_the_registries_hold_the_same_archs():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch, kind", CONFIGS)
def test_param_count_and_flags_match_the_reference(arch, kind):
    port, ref = _pair(arch, kind)
    for active in (False, True):
        assert port.param_count(active) == ref.param_count(active), active
    assert port.param_count() == port.param_count(active_only=False)
    assert port.sub_quadratic == ref.sub_quadratic
    assert port.has_decoder == ref.has_decoder


@pytest.mark.parametrize("arch, kind", CONFIGS)
def test_shape_applicable_matches_the_reference(arch, kind):
    port, ref = _pair(arch, kind)
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in LM_SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in JAX_SHAPES]
    for shape, jshape in zip(LM_SHAPES, JAX_SHAPES):
        assert shape_applicable(port, shape) == jax_applicable(ref, jshape)


def test_only_the_recurrent_archs_run_long_500k():
    long = next(s for s in LM_SHAPES if s.name == "long_500k")
    assert [a for a in ARCH_IDS if shape_applicable(get_config(a), long)[0]] \
        == ["recurrentgemma-2b", "rwkv6-7b"]


@pytest.mark.parametrize("arch, kind", CONFIGS)
def test_superblocks_match_the_reference(arch, kind):
    """``n_super_of`` and the configs rebuilt with 1 and 2 superblocks
    (prefix and suffix kept), field for field where they differ: the layer
    counts."""
    port, ref = _pair(arch, kind)
    assert D.n_super_of(port) == JD.n_super_of(ref)
    for n in (1, 2):
        got, want = D.cfg_with_n_super(port, n), JD.cfg_with_n_super(ref, n)
        assert (got.n_layers, got.n_enc_layers) == \
            (want.n_layers, want.n_enc_layers), n
        assert D.n_super_of(got) == JD.n_super_of(want) == n
        assert got.param_count() == want.param_count()


def _args(**kw):
    base = dict(optimizer="auto", zero_stage=2, remat="block", microbatch=0,
                fence="global", xent_chunks=1, act_shard="none",
                grad_clip=1.0)
    return argparse.Namespace(**(base | kw))


@pytest.mark.parametrize("kw", [{}, {"optimizer": "adamw"},
                                {"zero_stage": 0}, {"zero_stage": 3},
                                {"optimizer": "adafactor", "remat": "full",
                                 "microbatch": 4, "fence": "pair",
                                 "xent_chunks": 8, "act_shard": "seq",
                                 "grad_clip": 0.5}])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_tcfg_matches_the_reference(arch, kw):
    """Every field of the training config, giants (Adafactor on ``auto``,
    ZeRO 3 for 2, bf16 moments) and the rest."""
    got = D.default_tcfg(get_config(arch), _args(**kw))
    want = JD.default_tcfg(jax_config(arch), _args(**kw))
    assert vars(got) == vars(want)


def test_the_giants_are_llama4_and_deepseek():
    assert D.GIANT_PARAMS == JD.GIANT_PARAMS
    giants = [a for a in ARCH_IDS
              if get_config(a).param_count() > D.GIANT_PARAMS]
    assert giants == ["llama4-maverick-400b-a17b", "deepseek-v3-671b"]
    for a in giants:
        t = D.default_tcfg(get_config(a), _args())
        assert (t.optimizer, t.zero_stage, t.adam_dtype) == \
            ("adafactor", 3, "bfloat16")


def test_the_import_left_xla_flags_alone():
    assert "512" not in os.environ.get("XLA_FLAGS", "")
