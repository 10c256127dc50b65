"""The port's uint32 emulation against the JAX package on edge values:
``hash_u32``, ``checksum``, the kvstore row encoding and the bit casts.
Exact equality (integer arithmetic)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402

import repro_torch.core as pt  # noqa: E402
from repro_torch.core.u32 import as_u32, i2u, mul32, u2i  # noqa: E402

EDGES = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0x9E3779B1,
                  12345678], dtype=np.uint32)


@pytest.fixture(scope="module")
def core():
    return reference_core()


def test_hash_u32_edges(core):
    got = pt.hash_u32(as_u32(EDGES)).numpy()
    exp = np.asarray(core.cache.hash_u32(jnp.asarray(EDGES)))
    np.testing.assert_array_equal(got.astype(np.uint32), exp)
    assert (got >= 0).all() and (got < 2 ** 32).all()


def test_mul32_matches_uint32_wraparound():
    for b in (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x7FEB352D, 0xFFFFFFFF, 1):
        got = mul32(as_u32(EDGES), b).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, EDGES * np.uint32(b))


def test_bit_casts_round_trip():
    ints = u2i(as_u32(EDGES))
    assert ints.dtype == torch.int32
    np.testing.assert_array_equal(ints.numpy(), EDGES.view(np.int32))
    np.testing.assert_array_equal(i2u(ints).numpy().astype(np.uint32), EDGES)


@pytest.mark.parametrize("kind", ["int32", "uint32", "float32", "bool"])
def test_checksum_edges(core, kind):
    rows = np.stack([EDGES, EDGES[::-1], np.roll(EDGES, 3)])
    if kind == "int32":
        vals = rows.view(np.int32)
    elif kind == "uint32":
        vals = rows
    elif kind == "float32":
        vals = rows.view(np.float32)
    else:
        vals = (rows % 2).astype(bool)
    exp = np.stack([np.asarray(core.checksum(jnp.asarray(v))) for v in vals])
    tv = as_u32(vals) if kind == "uint32" else torch.from_numpy(vals.copy())
    got = pt.checksum(tv).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, exp)
    # scalar items (the SST's registers): one checksum per element
    exp0 = np.asarray([core.checksum(jnp.asarray(v)) for v in vals[0]])
    got0 = pt.checksum(tv[0], item_dims=0).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got0, exp0)


def test_encode_decode_rows_edges(core):
    jkv = core.KVStore(None, "kv_rows", core.make_manager(2),
                       slots_per_node=4, value_width=2)
    tkv = pt.KVStore(None, "kv_rows", pt.make_manager(2, device="cpu"),
                     slots_per_node=4, value_width=2)
    payload = np.stack([EDGES.view(np.int32), EDGES[::-1].view(np.int32)], 1)
    for valid in (False, True):
        exp = np.stack([np.asarray(jkv.encode_row(payload[i], EDGES[i], valid))
                        for i in range(EDGES.size)])
        got = tkv.encode_row(torch.from_numpy(payload), as_u32(EDGES), valid)
        np.testing.assert_array_equal(got.numpy(), exp)
        p, c, v, ok = tkv.decode_row(got)
        np.testing.assert_array_equal(p.numpy(), payload)
        np.testing.assert_array_equal(c.numpy().astype(np.uint32), EDGES)
        assert bool((v == valid).all()) and bool(ok.all())
        for i in range(EDGES.size):
            jp, jc, jv, jok = jkv.decode_row(jnp.asarray(exp[i]))
            assert int(jc) == int(c[i]) and bool(jv) == bool(v[i])
            assert bool(jok) == bool(ok[i])
    torn = got.clone()
    torn[:, 0] ^= 1
    assert not tkv.decode_row(torn)[3].any()
