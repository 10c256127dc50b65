"""The port's remote-DMA kernels (plain PyTorch versions, which CPU tensors
take) against the JAX package's Pallas kernels run in interpret mode —
values and the measured byte counters, bitwise.  Mirrors the remote-DMA
cases of tests/test_kernels.py, stacked: the port's functions take a
leading participant dimension, and each participant's slice must equal one
call of the reference kernel.  The CUDA kernels themselves run only on the
card; chip_smoke.py holds them against these plain versions there."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import remote_dma as jrdma  # noqa: E402
from repro_torch.core.backends import DMA_DESC_BYTES  # noqa: E402
from repro_torch.kernels import remote_dma as rdma  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def test_descriptor_constants():
    assert rdma.DESC_WORDS == jrdma.DESC_WORDS == 8
    assert rdma.DESC_BYTES == jrdma.DESC_BYTES == DMA_DESC_BYTES == 32
    assert (rdma.OP_READ, rdma.OP_WRITE) == (jrdma.OP_READ, jrdma.OP_WRITE)


@pytest.mark.parametrize("P, R", [(1, 1), (1, 4), (3, 9)])
def test_build_descriptors_matches_reference(P, R):
    rng = np.random.default_rng(R)
    tg = rng.integers(0, 4, (P, R)).astype(np.int32)
    ix = rng.integers(0, 8, (P, R)).astype(np.int32)
    en = rng.integers(0, 2, (P, R)).astype(np.int32)
    wire = rng.integers(0, 2, (P, R)).astype(np.int32)
    d, nb = rdma.build_descriptors(_t(tg), _t(ix), _t(en), wire=_t(wire),
                                   op=rdma.OP_WRITE, row_nbytes=20)
    assert d.dtype == nb.dtype == torch.int32
    for p in range(P):
        dj, nbj = jrdma.build_descriptors(
            jnp.asarray(tg[p]), jnp.asarray(ix[p]), jnp.asarray(en[p]),
            wire=jnp.asarray(wire[p]), op=jrdma.OP_WRITE, row_nbytes=20)
        np.testing.assert_array_equal(d[p].numpy(), np.asarray(dj))
        assert int(nb[p]) == int(nbj) == int(wire[p].sum()) * 32


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_gather_rows_matches_reference(dtype):
    rng = np.random.default_rng(1)
    P, S, N = 2, 8, 12
    buf = rng.integers(-99, 99, (P, S, 5)).astype(dtype)
    ix = rng.integers(0, S, (P, N)).astype(np.int32)
    mask = rng.integers(0, 2, (P, N)).astype(np.int32)
    mask[1] = 0                                        # an all-masked home
    rows, nb = rdma.gather_rows(_t(buf), _t(ix), _t(mask))
    for p in range(P):
        rj, nbj = jrdma.gather_rows(jnp.asarray(buf[p]), jnp.asarray(ix[p]),
                                    jnp.asarray(mask[p]))
        np.testing.assert_array_equal(rows[p].numpy(), np.asarray(rj))
        assert int(nb[p]) == int(nbj) == int(mask[p].sum()) * 5 * 4
    assert (rows[1] == 0).all() and int(nb[1]) == 0


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scatter_rows_matches_reference_with_collisions(dtype):
    """Duplicate target rows: last writer in lane order wins, bitwise."""
    rng = np.random.default_rng(2)
    P, S, n = 3, 6, 10
    buf = rng.integers(-99, 99, (P, S, 3)).astype(dtype)
    ix = rng.integers(0, S, (P, n)).astype(np.int32)
    ix[2] = 4                                          # every lane one row
    vals = rng.integers(-99, 99, (P, n, 3)).astype(dtype)
    ap = rng.integers(0, 2, (P, n)).astype(np.int32)
    ap[2] = 1
    wire = ap * rng.integers(0, 2, (P, n)).astype(np.int32)
    out, nb = rdma.scatter_rows(_t(buf), _t(ix), _t(vals), _t(ap), _t(wire))
    for p in range(P):
        oj, nbj = jrdma.scatter_rows(jnp.asarray(buf[p]), jnp.asarray(ix[p]),
                                     jnp.asarray(vals[p]), jnp.asarray(ap[p]),
                                     jnp.asarray(wire[p]))
        np.testing.assert_array_equal(out[p].numpy(), np.asarray(oj))
        assert int(nb[p]) == int(nbj) == int(wire[p].sum()) * 3 * 4
        exp = buf[p].copy()
        for i in range(n):
            if ap[p, i]:
                exp[ix[p, i]] = vals[p, i]
        np.testing.assert_array_equal(out[p].numpy(), exp)
    np.testing.assert_array_equal(out[2, 4].numpy(), vals[2, -1])
    # the function is functional: the input buffer is untouched
    np.testing.assert_array_equal(_t(buf).numpy(), buf)


def test_scatter_rows_all_masked_is_identity():
    buf = torch.arange(24, dtype=torch.int32).reshape(2, 4, 3)
    ix = torch.zeros((2, 5), dtype=torch.int32)
    zero = torch.zeros((2, 5), dtype=torch.int32)
    vals = torch.ones((2, 5, 3), dtype=torch.int32)
    out, nb = rdma.scatter_rows(buf, ix, vals, zero, zero)
    assert torch.equal(out, buf) and nb.tolist() == [0, 0]


def test_cpu_tensors_take_the_plain_version():
    before = [k.launches for k in rdma.KERNELS]
    rdma.build_descriptors(torch.zeros((2, 3)), torch.zeros((2, 3)),
                           torch.ones((2, 3)))
    rdma.gather_rows(torch.zeros((2, 4, 5), dtype=torch.int32),
                     torch.zeros((2, 3)), torch.ones((2, 3)))
    assert [k.launches for k in rdma.KERNELS] == before


def test_other_devices_are_refused():
    """No silent fallback: a tensor that is neither on the CPU nor on one
    CUDA device is refused, never computed by the plain version."""
    meta = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        rdma.build_descriptors(meta, meta, meta)
    with pytest.raises(ValueError):
        rdma.gather_rows(torch.zeros((2, 4, 5)), meta, meta)
