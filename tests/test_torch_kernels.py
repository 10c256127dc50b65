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


MASK_DTYPES = {"int32": np.int32, "bool": np.bool_}


@pytest.mark.parametrize("wire_dtype", ["int32", "bool", None])
@pytest.mark.parametrize("en_dtype", ["int32", "bool"])
def test_build_descriptors_mask_forms_match_reference(en_dtype, wire_dtype):
    """The masks as the verbs pass them: bool (the read verb's ``leader``,
    the write verb's ``preds`` and ``remote_lane``) or int32, and ``wire``
    left to default to ``en``; bitwise the reference kernel's output."""
    rng = np.random.default_rng(7)
    P, R = 3, 13
    tg = rng.integers(0, 4, (P, R)).astype(np.int32)
    ix = rng.integers(0, 8, (P, R)).astype(np.int32)
    en = rng.integers(0, 2, (P, R)).astype(MASK_DTYPES[en_dtype])
    en[2] = 0                                  # a participant with no lane
    kw = {}
    if wire_dtype is not None:
        wire = rng.integers(0, 2, (P, R)).astype(MASK_DTYPES[wire_dtype])
        kw["wire"] = _t(wire)
    d, nb = rdma.build_descriptors(_t(tg), _t(ix), _t(en), op=rdma.OP_READ,
                                   row_nbytes=20, **kw)
    assert d.dtype == nb.dtype == torch.int32
    assert d.shape == (P, R, rdma.DESC_WORDS) and nb.shape == (P,)
    for p in range(P):
        jkw = {} if wire_dtype is None else {"wire": jnp.asarray(wire[p])}
        dj, nbj = jrdma.build_descriptors(
            jnp.asarray(tg[p]), jnp.asarray(ix[p]), jnp.asarray(en[p]),
            op=jrdma.OP_READ, row_nbytes=20, **jkw)
        np.testing.assert_array_equal(d[p].numpy(), np.asarray(dj))
        on = en[p] if wire_dtype is None else wire[p]
        assert int(nb[p]) == int(nbj) == int((on != 0).sum()) * 32
    if wire_dtype is None:
        assert int(nb[2]) == 0


@pytest.mark.parametrize("layout", ["contiguous", "broadcast"])
@pytest.mark.parametrize("mask_dtype", ["int32", "bool"])
def test_gather_rows_argument_forms_match_reference(mask_dtype, layout):
    """The index and mask as the read verb passes them: one (N,) index
    vector broadcast to every home with ``expand`` (row stride 0) or a
    contiguous (P, N) index, and a bool or int32 mask with an all-masked
    home; bitwise the reference kernel's output for every home."""
    rng = np.random.default_rng(3)
    P, S, N = 3, 8, 12
    buf = rng.integers(-99, 99, (P, S, 5)).astype(np.int32)
    if layout == "broadcast":
        vec = rng.integers(0, S, (N,)).astype(np.int32)
        ix_t = _t(vec)[None, :].expand(P, -1)
        ix = np.broadcast_to(vec, (P, N))
        assert ix_t.stride() == (0, 1)
    else:
        ix = rng.integers(0, S, (P, N)).astype(np.int32)
        ix_t = _t(ix)
    mask = rng.integers(0, 2, (P, N)).astype(MASK_DTYPES[mask_dtype])
    mask[1] = 0                                        # an all-masked home
    rows, nb = rdma.gather_rows(_t(buf), ix_t, _t(mask))
    assert rows.shape == (P, N, 5) and nb.dtype == torch.int32
    for p in range(P):
        rj, nbj = jrdma.gather_rows(jnp.asarray(buf[p]), jnp.asarray(ix[p]),
                                    jnp.asarray(mask[p]))
        np.testing.assert_array_equal(rows[p].numpy(), np.asarray(rj))
        assert int(nb[p]) == int(nbj) == int((mask[p] != 0).sum()) * 5 * 4
    assert (rows[1] == 0).all() and int(nb[1]) == 0


@pytest.mark.parametrize("kernel", ["build_descriptors", "gather_rows",
                                    "scatter_rows"])
def test_wrappers_neither_mutate_nor_keep_their_inputs(kernel):
    """The wrappers take bool masks and broadcast indices as they are: the
    inputs come back unchanged, the outputs share no memory with them, and
    nothing keeps a reference to them after the call."""
    import weakref
    rng = np.random.default_rng(11)
    P, S, N = 2, 6, 7
    if kernel == "build_descriptors":
        args = [_t(rng.integers(0, 4, (P, N)).astype(np.int32)),
                _t(rng.integers(0, 8, (P, N)).astype(np.int32)),
                _t(rng.integers(0, 2, (P, N)).astype(bool))]
        kw = {"wire": _t(rng.integers(0, 2, (P, N)).astype(bool)),
              "op": rdma.OP_WRITE, "row_nbytes": 12}
        fn = rdma.build_descriptors
    else:
        args = [_t(rng.integers(-9, 9, (P, S, 3)).astype(np.int32)),
                _t(rng.integers(0, S, (N,)).astype(np.int32))[None].expand(
                    P, -1),
                _t(rng.integers(0, 2, (P, N)).astype(bool))]
        kw = {}
        fn = rdma.gather_rows
    if kernel == "scatter_rows":
        apply = rng.integers(0, 2, (P, N)).astype(bool)
        args = args[:2] + [
            _t(rng.integers(-9, 9, (P, N, 3)).astype(np.int32)), _t(apply),
            _t(apply & rng.integers(0, 2, (P, N)).astype(bool))]
        fn = rdma.scatter_rows
    inputs = args + [kw[k] for k in ("wire",) if k in kw]
    before = [(x.clone(), x.stride()) for x in inputs]
    outs = fn(*args, **kw)
    for x, (b, stride) in zip(inputs, before):
        assert torch.equal(x, b) and x.dtype == b.dtype
        assert x.stride() == stride
    in_storage = {x.untyped_storage().data_ptr() for x in inputs}
    assert not in_storage & {o.untyped_storage().data_ptr() for o in outs}
    refs = [weakref.ref(x) for x in inputs]
    del args, kw, inputs, x, outs
    assert all(r() is None for r in refs)


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


@pytest.mark.parametrize("case", ["one row", "random duplicates",
                                  "all masked", "1-word rows"])
def test_scatter_rows_write_verb_forms_match_reference(case):
    """The arguments as the write verb passes them: one (N,) index vector
    broadcast to every home with ``expand`` (row stride 0), bool apply and
    wire masks.  Every lane on one row, random duplicates, every lane
    masked, and rows one word wide; bitwise the reference kernel's output
    (interpret mode) and its plain version's for every home."""
    rng = np.random.default_rng(5)
    P, S, N = 3, 9, 14
    width = 1 if case == "1-word rows" else 5
    buf = rng.integers(-99, 99, (P, S, width)).astype(np.int32)
    vec = {"one row": np.full((N,), 4),
           "all masked": rng.integers(0, S, (N,))}.get(
               case, rng.integers(0, 3, (N,))).astype(np.int32)
    ix_t = _t(vec)[None, :].expand(P, -1)
    assert ix_t.stride() == (0, 1)
    vals = rng.integers(-99, 99, (P, N, width)).astype(np.int32)
    ap = rng.integers(0, 2, (P, N)).astype(bool)
    if case == "all masked":
        ap[:] = False
    wire = ap & rng.integers(0, 2, (P, N)).astype(bool)
    out, nb = rdma.scatter_rows(_t(buf), ix_t, _t(vals), _t(ap), _t(wire))
    assert out.shape == (P, S, width) and nb.dtype == torch.int32
    for p in range(P):
        args = [jnp.asarray(x) for x in (buf[p], vec, vals[p], ap[p],
                                         wire[p])]
        for force_ref in (False, True):
            oj, nbj = jrdma.scatter_rows(*args, force_ref=force_ref)
            np.testing.assert_array_equal(out[p].numpy(), np.asarray(oj))
            assert int(nb[p]) == int(nbj) == int(wire[p].sum()) * width * 4
    if case == "all masked":
        np.testing.assert_array_equal(out.numpy(), buf)
    if case == "one row":
        for p in range(P):
            if ap[p].any():
                last = np.flatnonzero(ap[p])[-1]
                np.testing.assert_array_equal(out[p, 4].numpy(),
                                              vals[p, last])


def test_scatter_rows_all_masked_is_identity():
    buf = torch.arange(24, dtype=torch.int32).reshape(2, 4, 3)
    ix = torch.zeros((2, 5), dtype=torch.int32)
    zero = torch.zeros((2, 5), dtype=torch.int32)
    vals = torch.ones((2, 5, 3), dtype=torch.int32)
    out, nb = rdma.scatter_rows(buf, ix, vals, zero, zero)
    assert torch.equal(out, buf) and nb.tolist() == [0, 0]


@pytest.mark.parametrize("case", ["outside only", "mixed"])
def test_scatter_rows_indices_outside_the_buffer_match_reference(case):
    """Lanes at -1, -slots, slots and slots + 3 (and -slots - 1): the
    reference's oracle wraps an index in [-slots, 0) and drops every other
    one outside the buffer, and so does the plain version, bitwise.  The
    in-range lanes of the mixed case avoid the rows the negative lanes wrap
    to: the reference elects its winner on the raw index, so one row named
    both as -1 and as slots - 1 has no defined order there."""
    rng = np.random.default_rng(7)
    P, S, width = 2, 6, 5
    odd = [-1, -S, S, S + 3, -S - 1]
    ix = np.tile(np.asarray(odd * 2, np.int32), (P, 1))
    if case == "mixed":
        inner = rng.integers(1, S - 1, (P, 6)).astype(np.int32)
        ix = np.concatenate([ix, inner, ix[:, :4]], axis=1)
    n = ix.shape[1]
    buf = rng.integers(-99, 99, (P, S, width)).astype(np.int32)
    vals = rng.integers(-99, 99, (P, n, width)).astype(np.int32)
    ap = rng.integers(0, 2, (P, n)).astype(bool)
    ap[:, :len(odd)] = True
    wire = ap & rng.integers(0, 2, (P, n)).astype(bool)
    out, nb = rdma.scatter_rows(_t(buf), _t(ix), _t(vals), _t(ap), _t(wire))
    for p in range(P):
        oj, nbj = jrdma._scatter_ref(
            *(jnp.asarray(x) for x in (buf[p], ix[p], vals[p], ap[p],
                                       wire[p])), width * 4)
        np.testing.assert_array_equal(out[p].numpy(), np.asarray(oj))
        assert int(nb[p]) == int(nbj)
    # the wrapped lanes landed: the last applied lane on row S - 1 wins
    for p in range(P):
        last = max(i for i in range(n) if ap[p, i] and ix[p, i] == -1)
        np.testing.assert_array_equal(out[p, S - 1].numpy(), vals[p, last])


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
