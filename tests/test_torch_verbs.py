"""The port's one-sided verbs and the primitives the KVStore is built from,
stacked, against the JAX package under ``Runtime.run`` (vmap binding): the
batched read (coalesced and not) and write on every backend, including the
remote-DMA kernels, with duplicate lanes, self lanes, disabled lanes and
write collisions; then the stacked collectives, the windowed
fetch-and-add, the ticket-lock array and the SST acknowledgement push.  Values, new buffers and traffic-ledger
rows (modeled bytes, rounds, DMA-measured bytes) must be equal exactly."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import locked_ledger, reference_core  # noqa: E402

import repro_torch.core as pt  # noqa: E402
from repro_torch.core.u32 import as_u32  # noqa: E402

P, SLOTS, ITEM, R = 4, 6, 4, 7
BACKENDS = ["onesided", "active_message", "pallas"]


@pytest.fixture(scope="module")
def core():
    return reference_core()


class _Regions:
    """One region per package on one backend; ledgers enabled."""

    def __init__(self, core, backend):
        self.jmgr = core.make_manager(P, backend=backend)
        locked_ledger(self.jmgr)
        self.jrg = core.SharedRegion(None, "rg", self.jmgr, slots=SLOTS,
                                     item_shape=(ITEM,), dtype=jnp.int32)
        self.tmgr = pt.make_manager(P, device="cpu", backend=backend)
        self.tmgr.traffic.enable()
        self.trg = pt.SharedRegion(None, "rg", self.tmgr, slots=SLOTS,
                                   item_shape=(ITEM,), dtype=torch.int32)

    def assert_ledgers_equal(self):
        jax.effects_barrier()
        jl, tl = self.jmgr.traffic, self.tmgr.traffic
        assert jl.summary() == tl.summary()
        assert jl.rounds_summary() == tl.rounds_summary()
        assert jl.dma_summary() == tl.dma_summary()


def _lanes(seed):
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2 ** 31, 2 ** 31, (P, SLOTS, ITEM),
                       dtype=np.int64).astype(np.int32)
    tg = rng.integers(0, P, (P, R)).astype(np.int32)
    ix = rng.integers(0, SLOTS, (P, R)).astype(np.int32)
    tg[:, -3:] = tg[:, -3:-2]                    # duplicate (target, index)
    ix[:, -3:] = ix[:, -3:-2]
    tg[0] = 0                                    # participant 0: self lanes
    preds = rng.random((P, R)) < 0.8
    vals = rng.integers(-99, 99, (P, R, ITEM)).astype(np.int32)
    return buf, tg, ix, preds, vals


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_read_batch_matches_reference(core, backend, coalesce):
    rg = _Regions(core, backend)
    buf, tg, ix, preds, _ = _lanes(3)
    jread = jax.jit(lambda s, t, i, p: rg.jmgr.runtime.run(
        lambda st, tt, ii, pp: rg.jrg.read_batch(st, tt, ii, preds=pp,
                                                 coalesce=coalesce)[0],
        s, t, i, p))
    exp = np.asarray(jread(core.SharedRegionState(buf=jnp.asarray(buf)),
                           tg, ix, preds))
    got, _ack = rg.trg.read_batch(pt.SharedRegionState(
        buf=torch.from_numpy(buf)), torch.from_numpy(tg),
        torch.from_numpy(ix), preds=torch.from_numpy(preds),
        coalesce=coalesce)
    np.testing.assert_array_equal(got.numpy(), exp)
    rg.assert_ledgers_equal()


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_write_batch_matches_reference(core, backend, unique):
    rg = _Regions(core, backend)
    buf, tg, ix, preds, vals = _lanes(4)
    if unique:      # distinct rows per home: lane (p, r) writes row r at p+1
        tg = np.broadcast_to((np.arange(P)[:, None] + 1) % P, (P, R)).copy()
        ix = np.broadcast_to(np.arange(R) % SLOTS, (P, R)).copy()
        preds[:, SLOTS:] = False
    jwrite = jax.jit(lambda s, t, i, v, p: rg.jmgr.runtime.run(
        lambda st, tt, ii, vv, pp: rg.jrg.write_batch(
            st, tt, ii, vv, preds=pp, assume_unique=unique)[0].buf,
        s, t, i, v, p))
    exp = np.asarray(jwrite(core.SharedRegionState(buf=jnp.asarray(buf)),
                            tg, ix, vals, preds))
    got, _ack = rg.trg.write_batch(
        pt.SharedRegionState(buf=torch.from_numpy(buf)),
        torch.from_numpy(tg), torch.from_numpy(ix), torch.from_numpy(vals),
        preds=torch.from_numpy(preds), assume_unique=unique)
    np.testing.assert_array_equal(got.buf.numpy(), exp)
    assert not np.array_equal(exp, buf)
    rg.assert_ledgers_equal()


def test_local_write_batch_matches_reference(core):
    rg = _Regions(core, "onesided")
    buf, _tg, _ix, preds, vals = _lanes(5)
    ix = np.broadcast_to(np.array([5, 0, 3, 1, 4, 2, 9]), (P, R)).copy()
    jw = jax.jit(lambda s, i, v, p: rg.jmgr.runtime.run(
        lambda st, ii, vv, pp: rg.jrg.local_write_batch(st, ii, vv, pp).buf,
        s, i, v, p))
    exp = np.asarray(jw(core.SharedRegionState(buf=jnp.asarray(buf)), ix,
                        vals, preds))
    got = rg.trg.local_write_batch(
        pt.SharedRegionState(buf=torch.from_numpy(buf)),
        torch.from_numpy(ix), torch.from_numpy(vals),
        torch.from_numpy(preds)).buf
    np.testing.assert_array_equal(got.numpy(), exp)


def test_collectives_match_reference(core):
    """The stacked collectives: bcast_from, the all-gather, prefix_sums
    and window_prefix, against the reference's under vmap."""
    colls = core.colls
    rng = np.random.default_rng(8)
    x = rng.integers(-50, 50, (P,)).astype(np.int32)
    xb = rng.integers(-50, 50, (P, R)).astype(np.int32)
    run = core.make_manager(P).runtime.run
    jb = run(lambda v: colls.bcast_from(v, 2, "nodes"), x)
    jg = run(lambda v: colls.gather_rows(v, "nodes"), x)
    je, jt, _ = run(lambda v: colls.prefix_sums(v, "nodes"), x)
    jwe, jwt = run(lambda v: colls.window_prefix(v, "nodes"), xb)
    tc = pt.colls
    np.testing.assert_array_equal(tc.bcast_from(torch.from_numpy(x), 2),
                                  np.asarray(jb))
    np.testing.assert_array_equal(tc.gather_rows(torch.from_numpy(x)),
                                  np.asarray(jg))
    te, tt, _ = tc.prefix_sums(torch.from_numpy(x))
    np.testing.assert_array_equal(te, np.asarray(je))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    twe, twt = tc.window_prefix(torch.from_numpy(xb))
    np.testing.assert_array_equal(twe, np.asarray(jwe))
    np.testing.assert_array_equal(twt, np.asarray(jwt))


def test_fetch_add_window_matches_reference(core):
    jmgr, tmgr = core.make_manager(P), pt.make_manager(P, device="cpu")
    jv = core.AtomicVar(None, "ctr", jmgr, host=2)
    tv = pt.AtomicVar(None, "ctr", tmgr, host=2)
    rng = np.random.default_rng(6)
    amt = rng.integers(0, 9, (P, R)).astype(np.int32)
    preds = rng.random((P, R)) < 0.7
    f = jax.jit(lambda s, a, p: jmgr.runtime.run(
        lambda st, aa, pp: jv.fetch_add_window(st, aa, pp)[:2], s, a, p))
    (jst, jold) = f(jv.init_state(5), amt, preds)
    tst, told, _ack = tv.fetch_add_window(tv.init_state(5),
                                          torch.from_numpy(amt),
                                          torch.from_numpy(preds))
    np.testing.assert_array_equal(told.numpy(), np.asarray(jold))
    np.testing.assert_array_equal(tst.official.numpy(),
                                  np.asarray(jst.official))


def test_ticket_lock_array_window_matches_reference(core):
    jmgr, tmgr = core.make_manager(P), pt.make_manager(P, device="cpu")
    jl = core.TicketLockArray(None, "locks", jmgr, num_locks=5)
    tl = pt.TicketLockArray(None, "locks", tmgr, num_locks=5)
    rng = np.random.default_rng(7)
    acq = jax.jit(lambda s, i, w: jmgr.runtime.run(jl.acquire_window, s, i, w))
    rel = jax.jit(lambda s, i, h: jmgr.runtime.run(jl.release_window, s, i, h))
    jst, tst = jl.init_state(), tl.init_state()
    for _ in range(3):
        ids = rng.integers(0, 5, (P, R)).astype(np.int32)
        want = rng.random((P, R)) < 0.6
        jst, jtix = acq(jst, ids, want)
        tst, ttix = tl.acquire_window(tst, torch.from_numpy(ids),
                                      torch.from_numpy(want))
        np.testing.assert_array_equal(ttix.numpy().astype(np.uint32),
                                      np.asarray(jtix))
        jst = rel(jst, ids, want)
        tst = tl.release_window(tst, torch.from_numpy(ids),
                                torch.from_numpy(want))
        for a, b in zip(jst, tst):
            np.testing.assert_array_equal(b.numpy().astype(np.uint32),
                                          np.asarray(a))


def test_sst_push_accumulate_matches_reference(core):
    jmgr, tmgr = core.make_manager(P), pt.make_manager(P, device="cpu")
    js = core.SST(None, "acks", jmgr, shape=(), dtype=jnp.uint32)
    ts = pt.SST(None, "acks", tmgr)
    push = jax.jit(lambda s, d: jmgr.runtime.run(
        lambda st, dd: js.push_accumulate(st, dd)[0], s, d))
    jst, tst = js.init_state(), ts.init_state()
    for delta in (3, 2 ** 32 - 2, 7):        # the second wraps around
        d = np.full((P,), delta, np.uint32)
        jst = push(jst, d)
        tst, _ack = ts.push_accumulate(tst, as_u32(d))
        for a, b in zip(jst, tst):
            np.testing.assert_array_equal(b.numpy().astype(np.uint32),
                                          np.asarray(a))
