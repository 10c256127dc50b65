"""The paper's channel objects' scalar verbs in the port against the JAX
package, bitwise: OwnedVar, AtomicVar, Barrier, SharedRegion (on all three
backends), TicketLock and the lock stripe's single-request forms, the
manager's fences, and the shared queue's scalar reference paths.  Each
reference function runs through ``mgr.runtime.run`` on the same seeded
numpy inputs as its port counterpart; every state leaf and output must be
equal bit for bit (uint32 words through the port's int64 holders), and so
must the traffic-ledger rows.  The checks of ``tests/test_channels.py``'s
classes are repeated on the port's results."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_ref import (ledger_rows, locked_ledger,  # noqa: E402
                            reference_core)

import torch  # noqa: E402

import repro_torch.core as pt  # noqa: E402

P = 4
BACKENDS = ["onesided", "active_message", "pallas"]


def _flat(x):
    """Numpy leaves of a (nested) tuple tree of JAX arrays or port tensors,
    the port's int64 uint32 holders back as uint32."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _flat(v)]
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return [(a & 0xFFFFFFFF).astype(np.uint32) if a.dtype == np.int64
                else a]
    return [np.asarray(x)]


def assert_same(ref, port, what=""):
    a, b = _flat(ref), _flat(port)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, f"{what} leaf {i}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


class _Pair:
    """A reference manager (ledger on, vmap binding) and a port manager on
    the CPU, same P and backend."""

    def __init__(self, backend="onesided"):
        self.core = reference_core()
        self.jmgr = self.core.make_manager(P, backend=backend)
        locked_ledger(self.jmgr)
        self.tmgr = pt.make_manager(P, device="cpu", backend=backend)
        self.tmgr.traffic.enable()

    def jit(self, fn):
        """``fn`` under the reference's runtime, jitted.  Each trace runs
        in a tracking scope of its own: the reference keeps the ack keys
        tracked outside one, and a later trace's fence would join those
        of an earlier trace."""
        def prog(*a):
            with self.jmgr.tracking():
                return self.jmgr.runtime.run(fn, *a)
        return jax.jit(prog)

    def jrun(self, fn, *args):
        return self.jit(fn)(*args)

    def assert_ledgers_equal(self):
        jax.effects_barrier()
        assert ledger_rows(self.jmgr.traffic) == \
            ledger_rows(self.tmgr.traffic)


def _me(mgr):
    return mgr.runtime.my_id()


# ---------------------------------------------------------------- owned_var
class TestOwnedVar:
    def test_push_makes_value_visible_everywhere(self):
        m = _Pair()
        v = np.random.default_rng(1).standard_normal(3).astype(np.float32)
        jov = m.core.OwnedVar(None, "v", m.jmgr, owner=2, shape=(3,),
                              dtype=jnp.float32)
        tov = pt.OwnedVar(None, "v", m.tmgr, owner=2, shape=(3,),
                          dtype=torch.float32)

        def jprog(st):
            st = jov.store_mine(st, v, pred=_me(m.jmgr) == 2)
            st, _ack = jov.push(st)
            return (st,) + jov.load(st)

        st = tov.store_mine(tov.init_state(), torch.from_numpy(v),
                            pred=_me(m.tmgr) == 2)
        st, _ack = tov.push(st)
        tout = (st,) + tov.load(st)
        assert_same(m.jrun(jprog, jov.init_state()), tout)
        np.testing.assert_array_equal(tout[1].numpy(), np.tile(v, (P, 1)))
        assert tout[2].all()

    def test_pull_refreshes_readers(self):
        m = _Pair()
        jov = m.core.OwnedVar(None, "v", m.jmgr, owner=0, shape=(),
                              dtype=jnp.int32)
        tov = pt.OwnedVar(None, "v", m.tmgr, owner=0, shape=(),
                          dtype=torch.int32)

        def jprog(st):
            st = jov.store_mine(st, jnp.int32(42), pred=_me(m.jmgr) == 0)
            stale = st.cached
            st, _ = jov.pull(st)
            return st, stale

        st = tov.store_mine(tov.init_state(), 42, pred=_me(m.tmgr) == 0)
        stale = st.cached
        st, _ = tov.pull(st)
        assert_same(m.jrun(jprog, jov.init_state()), (st, stale))
        assert stale[0] == 42 and (stale[1:] == 0).all()
        assert (st.cached == 42).all()

    def test_checksum_detects_torn_value(self):
        m = _Pair()
        rng = np.random.default_rng(2)
        init = rng.integers(-2 ** 31, 2 ** 31, 4).astype(np.int32)
        jov = m.core.OwnedVar(None, "v", m.jmgr, owner=0, shape=(4,),
                              dtype=jnp.int32)
        tov = pt.OwnedVar(None, "v", m.tmgr, owner=0, shape=(4,),
                          dtype=torch.int32)
        jst, tst = jov.init_state(init), tov.init_state(init)
        assert_same(jst, tst, "init")
        buf = np.asarray(jst.cached).copy()
        buf[1, 2] = 999                                 # a torn copy at 1
        jst = jst._replace(cached=jnp.asarray(buf))
        tst = tst._replace(cached=torch.from_numpy(buf))
        tout = tov.load(tst)
        assert_same(m.jrun(jov.load, jst), tout)
        assert not tout[1][1] and tout[1][0] and tout[1][2:].all()


# ---------------------------------------------------------------- atomic_var
class TestAtomicVar:
    def _pair(self, dtype, host=1, init=100):
        m = _Pair()
        jdt, tdt = {"int32": (jnp.int32, torch.int32),
                    "uint32": (jnp.uint32, torch.uint32)}[dtype]
        jav = m.core.AtomicVar(None, "a", m.jmgr, host=host, dtype=jdt)
        tav = pt.AtomicVar(None, "a", m.tmgr, host=host, dtype=tdt)
        return m, jav, tav, jav.init_state(init), tav.init_state(init)

    def test_concurrent_fetch_add_serializes_in_participant_order(self):
        m, jav, tav, jst, tst = self._pair("int32")

        def jprog(st):
            st, old, _ = jav.fetch_add(st, _me(m.jmgr) + 1, pred=True)
            return st, old, jav.load_cached(st)

        st, old, _ = tav.fetch_add(tst, _me(m.tmgr) + 1, pred=True)
        assert_same(m.jrun(jprog, jst), (st, old, tav.load_cached(st)))
        np.testing.assert_array_equal(old.numpy(), [100, 101, 103, 106])
        np.testing.assert_array_equal(st.cached.numpy(), [110] * P)

    def test_fetch_add_respects_pred(self):
        m, jav, tav, jst, tst = self._pair("int32", host=0, init=0)

        def jprog(st):
            st, old, _ = jav.fetch_add(st, 5, pred=(_me(m.jmgr) % 2) == 0)
            return st, old

        st, old, _ = tav.fetch_add(tst, 5, pred=(_me(m.tmgr) % 2) == 0)
        assert_same(m.jrun(jprog, jst), (st, old))
        np.testing.assert_array_equal(old.numpy(), [0, 0, 5, 0])
        np.testing.assert_array_equal(st.official.numpy(), [10] * P)

    def test_cas_lowest_contender_wins(self):
        m, jav, tav, jst, tst = self._pair("int32", host=0, init=7)

        def jprog(st):
            me = _me(m.jmgr)
            st, old, ok, _ = jav.compare_swap(st, 7, 100 + me, pred=me >= 1)
            return st, old, ok

        me = _me(m.tmgr)
        st, old, ok, _ = tav.compare_swap(tst, 7, 100 + me, pred=me >= 1)
        assert_same(m.jrun(jprog, jst), (st, old, ok))
        np.testing.assert_array_equal(ok.numpy(), [False, True, False, False])
        np.testing.assert_array_equal(st.official.numpy(), [101] * P)

    @pytest.mark.parametrize("dtype", ["int32", "uint32"])
    def test_random_rounds_bitwise(self, dtype):
        """fetch_add, compare_swap, store, pull and load_cached on seeded
        words near the wrap, round after round."""
        m, jav, tav, jst, tst = self._pair(dtype, host=2, init=2 ** 31 - 3)
        rng = np.random.default_rng(7 if dtype == "int32" else 8)
        jnp_dt = jnp.int32 if dtype == "int32" else jnp.uint32

        def jround(st, amt, p_add, exp, des, p_cas, val, p_st):
            st, old, _ = jav.fetch_add(st, amt.astype(jnp_dt), pred=p_add)
            st2, old2, ok, _ = jav.compare_swap(
                st, exp.astype(jnp_dt), des.astype(jnp_dt), pred=p_cas)
            st3, _ = jav.store(st2, val.astype(jnp_dt), pred=p_st)
            st4 = st3._replace(cached=jnp.zeros_like(st3.cached))
            st4, _ = jav.pull(st4)
            return st, old, st2, old2, ok, st3, st4, jav.load_cached(st4)

        jstep = m.jit(jround)
        for _ in range(6):
            amt = rng.integers(0, 2 ** 31, P).astype(np.int64)
            old_official = np.asarray(jst.official)[0].astype(np.int64)
            # half the expectations match the value after the adds
            exp = np.where(rng.random(P) < .5, rng.integers(0, 2 ** 31, P),
                           old_official)
            des = rng.integers(0, 2 ** 31, P)
            val = rng.integers(0, 2 ** 31, P)
            preds = [rng.random(P) < .6 for _ in range(3)]
            args = [amt, preds[0], exp, des, preds[1], val, preds[2]]
            jout = jstep(jst, *[np.asarray(a, np.int32) if a.dtype != bool
                                else a for a in args])
            st, old, _ = tav.fetch_add(tst, torch.from_numpy(amt),
                                       pred=torch.from_numpy(preds[0]))
            st2, old2, ok, _ = tav.compare_swap(
                st, torch.from_numpy(exp), torch.from_numpy(des),
                pred=torch.from_numpy(preds[1]))
            st3, _ = tav.store(st2, torch.from_numpy(val),
                               pred=torch.from_numpy(preds[2]))
            st4 = st3._replace(cached=torch.zeros_like(st3.cached))
            st4, _ = tav.pull(st4)
            assert_same(jout, (st, old, st2, old2, ok, st3, st4,
                               tav.load_cached(st4)), dtype)
            jst, tst = jout[5], st3


# ---------------------------------------------------------------- barrier
class TestBarrier:
    @pytest.mark.parametrize("crossings", [1, 2, 5])
    def test_all_participants_advance_together(self, crossings):
        m = _Pair()
        jbar = m.core.Barrier(None, "bar", m.jmgr)
        tbar = pt.Barrier(None, "bar", m.tmgr)

        def jprog(st):
            for _ in range(crossings):
                st = jbar.wait(st)
            return st

        st = tbar.init_state()
        for _ in range(crossings):
            st = tbar.wait(st)
        assert_same(m.jrun(jprog, jbar.init_state()), st)
        np.testing.assert_array_equal(st.count.numpy(), [crossings] * P)
        assert (st.sst.cached >= crossings).all()

    def test_stale_rows_are_pulled_again(self):
        """Rows of peers left behind in some participants' tables: the
        wait pulls until every row caught up, as the reference's loop
        does."""
        m = _Pair()
        jbar = m.core.Barrier(None, "bar", m.jmgr)
        tbar = pt.Barrier(None, "bar", m.tmgr)
        jst = m.jrun(jbar.wait, jbar.init_state())
        tst = tbar.wait(tbar.init_state())
        cached = np.asarray(jst.sst.cached).copy()
        cached[1, 2] = cached[3, 0] = 0       # stale views at 1 and 3
        jst = jst._replace(sst=jst.sst._replace(cached=jnp.asarray(cached)))
        tst = tst._replace(sst=tst.sst._replace(
            cached=torch.from_numpy(cached.astype(np.int64))))
        tout = tbar.wait(tst)
        assert_same(m.jrun(jbar.wait, jst), tout)
        np.testing.assert_array_equal(tout.count.numpy(), [2] * P)

    def test_expect_num_mismatch_raises(self):
        mgr = pt.make_manager(P, device="cpu")
        with pytest.raises(ValueError, match="join would never complete"):
            pt.Barrier(None, "bar", mgr, expect_num=P + 1)


# -------------------------------------------------------------- shared_region
@pytest.mark.parametrize("backend", BACKENDS)
class TestSharedRegion:
    def _pair(self, backend, slots, item_shape, jdt, tdt, buf=None):
        m = _Pair(backend)
        jreg = m.core.SharedRegion(None, "r", m.jmgr, slots=slots,
                                   item_shape=item_shape, dtype=jdt)
        treg = pt.SharedRegion(None, "r", m.tmgr, slots=slots,
                               item_shape=item_shape, dtype=tdt)
        jst, tst = jreg.init_state(), treg.init_state()
        if buf is not None:
            jst = jst._replace(buf=jnp.asarray(buf))
            tst = tst._replace(buf=torch.from_numpy(buf))
        return m, jreg, treg, jst, tst

    def test_remote_read_ring(self, backend):
        buf = np.zeros((P, 3, 2), np.float32)
        for p in range(P):
            buf[p, 1] = [p, p + 0.5]
        m, jreg, treg, jst, tst = self._pair(backend, 3, (2,), jnp.float32,
                                             torch.float32, buf)

        def jprog(st):
            val, _ack = jreg.read(st, (_me(m.jmgr) + 1) % P, 1)
            return val

        val, _ack = treg.read(tst, (_me(m.tmgr) + 1) % P, 1)
        assert_same(m.jrun(jprog, jst), val)
        for p in range(P):
            np.testing.assert_array_equal(val[p].numpy(),
                                          [(p + 1) % P, (p + 1) % P + 0.5])
        m.assert_ledgers_equal()

    def test_remote_write_lands_at_target(self, backend):
        m, jreg, treg, jst, tst = self._pair(backend, P, (), jnp.int32,
                                             torch.int32)

        def jprog(st):
            me = _me(m.jmgr)
            st, _ack = jreg.write(st, (me + 1) % P, me, 100 + me)
            return st

        me = _me(m.tmgr)
        st, _ack = treg.write(tst, (me + 1) % P, me, 100 + me)
        assert_same(m.jrun(jprog, jst), st)
        for writer in range(P):
            assert st.buf[(writer + 1) % P, writer] == 100 + writer
        m.assert_ledgers_equal()

    def test_random_scalar_verbs_bitwise(self, backend):
        """Seeded reads and writes with self lanes, disabled lanes, racy
        writes to one row (the highest id lands last) and indices off the
        buffer (clamped), then the local verbs."""
        rng = np.random.default_rng(17)
        S = 5
        buf = rng.integers(-2 ** 31, 2 ** 31, (P, S, 3)).astype(np.int32)
        m, jreg, treg, jst, tst = self._pair(backend, S, (3,), jnp.int32,
                                             torch.int32, buf)

        def jprog(st, t, i, v, pw, pr, li, lv, lp):
            st, _ = jreg.write(st, t, i, v, pred=pw)
            got, _ = jreg.read(st, i % P, t, pred=pr)
            st2 = jreg.local_write(st, li, lv, pred=lp)
            return st, got, st2, jreg.local_read(st2, li)

        jstep = m.jit(jprog)
        for rnd in range(5):
            t = rng.integers(0, P, P).astype(np.int32)
            i = rng.integers(-1, S + 1, P).astype(np.int32)
            if rnd % 2:
                t[:], i[:] = t[0], i[0]       # every writer on one row
            v = rng.integers(-2 ** 31, 2 ** 31, (P, 3)).astype(np.int32)
            pw, pr, lp = (rng.random(P) < .7 for _ in range(3))
            li = rng.integers(0, S, P).astype(np.int32)
            lv = rng.integers(-2 ** 31, 2 ** 31, (P, 3)).astype(np.int32)
            jout = jstep(jst, t, i, v, pw, pr, li, lv, lp)
            T = [torch.from_numpy(a) for a in (t, i, v, pw, pr, li, lv, lp)]
            st, _ = treg.write(tst, T[0], T[1], T[2], pred=T[3])
            got, _ = treg.read(st, T[1] % P, T[0], pred=T[4])
            st2 = treg.local_write(st, T[5], T[6], pred=T[7])
            tout = (st, got, st2, treg.local_read(st2, T[5]))
            assert_same(jout, tout, f"round {rnd}")
            if rnd % 2 and pw.any():
                last = int(np.flatnonzero(pw)[-1])
                row = int(np.clip(i[0], 0, S - 1))
                np.testing.assert_array_equal(st.buf[t[0], row].numpy(),
                                              v[last])
            jst, tst = jout[2], st2
        m.assert_ledgers_equal()

    def test_batch_read_write_roundtrip(self, backend):
        m, jreg, treg, jst, tst = self._pair(backend, 4, (), jnp.int32,
                                             torch.int32)

        def jprog(st):
            me = _me(m.jmgr)
            tgts = jnp.stack([(me + 1) % P, (me + 2) % P]).astype(jnp.int32)
            idxs = jnp.array([0, 1], jnp.int32)
            st, _ = jreg.write_batch(st, tgts, idxs,
                                     jnp.stack([10 * me, 10 * me + 1]))
            got, _ = jreg.read_batch(st, tgts, idxs)
            return st, got

        me = _me(m.tmgr)
        tgts = torch.stack([(me + 1) % P, (me + 2) % P], 1).to(torch.int32)
        idxs = torch.tensor([0, 1], dtype=torch.int32).expand(P, 2)
        st, _ = treg.write_batch(tst, tgts, idxs,
                                 torch.stack([10 * me, 10 * me + 1], 1))
        got, _ = treg.read_batch(st, tgts, idxs)
        assert_same(m.jrun(jprog, jst), (st, got))
        for p in range(P):
            np.testing.assert_array_equal(got[p].numpy(), [10 * p, 10 * p + 1])
        m.assert_ledgers_equal()


# ---------------------------------------------------------------- ticket lock
class TestTicketLock:
    def test_fifo_service_and_mutual_exclusion(self):
        m = _Pair()
        jlk = m.core.TicketLock(None, "l", m.jmgr, host=0)
        tlk = pt.TicketLock(None, "l", m.tmgr, host=0)

        def jprog(st):
            st, ticket = jlk.acquire(st, want=True)
            log = []
            for _round in range(P):
                holds = jlk.holds(st, ticket)
                log.append(holds)
                st = jlk.release(st, holds, fence_scope=pt.FenceScope.PAIR)
            return st, ticket, jnp.stack(log)

        st, ticket = tlk.acquire(tlk.init_state(), want=True)
        log = []
        for _round in range(P):
            holds = tlk.holds(st, ticket)
            log.append(holds)
            st = tlk.release(st, holds, fence_scope=pt.FenceScope.PAIR)
        tout = (st, ticket, torch.stack(log, 1))
        assert_same(m.jrun(jprog, jlk.init_state()), tout)
        assert sorted(ticket.tolist()) == list(range(P))
        for rnd in range(P):
            holders = torch.nonzero(tout[2][:, rnd]).flatten().tolist()
            assert len(holders) == 1 and ticket[holders[0]] == rnd
        assert m.tmgr.fence_counts[pt.FenceScope.PAIR] == P

    def test_contended_rounds_with_refresh(self):
        """bench_lock.py's single-lock round: every participant without a
        ticket asks for one, the holder releases (global fence), and every
        participant re-pulls its cached now_serving."""
        m = _Pair()
        jlk = m.core.TicketLock(None, "single", m.jmgr)
        tlk = pt.TicketLock(None, "single", m.tmgr)
        nt = np.uint32(pt.NO_TICKET)
        rng = np.random.default_rng(5)

        def jprog(st, t, want):
            st, t2 = jlk.acquire(st, want=(t == nt) & want)
            t = jnp.where(t == nt, t2, t)
            holds = jlk.holds(st, t)
            st = jlk.refresh(jlk.release(st, holds))
            return st, jnp.where(holds, nt, t), holds

        jstep = m.jit(jprog)
        jst, tst = jlk.init_state(), tlk.init_state()
        jt = np.full(P, nt, np.uint32)
        tt = torch.full((P,), pt.NO_TICKET, dtype=torch.int64)
        served = 0
        for _ in range(12):
            want = rng.random(P) < .8
            jst, jt, jh = jstep(jst, jt, want)
            w = torch.from_numpy(want)
            tst, t2 = tlk.acquire(tst, want=(tt == pt.NO_TICKET) & w)
            tt = torch.where(tt == pt.NO_TICKET, t2, tt)
            th = tlk.holds(tst, tt)
            tst = tlk.refresh(tlk.release(tst, th))
            tt = torch.where(th, pt.NO_TICKET, tt)
            assert_same((jst, jt, jh), (tst, tt, th))
            assert int(th.sum()) <= 1
            served += int(th.sum())
        assert served > 6

    def test_lock_array_independent_stripes(self):
        m = _Pair()
        jla = m.core.TicketLockArray(None, "locks", m.jmgr, num_locks=2)
        tla = pt.TicketLockArray(None, "locks", m.tmgr, num_locks=2)

        def jprog(st):
            lock_id = _me(m.jmgr) % 2
            st, ticket = jla.acquire(st, lock_id, want=True)
            h0 = jla.holds(st, lock_id, ticket)
            st = jla.release(st, lock_id, h0)
            h1 = jla.holds(st, lock_id, ticket)
            st = jla.release(st, lock_id, h1)
            return st, ticket, h0, h1

        lock_id = _me(m.tmgr) % 2
        st, ticket = tla.acquire(tla.init_state(), lock_id, want=True)
        h0 = tla.holds(st, lock_id, ticket)
        st = tla.release(st, lock_id, h0)
        h1 = tla.holds(st, lock_id, ticket)
        st = tla.release(st, lock_id, h1)
        assert_same(m.jrun(jprog, jla.init_state()), (st, ticket, h0, h1))
        np.testing.assert_array_equal(ticket.numpy(), [0, 0, 1, 1])
        np.testing.assert_array_equal(h0.numpy(), [True, True, False, False])
        np.testing.assert_array_equal(h1.numpy(), [False, False, True, True])


# ------------------------------------------------------ manager and fences
class TestManagerAndFences:
    def test_channel_name_collision_rejected(self):
        mgr = pt.make_manager(P, device="cpu")
        pt.OwnedVar(None, "x", mgr, owner=0)
        with pytest.raises(ValueError, match="collision"):
            pt.OwnedVar(None, "x", mgr, owner=1)

    def test_memory_ledger_accounts_regions(self):
        mgr = pt.make_manager(P, device="cpu")
        pt.SharedRegion(None, "r", mgr, slots=10, item_shape=(4,),
                        dtype=torch.float32)
        assert mgr.memory_ledger_bytes() == 10 * 4 * 4

    def test_fence_scopes_tracked(self):
        m = _Pair()
        jov = m.core.OwnedVar(None, "v", m.jmgr, owner=0, shape=(2,),
                              dtype=jnp.float32)
        tov = pt.OwnedVar(None, "v", m.tmgr, owner=0, shape=(2,),
                          dtype=torch.float32)

        def jprog(st):
            with m.jmgr.tracking():
                st2, _ = jov.push(st)
                return m.jmgr.fence(st2.cached, scope=pt.FenceScope.GLOBAL)

        with m.tmgr.tracking():
            st2, _ = tov.push(tov.init_state())
            assert len(m.tmgr.outstanding().descs) == 1
            out = m.tmgr.fence(st2.cached, scope=pt.FenceScope.GLOBAL)
            assert not m.tmgr.outstanding().descs
        assert_same(m.jrun(jprog, jov.init_state()), out)
        assert tuple(out.shape) == (P, 2)
        assert m.tmgr.fence_counts == dict(m.jmgr.fence_counts)
        assert m.tmgr.fence_counts[pt.FenceScope.GLOBAL] == 1

    def test_pair_fence_keeps_other_ops_outstanding(self):
        m = _Pair()
        seen = {}
        for side, mgr, lib in (("ref", m.jmgr, m.core), ("port", m.tmgr, pt)):
            kw = {} if side == "port" else dict(dtype=jnp.float32)
            ov0 = lib.OwnedVar(None, "a", mgr, owner=0, shape=(), **kw)
            ov1 = lib.OwnedVar(None, "b", mgr, owner=1, shape=(), **kw)

            def prog(s0, s1, mgr=mgr, ov0=ov0, ov1=ov1, side=side):
                with mgr.tracking():
                    s0b, _ = ov0.pull(s0)
                    _s1b, _ = ov1.pull(s1)
                    out = mgr.fence(s0b.cached, scope=pt.FenceScope.PAIR,
                                    peer=0)
                    seen[side] = mgr.outstanding().descs
                    with mgr.no_tracking():
                        ov0.push(s0)
                    seen[side + " paused"] = mgr.outstanding().descs
                return out

            args = (ov0.init_state(), ov1.init_state())
            if side == "ref":
                jout = m.jrun(prog, *args)
            else:
                tout = prog(*args)
        assert_same(jout, tout)
        assert seen["port"] == seen["ref"] == seen["port paused"]
        assert len(seen["port"]) == 1 and seen["port"][0].peers == (1,)
        assert m.tmgr.outstanding().descs == ()

    def test_ack_keys(self):
        """query/wait are a True on the tokens' device, tokens_for_peer
        picks the operations a PAIR fence orders — the reference's
        descriptors and token counts."""
        m = _Pair()
        out = {}
        for side, mgr, lib in (("ref", m.jmgr, m.core), ("port", m.tmgr, pt)):
            kw = {} if side == "port" else dict(dtype=jnp.float32)
            ov = lib.OwnedVar(None, "v", mgr, owner=1, shape=(2,), **kw)

            def prog(st, ov=ov, side=side):
                _, a = ov.pull(st)
                _, b = ov.push(st)
                ack = a | b
                out[side] = (ack.descs, len(ack.tokens_for_peer(1)),
                             len(ack.tokens_for_peer(3)), ack.nbytes)
                return ack.query(), ack.wait()

            if side == "ref":
                flags = m.jrun(prog, ov.init_state())
            else:
                flags = prog(ov.init_state())
                assert flags[0].dtype == torch.bool and flags[0].dim() == 0
                assert bool(pt.AckKey.empty().query())
            assert all(bool(np.all(np.asarray(f))) for f in flags)
        assert out["port"] == out["ref"]
        assert out["port"][1:3] == (2, 1)

    def test_runtime_run_and_stack(self):
        m = _Pair()
        vals = [np.float32(p) * np.arange(3, dtype=np.float32)
                for p in range(P)]
        states = [m.core.AtomicVarState(np.int32(p), np.int32(-p))
                  for p in range(P)]
        jst, tst = m.jmgr.runtime.stack(states), m.tmgr.runtime.stack(states)
        assert_same(m.jmgr.runtime.stack(vals), m.tmgr.runtime.stack(vals))
        assert_same(jst, tst)
        assert isinstance(tst, m.core.AtomicVarState)
        assert_same(m.jmgr.runtime.run(lambda v: v * 2, jst.official),
                    m.tmgr.runtime.run(lambda v: v * 2, tst.official))

    def test_default_backend_from_environment(self, monkeypatch):
        monkeypatch.setenv("REPRO_DEFAULT_BACKEND", "pallas")
        assert pt.make_manager(P, device="cpu").backend.name == "pallas"
        assert pt.make_manager(P, device="cpu",
                               backend="active_message").backend.name \
            == "active_message"
        monkeypatch.delenv("REPRO_DEFAULT_BACKEND")
        assert pt.make_manager(P, device="cpu").backend.name == "onesided"


# ------------------------------------------------------ the queue's spec
@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_queue_scalar_references_bitwise(backend):
    """The queue's scalar enqueue/dequeue (fetch-and-add tickets, scalar
    one-sided slot verbs) against the JAX package's, and the port's B=1
    windows against the port's scalar paths, through a full queue and
    tickets that wrap the capacity."""
    m = _Pair(backend)
    width = 2
    jq = m.core.SharedQueue(None, "q", m.jmgr, slots_per_node=2, width=width)
    tq = pt.SharedQueue(None, "q", m.tmgr, slots_per_node=2, width=width)
    tw = pt.SharedQueue(None, "w", pt.make_manager(P, device="cpu",
                                                   backend=backend),
                        slots_per_node=2, width=width)

    def jprog(st, ew, ev, dw):
        st, g = jq._enqueue_reference(st, ev, want=ew)
        st, v, ok = jq._dequeue_reference(st, want=dw)
        return st, g, v, ok

    jstep = m.jit(jprog)
    rng = np.random.default_rng(23)
    jst, tst, wst = jq.init_state(), tq.init_state(), tw.init_state()
    grants = oks = 0
    for rnd in range(16):
        ew = rng.random(P) < (0.9 if rnd < 4 else 0.5)
        dw = rng.random(P) < (0.1 if rnd < 4 else 0.7)
        ev = rng.integers(-2 ** 31, 2 ** 31, (P, width)).astype(np.int32)
        jst, *jout = jstep(jst, ew, ev, dw)
        tst, g = tq._enqueue_reference(tst, torch.from_numpy(ev),
                                       want=torch.from_numpy(ew))
        tst, v, ok = tq._dequeue_reference(tst, want=torch.from_numpy(dw))
        assert_same([jst] + jout, [tst, g, v, ok], f"round {rnd}")
        wst, gw = tw.enqueue(wst, torch.from_numpy(ev), torch.from_numpy(ew))
        wst, vw, okw = tw.dequeue(wst, torch.from_numpy(dw))
        assert_same([tst, g, v, ok], [wst, gw, vw, okw], f"B=1 {rnd}")
        grants += int(g.sum())
        oks += int(ok.sum())
        if rnd == 2:
            assert not g[torch.from_numpy(ew)].all(), "the full queue rejects"
    assert grants > 2 * tq.capacity and oks > tq.capacity
    m.assert_ledgers_equal()
