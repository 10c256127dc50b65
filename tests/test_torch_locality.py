"""The port's locality migration (DESIGN.md §10.2–§10.3) against the JAX
package: MOVE lanes, ``migrate_window``, the HotTracker heat channel and
``rebalance``.

Mirrors ``tests/test_locality.py``'s ``TestMigration`` and
``TestHotTrackerAndRebalance``, run on both packages from one state: after
every window each integer state leaf and each result lane must be equal bit
for bit, and so must the traffic-ledger rows.  The heat counters are
float32: the reference adds +1.0 lane by lane into the decayed counter, the
port adds a line's count once, so they are held within float32 rounding,
``HEAT_RTOL`` relative (plus ``HEAT_ATOL`` for counters near 0); the
rebalance proposals derived from them must be equal exactly on these cases.
A migrating torture history recorded from the port passes the
linearizability checker.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_port_ref import (jax_to_numpy, leaves, ledger_rows,  # noqa: E402
                            locked_ledger, reference_core, torch_to_numpy)

import repro_torch.core as pt  # noqa: E402
# after torch_port_ref: the package's __init__ imports repro.core
from linearizability import (HistoryRecorder, KVSpec,  # noqa: E402
                              check_history)

P, S, W = 4, 4, 2
KW = dict(slots_per_node=S, value_width=W, num_locks=8, index_capacity=64)
NOP, GET, INSERT, UPDATE, DELETE, MOVE = (pt.NOP, pt.GET, pt.INSERT,
                                          pt.UPDATE, pt.DELETE, pt.MOVE)
HEAT_RTOL, HEAT_ATOL = 1e-6, 1e-6
NOPR = (NOP, 1, (0, 0), 0)


def v(key, salt=0):
    return (int(key) * 10 + salt, int(key) * 100 + salt)


def arrs(window):
    """P lists of (op, key, value[, target]) → (ops, keys, values,
    targets) arrays."""
    return (np.asarray([[o[0] for o in ln] for ln in window], np.int32),
            np.asarray([[o[1] for o in ln] for ln in window], np.uint32),
            np.asarray([[o[2] for o in ln] for ln in window], np.int32),
            np.asarray([[o[3] if len(o) > 3 else 0 for o in ln]
                        for ln in window], np.int32))


def assert_states_equal(j, t, what):
    """Every leaf of a JAX state (numpy leaves) and a port state bitwise,
    but the float32 heat counters within float32 rounding."""
    lj, lt = leaves(jax_to_numpy(j)), leaves(pt.state_to_numpy(t))
    assert [p for p, _ in lj] == [p for p, _ in lt], what
    for (path, a), (_, b) in zip(lj, lt):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {path}"
        if path == "heat.heat":
            np.testing.assert_allclose(b, a, rtol=HEAT_RTOL, atol=HEAT_ATOL,
                                       err_msg=f"{what} {path}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")


def key_locations(st):
    """key → (node, slot) from participant 0's index (a port state)."""
    idx = pt.state_to_numpy(st).idx[0]
    used = idx[:, 0] == 1
    return {int(np.uint32(r[1])): (int(r[2]), int(r[3])) for r in idx[used]}


class _Loc:
    """One store configuration in both packages, run side by side, every
    step compared; ledgers enabled on both."""

    def __init__(self, name, backend="onesided", **cfg):
        core = reference_core()
        self.jm = core.make_manager(P, backend=backend)
        locked_ledger(self.jm)
        self.jkv = core.KVStore(None, name, self.jm, **{**KW, **cfg})
        self.tm = pt.make_manager(P, device="cpu", backend=backend)
        self.tm.traffic.enable()
        self.tkv = pt.KVStore(None, name, self.tm, **{**KW, **cfg})
        self.jst, self.tst = self.jkv.init_state(), self.tkv.init_state()
        self._jit = {}

    def _run(self, name, fn, *args):
        if name not in self._jit:
            run = self.jm.runtime.run
            self._jit[name] = jax.jit(lambda *a: run(fn, *a))
        return self._jit[name](*args)

    def check(self, what):
        assert_states_equal(self.jst, self.tst, what)

    def window(self, w, targets=True, what="window"):
        op, key, val, tgt = arrs(w)
        if targets:
            self.jst, jr = self._run(
                "wt", lambda s, o, k, v_, t: self.jkv.op_window(
                    s, o, k, v_, targets=t), self.jst, op, key, val, tgt)
            self.tst, tr = self.tkv.op_window(self.tst, op, key, val,
                                              targets=tgt)
        else:
            self.jst, jr = self._run("w", self.jkv.op_window, self.jst, op,
                                     key, val)
            self.tst, tr = self.tkv.op_window(self.tst, op, key, val)
        for a, b in zip(jax_to_numpy(jr), torch_to_numpy(tr)):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} result")
        self.check(what)
        return tr

    def migrate(self, keys, dests, preds, what="migrate"):
        keys = np.asarray(keys, np.uint32)
        dests = np.asarray(dests, np.int32)
        preds = np.asarray(preds, bool)
        self.jst, jm = self._run("mig", self.jkv.migrate_window, self.jst,
                                 keys, dests, preds)
        self.tst, tmv = self.tkv.migrate_window(self.tst, keys, dests, preds)
        np.testing.assert_array_equal(np.asarray(jm), tmv.numpy(),
                                      err_msg=what)
        self.check(what)
        return tmv.numpy()

    def reads(self, keys, pred, what="reads"):
        keys = np.asarray(keys, np.uint32)
        pred = np.asarray(pred, bool)
        self.jst, jv, jf = self._run(
            "get", lambda s, k, p: self.jkv.get_batch(s, k, pred=p),
            self.jst, keys, pred)
        self.tst, tv, tf = self.tkv.get_batch(self.tst, keys, pred=pred)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), what)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy(), what)
        self.check(what)
        return tf.numpy()

    def rebalance(self, max_moves, what="rebalance"):
        props_j = self._run(
            f"prop{max_moves}", lambda s: self.jkv.rebalance_proposals(
                s, max_moves, with_alts=True), self.jst)
        props_t = self.tkv.rebalance_proposals(self.tst, max_moves,
                                               with_alts=True)
        for a, b in zip(props_j, props_t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{what} proposals")
        self.jst, jn = self._run(
            f"reb{max_moves}", lambda s: self.jkv.rebalance(s, max_moves),
            self.jst)
        self.tst, tn = self.tkv.rebalance(self.tst, max_moves)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy(), what)
        self.check(what)
        return int(tn[0])

    def assert_ledgers_equal(self):
        jax.effects_barrier()
        assert ledger_rows(self.jm.traffic) == ledger_rows(self.tm.traffic)


def _seed(loc):
    """Two writer-local inserts per participant: keys 1+p and 1+P+p live at
    node p."""
    loc.window([[(INSERT, 1 + p + P * b, v(1 + p + P * b), 0)
                 for b in range(2)] for p in range(P)], what="seed")


class TestMigration:
    @pytest.mark.parametrize("backend", ["onesided", "pallas"])
    def test_move_rehomes_and_preserves_values(self, backend):
        s = _Loc(f"mig_rehome_{backend}", backend=backend)
        _seed(s)
        pre = key_locations(s.tst)
        moved = s.migrate(np.arange(1, P + 1).reshape(P, 1),
                          [[(p + 1) % P] for p in range(P)],
                          np.ones((P, 1), bool))
        assert moved.all()
        locs = key_locations(s.tst)
        for p in range(P):
            assert locs[1 + p][0] == (p + 1) % P
            assert pre[1 + P + p] == locs[1 + P + p]   # unmoved keys stay
        gk = np.broadcast_to(np.arange(1, 2 * P + 1, dtype=np.uint32),
                             (P, 2 * P))
        found = s.reads(gk, np.ones((P, 2 * P), bool))
        assert found.all()
        s.assert_ledgers_equal()
        # the pre-read ran (each mover reads its own node's row: zero wire
        # bytes)
        assert s.tm.traffic.summary()[
            f"mig_rehome_{backend}.move_read"]["calls"] > 0

    def test_move_frees_old_slot_and_bumps_reuse_counter(self):
        s = _Loc("mig_free")
        _seed(s)
        old_node, old_slot = key_locations(s.tst)[1]
        st0 = pt.state_to_numpy(s.tst)
        top, ctr = int(st0.free_top[old_node]), \
            int(st0.slot_ctr[old_node, old_slot])
        moved = s.migrate([[1]] + [[0]] * (P - 1), np.full((P, 1), 1),
                          [[True]] + [[False]] * (P - 1))
        assert moved[0, 0]
        st1 = pt.state_to_numpy(s.tst)
        assert int(st1.free_top[old_node]) == top + 1
        assert old_slot in st1.free_stack[old_node][:top + 1]
        assert int(st1.slot_ctr[old_node, old_slot]) == ctr + 1

    def test_move_of_absent_key_fails_cleanly(self):
        s = _Loc("mig_absent")
        _seed(s)
        pre = key_locations(s.tst)
        moved = s.migrate(np.full((P, 1), 99), np.zeros((P, 1)),
                          [[True]] + [[False]] * (P - 1))
        assert not moved[0, 0]
        assert key_locations(s.tst) == pre

    def test_move_to_current_home_is_a_successful_noop(self):
        s = _Loc("mig_noop")
        _seed(s)
        pre = key_locations(s.tst)
        moved = s.migrate([[1 + p] for p in range(P)],
                          [[p] for p in range(P)], np.ones((P, 1), bool))
        assert moved.all()
        assert key_locations(s.tst) == pre

    def test_move_to_full_destination_fails_with_row_intact(self):
        s = _Loc("mig_full")
        _seed(s)           # node 0 already hosts 2 rows (S = 4)
        res = s.window([[(INSERT, 100 + b, v(100 + b), 0) for b in range(2)]
                        if p == 0 else [NOPR, NOPR] for p in range(P)])
        assert res.found[0].all()
        pre = key_locations(s.tst)[2]
        moved = s.migrate([[2]] + [[0]] * (P - 1), np.zeros((P, 1)),
                          [[True]] + [[False]] * (P - 1))
        assert not moved[0, 0]
        assert key_locations(s.tst)[2] == pre
        found = s.reads(np.full((P, 1), 2), np.ones((P, 1), bool))
        assert found.all()

    @pytest.mark.parametrize("cfg", [dict(), dict(cache_slots=8),
                                     dict(placement="hashed")],
                             ids=["local", "cached", "hashed"])
    def test_move_lanes_in_mixed_windows(self, cfg):
        """MOVE lanes among INSERT/UPDATE/DELETE/GET lanes of one window,
        several MOVEs on one destination and on one key, a MOVE behind a
        DELETE of its key; on a cached store the moved rows' lines must be
        invalidated, on a hashed store MOVE lanes also home by the
        policy."""
        s = _Loc("mig_mixed_" + "_".join(f"{k}" for k in cfg), **cfg)
        _seed(s)
        rng = np.random.default_rng(5)
        for rnd in range(6):
            w = []
            for p in range(P):
                lane = []
                for _b in range(2):
                    op = int(rng.choice([GET, INSERT, UPDATE, DELETE, MOVE,
                                         MOVE, NOP]))
                    k = int(rng.integers(1, 3 * P))
                    lane.append((op, k, v(k, rnd), int(rng.integers(0, P))))
                w.append(lane)
            s.window(w, what=f"mixed {rnd}")
            gk = np.broadcast_to(np.arange(1, 3 * P, dtype=np.uint32),
                                 (P, 3 * P - 1))
            s.reads(gk, rng.random(gk.shape) < 0.7, what=f"reads {rnd}")
        s.assert_ledgers_equal()

    def test_writer_local_move_lane_fails_with_no_effect(self):
        """Under the writer-local path (no targets) a MOVE lane takes its
        lock and fails; the store is left as it was but for the lock
        counters."""
        s = _Loc("mig_local")
        _seed(s)
        before = pt.state_to_numpy(s.tst)
        res = s.window([[(MOVE, 1 + p, (0, 0)), NOPR] for p in range(P)],
                       targets=False)
        assert not res.found.any()
        after = pt.state_to_numpy(s.tst)
        for f in pt.KVStoreState._fields:
            if f != "locks":
                for a, b in zip(leaves(getattr(before, f)),
                                leaves(getattr(after, f))):
                    np.testing.assert_array_equal(a[1], b[1], err_msg=f)

    def test_migrated_store_results_equal_never_migrated(self):
        """The §10.2 transparency contract on the port: after migration,
        interleaved GET/UPDATE/DELETE windows return the results a
        never-migrated twin returns."""
        s = _Loc("mig_transp")
        _seed(s)
        mgr = pt.make_manager(P, device="cpu")
        plain = pt.KVStore(None, "plain", mgr, **KW)
        pst = plain.init_state()
        op, key, val, _t = arrs([[(INSERT, 1 + p + P * b, v(1 + p + P * b))
                                  for b in range(2)] for p in range(P)])
        pst, _r = plain.op_window(pst, op, key, val)
        assert s.migrate([[1 + p] for p in range(P)],
                         [[(p + 1) % P] for p in range(P)],
                         np.ones((P, 1), bool)).all()
        rng = np.random.default_rng(11)
        for rnd in range(6):
            w = [[(int(rng.choice([NOP, GET, UPDATE, DELETE])), k,
                   v(k, rnd), 0) for k in rng.integers(1, 2 * P + 1, 2)]
                 for _p in range(P)]
            res = s.window(w, what=f"window {rnd}")
            op, key, val, _t = arrs(w)
            pst, pres = plain.op_window(pst, op, key, val)
            for a, b in zip(torch_to_numpy(res), torch_to_numpy(pres)):
                np.testing.assert_array_equal(a, b, err_msg=f"round {rnd}")

    def test_move_records_replicate_bitwise(self):
        """MOVE windows ride the ReplicatedLog like any mutation: a follower
        replaying the exported records (targets included) converges leaf
        for leaf, and both packages' leader, follower and log agree."""
        core = reference_core()
        side = {}
        for name, mod, mgr in (("j", core, core.make_manager(P)),
                               ("t", pt, pt.make_manager(P, device="cpu"))):
            lead = mod.KVStore(None, "mig_leader", mgr, **KW)
            fol = mod.KVStore(None, "mig_follower", mgr, **KW)
            log = mod.ReplicatedLog(None, "mig_log", mgr, store=lead,
                                    window=2, capacity=2)
            side[name] = (mgr, lead, fol, log)
        jm, jlead, jfol, jlog = side["j"]
        _tm, tlead, tfol, tlog = side["t"]

        def prog(lst, fst, gst, op, key, val, tgt):
            lst, res = jlead.op_window(lst, op, key, val, targets=tgt)
            gst, ok = jlog.append(gst, op, key, val, targets=tgt)
            gst, fst, _n = jlog.sync(gst, jfol, fst, max_entries=1)
            return lst, fst, gst, res, ok

        jstep = jax.jit(lambda *a: jm.runtime.run(prog, *a))
        js = [jlead.init_state(), jfol.init_state(), jlog.init_state()]
        ts = [tlead.init_state(), tfol.init_state(), tlog.init_state()]
        wins = [
            [[(INSERT, 1 + p, v(1 + p), 0),
              (INSERT, 1 + P + p, v(1 + P + p), 0)] for p in range(P)],
            [[(MOVE, 1 + p, (0, 0), (p + 1) % P), NOPR] for p in range(P)],
            [[(UPDATE, 1 + p, v(1 + p, 9), 0),
              (DELETE, 1 + P + p, (0, 0), 0)] for p in range(P)],
        ]
        for i, w in enumerate(wins):
            op, key, val, tgt = arrs(w)
            *js, jres, jok = jstep(*js, op, key, val, tgt)
            ts[0], tres = tlead.op_window(ts[0], op, key, val, targets=tgt)
            ts[2], tok = tlog.append(ts[2], op, key, val, targets=tgt)
            ts[2], ts[1], _n = tlog.sync(ts[2], tfol, ts[1], max_entries=1)
            assert bool(tok[0])
            assert not pt.diverging_leaves(ts[0], ts[1]), f"window {i}"
            np.testing.assert_array_equal(np.asarray(jres.found),
                                          tres.found.numpy())
            for a, b in ((js[0], ts[0]), (js[1], ts[1])):
                assert_states_equal(a, b, f"window {i}")
        assert tres.found.all()

    def test_fastpath_move_exports_as_nop(self):
        """A MOVE lane with no target on a writer-local store is a no-op,
        so its exported record is masked to NOP, as the reference's is."""
        core = reference_core()
        jm = core.make_manager(P)
        jkv = core.KVStore(None, "exp_plain", jm, **KW)
        kv = pt.KVStore(None, "exp_plain", pt.make_manager(P, device="cpu"),
                        **KW)
        op = np.asarray([[MOVE, INSERT]] * P, np.int32)
        key = np.asarray([[1 + p, 1 + P + p] for p in range(P)], np.uint32)
        val = np.zeros((P, 2, W), np.int32)
        recs = kv.export_window_records(op, key, val).numpy()
        jrecs = np.asarray(jax.jit(lambda o, k, v_: jm.runtime.run(
            jkv.export_window_records, o, k, v_))(op, key, val))
        np.testing.assert_array_equal(recs, jrecs)
        assert (recs[:, 0, 0] == NOP).all()
        assert (recs[:, 1, 0] == INSERT).all()


class TestHotTrackerAndRebalance:
    def test_observe_decays_every_window_and_counts_live_lanes(self):
        mgr = pt.make_manager(2, device="cpu")
        hot = pt.HotTracker(None, "hot_unit", mgr, nodes=2, slots=2,
                            decay=0.5)
        st = hot.init_state()
        nodes = np.zeros((2, 2), np.int32)
        slots = np.asarray([[0, 1], [0, 0]], np.int32)

        def obs(st, live):
            return hot.observe(st, pt_t(nodes), pt_t(slots), pt_t(live))

        st = obs(st, np.asarray([[True, True], [False, False]]))
        np.testing.assert_array_equal(st.heat[0].numpy(), [1, 1, 0, 0])
        np.testing.assert_array_equal(st.heat[1].numpy(), [0, 0, 0, 0])
        st = obs(st, np.asarray([[True, True], [False, False]]))
        np.testing.assert_array_equal(st.heat[0].numpy(), [1.5, 1.5, 0, 0])
        # decay ticks every observed window on every participant
        st = obs(st, np.asarray([[False, False], [True, False]]))
        np.testing.assert_array_equal(st.heat[0].numpy(), [0.75, 0.75, 0, 0])
        np.testing.assert_array_equal(st.heat[1].numpy(), [1, 0, 0, 0])
        # two lanes on one line add 2 at once
        st = obs(st, np.asarray([[False, False], [True, True]]))
        np.testing.assert_array_equal(st.heat[1].numpy(), [2.5, 0, 0, 0])
        assert hot.line_of(pt_t([1, 0, 5]), pt_t([1, 1, 0])).tolist() \
            == [3, 1, 3]
        assert hot.all_heat(st) is st.heat
        st = hot.forget(st, pt_t([[0, 1], [0, 1]]), pt_t([[0, 0], [0, 0]]),
                        pt_t([[True, False], [False, False]]))
        np.testing.assert_array_equal(st.heat.numpy(),
                                      [[0, 0.375, 0, 0], [2.5, 0, 0, 0]])

    def test_observe_matches_reference_on_repeated_lanes(self):
        """Many lanes on few lines for many windows: the port's counters
        stay within float32 rounding of the reference's lane-by-lane adds
        (decay 0.9, so the counters carry long mantissas)."""
        core = reference_core()
        jm = core.make_manager(P)
        jhot = core.HotTracker(None, "hot_rep", jm, nodes=P, slots=3)
        hot = pt.HotTracker(None, "hot_rep",
                            pt.make_manager(P, device="cpu"), nodes=P,
                            slots=3)
        jobs = jax.jit(lambda s, n, sl, p: jm.runtime.run(jhot.observe, s, n,
                                                          sl, p))
        js, ts = jhot.init_state(), hot.init_state()
        rng = np.random.default_rng(9)
        for _w in range(30):
            n = rng.integers(0, 2, (P, 16)).astype(np.int32)
            sl = rng.integers(0, 3, (P, 16)).astype(np.int32)
            pr = rng.random((P, 16)) < 0.8
            js = jobs(js, n, sl, pr)
            ts = hot.observe(ts, pt_t(n), pt_t(sl), pt_t(pr))
            np.testing.assert_allclose(ts.heat.numpy(), np.asarray(js.heat),
                                       rtol=HEAT_RTOL, atol=HEAT_ATOL)

    def test_freed_slots_forget_their_heat(self):
        s = _Loc("loc_forget", track_heat=True)
        res = s.window([[(INSERT, 1 + p, v(1 + p), 0)] for p in range(P)],
                       targets=False)
        assert res.found.all()
        locs = key_locations(s.tst)
        lid1 = locs[1][0] * S + locs[1][1]
        lid2 = locs[2][0] * S + locs[2][1]
        pred = np.zeros((P, 2), bool)
        pred[3] = True
        s.reads(np.broadcast_to(np.asarray([1, 2], np.uint32), (P, 2)), pred)
        heat = s.tst.heat.heat.numpy()
        assert heat[3, lid1] > 0 and heat[3, lid2] > 0
        res = s.window([[(DELETE, 1, (0, 0))]] + [[NOPR]] * (P - 1),
                       targets=False)
        assert res.found[0, 0]
        assert s.migrate(np.full((P, 1), 2), np.full((P, 1), 3),
                         [[True]] + [[False]] * (P - 1))[0, 0]
        heat = s.tst.heat.heat.numpy()
        assert (heat[:, lid1] == 0).all() and (heat[:, lid2] == 0).all()

    @pytest.mark.parametrize("backend", ["onesided", "pallas"])
    def test_rebalance_moves_hot_rows_to_dominant_reader(self, backend):
        s = _Loc(f"loc_heat_{backend}", backend=backend,
                 slots_per_node=2 * P, num_locks=max(8, P * P),
                 index_capacity=256, track_heat=True)
        assert s.window([[(INSERT, 1 + p, v(1 + p), 0)] for p in range(P)]
                        ).found.all()
        rk = np.broadcast_to(np.arange(1, P + 1, dtype=np.uint32), (P, P))
        pred = np.zeros((P, P), bool)
        pred[0] = True
        for _ in range(4):
            assert s.reads(rk, pred)[0].all()
        # max_moves is an exact bound even when the P-lane grid rounds past
        n1 = s.rebalance(1)
        assert n1 == 1
        n2 = s.rebalance(2 * P)
        assert n1 + n2 == P - 1
        assert all(key_locations(s.tst)[k][0] == 0 for k in range(1, P + 1))
        s.assert_ledgers_equal()
        # the skewed reader's window is now wire-free
        s.tm.traffic.reset()
        _st, _v, found = s.tkv.get_batch(s.tst, rk, pred=pred)
        assert found[0].all() and s.tm.traffic.total_bytes() == 0.0

    def test_destination_full_migrations_defer_and_retry(self):
        s = _Loc("loc_backlog", slots_per_node=2, track_heat=True)

        def backlog():
            return int(s.tst.heat.backlog[0])

        res = s.window([[(INSERT, 1, v(1), 0), (INSERT, 2, v(2), 0)],
                        [(INSERT, 11, v(11), 0), NOPR],
                        [(INSERT, 12, v(12), 0), NOPR], [NOPR, NOPR]],
                       targets=False)
        assert res.found[0].all() and backlog() == 0
        rk = np.broadcast_to(np.asarray([11, 12], np.uint32), (P, 2))
        pred = np.zeros((P, 2), bool)
        pred[0] = True
        for _ in range(4):
            assert s.reads(rk, pred)[0].all()
        assert s.rebalance(P) == 0 and backlog() == 2
        locs = key_locations(s.tst)
        assert locs[11][0] == 1 and locs[12][0] == 2
        for k, left in ((1, 1), (2, 0)):
            res = s.window([[(DELETE, k, (0, 0), 0), NOPR]]
                           + [[NOPR, NOPR]] * (P - 1), targets=False)
            assert res.found[0, 0]
            assert s.rebalance(P) == 1 and backlog() == left
        locs = key_locations(s.tst)
        assert locs[11][0] == 0 and locs[12][0] == 0

    def test_destination_full_spills_to_second_hottest_reader(self):
        s = _Loc("loc_spill", slots_per_node=2, track_heat=True)
        res = s.window([[(INSERT, 1, v(1), 0), (INSERT, 2, v(2), 0)],
                        [NOPR, NOPR], [(INSERT, 11, v(11), 0), NOPR],
                        [NOPR, NOPR]], targets=False)
        assert res.found[2, 0] and key_locations(s.tst)[11][0] == 2
        rk = np.full((P, 2), 11, np.uint32)
        for reader, times in ((0, 4), (1, 2)):
            pred = np.zeros((P, 2), bool)
            pred[reader] = True
            for _ in range(times):
                assert s.reads(rk, pred)[reader].all()
        assert s.rebalance(P) == 1
        assert int(s.tst.heat.backlog[0]) == 0
        assert key_locations(s.tst)[11][0] == 1

    def test_rebalance_requires_heat_tracking(self):
        kv = pt.KVStore(None, "plain", pt.make_manager(P, device="cpu"),
                        **KW)
        with pytest.raises(ValueError, match="track_heat"):
            kv.rebalance(kv.init_state(), 4)

    def test_heat_tracked_store_random_windows_and_rebalance(self):
        """Random mixed windows with skewed reads on a heat-tracked store,
        a rebalance after every other window, then more windows; results,
        state and proposals equal to the reference's throughout."""
        s = _Loc("loc_heat_rand", slots_per_node=6, track_heat=True,
                 cache_slots=8)
        rng = np.random.default_rng(3)
        for rnd in range(8):
            w = [[(int(rng.choice([NOP, GET, INSERT, UPDATE, DELETE])), k,
                   v(k, rnd), 0) for k in rng.integers(1, 13, 2)]
                 for _p in range(P)]
            s.window(w, targets=False, what=f"window {rnd}")
            keys = np.asarray([[1 + p + P * ((rnd + j) % 3) for j in range(3)]
                               for p in range(P)], np.uint32)
            s.reads(keys, rng.random((P, 3)) < 0.9, what=f"reads {rnd}")
            if rnd % 2:
                s.rebalance(P, what=f"rebalance {rnd}")
        s.assert_ledgers_equal()


def pt_t(x):
    import torch
    return torch.as_tensor(np.asarray(x))


def test_torture_migration_histories_are_linearizable():
    """``sweep_kv("migrating", [(2, 2)], ...)`` on the port: op windows with
    interleaved MOVE windows, 6 random histories of 14 windows, each
    checked by the Wing–Gong checker."""
    nP, nB = 2, 2
    mgr = pt.make_manager(nP, device="cpu")
    kv = pt.KVStore(None, "tkv_mig", mgr, slots_per_node=32, value_width=W,
                    num_locks=8, index_capacity=256)
    mixes = [[0.10, 0.25, 0.25, 0.25, 0.15], [0.05, 0.15, 0.10, 0.65, 0.05],
             [0.10, 0.80, 0.00, 0.10, 0.00], [0.05, 0.10, 0.45, 0.10, 0.30]]
    codes = np.asarray([NOP, GET, INSERT, UPDATE, DELETE], np.int32)
    total = moves = 0
    for seed in range(300, 306):
        rng = np.random.default_rng(seed)
        rec = HistoryRecorder()
        st = kv.init_state()
        mix = mixes[int(rng.integers(len(mixes)))]
        for _w in range(14):
            ops = rng.choice(codes, size=(nP, nB), p=mix)
            keys = rng.integers(1, 9, size=(nP, nB)).astype(np.uint32)
            vals = rng.integers(-99, 100, size=(nP, nB, W)).astype(np.int32)
            st, res = kv.op_window(st, ops, keys, vals)
            rec.record_kv_window(ops, keys, vals, res)
            if rng.random() < 0.5:
                mk = rng.integers(1, 9, size=(nP, 1)).astype(np.uint32)
                md = rng.integers(0, nP, size=(nP, 1)).astype(np.int32)
                st, moved = kv.migrate_window(st, mk, md)
                moves += int(moved.sum())
                rec.record_kv_move_window(mk, md, np.ones((nP, 1), bool),
                                          moved.numpy())
        violation = check_history(KVSpec(W), rec.windows)
        assert violation is None, f"seed {seed}: {violation}"
        total += len(rec.windows)
    assert total >= 100 and moves > 0
