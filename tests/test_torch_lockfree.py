"""The port's lock-free fast path (DESIGN.md §11, ``KVStore(lockfree=True)``)
against the JAX package, bitwise.

Mirrors the lock-free cases of the reference suites:

* ``tests/test_backends.py``'s ``lockfree`` variant on all three backends:
  random contended windows (which fall back to the locked schedule), then
  all-UPDATE windows with same-key races and pure-GET windows (which take
  the fast path); every result lane, every state leaf and every traffic
  ledger row (the fastpath rows included) equal after every window;
* ``tests/test_properties.py``'s hypothesis property: on random histories
  the port's lock-free store equals its locked store and the JAX lock-free
  store leaf for leaf, and the recorded history passes the linearizability
  checker (``tests/linearizability/checker.py``);
* ``tests/test_replog.py``'s lock-free leader replayed by a locked follower
  through the ReplicatedLog: follower converged, both packages equal;
* ``tests/linearizability/test_torture.py``'s ``sweep_kv("lockfree",
  [(4, 2)], ...)`` histories recorded from the port and checked.

All data is integer: the tolerance is exact equality.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from hypothesis import given, settings, strategies as st  # noqa: E402
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            ledger_rows, locked_ledger, reference_core,
                            torch_to_numpy)

import repro_torch.core as pt  # noqa: E402
# after torch_port_ref: the package's __init__ imports repro.core
from linearizability import (HistoryRecorder, KVSpec,  # noqa: E402
                              check_history)

P, B, W = 4, 2, 2
KW = dict(slots_per_node=8, value_width=W, num_locks=8, index_capacity=64)
NOP, GET, INSERT, UPDATE, DELETE = (pt.NOP, pt.GET, pt.INSERT, pt.UPDATE,
                                    pt.DELETE)


def v(key, salt=0):
    return (int(key) * 10 + salt, int(key) * 100 + salt)


def arrays(lanes):
    """P lists of (op, key, value) tuples → (ops, keys, values) arrays."""
    return (np.asarray([[o[0] for o in ln] for ln in lanes], np.int32),
            np.asarray([[o[1] for o in ln] for ln in lanes], np.uint32),
            np.asarray([[o[2] for o in ln] for ln in lanes], np.int32))


def contended_windows(n_rounds=4, seed=3, key_space=12):
    """``tests/test_backends.py::_kv_windows``: duplicate keys, insert and
    delete churn, GET interleavings."""
    rng = np.random.default_rng(seed)
    codes = [NOP, GET, INSERT, INSERT, UPDATE, DELETE]
    out = []
    for rnd in range(n_rounds):
        lanes = []
        for _p in range(P):
            lane = []
            for b in range(B):
                op = codes[rng.integers(len(codes))]
                key = int(rng.integers(1, key_space + 1))
                lane.append((op, key, v(key, rnd * B + b)))
            lanes.append(lane)
        out.append(arrays(lanes))
    return out


def fast_windows(salt=50):
    """Windows the fast path serves: all-UPDATE with cross-participant and
    same-participant same-key races, UPDATE among GETs and NOPs, pure GET."""
    upd = [[(UPDATE, 1 + (p % 2), v(1, salt + p)),
            (UPDATE, 1 + (p % 2), v(2, salt + p))] for p in range(P)]
    mix = [[(UPDATE, 3 + p, v(3 + p, salt)), (GET, 1 + p, (0, 0))]
           for p in range(P - 1)] + [[(NOP, 1, (0, 0)), (UPDATE, 1, v(1))]]
    gets = [[(GET, 1 + p, (0, 0)), (GET, 5 + p, (0, 0))] for p in range(P)]
    return [arrays(upd), arrays(mix), arrays(gets)]


class _Pair:
    """One store configuration in both packages, ledgers enabled."""

    def __init__(self, name, backend="onesided", **cfg):
        core = reference_core()
        self.jmgr = core.make_manager(P, backend=backend)
        locked_ledger(self.jmgr)
        self.jkv = core.KVStore(None, name, self.jmgr, **KW, **cfg)
        self.jstep = jax.jit(lambda s, o, k, v_: self.jmgr.runtime.run(
            self.jkv.op_window, s, o, k, v_))
        self.tmgr = pt.make_manager(P, device="cpu", backend=backend)
        self.tmgr.traffic.enable()
        self.tkv = pt.KVStore(None, name, self.tmgr, **KW, **cfg)
        self.jst, self.tst = self.jkv.init_state(), self.tkv.init_state()

    def window(self, ops, keys, vals, what):
        self.jst, jres = self.jstep(self.jst, ops, keys, vals)
        self.tst, tres = self.tkv.op_window(self.tst, ops, keys, vals)
        assert_trees_equal(jax_to_numpy(jres), torch_to_numpy(tres),
                           f"{what} result")
        assert_trees_equal(jax_to_numpy(self.jst),
                           pt.state_to_numpy(self.tst), f"{what} state")
        return tres

    def assert_ledgers_equal(self):
        jax.effects_barrier()
        assert ledger_rows(self.jmgr.traffic) == ledger_rows(
            self.tmgr.traffic)


@pytest.mark.parametrize("backend", ["onesided", "active_message", "pallas"])
def test_lockfree_windows_bitwise_across_backends(backend):
    """The ``lockfree`` variant of the backend conformance suite: contended
    windows fall back to the locked schedule, commuting ones take the fast
    path, and both packages agree on results, state and ledger rows."""
    s = _Pair(f"lf_{backend}", backend=backend, lockfree=True)
    prefill = arrays([[(INSERT, 1 + p + P * b, v(1 + p + P * b))
                       for b in range(B)] for p in range(P)])
    windows = [prefill] + contended_windows() + fast_windows() \
        + contended_windows(n_rounds=2, seed=4) + fast_windows(salt=70)
    for i, w in enumerate(windows):
        s.window(*w, what=f"{backend} window {i}")
    s.assert_ledgers_equal()
    rows = s.tmgr.traffic.fastpath_summary()[f"lf_{backend}"]
    # one count a window; the six fast windows (and only those here) were
    # served lock-free
    assert rows["windows"] == len(windows)
    fast = sum(1 for w in windows if not np.isin(
        w[0], [INSERT, DELETE]).any())
    assert fast == 6 and rows["fast_windows"] == fast


def test_op_window_lockfree_argument_overrides_the_knob():
    """``op_window(lockfree=...)`` overrides the store's default: a locked
    store serving one window lock-free lands the locked store's bits."""
    mgr = pt.make_manager(P, device="cpu")
    kv = pt.KVStore(None, "lf_override", mgr, **KW)
    a = b = kv.init_state()
    for w in [arrays([[(INSERT, 1 + p, v(1 + p)), (NOP, 1, (0, 0))]
                      for p in range(P)])] + fast_windows():
        a, ra = kv.op_window(a, *w)
        b, rb = kv.op_window(b, *w, lockfree=True)
        assert_trees_equal(torch_to_numpy(ra), torch_to_numpy(rb))
        assert_trees_equal(pt.state_to_numpy(a), pt.state_to_numpy(b))
    with pytest.raises(ValueError, match="scheduled"):
        pt.KVStore(None, "lf_ref", mgr, lockfree=True, reference_impl=True,
                   **KW)


# ---------------------------------------------------------------- hypothesis
_H = {}


def _harness():
    """The JAX lock-free store and the port's locked and lock-free stores,
    built once for every example."""
    if not _H:
        core = reference_core()
        jmgr = core.make_manager(P)
        jkv = core.KVStore(None, "plf_fast", jmgr, lockfree=True, **KW)
        _H["jkv"] = jkv
        _H["jstep"] = jax.jit(lambda s, o, k, v_: jmgr.runtime.run(
            jkv.op_window, s, o, k, v_))
        tmgr = pt.make_manager(P, device="cpu")
        _H["locked"] = pt.KVStore(None, "plf_locked", tmgr, **KW)
        _H["fast"] = pt.KVStore(None, "plf_fast", tmgr, lockfree=True, **KW)
    return _H


op_strategy = st.tuples(st.sampled_from([NOP, GET, INSERT, UPDATE, DELETE]),
                        st.integers(min_value=1, max_value=6))


@settings(max_examples=15, deadline=None)
@given(st.lists(st.lists(st.lists(op_strategy, min_size=B, max_size=B),
                         min_size=P, max_size=P),
                min_size=1, max_size=4))
def test_lockfree_windows_equal_locked_and_reference_and_linearizable(
        batches):
    """The §11 pinning property on the port: on every random history the
    lock-free store commits the locked store's state leaves and result
    lanes and the JAX lock-free store's, and the history is
    linearizable."""
    h = _harness()
    lst, fst = h["locked"].init_state(), h["fast"].init_state()
    jst = h["jkv"].init_state()
    rec = HistoryRecorder()
    for rnd, lanes in enumerate(batches):
        w = arrays([[(o, k, v(k, rnd * B + b)) for b, (o, k) in
                     enumerate(lane)] for lane in lanes])
        lst, ra = h["locked"].op_window(lst, *w)
        fst, rb = h["fast"].op_window(fst, *w)
        jst, rj = h["jstep"](jst, *w)
        assert_trees_equal(torch_to_numpy(ra), torch_to_numpy(rb),
                           f"window {rnd} result vs locked")
        assert_trees_equal(jax_to_numpy(rj), torch_to_numpy(rb),
                           f"window {rnd} result vs JAX")
        assert not pt.diverging_leaves(lst, fst, skip=()), \
            f"lock-free diverged from locked after window {rnd}"
        assert_trees_equal(jax_to_numpy(jst), pt.state_to_numpy(fst),
                           f"window {rnd} state vs JAX")
        rec.record_kv_window(*w, rb)
    violation = check_history(KVSpec(W), rec.windows)
    assert violation is None, str(violation)


# ---------------------------------------------------------------- replication
def test_lockfree_leader_replays_bitwise_through_locked_follower():
    """``tests/test_replog.py``'s §11 replication invariant: a leader that
    serves windows lock-free (a mixed window falling back, a commuting
    window with same-key races, a pure-GET window) exports the records the
    locked path would, so a follower replaying through the locked path
    converges on every leaf, lock counters included; both packages'
    leader, follower and log states are equal after every window."""
    core = reference_core()
    side = {}
    for name, mod, mgr in (("j", core, core.make_manager(P)),
                           ("t", pt, pt.make_manager(P, device="cpu"))):
        kw = dict(slots_per_node=4, value_width=W, num_locks=8,
                  index_capacity=64)
        lead = mod.KVStore(None, "rl_leader", mgr, **kw)
        fol = mod.KVStore(None, "rl_follower", mgr, **kw)
        log = mod.ReplicatedLog(None, "rl_log", mgr, store=lead, window=B,
                                capacity=2)
        side[name] = (mgr, lead, fol, log)
    jm, jlead, jfol, jlog = side["j"]
    _tm, tlead, tfol, tlog = side["t"]

    def prog(lst, fst, gst, op, key, val):
        lst, res = jlead.op_window(lst, op, key, val, lockfree=True)
        gst, ok = jlog.append(gst, op, key, val)
        gst, fst, applied = jlog.sync(gst, jfol, fst, max_entries=1)
        return lst, fst, gst, res, ok

    jstep = jax.jit(lambda *a: jm.runtime.run(prog, *a))
    js = [jlead.init_state(), jfol.init_state(), jlog.init_state()]
    ts = [tlead.init_state(), tfol.init_state(), tlog.init_state()]
    nl = (NOP, 1, (0, 0))
    windows = [
        arrays([[(INSERT, 1, (10, 11)), (INSERT, 5, (50, 51))],
                [(INSERT, 2, (20, 21)), nl],
                [nl, (INSERT, 3, (30, 31))],
                [(INSERT, 4, (40, 41)), nl]]),
        arrays([[(UPDATE, 1, (12, 13)), (UPDATE, 5, (52, 53))],
                [(UPDATE, 2, (22, 23)), (GET, 1, (0, 0))],
                [(GET, 3, (0, 0)), (UPDATE, 3, (32, 33))],
                [(UPDATE, 1, (14, 15)), nl]]),
        arrays([[(GET, 1, (0, 0)), (GET, 5, (0, 0))],
                [(GET, 2, (0, 0)), nl],
                [(GET, 3, (0, 0)), (GET, 4, (0, 0))],
                [nl, (GET, 1, (0, 0))]]),
    ]
    for i, (op, key, val) in enumerate(windows):
        *js, jres, jok = jstep(*js, op, key, val)
        ts[0], tres = tlead.op_window(ts[0], op, key, val, lockfree=True)
        ts[2], tok = tlog.append(ts[2], op, key, val)
        ts[2], ts[1], _applied = tlog.sync(ts[2], tfol, ts[1],
                                           max_entries=1)
        assert bool(tok.all()), "append must land (ring sized)"
        assert not pt.diverging_leaves(ts[0], ts[1]), f"window {i}"
        assert_trees_equal(jax_to_numpy(jres), torch_to_numpy(tres),
                           f"window {i} result")
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        for what, a, b in (("leader", js[0], ts[0]),
                           ("follower", js[1], ts[1]),
                           ("log", js[2], ts[2])):
            assert_trees_equal(jax_to_numpy(a), torch_to_numpy(b),
                               f"window {i} {what}")
    # the same-key UPDATE race resolved last-(participant, lane)-wins: the
    # follower serves the winning value
    np.testing.assert_array_equal(tres.value[3, 1].numpy(), [14, 15])


# ---------------------------------------------------------------- torture
def _torture_history(kv, rng, n_windows, key_space=8):
    """``tests/linearizability/test_torture.py::run_kv_history`` on the
    port: the op mix itself is drawn per history (update-heavy histories
    make fast windows, read-heavy ones pure-GET windows)."""
    rec = HistoryRecorder()
    stt = kv.init_state()
    mixes = [[0.10, 0.25, 0.25, 0.25, 0.15], [0.05, 0.15, 0.10, 0.65, 0.05],
             [0.10, 0.80, 0.00, 0.10, 0.00], [0.05, 0.10, 0.45, 0.10, 0.30]]
    codes = np.asarray([NOP, GET, INSERT, UPDATE, DELETE], np.int32)
    mix = mixes[int(rng.integers(len(mixes)))]
    for _w in range(n_windows):
        ops = rng.choice(codes, size=(P, B), p=mix)
        keys = rng.integers(1, key_space + 1, size=(P, B)).astype(np.uint32)
        vals = rng.integers(-99, 100, size=(P, B, W)).astype(np.int32)
        stt, res = kv.op_window(stt, ops, keys, vals)
        rec.record_kv_window(ops, keys, vals, res)
    return rec


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_torture_lockfree_histories_are_linearizable(backend):
    """``sweep_kv("lockfree", [(4, 2)], ...)`` on the port: 8 random
    histories of 13 windows, each checked by the Wing–Gong checker."""
    mgr = pt.make_manager(P, device="cpu", backend=backend)
    kv = pt.KVStore(None, f"tkv_lf_{backend}", mgr, slots_per_node=32,
                    value_width=W, num_locks=8, index_capacity=256,
                    lockfree=True)
    total = 0
    for seed in range(100, 108):
        rec = _torture_history(kv, np.random.default_rng(seed), 13)
        violation = check_history(KVSpec(W), rec.windows)
        assert violation is None, f"seed {seed}: {violation}"
        total += len(rec.windows)
    assert total >= 100
