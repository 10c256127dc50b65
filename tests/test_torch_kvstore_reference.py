"""The map's executable specifications in the port against the JAX package,
bitwise: the scalar read path (``_get``) through the Appendix C cases, the
scalar round (``_op_round_reference``), the sequential tracker sweep
(``_apply_tracker_reference``) on record chains, a ``reference_impl=True``
store (flat-scan index, sequential sweep, one ticket served per lock a
round) on three backends and placed with MOVE lanes, and the migration
spec (``_migrate_reference``).  The same seeded numpy inputs go through
both packages; every state leaf, every result and the traffic-ledger rows
must be equal bit for bit.  Within the port, the specs are held against
the scheduled paths as the reference suite holds them: ``op_round`` bitwise
against ``_op_round_reference``, the wave scheduler logically against the
sweep, the hash store's results lane for lane against the spec store's, and
``migrate_window`` result for result against ``_migrate_reference``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            ledger_rows, locked_ledger, reference_core,
                            torch_to_numpy)

import torch  # noqa: E402

import repro_torch.core as pt  # noqa: E402

P, W = 4, 2


class _Pair:
    """One store configuration in both packages, ledgers on; every
    reference entry point jitted under the reference's runtime."""

    def __init__(self, name, backend="onesided", **cfg):
        core = reference_core()
        self.jmgr = core.make_manager(P, backend=backend)
        locked_ledger(self.jmgr)
        self.jkv = core.KVStore(None, name, self.jmgr, value_width=W, **cfg)
        self.tmgr = pt.make_manager(P, device="cpu", backend=backend)
        self.tmgr.traffic.enable()
        self.tkv = pt.KVStore(None, name, self.tmgr, value_width=W, **cfg)
        self.jst, self.tst = self.jkv.init_state(), self.tkv.init_state()
        self._jit = {}

    def jcall(self, method, *args, **kw):
        """``self.jkv.<method>(st, *args, **kw)`` under the reference's
        runtime, jitted once per (method, keywords)."""
        key = (method, tuple(sorted(kw)))
        if key not in self._jit:
            fn = getattr(self.jkv, method)

            def prog(st, *a):
                return self.jmgr.runtime.run(
                    lambda s, *aa: fn(s, *aa[:len(args)],
                                      **dict(zip(sorted(kw),
                                                 aa[len(args):]))),
                    st, *a)
            self._jit[key] = jax.jit(prog)
        return self._jit[key](self.jst, *args,
                              *(kw[k] for k in sorted(kw)))

    def step(self, method, *args, **kw):
        """The same call on both stores, keeping both new states; returns
        the rest of each output, as numpy trees."""
        jout = self.jcall(method, *args, **kw)
        tout = getattr(self.tkv, method)(self.tst, *args, **kw)
        self.jst, self.tst = jout[0], tout[0]
        return jax_to_numpy(jout[1:]), tuple(torch_to_numpy(t)
                                             for t in tout[1:])

    def assert_equal(self, what):
        assert_trees_equal(jax_to_numpy(self.jst),
                           pt.state_to_numpy(self.tst), what)

    def assert_ledgers_equal(self):
        jax.effects_barrier()
        assert ledger_rows(self.jmgr.traffic) == \
            ledger_rows(self.tmgr.traffic)


def _assert_out(jout, tout, what):
    for i, (a, b) in enumerate(zip(jout, tout)):
        if isinstance(a, tuple):
            assert_trees_equal(a, b, f"{what} output {i}")
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, what
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what} output {i}")


def v(key, salt=0):
    return (int(key) * 10 + salt, int(key) * 100 + salt)


def _window(rng, B, keys, p=(.1, .3, .3, .15, .15), moves=False):
    ops = [pt.NOP, pt.GET, pt.INSERT, pt.UPDATE, pt.DELETE]
    if moves:
        ops, p = ops + [pt.MOVE], list(p[:-1]) + [p[-1] / 2, p[-1] / 2]
    op = rng.choice(ops, size=(P, B), p=p).astype(np.int32)
    ks = rng.choice(keys, size=(P, B)).astype(np.uint32)
    vals = rng.integers(-2 ** 31, 2 ** 31, (P, B, W)).astype(np.int32)
    return op, ks, vals


# ------------------------------------------------ Appendix C through _get
@pytest.fixture(scope="module", params=[False, True],
                ids=["hash", "reference_impl"])
def seeded(request):
    """Both packages' stores with key 5 inserted by participant 0."""
    s = _Pair("kv", slots_per_node=4, num_locks=2, index_capacity=64,
              reference_impl=request.param)
    op = np.array([[pt.INSERT], [pt.NOP], [pt.NOP], [pt.NOP]], np.int32)
    key = np.array([[5], [1], [1], [1]], np.uint32)
    val = np.array([[v(5)], [(0, 0)], [(0, 0)], [(0, 0)]], np.int32)
    s.step("op_window", op, key, val)
    s.assert_equal("seeded")
    return s, s.jst, s.tst


class TestAppendixCValidation:
    """The read path's case analysis, through the scalar ``_get``:
    participant 1 reads key 5, on the hash store and on the spec store."""

    def _get5(self, s, jst, tst):
        s.jst, s.tst = jst, tst
        key = np.array([1, 5, 1, 1], np.uint32)
        pred = np.array([False, True, False, False])
        jout = s.jcall("_get", key, pred)
        tout = s.tkv._get(tst, torch.from_numpy(key), torch.from_numpy(pred))
        value, found, tries = (t.numpy() if isinstance(t, torch.Tensor)
                               else t for t in tout)
        np.testing.assert_array_equal(np.asarray(jout[0]), value)
        np.testing.assert_array_equal(np.asarray(jout[1]), found)
        np.testing.assert_array_equal(np.asarray(jout[2]), [tries] * P)
        s.assert_ledgers_equal()
        return value, found, tries

    def _rows(self, seeded, edit):
        _s, jst, tst = seeded
        buf = np.asarray(jst.rows.buf).copy()
        slot = np.nonzero(buf[0, :, W + 1] == 1)[0][0]   # the row at node 0
        edit(buf, slot)
        return (jst._replace(rows=jst.rows._replace(buf=jnp.asarray(buf))),
                tst._replace(rows=tst.rows._replace(
                    buf=torch.from_numpy(buf))))

    def test_case1_valid_read_returns_value(self, seeded):
        s, jst, tst = seeded
        value, found, tries = self._get5(s, jst, tst)
        assert found[1] and tries == 0
        np.testing.assert_array_equal(value[1], v(5))

    def test_case2_torn_row_retries_then_empty(self, seeded):
        def tear(buf, slot):
            buf[0, slot, 0] ^= 0x5A5A
        _value, found, tries = self._get5(seeded[0],
                                          *self._rows(seeded, tear))
        assert not found[1] and tries == 3

    def test_case3_invalid_bit_returns_empty(self, seeded):
        s = seeded[0]

        def invalid(buf, slot):
            row = torch.from_numpy(buf[0, slot].copy())
            row[W + 1] = 0
            buf[0, slot] = s.tkv.encode_row(row[:W], row[W] & 0xFFFFFFFF,
                                            False).numpy()
        _value, found, tries = self._get5(s, *self._rows(seeded, invalid))
        assert not found[1] and tries == 0

    def test_case4_counter_mismatch_returns_empty(self, seeded):
        from repro_torch.core.kvstore import IDX_CTR, IDX_KEY
        s, jst, tst = seeded
        idx = np.asarray(jst.idx).copy()
        pos = np.nonzero(idx[1, :, IDX_KEY] == 5)[0][0]
        idx[1, pos, IDX_CTR] -= 1
        _value, found, tries = self._get5(
            s, jst._replace(idx=jnp.asarray(idx)),
            tst._replace(idx=torch.from_numpy(idx)))
        assert not found[1] and tries == 0


# ------------------------------------------------ the scalar round
@pytest.mark.parametrize("seed", range(3))
def test_op_round_bitidentical_to_reference(seed):
    """op_round (the B=1 window) is bit-identical to the port's
    ``_op_round_reference``, and that to the JAX package's, on randomized
    mixed-op traces: full state and results, and the spec's ledger rows
    (seed 2 on a cache-enabled store, whose spec GET keeps no refills)."""
    s = _Pair(f"kv{seed}", backend="pallas", slots_per_node=4, num_locks=2,
              index_capacity=64, cache_slots=8 if seed == 2 else 0)
    rng = np.random.default_rng(40 + seed)
    st_w = s.tst
    for rnd in range(6):
        op = rng.choice([pt.NOP, pt.GET, pt.INSERT, pt.UPDATE, pt.DELETE],
                        size=P, p=[.1, .3, .3, .15, .15]).astype(np.int32)
        key = rng.integers(1, 7, P).astype(np.uint32)
        val = np.array([v(k, rnd) for k in key], np.int32)
        jout, tout = s.step("_op_round_reference", op, key, val)
        _assert_out(jout, tout, f"round {rnd}")
        s.assert_equal(f"round {rnd}")
        s.tmgr.traffic.disable()         # the ledger holds the spec's rows
        st_w, res_w = s.tkv.op_round(st_w, op, key, val)
        s.tmgr.traffic.enable()
        a, b = pt.state_to_numpy(s.tst), pt.state_to_numpy(st_w)
        if seed == 2:
            # the spec's GET drops its cache refills (it returns no state)
            a, b = a._replace(cache=b.cache), b
        assert_trees_equal(a, b, f"op_round {rnd}")
        assert_trees_equal(tout[0], torch_to_numpy(res_w), f"res {rnd}")
    s.assert_ledgers_equal()


# ------------------------------------------------ the sequential sweep
def _recs(*entries):
    """Tracker records from (kind, key, node, slot, ctr) tuples."""
    return np.array(entries, np.int32).reshape(-1, 5)


class _Apply:
    """Both tracker variants of one store shape in both packages, each
    reference variant jitted once (one harness a shape, see
    :func:`_harness`)."""

    def __init__(self, C, S, **cfg):
        self.s = _Pair(f"kv_apply_c{C}", slots_per_node=S, num_locks=2,
                       index_capacity=C, **cfg)
        self.jfn = {v: jax.jit(lambda t, r, m=m: self.s.jmgr.runtime.run(
            getattr(self.s.jkv, m), t, r))
            for v, m in (("seq", "_apply_tracker_reference"),
                         ("vec", "_apply_tracker_vectorized"))}

    def init(self):
        return self.s.jkv.init_state(), self.s.tkv.init_state()

    def apply(self, st, recs, variant):
        """Apply ``recs`` with one variant on a (JAX, port) state pair;
        both bitwise equal, the port's state and applied flags returned."""
        g = np.broadcast_to(recs, (P,) + recs.shape)
        jst, japp = self.jfn[variant](st[0], g)
        method = {"seq": self.s.tkv._apply_tracker_reference,
                  "vec": self.s.tkv._apply_tracker_vectorized}[variant]
        tst, tapp = method(st[1], torch.from_numpy(recs))
        assert_trees_equal(jax_to_numpy(jst), pt.state_to_numpy(tst),
                           f"{variant} state")
        np.testing.assert_array_equal(np.asarray(japp), tapp.numpy())
        return (jst, tst), tapp[0].numpy()

    def lookup(self, st, keys):
        ks = torch.tensor(keys, dtype=torch.int64).expand(P, len(keys))
        return [t[0].numpy() for t in
                self.s.tkv._index_lookup_reference(st[1], ks)]


_HARNESSES = {}


def _harness(C, S, **cfg):
    key = (C, S, tuple(sorted(cfg.items())))
    if key not in _HARNESSES:
        _HARNESSES[key] = _Apply(C, S, **cfg)
    return _HARNESSES[key]


def _check_chain(recs, C=8, S=16, steps=1, **cfg):
    """Both variants on ``recs`` (split into ``steps`` applications), each
    bitwise against the JAX package's, and the wave scheduler logically
    equal to the sweep: applied flags, the key → (node, slot, ctr) mapping
    through the layout-agnostic flat scan, free stacks, overflow latch."""
    out = {}
    h = _harness(C, S, **cfg)
    for variant in ("seq", "vec"):
        st = h.init()
        applied = []
        for part in np.array_split(recs, steps):
            st, app = h.apply(st, part, variant)
            applied.append(app)
        out[variant] = (h, st, np.concatenate(applied))
    (hv, sv, av), (hs, ss, as_) = out["vec"], out["seq"]
    np.testing.assert_array_equal(av, as_)
    keys = sorted(set(int(r[1]) for r in recs)) + [999]
    lv, ls = hv.lookup(sv, keys), hs.lookup(ss, keys)
    np.testing.assert_array_equal(lv[0], ls[0], err_msg="found")
    for name, a, b in zip("node slot ctr".split(), lv[2:], ls[2:]):
        np.testing.assert_array_equal(a[lv[0]], b[lv[0]], err_msg=name)
    a, b = pt.state_to_numpy(sv[1]), pt.state_to_numpy(ss[1])
    for name in ("free_top", "free_stack", "idx_overflow", "slot_ctr",
                 "heat"):
        assert_trees_equal(getattr(a, name), getattr(b, name), name)
    return av


class TestTrackerApplyEquivalence:
    def test_same_key_insert_delete_insert_chain(self):
        _check_chain(_recs((1, 7, 0, 0, 1), (2, 7, 0, 0, 1),
                           (1, 7, 1, 3, 2)))

    def test_interleaved_chains_and_distinct_keys(self):
        _check_chain(_recs(
            (1, 5, 0, 0, 1), (1, 6, 1, 1, 1), (2, 5, 0, 0, 1),
            (1, 5, 2, 2, 2), (2, 6, 1, 1, 1), (1, 8, 3, 3, 1),
            (2, 8, 3, 3, 1), (1, 6, 0, 4, 2)))

    def test_delete_miss_and_dead_records(self):
        app = _check_chain(_recs((0, 1, 0, 0, 0), (2, 42, 0, 0, 1),
                                 (1, 3, 0, 1, 1), (0, 2, 0, 0, 0),
                                 (2, 3, 0, 1, 1)))
        np.testing.assert_array_equal(app, [False, False, True, False,
                                            True])

    def test_host_slot_gc_order_matches(self):
        ins = [(1, 10 + i, i % P, i, 1) for i in range(8)]
        dels = [(2, 10 + i, i % P, i, 1) for i in (5, 1, 3, 7)]
        _check_chain(_recs(*ins, *dels), C=32, steps=2)

    def test_index_overflow_latches(self):
        app = _check_chain(_recs(*[(1, 20 + i, 0, i, 1) for i in range(5)]),
                           C=4)
        np.testing.assert_array_equal(app, [True] * 4 + [False])

    def test_moves_repoint_free_and_forget(self):
        """MOVE records (kind 3) on a heat-tracked store: the entry moves,
        the old host frees the vacated slot, bumps its reuse counter and
        forgets its heat; a MOVE of an absent key misses."""
        recs = _recs((1, 4, 0, 2, 1), (1, 9, 1, 5, 1), (3, 4, 2, 7, 3),
                     (3, 9, 1, 6, 2), (3, 77, 3, 0, 1), (2, 4, 2, 7, 3),
                     (1, 4, 3, 1, 4))
        app = _check_chain(recs, C=16, steps=3, track_heat=True)
        np.testing.assert_array_equal(app, [True, True, True, True, False,
                                            True, True])

    @pytest.mark.parametrize("seed", range(4))
    def test_random_valid_chains(self, seed):
        """Randomized protocol-valid record streams: same-key records
        alternate insert and delete (or move), as the lock FIFO
        guarantees."""
        rng = np.random.default_rng(200 + seed)
        live, entries, ctr = {}, [], 0
        for _ in range(12):
            key = int(rng.integers(1, 7))
            if live.get(key) and rng.random() < .3:
                loc = (int(rng.integers(0, P)), ctr % 16, ctr + 1)
                entries.append((3, key) + loc)
            elif live.get(key):
                entries.append((2, key) + live[key])
                loc = None
            else:
                loc = (int(rng.integers(0, P)), ctr % 16, ctr + 1)
                entries.append((1, key) + loc)
            ctr += 1
            live[key] = loc
        _check_chain(_recs(*entries), C=16, steps=2)


# ------------------------------------------------ the spec store
@pytest.mark.parametrize("backend", ["onesided", "active_message", "pallas"])
def test_reference_store_windows_bitwise(backend):
    """A reference-impl store over random windows on a crowded store (two
    locks: deep queues, one ticket served per lock a round), bitwise
    against the JAX reference-impl store; its results lane for lane the
    port's hash store's, and its logical contents the hash store's."""
    s = _Pair(f"kv_ref_{backend}", backend=backend, slots_per_node=6,
              num_locks=2, index_capacity=32, reference_impl=True)
    hmgr = pt.make_manager(P, device="cpu", backend=backend)
    hkv = pt.KVStore(None, "kv_hash", hmgr, slots_per_node=6,
                     value_width=W, num_locks=2, index_capacity=32)
    hst = hkv.init_state()
    rng = np.random.default_rng(61)
    keys = np.arange(1, 13, dtype=np.uint32)
    for i in range(5):
        w = _window(rng, 3, keys, p=(.05, .25, .4, .15, .15))
        jout, tout = s.step("op_window", *w)
        _assert_out(jout, tout, f"window {i}")
        s.assert_equal(f"after window {i}")
        hst, hres = hkv.op_window(hst, *w)
        assert_trees_equal(tout[0], torch_to_numpy(hres), f"hash {i}")
    _, got = s.step("get_batch", np.broadcast_to(keys, (P, keys.size)))
    _hst, hv, hf = hkv.get_batch(hst, np.broadcast_to(keys, (P, keys.size)))
    np.testing.assert_array_equal(got[1], hf.numpy())
    np.testing.assert_array_equal(got[0], hv.numpy())
    ks = torch.from_numpy(np.broadcast_to(keys, (P, keys.size)).astype(
        np.int64))
    fr = s.tkv._index_lookup_reference(s.tst, ks)
    fh = hkv._index_lookup_reference(hst, ks)
    # the same keys live on the same homes (slot choices differ: the spec
    # allocates one ticket a lock a round)
    np.testing.assert_array_equal(fr[0].numpy(), fh[0].numpy())
    np.testing.assert_array_equal(fr[2][fr[0]].numpy(), fh[2][fr[0]].numpy())
    s.assert_ledgers_equal()


def test_placed_reference_store_with_moves_bitwise():
    """A placed reference-impl store with the read tier and heat tracking
    on: windows with INSERTs homed away from their writers and MOVE lanes,
    then the migration spec — each bitwise against the JAX package's — and
    ``migrate_window`` result for result against the spec."""
    s = _Pair("kv_ref_placed", backend="pallas", slots_per_node=8,
              num_locks=4, index_capacity=48, reference_impl=True,
              placement="explicit", cache_slots=16, track_heat=True)
    rng = np.random.default_rng(71)
    keys = np.arange(1, 17, dtype=np.uint32)
    for i in range(3):
        w = _window(rng, 3, keys, p=(.05, .25, .4, .1, .2), moves=True)
        targets = rng.integers(0, P, (P, 3)).astype(np.int32)
        jout, tout = s.step("op_window", *w, targets=targets)
        _assert_out(jout, tout, f"window {i}")
        s.assert_equal(f"after window {i}")
    _check_migrations(s, rng, keys)


def test_migrate_reference_on_hash_store_bitwise():
    """On a scheduled (hashed) store too: ``_migrate_reference`` bitwise
    against the JAX package's, ``migrate_window`` result for result."""
    s = _Pair("kv_mig", slots_per_node=8, num_locks=8, index_capacity=64,
              placement="hashed")
    keys = np.arange(1, 4 * P + 1, dtype=np.uint32)
    s.step("op_window", np.full((P, 4), pt.INSERT, np.int32),
           keys.reshape(P, 4),
           np.stack([keys * 3, keys * 5], -1).astype(np.int32).reshape(
               P, 4, W))
    _check_migrations(s, np.random.default_rng(81), keys)


def _check_migrations(s, rng, keys):
    """Two lanes of MOVEs a participant through ``_migrate_reference`` on
    both packages, bitwise; then ``migrate_window`` on the port from the
    same state: the same moved lanes and the same contents after."""
    ks = rng.choice(keys, (P, 2)).astype(np.uint32)
    dests = rng.integers(0, P, (P, 2)).astype(np.int32)
    preds = rng.random((P, 2)) < .8
    st0 = s.tst
    jout, tout = s.step("_migrate_reference", ks, dests, preds=preds)
    _assert_out(jout, tout, "_migrate_reference")
    s.assert_equal("after _migrate_reference")
    s.assert_ledgers_equal()
    assert tout[0].any()
    s.tmgr.traffic.disable()
    st_w, moved = s.tkv.migrate_window(st0, ks, dests, preds=preds)
    np.testing.assert_array_equal(moved.numpy(), tout[0])
    every = np.broadcast_to(keys, (P, keys.size))
    after = [s.tkv.get_batch(st, every)[1:] for st in (s.tst, st_w)]
    for a, b in zip(*after):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lockfree_spec_store_is_refused():
    mgr = pt.make_manager(P, device="cpu")
    with pytest.raises(ValueError, match="lockfree"):
        pt.KVStore(None, "kv_lf", mgr, slots_per_node=4, lockfree=True,
                   reference_impl=True)
    kv = pt.KVStore(None, "kv_ref", mgr, slots_per_node=4,
                    reference_impl=True)
    with pytest.raises(ValueError, match="lockfree"):
        kv.op_window(kv.init_state(), np.full((P, 1), pt.GET, np.int32),
                     np.ones((P, 1), np.uint32),
                     np.zeros((P, 1, W), np.int32), lockfree=True)
