"""The port's KVStore window path against the JAX package, bitwise.

Both stores use the remote-DMA backend (the JAX one runs its Pallas kernels
in interpret mode) at P=4, B=8, and run the same window sequence from one
state: a prefill, a mixed GET/UPDATE/INSERT/DELETE window, a window where
every lane hammers one key, a window of more inserts than the free stacks
hold, and windows on a store whose tiny index overflows.  After every
window each KVStoreState leaf, each KVResult leaf and a ``get_batch`` of
every key must be equal bit for bit, and so must the traffic-ledger rows
(modeled bytes, rounds and the bytes the DMA kernels measured).  All data
is integer: the tolerance is exact equality.

The read tier (``cache_slots``) and the placement policies (``"explicit"``
with per-lane ``targets=``, ``"hashed"``) run the same way on both the
one-sided and the remote-DMA backend, with ``get_batch(pred=...)`` repeated
so the cache hits, and the ledger's cache tier compared too.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            locked_ledger, reference_core, torch_to_numpy)

import torch  # noqa: E402

import repro_torch.core as pt  # noqa: E402

P, B, W, L = 4, 8, 2, 16
KEYS = np.arange(1, 97, dtype=np.uint32)


class _Pair:
    """The same store configuration in both packages, ledger enabled."""

    def __init__(self, name, backend="pallas", **cfg):
        core = reference_core()
        self.jmgr = core.make_manager(P, backend=backend)
        locked_ledger(self.jmgr)
        self.jkv = core.KVStore(None, name, self.jmgr, **cfg)
        self.jstep = jax.jit(lambda s, o, k, v: self.jmgr.runtime.run(
            self.jkv.op_window, s, o, k, v))
        self.jstep_t = jax.jit(lambda s, o, k, v, t: self.jmgr.runtime.run(
            lambda *a: self.jkv.op_window(*a[:4], targets=a[4]),
            s, o, k, v, t))
        self.jget = jax.jit(lambda s, k: self.jmgr.runtime.run(
            lambda st, kk: self.jkv.get_batch(st, kk), s, k))
        self.jget_p = jax.jit(lambda s, k, p: self.jmgr.runtime.run(
            lambda st, kk, pp: self.jkv.get_batch(st, kk, pred=pp), s, k, p))
        self.tmgr = pt.make_manager(P, device="cpu", backend=backend)
        self.tmgr.traffic.enable()
        self.tkv = pt.KVStore(None, name, self.tmgr, **cfg)
        self.jst = self.jkv.init_state()
        self.tst = self.tkv.init_state()

    def window(self, ops, keys, vals, targets=None):
        if targets is None:
            self.jst, jres = self.jstep(self.jst, ops, keys, vals)
        else:
            self.jst, jres = self.jstep_t(self.jst, ops, keys, vals, targets)
        self.tst, tres = self.tkv.op_window(self.tst, ops, keys, vals,
                                            targets=targets)
        return jax_to_numpy(jres), torch_to_numpy(tres)

    def reads(self, keys, pred):
        """get_batch(pred=...) on both stores, keeping the new states (the
        read tier's refills)."""
        self.jst, jv, jf = self.jget_p(self.jst, keys, pred)
        self.tst, tv, tf = self.tkv.get_batch(self.tst, keys, pred=pred)
        return (np.asarray(jv), np.asarray(jf)), (tv.numpy(), tf.numpy())

    def get_all(self):
        keys = np.broadcast_to(KEYS, (P, KEYS.size))
        _s, jv, jf = self.jget(self.jst, keys)
        _t, tv, tf = self.tkv.get_batch(self.tst, keys)
        return (np.asarray(jv), np.asarray(jf)), (tv.numpy(), tf.numpy())

    def assert_equal(self, what):
        assert_trees_equal(jax_to_numpy(self.jst),
                           pt.state_to_numpy(self.tst), what)
        (jv, jf), (tv, tf) = self.get_all()
        np.testing.assert_array_equal(jv, tv, err_msg=f"{what} get values")
        np.testing.assert_array_equal(jf, tf, err_msg=f"{what} get found")

    def assert_ledgers_equal(self):
        jax.effects_barrier()
        jl, tl = self.jmgr.traffic, self.tmgr.traffic
        assert jl.summary() == tl.summary()
        assert jl.rounds_summary() == tl.rounds_summary()
        assert jl.dma_summary() == tl.dma_summary()
        assert jl.cache_summary() == tl.cache_summary()
        if self.tkv.backend.name == "pallas":
            assert tl.total_dma_bytes() > 0


def _lanes(op, keys, vals=None):
    ops = np.broadcast_to(np.asarray(op, np.int32), (P, B)).copy()
    keys = np.asarray(keys, np.uint32).reshape(P, B)
    if vals is None:
        vals = np.stack([keys.astype(np.int32) * 3, np.full((P, B), 7)], -1)
    return ops, keys, np.asarray(vals, np.int32).reshape(P, B, W)


def _mixed(rng):
    ops = rng.choice([pt.GET, pt.UPDATE, pt.INSERT, pt.DELETE, pt.NOP],
                     size=(P, B), p=[.4, .2, .15, .15, .1]).astype(np.int32)
    keys = rng.choice(KEYS, size=(P, B)).astype(np.uint32)
    vals = rng.integers(-2 ** 31, 2 ** 31, size=(P, B, W), dtype=np.int64)
    return ops, keys, vals.astype(np.int32)


@pytest.fixture(scope="module")
def store():
    return _Pair("kv", slots_per_node=16, value_width=W, num_locks=L,
                 index_capacity=128)


def test_window_sequence_bitwise(store):
    rng = np.random.default_rng(11)
    windows = [
        # prefill: 24 inserts, 6 per participant, then NOPs
        _lanes(np.where(np.arange(P * B).reshape(P, B) % B < 6,
                        pt.INSERT, pt.NOP), KEYS[:P * B]),
        _mixed(rng),
        # every lane hammers one key with a mix of ops
        _lanes(rng.choice([pt.GET, pt.UPDATE, pt.DELETE, pt.INSERT],
                          size=(P, B)), np.full(P * B, 5)),
        _mixed(rng),
        # new keys: 8 inserts per participant fit its free stack, the
        # next 8 do not
        _lanes(pt.INSERT, KEYS[32:32 + P * B]),
        _lanes(pt.INSERT, KEYS[64:64 + P * B]),
        _mixed(rng),
    ]
    for i, w in enumerate(windows):
        jres, tres = store.window(*w)
        assert_trees_equal(jres, tres, f"window {i} result")
        store.assert_equal(f"after window {i}")
    # the capacity window really ran out of slots somewhere
    assert (np.asarray(jax_to_numpy(store.jst).free_top) == 0).any()
    store.assert_ledgers_equal()


def test_tiny_index_overflows_bitwise():
    s = _Pair("kv_tiny", slots_per_node=16, value_width=W, num_locks=L,
              index_capacity=8)
    rng = np.random.default_rng(12)
    for i, w in enumerate([_lanes(pt.INSERT, KEYS[:P * B]), _mixed(rng),
                           _lanes(pt.INSERT, KEYS[16:16 + P * B])]):
        jres, tres = s.window(*w)
        assert_trees_equal(jres, tres, f"window {i} result")
        s.assert_equal(f"after window {i}")
    assert pt.state_to_numpy(s.tst).idx_overflow.all()
    s.assert_ledgers_equal()


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_random_window_sequences_bitwise(seed):
    """Random windows on a crowded store: four locks (deep per-lock
    queues, several service rounds), a 40-position index that every key
    probes whole (inserts race for the same free position, several tracker
    waves) and 8 slots per participant (stacks run dry)."""
    s = _Pair(f"kv_rand{seed}", slots_per_node=8, value_width=W,
              num_locks=4, index_capacity=40)
    rng = np.random.default_rng(seed)
    keys = KEYS[:30]
    for i in range(6):
        ops = rng.choice([pt.GET, pt.UPDATE, pt.INSERT, pt.DELETE, pt.NOP],
                         size=(P, B), p=[.2, .15, .4, .2, .05])
        ks = rng.choice(keys, size=(P, B))
        vals = rng.integers(-2 ** 31, 2 ** 31, size=(P, B, W),
                            dtype=np.int64)
        jres, tres = s.window(ops.astype(np.int32), ks.astype(np.uint32),
                              vals.astype(np.int32))
        assert_trees_equal(jres, tres, f"seed {seed} window {i} result")
        s.assert_equal(f"seed {seed} after window {i}")
    s.assert_ledgers_equal()


def test_op_round_is_the_b1_window(store):
    """op_round on a fresh port store equals op_window with B=1."""
    mgr = pt.make_manager(P, device="cpu", backend="pallas")
    kv = pt.KVStore(None, "kv_round", mgr, slots_per_node=4, value_width=W,
                    num_locks=2, index_capacity=32)
    st_a = st_b = kv.init_state()
    for op, key in [(pt.INSERT, 3), (pt.GET, 3), (pt.UPDATE, 3),
                    (pt.DELETE, 3), (pt.GET, 3)]:
        ops = np.full((P,), op, np.int32)
        keys = np.full((P,), key, np.uint32)
        vals = np.arange(P * W, dtype=np.int32).reshape(P, W)
        st_a, ra = kv.op_round(st_a, ops, keys, vals)
        st_b, rb = kv.op_window(st_b, ops[:, None], keys[:, None],
                                vals[:, None])
        assert_trees_equal(torch_to_numpy(rb._replace(
            value=rb.value[:, 0], found=rb.found[:, 0],
            retries=rb.retries[:, 0])), torch_to_numpy(ra), "op_round")
        assert_trees_equal(pt.state_to_numpy(st_b), pt.state_to_numpy(st_a))


def test_state_numpy_round_trip(store):
    """state_from_numpy ∘ state_to_numpy is the identity, and the JAX
    state loads into the port with the reference's dtypes."""
    np_state = pt.state_to_numpy(store.tst)
    back = pt.state_to_numpy(pt.state_from_numpy(np_state, device="cpu"))
    assert_trees_equal(np_state, back, "round trip")
    j = jax_to_numpy(store.jst)
    assert_trees_equal(j, pt.state_to_numpy(pt.state_from_numpy(j, "cpu")),
                       "from JAX")


def test_port_continues_from_a_jax_state(store):
    """A window run by the port on a state loaded from the JAX store lands
    on the JAX store's next state."""
    rng = np.random.default_rng(13)
    w = _mixed(rng)
    tst = pt.state_from_numpy(jax_to_numpy(store.jst), device="cpu")
    jst, jres = store.jstep(store.jst, *w)
    tst, tres = store.tkv.op_window(tst, *w)
    assert_trees_equal(jax_to_numpy(jres), torch_to_numpy(tres), "result")
    assert_trees_equal(jax_to_numpy(jst), pt.state_to_numpy(tst), "state")


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
@pytest.mark.parametrize("placement", ["explicit", "hashed"])
def test_placed_cached_windows_bitwise(backend, placement):
    """Non-local placement (INSERTs allocate at their home through the
    request/grant round-trip) with the read tier on: mixed windows with
    per-lane targets, then repeated ``get_batch(pred=...)`` rounds — the
    second of each pair served from the cache — and UPDATE/DELETE windows
    whose invalidations the next reads must see."""
    s = _Pair(f"kv_{placement}_{backend}", backend=backend,
              slots_per_node=8, value_width=W, num_locks=8,
              index_capacity=64, cache_slots=2 * 8 * P, placement=placement)
    rng = np.random.default_rng(31)
    keys = KEYS[:40]

    def targets():
        return rng.integers(0, P, (P, B)).astype(np.int32) \
            if placement == "explicit" else None

    def reads(i):
        ks = rng.choice(keys, size=(P, B)).astype(np.uint32)
        pred = rng.random((P, B)) < 0.75
        for rep in range(2):
            j, t = s.reads(ks, pred)
            for a, b_ in zip(j, t):
                np.testing.assert_array_equal(a, b_, err_msg=f"reads {i}.{rep}")
            s.assert_equal(f"after reads {i}.{rep}")

    windows = [_lanes(pt.INSERT, keys[:P * B])]
    for _ in range(4):
        ops = rng.choice([pt.GET, pt.UPDATE, pt.INSERT, pt.DELETE, pt.NOP],
                         size=(P, B), p=[.3, .25, .2, .15, .1])
        ks = rng.choice(keys, size=(P, B)).astype(np.uint32)
        vals = rng.integers(-2 ** 31, 2 ** 31, (P, B, W), dtype=np.int64)
        windows.append((ops.astype(np.int32), ks, vals.astype(np.int32)))
    for i, w in enumerate(windows):
        jres, tres = s.window(*w, targets=targets())
        assert_trees_equal(jres, tres, f"window {i} result")
        s.assert_equal(f"after window {i}")
        reads(i)
    tl = s.tmgr.traffic
    assert tl.cache_summary()[f"{s.tkv.full_name}.readcache"]["hits"] > 0
    assert any(k.endswith(".alloc") for k in tl.rounds_summary())
    s.assert_ledgers_equal()


def test_cache_only_store_bitwise():
    """The read tier on a writer-local store: GET lanes inside op_window
    refill the cache too, and the windows' invalidations ride the tracker
    records."""
    s = _Pair("kv_cached_local", slots_per_node=16, value_width=W,
              num_locks=L, index_capacity=128, cache_slots=16)
    rng = np.random.default_rng(32)
    for i, w in enumerate([_lanes(pt.INSERT, KEYS[:P * B]), _mixed(rng),
                           _lanes(pt.GET, KEYS[:P * B]), _mixed(rng),
                           _lanes(pt.GET, KEYS[:P * B])]):
        jres, tres = s.window(*w)
        assert_trees_equal(jres, tres, f"window {i} result")
        s.assert_equal(f"after window {i}")
    s.assert_ledgers_equal()


def test_unported_knobs_are_refused():
    """Only the reference-impl store is still refused.  The read tier, the
    placement policies, the lock-free fast path and heat tracking build
    stores with their state leaves; a MOVE lane with no target under
    writer-local placement takes its lock and fails with no effect."""
    mgr = pt.make_manager(P, device="cpu")
    for knob in [dict(cache_slots=4), dict(placement="hashed"),
                 dict(lockfree=True), dict(track_heat=True)]:
        kv = pt.KVStore(None, f"kv_{len(mgr.channels)}", mgr,
                        slots_per_node=4, **knob)
        st = kv.init_state()
        assert st.cache.tags.shape == (P, knob.get("cache_slots", 0), 2)
        assert kv.placement == knob.get("placement", "local")
        assert kv.lockfree == knob.get("lockfree", False)
        rows = P * 4 if knob.get("track_heat") else 0
        assert st.heat.heat.shape == (P, rows)
        assert st.heat.heat.dtype == torch.float32
        assert st.heat.backlog.shape == (P,)
    with pytest.raises(NotImplementedError, match="reference_impl"):
        pt.KVStore(None, f"kv_{len(mgr.channels)}", mgr, slots_per_node=4,
                   reference_impl=True)
    kv = pt.KVStore(None, "kv_move", mgr, slots_per_node=4)
    st = kv.init_state()
    ins = np.full((P, 2), pt.NOP, np.int32)
    ins[:, 0] = pt.INSERT
    keys = np.arange(1, 2 * P + 1, dtype=np.uint32).reshape(P, 2)
    st, res = kv.op_window(st, ins, keys, np.ones((P, 2, 2), np.int32))
    assert res.found[:, 0].all()
    ops = np.full((P, 2), pt.GET, np.int32)
    ops[1, 1] = pt.MOVE
    st2, res = kv.op_window(st, ops, keys, np.zeros((P, 2, 2), np.int32))
    assert not res.found[1, 1]
    a, b = pt.state_to_numpy(st), pt.state_to_numpy(st2)
    for name in pt.KVStoreState._fields:
        if name != "locks":
            assert_trees_equal(getattr(a, name), getattr(b, name), name)
    with pytest.raises(ValueError):
        pt.KVStore(None, "kv_bad", mgr, slots_per_node=4, placement="nope")
    kx = pt.KVStore(None, "kv_explicit", mgr, slots_per_node=4,
                    placement="explicit")
    with pytest.raises(ValueError, match="targets"):
        kx.op_window(kx.init_state(), np.full((P, 1), pt.INSERT, np.int32),
                     np.ones((P, 1), np.uint32), np.zeros((P, 1, 2), np.int32))
