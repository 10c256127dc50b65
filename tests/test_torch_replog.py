"""The port's replication tier against the JAX package's, bitwise: the
ReplicatedLog (with its Ringbuffer and promotion-table SST), the
FailureDetector and the follower KVStores, mirroring tests/test_replog.py,
the classes of tests/test_failover.py (promotion, zombie fence,
append-with-retry, crash injection) and those of tests/test_selfhealing.py
(detector semantics, heartbeat detection, cascading promotion, snapshot and
replay rejoin, bounded backoff), on the one-sided and remote-DMA backends.

Every step runs in both packages on the same numpy-made windows, and after
each one the log state (ring, ptable, counters, fence heads), the leader
store, every follower store, the detector state and the rejoin state must be
equal leaf by leaf, bit for bit; so must every returned value.  At the end of
a scenario the traffic ledgers must agree row for row (corrupt and fenced
tiers included).  The scenarios then assert the reference tests' semantics on
the port's values.  Also: ``export_window_records`` /
``replay_window_records``, ``snapshot_words`` and the rejoin chunk counts,
and ``FaultPlan``'s validation."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            ledger_rows, locked_ledger, reference_core,
                            torch_to_numpy)

import torch  # noqa: E402

import repro_torch.core as pt  # noqa: E402
from repro_torch.distributed import FaultPlan  # noqa: E402

P, B, CAP, THRESH = 4, 2, 4, 2
KW = dict(slots_per_node=6, value_width=2, num_locks=8, index_capacity=64)
NOP, GET, INSERT, UPDATE, DELETE = pt.NOP, pt.GET, pt.INSERT, pt.UPDATE, \
    pt.DELETE
NL = (NOP, 1, (0, 0))
ALL = np.ones(P, bool)


# ---------------------------------------------------------------------------
# windows (the reference tests' schedules)
# ---------------------------------------------------------------------------

def window(*lanes):
    op = np.asarray([[o[0] for o in ln] for ln in lanes], np.int32)
    key = np.asarray([[o[1] for o in ln] for ln in lanes], np.uint32)
    val = np.asarray([[o[2] for o in ln] for ln in lanes], np.int32)
    return op, key, val


WNOP = window(*[[NL] * B for _ in range(P)])


def wmut(*triples, dead=(0,)):
    """A window with ``dead`` lanes all-NOP and ``triples`` spread over the
    remaining lanes (a dead participant's slice would have no live
    submitter at replay)."""
    live = [p for p in range(P) if p not in dead]
    lanes = [[NL] * B for _ in range(P)]
    for i, t in enumerate(triples):
        lanes[live[i % len(live)]][i // len(live)] = t
    return window(*lanes)


def mkw(i, dead=(0,)):
    """Deterministic mutation window ``i`` routed around ``dead`` lanes."""
    k = 1 + (i % 5)
    return wmut((INSERT if i < 5 else UPDATE, k, (10 * k + i, i)),
                (UPDATE if i >= 5 else INSERT, k + 5, (20 * k, i)),
                dead=dead)


def mixed(rng, keys=12):
    """A random (P, B) window of GET/INSERT/UPDATE/DELETE/NOP lanes over
    distinct keys."""
    ks = rng.choice(np.arange(1, keys + 1), size=P * B, replace=False)
    ops = rng.choice([GET, INSERT, INSERT, UPDATE, DELETE, NOP], size=P * B)
    vals = rng.integers(-2 ** 31, 2 ** 31, (P * B, 2))
    return (ops.astype(np.int32).reshape(P, B),
            ks.astype(np.uint32).reshape(P, B),
            vals.astype(np.int32).reshape(P, B, 2))


def _pt(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    if t.dtype == torch.uint32:
        t = t.to(torch.int64)
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# the twin: the same channels and steps in both packages
# ---------------------------------------------------------------------------

class Twin:
    """A leader store, ``n_followers`` follower stores, a ReplicatedLog and
    a FailureDetector in each package, on one backend, with jitted JAX steps
    (the reference tests' ``prog`` functions) and their port counterparts.
    Each step runs on both sides and checks every state bitwise."""

    def __init__(self, backend, n_followers=1, capacity=CAP, ledger=True):
        core = reference_core()
        self.core = core
        self.backend = backend
        self.jm = core.make_manager(P, backend=backend)
        self.tm = pt.make_manager(P, device="cpu", backend=backend)
        if ledger:
            locked_ledger(self.jm)
            self.tm.traffic.enable()
        self.cap = capacity
        side = {}
        for name, mod, mgr in (("j", core, self.jm), ("t", pt, self.tm)):
            lead = mod.KVStore(None, "leader", mgr, **KW)
            fols = [mod.KVStore(None, f"follower{i}", mgr, **KW)
                    for i in range(n_followers)]
            log = mod.ReplicatedLog(None, "log", mgr, store=lead, window=B,
                                    capacity=capacity, rejoin_chunk=32)
            det = mod.FailureDetector(None, "det", mgr, threshold=THRESH)
            side[name] = (lead, fols, log, det)
        self.jlead, self.jfols, self.jlog, self.jdet = side["j"]
        self.tlead, self.tfols, self.tlog, self.tdet = side["t"]
        self._jit = {}

    # -- jitted reference steps, built on first use ----------------------------
    def _j(self, name, build):
        if name not in self._jit:
            self._jit[name] = jax.jit(build())
        return self._jit[name]

    def jrun(self, name, prog, *args):
        run = self.jm.runtime.run
        return self._j(name, lambda: lambda *a: run(prog, *a))(*args)


class World:
    """Both packages' states of one twin, stepped together."""

    def __init__(self, tw: Twin):
        self.tw = tw
        self.j = dict(lead=tw.jlead.init_state(),
                      fols=tuple(f.init_state() for f in tw.jfols),
                      log=tw.jlog.init_state(), det=tw.jdet.init_state())
        self.t = dict(lead=tw.tlead.init_state(),
                      fols=tuple(f.init_state() for f in tw.tfols),
                      log=tw.tlog.init_state(), det=tw.tdet.init_state())
        self.check("init")

    def check(self, what, jout=(), tout=()):
        for k in ("lead", "log", "det"):
            assert_trees_equal(jax_to_numpy(self.j[k]),
                               torch_to_numpy(self.t[k]), f"{what}: {k}")
        for i, (a, b) in enumerate(zip(self.j["fols"], self.t["fols"])):
            assert_trees_equal(jax_to_numpy(a), torch_to_numpy(b),
                               f"{what}: follower {i}")
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(np.asarray(a), torch_to_numpy(b),
                                          err_msg=what)

    def check_ledgers(self):
        assert ledger_rows(self.tw.jm.traffic) \
            == ledger_rows(self.tw.tm.traffic)

    # -- the serving window of the §13 protocol ------------------------------
    def hb_step(self, wnd, alive, max_attempts=2, heartbeat=True,
                what="hb_step"):
        """Leader apply + heartbeat/observe (unless ``heartbeat`` is False)
        + append_with_retry through the current owner + live-lane sync.
        Returns the port's (verdict (P,) or None, ok, applied) of lane 0."""
        tw = self.tw
        op, key, val = wnd
        alive = np.asarray(alive, bool)

        def prog(lst, fst, gst, dst, op, key, val, alive):
            me = tw.jm.runtime.my_id()
            lst, _res = tw.jlead.op_window(lst, op, key, val)
            verdict = alive
            if heartbeat:
                gst, dst, verdict = tw.jlog.heartbeat_and_detect(
                    gst, dst, tw.jdet, pred=alive[me])
            gst, fst, ok, applied = tw.jlog.append_with_retry(
                gst, op, key, val, tw.jfols, fst,
                max_attempts=max_attempts, pred=alive[gst.ring.owner],
                sync_pred=alive[me])
            return lst, fst, gst, dst, verdict, ok, applied

        j = self.j
        (j["lead"], j["fols"], j["log"], j["det"], jv, jok,
         jn) = tw.jrun(f"hb{max_attempts}{heartbeat}", prog, j["lead"],
                       j["fols"], j["log"], j["det"], op, key, val,
                       np.broadcast_to(alive, (P, P)))
        t = self.t
        a = torch.from_numpy(alive)
        t["lead"], _res = tw.tlead.op_window(t["lead"], op, key, val)
        tv = a.expand(P, P)
        if heartbeat:
            t["log"], t["det"], tv = tw.tlog.heartbeat_and_detect(
                t["log"], t["det"], tw.tdet, pred=a)
        t["log"], t["fols"], tok, tn = tw.tlog.append_with_retry(
            t["log"], op, key, val, tw.tfols, t["fols"],
            max_attempts=max_attempts,
            pred=a[t["log"].ring.owner.long()], sync_pred=a)
        self.check(what, (jv, jok, jn), (tv, tok, tn))
        return tv[0].numpy().copy(), bool(tok[0]), int(tn[0])

    def drive(self, n, alive, dead=(0,), start=0):
        verdict = None
        for i in range(start, start + n):
            verdict, _ok, _n = self.hb_step(mkw(i, dead=dead), alive,
                                            what=f"window {i}")
        return verdict

    def append_ns(self, wnd, alive=ALL):
        """Leader apply + append WITHOUT the drains."""
        tw = self.tw
        op, key, val = wnd
        alive = np.asarray(alive, bool)

        def prog(lst, gst, op, key, val, alive):
            lst, _res = tw.jlead.op_window(lst, op, key, val)
            gst, ok = tw.jlog.append(gst, op, key, val,
                                     pred=alive[gst.ring.owner])
            return lst, gst, ok

        j, t = self.j, self.t
        j["lead"], j["log"], jok = tw.jrun(
            "append", prog, j["lead"], j["log"], op, key, val,
            np.broadcast_to(alive, (P, P)))
        a = torch.from_numpy(alive)
        t["lead"], _res = tw.tlead.op_window(t["lead"], op, key, val)
        t["log"], tok = tw.tlog.append(t["log"], op, key, val,
                                       pred=a[t["log"].ring.owner.long()])
        self.check("append", (jok,), (tok,))
        return bool(tok[0])

    def sync(self, mask=ALL, max_entries=1):
        tw = self.tw
        mask = np.asarray(mask, bool)

        def prog(gst, fst, mask):
            gst, fst, applied = tw.jlog.sync(gst, tw.jfols, fst,
                                             max_entries=max_entries,
                                             pred=mask)
            return gst, fst, applied, tw.jlog.lag(gst)

        j, t = self.j, self.t
        j["log"], j["fols"], jn, jlag = tw.jrun(
            f"sync{max_entries}", prog, j["log"], j["fols"], mask)
        t["log"], t["fols"], tn = tw.tlog.sync(
            t["log"], tw.tfols, t["fols"], max_entries=max_entries,
            pred=torch.from_numpy(mask))
        tlag = tw.tlog.lag(t["log"])
        self.check("sync", (jn, jlag), (tn, tlag))
        return int(tn[0]), int(tlag[0])

    def drain(self, mask=ALL):
        n = 0
        while self.lag():
            self.sync(mask)
            n += 1
            assert n <= 2 * CAP, "drain must terminate"
        return n

    def lag(self):
        return int(self.tw.tlog.lag(self.t["log"])[0])

    def _log_op(self, name, jprog, tfn, *args):
        """A step on the log state alone: (state, *args) → state or
        (state, out)."""
        tw = self.tw
        jres = tw.jrun(name, jprog, self.j["log"], *args)
        tres = tfn(self.t["log"], *[_pt(a) for a in args])
        if not isinstance(tres, pt.ReplicatedLogState):
            self.j["log"], jo = jres
            self.t["log"], to = tres
            self.check(name, (jo,), (to,))
            return to
        self.j["log"], self.t["log"] = jres, tres
        self.check(name)
        return None

    def promote(self, alive):
        tw = self.tw
        w = self._log_op("promote", tw.jlog.promote, tw.tlog.promote,
                         np.broadcast_to(np.asarray(alive, bool), (P, P)))
        return int(w[0])

    def gather(self, alive):
        tw = self.tw
        self._log_op("gather", tw.jlog.promote_gather,
                     tw.tlog.promote_gather,
                     np.broadcast_to(np.asarray(alive, bool), (P, P)))

    def fence(self, alive):
        tw = self.tw
        self._log_op("fence", tw.jlog.promote_fence, tw.tlog.promote_fence,
                     np.broadcast_to(np.asarray(alive, bool), (P, P)))

    def republish(self, alive, limit):
        tw = self.tw
        return int(self._log_op(
            f"repub{limit}",
            lambda g, a: tw.jlog.promote_republish(g, a, limit=limit),
            lambda g, a: tw.tlog.promote_republish(g, a, limit=limit),
            np.broadcast_to(np.asarray(alive, bool), (P, P)))[0])

    def zombie(self, wnd, zombie=0, stale_epoch=0):
        tw = self.tw
        op, key, val = wnd
        landed = self._log_op(
            "zombie",
            lambda g, o, k, v: tw.jlog.zombie_publish(
                g, o, k, v, zombie=zombie, stale_epoch=stale_epoch),
            lambda g, o, k, v: tw.tlog.zombie_publish(
                g, o, k, v, zombie=zombie, stale_epoch=stale_epoch),
            op, key, val)
        return bool(landed[0])

    def readmit(self, node):
        tw = self.tw
        self._log_op("readmit", lambda g, n: tw.jlog.readmit(g, n),
                     tw.tlog.readmit, np.full((P,), node, np.int32))

    def readmit_detector(self, node):
        tw = self.tw
        self.j["det"] = tw.jrun("det_readmit",
                                lambda d, n: tw.jdet.readmit(d, n),
                                self.j["det"], np.full((P,), node, np.int32))
        self.t["det"] = tw.tdet.readmit(self.t["det"], node)
        self.check("detector readmit")

    def needs_snapshot(self, node):
        tw = self.tw
        jn = tw.jrun("needs", lambda g, n: tw.jlog.needs_snapshot(g, n),
                     self.j["log"], np.full((P,), node, np.int32))
        tn = tw.tlog.needs_snapshot(self.t["log"], node)
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        return bool(tn[0])

    def rejoin(self, node=0, between=None):
        """The snapshot transfer, step by step on both sides, the rejoin
        state compared after every chunk.  Returns (rounds, restarts)."""
        tw = self.tw

        def prog(gst, rst, lst, fst, node):
            return tw.jlog.rejoin_step(gst, rst, lst, tw.jfols, fst, node)

        jr, tr = tw.jlog.rejoin_init(), tw.tlog.rejoin_init()
        assert_trees_equal(jax_to_numpy(jr), torch_to_numpy(tr),
                           "rejoin init")
        rounds = 0
        while not bool(tr.done[0]):
            j, t = self.j, self.t
            j["log"], jr, j["fols"] = tw.jrun(
                "rejoin", prog, j["log"], jr, j["lead"], j["fols"],
                np.full((P,), node, np.int32))
            t["log"], tr, t["fols"] = tw.tlog.rejoin_step(
                t["log"], tr, t["lead"], tw.tfols, t["fols"],
                torch.full((P,), node))
            self.check(f"rejoin chunk {rounds}")
            assert_trees_equal(jax_to_numpy(jr), torch_to_numpy(tr),
                               f"rejoin state {rounds}")
            rounds += 1
            if between is not None:
                between(rounds)
            assert rounds < 96, "rejoin must terminate"
        return rounds, int(tr.restarts[0])

    def converged(self, lanes=None):
        """diverging_leaves(leader, follower) == [] for every follower, in
        both packages."""
        for jf, tf in zip(self.j["fols"], self.t["fols"]):
            jd = self.tw.core.diverging_leaves(
                jax_to_numpy(self.j["lead"]), jax_to_numpy(jf), lanes=lanes)
            td = pt.diverging_leaves(self.t["lead"], tf,
                                     lanes=None if lanes is None
                                     else torch.from_numpy(np.asarray(lanes)))
            assert jd == td
            if td:
                return False
        return True

    def counter(self, name):
        return int(getattr(self.t["log"], name)[0])


_TWINS = {}


def twin(backend="onesided", **kw):
    key = (backend,) + tuple(sorted(kw.items()))
    if key not in _TWINS:
        _TWINS[key] = Twin(backend, **kw)
    return _TWINS[key]


def world(backend="onesided", **kw):
    tw = twin(backend, **kw)
    tw.jm.traffic.reset()
    tw.tm.traffic.reset()
    return World(tw)


# ---------------------------------------------------------------------------
# records and the snapshot stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["local", "hashed", "explicit"])
def test_export_and_replay_window_records(placement):
    """``export_window_records`` masks non-mutations to NOP and resolves
    each lane's home under the placement policy; ``replay_window_records``
    with pred=False is the identity and with pred=True commits exactly the
    leader's window — both bitwise the reference's."""
    core = reference_core()
    jm, tm = core.make_manager(P), pt.make_manager(P, device="cpu")
    kw = dict(KW, placement=placement)
    js, ts = core.KVStore(None, "kv", jm, **kw), \
        pt.KVStore(None, "kv", tm, **kw)
    rng = np.random.default_rng(3)
    tgt = rng.integers(0, P, (P, B)).astype(np.int32)
    targets = tgt if placement == "explicit" else None
    run = jm.runtime.run
    jexp = jax.jit(lambda o, k, v, t: run(
        lambda o, k, v, t: js.export_window_records(
            o, k, v, targets=t if placement == "explicit" else None),
        o, k, v, t))
    jrep = jax.jit(lambda s, r, p: run(js.replay_window_records, s, r, p))
    jst, tst = js.init_state(), ts.init_state()
    for w in range(4):
        op, key, val = mixed(rng)
        jr = jexp(op, key, val, tgt)
        tr = ts.export_window_records(op, key, val, targets=targets)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        live = tr[..., 0].numpy()
        assert set(np.unique(live)) <= {NOP, INSERT, UPDATE, DELETE}
        assert (live[(op == GET) | (op == NOP)] == NOP).all()
        if placement == "local":
            assert (tr[..., -1].numpy() == np.arange(P)[:, None]).all()
        for pred in (np.zeros(P, bool), np.ones(P, bool)):
            jst2, jres = jrep(jst, jr, pred)
            tst2, tres = ts.replay_window_records(tst, tr,
                                                  pred=torch.from_numpy(pred))
            assert_trees_equal(jax_to_numpy(jst2), pt.state_to_numpy(tst2),
                               f"replay {w} pred={pred[0]}")
            np.testing.assert_array_equal(np.asarray(jres.found),
                                          tres.found.numpy())
            if not pred[0]:
                assert pt.diverging_leaves(tst, tst2) == []
        jst, tst = jst2, tst2


def test_channel_names_and_regions_match():
    """The replication tier registers the reference's channel tree and
    memory regions, byte for byte."""
    tw = twin()
    assert sorted(tw.tm.channels) == sorted(tw.jm.channels)
    assert {k: r.nbytes for k, r in tw.tm.regions.items()} \
        == {k: r.nbytes for k, r in tw.jm.regions.items()}
    assert tw.tm.memory_ledger_bytes() == tw.jm.memory_ledger_bytes()


def test_snapshot_words_and_chunks_match():
    tw = twin()
    assert tw.tlog.snapshot_words() == tw.jlog.snapshot_words()
    assert tw.tlog._snap_chunks() == tw.jlog._snap_chunks()
    assert tw.tlog.entry_nbytes() == tw.jlog.entry_nbytes()
    assert tw.tlog.entry_width == tw.jlog.entry_width == P * B * 5


# ---------------------------------------------------------------------------
# tests/test_replog.py::TestReplicatedLog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_follower_converges_on_mixed_windows(backend):
    w = world(backend)
    rng = np.random.default_rng(11)
    for i in range(5):
        w.hb_step(mixed(rng), ALL, what=f"mixed {i}")
        assert w.lag() == 0
    assert w.converged()
    assert w.counter("published") == 5 and w.counter("dropped") == 0
    w.check_ledgers()


def test_flow_control_counts_drops_and_backlog_drains_in_order():
    w = world()
    for i in range(CAP):
        assert w.append_ns(mkw(i, dead=()))
    assert not w.append_ns(mkw(CAP, dead=())), "a full ring drops"
    assert w.counter("dropped") == 1
    assert w.lag() == CAP
    n = w.drain()
    assert n == CAP and w.lag() == 0
    w.sync()
    w.check_ledgers()


def test_partial_sync_lag_counts_down_with_two_entries_per_sync():
    w = world()
    for i in range(3):
        assert w.append_ns(mkw(i, dead=()))
    applied, lag = w.sync(max_entries=2)
    assert applied == 2 and lag == 1
    applied, lag = w.sync(max_entries=2)
    assert applied == 1 and lag == 0


def test_multiple_followers_one_drain():
    w = world(n_followers=2)
    rng = np.random.default_rng(12)
    for i in range(3):
        w.hb_step(mixed(rng), ALL, what=f"two followers {i}")
    assert w.converged()


# ---------------------------------------------------------------------------
# tests/test_failover.py
# ---------------------------------------------------------------------------

def test_promotion_equal_cursors_tie_break_to_lowest_live_rank():
    w = world()
    w.drive(2, ALL, dead=())
    assert w.promote([False, True, True, True]) == 1
    assert int(w.tw.tlog.epoch(w.t["log"])[0]) == 1
    assert w.counter("failovers") == 1


def test_promotion_highest_applied_cursor_wins():
    w = world()
    w.drive(2, ALL, dead=())
    assert w.append_ns(mkw(2, dead=(0, 1, 2)))
    # only participant 3 drains the acked-but-unsynced entry
    w.sync(mask=[False, False, False, True])
    assert w.promote([False, True, True, True]) == 3
    w.drain([False, True, True, True])
    assert w.converged(lanes=[False, True, True, True])


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_zombie_publish_is_fenced_and_counted(backend):
    w = world(backend)
    w.drive(2, ALL, dead=())
    alive = np.asarray([False, True, True, True])
    assert w.promote(alive) == 1
    w.drain(alive)
    zop = np.full((P, B), NOP, np.int32)
    zkey = np.ones((P, B), np.uint32)
    zval = np.full((P, B, 2), -777, np.int32)
    zop[1, 0], zkey[1, 0] = UPDATE, 1
    assert w.zombie((zop, zkey, zval), zombie=0, stale_epoch=0)
    applied, _lag = w.sync(alive)
    assert applied == 0, "a fenced entry must not apply"
    assert w.counter("fenced") >= 1
    assert w.converged(lanes=alive)
    assert sum(w.tw.tm.traffic.fenced_summary().values()) >= 1
    w.check_ledgers()


def test_append_with_retry_drop_then_recover():
    w = world()
    wedged = np.asarray([True, True, True, False])
    for i in range(CAP):
        _v, ok, _n = w.hb_step(mkw(i, dead=(3,)), wedged, heartbeat=False)
        assert ok
    _v, ok, _n = w.hb_step(mkw(CAP, dead=(3,)), wedged, heartbeat=False)
    assert not ok and w.counter("dropped") == 2
    _v, ok, _n = w.hb_step(mkw(CAP, dead=(3,)), ALL, heartbeat=False)
    assert ok and w.counter("retries") == 2


def test_mid_window_kill_loses_no_acked_window():
    """Steady windows, one acked-but-unsynced window, the leader dies, the
    detector's verdict promotes, the suffix re-publishes and the followers
    converge; then the in-flight window retries through the new leader."""
    w = world(n_followers=2)
    w.drive(3, ALL)
    assert w.append_ns(mkw(3))
    plan = FaultPlan(kills={0: 4})
    alive = plan.alive_mask(P, 4)
    verdict = None
    for _ in range(THRESH):
        verdict, _ok, _n = w.hb_step(WNOP, alive)
    assert not verdict[0] and verdict[1:].all()
    assert w.promote(verdict) == 1
    w.drain(alive)
    assert w.converged(lanes=alive)
    _v, ok, _n = w.hb_step(mkw(4), alive)
    assert ok and w.counter("dropped") == 0
    assert w.counter("failovers") == 1


def test_fault_plan_validation_and_schedule():
    plan = FaultPlan(kills={0: 3}, revives={0: 6})
    assert plan.dead_at(2) == set() and plan.dead_at(3) == {0}
    assert plan.dead_at(6) == set()
    assert plan.newly_dead(3) == [0] and plan.newly_alive(6) == [0]
    assert plan.alive_mask(P, 4).tolist() == [False, True, True, True]
    assert plan.device_failures() == {3: True}
    with pytest.raises(ValueError, match="never-killed"):
        FaultPlan(revives={1: 2})
    with pytest.raises(ValueError, match="after the kill"):
        FaultPlan(kills={0: 3}, revives={0: 3})
    ref = pytest.importorskip("repro.distributed.fault")
    rplan = ref.FaultPlan(kills={0: 3}, revives={0: 6})
    for wdw in range(8):
        assert plan.dead_at(wdw) == rplan.dead_at(wdw)
        np.testing.assert_array_equal(plan.alive_mask(P, wdw),
                                      rplan.alive_mask(P, wdw))


# ---------------------------------------------------------------------------
# tests/test_selfhealing.py
# ---------------------------------------------------------------------------

def _observe(w, hb):
    tw = w.tw
    table = np.broadcast_to(np.asarray(hb, np.uint32), (P, P))
    w.j["det"], ja = tw.jrun("observe", lambda d, h: tw.jdet.observe(d, h),
                             w.j["det"], table)
    w.t["det"], ta = tw.tdet.observe(w.t["det"], _pt(table))
    w.check("observe", (ja,), (ta,))
    return ta[0].numpy()


def test_detector_threshold_edge_and_latency():
    w = world()
    hb = np.zeros(P, np.uint32)
    hb += 1
    assert _observe(w, hb).all()
    hb[[0, 1, 3]] += 1
    assert _observe(w, hb).all(), "one miss is below threshold"
    hb[[0, 1, 3]] += 1
    a = _observe(w, hb)
    assert not a[2] and a[[0, 1, 3]].all()
    assert int(w.tw.tdet.detection_latency(w.t["det"], 2)[0]) == 3


def test_detector_false_positive_window_and_sticky_readmit():
    w = world()
    hb = np.zeros(P, np.uint32)
    for _ in range(2):
        hb += 1
        _observe(w, hb)
    hb[[0, 2, 3]] += 1
    assert _observe(w, hb).all()
    hb += 1
    assert _observe(w, hb).all(), "resuming under the threshold"
    for _ in range(THRESH):
        hb[[1, 2, 3]] += 1
        a = _observe(w, hb)
    assert not a[0]
    hb += 1
    assert not _observe(w, hb)[0], "dead is sticky"
    w.readmit_detector(0)
    assert w.t["det"].alive[0].all()
    with pytest.raises(ValueError, match="threshold"):
        pt.FailureDetector(None, "bad", w.tw.tm, threshold=0)


def test_stalled_heartbeats_reach_verdict_and_evict():
    w = world()
    plan = FaultPlan(kills={0: 2})
    alive = ALL.copy()
    verdicts = []
    for wdw in range(2 + THRESH):
        for p in plan.newly_dead(wdw):
            alive[p] = False
        v, _ok, _n = w.hb_step(mkw(wdw) if alive[0] else WNOP, alive)
        verdicts.append(v)
    assert verdicts[1 + THRESH - 1].all()
    assert not verdicts[1 + THRESH][0]
    assert not bool(w.t["log"].ring.alive[0, 0])
    assert w.promote(verdicts[-1]) != 0
    w.drive(3, verdicts[-1], start=10)
    w.drain(verdicts[-1])
    assert w.converged(lanes=verdicts[-1])
    w.check_ledgers()


def _seed(w):
    w.drive(3, ALL, dead=())


def _suffix(w, dead):
    for i in (3, 4):
        assert w.append_ns(mkw(i, dead=dead))


def _finish(w, alive, start):
    alive = np.asarray(alive, bool)
    dead = tuple(int(p) for p in np.where(~alive)[0])
    w.drive(3, alive, dead=dead, start=start)
    w.drain(alive)
    assert w.converged(lanes=alive)
    assert w.counter("dropped") == 0


def test_cascade_winner_dies_after_fence():
    w = world()
    _seed(w)
    a1 = np.asarray([False, True, True, True])
    w.gather(a1)
    w.fence(a1)
    a2 = np.asarray([False, False, True, True])
    assert w.promote(a2) == 2
    assert int(w.tw.tlog.epoch(w.t["log"])[0]) == 2
    _finish(w, a2, start=20)


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_cascade_winner_dies_mid_republish(backend):
    w = world(backend)
    _seed(w)
    _suffix(w, dead=(0, 1))
    a1 = np.asarray([False, True, True, True])
    w.gather(a1)
    w.fence(a1)
    w.republish(a1, limit=1)
    a2 = np.asarray([False, False, True, True])
    assert w.promote(a2) == 2
    _finish(w, a2, start=20)
    w.check_ledgers()


def test_cascade_simultaneous_leader_and_follower_kill():
    w = world()
    _seed(w)
    alive = np.asarray([False, True, False, True])
    for _ in range(THRESH):
        v, _ok, _n = w.hb_step(WNOP, alive)
    assert not v[0] and not v[2] and v[1] and v[3]
    assert w.promote(v) == 1
    _finish(w, alive, start=30)


def _kill_and_outrun(w, n_post=CAP + 2):
    w.drive(3, ALL, dead=())
    alive = np.asarray([False, True, True, True])
    for _ in range(THRESH):
        v, _ok, _n = w.hb_step(WNOP, alive)
    w.promote(v)
    w.drive(n_post, alive, start=20)
    return alive


def test_rejoin_needs_snapshot_decision_and_replay_path():
    w = world()
    w.drive(2, ALL, dead=())
    assert not w.needs_snapshot(0)
    w2 = world()
    _kill_and_outrun(w2)
    assert w2.needs_snapshot(0)


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_snapshot_rejoin_converges_bitwise(backend):
    w = world(backend)
    _kill_and_outrun(w)
    rounds, restarts = w.rejoin(0)
    assert restarts == 0 and rounds == w.tw.tlog._snap_chunks()[1]
    assert w.converged()
    assert bool(w.t["log"].ring.alive[0, 0])
    w.readmit_detector(0)
    v = w.drive(3, ALL, dead=(), start=30)
    assert v.all()
    w.drain()
    assert w.converged()
    w.check_ledgers()


def test_replay_rejoin_readmits_within_the_ring():
    """A gap that fits the ring: readmit, then ring-tail replay catches the
    revived node up (the engine's cheap rejoin path)."""
    w = world()
    w.drive(3, ALL, dead=())
    alive = np.asarray([False, True, True, True])
    for _ in range(THRESH):
        v, _ok, _n = w.hb_step(WNOP, alive)
    w.promote(v)
    w.drive(1, alive, start=20)
    assert not w.needs_snapshot(0)
    w.readmit(0)
    w.readmit_detector(0)
    w.drive(3, ALL, start=30)
    w.drain()
    assert w.converged()


def test_rejoin_racing_mutation_restarts_then_converges():
    w = world()
    alive = _kill_and_outrun(w)

    def racing(rounds):
        if rounds == 2:
            w.hb_step(mkw(40), alive, what="racing window")

    _rounds, restarts = w.rejoin(0, between=racing)
    assert restarts >= 1
    assert w.converged()


def test_rejoin_leader_death_mid_transfer_resumes():
    w = world()
    _kill_and_outrun(w)

    def kill_leader(rounds):
        if rounds == 2:
            assert w.promote([False, False, True, True]) == 2

    _rounds, restarts = w.rejoin(0, between=kill_leader)
    assert restarts >= 1
    assert w.converged()


def test_backoff_histogram_fast_path():
    w = world()
    w.drive(3, ALL, dead=())
    hist = w.t["log"].retries_by_attempt[0].numpy()
    assert hist[0] == 3 and hist[1:].sum() == 0


@pytest.mark.parametrize("max_attempts", [1, 3])
def test_drop_then_recover_at_each_backoff_stage(max_attempts):
    w = world()
    wedged = np.asarray([True, True, True, False])
    for i in range(CAP):
        _v, ok, _n = w.hb_step(mkw(i, dead=(3,)), wedged,
                               max_attempts=max_attempts, heartbeat=False)
        assert ok
    _v, ok, _n = w.hb_step(mkw(CAP, dead=(3,)), wedged,
                           max_attempts=max_attempts, heartbeat=False)
    assert not ok
    assert w.counter("dropped") == max_attempts
    assert w.counter("retries") == max_attempts - 1
    _v, ok, _n = w.hb_step(mkw(CAP, dead=(3,)), ALL,
                           max_attempts=max_attempts, heartbeat=False)
    hist = w.t["log"].retries_by_attempt[0].numpy()
    if max_attempts == 1:
        assert not ok and hist[1:].sum() == 0
    else:
        assert ok and hist[1] == 1
