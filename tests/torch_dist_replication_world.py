"""The gloo worlds of ``tests/test_torch_dist_replication.py``, run as one
child process:

    python tests/torch_dist_replication_world.py <inputs.pt> <outputs.pt> \
        [P,P,...] [backend]

``inputs.pt`` holds scenarios of the replication tier: a ring scenario (a
:class:`~repro_torch.core.Ringbuffer` and the steps to run on it) and a log
scenario (a leader store, two follower stores, a
:class:`~repro_torch.core.ReplicatedLog` and a
:class:`~repro_torch.core.FailureDetector`, and the protocol's steps), each
at P participants on one backend, every step's arguments (P, ...) numpy
arrays.  For every P the scenarios need (or each P given, with the
scenarios of the backend given), one world of P ranks is spawned on the
CPU over gloo
(:func:`repro_torch.launch.world.spawn_world`); each rank
binds ``make_manager(P, mesh=ProcessMesh(P))``, takes its block of each
step's arguments, runs the steps on its own block and keeps, after every
step, its state blocks and the step's outputs and, at the end, its traffic
ledger and the ring's publish count.  :func:`run_ring` and :func:`run_log`
are the drivers the test runs on the stacked binding too, and
:func:`ring_steps` and :func:`log_steps` make the scenarios from a seed
with numpy alone.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

NOP, GET, INSERT, UPDATE, DELETE = 0, 1, 2, 3, 4
#: the log scenario's store, window, ring and detector (tests/test_replog.py)
KW = dict(slots_per_node=6, value_width=2, num_locks=8, index_capacity=64)
B, CAP, THRESH, CHUNK = 2, 4, 2, 64
#: the ring scenario's ring
RING_CAP, RING_WIDTH = 4, 3


# ------------------------------------------------------------------ scenarios
def _mask(P, dead=()):
    a = np.ones(P, bool)
    a[list(dead)] = False
    return a


def _everywhere(mask):
    """One (P,) mask as every participant's view, (P, P)."""
    return np.ascontiguousarray(np.broadcast_to(mask, (mask.size,) * 2))


def mkw(i, P, dead=(0,)):
    """Deterministic mutation window ``i``: two mutations on the lanes of
    the participants not in ``dead``, every other lane a NOP (a dead
    participant's slice would have no live submitter at replay)."""
    k = 1 + (i % 5)
    triples = [(INSERT if i < 5 else UPDATE, k, (10 * k + i, i)),
               (UPDATE if i >= 5 else INSERT, k + 5, (20 * k, i))]
    live = [p for p in range(P) if p not in dead]
    ops = np.full((P, B), NOP, np.int32)
    keys = np.ones((P, B), np.uint32)
    vals = np.zeros((P, B, 2), np.int32)
    for j, (o, key, v) in enumerate(triples):
        p, b = live[j % len(live)], j // len(live)
        ops[p, b], keys[p, b], vals[p, b] = o, key, v
    return ops, keys, vals


def mixed(rng, P, keys=24):
    """A random (P, B) window of GET/INSERT/UPDATE/DELETE/NOP lanes over
    distinct keys."""
    ks = rng.choice(np.arange(1, keys + 1), size=P * B, replace=False)
    ops = rng.choice([GET, INSERT, INSERT, UPDATE, DELETE, NOP], size=P * B)
    vals = rng.integers(-2 ** 31, 2 ** 31, (P * B, 2))
    return (ops.astype(np.int32).reshape(P, B),
            ks.astype(np.uint32).reshape(P, B),
            vals.astype(np.int32).reshape(P, B, 2))


def log_steps(P, seed):
    """The log scenario at P participants, after tests/test_replog.py,
    test_failover.py and test_selfhealing.py: steady windows, two acked and
    unsynced windows, participant 0's death by mask, the promotion in its
    three steps with the winner dying mid-re-publish and the restart at
    epoch + 2, the in-flight window retried through the new leader while
    ``heartbeat_and_detect`` reaches its verdict on the dead, the drain, a
    zombie publish fenced, a snapshot rejoin and the detector's readmit, a
    short death readmitted by ring-tail replay, and a wedged follower's drop
    and retry.  A step's ``tag`` names it for the test's checks."""
    rng = np.random.default_rng(seed)
    steps = []

    def window(w, alive, max_attempts=1, heartbeat=True, tag=None):
        op, key, val = w
        steps.append(("window", dict(op=op, key=key, val=val,
                                     alive=_everywhere(alive),
                                     max_attempts=max_attempts,
                                     heartbeat=heartbeat, tag=tag)))

    def step(name, tag=None, **args):
        steps.append((name, dict(args, tag=tag)))

    def node(p):
        return np.full(P, p, np.int32)

    everyone = _mask(P)
    window(mixed(rng, P), everyone)
    window(mkw(2, P, dead=()), everyone)
    # the last two windows before the leader's death: acked, not synced
    dead = (0, 1) if P >= 4 else (0,)
    for i in (3, 4):
        op, key, val = mkw(i, P, dead)
        step("append", op=op, key=key, val=val, alive=_everywhere(everyone))
    # participant 0 dies; the winner of the first promotion dies after
    # re-publishing one entry, and the promotion restarts at epoch + 2 (at
    # P = 2, with the same winner: nobody else is left)
    alive = _mask(P, (0,))
    step("gather", alive=_everywhere(alive))
    step("fence", alive=_everywhere(alive))
    step("republish", alive=_everywhere(alive), limit=1)
    alive = _mask(P, dead)
    step("promote", alive=_everywhere(alive), tag="promote")
    # the in-flight window retried through the new leader; the detector
    # reaches its verdict on the dead
    for i in range(THRESH):
        window(mkw(5 + i, P, dead), alive,
               tag="verdict" if i == THRESH - 1 else None)
    for _ in range(2):
        step("sync", mask=alive)
    zop, zkey = np.full((P, B), NOP, np.int32), np.ones((P, B), np.uint32)
    zop[P - 1, 0] = UPDATE
    step("zombie", op=zop, key=zkey, val=np.full((P, B, 2), -777, np.int32),
         zombie=0, stale_epoch=0, tag="zombie")
    step("sync", mask=alive, tag="fenced")
    step("needs_snapshot", node=node(0), tag="gap")
    step("rejoin_init")
    for i in range(n_chunks(P)):
        step("rejoin_step", node=node(0))
    step("det_readmit", node=node(0), tag="rejoined")
    dead = tuple(p for p in dead if p != 0)
    alive = _mask(P, dead)
    window(mkw(20, P, dead), alive)
    step("sync", mask=alive)
    step("lag", tag="converged")
    # a follower misses one window and rejoins from the ring's tail
    r = P - 1 if P >= 4 else 0
    short = _mask(P, dead + (r,))
    window(mkw(30, P, dead + (r,)), short, heartbeat=False)
    step("needs_snapshot", node=node(r), tag="short gap")
    step("readmit", node=node(r))
    step("det_readmit", node=node(r))
    window(mkw(31, P, dead), alive)
    # the same follower wedges: the ring fills, an append drops, then is
    # retried once the follower drains again
    for i in range(CAP - 1):
        window(mkw(40 + i, P, dead + (r,)), short, heartbeat=False)
    window(mkw(40 + CAP, P, dead + (r,)), short, max_attempts=2,
           heartbeat=False, tag="drop")
    window(mkw(40 + CAP, P, dead + (r,)), alive, max_attempts=2,
           heartbeat=False, tag="retry")
    for _ in range(3):
        step("sync", mask=alive)
    step("lag", tag="end")
    return steps


def n_chunks(P):
    """The snapshot's chunk count of :data:`KW`'s store at P participants
    (the log's ``_snap_chunks``), made on the meta device."""
    from repro_torch.core import KVStore, ReplicatedLog, make_manager
    mgr = make_manager(P, device="cpu")
    store = KVStore(None, "kv", mgr, **KW)
    log = ReplicatedLog(None, "log", mgr, store=store, window=B,
                        capacity=CAP, rejoin_chunk=CHUNK)
    return log._snap_chunks()[1]


def ring_steps(P, seed):
    """The ring scenario at P participants, after tests/test_channels.py's
    ring tests: a send, windows that fill the ring until one lane is
    refused, a scalar and a windowed receive, a corrupted slot rejected at
    one consumer, a stale epoch fenced, and a takeover by another owner
    with a crashed consumer."""
    rng = np.random.default_rng(seed)

    def msgs(*shape):
        return rng.integers(-2 ** 31, 2 ** 31, shape + (RING_WIDTH,)) \
            .astype(np.int32)

    def lens(*shape):
        return rng.integers(0, RING_WIDTH + 1, shape).astype(np.int32)

    owner = min(1, P - 1)
    steps = [
        ("send", dict(msg=msgs(P), len=lens(P), pred=np.ones(P, bool))),
        ("publish", dict(msgs=msgs(P, 2), lens=lens(P, 2),
                         preds=np.ones((P, 2), bool), epoch=None)),
        # the ring holds 3 of 4: one lane lands, the next is refused
        ("publish", dict(msgs=msgs(P, 3), lens=lens(P, 3),
                         preds=np.asarray([[True, True, False]] * P),
                         epoch=None)),
        ("recv_one", dict(pred=np.ones(P, bool))),
        ("recv", dict(window=2, pred=None, expect_epoch=None)),
        ("corrupt", dict(p=P - 1)),
        ("recv", dict(window=2, pred=None, expect_epoch=None)),
        ("recv", dict(window=4, pred=None, expect_epoch=None)),
        ("publish", dict(msgs=msgs(P, 2), lens=lens(P, 2), preds=None,
                         epoch=np.full((P, 2), 1, np.uint32))),
        ("recv", dict(window=4, pred=None,
                      expect_epoch=np.full(P, 2, np.uint32))),
        ("re_own", dict(owner=np.full(P, 0, np.int32),
                        alive=_everywhere(_mask(P, (P - 1,))),
                        head=np.full(P, 6, np.uint32))),
        ("publish", dict(msgs=msgs(P, 4), lens=lens(P, 4), preds=None,
                         epoch=np.full(P, 2, np.uint32))),
        ("recv", dict(window=4, pred=_mask(P, (P - 1,)),
                      expect_epoch=np.full(P, 2, np.uint32))),
        ("send", dict(msg=msgs(P), len=lens(P), pred=rng.random(P) < 0.5)),
        ("recv_one", dict(pred=_mask(P, (P - 1,)))),
    ]
    return [(owner, RING_CAP)] + steps


# -------------------------------------------------------------------- drivers
def block_cut(P, rank=None):
    """Numpy arguments as tensors, each (P, ...) one cut to participant
    ``rank``'s block (all of it when ``rank`` is None, the stacked
    binding); other values as they are."""
    def cut(a):
        if not isinstance(a, np.ndarray):
            return a
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        if rank is not None and a.ndim and a.shape[0] == P:
            a = a[rank:rank + 1]
        return torch.from_numpy(a.copy())
    return cut


def build_log(mgr):
    from repro_torch.core import FailureDetector, KVStore, ReplicatedLog
    lead = KVStore(None, "leader", mgr, **KW)
    fols = [KVStore(None, f"follower{i}", mgr, **KW) for i in range(2)]
    log = ReplicatedLog(None, "log", mgr, store=lead, window=B,
                        capacity=CAP, rejoin_chunk=CHUNK)
    det = FailureDetector(None, "det", mgr, threshold=THRESH)
    return lead, fols, log, det


def _log_step(objs, st, name, a):
    """One step of the log scenario on ``st`` (a dict of states, updated in
    place); returns the step's outputs."""
    lead, fols, log, det = objs
    rt = log.rt
    loc, me = rt.local_ids(), rt.my_id()
    if name in ("window", "append"):
        st["lead"], _res = lead.op_window(st["lead"], a["op"], a["key"],
                                          a["val"])
        A = a["alive"].to(torch.bool)
        owner = st["log"].ring.owner.long()
        if name == "append":
            st["log"], ok = log.append(st["log"], a["op"], a["key"],
                                       a["val"], pred=A[loc, owner])
            return (ok,)
        verdict = A
        if a["heartbeat"]:
            st["log"], st["det"], verdict = log.heartbeat_and_detect(
                st["log"], st["det"], det, pred=A[loc, me])
        st["log"], st["fols"], ok, applied = log.append_with_retry(
            st["log"], a["op"], a["key"], a["val"], fols, st["fols"],
            max_attempts=a["max_attempts"], pred=A[loc, owner],
            sync_pred=A[loc, me])
        return verdict, ok, applied
    if name == "sync":
        st["log"], st["fols"], applied = log.sync(
            st["log"], fols, st["fols"], max_entries=a.get("max_entries", 1),
            pred=a["mask"])
        return applied, log.lag(st["log"])
    if name in ("gather", "fence"):
        fn = log.promote_gather if name == "gather" else log.promote_fence
        st["log"] = fn(st["log"], a["alive"])
        return ()
    if name == "republish":
        st["log"], winner = log.promote_republish(st["log"], a["alive"],
                                                  limit=a["limit"])
        return (winner,)
    if name == "promote":
        st["log"], winner = log.promote(st["log"], a["alive"])
        return (winner,)
    if name == "zombie":
        st["log"], landed = log.zombie_publish(
            st["log"], a["op"], a["key"], a["val"], zombie=a["zombie"],
            stale_epoch=a["stale_epoch"])
        return (landed,)
    if name == "needs_snapshot":
        return (log.needs_snapshot(st["log"], a["node"]),)
    if name == "rejoin_init":
        st["rejoin"] = log.rejoin_init()
        return ()
    if name == "rejoin_step":
        st["log"], st["rejoin"], st["fols"] = log.rejoin_step(
            st["log"], st["rejoin"], st["lead"], fols, st["fols"],
            a["node"])
        return ()
    if name == "readmit":
        st["log"] = log.readmit(st["log"], a["node"])
        return ()
    if name == "det_readmit":
        st["det"] = det.readmit(st["det"], a["node"])
        return ()
    if name == "lag":
        return (log.lag(st["log"]), log.epoch(st["log"]),
                st["log"].ring.owner)
    raise ValueError(f"unknown log step {name!r}")


def _snapshot(st):
    return (st["lead"], *st["fols"], st["log"], st["det"], st["rejoin"])


def run_log(mgr, steps, cut):
    """The log scenario's ``steps`` under ``mgr``.  Returns [(states,
    outputs)] after every step (states: the leader, the two followers, the
    log, the detector, the rejoin) and the ring's publish count."""
    objs = build_log(mgr)
    lead, fols, log, det = objs
    st = dict(lead=lead.init_state(),
              fols=tuple(f.init_state() for f in fols),
              log=log.init_state(), det=det.init_state(),
              rejoin=log.rejoin_init())
    out = []
    for name, args in steps:
        outs = _log_step(objs, st, name,
                         {k: cut(v) for k, v in args.items() if k != "tag"})
        out.append((_snapshot(st), outs))
    log.close()
    return out, log.ring.publishes


def _corrupt(ring, state, p):
    """Flip the low bit of the first payload word of participant ``p``'s
    cached copy of its next unread slot, on the rank that holds ``p``."""
    rt = ring.rt
    loc = p - rt.rank
    if not 0 <= loc < rt.n_local:
        return state
    cursor = int(ring.acks.rows(state.acks)[loc, p])
    payload = state.payload.clone()
    payload[loc, cursor % ring.capacity, 0] ^= 1
    return state._replace(payload=payload)


def run_ring(mgr, steps, cut):
    """The ring scenario's ``steps`` (the first entry the ring's (owner,
    capacity)) under ``mgr``.  Returns [(state, outputs)] after every step
    and the ring's publish count."""
    from repro_torch.core import Ringbuffer
    (owner, capacity), steps = steps[0], steps[1:]
    ring = Ringbuffer(None, "rb", mgr, owner=owner, capacity=capacity,
                      width=RING_WIDTH)
    state = ring.init_state()
    out = []
    for name, args in steps:
        a = {k: cut(v) for k, v in args.items()}
        if name == "send":
            state, sent, _ack = ring.send(state, a["msg"], a["len"],
                                          pred=a["pred"])
            outs = (sent,)
        elif name == "publish":
            state, sent, _ack = ring.publish_window(
                state, a["msgs"], a["lens"], a["preds"], a["epoch"])
            outs = (sent,)
        elif name == "recv_one":
            state, *outs = ring.recv_one(state, a["pred"])
        elif name == "recv":
            state, *outs = ring.recv_window(
                state, a["window"],
                True if a["pred"] is None else a["pred"],
                expect_epoch=a["expect_epoch"])
        elif name == "corrupt":
            state, outs = _corrupt(ring, state, a["p"]), ()
        elif name == "re_own":
            state, outs = ring.re_own(state, a["owner"], a["alive"],
                                      a["head"]), ()
        else:
            raise ValueError(f"unknown ring step {name!r}")
        out.append((state, tuple(outs)))
    ring.close()
    return out, ring.publishes


def ledger_rows(traffic):
    return {"bytes": traffic.summary(), "rounds": traffic.rounds_summary(),
            "dma": traffic.dma_summary(), "cache": traffic.cache_summary(),
            "corrupt": traffic.corrupt_summary(),
            "fenced": traffic.fenced_summary()}


def run_scenario(sc, mgr, cut):
    """One scenario ({"kind": "ring" or "log", "steps": ...}) under
    ``mgr``, its ledger enabled: (steps, publishes, ledger rows)."""
    mgr.traffic.enable()
    run = run_ring if sc["kind"] == "ring" else run_log
    steps, publishes = run(mgr, sc["steps"], cut)
    return steps, publishes, ledger_rows(mgr.traffic)


def replication_rank(rank, P, scenarios, copy_cases):
    """One rank of a world of P: every scenario on the 1-D ``("nodes",)``
    mesh of P, one participant a rank; then ``remote_copy_peers`` (its plain
    version, on CPU tensors) on each (words (P, n), sender (P,)) case of
    ``copy_cases``, the rank's rows."""
    from repro_torch.core import make_manager
    from repro_torch.kernels.remote_dma import PeerWindows, remote_copy_peers
    from repro_torch.launch.mesh import ProcessMesh
    torch.set_num_threads(1)
    mesh = ProcessMesh(P)
    out = {"rank": rank, "scenarios": {}}
    for name, sc in scenarios.items():
        mgr = make_manager(P, mesh=mesh, backend=sc["backend"])
        steps, publishes, ledger = run_scenario(sc, mgr, block_cut(P, rank))
        out["scenarios"][name] = {"steps": steps, "publishes": publishes,
                                  "ledger": ledger}
    windows = PeerWindows(make_manager(P, mesh=mesh).runtime)
    cut = block_cut(P, rank)
    out["copy"] = [remote_copy_peers(cut(w), cut(s), windows)
                   for w, s in copy_cases]
    return out


def main(inp, outp, worlds=None, backend=None):
    """The worlds of ``inp``'s scenarios, or only those of the P in
    ``worlds`` (and of ``backend``'s scenarios), one after the other."""
    from repro_torch.launch.world import spawn_world
    job = torch.load(inp, weights_only=False)
    out = {}
    for P in sorted(job["worlds"] if worlds is None else worlds):
        scenarios = {k: v for k, v in job["scenarios"].items()
                     if v["P"] == P and backend in (None, v["backend"])}
        out[P] = spawn_world(replication_rank, P, backend="gloo",
                             device="cpu",
                             args=(P, scenarios, job["copy_cases"][P]),
                             timeout_s=job.get("timeout_s", 240))
    torch.save(out, outp)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2],
         *([int(p) for p in sys.argv[3].split(",")] if i == 3 else sys.argv[i]
           for i in range(3, len(sys.argv))))
