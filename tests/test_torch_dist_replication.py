"""The replication tier across processes, on the CPU: the ring, the
replicated log and the failure detector on the process binding
(``make_manager(P, mesh=ProcessMesh(P))``, one participant a rank) against
the stacked binding and against the reference's ``shard_map`` binding.

One module fixture runs two children at once:

* ``tests/torch_dist_replication_world.py`` spawns gloo worlds of 2, 4 and
  8 ranks on the CPU.  Each rank runs, on the one-sided, active-message and
  remote-DMA backends, the ring scenario (a send, windows filling the ring
  until a lane is refused, ``recv_one``, ``recv_window``, a corrupted slot
  rejected, a stale epoch fenced, ``re_own``) and the log scenario (append
  and sync, a death by mask, ``heartbeat_and_detect`` to its verdict, the
  promotion in its three steps with the winner dying mid-re-publish and the
  restart at epoch + 2, the drain, a zombie fenced, a snapshot
  ``rejoin_step`` and the detector's readmit, ``readmit`` by ring-tail
  replay, a wedged follower's drop and retry, ``lag``) on its own block, and
  holds ``remote_copy_peers``' plain version on random sender maps;
* one JAX subprocess (8 host devices, the reference imported through the
  shim of ``tests/torch_port_ref.py``) runs the log scenario at P = 8 on the
  reference's ``ReplicatedLog`` / ``FailureDetector`` under ``shard_map``
  and writes every step's states and outputs out as numpy.

The same scenarios run here on the stacked binding (the world script's
drivers).  Held: every rank's state blocks bitwise the stacked states' rows
after every step, leaf by leaf; every output its rows of the stacked
output; the ring's publish count; the ledger's rounds, corrupt and fenced
tiers on rank 0 equal to the stacked ledger's (none on the other ranks),
its bytes and measured-DMA rows summed over the ranks equal to the stacked
ones; the world of 8's states and outputs bitwise the reference's
participants' rows on every backend; and the scenarios' semantics on the
stacked run (one verdict, the promoted winner, the fence, the drop, the
convergence of the followers)."""
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import diverging_leaves, make_manager
from repro_torch.core.runtime import state_block
from repro_torch.kernels import remote_dma as rdma
from torch_dist_replication_world import (block_cut, log_steps, ring_steps,
                                          run_scenario)

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["onesided", "active_message", "pallas"]
WORLDS = [2, 4, 8]
REF_P = 8

# The log scenario under the reference's shard_map binding: the programs of
# tests/test_torch_replog.py's twin, one a step kind, each jitted once.
REFERENCE_LOG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={P}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {tests!r})
    from torch_port_ref import reference_core, jax_to_numpy, leaves
    core = reference_core()
    import jax, jax.numpy as jnp, numpy as np
    from torch_dist_replication_world import (B, CAP, CHUNK, KW, THRESH,
                                              log_steps)

    P = {P}
    if hasattr(jax.sharding, "AxisType"):          # jax >= 0.5
        mesh = jax.make_mesh((P,), ("nodes",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    else:
        mesh = jax.make_mesh((P,), ("nodes",))
    mgr = core.make_manager(P, axis="nodes", mesh=mesh)
    lead = core.KVStore(None, "leader", mgr, **KW)
    fols = [core.KVStore(None, f"follower{{i}}", mgr, **KW) for i in range(2)]
    log = core.ReplicatedLog(None, "log", mgr, store=lead, window=B,
                             capacity=CAP, rejoin_chunk=CHUNK)
    det = core.FailureDetector(None, "det", mgr, threshold=THRESH)
    # states laid out as the steps return them, so each step compiles once
    blocks = jax.sharding.NamedSharding(mesh,
                                        jax.sharding.PartitionSpec("nodes"))
    st = jax.device_put(dict(lead=lead.init_state(),
                             fols=tuple(f.init_state() for f in fols),
                             log=log.init_state(), det=det.init_state(),
                             rejoin=log.rejoin_init()), blocks)
    run = mgr.runtime.run
    jits = {{}}

    def jrun(key, prog, *args):
        if key not in jits:
            jits[key] = jax.jit(lambda *a: run(prog, *a))
        return jits[key](*args)

    def window(a):
        hb, ma = a["heartbeat"], a["max_attempts"]

        def prog(lst, fst, gst, dst, op, key, val, alive):
            me = mgr.runtime.my_id()
            lst, _res = lead.op_window(lst, op, key, val)
            owner = gst.ring.owner
            verdict = alive
            if hb:
                gst, dst, verdict = log.heartbeat_and_detect(
                    gst, dst, det, pred=alive[me])
            gst, fst, ok, applied = log.append_with_retry(
                gst, op, key, val, fols, fst, max_attempts=ma,
                pred=alive[owner], sync_pred=alive[me])
            return lst, fst, gst, dst, verdict, ok, applied
        (st["lead"], st["fols"], st["log"], st["det"], *outs) = jrun(
            ("window", hb, ma), prog, st["lead"], st["fols"], st["log"],
            st["det"], a["op"], a["key"], a["val"], a["alive"])
        return outs

    def append(a):
        def prog(lst, gst, op, key, val, alive):
            lst, _res = lead.op_window(lst, op, key, val)
            gst, ok = log.append(gst, op, key, val,
                                 pred=alive[gst.ring.owner])
            return lst, gst, ok
        st["lead"], st["log"], ok = jrun("append", prog, st["lead"],
                                         st["log"], a["op"], a["key"],
                                         a["val"], a["alive"])
        return [ok]

    def sync(a):
        n = a.get("max_entries", 1)

        def prog(gst, fst, mask):
            gst, fst, applied = log.sync(gst, fols, fst, max_entries=n,
                                         pred=mask)
            return gst, fst, applied, log.lag(gst)
        st["log"], st["fols"], *outs = jrun(("sync", n), prog, st["log"],
                                            st["fols"], a["mask"])
        return outs

    def on_log(key, fn, *args):
        res = jrun(key, fn, st["log"], *args)
        if isinstance(res, type(st["log"])):
            st["log"] = res
            return []
        st["log"] = res[0]
        return list(res[1:])

    def step(name, a):
        if name == "window":
            return window(a)
        if name == "append":
            return append(a)
        if name == "sync":
            return sync(a)
        if name == "gather":
            return on_log(name, log.promote_gather, a["alive"])
        if name == "fence":
            return on_log(name, log.promote_fence, a["alive"])
        if name == "republish":
            lim = a["limit"]
            return on_log(("republish", lim), lambda g, al:
                          log.promote_republish(g, al, limit=lim),
                          a["alive"])
        if name == "promote":
            return on_log(name, log.promote, a["alive"])
        if name == "zombie":
            z, e = a["zombie"], a["stale_epoch"]
            return on_log(("zombie", z, e), lambda g, o, k, v:
                          log.zombie_publish(g, o, k, v, zombie=z,
                                             stale_epoch=e),
                          a["op"], a["key"], a["val"])
        if name == "needs_snapshot":
            return [jrun(name, lambda g, n: log.needs_snapshot(g, n),
                         st["log"], a["node"])]
        if name == "rejoin_init":
            st["rejoin"] = jax.device_put(log.rejoin_init(), blocks)
            return []
        if name == "rejoin_step":
            def prog(gst, rst, lst, fst, node):
                return log.rejoin_step(gst, rst, lst, fols, fst, node)
            st["log"], st["rejoin"], st["fols"] = jrun(
                name, prog, st["log"], st["rejoin"], st["lead"],
                st["fols"], a["node"])
            return []
        if name == "readmit":
            return on_log(name, lambda g, n: log.readmit(g, n), a["node"])
        if name == "det_readmit":
            st["det"] = jrun(name, lambda d, n: det.readmit(d, n),
                             st["det"], a["node"])
            return []
        if name == "lag":
            return list(jrun(name, lambda g: (log.lag(g), log.epoch(g),
                                              g.ring.owner), st["log"]))
        raise ValueError(name)

    out = {{}}
    for i, (name, args) in enumerate(log_steps(P, {seed})):
        outs = step(name, args)
        states = dict(lead=st["lead"], fol0=st["fols"][0],
                      fol1=st["fols"][1], log=st["log"], det=st["det"],
                      rejoin=st["rejoin"])
        for group, tree in states.items():
            for path, leaf in leaves(jax_to_numpy(tree)):
                out[f"{{i}}/{{group}}/{{path}}"] = np.asarray(leaf)
        for j, o in enumerate(outs):
            out[f"{{i}}/out/{{j}}"] = np.asarray(o)
    np.savez({out!r}, **out)
""")


def _scenarios():
    out = {}
    for P in WORLDS:
        for i, backend in enumerate(BACKENDS):
            out[f"ring{P}_{backend}"] = {"P": P, "backend": backend,
                                         "kind": "ring",
                                         "steps": ring_steps(P, 37 + i)}
            out[f"log{P}_{backend}"] = {"P": P, "backend": backend,
                                        "kind": "log",
                                        "steps": log_steps(P, 37)}
    return out


SCENARIOS = _scenarios()
LOGS = [k for k, v in SCENARIOS.items() if v["kind"] == "log"]


def _copy_cases(P, rng):
    """(words (P, n) int32, sender (P,)) for remote_copy_peers' plain
    version: random maps with -1, self and out-of-range entries."""
    cases = []
    for n in (0, 3, 8, 21):
        words = rng.integers(-2 ** 31, 2 ** 31, (P, n)).astype(np.int32)
        for dtype in (np.int32, np.int64):
            sender = rng.integers(-2, P + 2, P).astype(dtype)
            sender[rng.integers(P)] = -1
            sender[0] = 0                    # itself
            cases.append((words, sender))
    return cases


COPY_CASES = {P: _copy_cases(P, np.random.default_rng(370 + P))
              for P in WORLDS}
# The world children, run at once, one a world (gloo's collectives wait
# more than they compute, so the worlds overlap).
CHILDREN = [(str(P),) for P in WORLDS]


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def runs():
    """The children of :data:`CHILDREN` and the reference's log scenario
    under shard_map, run at once, while every scenario runs here on the
    stacked binding:
    (the worlds' results, the reference's arrays, the stacked runs' (steps,
    publishes, ledger) by scenario)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory(prefix="dist-replication-") as tmp:
        tmp = Path(tmp)
        torch.save({"scenarios": SCENARIOS, "worlds": WORLDS,
                    "copy_cases": COPY_CASES, "timeout_s": 300},
                   tmp / "in.pt")
        children = {i: subprocess.Popen(
            [sys.executable, str(ROOT / "tests" /
                                 "torch_dist_replication_world.py"),
             str(tmp / "in.pt"), str(tmp / f"out{i}.pt"), *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i, args in enumerate(CHILDREN)}
        ref = subprocess.Popen(
            [sys.executable, "-c", REFERENCE_LOG.format(
                P=REF_P, tests=str(ROOT / "tests"), seed=37,
                out=str(tmp / "ref.npz"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        stacked = {name: run_scenario(
            sc, make_manager(sc["P"], device="cpu", backend=sc["backend"]),
            block_cut(sc["P"])) for name, sc in SCENARIOS.items()}
        results = {}
        for i, child in children.items():
            w_out, w_err = child.communicate(timeout=600)
            assert child.returncode == 0, \
                f"{CHILDREN[i]}\nstdout:\n{w_out}\nstderr:\n{w_err}"
            for P, ranks in torch.load(tmp / f"out{i}.pt",
                                       weights_only=False).items():
                for r, got in zip(results.setdefault(P, ranks), ranks):
                    if got is not r:
                        r["scenarios"].update(got["scenarios"])
        r_out, r_err = ref.communicate(timeout=600)
        assert ref.returncode == 0, f"stdout:\n{r_out}\nstderr:\n{r_err}"
        reference = dict(np.load(tmp / "ref.npz"))
    return results, reference, stacked


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[:2]


@pytest.fixture(scope="module")
def stacked(runs):
    return runs[2]


def _ranks(results, name):
    P = SCENARIOS[name]["P"]
    ranks = results[P]
    assert [r["rank"] for r in ranks] == list(range(P))
    return [(r["rank"], r["scenarios"][name]) for r in ranks]


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x if isinstance(x, torch.Tensor) else torch.as_tensor(x)]


def _assert_bitwise(want, got, what):
    a, b = _leaves(want), _leaves(got)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, \
            f"{what} leaf {i}: {x.dtype}{tuple(x.shape)} vs " \
            f"{y.dtype}{tuple(y.shape)}"
        assert torch.equal(x, y), f"{what} leaf {i}:\n{x}\nvs\n{y}"


def _rows_of(out, P, p):
    """Participant ``p``'s rows of a stacked output (leaves led by P)."""
    if isinstance(out, (tuple, list)):
        return type(out)(_rows_of(v, P, p) for v in out)
    return out[p:p + 1] if out.dim() and out.shape[0] == P else out


def _what(name, i):
    sc = SCENARIOS[name]
    steps = sc["steps"][1:] if sc["kind"] == "ring" else sc["steps"]
    return f"{name} step {i} ({steps[i][0]})"


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_ranks_blocks_are_the_stacked_rows_after_every_step(
        worlds, stacked, name):
    results, _ref = worlds
    want_steps, _pub, _ledger = stacked[name]
    for p, got in _ranks(results, name):
        assert len(got["steps"]) == len(want_steps)
        for i, ((want, _), (state, _o)) in enumerate(zip(want_steps,
                                                         got["steps"])):
            if SCENARIOS[name]["kind"] == "ring":
                want, state = (want,), (state,)
            for w, g in zip(want, state):
                _assert_bitwise(state_block(w, p), g,
                                f"{_what(name, i)} rank {p}")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_ranks_outputs_are_its_rows_and_publishes_match(
        worlds, stacked, name):
    results, _ref = worlds
    P = SCENARIOS[name]["P"]
    want_steps, publishes, _ledger = stacked[name]
    assert publishes > 0
    for p, got in _ranks(results, name):
        assert got["publishes"] == publishes
        for i, ((_s, want), (_st, outs)) in enumerate(zip(want_steps,
                                                          got["steps"])):
            _assert_bitwise(_rows_of(want, P, p), outs,
                            f"{_what(name, i)} rank {p}")


def _summed(rows, table):
    out = {}
    for r in rows:
        for verb, e in r[table].items():
            acc = out.setdefault(verb, {"calls": 0, "bytes": 0.0})
            acc["calls"] += e["calls"]
            acc["bytes"] += e["bytes"]
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_ledger_rows_match_the_stacked_ledger(worlds, stacked, name):
    """Rounds, corrupt and fenced tiers on rank 0 as the stacked ledger's
    (the others file none); bytes and measured-DMA rows summed over the
    ranks (each rank files its own verbs' rows; the publish's on rank 0)."""
    results, _ref = worlds
    _steps, _pub, want = stacked[name]
    rows = [got["ledger"] for _p, got in _ranks(results, name)]
    assert want["bytes"] and want["rounds"]
    for table in ("rounds", "corrupt", "fenced"):
        assert rows[0][table] == want[table], table
    for r in rows[1:]:
        assert not r["corrupt"] and not r["fenced"]
        assert all(e["rounds"] == 0.0 for e in r["rounds"].values())
    for table in ("bytes", "dma"):
        assert _summed(rows, table) == want[table], table
    publish = [v for v in want["bytes"] if v.endswith(".publish")]
    assert publish and rows[0]["bytes"][publish[0]] \
        == want["bytes"][publish[0]]
    if SCENARIOS[name]["backend"] == "pallas" and \
            SCENARIOS[name]["kind"] == "log":
        assert want["dma"], "the rejoin reads file measured bytes"


@pytest.mark.parametrize("name", [k for k in SCENARIOS if "ring" in k])
def test_the_ring_scenarios_semantics(stacked, name):
    """A lane refused by a full ring, the corrupted slot rejected at one
    consumer, the stale epoch fenced, the takeover's window delivered."""
    steps, _pub, ledger = stacked[name]
    P = SCENARIOS[name]["P"]
    owner = SCENARIOS[name]["steps"][0][0]
    sent = steps[2][1][0]
    assert sent[owner].tolist() == [True, False, False]
    _st, (_m, _ln, got, _f) = steps[6]
    assert not got[P - 1].any() and got[:P - 1, 0].all()
    _st, (_m, _ln, got, fenced) = steps[9]
    assert fenced[:P - 1, :2].all() and not got.any()
    _st, (_m, _ln, got, _f) = steps[12]
    assert got[:P - 1].all()
    assert ledger["corrupt"]["rb"] >= 1 and ledger["fenced"]["rb"] >= 1


def _tagged(name, steps):
    """{tag: (states, outputs)} of the log scenario's tagged steps."""
    return {args["tag"]: steps[i]
            for i, (_k, args) in enumerate(SCENARIOS[name]["steps"])
            if args.get("tag")}


@pytest.mark.parametrize("name", LOGS)
def test_the_log_scenarios_semantics(stacked, name):
    """The restarted promotion's winner at epoch 2, one verdict on the dead
    after THRESH windows, the zombie fenced, the snapshot needed and
    installed, every live follower converged, the short gap replayed from
    the ring, the wedged follower's drop retried."""
    steps, _pub, ledger = stacked[name]
    P = SCENARIOS[name]["P"]
    t = _tagged(name, steps)
    dead = [0, 1] if P >= 4 else [0]
    verdict = t["verdict"][1][0]
    assert (verdict.all(0) == torch.tensor(
        [p not in dead for p in range(P)])).all()
    assert not t["promote"][0][3].fence_heads.eq(0xFFFFFFFF).all()
    winner = t["promote"][1][0]
    assert winner.tolist() == [2 if P >= 4 else 1] * P
    assert t["zombie"][1][0].all()
    assert t["fenced"][1][0].tolist() == [0] * P      # fenced, not applied
    assert ledger["fenced"]["log/log"] >= 1
    assert t["gap"][1][0].all() and not t["short gap"][1][0].any()
    rejoin = t["rejoined"][0][5]
    assert bool(rejoin.done.all()) and int(rejoin.restarts.max()) == 0
    state, (lag, epoch, owner) = t["converged"]
    assert lag.tolist() == [0] * P and owner.tolist() == winner.tolist()
    assert epoch.tolist() == [2] * P
    lanes = torch.tensor([p not in dead[1:] for p in range(P)])
    for f in state[1:3]:
        assert diverging_leaves(state[0], f, lanes=lanes) == []
    log = state[3]
    assert int(log.failovers[0]) == 2
    assert int(log.fenced[0]) >= 1
    assert not t["drop"][1][1].any() and t["retry"][1][1].all()
    end, (lag, _e, _o) = t["end"]
    assert lag.tolist() == [0] * P
    assert int(end[3].dropped[0]) >= 2 and int(end[3].retries[0]) >= 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_world_of_8_matches_the_reference_under_shard_map(
        worlds, backend):
    """The log scenario's states and outputs of every rank of the world of
    8, on each backend, bitwise the reference participants' rows under its
    ``shard_map`` binding (one-sided; the backends' states are equal)."""
    from torch_port_ref import leaves, torch_to_numpy
    results, ref = worlds
    name = f"log{REF_P}_{backend}"
    n_steps = len(SCENARIOS[name]["steps"])
    assert max(int(k.split("/")[0]) for k in ref) == n_steps - 1
    for p, got in _ranks(results, name):
        for i, (state, outs) in enumerate(got["steps"]):
            groups = dict(zip(("lead", "fol0", "fol1", "log", "det",
                               "rejoin"), state))
            for group, tree in groups.items():
                for path, leaf in leaves(torch_to_numpy(tree)):
                    key = f"{i}/{group}/{path}"
                    want = ref[key][p:p + 1]
                    assert leaf.dtype == want.dtype, key
                    np.testing.assert_array_equal(
                        leaf, want, err_msg=f"rank {p} {key}")
            want = [ref[k] for k in sorted(
                (k for k in ref if k.startswith(f"{i}/out/")),
                key=lambda k: int(k.rsplit("/", 1)[1]))]
            assert len(want) == len(outs), f"step {i}"
            for j, (o, w) in enumerate(zip(outs, want)):
                np.testing.assert_array_equal(
                    torch_to_numpy(o), w[p:p + 1] if w.ndim else w,
                    err_msg=f"rank {p} step {i} output {j}")


@pytest.mark.parametrize("P", WORLDS)
def test_remote_copy_peers_plain_version_is_the_stacked_copy(worlds, P):
    """Each rank's plain ``remote_copy_peers`` (a gather and a select over
    the world) is its row of ``_remote_copy_ref`` on the stacked rows:
    values and both byte counters, for maps with -1, self and out-of-range
    entries, int32 and int64."""
    results, _ref = worlds
    for r in results[P]:
        p = r["rank"]
        for (words, sender), got in zip(COPY_CASES[P], r["copy"]):
            w = torch.from_numpy(words)
            want = rdma._remote_copy_ref(w, w, torch.from_numpy(sender))
            _assert_bitwise(_rows_of(want, P, p), got,
                            f"P={P} rank {p} sender {sender.tolist()}")
