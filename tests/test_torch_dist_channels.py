"""The channel objects across processes, on the CPU: the process binding
(``make_manager(P, mesh=ProcessMesh(P))``, one participant a rank) against
the stacked binding and against the reference's ``shard_map`` binding.

One module fixture runs two children at once:

* ``tests/torch_dist_channels_world.py`` spawns gloo worlds of 2, 4 and 8
  ranks on the CPU.  Each rank runs every scenario of its P on its own
  block — seeded numpy windows of the KVStore (NOP/GET/INSERT/UPDATE/
  DELETE/MOVE with explicit targets, cached ``get_batch``, lock-free
  windows, ``rebalance``, exported and replayed records, a torn row whose
  GET retries only one participant's lane takes, a window whose service
  rounds only one participant's lanes need) on the three backends, a
  ``reference_impl=True`` store, the queue's windows and scalar paths, the
  lock stripe's windows, barrier crossings, the atomic word, the SST, an
  owned var, a shared region and a ticket lock, and (in the world of 4) a
  store of 2 participants over the ``model`` axis of a (2, 2) mesh — and
  keeps its state block after every step, the step's outputs and its
  traffic ledger;
* one JAX subprocess (8 host devices, the reference imported through the
  shim of ``tests/torch_port_ref.py``) runs the programs of the
  reference's ``tests/test_shardmap_binding.py`` — PROG and PROG2, their
  text copied here with lines that keep their states and results — under
  ``shard_map`` and writes them out as numpy.

The same scenarios run here on the stacked binding (:func:`run_steps`, the
world script's driver).  Held: every rank's state block bitwise the stacked
state's row after every step, leaf by leaf; every output its rows of the
stacked output; the ledger's byte, cache and measured-DMA rows summed over
the ranks equal to the stacked ledger's, its round and lock-free-window
rows on rank 0 equal to the stacked ones (zero on the other ranks); the
world of 8's states and results of the reference programs bitwise the
reference participants' rows, and the programs' own assertions (run in
each rank); the refusals (a mesh axis whose size is not P; the ring, the
log and the detector run across processes, in
``tests/test_torch_dist_replication.py``)."""
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (DELETE, GET, INSERT, MOVE, NOP, UPDATE,
                              make_manager)
from repro_torch.core.kvstore import MAX_GET_RETRIES, _leaf_out
from repro_torch.core.runtime import assemble_blocks, state_block
from torch_dist_channels_world import block_cut, build, ledger_rows, run_steps

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["onesided", "active_message", "pallas"]
B, W = 6, 2

# The programs of tests/test_shardmap_binding.py (PROG, then PROG2), as
# they stand there, with ``keep`` lines that write out what they pass
# through.
REFERENCE_PROGRAMS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {tests!r})
    from torch_port_ref import reference_core
    reference_core()
    import jax, jax.numpy as jnp, numpy as np

    out = {{}}
    def keep(name, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out["/".join([name] + [k.name for k in path])] = np.asarray(leaf)

    # ---- PROG
    from repro.core import (Barrier, KVStore, SharedQueue, make_manager,
                            INSERT, GET, NOP)

    P = 8
    if hasattr(jax.sharding, "AxisType"):          # jax >= 0.5
        mesh = jax.make_mesh((P,), ("nodes",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    else:
        mesh = jax.make_mesh((P,), ("nodes",))
    mgr = make_manager(P, axis="nodes", mesh=mesh)

    # --- barrier under shard_map
    bar = Barrier(None, "bar", mgr)
    st = bar.init_state()
    def prog(s):
        s = bar.wait(s)
        return bar.wait(s)
    st = jax.jit(lambda s: mgr.runtime.run(prog, s))(st)
    assert np.all(np.asarray(st.count) == 2), st.count
    keep("bar", st)

    # --- kvstore round-trip under shard_map
    kv = KVStore(None, "kv", mgr, slots_per_node=2, value_width=2,
                 num_locks=4, index_capacity=64)
    kst = kv.init_state()
    step = jax.jit(lambda s, o, k, v: mgr.runtime.run(kv.op_round, s, o, k, v))
    ops = jnp.asarray([INSERT] * P, jnp.int32)
    keys = jnp.arange(1, P + 1, dtype=jnp.uint32)
    vals = jnp.stack([jnp.arange(1, P + 1), jnp.arange(1, P + 1) * 7],
                     axis=1).astype(jnp.int32)
    kst, res = step(kst, ops, keys, vals)
    assert np.all(np.asarray(res.found)), res.found
    keep("kv_insert", kst); keep("kv_insert_res", res)
    gets = jnp.asarray([GET] * P, jnp.int32)
    gkeys = jnp.asarray(list(reversed(range(1, P + 1))), jnp.uint32)
    kst, res = step(kst, gets, gkeys, jnp.zeros((P, 2), jnp.int32))
    assert np.all(np.asarray(res.found))
    want = np.stack([np.asarray(gkeys), np.asarray(gkeys) * 7], axis=1)
    np.testing.assert_array_equal(np.asarray(res.value), want)
    keep("kv_get", kst); keep("kv_get_res", res)

    # --- queue under shard_map
    q = SharedQueue(None, "q", mgr, slots_per_node=2, width=1)
    qst = q.init_state()
    def qprog(s, v):
        s, _ = q.enqueue(s, v)
        return q.dequeue(s)
    qst, vals_out, ok = jax.jit(
        lambda s, v: mgr.runtime.run(qprog, s, v))(
        qst, jnp.arange(P, dtype=jnp.int32)[:, None])
    assert np.all(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(vals_out)[:, 0], np.arange(P))
    keep("queue", qst)
    out["queue_vals"], out["queue_ok"] = np.asarray(vals_out), np.asarray(ok)

    # ---- PROG2
    from repro.core import GET, INSERT, KVStore, make_manager
    from repro.core.kvstore import IDX_NODE, IDX_STATE, _USED

    P, B, W = 8, 2, 2
    if hasattr(jax.sharding, "AxisType"):          # jax >= 0.5
        mesh = jax.make_mesh((P,), ("nodes",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    else:
        mesh = jax.make_mesh((P,), ("nodes",))
    mgr = make_manager(P, axis="nodes", mesh=mesh)

    kv = KVStore(None, "kv", mgr, slots_per_node=4, value_width=W,
                 num_locks=8, index_capacity=128, placement="explicit")
    st = kv.init_state()
    step = jax.jit(lambda s, o, k, v, t: mgr.runtime.run(
        lambda s_, o_, k_, v_, t_: kv.op_window(s_, o_, k_, v_, targets=t_),
        s, o, k, v, t))
    move = jax.jit(lambda s, k, d, p: mgr.runtime.run(
        lambda s_, k_, d_, p_: kv.migrate_window(s_, k_, d_, preds=p_),
        s, k, d, p))

    def homes(state):
        idx = np.asarray(state.idx[0])
        used = idx[:, IDX_STATE] == _USED
        return {{int(np.uint32(r[1])): int(r[IDX_NODE]) for r in idx[used]}}

    # --- explicit placement: participant p INSERTs keys (2p+1, 2p+2),
    # homed at key % P — a REMOTE home for most writers.
    keys = np.arange(1, 2 * P + 1, dtype=np.uint32).reshape(P, B)
    vals = jnp.stack([jnp.asarray(keys, jnp.int32) * 10,
                      jnp.asarray(keys, jnp.int32) * 100], axis=-1)
    st, res = step(st, jnp.full((P, B), INSERT, jnp.int32),
                   jnp.asarray(keys), vals, jnp.asarray(keys % P, jnp.int32))
    assert np.all(np.asarray(res.found)), res.found
    assert homes(st) == {{int(k): int(k) % P for k in keys.ravel()}}, homes(st)
    keep("placed", st); keep("placed_res", res)

    # --- MOVE under shard_map: re-home every key to (key + 3) % P; one
    # absent-key lane and one pred-masked lane must fail cleanly.
    mkeys = keys.copy(); mkeys[0, 1] = 999         # absent key
    preds = np.ones((P, B), bool); preds[1, 0] = False
    st, moved = move(st, jnp.asarray(mkeys),
                     jnp.asarray((keys + 3) % P, jnp.int32),
                     jnp.asarray(preds))
    moved = np.asarray(moved)
    assert not moved[0, 1] and not moved[1, 0], moved
    assert moved.sum() == P * B - 2, moved
    want = {{int(k): (int(k) + 3) % P for k in keys.ravel()}}
    want[int(keys[0, 1])] = int(keys[0, 1]) % P    # lane carried 999 instead
    want[int(keys[1, 0])] = int(keys[1, 0]) % P    # pred-masked
    assert homes(st) == want, (homes(st), want)
    keep("moved", st); out["moved_mask"] = moved

    # --- values survive the re-home: shifted readers GET every key
    gkeys = np.roll(keys.ravel(), 3).reshape(P, B)
    st, res = step(st, jnp.full((P, B), GET, jnp.int32), jnp.asarray(gkeys),
                   jnp.zeros((P, B, W), jnp.int32),
                   jnp.zeros((P, B), jnp.int32))
    assert np.all(np.asarray(res.found))
    np.testing.assert_array_equal(
        np.asarray(res.value),
        np.stack([gkeys * 10, gkeys * 100], axis=-1).astype(np.int32))
    keep("regets", st); keep("regets_res", res)
    np.savez({out!r}, **out)
""")


# ---------------------------------------------------------------- scenarios
def _kv_steps(P, rng):
    """The KVStore's windows: explicit homes, mixed ops with MOVE lanes,
    lock-free windows, cached reads, a torn row, uneven service rounds,
    rebalance, replayed records, migration and the B = 1 round."""
    n_keys = P * B
    keys0 = (np.arange(1, n_keys + 1, dtype=np.uint32) * 7).reshape(P, B)
    # B rows a home, so that every home keeps 4 free slots
    homes0 = rng.permutation(np.arange(P * B) % P).reshape(P, B) \
        .astype(np.int32)

    def vals():
        return rng.integers(-99, 99, (P, B, W)).astype(np.int32)

    def window(weights):
        ops = rng.choice([NOP, GET, INSERT, UPDATE, DELETE, MOVE], (P, B),
                         p=weights).astype(np.int32)
        keys = rng.choice(keys0.ravel(), (P, B)).astype(np.uint32)
        return ops, keys, vals(), rng.integers(0, P, (P, B)).astype(np.int32)

    steps = [("op_window", [np.full((P, B), INSERT, np.int32), keys0,
                            vals()], {"targets": homes0})]
    # a torn row at its home: a GET of it, from participant 0 alone,
    # retries while the others wait in the same loop
    k = int(keys0[P - 1, 0])
    steps.append(("corrupt", [k], {}))
    ops = np.full((P, B), NOP, np.int32)
    ops[0, 0] = GET
    gk = np.full((P, B), k, np.uint32)
    steps.append(("op_window", [ops, gk, vals()],
                  {"targets": homes0, "lockfree": False}))
    steps.append(("op_window", [np.full((P, B), UPDATE, np.int32), gk,
                                vals()], {"targets": homes0}))
    # participant 0 alone needs three service rounds (INSERT, DELETE,
    # INSERT of one key); the others only GET
    ops = np.full((P, B), GET, np.int32)
    ops[0, :3] = [DELETE, INSERT, DELETE]
    uk = keys0.copy()
    uk[0, :3] = keys0[0, 0]
    steps.append(("op_window", [ops, uk, vals()], {"targets": homes0}))
    for weights in ([.1, .3, .2, .2, .1, .1], [.05, .2, .25, .2, .2, .1],
                    [0, .4, 0, .6, 0, 0], [0, 1, 0, 0, 0, 0]):
        ops, keys, v, t = window(weights)
        steps.append(("op_window", [ops, keys, v], {"targets": t}))
    for _ in range(2):
        steps.append(("get_batch", [rng.choice(keys0.ravel(), (P, B))
                                    .astype(np.uint32)], {}))
    steps.append(("get_batch", [keys0, rng.random((P, B)) < 0.7], {}))
    steps.append(("rebalance", [P * B // 2], {}))
    ops, keys, v, t = window([.1, .2, .3, .2, .1, .1])
    steps.append(("replay", [ops, keys, v], {"targets": t}))
    steps.append(("migrate_window",
                  [rng.choice(keys0.ravel(), (P, 2)).astype(np.uint32),
                   rng.integers(0, P, (P, 2)).astype(np.int32)],
                  {"preds": rng.random((P, 2)) < 0.8}))
    return steps


def _kv_local_steps(P, rng):
    """The writer-local store (the main path's): mixed windows without
    targets over more keys than its small index holds, so that inserts
    overflow it and return their slots, the uncached read, lock-free
    fast windows and the B = 1 round."""
    keys0 = np.arange(1, 3 * P * B + 1, dtype=np.uint32)

    def window(weights):
        ops = rng.choice([NOP, GET, INSERT, UPDATE, DELETE], (P, B),
                         p=weights).astype(np.int32)
        return [ops, rng.choice(keys0, (P, B)).astype(np.uint32),
                rng.integers(-99, 99, (P, B, W)).astype(np.int32)]

    steps = [("op_window", [np.full((P, B), INSERT, np.int32),
                            keys0[:P * B].reshape(P, B),
                            rng.integers(-9, 9, (P, B, W)).astype(np.int32)],
              {})]
    for weights in ([0, .2, .6, .1, .1], [.1, .3, .2, .2, .2],
                    [0, .5, 0, .5, 0], [.1, .2, .3, .2, .2]):
        steps.append(("op_window", window(weights), {}))
    steps.append(("get_batch", [rng.choice(keys0, (P, B)).astype(np.uint32)],
                  {}))
    steps.append(("op_round", [rng.choice([GET, INSERT, UPDATE, DELETE], P)
                               .astype(np.int32),
                               rng.choice(keys0, P).astype(np.uint32),
                               rng.integers(0, 9, (P, W)).astype(np.int32)],
                  {}))
    return steps


def _kv_reference_steps(P, rng):
    """A ``reference_impl=True`` store: the specification's windows, the
    B = 1 round and the scalar one, and its migration."""
    keys0 = np.arange(1, P * 3 + 1, dtype=np.uint32).reshape(P, 3)
    steps = [("op_window", [np.full((P, 3), INSERT, np.int32), keys0,
                            rng.integers(0, 9, (P, 3, W)).astype(np.int32)],
              {})]
    for _ in range(2):
        ops = rng.choice([GET, INSERT, UPDATE, DELETE], (P, 3)) \
            .astype(np.int32)
        steps.append(("op_window",
                      [ops, rng.choice(keys0.ravel(), (P, 3))
                       .astype(np.uint32),
                       rng.integers(0, 9, (P, 3, W)).astype(np.int32)], {}))
    steps.append(("op_round",
                  [rng.choice([GET, INSERT, UPDATE, DELETE], P)
                   .astype(np.int32),
                   rng.choice(keys0.ravel(), P).astype(np.uint32),
                   rng.integers(0, 9, (P, W)).astype(np.int32)], {}))
    steps.append(("_op_round_reference",
                  [rng.choice([GET, INSERT, UPDATE, DELETE], P)
                   .astype(np.int32),
                   rng.choice(keys0.ravel(), P).astype(np.uint32),
                   rng.integers(0, 9, (P, W)).astype(np.int32)], {}))
    steps.append(("_migrate_reference",
                  [rng.choice(keys0.ravel(), (P, 2)).astype(np.uint32),
                   rng.integers(0, P, (P, 2)).astype(np.int32)], {}))
    return steps


def _channel_scenarios(P, rng):
    """The other channels at P participants: their windows and scalar
    paths."""
    def b(shape, p=0.7):
        return rng.random(shape) < p

    def i32(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    sc = {}
    sc["queue"] = ("queue", dict(slots_per_node=2, width=2), [
        ("enqueue_window", [i32(0, 99, (P, 3, 2)), b((P, 3))], {}),
        ("dequeue_window", [b((P, 2))], {}),
        ("enqueue_window", [i32(0, 99, (P, 2, 2)), b((P, 2), 0.9)], {}),
        ("enqueue", [i32(0, 99, (P, 2)), b(P)], {}),
        ("dequeue", [b(P)], {}),
        ("_enqueue_reference", [i32(0, 99, (P, 2)), b(P)], {}),
        ("_dequeue_reference", [b(P)], {}),
        ("dequeue_window", [b((P, 4), 0.9)], {})])
    L = 3
    lids = i32(0, L, (P, 4))
    sc["locks"] = ("locks", dict(num_locks=L), [
        ("acquire_window", [lids, b((P, 4))], {}),
        ("holds", [lids, i32(0, 3, (P, 4)).astype(np.int64)], {}),
        ("release_window", [i32(0, L, (P, 2)), b((P, 2), 0.3)], {}),
        ("acquire", [i32(0, L, P), b(P)], {}),
        ("release", [i32(0, L, P), b(P, 0.3)], {}),
        ("acquire_window", [i32(0, L, (P, 2)), b((P, 2))], {})])
    sc["atomic"] = ("atomic", dict(host=min(2, P - 1), dtype=torch.uint32,
                                   init=0xFFFFFFF0), [
        ("fetch_add", [i32(1, 9, P), b(P)], {}),
        ("compare_swap", [np.full(P, 0xFFFFFFF4, np.int64),
                          i32(0, 99, P), b(P)], {}),
        ("store", [i32(0, 99, P), b(P, 0.5)], {}),
        ("pull", [], {}),
        ("fetch_add_window", [i32(0, 5, (P, 3)), b((P, 3))], {})])
    sc["sst"] = ("sst", dict(shape=(2,)), [
        ("store_mine", [i32(0, 99, (P, 2)), b(P)], {}),
        ("push_broadcast", [], {}),
        ("push_accumulate", [i32(1, 5, (P, 2)).astype(np.int64)], {}),
        ("load_row", [i32(0, P, P)], {}),
        ("store_mine", [i32(0, 99, (P, 2))], {}),
        ("pull_all", [], {}),
        ("load_row", [1 % P], {})])
    sc["ownedvar"] = ("ownedvar", dict(owner=P - 1, shape=(3,)), [
        ("store_mine", [rng.standard_normal((P, 3)).astype(np.float32),
                        b(P)], {}),
        ("push", [], {}),
        ("load", [], {}),
        ("store_mine", [rng.standard_normal((P, 3)).astype(np.float32)],
         {}),
        ("pull", [], {})])
    sc["region"] = ("region", dict(slots=5, item_shape=(2,),
                                   dtype=torch.int32, backend="pallas"), [
        ("local_write", [i32(0, 5, P), i32(0, 99, (P, 2))], {}),
        ("write", [i32(0, P, P), i32(0, 5, P), i32(0, 99, (P, 2)), b(P)],
         {}),
        ("read", [i32(0, P, P), i32(0, 5, P), b(P)], {}),
        ("write_batch", [i32(0, P, (P, 4)), i32(0, 5, (P, 4)),
                         i32(0, 99, (P, 4, 2)), b((P, 4))], {}),
        ("read_batch", [i32(0, P, (P, 4)), i32(0, 5, (P, 4)), b((P, 4))],
         {}),
        ("local_read", [i32(0, 5, P)], {})])
    sc["ticketlock"] = ("ticketlock", dict(host=P - 1), [
        ("acquire", [b(P)], {}),
        ("holds", [np.arange(P, dtype=np.int64)], {}),
        ("release", [np.eye(1, P, 0, dtype=bool)[0]], {}),
        ("refresh", [], {}),
        ("holds", [np.arange(P, dtype=np.int64)], {})])
    return {name: {"P": P, "channel": (kind, kw), "steps": steps}
            for name, (kind, kw, steps) in sc.items()}


def _scenarios():
    rng = np.random.default_rng(36)
    out = {}
    for P in (2, 4, 8):
        for backend in BACKENDS:
            out[f"kv{P}_{backend}"] = {
                "P": P, "backend": backend,
                "channel": ("kv", dict(slots_per_node=B + 4, value_width=W,
                                       num_locks=4, cache_slots=4 * P * B,
                                       placement="explicit", track_heat=True,
                                       lockfree=True)),
                "steps": _kv_steps(P, rng)}
            if P == 8:
                continue
            out[f"kvlocal{P}_{backend}"] = {
                "P": P, "backend": backend,
                "channel": ("kv", dict(slots_per_node=2 * B, value_width=W,
                                       num_locks=5, index_capacity=2 * P * B,
                                       index_max_probe=4, lockfree=True)),
                "steps": _kv_local_steps(P, rng)}
    out["kvref2"] = {"P": 2, "backend": "pallas",
                     "channel": ("kv", dict(slots_per_node=8, value_width=W,
                                            num_locks=3, index_capacity=32,
                                            placement="hashed",
                                            reference_impl=True)),
                     "steps": _kv_reference_steps(2, rng)}
    out.update(_channel_scenarios(4, rng))
    for P in (2, 4, 8):
        out[f"barrier{P}"] = {"P": P, "channel": ("barrier", {}),
                              "steps": [("wait", [], {})] * 3}
    # a map over the model axis of a (2, 2) mesh inside a world of 4: each
    # data line runs the same participants
    out["kv2_over_model"] = {
        "P": 2, "world": 4, "mesh": (2, 2), "axis": "model",
        "backend": "pallas",
        "channel": ("kv", dict(slots_per_node=2 * B, value_width=W,
                               num_locks=5, index_capacity=4 * 2 * B)),
        "steps": _kv_local_steps(2, rng)}
    return out


SCENARIOS = _scenarios()
KV = [k for k, v in SCENARIOS.items()
      if v["channel"][0] == "kv" and "mesh" not in v]
PROGRAM_KEYS = ["bar", "kv_insert", "kv_insert_res", "kv_get", "kv_get_res",
                "queue", "placed", "placed_res", "moved", "regets",
                "regets_res"]


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def worlds():
    """Both children, run at once: the gloo worlds and the reference's
    shard_map programs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory(prefix="dist-channels-") as tmp:
        tmp = Path(tmp)
        torch.save({"scenarios": SCENARIOS, "worlds": [2, 4, 8],
                    "programs": [8], "timeout_s": 300}, tmp / "in.pt")
        world = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" /
                                 "torch_dist_channels_world.py"),
             str(tmp / "in.pt"), str(tmp / "out.pt")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        ref = subprocess.Popen(
            [sys.executable, "-c", REFERENCE_PROGRAMS.format(
                tests=str(ROOT / "tests"), out=str(tmp / "ref.npz"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        w_out, w_err = world.communicate(timeout=600)
        r_out, r_err = ref.communicate(timeout=600)
        assert world.returncode == 0, f"stdout:\n{w_out}\nstderr:\n{w_err}"
        assert ref.returncode == 0, f"stdout:\n{r_out}\nstderr:\n{r_err}"
        results = torch.load(tmp / "out.pt", weights_only=False)
        reference = dict(np.load(tmp / "ref.npz"))
    return results, reference


@pytest.fixture(scope="module")
def stacked():
    """Every scenario on the stacked binding: (steps, ledger rows)."""
    out = {}
    for name, sc in SCENARIOS.items():
        P = sc["P"]
        mgr = make_manager(P, device="cpu", backend=sc.get("backend"))
        mgr.traffic.enable()
        ch, state = build(mgr, sc["channel"])
        steps = run_steps(ch, state, sc["steps"], block_cut(P))
        out[name] = (steps, ledger_rows(mgr.traffic))
    return out


def _ranks(results, name):
    """(participant, result) of every rank that ran scenario ``name``."""
    sc = SCENARIOS[name]
    world = sc.get("world", sc["P"])
    ranks = results[world]
    assert [r["rank"] for r in ranks] == list(range(world))
    got = [(r["scenarios"][name]["participant"], r["scenarios"][name])
           for r in ranks]
    assert sorted({p for p, _ in got}) == list(range(sc["P"]))
    return got


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
    """Participant ``p``'s rows of a stacked step output (leaves that lead
    with P), the others as they are."""
    if isinstance(out, (tuple, list)):
        return type(out)(*(_rows_of(v, P, p) for v in out)) \
            if hasattr(out, "_fields") else \
            type(out)(_rows_of(v, P, p) for v in out)
    t = out if isinstance(out, torch.Tensor) else torch.as_tensor(out)
    return t[p:p + 1] if t.dim() and t.shape[0] == P else t


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_ranks_state_is_its_block_of_the_stacked_state(worlds,
                                                            stacked, name):
    results, _ref = worlds
    want_steps, _ledger = stacked[name]
    for p, got in _ranks(results, name):
        assert len(got["steps"]) == len(want_steps)
        for i, ((want, _), (state, _o)) in enumerate(zip(want_steps,
                                                         got["steps"])):
            _assert_bitwise(state_block(want, p), state,
                            f"{name} rank {p} step {i} "
                            f"({SCENARIOS[name]['steps'][i][0]})")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_each_ranks_outputs_are_its_rows_of_the_stacked_outputs(
        worlds, stacked, name):
    results, _ref = worlds
    P = SCENARIOS[name]["P"]
    want_steps, _ledger = stacked[name]
    for p, got in _ranks(results, name):
        for i, ((_s, want), (_st, outs)) in enumerate(zip(want_steps,
                                                          got["steps"])):
            _assert_bitwise(_rows_of(want, P, p), outs,
                            f"{name} rank {p} step {i} "
                            f"({SCENARIOS[name]['steps'][i][0]})")


def _summed(rows, table, keys):
    out = {}
    for r in rows:
        for verb, e in r[table].items():
            acc = out.setdefault(verb, dict.fromkeys(keys, 0.0))
            for k in keys:
                acc[k] += e[k]
    return out


@pytest.mark.parametrize("name", KV)
def test_the_ledger_rows_sum_to_the_stacked_ledger(worlds, stacked, name):
    """Bytes, cache and measured-DMA rows summed over the ranks; rounds
    and lock-free-window rows from rank 0, zero elsewhere."""
    results, _ref = worlds
    _steps, want = stacked[name]
    rows = [got["ledger"] for _p, got in _ranks(results, name)]
    assert want["bytes"] and want["rounds"]
    for table, keys in (("bytes", ("calls", "bytes")),
                        ("dma", ("calls", "bytes")),
                        ("cache", ("hits", "lookups"))):
        assert _summed(rows, table, keys) == {
            v: {k: e[k] for k in keys} for v, e in want[table].items()}, \
            table
    assert rows[0]["rounds"] == want["rounds"]
    assert rows[0]["fastpath"] == want["fastpath"]
    for r in rows[1:]:
        assert all(e["rounds"] == 0.0 for e in r["rounds"].values())
        assert all(e["windows"] == 0.0 for e in r["fastpath"].values())
        assert r["rounds"].keys() == want["rounds"].keys()
    if SCENARIOS[name]["backend"] == "pallas":
        assert want["dma"], "the DMA backend files its measured bytes"


@pytest.mark.parametrize("name", [k for k in KV
                                  if "ref" not in k and "local" not in k])
def test_the_windows_took_uneven_loops(stacked, name):
    """The torn row's GET retried and the uneven window needed three
    service rounds: the world-uniform exits of both loops were taken by
    ranks with nothing of their own to do (and the state blocks above
    still agree)."""
    steps, _ledger = stacked[name]
    _state, (res,) = steps[2]
    assert int(res.retries[0, 0]) == MAX_GET_RETRIES
    assert not bool(res.found[0, 0])
    _state, (res,) = steps[4]
    assert res.found[0, :3].tolist() == [True, True, True]


@pytest.mark.parametrize("key", PROGRAM_KEYS)
def test_the_shardmap_programs_match_the_reference_bitwise(worlds, key):
    """PROG and PROG2 of the reference's production-binding test: each
    rank's block of every state leaf and result is the reference
    participant's row."""
    results, ref = worlds
    names = sorted(k for k in ref if k == key or k.startswith(key + "/"))
    assert names, key
    for r in results[8]:
        p, got = r["rank"], r["programs"][key]
        flat = {}

        def walk(prefix, x):
            if hasattr(x, "_fields"):
                for f in x._fields:
                    walk(f"{prefix}/{f}", getattr(x, f))
            else:
                flat[prefix] = _leaf_out(x)
        walk(key, got)
        assert sorted(flat) == names
        for n in names:
            want = ref[n][p:p + 1]
            assert flat[n].dtype == want.dtype, n
            np.testing.assert_array_equal(flat[n], want,
                                          err_msg=f"rank {p} {n}")


@pytest.mark.parametrize("key", ["queue_vals", "queue_ok", "moved_mask"])
def test_the_shardmap_programs_results_match(worlds, key):
    results, ref = worlds
    for r in results[8]:
        p = r["rank"]
        np.testing.assert_array_equal(_leaf_out(r["programs"][key]),
                                      ref[key][p:p + 1])


@pytest.mark.parametrize("P", [2, 4, 8])
def test_a_process_runtime_refuses_what_is_not_ported(worlds, P):
    results, _ref = worlds
    for r in results[P]:
        said = r["refusals"]
        assert said["size"].startswith("ValueError") and \
            f"has {P} ranks" in said["size"]
        assert said["axis"].startswith("ValueError")


@pytest.mark.parametrize("name", ["kv4_pallas", "queue", "sst"])
def test_state_blocks_assemble_back(stacked, name):
    steps, _ledger = stacked[name]
    state = steps[-1][0]
    P = SCENARIOS[name]["P"]
    back = assemble_blocks([state_block(state, p) for p in range(P)])
    _assert_bitwise(state, back, name)
