"""The channel layer across processes: one participant a rank of a
``torch.distributed`` world (the counterpart of the reference's
``shard_map`` binding, ``make_manager(P, axis="nodes", mesh=mesh)``).

:func:`shardmap_programs` is the port of the two programs the reference's
``tests/test_shardmap_binding.py`` runs on an 8-device mesh: a barrier
crossed twice, a KVStore INSERT/GET round trip through ``op_round``, a
queue's enqueue and dequeue; then an explicit-placement store whose INSERT
window homes rows remotely, a MOVE window that re-homes them (one absent
key and one masked lane failing cleanly) and GETs that read them back.
Each rank passes its own rows of every (P, ...) input, checks the
programs' own assertions on what it holds, and returns the states and
results it went through.  With a stacked manager the same function runs
all P participants at once.

Build a map over processes like this, in every rank::

    from repro_torch.core import make_manager
    from repro_torch.launch.mesh import ProcessMesh, init_distributed
    init_distributed("gloo", P, rank, "tcp://localhost:<port>",
                     device="cpu")          # or "nccl" and the card
    mgr = make_manager(P, mesh=ProcessMesh(P))

Run:  PYTHONPATH=src python -m repro_torch.examples.process_map
      [--world 8] [--device cpu] [--backend pallas]
(:func:`repro_torch.launch.world.spawn_world` starts the ranks; on the card
a world of more than one rank shares it over gloo.)
"""
import argparse

import numpy as np

from repro_torch.core import GET, INSERT, Barrier, KVStore, SharedQueue


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def shardmap_programs(mgr_factory, P):
    """The port of PROG and PROG2 of the reference's production-binding
    test, on the participants ``mgr_factory()``'s managers hold (a fresh
    manager per program).  Returns {name: state or result} in the
    programs' order; raises ``AssertionError`` where a program's own
    assertion fails."""
    from repro_torch.core.kvstore import IDX_NODE, IDX_STATE, _USED
    out = {}
    # --- PROG: barrier, kvstore round-trip, queue
    mgr = mgr_factory()
    rt = mgr.runtime
    mine = slice(rt.rank, rt.rank + rt.n_local)
    bar = Barrier(None, "bar", mgr)
    st = bar.wait(bar.wait(bar.init_state()))
    _check(bool((st.count == 2).all()), f"barrier count {st.count}")
    out["bar"] = st
    kv = KVStore(None, "kv", mgr, slots_per_node=2, value_width=2,
                 num_locks=4, index_capacity=64)
    kst = kv.init_state()
    keys = np.arange(1, P + 1, dtype=np.uint32)
    vals = np.stack([np.arange(1, P + 1), np.arange(1, P + 1) * 7],
                    axis=1).astype(np.int32)
    kst, res = kv.op_round(kst, np.full(P, INSERT, np.int32)[mine],
                           keys[mine], vals[mine])
    _check(bool(res.found.all()), f"INSERT round found {res.found}")
    out["kv_insert"], out["kv_insert_res"] = kst, res
    gkeys = np.asarray(list(reversed(range(1, P + 1))), np.uint32)
    kst, res = kv.op_round(kst, np.full(P, GET, np.int32)[mine],
                           gkeys[mine], np.zeros((P, 2), np.int32)[mine])
    _check(bool(res.found.all()), f"GET round found {res.found}")
    want = np.stack([gkeys, gkeys * 7], axis=1)[mine]
    _check(np.array_equal(res.value.cpu().numpy(), want),
           f"GET round values {res.value}")
    out["kv_get"], out["kv_get_res"] = kst, res
    q = SharedQueue(None, "q", mgr, slots_per_node=2, width=1)
    qst, _ok = q.enqueue(q.init_state(),
                         np.arange(P, dtype=np.int32)[:, None][mine])
    qst, vals_out, ok = q.dequeue(qst)
    _check(bool(ok.all()), f"dequeue ok {ok}")
    _check(np.array_equal(vals_out.cpu().numpy()[:, 0], np.arange(P)[mine]),
           f"dequeued {vals_out}")
    out["queue"], out["queue_vals"], out["queue_ok"] = qst, vals_out, ok

    # --- PROG2: explicit placement, MOVE, GETs after the re-home
    mgr = mgr_factory()
    B, W = 2, 2
    kv = KVStore(None, "kv", mgr, slots_per_node=4, value_width=W,
                 num_locks=8, index_capacity=128, placement="explicit")
    st = kv.init_state()

    def homes(state):
        idx = state.idx[0].cpu().numpy()
        used = idx[:, IDX_STATE] == _USED
        return {int(np.uint32(r[1])): int(r[IDX_NODE]) for r in idx[used]}

    keys = np.arange(1, 2 * P + 1, dtype=np.uint32).reshape(P, B)
    vals = np.stack([keys.astype(np.int32) * 10,
                     keys.astype(np.int32) * 100], axis=-1)
    st, res = kv.op_window(st, np.full((P, B), INSERT, np.int32)[mine],
                           keys[mine], vals[mine],
                           targets=(keys % P).astype(np.int32)[mine])
    _check(bool(res.found.all()), f"placed INSERT found {res.found}")
    _check(homes(st) == {int(k): int(k) % P for k in keys.ravel()},
           f"homes after the placed INSERTs {homes(st)}")
    out["placed"], out["placed_res"] = st, res
    mkeys = keys.copy()
    mkeys[0, 1] = 999                                # absent key
    preds = np.ones((P, B), bool)
    preds[1, 0] = False                              # masked lane
    st, moved = kv.migrate_window(st, mkeys[mine],
                                  ((keys + 3) % P).astype(np.int32)[mine],
                                  preds=preds[mine])
    moved_all = rt.gather(moved).cpu().numpy()
    _check(not moved_all[0, 1] and not moved_all[1, 0]
           and moved_all.sum() == P * B - 2, f"moved {moved_all}")
    want = {int(k): (int(k) + 3) % P for k in keys.ravel()}
    want[int(keys[0, 1])] = int(keys[0, 1]) % P
    want[int(keys[1, 0])] = int(keys[1, 0]) % P
    _check(homes(st) == want, f"homes after the MOVE {homes(st)}")
    out["moved"], out["moved_mask"] = st, moved
    gkeys = np.roll(keys.ravel(), 3).reshape(P, B)
    st, res = kv.op_window(st, np.full((P, B), GET, np.int32)[mine],
                           gkeys[mine], np.zeros((P, B, W), np.int32)[mine],
                           targets=np.zeros((P, B), np.int32)[mine])
    _check(bool(res.found.all()), f"GETs after the MOVE found {res.found}")
    _check(np.array_equal(
        res.value.cpu().numpy(),
        np.stack([gkeys * 10, gkeys * 100], axis=-1).astype(np.int32)[mine]),
        f"GETs after the MOVE read {res.value}")
    out["regets"], out["regets_res"] = st, res
    return out


def _rank(rank, world, backend):
    from repro_torch.core import make_manager
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh(world)
    shardmap_programs(lambda: make_manager(world, mesh=mesh,
                                           backend=backend), world)
    return mesh.backend


def main(world=8, device=None, backend=None):
    from repro_torch.launch.world import spawn_world
    comm = "gloo" if device == "cpu" or world > 1 else "nccl"
    spawn_world(_rank, world, backend=comm, device=device,
                args=(world, backend))
    print(f"the reference's shard_map programs hold on a world of {world} "
          f"({comm}, one participant a rank)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    main(a.world, a.device, a.backend)
