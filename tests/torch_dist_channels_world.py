"""The gloo worlds of ``tests/test_torch_dist_channels.py``, run as one child
process:

    python tests/torch_dist_channels_world.py <inputs.pt> <outputs.pt>

``inputs.pt`` holds scenarios: a channel to build (a KVStore, a queue, a
lock stripe, a barrier, an atomic word, an SST, ...) on P participants and
the steps to run on it, each step a channel method and its (P, ...)
arguments.  For every P the scenarios need, one world of P ranks is
spawned on the CPU over gloo (:func:`repro_torch.launch.world.spawn_world`);
each rank binds ``make_manager(P, mesh=ProcessMesh(P))``, takes its block
of each step's arguments, runs the steps on its own block of the state and
keeps, after every step, its state block, the step's outputs and, at the
end, its traffic ledger.  A world of 8 also runs the port of the reference's
``tests/test_shardmap_binding.py`` programs
(:func:`repro_torch.examples.process_map.shardmap_programs`), and every
world asks the refusals.  :func:`run_steps` is the same driver the test runs on the
stacked binding.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import (AckKey, AtomicVar, Barrier, KVStore,
                              OwnedVar, SharedQueue, SharedRegion, SST,
                              TicketLock, TicketLockArray)
from repro_torch.examples.process_map import shardmap_programs


def build(mgr, spec):
    """The channel ``spec`` = (kind, kwargs) names, built under ``mgr``, and
    its initial state."""
    kind, kw = spec
    kw = dict(kw)
    if kind == "kv":
        ch = KVStore(None, "kv", mgr, **kw)
        return ch, ch.init_state()
    init = kw.pop("init", None)
    cls = {"queue": SharedQueue, "locks": TicketLockArray,
           "barrier": Barrier, "atomic": AtomicVar, "sst": SST,
           "ownedvar": OwnedVar, "region": SharedRegion,
           "ticketlock": TicketLock}[kind]
    ch = cls(None, kind, mgr, **kw)
    return ch, (ch.init_state() if init is None else ch.init_state(init))


def _outputs(r, state_type):
    """A channel method's result → (state or None, its other outputs,
    acknowledgement keys dropped)."""
    if isinstance(r, state_type):
        return r, ()
    if isinstance(r, tuple) and not hasattr(r, "_fields"):
        rest = tuple(x for x in r if not isinstance(x, AckKey))
        if isinstance(rest[0], state_type):
            return rest[0], rest[1:]
        return None, rest
    return None, (r,)


def _corrupt(kv, st, key, rt):
    """Flip the low checksum bit of ``key``'s row at its home — a torn row
    that the GETs reading it retry on.  The index is the same at every
    participant, so each finds the row and its home flips it."""
    keys = torch.full((rt.n_local, 1), key, dtype=torch.int64)
    _found, _pos, node, slot, _ctr = kv._index_lookup(st, keys)
    home, slot = int(node[0, 0]), int(slot[0, 0])
    loc = home - rt.rank
    if not 0 <= loc < rt.n_local:
        return st
    buf = st.rows.buf.clone()
    buf[loc, slot, kv.W + 2] ^= 1
    return st._replace(rows=st.rows._replace(buf=buf))


def run_steps(ch, state, steps, cut):
    """Run ``steps`` on ``ch`` from ``state``; ``cut`` takes the held
    participants' block of a (P, ...) argument (the identity on the stacked
    binding).  Returns [(state, outputs)] after every step."""
    rt = ch.mgr.runtime
    out = []
    for name, args, kwargs in steps:
        args = [cut(a) for a in args]
        kwargs = {k: cut(v) for k, v in kwargs.items()}
        if name == "corrupt":
            state, outs = _corrupt(ch, state, *args, rt=rt), ()
        elif name == "replay":
            recs = ch.export_window_records(*args, **kwargs)
            state, res = ch.replay_window_records(state, recs)
            outs = (recs, res)
        else:
            new, outs = _outputs(getattr(ch, name)(state, *args, **kwargs),
                                 type(state))
            state = state if new is None else new
        out.append((state, outs))
    return out


def block_cut(P, rank=None):
    """The ``cut`` of :func:`run_steps`: numpy arguments as tensors, each
    (P, ...) one cut to participant ``rank``'s block (all of it when
    ``rank`` is None, the stacked binding)."""
    def cut(a):
        if isinstance(a, np.ndarray) and rank is not None and a.ndim \
                and a.shape[0] == P:
            return torch.from_numpy(a[rank:rank + 1].copy())
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a.copy())
        return a
    return cut


def ledger_rows(traffic):
    return {"bytes": traffic.summary(), "rounds": traffic.rounds_summary(),
            "dma": traffic.dma_summary(), "cache": traffic.cache_summary(),
            "fastpath": traffic.fastpath_summary()}


def _refusals(mgr, mesh, P):
    """What a process runtime refuses: a mesh axis whose size is not P."""
    from repro_torch.core import make_manager
    said = {}
    tries = {"size": lambda: make_manager(P + 1, mesh=mesh),
             "axis": lambda: make_manager(P, mesh=mesh, axis="model")}
    for name, fn in tries.items():
        try:
            fn()
            said[name] = None
        except (NotImplementedError, ValueError) as e:
            said[name] = f"{type(e).__name__}: {e}"
    return said


def channels_rank(rank, P, scenarios, programs):
    """One rank of a world of P: every scenario on the 1-D ``("nodes",)``
    mesh of P, or, where a scenario names a ``mesh`` and an ``axis``, on
    that axis of a second mesh of the same world (its participant this
    rank's coordinate there)."""
    from repro_torch.core import make_manager
    from repro_torch.launch.mesh import ProcessMesh
    torch.set_num_threads(1)
    meshes = {(P,): ProcessMesh(P)}
    result = {"rank": rank, "scenarios": {}}
    for name, sc in scenarios.items():
        sizes, axis = tuple(sc.get("mesh", (P,))), sc.get("axis", "nodes")
        if sizes not in meshes:
            meshes[sizes] = ProcessMesh(*sizes)
        mesh = meshes[sizes]
        part = mesh.coord(axis)
        mgr = make_manager(sc["P"], mesh=mesh, axis=axis,
                           backend=sc.get("backend"))
        mgr.traffic.enable()
        ch, state = build(mgr, sc["channel"])
        steps = run_steps(ch, state, sc["steps"], block_cut(sc["P"], part))
        result["scenarios"][name] = {"steps": steps, "participant": part,
                                     "ledger": ledger_rows(mgr.traffic)}
    mesh = meshes[(P,)]
    result["refusals"] = _refusals(make_manager(P, mesh=mesh), mesh, P)
    if programs:
        result["programs"] = shardmap_programs(
            lambda: make_manager(P, mesh=mesh), P)
    return result


def main(inp, outp):
    from repro_torch.launch.world import spawn_world
    job = torch.load(inp, weights_only=False)
    out = {}
    for P in sorted(job["worlds"]):
        scenarios = {k: v for k, v in job["scenarios"].items()
                     if v.get("world", v["P"]) == P}
        out[P] = spawn_world(channels_rank, P, backend="gloo", device="cpu",
                             args=(P, scenarios, P in job["programs"]),
                             timeout_s=job.get("timeout_s", 240))
    torch.save(out, outp)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

