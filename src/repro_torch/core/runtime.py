"""Participant runtime and manager — LOCO's connection/resource manager
(paper §4.2), the counterpart of ``repro/core/runtime.py``, in two
bindings that run the same channel code.

**Stacked** (``mesh=None``, the default).  Every state and argument tensor
carries the leading participant dimension P on one device, and a
collective is a tensor operation over that dimension: an all-gather is the
(P, ...) tensor itself, a psum a sum over dim 0, ``axis_index`` is
``torch.arange(P)``.  On one card the P participants share its memory, and
the "wire hop" is a gather in device memory.  This is the reference's
``jax.vmap`` binding.

**Process** (``mesh=`` a :class:`~repro_torch.launch.mesh.ProcessMesh`).
The P participants are the P ranks of the mesh's ``axis``, one participant
a rank, as the reference's ``shard_map`` binding puts one on each device.
Each rank holds only its own participant's block of every state leaf: a
leading dimension of 1 where the stacked form has P.  Two participant
notions follow, and channel code keeps them apart:

* ``P`` is the cluster's size; ``n_local`` the participants held here (P
  stacked, 1 a rank), which is what every state and lane tensor leads with;
* :meth:`Runtime.my_id` is each held participant's *global* id (what a
  ``target == me`` test compares), ``arange(P)`` stacked and ``[rank]`` a
  rank; :meth:`Runtime.local_ids` indexes the leading dimension.

The collectives (:meth:`Runtime.gather`, :meth:`~Runtime.gather_many`,
:meth:`~Runtime.mine`, :meth:`~Runtime.with_own`,
:meth:`~Runtime.psum_scatter`, :meth:`~Runtime.bcast`, :meth:`~Runtime.pmax`,
:meth:`~Runtime.world_any`, :meth:`~Runtime.any`) are the identity or the tensor operation the stacked code did before the
process form existed, so the stacked path is bitwise what it was; in the
process form each is a ``torch.distributed`` collective over the mesh's
group for ``axis`` (:mod:`repro_torch.distributed.collectives`, gloo moving
card tensors natively where :func:`~repro_torch.distributed.collectives.
probe_transports` found it can).  Channel code computes what every
participant agrees on from the *gathered* lanes — the whole (P, ...)
table, the stacked tensor itself — and keeps its own rows of it
(:meth:`~Runtime.mine`).

**World-uniform loop exits.**  The reference loops with ``lax.while_loop``
on psum'd flags, so every participant takes the same number of iterations.
The port reads its flags on the host; in the process form each such read
is :meth:`Runtime.any`, an all-reduce max of the flag before ``bool``, so
no rank leaves a loop another rank is still in (it would wait in that
rank's next collective for ever).

**Ledger.**  Byte rows, cache rows and the measured DMA tier are each
rank's own and sum over the ranks to the stacked binding's totals; rounds
and lock-free-window counts are cluster-wide and are added by rank 0 alone
(the reference counts a round on participant 0 only).  The ring's rows
that the stacked binding files as one row of every participant's counts
(the publish's bytes, the corrupt and fenced tiers) rank 0 files from the
gathered counts (:meth:`Runtime.lead_rows`), so its rows are the
stacked ledger's.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from .ack import ALL_PEERS, AckKey, FenceScope, join


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no card present that raises instead of
    running on the CPU — the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch path on the CPU")
    return dev


class Runtime:
    """The binding of P participants: stacked on ``device`` (``mesh=None``),
    or one a rank of ``mesh``'s ``axis`` (a
    :class:`~repro_torch.launch.mesh.ProcessMesh` whose ``axis`` has P
    ranks; the tensors live on ``mesh.device``).  Channel methods take and
    return tensors led by :attr:`n_local` participants, so they may be
    called directly where the reference wraps them in :meth:`run`."""

    def __init__(self, num_participants: int, device=None, mesh=None,
                 axis: str = "nodes"):
        self.P = int(num_participants)
        self.mesh = mesh
        self.axis = axis
        self._ids = {}
        if mesh is None:
            self.device = resolve_device(device)
            self.n_local = self.P
            self.rank = 0
            return
        size = mesh.shape.get(axis)
        if size != self.P:
            raise ValueError(f"mesh axis {axis!r} has {size} ranks, but the "
                             f"runtime expects {self.P} participants")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"a process runtime's tensors live on the "
                             f"mesh's device {mesh.device}, not {device}")
        self.device = mesh.device
        self.n_local = 1
        self.rank = mesh.coord(axis)
        if not hasattr(mesh, "transports"):
            from ..distributed.collectives import probe_transports
            probe_transports(mesh)

    @property
    def stacked(self) -> bool:
        """Whether all P participants are held here (the stacked form)."""
        return self.mesh is None

    @property
    def lead(self) -> bool:
        """Whether this binding adds the cluster-wide ledger rows: the
        stacked one, and rank 0 of a process one."""
        return self.rank == 0

    def run(self, fn: Callable, *args):
        """Execute ``fn`` for every participant held here at once: ``fn``
        takes the (n_local, ...) ``args`` and returns such outputs.  The
        reference's ``jax.vmap``/``shard_map`` over a per-participant
        program is the identity of both forms."""
        return fn(*args)

    def _arange(self, lo: int, n: int) -> torch.Tensor:
        """``arange(lo, lo + n)`` on the device, made once: callers read
        the ids and never write them."""
        if (lo, n) not in self._ids:
            self._ids[lo, n] = torch.arange(lo, lo + n, device=self.device)
        return self._ids[lo, n]

    def my_id(self) -> torch.Tensor:
        """(n_local,) global participant ids — the ``axis_index``."""
        return self._arange(self.rank, self.n_local)

    def local_ids(self) -> torch.Tensor:
        """(n_local,) positions on the leading dimension (on the stacked
        binding the ids themselves)."""
        return self._arange(0, self.n_local)

    def all_ids(self) -> torch.Tensor:
        """(P,) every participant's id (on the stacked binding the ids
        held here)."""
        return self._arange(0, self.P)

    def stack(self, per_participant_values: List[Any]):
        """Stack the P per-participant values (tensors, arrays, numbers, or
        NamedTuples of them) leaf by leaf into the runtime's (n_local, ...)
        layout on its device: a rank keeps its own."""
        return _stack(per_participant_values[self.rank:
                                             self.rank + self.n_local],
                      self.device)

    # -- the collectives ----------------------------------------------------
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n_local, ...) → the (P, ...) table of every participant's rows,
        in participant order (the reference's ``all_gather``): the stacked
        tensor itself.  Bool tensors travel as uint8."""
        if self.stacked:
            return x
        from ..distributed import collectives as DC
        if x.dtype == torch.bool:
            return DC.all_gather(x.to(torch.uint8), self.mesh,
                                 self.axis) != 0
        return DC.all_gather(x, self.mesh, self.axis)

    def gather_many(self, *xs: torch.Tensor):
        """:meth:`gather` of several integer or bool (n_local, ...) tensors
        in one collective: packed as int64 words, unpacked to their
        dtypes."""
        if self.stacked:
            return xs
        flat = torch.cat([x.to(torch.int64).reshape(self.n_local, -1)
                          for x in xs], dim=1)
        g = self.gather(flat)
        out, off = [], 0
        for x in xs:
            k = x[0].numel()
            out.append(g[:, off:off + k].reshape((self.P,) + x.shape[1:])
                       .to(x.dtype))
            off += k
        return tuple(out)

    def mine(self, table: torch.Tensor) -> torch.Tensor:
        """This binding's rows of a (P, ...) table: the table itself
        stacked, a rank's own row (a view) in the process form."""
        if self.stacked:
            return table
        return table[self.rank:self.rank + self.n_local]

    def with_own(self, table: torch.Tensor, local: torch.Tensor):
        """The (P, ...) ``table`` with the rows held here replaced by
        ``local``: ``local`` itself stacked (it is every row), a copy of the
        gathered table with the rank's row put back in the process form —
        a home's own lanes, which never rode the wire."""
        if self.stacked:
            return local
        out = table.clone()
        out[self.rank:self.rank + self.n_local] = local
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(n_local homes, P, ...) → (n_local, ...): participant q receives
        the sum over every home of ``x[home, q]`` (the reference's
        ``psum_scatter``), in x's dtype.  Exact for the integer rows the
        verbs move, since at most one home serves a lane."""
        if self.stacked:
            return x.sum(0, dtype=x.dtype)
        from ..distributed import collectives as DC
        return DC.reduce_scatter(x, self.mesh, self.axis, dim=1)[:, 0]

    def bcast(self, value: torch.Tensor, owner) -> torch.Tensor:
        """Participant ``owner``'s value at every participant held here:
        (n_local, ...) → (n_local, ...).  ``owner`` is an int, or an
        (n_local,) tensor of each participant's view of the owner."""
        table = self.gather(value)
        if isinstance(owner, torch.Tensor):
            return table[owner.to(torch.int64)]
        return table[owner].expand((value.shape[0],) + tuple(table.shape[1:]))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """(n_local, ...) → (...): the elementwise max over every
        participant (the reference's ``pmax``), on the device."""
        if self.stacked:
            return x.max(0).values
        from ..distributed import collectives as DC
        return DC.pmax(x.max(0).values, self.mesh, self.axis)

    def world_any(self, *xs: torch.Tensor):
        """For each tensor of flags led by the participants held here,
        whether any flag of any participant holds (the reference's
        ``psum(x) > 0``), as an (n_local,) bool tensor on the device; the
        process form reduces all of them in one collective."""
        if self.stacked:
            out = tuple(x.any().expand(self.n_local) for x in xs)
        else:
            v = torch.stack([x.any() for x in xs]).to(torch.int32)
            from ..distributed import collectives as DC
            v = DC.pmax(v, self.mesh, self.axis) != 0
            out = tuple(v[i].expand(self.n_local) for i in range(len(xs)))
        return out if len(xs) > 1 else out[0]

    def lead_rows(self, *xs: torch.Tensor):
        """Every participant's rows of each integer or bool (n_local, ...)
        tensor, for a ledger row that the stacked binding files for all P
        participants at once: the tensors themselves stacked; in the process
        form gathered in one collective (every rank calls it) and returned
        on rank 0, None on the others, so that rank 0 files the cluster's
        row."""
        if self.stacked:
            return xs
        g = self.gather_many(*xs)
        return g if self.lead else None

    def any(self, flag) -> bool:
        """Whether ``flag`` holds anywhere in the cluster — the one
        world-uniform host read that may steer a loop or a branch."""
        flag = torch.as_tensor(flag).any()
        if self.stacked:
            return bool(flag)
        return bool(self.any_flags(flag)[0])

    def any_flags(self, *flags) -> List[bool]:
        """:meth:`any` of several flags in one collective."""
        v = torch.stack([torch.as_tensor(f, device=self.device).any()
                         for f in flags]).to(torch.int32)
        if not self.stacked:
            from ..distributed import collectives as DC
            v = DC.pmax(v, self.mesh, self.axis)
        return [bool(b) for b in v.tolist()]


def _stack(values: List[Any], device):
    first = values[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(leaves), device)
                             for leaves in zip(*values)))
    return torch.stack([torch.as_tensor(v, device=device) for v in values])


def state_block(state, p: int):
    """Participant ``p``'s block of a stacked channel state (any NamedTuple
    tree of tensors led by P): every leaf's rows ``p:p+1``, copied — what
    rank ``p`` of a process binding holds."""
    if isinstance(state, tuple):
        return type(state)(*(state_block(leaf, p) for leaf in state))
    return state[p:p + 1].clone()


def assemble_blocks(blocks: List[Any]):
    """The stacked state whose participant ``p``'s block is ``blocks[p]``:
    the inverse of :func:`state_block`, leaf by leaf."""
    first = blocks[0]
    if isinstance(first, tuple):
        return type(first)(*(assemble_blocks(list(leaves))
                             for leaves in zip(*blocks)))
    return torch.cat([b.to(first.device) for b in blocks], dim=0)


@dataclass
class RegionInfo:
    """Ledger entry for a declared network-memory region (Appendix A.2)."""

    name: str
    shape: tuple
    dtype: Any
    nbytes: int


class TrafficLedger:
    """Per-verb traffic accounting (DESIGN.md §2.3, §8, §11, §12, §14, §15):
    modeled wire bytes, modeled collective rounds, read-cache hits and
    lookups, lock-free-served windows, the bytes the remote-DMA kernels
    measure, and the per-channel counts of checksum failures (corrupt) and
    stale-epoch entries (fenced).

    A verb reports one (P,) tensor — each participant's bytes — which is
    summed on the device into the verb's running total; nothing is read to
    the host until a summary is asked for, so recording costs no host sync.
    ``calls`` counts P per verb call, as the reference's per-participant
    callbacks do.  Rounds are static per verb call and are kept as host
    floats.  The ledger is disabled by default; verbs check ``enabled``.

    ``lead=False`` (ranks other than 0 of a process binding) adds zero to
    the cluster-wide rows — rounds and lock-free-window counts — so that
    rank 0's rows are the cluster's, as the stacked ledger's are."""

    def __init__(self, lead: bool = True):
        self.enabled = False
        self.lead = bool(lead)
        self.reset()

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        self.counts: Dict[str, Dict[str, Any]] = {}
        self.round_counts: Dict[str, Dict[str, float]] = {}
        self.dma_counts: Dict[str, Dict[str, Any]] = {}
        self.cache_counts: Dict[str, Dict[str, Any]] = {}
        self.fastpath_counts: Dict[str, Dict[str, Any]] = {}
        self.corrupt_counts: Dict[str, Any] = {}
        self.fenced_counts: Dict[str, Any] = {}
        return self

    @staticmethod
    def _add(table, verb, per_participant):
        v = torch.as_tensor(per_participant)
        e = table.setdefault(verb, {"calls": 0, "bytes": 0.0})
        e["calls"] += int(v.numel())
        e["bytes"] = e["bytes"] + v.to(torch.float64).sum()

    def record(self, verb: str, wire_bytes):
        """Add modeled wire bytes, one entry per participant."""
        self._add(self.counts, verb, wire_bytes)

    def record_rounds(self, verb: str, rounds: float):
        """Add cluster-wide modeled collective rounds (§14)."""
        e = self.round_counts.setdefault(verb, {"rounds": 0.0})
        e["rounds"] += float(rounds) if self.lead else 0.0

    def record_dma(self, verb: str, nbytes):
        """Add the bytes the remote-DMA kernels measured, one (P,) counter
        per kernel call (§15)."""
        self._add(self.dma_counts, verb, nbytes)

    def record_cache(self, name: str, hits, lookups):
        """Add read-cache ``hits`` out of ``lookups`` (per-participant
        tensors, summed on the device) against channel ``name`` (§8)."""
        e = self.cache_counts.setdefault(name, {"hits": 0.0, "lookups": 0.0})
        for k, v in (("hits", hits), ("lookups", lookups)):
            e[k] = e[k] + torch.as_tensor(v).to(torch.float64).sum()

    def record_fastpath(self, name: str, fast, windows):
        """Add ``fast`` lock-free-served windows out of ``windows`` executed
        against channel ``name`` (§11): a fast window was classified
        commuting and served without its lock, tracker and ack rounds.  The
        classification is known on the host, so the counts are floats."""
        e = self.fastpath_counts.setdefault(
            name, {"fast_windows": 0.0, "windows": 0.0})
        if self.lead:
            e["fast_windows"] += float(fast)
            e["windows"] += float(windows)

    def record_corrupt(self, name: str, count):
        """Add checksum-validation failures (a per-participant tensor, summed
        on the device) against channel ``name``: a receive found a slot whose
        seq matched its cursor but whose checksum did not (§12)."""
        self.corrupt_counts[name] = self.corrupt_counts.get(name, 0.0) \
            + torch.as_tensor(count).to(torch.float64).sum()

    def record_fenced(self, name: str, count):
        """Add stale-epoch entries rejected by the failover fence (§12.1), a
        per-participant tensor, against channel ``name``."""
        self.fenced_counts[name] = self.fenced_counts.get(name, 0.0) \
            + torch.as_tensor(count).to(torch.float64).sum()

    @staticmethod
    def _read(table):
        return {k: {"calls": v["calls"], "bytes": float(v["bytes"])}
                for k, v in sorted(table.items())}

    def summary(self) -> Dict[str, Dict[str, float]]:
        return self._read(self.counts)

    def rounds_summary(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in sorted(self.round_counts.items())}

    def dma_summary(self) -> Dict[str, Dict[str, float]]:
        return self._read(self.dma_counts)

    def cache_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-channel read-tier counters with derived hit rates."""
        out = {}
        for k, v in sorted(self.cache_counts.items()):
            hits, lookups = float(v["hits"]), float(v["lookups"])
            out[k] = {"hits": hits, "lookups": lookups,
                      "hit_rate": hits / lookups if lookups else 0.0}
        return out

    def fastpath_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-channel lock-skipped-window counters with derived rates."""
        out = {}
        for k, v in sorted(self.fastpath_counts.items()):
            fast, windows = float(v["fast_windows"]), float(v["windows"])
            out[k] = {"fast_windows": fast, "windows": windows,
                      "fast_rate": fast / windows if windows else 0.0}
        return out

    def corrupt_summary(self) -> Dict[str, float]:
        """Per-channel checksum-validation-failure counts (§12)."""
        return {k: float(v) for k, v in sorted(self.corrupt_counts.items())}

    def fenced_summary(self) -> Dict[str, float]:
        """Per-channel stale-epoch fenced-entry counts (§12.1)."""
        return {k: float(v) for k, v in sorted(self.fenced_counts.items())}

    def total_bytes(self) -> float:
        return sum(e["bytes"] for e in self.summary().values())

    def total_rounds(self) -> float:
        return sum(e["rounds"] for e in self.round_counts.values())

    def total_dma_bytes(self) -> float:
        return sum(e["bytes"] for e in self.dma_summary().values())


class Manager:
    """LOCO manager: channel registry, memory ledger, traffic ledger and
    fence provider.

    ``backend`` selects the default execution protocol for every channel
    built under this manager (DESIGN.md §14): a name from
    :data:`repro_torch.core.backends.BACKENDS`, a backend instance, or
    ``None`` for the ``REPRO_DEFAULT_BACKEND`` environment default (falling
    back to the one-sided reference backend).

    Fences (paper §5.3): inside a :meth:`tracking` scope the channels'
    operations register their ack keys (:meth:`track`) and :meth:`fence`
    joins the ones its scope covers.  Outside a scope nothing is kept: the
    port runs in program order on one stream, so a fence orders nothing
    that is not ordered already, and an eager loop of operations would
    otherwise keep every token it produced alive."""

    def __init__(self, runtime: Runtime, backend=None):
        from .backends import get_backend  # local import: avoids a cycle
        self.runtime = runtime
        self.backend = get_backend(
            backend, default=os.environ.get("REPRO_DEFAULT_BACKEND"))
        self.channels: Dict[str, Any] = {}
        self.regions: Dict[str, RegionInfo] = {}
        self.traffic = TrafficLedger(lead=runtime.lead)
        # fence statistics per scope, as the reference's benchmarks report
        self.fence_counts = {s: 0 for s in FenceScope}
        self._outstanding = None     # a list inside a tracking() scope
        self._paused = False

    @property
    def P(self) -> int:
        return self.runtime.P

    @property
    def n_local(self) -> int:
        return self.runtime.n_local

    @property
    def device(self) -> torch.device:
        return self.runtime.device

    def register_channel(self, full_name: str, channel: Any):
        if full_name in self.channels:
            raise ValueError(f"channel name collision: {full_name!r} "
                             "(join would fail: duplicate endpoint)")
        self.channels[full_name] = channel

    def register_region(self, full_name: str, shape, dtype: torch.dtype):
        if full_name in self.regions:
            raise ValueError(f"memory region collision: {full_name!r}")
        nbytes = int(np.prod(shape)) * dtype.itemsize
        self.regions[full_name] = RegionInfo(full_name, tuple(shape), dtype,
                                             nbytes)
        return self.regions[full_name]

    def memory_ledger_bytes(self) -> int:
        """Total registered network memory per participant."""
        return sum(r.nbytes for r in self.regions.values())

    def traffic_ledger_bytes(self) -> float:
        return self.traffic.total_bytes()

    # -- outstanding-op tracking --------------------------------------------
    @contextlib.contextmanager
    def tracking(self):
        """Scope within which issued ack keys are tracked for fences;
        channel operations call :meth:`track`, ``fence`` drains."""
        prev, self._outstanding = self._outstanding, []
        try:
            yield self
        finally:
            self._outstanding = prev

    @contextlib.contextmanager
    def no_tracking(self):
        """Suspend tracking (the reference's loop bodies, whose tokens must
        not escape the loop)."""
        prev, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = prev

    def track(self, ack: AckKey) -> AckKey:
        """Register ``ack`` as outstanding inside a :meth:`tracking` scope;
        returns it."""
        if self._outstanding is not None and not self._paused:
            self._outstanding.append(ack)
        return ack

    def outstanding(self) -> AckKey:
        """The union of the tracked ack keys not yet fenced."""
        acc = AckKey.empty()
        for a in self._outstanding or ():
            acc = acc | a
        return acc

    def fence(self, *args, scope: FenceScope = FenceScope.GLOBAL,
              peer: int | None = None):
        """Order ``args`` after the outstanding operations ``scope`` covers
        and return them (one value if one argument).

        GLOBAL and THREAD join every outstanding operation and drain the
        list; PAIR joins the operations that target ``peer`` (or every
        peer) and leaves the others outstanding."""
        self.fence_counts[scope] += 1
        out_ack = self.outstanding()
        if scope != FenceScope.PAIR:
            if self._outstanding is not None:
                self._outstanding = []
            return join(out_ack, *args, scope=FenceScope.GLOBAL)
        kept = [(tok, d) for tok, d in zip(out_ack.tokens, out_ack.descs)
                if not (d.peers == ALL_PEERS
                        or (peer is not None and peer in d.peers))]
        if self._outstanding is not None:
            self._outstanding = [AckKey([t for t, _ in kept],
                                        [d for _, d in kept])]
        return join(out_ack, *args, peer=peer, scope=FenceScope.PAIR)

def make_manager(num_participants: int, device=None, backend=None,
                 mesh=None, axis: str = "nodes") -> Manager:
    """A manager for P participants: stacked on ``device`` (default: the
    card; raises when there is none), or one a rank of ``mesh``'s ``axis``
    (a :class:`~repro_torch.launch.mesh.ProcessMesh`; that axis must have P
    ranks, and every rank must call this at the same point)."""
    return Manager(Runtime(num_participants, device=device, mesh=mesh,
                           axis=axis),
                   backend=backend)


__all__ = ["Manager", "RegionInfo", "Runtime", "TrafficLedger",
           "assemble_blocks", "make_manager", "resolve_device",
           "state_block"]
