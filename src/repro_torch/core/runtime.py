"""Participant runtime and manager — LOCO's connection/resource manager
(paper §4.2), the counterpart of ``repro/core/runtime.py``.

The JAX package runs each channel method once per participant under
``jax.vmap(axis_name=...)`` and writes collectives over the axis name.  The
port writes the **stacked form** instead: every state and argument tensor
carries the leading participant dimension P, and a collective is a tensor
operation over that dimension — an all-gather is the (P, ...) tensor itself,
a psum is a sum over dim 0, ``axis_index`` is ``torch.arange(P)``.  On one
card the P participants share its memory, and the "wire hop" is a gather in
device memory.
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
    """The stacked binding of P participants on one ``device``: channel
    methods take and return stacked tensors, so they may be called directly
    where the reference wraps them in :meth:`run`."""

    def __init__(self, num_participants: int, device=None):
        self.P = int(num_participants)
        self.device = resolve_device(device)

    def run(self, fn: Callable, *args):
        """Execute ``fn`` for every participant at once: ``fn`` takes the
        stacked (P, ...) ``args`` and returns stacked outputs.  The
        reference's ``jax.vmap``/``shard_map`` over a per-participant
        program is the identity of the stacked form."""
        return fn(*args)

    def my_id(self) -> torch.Tensor:
        """(P,) participant ids — the stacked ``axis_index``."""
        return torch.arange(self.P, device=self.device)

    def stack(self, per_participant_values: List[Any]):
        """Stack P per-participant values (tensors, arrays, numbers, or
        NamedTuples of them) leaf by leaf into the runtime's (P, ...)
        layout on its device."""
        first = per_participant_values[0]
        if isinstance(first, tuple):
            return type(first)(*(self.stack(list(leaves))
                                 for leaves in zip(*per_participant_values)))
        return torch.stack([torch.as_tensor(v, device=self.device)
                            for v in per_participant_values])


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
    floats.  The ledger is disabled by default; verbs check ``enabled``."""

    def __init__(self):
        self.enabled = False
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
        e["rounds"] += float(rounds)

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
        self.traffic = TrafficLedger()
        # fence statistics per scope, as the reference's benchmarks report
        self.fence_counts = {s: 0 for s in FenceScope}
        self._outstanding = None     # a list inside a tracking() scope
        self._paused = False

    @property
    def P(self) -> int:
        return self.runtime.P

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

def make_manager(num_participants: int, device=None,
                 backend=None) -> Manager:
    """A manager for P participants stacked on ``device`` (default: the
    card; raises when there is none)."""
    return Manager(Runtime(num_participants, device=device),
                   backend=backend)


__all__ = ["Manager", "RegionInfo", "Runtime", "TrafficLedger",
           "make_manager", "resolve_device"]
