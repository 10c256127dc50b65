"""Swappable execution backends for the one-sided verb layer (DESIGN.md §14),
the counterpart of ``repro/core/backends.py``.

* ``onesided`` — the reference backend: the verbs of :mod:`.colls` with
  their coalescing read tier and locality discounts.  Reads cost 2 rounds
  and 2·|row| per unique remote row; writes 1 round and |row| per lane.
* ``active_message`` — RPC-style function shipping over the same execution:
  every enabled remote op pays an (:data:`AM_HDR_BYTES` + |row|) message,
  un-coalesced, over the same rounds.
* ``pallas`` — the remote-DMA lowering (DESIGN.md §15): the batched verbs
  run through the hand-written kernels of
  :mod:`repro_torch.kernels.remote_dma` (the name is the reference's; the
  kernels here are CUDA), and every kernel's measured bytes are filed in the
  ledger's measured tier beside the modeled rows: (:data:`DMA_DESC_BYTES` +
  |row|) per unique remote read and per remote write lane.

Execution is bitwise-identical across backends; only the modeled bytes and
rounds differ.  This slice ports the batched verbs, which is what the
KVStore window path uses; the scalar ``read``/``write`` verbs and the
ringbuffer publish hook wait for the channels that call them.
"""
from __future__ import annotations

import torch

from . import colls

#: Modeled bytes of one active-message op descriptor.
AM_HDR_BYTES = 16

#: Modeled bytes of one remote-DMA transfer descriptor; equal to
#: ``repro_torch.kernels.remote_dma.DESC_BYTES`` (a test pins the two).
DMA_DESC_BYTES = 32


class CollsBackend:
    """Protocol contract for the batched one-sided verbs: execution must be
    bitwise-identical across backends, only the modeled wire bytes and round
    counts may differ."""

    name = "abstract"
    #: rounds the placed-path slot-allocation round-trip costs (kvstore §10)
    alloc_rounds = 2.0

    def read_batch(self, local_buf, targets, indices, preds=None,
                   ledger=None, verb="remote_read_batch", coalesce=True):
        raise NotImplementedError

    def write_batch(self, local_buf, targets, indices, values, preds=None,
                    assume_unique=False, ledger=None,
                    verb="remote_write_batch"):
        raise NotImplementedError

    def row_read_bytes(self, row_nbytes: int) -> float:
        """Modeled wire bytes of one remote row read."""
        raise NotImplementedError


class OneSidedBackend(CollsBackend):
    """LOCO's one-sided verbs: delegates straight to :mod:`.colls`, whose
    verbs record their own byte model and rounds."""

    name = "onesided"
    alloc_rounds = 2.0

    def read_batch(self, local_buf, targets, indices, preds=None,
                   ledger=None, verb="remote_read_batch", coalesce=True):
        return colls.remote_read_batch(local_buf, targets, indices,
                                       preds=preds, ledger=ledger, verb=verb,
                                       coalesce=coalesce)

    def write_batch(self, local_buf, targets, indices, values, preds=None,
                    assume_unique=False, ledger=None,
                    verb="remote_write_batch"):
        return colls.remote_write_batch(local_buf, targets, indices, values,
                                        preds=preds,
                                        assume_unique=assume_unique,
                                        ledger=ledger, verb=verb)

    def row_read_bytes(self, row_nbytes: int) -> float:
        return 2.0 * row_nbytes


class ActiveMessageBackend(CollsBackend):
    """RPC-style function shipping over the same execution: the one-sided
    verb runs with no ledger, then this class records the active-message
    contract — (hdr + |row|) per enabled remote lane, no coalescing."""

    name = "active_message"
    alloc_rounds = 0.0

    def _record(self, ledger, verb, local_buf, targets, preds, rounds):
        me = colls.my_id(local_buf.shape[0], targets.device)[:, None]
        if preds is None:
            preds = torch.ones(targets.shape, dtype=torch.bool,
                               device=targets.device)
        remote = preds & (targets.to(torch.int32) != me)
        colls._record(ledger, verb,
                      float(AM_HDR_BYTES + colls._item_nbytes(local_buf))
                      * remote.sum(1).to(torch.float64))
        colls.record_rounds(ledger, verb, rounds)

    def read_batch(self, local_buf, targets, indices, preds=None,
                   ledger=None, verb="remote_read_batch", coalesce=True):
        out = colls.remote_read_batch(local_buf, targets, indices,
                                      preds=preds, ledger=None, verb=verb,
                                      coalesce=coalesce)
        self._record(ledger, verb, local_buf, targets, preds, 2.0)
        return out

    def write_batch(self, local_buf, targets, indices, values, preds=None,
                    assume_unique=False, ledger=None,
                    verb="remote_write_batch"):
        buf = colls.remote_write_batch(local_buf, targets, indices, values,
                                       preds=preds,
                                       assume_unique=assume_unique,
                                       ledger=None, verb=verb)
        self._record(ledger, verb, local_buf, targets, preds, 1.0)
        return buf

    def row_read_bytes(self, row_nbytes: int) -> float:
        return float(AM_HDR_BYTES + row_nbytes)


class _DmaEngine:
    """Measured-byte sink the DMA backend threads through the colls wire
    path: each remote-DMA kernel reports the (P,) bytes it moved and the
    engine files them under the verb in the ledger's measured tier (§15)."""

    __slots__ = ("ledger", "verb")

    def __init__(self, ledger, verb):
        self.ledger = ledger
        self.verb = verb

    def count(self, nbytes):
        colls.record_dma(self.ledger, self.verb, nbytes)


class PallasDmaBackend(CollsBackend):
    """One-sided verbs lowered onto the remote-DMA kernels (§15): descriptor
    build on the requester, row gather/scatter on the home, the hop between
    them a gather in device memory.  Values are bitwise those of the
    one-sided backend.  Cost model: (desc + |row|) per unique coalesced
    remote read and per remote write lane, over the one-sided rounds."""

    name = "pallas"
    alloc_rounds = 2.0

    @staticmethod
    def _cost_fn(n_lanes, row_nbytes):
        return float(DMA_DESC_BYTES + row_nbytes) * n_lanes

    def read_batch(self, local_buf, targets, indices, preds=None,
                   ledger=None, verb="remote_read_batch", coalesce=True):
        return colls.remote_read_batch(
            local_buf, targets, indices, preds=preds, ledger=ledger,
            verb=verb, coalesce=coalesce, engine=_DmaEngine(ledger, verb),
            cost_fn=self._cost_fn)

    def write_batch(self, local_buf, targets, indices, values, preds=None,
                    assume_unique=False, ledger=None,
                    verb="remote_write_batch"):
        # assume_unique is moot here: the scatter kernel commits in lane
        # order, which realizes last-writer-wins itself
        return colls.remote_write_batch(
            local_buf, targets, indices, values, preds=preds,
            assume_unique=assume_unique, ledger=ledger, verb=verb,
            engine=_DmaEngine(ledger, verb), cost_fn=self._cost_fn)

    def row_read_bytes(self, row_nbytes: int) -> float:
        return float(DMA_DESC_BYTES + row_nbytes)


#: Singleton registry — backends are stateless, one instance each.
BACKENDS = {
    "onesided": OneSidedBackend(),
    "active_message": ActiveMessageBackend(),
    "pallas": PallasDmaBackend(),
}


def get_backend(spec=None, default=None):
    """Resolve a backend knob: a name from :data:`BACKENDS`, an instance
    (passed through), or ``None`` → ``default`` (itself resolved; the final
    fallback is the one-sided reference backend)."""
    if spec is None:
        if default is None:
            return BACKENDS["onesided"]
        return get_backend(default)
    if isinstance(spec, CollsBackend):
        return spec
    try:
        return BACKENDS[spec]
    except KeyError:
        raise ValueError(
            f"unknown colls backend {spec!r}; available: "
            f"{sorted(BACKENDS)}") from None
