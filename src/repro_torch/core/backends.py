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
rounds differ.  Every backend runs its scalar verbs (``read``/``write``,
one request per participant) as batches of one of its batched verbs, so on
``pallas`` every verb rides the kernels.
The ring publish has its ledger model (:meth:`CollsBackend.record_publish`)
and its wire hop (:meth:`CollsBackend.publish_hop`), which the ``pallas``
backend runs on the remote-copy kernel.
"""
from __future__ import annotations

import torch

from . import colls
from .u32 import from_words, to_words

#: Modeled bytes of one active-message op descriptor.
AM_HDR_BYTES = 16

#: Modeled bytes of one remote-DMA transfer descriptor; equal to
#: ``repro_torch.kernels.remote_dma.DESC_BYTES`` (a test pins the two).
DMA_DESC_BYTES = 32


class CollsBackend:
    """Protocol contract for the one-sided verbs: execution must be
    bitwise-identical across backends, only the modeled wire bytes and round
    counts may differ."""

    name = "abstract"
    #: rounds the placed-path slot-allocation round-trip costs (kvstore §10)
    alloc_rounds = 2.0

    def read(self, local_buf, target, index, pred=True, ledger=None,
             verb="remote_read"):
        """The scalar read: this backend's batched read with one uncoalesced
        lane per participant (on ``pallas`` it launches the descriptor and
        row-gather kernels on the card).  Returns (P, *item)."""
        return self.read_batch(
            local_buf, *colls.scalar_lanes(local_buf, target, index, pred),
            ledger=ledger, verb=verb, coalesce=False)[:, 0]

    def write(self, local_buf, target, index, value, pred=True, ledger=None,
              verb="remote_write"):
        """The scalar write: this backend's batched write with one lane per
        participant (on ``pallas`` it launches the descriptor and row-commit
        kernels on the card).  Returns the new buffer."""
        targets, indices, preds = colls.scalar_lanes(local_buf, target,
                                                     index, pred)
        return self.write_batch(local_buf, targets, indices,
                                colls.scalar_value(local_buf, value),
                                preds=preds, ledger=ledger, verb=verb)

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

    def record_publish(self, ledger, verb, slot_nbytes, n_moved):
        """Ledger model of a ringbuffer publish of ``n_moved`` (P,) slots."""
        raise NotImplementedError

    def publish_hop(self, values, owner):
        """The ring publish's wire hop: every participant receives the
        owner's copy of each (P, ...) tensor in ``values``; ``owner`` is the
        ring state's (P,) owner.  A view of the owner's row, as
        :func:`colls.bcast_from` realizes it."""
        return [colls.bcast_from(v, owner) for v in values]


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

    def record_publish(self, ledger, verb, slot_nbytes, n_moved):
        # the owner pushes each slot, consumers validate by counter
        # read-back: 2·|slot| per moved slot, one round
        colls._record(ledger, verb, 2.0 * slot_nbytes
                      * torch.as_tensor(n_moved).to(torch.float64))
        colls.record_rounds(ledger, verb, 1.0)


class ActiveMessageBackend(CollsBackend):
    """RPC-style function shipping over the same execution: the one-sided
    verb runs with no ledger, then this class records the active-message
    contract — (hdr + |row|) per enabled remote lane, no coalescing."""

    name = "active_message"
    alloc_rounds = 0.0

    def _record(self, ledger, verb, local_buf, targets, preds, rounds):
        """Record (hdr + |row|) per enabled remote lane of (P, R) lanes."""
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

    def record_publish(self, ledger, verb, slot_nbytes, n_moved):
        # one (hdr + slot) message per moved slot, no read-back, one round
        colls._record(ledger, verb, float(AM_HDR_BYTES + slot_nbytes)
                      * torch.as_tensor(n_moved).to(torch.float64))
        colls.record_rounds(ledger, verb, 1.0)


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

    def record_publish(self, ledger, verb, slot_nbytes, n_moved):
        # one descriptor + slot payload per moved slot, delivery confirmed by
        # the DMA completion (no counter read-back), one round
        colls._record(ledger, verb, float(DMA_DESC_BYTES + slot_nbytes)
                      * torch.as_tensor(n_moved).to(torch.float64))
        colls.record_rounds(ledger, verb, 1.0)

    def publish_hop(self, values, owner):
        """The hop on the remote-copy kernel: the values are packed bit for
        bit into one (P, n) int32 word buffer (n padded to a multiple of
        four) and copied from the owner's row into every other row in one
        launch; the owner keeps its own.  Values are bitwise those of the
        one-sided hop.  The kernel's measured bytes are not filed: the
        reference's emulated broadcast files no measured row for a publish
        either."""
        words = [to_words(v) for v in values]
        n = sum(w.shape[1] for w in words)
        # rows of whole 16-byte units take the kernel's vector path
        words.append(words[0].new_zeros((words[0].shape[0], -n % 4)))
        words = torch.cat(words, dim=1)
        # the map in the owner's dtype (int32): the kernel takes it as is
        me = torch.arange(owner.shape[0], dtype=owner.dtype,
                          device=owner.device)
        sender = torch.where(owner == me, -1, owner)
        out, _sent, _recv = colls._dma().remote_copy(words, words, sender)
        res, off = [], 0
        for v in values:
            k = v[0].numel()
            res.append(from_words(out[:, off:off + k], v))
            off += k
        return res


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
