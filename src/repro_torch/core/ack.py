"""Completion tracking and fences — LOCO's memory-consistency mechanism
(paper §5.2-§5.3), the counterpart of ``repro/core/ack.py``.

``AckKey`` is the completion handle every channel operation returns: a list
of dependency tokens (the tensors an operation produced) plus static
:class:`OpDesc` descriptors.  In the JAX package a fence is an
``optimization_barrier`` over the tokens in scope, because XLA reorders
collectives freely.  Eager PyTorch runs every operation of the port in
program order on one stream, so an operation is complete for every later
one: :func:`join` is an ordering no-op that returns its arguments, and
:meth:`AckKey.query` is a constant True.  The handles and their descriptors
are kept so the channel code reads as in the reference, and so
:meth:`repro_torch.core.runtime.Manager.fence` can pick the operations a
scope covers.
"""
from __future__ import annotations

import enum
from typing import Any, NamedTuple, Sequence, Tuple

import torch


class FenceScope(enum.IntEnum):
    """Fence scopes, weakest to strongest (paper §5.3)."""

    PAIR = 0    # order ops targeting one given peer
    THREAD = 1  # order all ops issued by the calling participant
    GLOBAL = 2  # order all outstanding ops tracked by the manager


# Peer wildcard used by broadcast-style operations.
ALL_PEERS: Tuple = ("all",)


class OpDesc(NamedTuple):
    """Static descriptor of one issued remote operation.

    kind:    'write' | 'read' | 'atomic' | 'bcast' | 'barrier'
    channel: full channel name that issued the op (e.g. "kv/locks")
    peers:   tuple of target participant ids, or ALL_PEERS
    nbytes:  payload bytes moved per participant
    """

    kind: str
    channel: str
    peers: Tuple
    nbytes: int


class AckKey:
    """Completion handle for channel operations (paper §5.2); unioned with
    ``|`` so a composite operation builds its key from its components."""

    def __init__(self, tokens: Sequence[Any] = (),
                 descs: Sequence[OpDesc] = ()):
        self.tokens = list(tokens)
        self.descs = tuple(descs)

    def union(self, other: "AckKey") -> "AckKey":
        return AckKey(self.tokens + other.tokens, self.descs + other.descs)

    __or__ = union

    @staticmethod
    def empty() -> "AckKey":
        return AckKey()

    def query(self) -> torch.Tensor:
        """True once the tracked operations are complete: a 0-d bool on the
        device of the first tensor token (the CPU without one).  Every
        operation of the port is queued on one stream in program order, so
        any kernel that consumes this flag, or anything issued after this
        call, runs after the tracked operations; the flag is a constant and
        reading it asks nothing of the host."""
        return torch.ones((), dtype=torch.bool, device=_device_of(self.tokens))

    def wait(self) -> torch.Tensor:
        """Blocking wait: consuming the completion flag (:meth:`query`)."""
        return self.query()

    def tokens_for_peer(self, peer: int):
        """The tokens of the tracked operations that target ``peer`` (or
        every peer) — what a PAIR-scope fence orders."""
        return [tok for tok, d in zip(self.tokens, self.descs)
                if d.peers == ALL_PEERS or peer in d.peers]

    @property
    def nbytes(self) -> int:
        return sum(d.nbytes for d in self.descs)

    def __repr__(self):
        return f"AckKey({len(self.tokens)} ops, {self.nbytes}B)"


def _device_of(tokens):
    """The device of the first tensor among (nested tuples of) tokens."""
    for tok in tokens:
        if isinstance(tok, torch.Tensor):
            return tok.device
        if isinstance(tok, (tuple, list)):
            dev = _device_of(tok)
            if dev is not None:
                return dev
    return None


def make_ack(token: Any, kind: str, channel: str, peers: Tuple,
             nbytes: int) -> AckKey:
    """Build a single-op AckKey whose token is ``token``."""
    return AckKey([token], [OpDesc(kind, channel, peers, int(nbytes))])


def join(ack: AckKey, *args, peer: int | None = None,
         scope: FenceScope = FenceScope.GLOBAL):
    """Order ``args`` after the operations tracked by ``ack``: in program
    order already, so ``args`` come back unchanged (one value if one arg)."""
    return args[0] if len(args) == 1 else args
