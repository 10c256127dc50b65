"""LOCO core, ported to PyTorch: the channel-object model on one card.

Public surface so far — the KVStore window path (with its read tier,
placement policies, lock-free fast path and locality migration), the shared
queue, the replication tier (ring, log, failure detector) and what they are
built from:

* runtime/binding: :class:`Runtime`, :class:`Manager`, :func:`make_manager`
* consistency:     :class:`AckKey`, :class:`FenceScope`, :func:`join`
* channels:        :class:`SharedRegion`, :class:`OwnedVar`,
                   :class:`AtomicVar`, :class:`SST`,
                   :class:`TicketLockArray`, :class:`KVStore`,
                   :class:`ReadCache`, :class:`HotTracker`,
                   :class:`SharedQueue`,
                   :class:`Ringbuffer`, :class:`ReplicatedLog`,
                   :class:`FailureDetector`
* backends:        :class:`CollsBackend`, :class:`OneSidedBackend`,
                   :class:`ActiveMessageBackend`,
                   :class:`PallasDmaBackend`, :func:`get_backend`
* state exchange:  :func:`state_from_numpy`, :func:`state_to_numpy`
"""
from .ack import ALL_PEERS, AckKey, FenceScope, OpDesc, join, make_ack
from .atomic import AtomicVar, AtomicVarState
from .backends import (AM_HDR_BYTES, BACKENDS, DMA_DESC_BYTES,
                       ActiveMessageBackend, CollsBackend, OneSidedBackend,
                       PallasDmaBackend, get_backend)
from .cache import ReadCache, ReadCacheState, hash_u32
from .channel import Channel
from .detector import FailureDetector, FailureDetectorState
from .hottracker import HotTracker, HotTrackerState
from .kvstore import (DELETE, GET, INSERT, MOVE, NOP, PLACEMENTS, UPDATE,
                      KVResult, KVStore, KVStoreState, state_from_numpy,
                      state_to_numpy)
from .lock import (NO_TICKET, TicketLockArray, TicketLockArrayState,
                   window_fifo_ranks)
from .ownedvar import OwnedVar, OwnedVarState, checksum
from .queue import SharedQueue, SharedQueueState, queue_state_to_numpy
from .region import SharedRegion, SharedRegionState
from .replog import (MAX_EPOCHS, RETRY_STAGES, RejoinState, ReplicatedLog,
                     ReplicatedLogState, diverging_leaves)
from .ringbuffer import Ringbuffer, RingbufferState
from .runtime import Manager, Runtime, TrafficLedger, make_manager
from .sst import SST, SSTState

__all__ = [
    "ALL_PEERS", "AckKey", "FenceScope", "OpDesc", "join", "make_ack",
    "AM_HDR_BYTES", "BACKENDS", "DMA_DESC_BYTES", "ActiveMessageBackend",
    "CollsBackend", "OneSidedBackend", "PallasDmaBackend", "get_backend",
    "AtomicVar", "AtomicVarState", "Channel",
    "NOP", "GET", "INSERT", "UPDATE", "DELETE", "MOVE", "PLACEMENTS",
    "HotTracker", "HotTrackerState", "KVResult", "KVStore", "KVStoreState",
    "state_from_numpy", "state_to_numpy", "NO_TICKET", "TicketLockArray",
    "TicketLockArrayState", "window_fifo_ranks", "OwnedVar",
    "OwnedVarState", "checksum", "hash_u32", "ReadCache", "ReadCacheState",
    "SharedQueue", "SharedQueueState", "queue_state_to_numpy",
    "SharedRegion", "SharedRegionState", "Manager", "Runtime",
    "TrafficLedger", "make_manager", "SST", "SSTState",
    "FailureDetector", "FailureDetectorState", "MAX_EPOCHS", "RETRY_STAGES",
    "RejoinState", "ReplicatedLog", "ReplicatedLogState", "diverging_leaves",
    "Ringbuffer", "RingbufferState",
]
