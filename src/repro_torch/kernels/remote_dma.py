"""Remote-DMA kernels of the colls verb layer (DESIGN.md §15), for Hopper.

The counterpart of ``repro/kernels/remote_dma.py``.  A requester builds
fixed-width transfer *descriptors* (the NIC work-queue-entry analogue), the
home serves or commits the described rows, and every kernel **counts the
bytes it moves** from the same masks that drive its copies.

Every function but :func:`remote_copy_peers` works on the port's stacked
tensors: a leading participant dimension P, so one launch covers all P
requesters or homes.  On a CUDA tensor a wrapper launches its hand-written
kernel from ``csrc/remote_dma.cu`` (built with ``nvcc`` for ``sm_90a`` at
first use) or raises; on a CPU tensor it runs the kernel's plain PyTorch
version below, which the CPU tests hold against the JAX package.  Each wrapper counts its
kernel launches in ``<wrapper>.launches``.

:func:`remote_copy` is the ring broadcast's wire hop, the counterpart of the
TPU-only ``remote_copy_tpu``, on the stacked binding; its kernel lives in
``csrc/remote_copy.cu``.  :func:`remote_copy_peers` is the same hop between
processes, one participant a rank, through exchange windows mapped by CUDA
IPC (:class:`PeerWindows`); its kernel lives in
``csrc/remote_copy_peers.cu``.

Descriptor layout (8 × int32 = :data:`DESC_BYTES` bytes)::

    word 0  op        1 = read, 2 = write
    word 1  target    home participant id
    word 2  index     row within the home's buffer
    word 3  enabled   lane rides the wire iff != 0
    word 4  length    row payload bytes
    word 5  seq       lane sequence number (application order)
    word 6-7          reserved (zero)
"""
from __future__ import annotations

import ctypes

import torch

from . import _nvcc

#: int32 words per transfer descriptor.
DESC_WORDS = 8
#: Bytes of one remote-DMA descriptor on the wire.
DESC_BYTES = DESC_WORDS * 4

OP_READ = 1
OP_WRITE = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "rdma_build_descriptors": [_P] * 5 + [_I] * 4 + [_P],
    "rdma_gather_rows": [_P, _P, _L, _P, _P, _I, _L] + [_I] * 3 + [_P],
    "rdma_scatter_rows": [_P, _P, _L] + [_P] * 4 + [_I, _L] + [_I] * 3
    + [_P],
}
_LIB = _nvcc.Library("remote_dma", _SIGNATURES, "rdma_error_string")
_COPY_LIB = _nvcc.Library(
    "remote_copy",
    {"remote_copy": [_P] * 3 + [_I] + [_P] * 3
     + [_I, ctypes.c_longlong, _I, _I, _P]},
    "remote_copy_error_string")
_PEERS_LIB = _nvcc.Library(
    "remote_copy_peers",
    {"remote_copy_peers": [_P, _L, _P, _P, _I, _P, _P, _P, _I, _I, _L, _I,
                           _I, _P],
     "rcp_window_alloc": [_L, ctypes.POINTER(_P), _P],
     "rcp_window_free": [_P],
     "rcp_window_open": [_P, ctypes.POINTER(_P)],
     "rcp_window_close": [_P],
     "rcp_stage": [_P, _P, _L, _P]},
    "remote_copy_peers_error_string")


def _on_card(*tensors) -> bool:
    return _nvcc.on_card("the remote-DMA kernels", *tensors)


def _words(x):
    """The int32 bit pattern of a 4-byte tensor (the kernels move words)."""
    if x.element_size() != 4:
        raise TypeError(f"the CUDA kernels move 4-byte words, got {x.dtype}")
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.contiguous().view(torch.int32)


def _i32(x):
    return x.to(torch.int32).contiguous()


def _mask(x):
    """A lane mask as the kernels read it: contiguous bool, one byte a lane
    (a lane is on iff != 0).  The verbs pass bool masks, taken as they are;
    any other dtype is converted."""
    if x.dtype != torch.bool:
        x = x != 0
    return x.contiguous()


# ---------------------------------------------------------------------------
# descriptor build (requester side)
# ---------------------------------------------------------------------------

def _build_desc_ref(targets, indices, en, wire, op, row_nbytes):
    P, R = targets.shape
    desc = torch.zeros((P, R, DESC_WORDS), dtype=torch.int32,
                       device=targets.device)
    desc[..., 0] = op
    desc[..., 1] = targets
    desc[..., 2] = indices
    desc[..., 3] = (en != 0).to(torch.int32)
    desc[..., 4] = row_nbytes
    desc[..., 5] = torch.arange(R, dtype=torch.int32, device=targets.device)
    nb = (wire != 0).sum(1, dtype=torch.int32) * DESC_BYTES
    return desc, nb


def build_descriptors(targets, indices, en, *, wire=None, op=OP_READ,
                      row_nbytes=0):
    """(P, R) request lanes → ((P, R, :data:`DESC_WORDS`) int32 descriptors,
    (P,) int32 measured descriptor bytes: :data:`DESC_BYTES` per ``wire``
    lane; ``wire`` defaults to ``en``).  ``en`` and ``wire`` are masks (a
    lane is on iff != 0), bool ones taken as they are.  On the card, with
    int32 targets and indices and bool masks as the verbs pass them, the
    descriptors and the counter are views of one allocation, written by one
    kernel launch and no other device operation.

    Replaces the Pallas kernel ``build_descriptors`` of
    ``repro/kernels/remote_dma.py``.  Bound by device-memory bytes
    (~48 B per lane), so in practice by the host's launch work."""
    targets, indices, en = _i32(targets), _i32(indices), _mask(en)
    wire = en if wire is None else _mask(wire)
    args = (targets, indices, en, wire)
    if targets.dim() != 2 or any(t.shape != targets.shape for t in args):
        raise ValueError(f"targets, indices, en and wire must be (P, R), "
                         f"got {[tuple(t.shape) for t in args]}")
    if not _on_card(*args):
        return _build_desc_ref(targets, indices, en, wire, int(op),
                               int(row_nbytes))
    P, R = targets.shape
    n = P * R * DESC_WORDS
    # descriptors first, so that they keep the allocation's 16-byte alignment
    buf = torch.empty(n + P, dtype=torch.int32, device=targets.device)
    _LIB.call("rdma_build_descriptors",
              targets.data_ptr(), indices.data_ptr(), en.data_ptr(),
              wire.data_ptr(), buf.data_ptr(), P, R, int(op),
              int(row_nbytes), _nvcc.stream(targets))
    build_descriptors.launches += 1
    return (buf.as_strided((P, R, DESC_WORDS),
                           (R * DESC_WORDS, DESC_WORDS, 1)),
            buf.as_strided((P,), (1,), n))


build_descriptors.launches = 0


# ---------------------------------------------------------------------------
# row serve (home side, reads)
# ---------------------------------------------------------------------------

def _gather_ref(buf, indices, mask, row_nbytes):
    homes = torch.arange(buf.shape[0], device=buf.device)[:, None]
    m = mask != 0
    rows = torch.where(m[..., None], buf[homes, indices.long()],
                       torch.zeros((), dtype=buf.dtype, device=buf.device))
    return rows, m.sum(1, dtype=torch.int32) * row_nbytes


def _row_index(indices, N):
    """(P, N) row indices as the gather kernel reads them: int32 with unit
    column stride and a row stride of 0 (one (N,) vector for every home,
    as ``expand`` gives it) or N (contiguous), taken as they are; any
    other dtype or layout is converted.  Returns (indices, row stride)."""
    if indices.dtype != torch.int32:
        indices = indices.to(torch.int32)
    st = indices.stride()
    if (st[1] == 1 or N <= 1) and st[0] in (0, N):
        return indices, st[0]
    return indices.contiguous(), N


def gather_rows(buf, indices, mask):
    """Serve N described rows at every home: lane i of home p receives
    ``buf[p, indices[p, i]]`` iff ``mask[p, i]`` (zeros otherwise), plus the
    (P,) int32 measured payload bytes — one row width per served lane.
    ``buf``: (P, slots, width); ``indices`` (P, N), pre-clipped to range,
    int32 taken as it is when contiguous or a stride-0 broadcast of one
    (N,) vector (``idx[None, :].expand(P, -1)``, as the read verb passes
    it); ``mask`` (P, N), bool taken as it is.  On the card, on those
    forms, the rows and the counter are views of one allocation, written by
    one kernel launch and no other device operation.

    Replaces the Pallas kernel ``gather_rows`` of
    ``repro/kernels/remote_dma.py``.  Bound by device-memory bytes (the
    (P, N, width) output dominates), so in practice by the host's launch
    work."""
    P, slots, width = buf.shape
    if indices.dim() != 2 or indices.shape[0] != P \
            or mask.shape != indices.shape:
        raise ValueError(f"indices and mask must be ({P}, N), got "
                         f"{tuple(indices.shape)} and {tuple(mask.shape)}")
    N = indices.shape[1]
    row_nbytes = width * buf.element_size()
    indices, idx_stride = _row_index(indices, N)
    mask = _mask(mask)
    if not _on_card(buf, indices, mask):
        return _gather_ref(buf, indices, mask, row_nbytes)
    words = _words(buf)
    n = P * N * width
    out = torch.empty(n + P, dtype=torch.int32, device=buf.device)
    _LIB.call("rdma_gather_rows",
              words.data_ptr(), indices.data_ptr(), idx_stride,
              mask.data_ptr(), out.data_ptr(), P, slots, N, width,
              row_nbytes, _nvcc.stream(buf))
    gather_rows.launches += 1
    rows = out.as_strided((P, N, width), (N * width, width, 1))
    return (rows if buf.dtype == torch.int32 else rows.view(buf.dtype),
            out.as_strided((P,), (1,), n))


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# row commit (home side, writes)
# ---------------------------------------------------------------------------

def _scatter_ref(buf, indices, values, apply_mask, wire_mask, row_nbytes):
    P, slots = buf.shape[:2]
    n = indices.shape[1]
    # an index in [-slots, 0) wraps to the end of the buffer and any other
    # index outside [0, slots) is dropped, as the reference's
    # ``.at[row].set(mode="drop")`` does
    rows = indices.long()
    rows = torch.where(rows < 0, rows + slots, rows)
    # sequential in-order application == last-writer-wins, computed as a
    # winner mask on the wrapped rows so one scatter commits the survivors
    win = (apply_mask != 0) & (rows >= 0) & (rows < slots)
    order = torch.arange(n, device=buf.device)
    later_same = (rows[:, None, :] == rows[:, :, None]) \
        & win[:, None, :] & (order[None, :] > order[:, None])[None]
    win = win & ~later_same.any(2)
    out = buf.clone()
    homes = torch.arange(P, device=buf.device)[:, None].expand(P, n)
    out[homes[win], rows[win]] = values[win]
    return out, (wire_mask != 0).sum(1, dtype=torch.int32) * row_nbytes


def scatter_rows(buf, indices, values, apply_mask, wire_mask):
    """Commit N described rows into every home's buffer **in lane order**:
    lane i of home p stores ``values[p, i]`` at ``indices[p, i]`` iff
    ``apply_mask[p, i]``, and among lanes on one row the last one wins.
    Measured payload bytes count ``wire_mask`` lanes.  ``buf``
    (P, slots, width) is not modified; returns (new buf, (P,) int32 bytes).
    ``indices`` (P, N): int32 taken as it is when contiguous or a stride-0
    broadcast of one (N,) vector (``idx[None, :].expand(P, -1)``, as the
    write verb passes it); the masks (P, N), bool taken as they are;
    ``values`` (P, N, width) of buf's dtype.  On the card, on those forms,
    the new buffer and the counter are views of one allocation, written by
    one kernel launch and no other device operation.  Both versions wrap an
    index in [-slots, 0) to the end of the buffer and commit no lane whose
    index lies outside [-slots, slots), as the reference's oracle does; the
    last lane wins among lanes on one wrapped row.

    Replaces the Pallas kernel ``scatter_rows`` of
    ``repro/kernels/remote_dma.py``, whose sequential loop made the last
    lane win.  GPU threads commit in no order, so each block elects the
    last applied lane of each row in its stripe of the buffer (a shared
    atomic max of the lane id), then copies the stripe with the elected
    rows taken from ``values``.  Bound by device-memory bytes: one read and
    one write of the home buffer, which the functional contract forces."""
    P, slots, width = buf.shape
    if indices.dim() != 2 or indices.shape[0] != P \
            or apply_mask.shape != indices.shape \
            or wire_mask.shape != indices.shape:
        raise ValueError(f"indices and masks must be ({P}, N), got "
                         f"{tuple(indices.shape)}, {tuple(apply_mask.shape)} "
                         f"and {tuple(wire_mask.shape)}")
    N = indices.shape[1]
    row_nbytes = width * buf.element_size()
    indices, idx_stride = _row_index(indices, N)
    apply_mask, wire_mask = _mask(apply_mask), _mask(wire_mask)
    if not _on_card(buf, indices, values, apply_mask, wire_mask):
        return _scatter_ref(buf, indices, values, apply_mask, wire_mask,
                            row_nbytes)
    if values.dtype != buf.dtype or values.shape != (P, N, width):
        raise ValueError(f"values must be {buf.dtype} of shape "
                         f"{(P, N, width)}, got {values.dtype} "
                         f"{tuple(values.shape)}")
    words, vals = _words(buf), _words(values)
    n = P * slots * width
    # the new buffer first, so that it keeps the allocation's alignment
    out = torch.empty(n + P, dtype=torch.int32, device=buf.device)
    _LIB.call("rdma_scatter_rows",
              words.data_ptr(), indices.data_ptr(), idx_stride,
              apply_mask.data_ptr(), wire_mask.data_ptr(), vals.data_ptr(),
              out.data_ptr(), P, slots, N, width, row_nbytes,
              _nvcc.stream(buf))
    scatter_rows.launches += 1
    new = out.as_strided((P, slots, width), (slots * width, width, 1))
    return (new if buf.dtype == torch.int32 else new.view(buf.dtype),
            out.as_strided((P,), (1,), n))


scatter_rows.launches = 0

# ---------------------------------------------------------------------------
# the wire hop between participants (the ring broadcast)
# ---------------------------------------------------------------------------

def _remote_copy_ref(src, dst, sender):
    P, n = src.shape
    me = torch.arange(P, device=src.device)
    s = sender.to(torch.int64)
    peer = (s >= 0) & (s < P) & (s != me)
    out = torch.where(peer[:, None], src[s.clamp(0, P - 1)], dst)
    row_nbytes = n * src.element_size()
    recv = peer.to(torch.int32) * row_nbytes
    sent = ((s[None, :] == me[:, None]) & peer[None, :]).sum(
        1, dtype=torch.int32) * row_nbytes
    return out, sent, recv


def _check_counter_range(P: int, row_nbytes: int) -> None:
    """Refuse a hop whose int32 byte counters could wrap.  A sender adds
    one row for each of its receivers, at most P - 1 of them, so its
    ``sent`` count reaches (P - 1)·row_nbytes; a receiver's ``recv`` is one
    row, which that bounds for any P > 1 (and which the kernel takes as an
    int, so P = 1 is held to one row).  The counters stay int32, as the
    reference's ``s32`` semaphores are."""
    if max(P - 1, 1) * row_nbytes >= 2 ** 31:
        raise ValueError(f"remote_copy: {P - 1} rows of {row_nbytes} bytes "
                         f"overflow the int32 byte counters")


def remote_copy(src, dst, sender):
    """The wire hop of the stacked binding: receiver ``q`` takes row
    ``sender[q]`` of ``src``; a sender of -1, ``q`` itself or any value
    outside [0, P) means ``q`` receives nothing and keeps ``dst[q]``.
    ``src`` and ``dst`` are (P, n) buffers of one 4-byte dtype, ``sender`` a
    (P,) int (int32 and int64 are taken as they are; other integer types
    are widened to int64).  Returns (out, sent_bytes (P,) int32, recv_bytes
    (P,) int32): the byte counts stand in for the DMA send and recv
    semaphores — a row's bytes at its receiver and at its sender, counted
    from the same map that drives the copy.  On the card the three are
    views of one allocation, written by one kernel launch and no other
    device operation.  A broadcast from participant ``o`` is ``sender = o``
    everywhere but at ``o``.

    Replaces the TPU kernel ``remote_copy_tpu`` of
    ``repro/kernels/remote_dma.py``, a remote-DMA send/wait pair to a peer
    chip.  Here the P participants share one card, so the copy runs between
    their slices of device memory.  Bound by device-memory bytes."""
    if src.shape != dst.shape or src.dim() != 2 or src.dtype != dst.dtype:
        raise ValueError(f"src and dst must be (P, n) of one dtype, got "
                         f"{src.dtype} {tuple(src.shape)} and {dst.dtype} "
                         f"{tuple(dst.shape)}")
    P, n = src.shape
    if sender.dim() != 1:
        sender = sender.reshape(-1)
    if sender.dtype not in (torch.int32, torch.int64):
        sender = sender.to(torch.int64)
    if sender.shape[0] != P:
        raise ValueError(f"sender must be ({P},), got {tuple(sender.shape)}")
    row_nbytes = n * src.element_size()
    _check_counter_range(P, row_nbytes)
    if not _on_card(src, dst, sender):
        return _remote_copy_ref(src, dst, sender)
    # the hop is launch-bound: the host work here is kept to one
    # allocation, pointer arithmetic and three views
    a, b = _words(src), _words(dst)
    if not sender.is_contiguous():
        sender = sender.contiguous()
    # out first, so that it keeps the allocation's 16-byte alignment
    buf = torch.empty(P * n + 2 * P, dtype=torch.int32, device=src.device)
    out_p = buf.data_ptr()
    vec = int(n % 4 == 0 and (a.data_ptr() | b.data_ptr() | out_p) % 16 == 0)
    _COPY_LIB.call("remote_copy", a.data_ptr(), b.data_ptr(),
                   sender.data_ptr(), int(sender.dtype == torch.int64),
                   out_p, out_p + 4 * P * n, out_p + 4 * (P * n + P), P, n,
                   row_nbytes, vec, _nvcc.stream(src))
    remote_copy.launches += 1
    out = buf.as_strided((P, n), (n, 1))
    return (out if src.dtype == torch.int32 else out.view(src.dtype),
            buf.as_strided((P,), (1,), P * n),
            buf.as_strided((P,), (1,), P * n + P))


remote_copy.launches = 0


# ---------------------------------------------------------------------------
# the wire hop between processes (the ring broadcast, one participant a rank)
# ---------------------------------------------------------------------------

#: Bytes of a ``cudaIpcMemHandle_t``.
IPC_HANDLE_BYTES = 64


class PeerWindows:
    """A rank's two exchange windows of the ring hop's packed word row,
    mapped into every peer by CUDA IPC, for :func:`remote_copy_peers`.

    ``rt`` is the process runtime of the ring (its ``rank``, ``P``,
    ``device`` and the all-gather ``rt.gather``).  Nothing is allocated
    until the first hop on the card; a hop wider than the windows replaces
    them.  Each allocation is one ``cudaMalloc`` made by the extension
    (never a piece of PyTorch's caching allocator, whose blocks share a
    segment), exported with ``cudaIpcGetMemHandle``; the P handles are
    all-gathered as bytes over the ring's group, each rank opens its P - 1
    peers' with ``cudaIpcOpenMemHandle`` and keeps the P base addresses in a
    device table.  Every rank must make each call at the same point (the
    runtime's collectives are the ranks' rendezvous): the ring's hops are
    SPMD, so the windows grow at the same hop everywhere.  :meth:`close`
    releases them."""

    def __init__(self, rt):
        self.rt = rt
        self.words = 0          # capacity of one window, in int32 words
        self.hops = 0           # hops run: hop k writes window k % 2
        self._own = None        # this rank's allocation
        self._peers = []        # the peers' mapped allocations
        self.bases = None       # (P,) int64 window addresses on the device

    def _call(self, fn, *args, what):
        code = getattr(_PEERS_LIB._handle(), fn)(*args)
        if code != 0:
            msg = getattr(_PEERS_LIB._handle(), _PEERS_LIB.error_fn)(code)
            raise RuntimeError(f"remote_copy_peers: {what} failed on rank "
                               f"{self.rt.rank}: {msg.decode()} ({code})")

    def ensure(self, n: int) -> None:
        """Windows of at least ``n`` words each (a collective when they
        grow)."""
        if n <= self.words and self.bases is not None:
            return
        self.close()
        words = max(4, -(-n // 4) * 4)         # whole 16-byte units
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(
            IPC_HANDLE_BYTES)
        self._call("rcp_window_alloc", 2 * words * 4, ctypes.byref(ptr),
                   handle, what="cudaMalloc / cudaIpcGetMemHandle")
        self._own = ptr.value
        mine = torch.frombuffer(bytearray(handle.raw), dtype=torch.uint8)
        handles = self.rt.gather(mine[None].to(self.rt.device)).cpu()
        bases = []
        for r in range(self.rt.P):
            if r == self.rt.rank:
                bases.append(self._own)
                continue
            peer = ctypes.c_void_p()
            raw = ctypes.create_string_buffer(bytes(handles[r].tolist()),
                                              IPC_HANDLE_BYTES)
            self._call("rcp_window_open", raw, ctypes.byref(peer),
                       what=f"cudaIpcOpenMemHandle of rank {r}'s window")
            self._peers.append(peer.value)
            bases.append(peer.value)
        self.bases = torch.tensor(bases, dtype=torch.int64,
                                  device=self.rt.device)
        self.words = words

    def close(self) -> None:
        """Unmap the peers' windows, wait until every peer has unmapped
        this rank's (one all-gather), then free them; every rank calls it at
        the same point.  A no-op before the first hop on the card."""
        if self.bases is None:
            return
        torch.cuda.synchronize(self.rt.device)  # no pull still reads
        for peer in self._peers:
            self._call("rcp_window_close", peer,
                       what="cudaIpcCloseMemHandle")
        self.rt.gather(torch.zeros((1, 1), dtype=torch.int32,
                                   device=self.rt.device))
        self._call("rcp_window_free", self._own, what="cudaFree")
        self._own, self._peers, self.bases, self.words = None, [], None, 0


def _remote_copy_peers_ref(words, sender, rt):
    """The plain version: :meth:`Runtime.bcast` as a gather and a select —
    the rows and the map gathered in one collective, through
    :func:`_remote_copy_ref`, this rank's row of each result."""
    table, smap = rt.gather_many(words, sender)
    out, sent, recv = _remote_copy_ref(table, table, smap)
    return rt.mine(out), rt.mine(sent), rt.mine(recv)


def remote_copy_peers(words, sender, windows):
    """The wire hop between processes: this rank (one participant, global id
    ``windows.rt.rank``) receives the packed row of rank ``sender[0]``; a
    sender of -1, itself or any value outside [0, P) means it receives
    nothing and keeps its own row.  ``words`` (1, n) int32 is this rank's
    packed row, ``sender`` (1,) int32 or int64 its view of its sender.
    Returns (out (1, n) int32, sent_bytes (1,) int32, recv_bytes (1,)
    int32), the byte counts counted from the gathered sender map as
    :func:`remote_copy` counts them.  The values are bitwise
    ``Runtime.bcast`` of the packed rows.

    On the card, one hop k is: this rank's row written into its window
    k % 2 on the current stream; one all-gather of the (1,) sender views,
    which gives the whole map and is the fence; one launch of
    ``remote_copy_peers_kernel``, which pulls window k % 2 of the sender's
    process.  **Why no rank reads a row before its owner has written it:**
    the owner's write is enqueued on its stream before its part of the
    all-gather, and the all-gather completes at a reader only after every
    rank's part was sent.  Over gloo a card tensor's part is copied to the
    host after the stream's earlier work (a blocking copy when the
    transport is "host"; gloo's own stream waits on the current one when it
    is "native"), so the write has finished before the part leaves; NCCL
    runs the all-gather on the stream, after the write, and its peers'
    kernels finish only once the parts arrived.  The reader's pull is
    enqueued after the all-gather returned (its result reaches the device
    before the pull, on the stream).  **Why two windows and one fence a hop
    suffice:** an owner writes window k % 2 again only at hop k + 2, which
    it issues after returning from the all-gather of hop k + 1; every peer
    joined that all-gather after enqueueing its pull of hop k, and its part
    leaves only after that pull finished (the same stream order as above),
    so no pull of hop k reads a window that hop k + 2 overwrites.

    Replaces the TPU kernel ``remote_copy_tpu`` of
    ``repro/kernels/remote_dma.py``, a remote-DMA send/wait pair to a peer
    chip.  On CPU tensors the plain version (:meth:`Runtime.bcast` of the
    rows, a gather and a select) runs; on the card a failed map or launch
    raises with the CUDA error and never gives way to the gather."""
    rt = windows.rt
    if words.dim() != 2 or words.shape[0] != 1 or words.dtype != torch.int32:
        raise ValueError(f"words must be (1, n) int32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    sender = sender.reshape(-1)
    if sender.dtype not in (torch.int32, torch.int64):
        sender = sender.to(torch.int64)
    if sender.shape[0] != 1:
        raise ValueError(f"sender must be (1,), got {tuple(sender.shape)}")
    P, n = rt.P, words.shape[1]
    row_nbytes = 4 * n
    _check_counter_range(P, row_nbytes)
    if not _nvcc.on_card("the remote-DMA kernels", words, sender):
        return _remote_copy_peers_ref(words, sender, rt)
    words = words.contiguous()
    windows.ensure(n)
    offset = (windows.hops % 2) * windows.words
    windows.hops += 1
    stream = _nvcc.stream(words)
    windows._call("rcp_stage", windows._own + 4 * offset, words.data_ptr(),
                  row_nbytes, stream, what="the row's write into its window")
    smap = rt.gather(sender)                       # the map, and the fence
    buf = torch.empty(n + 2, dtype=torch.int32, device=words.device)
    out_p = buf.data_ptr()
    vec = int(n % 4 == 0 and (words.data_ptr() | out_p) % 16 == 0)
    _PEERS_LIB.call("remote_copy_peers", windows.bases.data_ptr(), offset,
                    words.data_ptr(), smap.data_ptr(),
                    int(smap.dtype == torch.int64), out_p, out_p + 4 * n,
                    out_p + 4 * (n + 1), P, rt.rank, n, row_nbytes, vec,
                    stream)
    remote_copy_peers.launches += 1
    return (buf.as_strided((1, n), (n, 1)), buf.as_strided((1,), (1,), n),
            buf.as_strided((1,), (1,), n + 1))


remote_copy_peers.launches = 0

#: The kernels of the KVStore window path (the ring hop is :func:`remote_copy`).
KERNELS = (build_descriptors, gather_rows, scatter_rows)
