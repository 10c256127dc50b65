"""Collective building blocks for channel implementations — LOCO's one-sided
verbs (DESIGN.md §2), the counterpart of ``repro/core/colls.py``.

Every function takes tensors led by the participants held here and an
optional runtime ``rt`` (:class:`repro_torch.core.runtime.Runtime`), the
binding the collectives go through; without one the binding is stacked
over the tensor's leading dimension.  Each verb follows the reference's
per-participant structure, with the collectives on the runtime:

* a read gathers the (R,) request lanes (or, on the DMA backend, the (R, 8)
  descriptors), every home serves the gathered lanes addressed to it from
  its own block, and the answers come back by a psum_scatter over the
  homes — exact, because at most one home serves each lane;
* a write gathers the payloads and their metadata, and every home commits
  the lanes addressed to it on its own block in (participant, lane) order;
* ``bcast_from``, ``gather_rows``, ``prefix_sums`` and ``window_prefix``
  compute on the gathered table and keep their own rows.

In the stacked binding a gather is the stacked tensor itself and a
psum_scatter a sum over the home dimension — the tensor operations these
functions did before the process binding existed, so their values are
bitwise what they were.  In the process binding (one participant a rank)
each is a ``torch.distributed`` collective (:mod:`.runtime`).  Two ids are
kept apart: a lane's target and ``me`` are global participant ids
(``rt.my_id()``); the leading dimension is indexed by local position.
Costs, ledger rows and rounds are those of the reference verb for verb;
each rank files its own bytes.

Locality tier (DESIGN.md §2.3): lanes with ``target == me`` are local memory
accesses, served from ``local_buf`` (reads) or applied from the local payload
(writes), and modeled at zero wire bytes; disabled lanes contribute nothing.
Read tier (DESIGN.md §8.1): the batched read coalesces duplicate
(target, index) pairs per participant before the wire.
"""
from __future__ import annotations

import torch


def _rt(rt, x):
    """``rt``, or the stacked binding over ``x``'s leading dimension."""
    if rt is not None:
        return rt
    from .runtime import Runtime
    return Runtime(x.shape[0], device=x.device)


def _per_participant(x, P, device, dtype=None):
    """A scalar or a (P,) value as a (P,) tensor on ``device``."""
    x = torch.as_tensor(x, device=device)
    return (x if dtype is None else x.to(dtype)).expand(P)


def _item_nbytes(local_buf) -> int:
    """Static per-row payload bytes of a stacked (P, slots, *item) buffer."""
    n = 1
    for d in local_buf.shape[2:]:
        n *= int(d)
    return n * local_buf.element_size()


def _lanes(x, like):
    """Reshape a (P, R) lane mask to broadcast over ``like``'s item dims."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _record(ledger, verb, wire_bytes):
    """Report modeled wire bytes, a (P,) tensor, into the traffic ledger
    (no-op when disabled)."""
    if ledger is not None and ledger.enabled:
        ledger.record(verb, wire_bytes)


def record_dma(ledger, verb, nbytes):
    """Report the (P,) bytes a remote-DMA kernel measured into the ledger's
    measured tier (DESIGN.md §15)."""
    if ledger is not None and ledger.enabled:
        ledger.record_dma(verb, nbytes)


def record_rounds(ledger, verb, rounds):
    """Report cluster-wide modeled collective rounds (DESIGN.md §14)."""
    if ledger is not None and ledger.enabled:
        ledger.record_rounds(verb, rounds)


def record_fastpath(ledger, name, fast, windows):
    """Report lock-skipped windows (DESIGN.md §11): ``fast`` windows out of
    ``windows`` executed were classified commuting and served without any
    lock or tracker round (no-op when disabled)."""
    if ledger is not None and ledger.enabled:
        ledger.record_fastpath(name, fast, windows)


def _dma():
    """The remote-DMA kernel module, imported where it is used."""
    from ..kernels import remote_dma
    return remote_dma


# ---------------------------------------------------------------------------
# local-memory helpers of the stacked form
# ---------------------------------------------------------------------------

def put_rows_(dst, rows, values, keep, accumulate=False):
    """In place: ``dst[p, rows[p, k]] = values[p, k]`` for every kept lane —
    the stacked form of ``buf.at[row].set(values, mode="drop")`` (or
    ``.add`` with ``accumulate``).  ``dst`` (P, M, *item); ``rows``/``keep``
    (P, K); ``values`` broadcastable to (P, K, *item).  Kept rows must be
    distinct unless ``accumulate``.  Returns ``dst``."""
    P, K = rows.shape
    homes = torch.arange(P, device=dst.device)[:, None].expand(P, K)
    vals = torch.as_tensor(values, dtype=dst.dtype, device=dst.device) \
        .expand((P, K) + tuple(dst.shape[2:]))
    dst.index_put_((homes[keep], rows.long()[keep]), vals[keep],
                   accumulate=accumulate)
    return dst


def put_rows(dst, rows, values, keep, accumulate=False):
    """:func:`put_rows_` on a copy of ``dst``."""
    return put_rows_(dst.clone(), rows, values, keep, accumulate=accumulate)


def exclusive_any(x):
    """``out[..., i] = any(x[..., :i])`` along the last dimension."""
    c = x.to(torch.int64).cumsum(-1)
    return (c - x.to(torch.int64)) > 0


def segments(keys):
    """Stable sort of ``keys`` along the last dimension, for
    :func:`count_before_same`: (order, segment-start flags)."""
    skeys, perm = torch.sort(keys, dim=-1, stable=True)
    start = torch.ones_like(skeys, dtype=torch.bool)
    start[..., 1:] = skeys[..., 1:] != skeys[..., :-1]
    return perm, start


def count_before_same(seg, flags):
    """For every position i along the last dimension: the number of flagged
    positions j < i with the same key — the reduction
    ``sum(earlier & same_key & flags[None, :], axis=1)`` without an (N, N)
    mask, from one stable sort (``seg = segments(keys)``).  ``keys`` may be
    (N,) and ``flags`` (P, N): the sort is then shared by all participants."""
    perm, start = seg
    perm = perm.expand(flags.shape)
    start = start.expand(flags.shape)
    f = flags.gather(-1, perm).to(torch.int64)
    c = f.cumsum(-1) - f
    base = torch.where(start, c, torch.zeros_like(c)).cummax(-1).values
    return torch.empty_like(c).scatter_(-1, perm, c - base)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def bcast_from(value, owner, rt=None):
    """Broadcast participant ``owner``'s value to all: (n, ...) → (n, ...).
    ``owner`` is an int, or an (n,) tensor holding each participant's view
    of the owner — the same id everywhere, as every state that names an
    owner is (then participant q receives the owner's row)."""
    return _rt(rt, value).bcast(value, owner)


def gather_rows(value, rt=None):
    """All-gather each participant's value into a leading-P table: (n, ...)
    → (n viewers, P, ...), every viewer seeing the same table."""
    table = _rt(rt, value).gather(value)
    return table[None].expand((value.shape[0],) + tuple(table.shape))


def prefix_sums(x, rt=None):
    """(exclusive prefix at each participant, total, gathered) for one
    scalar per participant, in participant order."""
    rt = _rt(rt, x)
    g = rt.gather(x)
    excl = rt.mine(g.cumsum(0) - g)
    return excl, g.sum().expand_as(x), \
        g[None].expand((x.shape[0],) + tuple(g.shape))


def window_prefix(x, rt=None):
    """(exclusive prefix (n, B), total (n,)) over all P·B lanes flattened in
    (participant, lane) lexicographic order — the windowed prefix_sums."""
    rt = _rt(rt, x)
    g = rt.gather(x)
    flat = g.reshape(-1)
    excl = rt.mine((flat.cumsum(0) - flat).reshape(g.shape))
    return excl, flat.sum().expand(x.shape[0])


# ---------------------------------------------------------------------------
# scalar one-sided verbs: one request per participant
# ---------------------------------------------------------------------------

def scalar_lanes(local_buf, target, index, pred):
    """A scalar verb's target, index and pred — one value, or one a
    participant — as the (P, 1) int32, int32 and bool lanes of a batch of
    one."""
    P, dev = local_buf.shape[0], local_buf.device
    return tuple(_per_participant(x, P, dev, dt)[:, None]
                 for x, dt in ((target, torch.int32), (index, torch.int32),
                               (pred, torch.bool)))


def scalar_value(local_buf, value):
    """A scalar write's value — one item, or one a participant — as the
    (P, 1, *item) values of a batch of one."""
    return torch.as_tensor(value, device=local_buf.device) \
        .to(local_buf.dtype) \
        .expand((local_buf.shape[0],) + tuple(local_buf.shape[2:]))[:, None]


def remote_read(local_buf, target, index, pred=True, ledger=None,
                verb: str = "remote_read", rt=None):
    """One-sided READ: participant q reads row ``index[q]`` of participant
    ``target[q]``'s buffer — :func:`remote_read_batch` with one uncoalesced
    lane per participant.

    local_buf (n, slots, *item); target, index (n,) int (or one int for
    all); pred (n,) bool or a bool.  Returns (n, *item): each value as
    stored at its target, zeros where ``pred`` is False.  A ``target == me``
    request is a local read at zero modeled wire bytes.  Ledger: 2·|item|
    bytes per remote read, 2 rounds."""
    return remote_read_batch(local_buf,
                             *scalar_lanes(local_buf, target, index, pred),
                             ledger=ledger, verb=verb, coalesce=False,
                             rt=rt)[:, 0]


def remote_write(local_buf, target, index, value, pred=True, ledger=None,
                 verb: str = "remote_write", rt=None):
    """One-sided WRITE: participant q writes ``value[q]`` into row
    ``index[q]`` of participant ``target[q]``'s buffer; ``value`` (n,
    *item) — :func:`remote_write_batch` with one lane per participant.
    Racy writes to one row land in increasing participant order, so the
    highest id's write wins — a fixed total order standing in for RDMA's
    unspecified outcome.  A target outside the cluster is dropped; a
    ``target == me`` write is a local store at zero modeled wire bytes.
    Returns the new (n, slots, *item) buffer.  Ledger: |item| bytes per
    remote write, 1 round."""
    targets, indices, preds = scalar_lanes(local_buf, target, index, pred)
    return remote_write_batch(local_buf, targets, indices,
                              scalar_value(local_buf, value), preds=preds,
                              ledger=ledger, verb=verb, rt=rt)


# ---------------------------------------------------------------------------
# batched one-sided verbs
# ---------------------------------------------------------------------------

def _serve_scatter(local_buf, targets, indices, wire_lane, engine=None,
                   rt=None):
    """The shared wire path of the batched read verbs: gather the (n, R)
    read requests (a lane rides iff ``wire_lane``), let every home serve the
    gathered requests addressed to it from its ``local_buf``, and
    psum_scatter the (home, requester, R, *item) served tensor over the
    homes, so requester q receives exactly its R answers.  Lanes off the
    wire come back as zero rows.  Returns (n, R, *item).

    With an ``engine`` (the DMA backend, DESIGN.md §15) the requests travel
    as (R, 8)-word descriptors built by the descriptor kernel on each
    requester's lanes, homes serve the gathered P·R descriptors with the
    row-gather kernel on their own blocks, and the engine records the bytes
    both kernels measured.  The served values are bitwise those of the
    plain path."""
    rt = _rt(rt, local_buf)
    n, slots = local_buf.shape[:2]
    P, R = rt.P, targets.shape[1]
    homes = rt.my_id()
    if engine is None:
        tgt, idx, en = rt.gather_many(targets, indices, wire_lane)
        idx = idx.clamp(0, slots - 1).reshape(-1)
        mask = (tgt.reshape(-1)[None, :] == homes[:, None]) \
            & en.reshape(-1)[None, :]                            # (n, P·R)
        served = local_buf[:, idx]                               # (n, P·R, *)
        served = torch.where(_lanes(mask, served), served,
                             torch.zeros((), dtype=served.dtype,
                                         device=served.device))
    else:
        dma = _dma()
        reqs, desc_nb = dma.build_descriptors(
            targets, indices, wire_lane, op=dma.OP_READ,
            row_nbytes=_item_nbytes(local_buf))                  # (n, R, 8)
        engine.count(desc_nb)
        reqs = rt.gather(reqs)                                   # (P, R, 8)
        tgt, idx, en = reqs[..., 1], reqs[..., 2], reqs[..., 3] != 0
        idx = idx.clamp(0, slots - 1).reshape(-1)
        mask = (tgt.reshape(-1)[None, :] == homes[:, None]) \
            & en.reshape(-1)[None, :]
        buf2d = local_buf.reshape(n, slots, -1)
        rows, served_nb = dma.gather_rows(
            buf2d, idx[None, :].expand(n, -1), mask)
        engine.count(served_nb)
        served = rows
    served = served.reshape((n, P, R) + tuple(local_buf.shape[2:]))
    # psum_scatter over the requester axis: requester q receives
    # sum_h served[h, q]; at most one home serves a lane, so the sum is exact
    return rt.psum_scatter(served)


def remote_read_batch(local_buf, targets, indices, preds=None, ledger=None,
                      verb: str = "remote_read_batch", coalesce: bool = True,
                      engine=None, cost_fn=None, rt=None):
    """Batched one-sided READ: R requests per participant.

    local_buf (n, slots, *item); targets, indices (n, R) int; preds (n, R)
    bool (default all enabled).  Returns (n, R, *item).  Coalesces duplicate
    (target, index) lanes by default (:func:`remote_read_coalesced`);
    ``coalesce=False`` keeps every enabled remote lane on the wire.  Self
    lanes are served from local memory; disabled lanes return zeros.
    ``engine`` routes the wire path through the remote-DMA kernels;
    ``cost_fn(n, nb)`` overrides the modeled byte contract."""
    if coalesce:
        return remote_read_coalesced(local_buf, targets, indices,
                                     preds=preds, ledger=ledger, verb=verb,
                                     engine=engine, cost_fn=cost_fn, rt=rt)
    rt = _rt(rt, local_buf)
    slots = local_buf.shape[1]
    targets = targets.to(torch.int32)
    indices = indices.to(torch.int32)
    if preds is None:
        preds = torch.ones(targets.shape, dtype=torch.bool,
                           device=targets.device)
    me = rt.my_id()[:, None]
    self_lane = preds & (targets == me)
    remote_lane = preds & (targets != me)
    out = _serve_scatter(local_buf, targets, indices, remote_lane,
                         engine=engine, rt=rt)
    homes = rt.local_ids()[:, None].expand_as(indices)
    local_vals = local_buf[homes, indices.long().clamp(0, slots - 1)]
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    out = torch.where(_lanes(self_lane, out), local_vals, out)
    out = torch.where(_lanes(preds, out), out, zero)
    nb = _item_nbytes(local_buf)
    n_wire = remote_lane.sum(1).to(torch.float64)
    _record(ledger, verb, cost_fn(n_wire, nb) if cost_fn is not None
            else 2.0 * nb * n_wire)
    record_rounds(ledger, verb, 2.0)
    return out


def remote_read_coalesced(local_buf, targets, indices, preds=None,
                          ledger=None, verb: str = "remote_read_coalesced",
                          engine=None, cost_fn=None, rt=None):
    """Duplicate-coalescing batched read (DESIGN.md §8.1): the first enabled
    remote lane of each distinct (target, index) pair — its leader — rides
    the wire; duplicates fan out locally from the leader's answer.
    Bitwise-identical results to the uncoalesced path.

    Leader election is one (n, P·slots) int32 min-scatter of lane order on
    the linear row id (first lane wins) and one gather back.  Modeled wire
    bytes: 2·|item| per unique enabled remote pair."""
    rt = _rt(rt, local_buf)
    n, slots = local_buf.shape[:2]
    R = targets.shape[1]
    dev = targets.device
    targets = targets.to(torch.int32)
    indices = indices.to(torch.int32)
    if preds is None:
        preds = torch.ones(targets.shape, dtype=torch.bool, device=dev)
    me = rt.my_id()[:, None]
    loc = rt.local_ids()[:, None].expand(n, R)
    self_lane = preds & (targets == me)
    remote_lane = preds & (targets != me)
    n_rows = rt.P * slots
    order = torch.arange(R, dtype=torch.int32, device=dev).expand(n, R)
    lid = targets.long() * slots + indices.long().clamp(0, slots - 1)
    # column n_rows takes the lanes off the wire (the reference's dropped
    # scatter index)
    table = torch.full((n, n_rows + 1), R, dtype=torch.int32, device=dev)
    table.scatter_reduce_(1, torch.where(remote_lane, lid, n_rows), order,
                          "amin")
    rep = table.gather(1, lid.clamp(0, n_rows - 1)).clamp(0, R - 1).long()
    leader = remote_lane & (rep == order)
    out = _serve_scatter(local_buf, targets, indices, leader, engine=engine,
                         rt=rt)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    # duplicate fan-out: every remote lane reads its leader's answer
    fanned = out[loc, rep]
    out = torch.where(_lanes(remote_lane, out), fanned, zero)
    local_vals = local_buf[loc, indices.long().clamp(0, slots - 1)]
    out = torch.where(_lanes(self_lane, out), local_vals, out)
    out = torch.where(_lanes(preds, out), out, zero)
    nb = _item_nbytes(local_buf)
    n_wire = leader.sum(1).to(torch.float64)
    _record(ledger, verb, cost_fn(n_wire, nb) if cost_fn is not None
            else 2.0 * nb * n_wire)
    record_rounds(ledger, verb, 2.0)
    return out


def remote_write_batch(local_buf, targets, indices, values, preds=None,
                       assume_unique=False, ledger=None,
                       verb: str = "remote_write_batch", engine=None,
                       cost_fn=None, rt=None):
    """Batched one-sided WRITE: R writes per participant, applied in
    (participant, request) lexicographic order — racy writes to one row
    resolve last-writer-wins.  Returns the new (n, slots, *item) buffer.

    ``assume_unique=True`` skips the winner election for callers whose
    enabled writes never collide.  ``target == me`` lanes are local stores
    (zero modeled wire bytes).  ``engine`` routes the metadata gather and
    the commit through the remote-DMA kernels: (R, 8)-word descriptors
    carry the metadata, and the scatter kernel commits the gathered P·R
    lanes on each home's block in lane order; ``cost_fn(n, nb)`` overrides
    the modeled byte contract."""
    rt = _rt(rt, local_buf)
    L, slots = local_buf.shape[:2]
    P, R = rt.P, targets.shape[1]
    dev = targets.device
    item = tuple(local_buf.shape[2:])
    targets = targets.to(torch.int32)
    indices = indices.to(torch.int32)
    values = values.to(local_buf.dtype)
    if preds is None:
        preds = torch.ones(targets.shape, dtype=torch.bool, device=dev)
    homes = rt.my_id()
    me = homes[:, None]
    self_lane = preds & (targets == me)
    remote_lane = preds & (targets != me)
    zero = torch.zeros((), dtype=values.dtype, device=dev)
    wire_vals = torch.where(_lanes(self_lane, values), zero, values)
    if engine is None:
        tgts, idxs, ens = rt.gather_many(targets, indices, preds)
    else:
        dma = _dma()
        meta, desc_nb = dma.build_descriptors(
            targets, indices, preds, wire=remote_lane, op=dma.OP_WRITE,
            row_nbytes=_item_nbytes(local_buf))                   # (n, R, 8)
        engine.count(desc_nb)
        meta = rt.gather(meta)                                    # (P, R, 8)
        tgts, idxs, ens = meta[..., 1], meta[..., 2], meta[..., 3] != 0
    # every home sees the gathered payloads, with its own lanes restored
    # from local memory (they never rode the wire)
    g_wire = rt.gather(wire_vals)                                 # (P, R, *)
    own = (homes[:, None] == rt.all_ids()[None, :]).reshape(
        (L, P, 1) + (1,) * len(item))
    vals = torch.where(own, rt.with_own(g_wire, values)[None],
                       g_wire[None])                          # (home, P, R, *)
    n = P * R
    flat_i = idxs.reshape(n).clamp(0, slots - 1)
    flat_v = vals.reshape((L, n) + item)
    win = (tgts.reshape(n)[None, :] == me) & ens.reshape(n)[None, :]  # (L, n)
    nb = _item_nbytes(local_buf)
    n_wire = remote_lane.sum(1).to(torch.float64)
    _record(ledger, verb, cost_fn(n_wire, nb) if cost_fn is not None
            else float(nb) * n_wire)
    record_rounds(ledger, verb, 1.0)
    rows = flat_i[None, :].expand(L, n)
    if engine is not None:
        # DMA commit: lanes apply in sequence order; only lanes that came
        # from another participant count as measured wire payload
        origin = torch.arange(n, device=dev) // R
        wire = win & (origin[None, :] != me)
        out2d, wire_nb = _dma().scatter_rows(
            local_buf.reshape(L, slots, -1), rows, flat_v.reshape(L, n, -1),
            win, wire)
        engine.count(wire_nb)
        return out2d.reshape(local_buf.shape)
    if not assume_unique:
        order = torch.arange(n, device=dev)
        later_same = (flat_i[None, :] == flat_i[:, None]) \
            & (order[None, :] > order[:, None])                   # (n, n)
        win = win & ~(later_same[None] & win[:, None, :]).any(2)
    return put_rows(local_buf, rows, flat_v, win)
