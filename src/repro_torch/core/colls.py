"""Collective building blocks for channel implementations — LOCO's one-sided
verbs (DESIGN.md §2), the counterpart of ``repro/core/colls.py``.

Every function takes the port's stacked tensors: a leading participant
dimension P on every state and argument.  The reference's collectives become
operations over that dimension (an all-gather is the stacked tensor itself, a
psum a sum over dim 0, a psum_scatter of ``(home, requester, ...)`` served
rows a sum over the home dimension — exact, because at most one home serves
each lane).  Costs, ledger rows and rounds are those of the reference verb
for verb.

Locality tier (DESIGN.md §2.3): lanes with ``target == me`` are local memory
accesses, served from ``local_buf`` (reads) or applied from the local payload
(writes), and modeled at zero wire bytes; disabled lanes contribute nothing.
Read tier (DESIGN.md §8.1): the batched read coalesces duplicate
(target, index) pairs per participant before the wire.
"""
from __future__ import annotations

import torch


def my_id(P: int, device) -> torch.Tensor:
    """(P,) participant ids — the stacked ``axis_index``."""
    return torch.arange(P, device=device)


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

def bcast_from(value, owner):
    """Broadcast participant ``owner``'s value to all: (P, ...) → (P, ...).
    ``owner`` is an int, or a (P,) tensor holding each participant's view of
    the owner — the same id everywhere, as every state that names an owner
    is (then participant q receives ``value[owner[q]]``)."""
    if isinstance(owner, torch.Tensor):
        return value[owner.to(torch.int64)]
    return value[owner].expand_as(value)


def gather_rows(value):
    """All-gather each participant's value into a leading-P table: (P, ...)
    → (P viewers, P, ...), every viewer seeing the same table."""
    return value[None].expand((value.shape[0],) + tuple(value.shape))


def prefix_sums(x):
    """(exclusive prefix at each participant, total, gathered) for one
    scalar per participant, in participant order."""
    excl = x.cumsum(0) - x
    return excl, x.sum().expand_as(x), gather_rows(x)


def window_prefix(x):
    """(exclusive prefix (P, B), total (P,)) over all P·B lanes flattened in
    (participant, lane) lexicographic order — the windowed prefix_sums."""
    flat = x.reshape(-1)
    excl = (flat.cumsum(0) - flat).reshape(x.shape)
    return excl, flat.sum().expand(x.shape[0])


# ---------------------------------------------------------------------------
# batched one-sided verbs
# ---------------------------------------------------------------------------

def _serve_scatter(local_buf, targets, indices, wire_lane, engine=None):
    """The shared wire path of the batched read verbs: gather the (P, R)
    read requests (a lane rides iff ``wire_lane``), let every home serve the
    requests addressed to it from its ``local_buf``, and reduce the
    (home, requester, R, *item) served tensor over the home dimension, so
    requester q receives exactly its R answers.  Lanes off the wire come
    back as zero rows.  Returns (P, R, *item).

    With an ``engine`` (the DMA backend, DESIGN.md §15) the requests travel
    as (R, 8)-word descriptors built by the descriptor kernel, homes serve
    with the row-gather kernel, and the engine records the bytes both
    kernels measured.  The served values are bitwise those of the plain
    path."""
    P, slots = local_buf.shape[:2]
    R = targets.shape[1]
    homes = my_id(P, local_buf.device)
    if engine is None:
        tgt, idx, en = targets, indices, wire_lane
        idx = idx.clamp(0, slots - 1).reshape(-1)
        mask = (tgt.reshape(-1)[None, :] == homes[:, None]) \
            & en.reshape(-1)[None, :]                            # (P, P·R)
        served = local_buf[:, idx]                               # (P, P·R, *)
        served = torch.where(_lanes(mask, served), served,
                             torch.zeros((), dtype=served.dtype,
                                         device=served.device))
    else:
        dma = _dma()
        reqs, desc_nb = dma.build_descriptors(
            targets, indices, wire_lane, op=dma.OP_READ,
            row_nbytes=_item_nbytes(local_buf))                  # (P, R, 8)
        engine.count(desc_nb)
        tgt, idx, en = reqs[..., 1], reqs[..., 2], reqs[..., 3] != 0
        idx = idx.clamp(0, slots - 1).reshape(-1)
        mask = (tgt.reshape(-1)[None, :] == homes[:, None]) \
            & en.reshape(-1)[None, :]
        buf2d = local_buf.reshape(P, slots, -1)
        rows, served_nb = dma.gather_rows(
            buf2d, idx[None, :].expand(P, -1), mask)
        engine.count(served_nb)
        served = rows
    served = served.reshape((P, P, R) + tuple(local_buf.shape[2:]))
    # psum_scatter over the requester axis: requester q receives
    # sum_h served[h, q]; at most one home serves a lane, so the sum is exact
    return served.sum(0, dtype=served.dtype)


def remote_read_batch(local_buf, targets, indices, preds=None, ledger=None,
                      verb: str = "remote_read_batch", coalesce: bool = True,
                      engine=None, cost_fn=None):
    """Batched one-sided READ: R requests per participant.

    local_buf (P, slots, *item); targets, indices (P, R) int; preds (P, R)
    bool (default all enabled).  Returns (P, R, *item).  Coalesces duplicate
    (target, index) lanes by default (:func:`remote_read_coalesced`);
    ``coalesce=False`` keeps every enabled remote lane on the wire.  Self
    lanes are served from local memory; disabled lanes return zeros.
    ``engine`` routes the wire path through the remote-DMA kernels;
    ``cost_fn(n, nb)`` overrides the modeled byte contract."""
    if coalesce:
        return remote_read_coalesced(local_buf, targets, indices,
                                     preds=preds, ledger=ledger, verb=verb,
                                     engine=engine, cost_fn=cost_fn)
    P, slots = local_buf.shape[:2]
    targets = targets.to(torch.int32)
    indices = indices.to(torch.int32)
    if preds is None:
        preds = torch.ones(targets.shape, dtype=torch.bool,
                           device=targets.device)
    me = my_id(P, targets.device)[:, None]
    self_lane = preds & (targets == me)
    remote_lane = preds & (targets != me)
    out = _serve_scatter(local_buf, targets, indices, remote_lane,
                         engine=engine)
    homes = me.expand_as(indices)
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
                          engine=None, cost_fn=None):
    """Duplicate-coalescing batched read (DESIGN.md §8.1): the first enabled
    remote lane of each distinct (target, index) pair — its leader — rides
    the wire; duplicates fan out locally from the leader's answer.
    Bitwise-identical results to the uncoalesced path.

    Leader election is one (P, P·slots) int32 min-scatter of lane order on
    the linear row id (first lane wins) and one gather back.  Modeled wire
    bytes: 2·|item| per unique enabled remote pair."""
    P, slots = local_buf.shape[:2]
    R = targets.shape[1]
    dev = targets.device
    targets = targets.to(torch.int32)
    indices = indices.to(torch.int32)
    if preds is None:
        preds = torch.ones(targets.shape, dtype=torch.bool, device=dev)
    me = my_id(P, dev)[:, None]
    self_lane = preds & (targets == me)
    remote_lane = preds & (targets != me)
    n_rows = P * slots
    order = torch.arange(R, dtype=torch.int32, device=dev).expand(P, R)
    lid = targets.long() * slots + indices.long().clamp(0, slots - 1)
    # column n_rows takes the lanes off the wire (the reference's dropped
    # scatter index)
    table = torch.full((P, n_rows + 1), R, dtype=torch.int32, device=dev)
    table.scatter_reduce_(1, torch.where(remote_lane, lid, n_rows), order,
                          "amin")
    rep = table.gather(1, lid.clamp(0, n_rows - 1)).clamp(0, R - 1).long()
    leader = remote_lane & (rep == order)
    out = _serve_scatter(local_buf, targets, indices, leader, engine=engine)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    # duplicate fan-out: every remote lane reads its leader's answer
    fanned = out[me.expand(P, R), rep]
    out = torch.where(_lanes(remote_lane, out), fanned, zero)
    local_vals = local_buf[me.expand(P, R), indices.long().clamp(0, slots - 1)]
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
                       cost_fn=None):
    """Batched one-sided WRITE: R writes per participant, applied in
    (participant, request) lexicographic order — racy writes to one row
    resolve last-writer-wins.  Returns the new (P, slots, *item) buffer.

    ``assume_unique=True`` skips the winner election for callers whose
    enabled writes never collide.  ``target == me`` lanes are local stores
    (zero modeled wire bytes).  ``engine`` routes the metadata gather and
    the commit through the remote-DMA kernels: (R, 8)-word descriptors
    carry the metadata, and the scatter kernel commits in lane order;
    ``cost_fn(n, nb)`` overrides the modeled byte contract."""
    P, slots = local_buf.shape[:2]
    R = targets.shape[1]
    dev = targets.device
    item = tuple(local_buf.shape[2:])
    targets = targets.to(torch.int32)
    indices = indices.to(torch.int32)
    values = values.to(local_buf.dtype)
    if preds is None:
        preds = torch.ones(targets.shape, dtype=torch.bool, device=dev)
    homes = my_id(P, dev)
    me = homes[:, None]
    self_lane = preds & (targets == me)
    remote_lane = preds & (targets != me)
    zero = torch.zeros((), dtype=values.dtype, device=dev)
    wire_vals = torch.where(_lanes(self_lane, values), zero, values)
    if engine is None:
        tgts, idxs, ens = targets, indices, preds
    else:
        dma = _dma()
        meta, desc_nb = dma.build_descriptors(
            targets, indices, preds, wire=remote_lane, op=dma.OP_WRITE,
            row_nbytes=_item_nbytes(local_buf))                   # (P, R, 8)
        engine.count(desc_nb)
        tgts, idxs, ens = meta[..., 1], meta[..., 2], meta[..., 3] != 0
    # every home sees the gathered payloads, with its own lanes restored
    # from local memory (they never rode the wire)
    own = (homes[:, None] == homes[None, :]).reshape((P, P, 1) + (1,) * len(item))
    vals = torch.where(own, values[None], wire_vals[None])   # (home, P, R, *)
    n = P * R
    flat_i = idxs.reshape(n).clamp(0, slots - 1)
    flat_v = vals.reshape((P, n) + item)
    win = (tgts.reshape(n)[None, :] == me) & ens.reshape(n)[None, :]  # (P, n)
    nb = _item_nbytes(local_buf)
    n_wire = remote_lane.sum(1).to(torch.float64)
    _record(ledger, verb, cost_fn(n_wire, nb) if cost_fn is not None
            else float(nb) * n_wire)
    record_rounds(ledger, verb, 1.0)
    rows = flat_i[None, :].expand(P, n)
    if engine is not None:
        # DMA commit: lanes apply in sequence order; only lanes that came
        # from another participant count as measured wire payload
        origin = torch.arange(n, device=dev) // R
        wire = win & (origin[None, :] != me)
        out2d, wire_nb = _dma().scatter_rows(
            local_buf.reshape(P, slots, -1), rows, flat_v.reshape(P, n, -1),
            win, wire)
        engine.count(wire_nb)
        return out2d.reshape(local_buf.shape)
    if not assume_unique:
        order = torch.arange(n, device=dev)
        later_same = (flat_i[None, :] == flat_i[:, None]) \
            & (order[None, :] > order[:, None])                   # (n, n)
        win = win & ~(later_same[None] & win[:, None, :]).any(2)
    return put_rows(local_buf, rows, flat_v, win)
