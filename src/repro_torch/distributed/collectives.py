"""GradChannel: LOCO-style explicit gradient synchronization, the
counterpart of ``repro/distributed/collectives.py``, on both bindings.

The paper's claim is that upper-level systems (here: data-parallel
training) should be built FROM channel objects rather than ad-hoc
collectives.  This module is that construction:

* each participant's gradient is its register in a conceptual SST over the
  data axes: ``push`` = every owner pushes, every peer combines (a mean
  over the participant dimension on the stacked binding, an all-reduce
  between processes);
* multi-pod meshes use the **hierarchical schedule**: the mean inside the
  pod first, then across pods;
* fence scopes (``core/ack.py``) order the phases: ``fence="global"``
  joins every earlier bucket before a bucket's push, ``"pair"`` joins each
  bucket only to itself.  Eager PyTorch issues every operation on one
  stream in program order, so both give the same values in the same order
  (:func:`repro_torch.core.ack.join` is an ordering no-op); the
  bookkeeping is kept so the channel code reads as the reference's, whose
  XLA schedule the knob moves;
* optional int8 error-feedback compression (:mod:`repro_torch.optim.
  compression`) on the cross-pod hop.

On the stacked binding (:func:`grad_sync`, :func:`make_grad_sync` with a
:class:`~repro_torch.launch.mesh.StackedMesh`) a gradient leaf is
stacked: its leading dimensions are the participants (``data_dim``,
``pod_dim`` where the mesh has pods, and any other mesh axis, such as
``model``, whose shards pass through untouched), each participant's
gradient shard after them.  On the process binding
(:func:`grad_sync_process`, :func:`make_grad_sync` with a
:class:`~repro_torch.launch.mesh.ProcessMesh`) each rank holds its own
shard, and the means are all-reduces over the ``data`` and ``pod``
process groups: the reference's ``make_grad_sync_shardmap``.  Every
participant leaves with the mean over the dp axes.

The process binding's collectives: :func:`psum`, :func:`all_gather`,
:func:`all_to_all`, :func:`reduce_scatter`, :func:`copy_to`,
:func:`slice_to` and :func:`gather_param` over one named axis of a
:class:`~repro_torch.launch.mesh.ProcessMesh`, or over a tuple of axes
taken as one (the flattened data-parallel axes ``("pod", "data")``: one
group, its ranks in pod-major order, so a sum over it is one reduction,
as the reference's GSPMD takes it), each the identity on an axis of size
1 and when no mesh is given, so a path without a mesh runs
no collective at all.  Where autograd needs their gradient each is a
``torch.autograd.Function`` whose backward is its adjoint: ``psum`` (the
row-parallel sum) passes the gradient through; ``copy_to`` (a
column-parallel layer's input, the identity) sums it over the axis;
``all_gather`` (the logits over ``model``) keeps the rank's own slice;
``slice_to`` (a rank's slice, as the MoE block's ``x_spec`` cuts S)
gathers the slices' gradients; ``all_to_all`` is its own adjoint; and
``gather_param`` (fsdp's per-layer gather over ``data``) reduce-scatters
the gradient back to the shards.  :func:`loss_mean` is a loss term's
mean over the whole world (the MoE load-balance loss).  Under gloo a
tensor on the card goes through host memory (``transport`` "host") unless
:func:`probe_transports` found that gloo takes card tensors for that
collective ("native"), a verdict that holds for every group of the mesh,
the flattened dp group among them; NCCL always takes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.ack import AckKey, join
from ..optim import compression as C
from ..tree import leaves, unflatten
from .sharding import DP, dp_axes


def fence_grads(grads):
    """LOCO GLOBAL fence between the backward and the optimizer update.

    The reference pins XLA's float32 converts below the gradient
    all-reduces with an ``optimization_barrier`` over every leaf, so the
    wire payload stays bf16.  Eager PyTorch runs the port's operations on
    one stream in program order (``core/ack.py``): nothing can be hoisted
    across the fence, and it returns the gradients as they are."""
    return grads


def _bucketize(n_leaves, n_buckets):
    """Round-robin leaf indices into n_buckets lists."""
    buckets = [[] for _ in range(min(n_buckets, max(n_leaves, 1)))]
    for i in range(n_leaves):
        buckets[i % len(buckets)].append(i)
    return [b for b in buckets if b]


def grad_sync(grads, *, data_dim: int = 0, pod_dim: Optional[int] = None,
              fence: str = "global", compress: str = "none",
              error_state=None, n_buckets: int = 4,
              lead: Optional[int] = None):
    """Stacked gradient synchronization.  Returns (synced_grads,
    new_error_state): each leaf in float32 with every participant holding
    the mean over ``data_dim``, then over ``pod_dim`` (with
    ``compress="int8ef"`` an int8 error-feedback mean there, every
    participant quantizing with one scale: the largest of the participants'
    max |value| / 127, as the reference's ``pmax`` agrees it); the error
    state is a tree of
    float32 leaves shaped as the gradients with ``"int8ef"``, else None.
    The leaves' first ``lead`` dimensions are participants (default: those
    through ``data_dim`` and ``pod_dim``).

    fence='global'  — join every bucket before any later bucket's push
                      (paper-faithful conservative order);
    fence='pair'    — each bucket only joins itself.
    """
    flat = list(leaves(grads))
    err = (list(leaves(error_state)) if error_state is not None
           else [None] * len(flat))
    if lead is None:
        lead = 1 + max(data_dim, -1 if pod_dim is None else pod_dim)
    out = [None] * len(flat)
    new_err = [None] * len(flat)
    pending = AckKey.empty()
    for bucket in _bucketize(len(flat), n_buckets):
        if fence == "global" and pending.tokens:
            # order this bucket after ALL previously issued pushes
            gate = [flat[i] for i in bucket]
            gate = join(pending, *gate) if len(gate) > 1 else \
                [join(pending, gate[0])]
            for j, i in enumerate(bucket):
                flat[i] = gate[j]
        bucket_ack = AckKey.empty()
        for i in bucket:
            g = flat[i].float()
            # in-pod push: every data peer contributes
            g = g.mean(data_dim, keepdim=True).expand(g.shape)
            if pod_dim is not None:
                if compress == "int8ef":
                    g, new_err[i] = C.int8_ef_allreduce(g, pod_dim, err[i],
                                                        lead=lead)
                else:
                    g = g.mean(pod_dim, keepdim=True).expand(g.shape)
            out[i] = g
            bucket_ack = bucket_ack | AckKey([g])
        pending = bucket_ack if fence == "pair" else (pending | bucket_ack)
    synced = unflatten(grads, out)
    err_tree = unflatten(grads, new_err) if compress == "int8ef" else None
    return synced, err_tree


def make_grad_sync(mesh, *, fence="global", compress="none", n_buckets=4):
    """Bind the gradient channel to ``mesh``, as the reference's
    ``make_grad_sync_shardmap``: every participant leaves with the float32
    dp mean of its gradients, int8 error feedback on the pod hop with
    ``compress="int8ef"``.

    On a :class:`~repro_torch.launch.mesh.StackedMesh` (:func:`grad_sync`)
    each leaf arrives with one leading dimension a mesh axis, in the mesh's
    order — (pod, data, model, ...) — and each participant's shard after
    them, as the reference's gradients carry their parameter sharding (a
    leaf replicated over ``model`` holds equal copies there).  On a
    :class:`~repro_torch.launch.mesh.ProcessMesh`
    (:func:`grad_sync_process`) each leaf is this rank's shard, and the
    compressed pod hop's error state stays on the rank between calls."""
    from ..launch.mesh import ProcessMesh
    axes = mesh.axis_names
    if isinstance(mesh, ProcessMesh):
        state = {"error": None}

        def sync_process(grads):
            synced, state["error"] = grad_sync_process(
                grads, mesh, fence=fence, compress=compress,
                error_state=state["error"], n_buckets=n_buckets)
            return synced

        return sync_process

    def sync(grads):
        synced, _err = grad_sync(
            grads, data_dim=axes.index("data"),
            pod_dim=axes.index("pod") if "pod" in axes else None,
            fence=fence, compress=compress, n_buckets=n_buckets,
            lead=len(axes))
        return synced

    return sync


def grad_sync_process(grads, mesh, *, fence: str = "global",
                      compress: str = "none", error_state=None,
                      n_buckets: int = 4):
    """:func:`grad_sync` on one rank of a process mesh.  Returns
    (synced_grads, new_error_state): each leaf in float32, the mean over
    the ``data`` ranks (an all-reduce of the sum, divided by their number),
    then over ``pod`` where the mesh has it — with ``compress="int8ef"``
    :func:`repro_torch.optim.compression.int8_ef_allreduce_process` there,
    whose residual stays on the rank.  Buckets and fences as in
    :func:`grad_sync`."""
    has_pod = "pod" in mesh.axis_names
    flat = list(leaves(grads))
    err = (list(leaves(error_state)) if error_state is not None
           else [None] * len(flat))
    out = [None] * len(flat)
    new_err = [None] * len(flat)
    pending = AckKey.empty()
    for bucket in _bucketize(len(flat), n_buckets):
        if fence == "global" and pending.tokens:
            gate = [flat[i] for i in bucket]
            gate = join(pending, *gate) if len(gate) > 1 else \
                [join(pending, gate[0])]
            for j, i in enumerate(bucket):
                flat[i] = gate[j]
        bucket_ack = AckKey.empty()
        for i in bucket:
            g = pmean(flat[i].float(), mesh, "data")
            if has_pod:
                if compress == "int8ef":
                    g, new_err[i] = C.int8_ef_allreduce_process(
                        g, mesh, "pod", err[i])
                else:
                    g = pmean(g, mesh, "pod")
            out[i] = g
            bucket_ack = bucket_ack | AckKey([g])
        pending = bucket_ack if fence == "pair" else (pending | bucket_ack)
    synced = unflatten(grads, out)
    err_tree = unflatten(grads, new_err) if compress == "int8ef" else None
    return synced, err_tree


# ------------------------------------------------- process-group collectives
_OPS = ("all_reduce", "all_gather_into_tensor", "all_to_all_single")


def transport(mesh, op: str, x) -> str:
    """How ``op`` moves ``x`` between ``mesh``'s ranks: "native" (the
    backend takes the tensor where it lies) or "host" (gloo with a card
    tensor: copied to host memory and back)."""
    if mesh.backend != "gloo" or x.device.type == "cpu":
        return "native"
    return getattr(mesh, "transports", {}).get(op, "host")


def probe_transports(mesh) -> dict:
    """Ask gloo, on a few elements of card memory, which collectives take
    card tensors; record "native" for those and "host" for the others on
    ``mesh.transports``, and return it.  Each collective is asked on the
    whole world and on the dp axes' group, and is "native" only where both
    take it.  Every rank must call it at the
    same point (each collective is one).  Other backends and CPU meshes
    need no probe: every collective is "native" there."""
    import torch.distributed as dist
    mesh.transports = dict.fromkeys(_OPS, "native")
    if mesh.backend != "gloo" or mesh.device.type == "cpu":
        return mesh.transports
    groups = [None]
    if mesh.axis_size(DP) > 1:
        groups.append(mesh.group(DP))
    for group in groups:
        n = dist.get_world_size(group)
        x = torch.ones(n, device=mesh.device)
        calls = {"all_reduce": lambda: dist.all_reduce(x.clone(),
                                                       group=group),
                 "all_gather_into_tensor":
                     lambda: dist.all_gather_into_tensor(
                         x.new_empty(n * n), x, group=group),
                 "all_to_all_single": lambda: dist.all_to_all_single(
                     torch.empty_like(x), x, group=group)}
        for op, call in calls.items():
            try:
                call()
                torch.cuda.synchronize(mesh.device)
            except (RuntimeError, ValueError, NotImplementedError):
                mesh.transports[op] = "host"
    return mesh.transports


def _run(mesh, op: str, fn, out, *inputs):
    """``fn(out, *inputs)`` where they lie, or on host copies (copying the
    result back into ``out``)."""
    if transport(mesh, op, out) == "native":
        fn(out, *inputs)
        return out
    host = out.cpu()
    fn(host, *(t.cpu() for t in inputs))
    return out.copy_(host)


def _trivial(mesh, axis) -> bool:
    return mesh is None or mesh.axis_size(axis) == 1


def _graded(x) -> bool:
    """Whether autograd follows ``x`` here (the collective then goes
    through its Function)."""
    return torch.is_grad_enabled() and x.requires_grad


def _low(x) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


def _all_reduce(x, mesh, axis, op=None):
    """A new tensor: ``x`` reduced (sum, or ``op``) over ``axis``; a bf16 or
    fp16 ``x`` summed in float32 and rounded once."""
    import torch.distributed as dist
    op = dist.ReduceOp.SUM if op is None else op
    y = x.float() if _low(x) else x.clone(
        memory_format=torch.contiguous_format)
    _run(mesh, "all_reduce",
         lambda o: dist.all_reduce(o, op=op, group=mesh.group(axis)), y)
    return y.to(x.dtype) if _low(x) else y


def _gather(x, mesh, axis, dim):
    """The ranks' ``x`` concatenated on ``dim`` in coordinate order, laid
    out contiguous (row-major), as the whole tensor is: the ops that read
    it then take the whole tensor's path, bit for bit."""
    import torch.distributed as dist
    n = mesh.axis_size(axis)
    xc = x.movedim(dim, 0).contiguous()
    out = xc.new_empty((n * xc.shape[0], *xc.shape[1:]))
    _run(mesh, "all_gather_into_tensor",
         lambda o, i: dist.all_gather_into_tensor(o, i,
                                                  group=mesh.group(axis)),
         out, xc)
    return out.movedim(0, dim).contiguous()


def _own(x, mesh, axis, dim):
    """This rank's slice of ``x`` along ``dim``: block ``coord(axis)`` of
    ``axis``'s size equal blocks (a view)."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis!r} of {n}")
    w = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axis) * w, w)


def _reduce_scatter(x, mesh, axis, dim):
    """This rank's block along ``dim`` of the sum over ``axis`` (bf16 and
    fp16 summed in float32, rounded once): an all-reduce, then the rank's
    own block, on every backend."""
    return _own(_all_reduce(x, mesh, axis), mesh, axis, dim).contiguous()


def _a2a(x, mesh, axis):
    import torch.distributed as dist
    xc = x.contiguous()
    out = torch.empty_like(xc)
    _run(mesh, "all_to_all_single",
         lambda o, i: dist.all_to_all_single(o, i, group=mesh.group(axis)),
         out, xc)
    return out


class _Psum(torch.autograd.Function):
    """A row-parallel sum: all-reduce forward, the gradient passed through
    (every rank's output feeds the same downstream value)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """A column-parallel layer's input: the identity forward, the ranks'
    partial input gradients summed backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """All-gather forward; the rank's own slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Slice(torch.autograd.Function):
    """The rank's slice forward; the slices' gradients gathered
    backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of blocks over the leading dim: its own adjoint."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axis), None, None


class _GatherParam(torch.autograd.Function):
    """fsdp's gather of a parameter shard: all-gather forward, the whole
    gradient reduce-scattered (summed) back to the shards backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _LossMean(torch.autograd.Function):
    """A loss term's mean over every rank: the all-reduced sum over the
    world's size forward; backward the gradient times ``scale`` (see
    :func:`loss_mean`)."""

    @staticmethod
    def forward(ctx, x, mesh, scale):
        ctx.scale = scale
        return _world_mean(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def reduction_axes(mesh) -> list:
    """The mesh's axes as a sum over the whole world takes them: the dp
    axes as one (pod-major), then each other axis."""
    dp = dp_axes(mesh)
    rest = [a for a in mesh.axis_names if a not in dp]
    return ([dp] if dp else []) + rest


def _world_mean(x, mesh):
    y = x
    for axis in reduction_axes(mesh):
        if not _trivial(mesh, axis):
            y = _all_reduce(y, mesh, axis)
    return y / y.new_tensor(float(mesh.size))


def psum(x, mesh, axis):
    """The sum of ``x`` over ``axis``'s ranks, on every one of them.  A
    bf16 or fp16 ``x`` is summed in float32 and rounded once.  Under
    autograd the gradient passes through (a row-parallel sum)."""
    if _trivial(mesh, axis):
        return x
    if _graded(x):
        return _Psum.apply(x, mesh, axis)
    return _all_reduce(x, mesh, axis)


def pmax(x, mesh, axis):
    """The elementwise max of ``x`` over ``axis``'s ranks (no gradient)."""
    if _trivial(mesh, axis):
        return x
    import torch.distributed as dist
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmean(x, mesh, axis):
    """The float mean of ``x`` over ``axis``'s ranks: the sum divided by a
    tensor holding their number (no gradient)."""
    if _trivial(mesh, axis):
        return x
    return _all_reduce(x, mesh, axis) / x.new_tensor(
        float(mesh.axis_size(axis)))


def psum_axes(x, mesh, axes):
    """:func:`psum` over each of ``axes`` in turn (no gradient); an entry
    may be a tuple of axes, summed over as one."""
    for axis in axes:
        if not _trivial(mesh, axis):
            x = _all_reduce(x, mesh, axis)
    return x


def all_gather(x, mesh, axis, dim: int = 0):
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
    coordinate order, on every one of them.  Under autograd each rank
    keeps its own slice of the gradient (the logits' gather over
    ``model``, the MoE block's output over S)."""
    if _trivial(mesh, axis):
        return x
    if _graded(x):
        return _Gather.apply(x, mesh, axis, dim)
    return _gather(x, mesh, axis, dim)


def all_to_all(x, mesh, axis):
    """x (P, ...), P = ``axis``'s size: block j goes to coordinate j, and
    block s of the result came from coordinate s — the reference's
    ``jax.lax.all_to_all(x, axis, 0, 0)``, its own adjoint under
    autograd."""
    if _trivial(mesh, axis):
        return x
    n = mesh.axis_size(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} of {n} takes {n} "
                         f"blocks, got {x.shape[0]}")
    if _graded(x):
        return _AllToAll.apply(x, mesh, axis)
    return _a2a(x, mesh, axis)


def reduce_scatter(x, mesh, axis, dim: int = 0):
    """This rank's block along ``dim`` of the sum of ``x`` over ``axis``
    (the ZeRO gradient's push; no gradient)."""
    if _trivial(mesh, axis):
        return x
    return _reduce_scatter(x, mesh, axis, dim)


def copy_to(x, mesh, axis):
    """``x`` itself, as the input of a layer whose weight is split over
    ``axis`` (column-parallel): under autograd the ranks' partial input
    gradients are summed over ``axis``."""
    if _trivial(mesh, axis) or not _graded(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def slice_to(x, mesh, axis, dim: int):
    """This rank's slice of ``x`` along ``dim`` over ``axis`` (a view);
    under autograd the slices' gradients are gathered back."""
    if _trivial(mesh, axis):
        return x
    if _graded(x):
        return _Slice.apply(x, mesh, axis, dim)
    return _own(x, mesh, axis, dim)


def gather_param(x, mesh, axis, dim: int):
    """A parameter shard split over ``axis`` (or a tuple of axes, pod-major)
    on ``dim``, gathered whole (fsdp); under autograd the gradient is summed over ``axis`` and each
    rank keeps its shard's block."""
    if _trivial(mesh, axis):
        return x
    if _graded(x):
        return _GatherParam.apply(x, mesh, axis, dim)
    return _gather(x, mesh, axis, dim)


def loss_mean(x, mesh, summed_over: int = 1):
    """A scalar loss term's mean over every rank of ``mesh``, the
    reference's ``pmean`` over all its axes.  Its gradient on each rank is
    scaled so that the data-parallel mean of the gradients, after the
    ``summed_over`` ranks of the model axis that see different tokens have
    their partial gradients summed, is the gradient of the world mean:
    ``n_data / world`` = 1 / ``summed_over``'s model ranks when they are
    summed, 1 when they hold the same tokens (``summed_over`` 1).  The
    identity on a world of 1."""
    if mesh is None or mesh.size == 1:
        return x
    scale = 1.0 / summed_over
    if _graded(x):
        return _LossMean.apply(x, mesh, scale)
    return _world_mean(x, mesh)
