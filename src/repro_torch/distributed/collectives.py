"""GradChannel: LOCO-style explicit gradient synchronization on the stacked
binding, the counterpart of ``repro/distributed/collectives.py``.

The paper's claim is that upper-level systems (here: data-parallel
training) should be built FROM channel objects rather than ad-hoc
collectives.  This module is that construction:

* each participant's gradient is its register in a conceptual SST over the
  data axes: ``push`` = every owner pushes, every peer combines (a mean
  over the participant dimension on the stacked binding);
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

A gradient leaf here is stacked: its leading dimensions are the
participants (``data_dim``, ``pod_dim`` where the mesh has pods, and any
other mesh axis, such as ``model``, whose shards pass through untouched),
each participant's gradient shard after them.  Every participant leaves
with the mean over the dp dimensions.  The same channel over processes
(the reference's ``shard_map`` of ``grad_sync``) is ROADMAP item 12's
training half.

The process binding's collectives come after it: :func:`psum`,
:func:`all_gather` and :func:`all_to_all` over one named axis of a
:class:`~repro_torch.launch.mesh.ProcessMesh`, each the identity on an
axis of size 1 and when no mesh is given, so a path without a mesh runs
no collective at all.  Under gloo a tensor on the card goes
through host memory (``transport`` "host") unless :func:`probe_transports`
found that gloo takes card tensors for that collective ("native"); NCCL
always takes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.ack import AckKey, join
from ..optim import compression as C
from ..tree import leaves, unflatten


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
    ``compress="int8ef"`` an int8 error-feedback mean there, each
    participant's scale from its own shard); the error state is a tree of
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
    """Bind :func:`grad_sync` to a :class:`~repro_torch.launch.mesh.
    StackedMesh`: each leaf arrives with one leading dimension a mesh axis,
    in the mesh's order — (pod, data, model, ...) — and each participant's
    shard after them, as the reference's gradients carry their parameter
    sharding (a leaf replicated over ``model`` holds equal copies there).
    It leaves with the dp mean, as the reference's
    ``make_grad_sync_shardmap``."""
    axes = mesh.axis_names

    def sync(grads):
        synced, _err = grad_sync(
            grads, data_dim=axes.index("data"),
            pod_dim=axes.index("pod") if "pod" in axes else None,
            fence=fence, compress=compress, n_buckets=n_buckets,
            lead=len(axes))
        return synced

    return sync


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
    ``mesh.transports``, and return it.  Every rank must call it at the
    same point (each collective is one).  Other backends and CPU meshes
    need no probe: every collective is "native" there."""
    import torch.distributed as dist
    mesh.transports = dict.fromkeys(_OPS, "native")
    if mesh.backend != "gloo" or mesh.device.type == "cpu":
        return mesh.transports
    world = dist.get_world_size()
    x = torch.ones(world, device=mesh.device)
    calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 x.new_empty(world * world), x),
             "all_to_all_single": lambda: dist.all_to_all_single(
                 torch.empty_like(x), x)}
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
    return mesh is None or mesh.shape.get(axis, 1) == 1


def psum(x, mesh, axis: str):
    """The sum of ``x`` over ``axis``'s ranks, on every one of them.  A
    bf16 or fp16 ``x`` is summed in float32 and rounded once."""
    if _trivial(mesh, axis):
        return x
    import torch.distributed as dist
    low = x.dtype in (torch.bfloat16, torch.float16)
    y = x.float() if low else x.clone(memory_format=torch.contiguous_format)
    _run(mesh, "all_reduce",
         lambda o: dist.all_reduce(o, group=mesh.group(axis)), y)
    return y.to(x.dtype) if low else y


def all_gather(x, mesh, axis: str, dim: int = 0):
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
    coordinate order, on every one of them."""
    if _trivial(mesh, axis):
        return x
    import torch.distributed as dist
    n = mesh.shape[axis]
    xc = x.movedim(dim, 0).contiguous()
    out = xc.new_empty((n * xc.shape[0], *xc.shape[1:]))
    _run(mesh, "all_gather_into_tensor",
         lambda o, i: dist.all_gather_into_tensor(o, i,
                                                  group=mesh.group(axis)),
         out, xc)
    return out.movedim(0, dim)


def all_to_all(x, mesh, axis: str):
    """x (P, ...), P = ``axis``'s size: block j goes to coordinate j, and
    block s of the result came from coordinate s — the reference's
    ``jax.lax.all_to_all(x, axis, 0, 0)``."""
    if _trivial(mesh, axis):
        return x
    import torch.distributed as dist
    if x.shape[0] != mesh.shape[axis]:
        raise ValueError(f"all_to_all over {axis!r} of {mesh.shape[axis]} "
                         f"takes {mesh.shape[axis]} blocks, got "
                         f"{x.shape[0]}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    _run(mesh, "all_to_all_single",
         lambda o, i: dist.all_to_all_single(o, i, group=mesh.group(axis)),
         out, xc)
    return out
