"""Train-step factory, the counterpart of ``repro/train/train_step.py``.

``make_train_step(cfg, tcfg, device, mesh)`` returns ``(model, opt,
train_step)`` on one device (no mesh, or a
:class:`~repro_torch.launch.mesh.StackedMesh`) and the reference's four
values ``(model, opt, train_step, jit_train_step)`` on a
:class:`~repro_torch.launch.mesh.ProcessMesh`.
``train_step(params, opt_state, batch)`` returns ``(params, opt_state,
metrics)`` with the model's metrics, ``loss`` and ``grad_norm`` as 0-d
tensors on the device.  Gradients come from ``torch.autograd.grad``
over every parameter leaf (each is made to require grad); with
``tcfg.microbatch`` > 1 the batch is cut along its first axis and the
microbatches' gradients summed in float32, then divided, as the reference's
``_accumulated_grads`` does.  ``tcfg.fence_scope == "grads"`` puts
:func:`repro_torch.distributed.collectives.fence_grads` between the
backward and the update.  The optimizer updates the parameters and its
state in place (:mod:`repro_torch.optim.optimizer`).

With a :class:`~repro_torch.launch.mesh.StackedMesh` the model is
:func:`build_for_mesh`'s: an MoE config with ``router_impl == "a2a"`` runs
its MoE layers expert-parallel over the mesh's stacked shards, as the
reference's ``moe_fn`` hook does.

With a :class:`~repro_torch.launch.mesh.ProcessMesh` each rank of the
world trains its blocks, the collectives between processes, as the
reference's ``jit_train_step`` partitions its step (shardings of its
``:108-126``):

* parameters by ``param_pspecs`` through the whole-head
  ``tensor_parallel.param_layout``, with fsdp's split over the dp axes
  at ``zero_stage`` 3; ``model.init(generator)`` draws the rank's blocks;
* the dense and GQA MoE layers tensor- and expert-parallel over
  ``model``, differentiated through the collectives' adjoints
  (:mod:`repro_torch.distributed.collectives`); at stage 3 each layer's
  dp-sharded leaves are gathered inside its ``remat`` region, so they
  are freed after it and gathered again in its backward, and their
  gradients reduce-scattered back to the shards — in every family, the
  encoder-decoder's and RWKV's layers too; the leaves outside the layers
  are gathered once a step;
* the batch by ``batch_pspecs``: ``train_step`` takes the global batch
  and keeps the rank's rows, microbatches accumulating on the rank
  before one push;
* the optimizer state by ``opt_state_pspecs`` (ZeRO at stage ≥ 2,
  :mod:`repro_torch.distributed.zero`: the dp-mean gradient
  reduce-scattered, each rank updating its block, the parameters
  all-gathered over the dp axes below stage 3).

The dp axes are ``("pod", "data")``, those the mesh has: on a (pod,
data, model) mesh the batch, ZeRO's blocks, fsdp's gathers and the
loss's mean run over both as one group, pod-major, so a (2, 2, 1) mesh
steps bit for bit as a (4, 1) mesh does.

``jit_train_step(params_shape, opt_shape, batch_shape)`` — whole shapes,
meta tensors will do; ``opt_shape`` the one-device optimizer's state of
``params_shape`` — binds the step to those layouts: the step it returns
takes the rank's batch block, and its first call checks the parameter,
state and batch blocks against them.  ``metrics`` hold the dp ranks'
mean of the loss.
:func:`state_shardings` gives the checkpoint's layouts.  At a world of 1
every collective is the identity and the step is bitwise the one-device
step.

``tcfg.zero_stage`` and ``fence_scope`` are read.  ``grad_compression``
is not, as the reference's ``make_train_step`` does not read it: the
int8 channel is :func:`~repro_torch.distributed.collectives.
make_grad_sync`.  ``act_shard`` is not: the reference's ``make_act_fn``
pins activation shardings between sublayers, which change layouts, not
values, and the port's process step keeps activations whole over
``model`` between sublayers (row-parallel outputs are summed) and split
over the dp axes by rows.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, TrainConfig
from ..core.runtime import resolve_device
from ..data.pipeline import place_batch
from ..launch.mesh import ProcessMesh
from ..models.model import build_model, param_stacks
from ..optim.optimizer import make_optimizer
from ..tree import leaves, unflatten


def build_for_mesh(cfg: ArchConfig, tcfg: TrainConfig, mesh=None):
    """The model with ``mesh``'s hooks: the expert-parallel MoE block for an
    MoE config with ``router_impl == "a2a"`` when a mesh is given."""
    moe_fn = None
    if mesh is not None and cfg.moe is not None and \
            cfg.moe.router_impl == "a2a":
        from ..distributed.moe_ep import make_moe_fn
        moe_fn = make_moe_fn(cfg, mesh)
    return build_model(cfg, remat=tcfg.remat, xent_chunks=tcfg.xent_chunks,
                       moe_fn=moe_fn)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device=None,
                    mesh=None):
    """Returns (model, opt, train_step) for ``device`` (default: the card)
    and ``mesh`` (default: none, every layer local); on a
    :class:`~repro_torch.launch.mesh.ProcessMesh` (its own device) the
    reference's (model, opt, train_step, jit_train_step)."""
    if isinstance(mesh, ProcessMesh):
        return _process_train_step(cfg, tcfg, mesh)
    dev = resolve_device(device)
    model = build_for_mesh(cfg, tcfg, mesh)
    opt = make_optimizer(tcfg, param_stacks(cfg))
    loss_and_grads = _loss_and_grads(model)

    def train_step(params, opt_state, batch):
        batch = place_batch(batch, dev)
        if tcfg.microbatch and tcfg.microbatch > 1:
            grads, loss, metrics = _accumulated_grads(
                loss_and_grads, params, batch, tcfg.microbatch)
        else:
            loss, metrics, grads = loss_and_grads(params, batch)
        if tcfg.fence_scope == "grads":
            from ..distributed.collectives import fence_grads
            grads = fence_grads(grads)
        params, opt_state, stats = opt.update(unflatten(params, grads),
                                              opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **stats)

    return model, opt, train_step


def _loss_and_grads(model):
    def loss_and_grads(params, batch):
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    return loss_and_grads


def _process_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                        mesh: ProcessMesh):
    from ..distributed import collectives as CL
    from ..distributed import sharding as SH
    from ..distributed import tensor_parallel as TPL
    from ..distributed.zero import (ZeroOptimizer, ZeroPlan, check_blocks,
                                    state_layout)
    from ..models.layers import MetaGenerator
    n_tp = mesh.shape[SH.TP]
    TPL.check_supported(cfg, n_tp, training=True)
    fsdp = tcfg.zero_stage >= 3
    full = build_model(cfg).init(MetaGenerator())
    layout = TPL.param_layout(full, cfg, mesh, fsdp)
    plan = ZeroPlan(mesh, full, layout, tcfg.zero_stage)
    stacks = param_stacks(cfg)
    opt = ZeroOptimizer(tcfg, stacks, plan)
    moe_fn = None
    if cfg.moe is not None and cfg.moe.router_impl == "a2a":
        from ..distributed.moe_ep import make_moe_fn
        moe_fn = make_moe_fn(cfg, mesh)
    tp = TPL.TensorParallel(cfg, mesh) if n_tp > 1 else None
    gather = None
    if fsdp and mesh.axis_size(SH.dp_axes(mesh)) > 1:
        gather = TPL.FsdpGather(mesh, full, layout)
    model = build_model(cfg, remat=tcfg.remat, xent_chunks=tcfg.xent_chunks,
                        moe_fn=moe_fn, tp=tp, gather=gather)
    loss_and_grads = _loss_and_grads(model)

    def init(generator: torch.Generator):
        return TPL.init_params(cfg, generator, mesh, fsdp)

    def rows(batch):
        batch = place_batch(batch, mesh.device)
        bspecs = SH.batch_pspecs(batch, mesh)
        return {k: SH.shard(v, bspecs[k], mesh).contiguous()
                for k, v in batch.items()}

    def local_grads(params, batch):
        """(loss, metrics, this rank's gradients) on its batch rows."""
        if gather is not None:
            gather.bind(params)
        if tcfg.microbatch and tcfg.microbatch > 1:
            grads, loss, metrics = _accumulated_grads(
                loss_and_grads, params, batch, tcfg.microbatch)
        else:
            loss, metrics, grads = loss_and_grads(params, batch)
        return loss, metrics, grads

    def step(params, opt_state, batch):
        loss, metrics, grads = local_grads(params, batch)
        if tcfg.fence_scope == "grads":
            from ..distributed.collectives import fence_grads
            grads = fence_grads(grads)
        params, opt_state, stats = opt.update(unflatten(params, grads),
                                              opt_state, params)
        metrics = {k: CL.pmean(v, mesh, SH.dp_axes(mesh))
                   for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, dict(metrics, **stats)

    def train_step(params, opt_state, batch):
        return step(params, opt_state, rows(batch))

    def jit_train_step(params_shape, opt_shape, batch_shape):
        want = {"params": (params_shape, layout),
                "opt_state": (opt_shape, state_layout(
                    opt_shape, params_shape, plan, stacks)),
                "batch": (batch_shape, SH.batch_pspecs(batch_shape, mesh))}
        checked = []

        def bound(params, opt_state, batch):
            batch = place_batch(batch, mesh.device)
            if not checked:
                got = {"params": params, "opt_state": opt_state,
                       "batch": batch}
                for what, (shape, lay) in want.items():
                    check_blocks(what, got[what], shape, lay, mesh)
                checked.append(True)
            return step(params, opt_state, batch)

        return bound

    model = model._replace(init=init)
    return model, opt, train_step, jit_train_step


def state_shardings(cfg: ArchConfig, tcfg: TrainConfig, mesh):
    """The layouts of a process step's ``{"params", "opt"}`` tree on
    ``mesh``, as a tree of :class:`~repro_torch.distributed.sharding.
    NamedSharding` (what ``CheckpointManager.save`` gathers by and
    ``restore`` cuts by)."""
    from ..distributed import sharding as SH
    from ..distributed import tensor_parallel as TPL
    from ..distributed.zero import ZeroPlan, state_layout
    from ..models.layers import MetaGenerator
    full = build_model(cfg).init(MetaGenerator())
    layout = TPL.param_layout(full, cfg, mesh, tcfg.zero_stage >= 3)
    plan = ZeroPlan(mesh, full, layout, tcfg.zero_stage)
    stacks = param_stacks(cfg)
    state = make_optimizer(tcfg, stacks).init(full)
    return {"params": SH.named(full, layout, mesh),
            "opt": SH.named(state, state_layout(state, full, plan, stacks),
                            mesh)}


def _accumulated_grads(loss_and_grads, params, batch, n_micro: int):
    """Gradients summed in float32 over ``n_micro`` microbatches, then
    divided by their number; the mean loss and the last microbatch's
    metrics."""
    def split(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of microbatch "
                             f"{n_micro}")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    micro = {k: split(v) for k, v in batch.items()}
    acc, loss_sum, metrics = None, None, None
    for i in range(n_micro):
        loss, metrics, grads = loss_and_grads(
            params, {k: v[i] for k, v in micro.items()})
        if acc is None:
            acc, loss_sum = [g.float() for g in grads], loss
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
            loss_sum = loss_sum + loss
        del grads
    for a in acc:
        a.div_(n_micro)
    return acc, loss_sum / n_micro, metrics
