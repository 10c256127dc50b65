"""Train-step factory, the counterpart of ``repro/train/train_step.py`` on
one device.

``make_train_step(cfg, tcfg, device, mesh)`` returns ``(model, opt,
train_step)``; ``train_step(params, opt_state, batch)`` returns ``(params,
opt_state, metrics)`` with the model's metrics, ``loss`` and ``grad_norm``
as 0-d tensors on the device.  Gradients come from ``torch.autograd.grad``
over every parameter leaf (each is made to require grad); with
``tcfg.microbatch`` > 1 the batch is cut along its first axis and the
microbatches' gradients summed in float32, then divided, as the reference's
``_accumulated_grads`` does.  ``tcfg.fence_scope == "grads"`` puts
:func:`repro_torch.distributed.collectives.fence_grads` between the
backward and the update.  The optimizer updates the parameters and its
state in place (:mod:`repro_torch.optim.optimizer`).

With a mesh (:class:`~repro_torch.launch.mesh.StackedMesh`) the model is
:func:`build_for_mesh`'s: an MoE config with ``router_impl == "a2a"`` runs
its MoE layers expert-parallel over the mesh's stacked shards, as the
reference's ``moe_fn`` hook does.  The reference's ``make_act_fn``
(sharding constraints between sublayers) has no counterpart on one
device; its shardings, donation and ``jit_train_step`` come with the
port's ``torch.distributed`` binding (ROADMAP item 12).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, TrainConfig
from ..core.runtime import resolve_device
from ..data.pipeline import place_batch
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
    and ``mesh`` (default: none, every layer local)."""
    dev = resolve_device(device)
    model = build_for_mesh(cfg, tcfg, mesh)
    opt = make_optimizer(tcfg, param_stacks(cfg))

    def loss_and_grads(params, batch):
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

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
