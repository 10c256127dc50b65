"""Expert-parallel MoE wiring on the stacked binding, the counterpart of
``repro/distributed/moe_ep.py``.

This is the framework's clearest channel-object instantiation (DESIGN.md
§3): the dispatch buffer is a striped shared region of (expert, capacity)
slots; tokens are one-sided-written to the expert's host shard and the
results one-sided-read back — the two all-to-alls of
:func:`repro_torch.models.moe.moe_block_a2a`.  The reference binds that
per-shard math to a device mesh with ``shard_map``.  On a
:class:`~repro_torch.launch.mesh.StackedMesh` this module cuts the model's
(B, S, d) activations into the stacked (P_dp, P_tp, B_l, S_l, d) shards,
views the experts as (P_dp, P_tp, E_local, ...) without copying them, and
puts the output back together.  On a
:class:`~repro_torch.launch.mesh.ProcessMesh` each rank runs
:func:`repro_torch.models.moe.moe_block_a2a_rank` on its own tokens and
experts, the all_to_alls between the processes.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..launch.mesh import ProcessMesh
from ..models import moe as M
from ..models.layers import mlp
from . import collectives as CL
from .sharding import TP, dp_axes


def expert_views(experts: dict, n_dp: int, n_tp: int) -> dict:
    """Each (E, ...) expert leaf as the (n_dp, n_tp, E / n_tp, ...) view the
    stacked block takes: model shard j holds experts j·E/n_tp onwards, the
    reference's ``P("model", None, None)``, broadcast over the dp shards
    (``expand``, no copy), the reference's replication over the dp axes."""
    return {k: w.view(n_tp, w.shape[0] // n_tp, *w.shape[1:])
            .expand(n_dp, n_tp, *(-1,) * w.dim()) for k, w in experts.items()}


def make_moe_fn(cfg: ArchConfig, mesh):
    """Returns moe_fn(ffn_params, x, cfg) -> (out, aux) running the
    expert-parallel a2a block over ``mesh``'s shards.

    x (B, S, d) is laid out as the reference's ``x_spec``: B split over the
    dp axes where it divides, S over ``model`` where it divides, otherwise
    every shard of that axis holds the whole of it.  ``aux`` is the mean of
    the shards' load-balance losses over the whole mesh, the reference's
    ``pmean`` over every axis.  On a ``ProcessMesh`` see
    :func:`_process_moe_fn`."""
    n_tp, n_dp = mesh.shape[TP], _dp_total(mesh)
    if cfg.moe.n_experts % n_tp:
        raise ValueError(f"{cfg.name}: {cfg.moe.n_experts} experts do not "
                         f"split over a model axis of {n_tp}")
    if isinstance(mesh, ProcessMesh):
        return _process_moe_fn(cfg, mesh)

    def moe_fn(params, x, _cfg):
        B, S, d = x.shape
        split_b, split_s = B % n_dp == 0, S % n_tp == 0
        xs = x.reshape(n_dp, B // n_dp, S, d) if split_b \
            else x.expand(n_dp, B, S, d)
        if split_s:
            xs = xs.reshape(n_dp, xs.shape[1], n_tp, S // n_tp, d) \
                .transpose(1, 2)
        else:
            xs = xs.unsqueeze(1).expand(n_dp, n_tp, *xs.shape[1:])
        stacked = dict(params, experts=expert_views(params["experts"], n_dp,
                                                    n_tp))
        out, aux = M.moe_block_a2a(stacked, xs, cfg)
        # replicated axes hold equal copies: keep the first
        out = out.transpose(1, 2).reshape(n_dp, -1, S, d) if split_s \
            else out[:, 0]
        out = out.reshape(B, S, d) if split_b else out[0]
        return out, aux.mean()

    return moe_fn


def _process_moe_fn(cfg: ArchConfig, mesh: ProcessMesh):
    """moe_fn of one rank of a process mesh.  x (B, S, d) is the rank's
    batch rows (the dp split happened at the step), the same on every
    model rank.  As the reference's ``x_spec`` lays it out, the rank takes
    its slice of S where S divides over ``model`` (a prefill, a training
    step) and all of it otherwise (a decode step, S = 1); the routed
    output's slices are gathered back over ``model``.  The shared expert
    runs tensor-parallel on all of x (its columns and rows split over
    ``model``, the partial outputs summed) and is added token by token,
    after the routed output, as :func:`~repro_torch.models.moe.
    moe_block_local` adds it (inside the a2a block where S is whole).

    Under autograd the slice's backward gathers the slices' gradients and
    the output gather's keeps the rank's slice; the a2a block's two
    all_to_alls are their own adjoints.  The router is replicated over
    ``model`` but routes only the rank's slice of S, so its gradient is
    partial there: it enters through ``copy_to``, which sums that gradient
    over ``model`` (GSPMD does so for the reference unasked).

    ``aux`` is the rank's own load-balance loss: the serving steps drop it.
    Training takes its mean over the world, the reference's ``pmean`` over
    every axis, once for the whole stack: ``moe_fn.world_aux(aux, S)``
    (:func:`~repro_torch.distributed.collectives.loss_mean`, the model
    ranks' gradients summed where S was sliced)."""
    from .tensor_parallel import TensorParallel
    n_tp = mesh.shape[TP]
    tp = TensorParallel(cfg, mesh) if n_tp > 1 else None

    def split(S):
        return n_tp > 1 and S % n_tp == 0

    def moe_fn(params, x, _cfg):
        B, S, d = x.shape
        routed = params
        if split(S):
            x_l = CL.slice_to(x, mesh, TP, 1)
            routed = dict(params, router=CL.copy_to(params["router"], mesh,
                                                    TP))
        else:
            x_l = x
        def shared(xt):
            return mlp(params["shared"], xt, cfg.act, tp)

        has_shared = bool(cfg.moe.n_shared_experts)
        out, aux = M.moe_block_a2a_rank(
            routed, x_l, cfg, mesh,
            shared if has_shared and not split(S) else None)
        if split(S):
            out = CL.all_gather(out, mesh, TP, 1)
            if has_shared:
                out = (out.reshape(B * S, d) + shared(
                    x.reshape(B * S, d))).reshape(B, S, d)
        return out, aux

    def world_aux(aux, S):
        return CL.loss_mean(aux, mesh, n_tp if split(S) else 1)

    moe_fn.world_aux = world_aux
    return moe_fn


def _dp_total(mesh) -> int:
    t = 1
    for a in dp_axes(mesh):
        t *= mesh.shape[a]
    return t
