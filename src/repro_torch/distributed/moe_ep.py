"""Expert-parallel MoE wiring on the stacked binding, the counterpart of
``repro/distributed/moe_ep.py``.

This is the framework's clearest channel-object instantiation (DESIGN.md
§3): the dispatch buffer is a striped shared region of (expert, capacity)
slots; tokens are one-sided-written to the expert's host shard and the
results one-sided-read back — the two all-to-alls of
:func:`repro_torch.models.moe.moe_block_a2a`.  The reference binds that
per-shard math to a device mesh with ``shard_map``; here the mesh is a
:class:`~repro_torch.launch.mesh.StackedMesh`, and this module cuts the
model's (B, S, d) activations into the stacked (P_dp, P_tp, B_l, S_l, d)
shards, views the experts as (P_dp, P_tp, E_local, ...) without copying
them, and puts the output back together.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..models import moe as M
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
    ``pmean`` over every axis."""
    n_tp, n_dp = mesh.shape[TP], _dp_total(mesh)
    if cfg.moe.n_experts % n_tp:
        raise ValueError(f"{cfg.name}: {cfg.moe.n_experts} experts do not "
                         f"split over a model axis of {n_tp}")

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


def _dp_total(mesh) -> int:
    t = 1
    for a in dp_axes(mesh):
        t *= mesh.shape[a]
    return t
