"""ZeRO on the process binding: the optimizer's state sharded over the
data-parallel ranks, the counterpart of what the reference's
``jit_train_step`` gets from ``opt_state_pspecs`` and GSPMD.

The data-parallel axes are the mesh's of ``sharding.DP``, ``("pod",
"data")`` (:func:`~repro_torch.distributed.sharding.dp_axes`): on a
(pod, data, model) mesh every collective below runs over both as one
group, its ranks in pod-major order (the reference's ``P(("pod",
"data"))``), so a (2, 2, 1) mesh holds the blocks a (4, 1) mesh holds and
sums them in one reduction over the same four ranks.

Each rank holds its block of every parameter (the tensor-parallel layout,
and at ``zero_stage`` 3 fsdp's split over the dp axes) and runs the
backward on its own batch rows.  Then, per leaf:

* **the gradient's push**: a leaf whose moments
  :func:`~repro_torch.optim.optimizer.opt_state_pspecs` splits over the
  dp axes on a dim z (stage ≥ 2) is reduce-scattered there, so the rank
  receives its block of the dp sum; an fsdp leaf arrives summed already
  (its gather's backward reduce-scatters); any other leaf is all-reduced.
  The sum is taken in float32, divided by the dp ranks' number and
  rounded once to the gradient's dtype: the dp mean;
* **the update**: the one-device optimizer
  (:func:`~repro_torch.optim.optimizer.make_optimizer`) runs on the
  rank's blocks — the parameter's block a view of its whole local tensor,
  the moments block-shaped — with two hooks: the clip's global norm sums
  each block's squares over the ranks, counting a block that several
  ranks hold (replicated over ``model``, say) once; Adafactor's factor
  means over a dimension split across ranks sum over them;
* **the pull**: the updated blocks of a leaf split on z are all-gathered
  over the dp axes into the rank's whole local tensor (the reference's
  ``out_shardings`` keep parameters whole over them below stage 3).

At one dp rank every collective is the identity and the update sees the
very tensors the one-device step does, so the step is bitwise that step.

The layout of the moments is ``opt_state_pspecs`` on the port's tree,
whose stacks are lists of per-layer leaves: a per-layer leaf's moments
split on its first free dim that divides.  The reference's stacked ``(n,
…)`` leaf splits on the stack's dim when ``n`` divides, so each of its
dp ranks holds whole layers' moments; the port's rank holds a block of
every layer's (the same bytes).  Adafactor's factors ``vr`` / ``vc``
follow the rank's block of their leaf (its rows and columns), where the
reference splits them on their own first divisible dim: they are a row
and a column of the leaf, and the update needs them where the rank's
block is.  :func:`state_layout` is the layout used.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..optim.optimizer import (AdamState, FactoredState, _stacked_rows,
                               make_optimizer, opt_state_pspecs)
from ..tree import flatten, leaves, tree_map, unflatten
from . import collectives as CL
from .sharding import _axes, dp_axes, entry_axes


class ZeroPlan:
    """Per leaf of a parameter tree, by its path: its spec, the ZeRO dim
    z, and the dims its optimizer block splits over ranks.
    ``params_shape``: the whole parameters (meta tensors will do);
    ``layout``: their specs on ``mesh`` (:func:`~repro_torch.distributed.
    tensor_parallel.param_layout`).  The trees the plan later takes may
    hold their keys in another order: every lookup goes by path."""

    def __init__(self, mesh, params_shape, layout, zero_stage: int):
        self.mesh = mesh
        #: the dp axes (pod before data), taken as one in every collective
        self.dp = dp_axes(mesh)
        self.n_dp = mesh.axis_size(self.dp)
        paths = [p for p, _ in flatten(params_shape)]
        specs = _in_order(params_shape, layout)
        state = AdamState(params_shape, params_shape, torch.zeros(()))
        moment = _in_order(params_shape, opt_state_pspecs(
            state, layout, mesh, zero_stage).mu)
        self.spec, self.z, self.fsdp, self.splits = {}, {}, {}, {}
        self.replicated = {}
        for path, t, spec, mspec in zip(paths, leaves(params_shape), specs,
                                        moment):
            spec = spec + (None,) * (t.dim() - len(spec))
            mspec = mspec + (None,) * (t.dim() - len(mspec))
            z = next((i for i, (a, b) in enumerate(zip(spec, mspec))
                      if a is None and b is not None), None)
            block = list(spec)
            if z is not None:
                block[z] = _axes(self.dp)
            splits = {i - t.dim(): tuple(a for a in entry_axes(e)
                                         if mesh.shape[a] > 1)
                      for i, e in enumerate(block)
                      if any(mesh.shape[a] > 1 for a in entry_axes(e))}
            self.spec[path], self.z[path] = tuple(block), z
            self.fsdp[path] = any(set(self.dp) & set(entry_axes(e))
                                  for e in spec)
            self.splits[path] = splits
            self.replicated[path] = tuple(
                a for a in mesh.axis_names if mesh.shape[a] > 1 and
                not any(a in ax for ax in splits.values()))
        self.order: List[str] = paths

    def specs_of(self, tree) -> list:
        """The block spec of each leaf of ``tree``, in its order."""
        return [self.spec[p] for p, _ in flatten(tree)]

    # ------------------------------------------------------------- blocks
    def _mean_dp(self, g, reduced):
        if self.n_dp == 1:
            return g
        return (reduced / reduced.new_tensor(float(self.n_dp))).to(g.dtype)

    def grad_blocks(self, grads) -> List[torch.Tensor]:
        """Each leaf's block of the dp-mean gradient (the push)."""
        out = []
        for path, g in flatten(grads):
            z = self.z[path]
            if self.n_dp == 1:
                out.append(g)
            elif self.fsdp[path]:
                out.append(self._mean_dp(g, g.float()))
            elif z is not None:
                out.append(self._mean_dp(g, CL.reduce_scatter(
                    g.float(), self.mesh, self.dp, z)))
            else:
                out.append(self._mean_dp(g, CL.psum(g.float(), self.mesh,
                                                    self.dp)))
        return out

    def param_blocks(self, params) -> List[torch.Tensor]:
        """Each leaf's block the rank updates: a view of its local
        tensor."""
        out = []
        for path, p in flatten(params):
            z = self.z[path]
            out.append(CL._own(p, self.mesh, self.dp, z)
                       if z is not None and self.n_dp > 1 else p)
        return out

    def pull(self, params, blocks) -> None:
        """The updated blocks gathered over the dp axes into each leaf."""
        for (path, p), b in zip(flatten(params), blocks):
            z = self.z[path]
            if z is not None and self.n_dp > 1:
                p.copy_(CL.all_gather(b, self.mesh, self.dp, z))

    # -------------------------------------------------------------- hooks
    def norm(self, grads) -> torch.Tensor:
        """The global norm of the gradient blocks: each block's float32
        sum of squares, a block several ranks hold counted on the one at
        coordinate 0 of those axes, summed in leaf order and then over
        every axis (the dp axes as one)."""
        total = None
        for path, x in flatten(grads):
            if any(self.mesh.coord(a) for a in self.replicated[path]):
                continue
            s = x.float().square().sum()
            total = s if total is None else total + s
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=self.mesh.device)
        return CL.psum_axes(total, self.mesh,
                            CL.reduction_axes(self.mesh)).sqrt()

    def means(self, i: int):
        """Leaf i's (of :attr:`order`) mean for Adafactor's factors:
        ``x.mean(dim)`` where the leaf's dim is whole on the rank, else the
        sum over the ranks that split it (one reduction over their axes)
        over the whole length."""
        splits = self.splits[self.order[i]]

        def mean(x, dim, leaf_dim, keepdim=False):
            axes = splits.get(leaf_dim)
            if not axes:
                return x.mean(dim, keepdim=keepdim)
            n = x.shape[dim] * math.prod(self.mesh.shape[a] for a in axes)
            s = CL.psum_axes(x.sum(dim, keepdim=keepdim), self.mesh, [axes])
            return s / s.new_tensor(float(n))

        return mean


def _in_order(tree, specs) -> list:
    """``specs``' entries in ``tree``'s leaf order (a spec is a tuple, so
    the walk follows ``tree``)."""
    out = []
    tree_map(lambda _t, s: out.append(tuple(s)), tree, specs)
    return out


class ZeroOptimizer:
    """``make_optimizer(tcfg, stacks)`` on the rank's ZeRO blocks:
    ``init(params)`` and ``update(grads, state, params)`` as the
    one-device optimizer's (parameters updated in place), ``plan`` its
    :class:`ZeroPlan`."""

    def __init__(self, tcfg, stacks, plan: ZeroPlan):
        self.plan = plan
        self.base = make_optimizer(tcfg, stacks, norm_fn=plan.norm,
                                   means=plan.means)

    def init(self, params):
        return self.base.init(unflatten(params,
                                        self.plan.param_blocks(params)))

    @torch.no_grad()
    def update(self, grads, state, params):
        self.plan.order = [p for p, _ in flatten(params)]
        blocks = self.plan.param_blocks(params)
        _p, state, stats = self.base.update(
            unflatten(params, self.plan.grad_blocks(grads)), state,
            unflatten(params, blocks))
        self.plan.pull(params, blocks)
        return params, state, stats


def state_layout(state, params, plan: ZeroPlan, stacks=()):
    """The spec tree of a :class:`ZeroOptimizer`'s state: the moments by
    each leaf's block spec, ``count`` replicated; Adafactor's ``vr`` /
    ``vc`` by the rows / columns of the block (a stacked per-layer vector's
    ``vr`` replicated, its ``vc`` the vector's spec; an unfactored leaf's
    ``vr`` its spec, ``vc`` replicated)."""
    specs = plan.specs_of(params)
    mu = unflatten(params, specs)
    if isinstance(state, AdamState):
        return AdamState(mu, unflatten(params, specs), ())
    if not isinstance(state, FactoredState):
        raise TypeError(type(state))
    flat = flatten(params)
    rows = _stacked_rows([p for p, _ in flat], stacks)
    vr, vc = [], []
    for n, ((_path, p), spec) in enumerate(zip(flat, specs)):
        stacked = n in rows
        if p.dim() + stacked < 2:
            vr.append(spec)
            vc.append((None,))
        elif p.dim() == 1:
            vr.append(())
            vc.append(spec)
        else:
            vr.append(spec[:-1])
            vc.append(spec[:-2] + spec[-1:])
    return FactoredState(mu, unflatten(params, vr), unflatten(params, vc),
                         ())


def check_blocks(what: str, got, full, layout, mesh) -> None:
    """Raise ``ValueError`` unless every leaf of ``got`` has the shape of
    this rank's block of ``full`` under ``layout`` (leaves matched by
    path)."""
    from .sharding import local_shape
    specs = _in_order(full, layout)
    want = {p: local_shape(t.shape, spec, mesh)
            for (p, t), spec in zip(flatten(full), specs)}
    have = {p: tuple(t.shape) for p, t in flatten(got)}
    if have != want:
        bad = sorted(p for p in set(have) | set(want)
                     if have.get(p) != want.get(p))
        raise ValueError(f"jit_train_step: this rank's {what} blocks are "
                         f"not the layout's: {bad[0]} is "
                         f"{have.get(bad[0])}, the layout's "
                         f"{want.get(bad[0])} ({len(bad)} leaves differ)")
