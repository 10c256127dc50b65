"""Optimizers, the counterpart of ``repro/optim/optimizer.py``: AdamW and a
factored Adafactor-style option, with global-norm clipping.  Interface:

    opt = make_optimizer(tcfg, stacks)
    state = opt.init(params)
    params, state, stats = opt.update(grads, state, params)

The arithmetic is the reference's, per leaf in float32, the result cast to
the leaf's dtype and the moments kept in ``adam_dtype``.  Where the
reference returns new trees, the port updates the parameters, the moments
and the gradients (clipping) **in place** and returns the same trees: a
second copy of llama3.2-3b's parameters and float32 moments would not fit
beside the first on one 80 GB card.  The step count is a new 0-d tensor.

Adafactor factors a leaf's second moment when the leaf has two or more
dimensions **in the reference's layout**, where a stack of layers is one
``(n, …)`` leaf (``stacks``: the groups of ``params['layers']`` indices the
reference stacks, from ``models.model.param_stacks``).  So a per-layer
vector there (a norm's scale) is a row of an (n, d) matrix: its row factor
is the layer's, its column factor is shared by the n layers, and the port
updates the group's rows together.  A per-layer matrix factors as it would
alone.

:func:`opt_state_pspecs` is the reference's ZeRO layout of the state,
ported whole.  On the process binding the state is sharded as
:mod:`repro_torch.distributed.zero` lays it out: it hands this module's
update the rank's blocks, a global norm summed over the ranks
(``norm_fn``) and Adafactor's factor means taken over the ranks that
split a dimension (``means``); without them the arithmetic is exactly the
one-device update's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from ..configs.base import TrainConfig
from ..tree import flatten, leaves, tree_map, unflatten


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


class FactoredState(NamedTuple):
    mu: Any         # first moment
    vr: Any         # row second-moment factors
    vc: Any         # col second-moment factors
    count: torch.Tensor


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm of every leaf, accumulated in float32, as a 0-d
    tensor on the leaves' device (no host read)."""
    total = None
    for x in leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total.sqrt()


def clip_by_global_norm(grads, max_norm, norm_fn=global_norm):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``, in
    place, the factor cast to each leaf's dtype; returns (grads, norm of
    the unclipped gradients, by ``norm_fn``).  ``max_norm <= 0`` disables
    clipping (norm 0)."""
    if max_norm is None or max_norm <= 0:
        return grads, torch.zeros((), dtype=torch.float32)
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _mean(x, dim, _leaf_dim, keepdim=False):
    return x.mean(dim, keepdim=keepdim)


def make_optimizer(tcfg: TrainConfig,
                   stacks: Optional[Sequence[Sequence[int]]] = None, *,
                   norm_fn: Callable = global_norm,
                   means: Optional[Callable] = None) -> Optimizer:
    """AdamW or Adafactor by ``tcfg.optimizer``.  ``norm_fn(grads)``: the
    clip's global norm; ``means(i)``: leaf i's mean function ``(x, dim,
    leaf_dim, keepdim)`` for Adafactor's factors (``leaf_dim``: the leaf's
    dimension that ``dim`` of ``x`` runs over); by default
    :func:`global_norm` and ``x.mean(dim)``."""
    if tcfg.optimizer == "adafactor":
        return _adafactor(tcfg, stacks or [], norm_fn,
                          means or (lambda _i: _mean))
    if tcfg.optimizer != "adamw":
        raise ValueError(f"optimizer must be adamw or adafactor, got "
                         f"{tcfg.optimizer!r}")
    return _adamw(tcfg, norm_fn)


def _count(count: torch.Tensor) -> tuple:
    """The incremented step count and it as float32."""
    count = count + 1
    return count, count.to(torch.float32)


def _adamw(tcfg: TrainConfig, norm_fn=global_norm, b1=0.9, b2=0.95,
           eps=1e-8) -> Optimizer:
    mdt = getattr(torch, tcfg.adam_dtype)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=mdt,  # noqa: E731
                                  device=p.device)
        dev = leaves(params)[0].device
        return AdamState(mu=tree_map(z, params), nu=tree_map(z, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm_fn)
        count, cf = _count(state.count)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=cf.device) ** cf
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=cf.device) ** cf
        for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                              leaves(state.nu), leaves(params)):
            g = g.float()
            m2 = b1 * m.float() + (1 - b1) * g
            v2 = b2 * v.float() + (1 - b2) * g * g
            del g
            step_ = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
            m.copy_(m2)
            v.copy_(v2)
            del m2, v2
            pf = p.float()
            p.copy_(pf - tcfg.lr * (step_ + tcfg.weight_decay * pf))
        return params, AdamState(state.mu, state.nu, count), \
            {"grad_norm": gnorm}

    return Optimizer(init, update)


def _stacked_rows(paths, stacks):
    """{leaf index: (group key, row)} for the leaves under ``layers/<i>/``
    with layer i in a stack: the group key names the stack and the path
    inside the layer, the row is the layer's place in the stack."""
    where = {i: (s, row) for s, idx in enumerate(stacks)
             for row, i in enumerate(idx)}
    out = {}
    for n, path in enumerate(paths):
        parts = path.split("/")
        if len(parts) > 2 and parts[0] == "layers" \
                and int(parts[1]) in where:
            s, row = where[int(parts[1])]
            out[n] = ((s, "/".join(parts[2:])), row)
    return out


def _adafactor(tcfg: TrainConfig, stacks, norm_fn=global_norm,
               means=lambda _i: _mean, b1=0.9, decay=0.8,
               eps=1e-30) -> Optimizer:
    """Factored second moments for leaves of two or more dimensions in the
    reference's stacked layout, full ones for the rest."""
    mdt = getattr(torch, tcfg.adam_dtype)

    def layout(params):
        """Per leaf: (stacked?, factored?) and the stacked rows."""
        flat = flatten(params)
        rows = _stacked_rows([p for p, _ in flat], stacks)
        kinds = [(n in rows, leaf.dim() + (n in rows) >= 2)
                 for n, (_, leaf) in enumerate(flat)]
        return kinds, rows

    def init(params):
        kinds, _rows = layout(params)
        vr, vc = [], []
        for (_stacked, fac), p in zip(kinds, leaves(params)):
            dev = p.device
            if not fac:
                vr.append(torch.zeros(p.shape, dtype=mdt, device=dev))
                vc.append(torch.zeros((1,), dtype=mdt, device=dev))
            elif p.dim() == 1:     # a row of a stacked (n, d) leaf
                vr.append(torch.zeros((), dtype=mdt, device=dev))
                vc.append(torch.zeros(p.shape, dtype=mdt, device=dev))
            else:
                vr.append(torch.zeros(p.shape[:-1], dtype=mdt, device=dev))
                vc.append(torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=mdt, device=dev))
        return FactoredState(
            mu=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                              device=p.device), params),
            vr=unflatten(params, vr), vc=unflatten(params, vc),
            count=torch.zeros((), dtype=torch.int32,
                              device=leaves(params)[0].device))

    def step_of(g, vr, vc, fac, beta2, mean=_mean):
        """(step, vr', vc') for g in float32, the reference's arithmetic on
        one leaf of its layout (``mean``: the leaf's, see
        :func:`make_optimizer`)."""
        if fac:
            r2 = mean(g * g, -1, -1) + eps
            c2 = mean(g * g, -2, -2) + eps
            vr2 = beta2 * vr.float() + (1 - beta2) * r2
            vc2 = beta2 * vc.float() + (1 - beta2) * c2
            rfac = torch.rsqrt(vr2 / mean(vr2, -1, -2, keepdim=True))
            cfac = torch.rsqrt(vc2)
            return g * rfac[..., None] * cfac[..., None, :], vr2, vc2
        vr2 = beta2 * vr.float() + (1 - beta2) * (g * g)
        return g * torch.rsqrt(vr2 + eps), vr2, vc.float()

    def apply(step_, m, p):
        m2 = b1 * m.float() + (1 - b1) * step_
        pf = p.float()
        return pf - tcfg.lr * (m2 + tcfg.weight_decay * pf), m2

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm_fn)
        count, cf = _count(state.count)
        beta2 = 1.0 - cf ** -decay
        kinds, rows = layout(params)
        cols = zip(leaves(grads), leaves(state.mu), leaves(state.vr),
                   leaves(state.vc), leaves(params))
        groups = {}
        for n, ((stacked, fac), (g, m, vr, vc, p)) in enumerate(
                zip(kinds, cols)):
            if stacked and p.dim() == 1:
                key, row = rows[n]
                groups.setdefault(key, {})[row] = (n, g, m, vr, vc, p)
                continue
            s, vr2, vc2 = step_of(g.float(), vr, vc, fac, beta2, means(n))
            pf, m2 = apply(s, m, p)
            p.copy_(pf)
            m.copy_(m2)
            vr.copy_(vr2)
            vc.copy_(vc2)
        # each stack's per-layer vectors as the reference's (n, d) leaf: its
        # dim -1 is each vector's own, its dim -2 the stack's
        for members in groups.values():
            idx, g, m, vr, vc, p = (list(x) for x in zip(
                *(members[r] for r in sorted(members))))
            gs = torch.stack([x.float() for x in g])
            s, vr2, vc2 = step_of(gs, torch.stack(vr), vc[0], True, beta2,
                                  means(idx[0]))
            pf, m2 = apply(s, torch.stack(m), torch.stack(p))
            for i in range(len(p)):
                p[i].copy_(pf[i])
                m[i].copy_(m2[i])
                vr[i].copy_(vr2[i])
                vc[i].copy_(vc2)
        return params, FactoredState(state.mu, state.vr, state.vc, count), \
            {"grad_norm": gnorm}

    return Optimizer(init, update)


def opt_state_pspecs(state, params_pspecs, mesh, zero_stage: int):
    """ZeRO: shard moment leaves like their params, PLUS over the data axes
    on the first divisible dim (stage ≥ 2).  The count scalar is
    replicated.  The reference's function on the port's spec tuples
    (:mod:`repro_torch.distributed.sharding`): ``state`` an
    :class:`AdamState` or :class:`FactoredState` of tensors (meta ones
    will do), ``params_pspecs`` the parameters' spec tree; returns the
    state's spec tree.  Factored ``vr`` / ``vc`` leaves, whose shapes
    differ from the parameters', take the rule on a replicated spec."""
    from ..distributed.sharding import _axes, dp_axes
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= mesh.shape[a]

    def moment_spec(leaf, pspec):
        if leaf.dim() == 0:
            return ()
        dims = list(pspec) + [None] * (leaf.dim() - len(pspec))
        used = set()
        for d in dims:
            if d is None:
                continue
            used.update(d if isinstance(d, tuple) else
                        (getattr(d, "axis", d),))
        if zero_stage >= 2 and dp and not used.intersection(dp):
            for i in range(leaf.dim()):
                if dims[i] is None and leaf.shape[i] % dp_total == 0 and \
                        leaf.shape[i] > 0:
                    dims[i] = _axes(dp)
                    break
        return tuple(dims)

    if not isinstance(state, (AdamState, FactoredState)):
        raise TypeError(type(state))
    fields = {}
    for name, sub in state._asdict().items():
        if name == "count":
            fields[name] = ()
        elif name in ("mu", "nu"):
            fields[name] = tree_map(moment_spec, sub, params_pspecs)
        else:
            fields[name] = tree_map(lambda leaf: moment_spec(leaf, ()), sub)
    return type(state)(**fields)
