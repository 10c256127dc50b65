"""JAX parameter trees → the port's parameters.

:func:`params_from_jax` takes the tree of ``repro.models.build_model(cfg)
.init(key)`` with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the port's dict: the same leaves under the same names, with stacked
layers unstacked into the port's per-layer list —

* the LM family's ``StackParams``: its prefix, then superblock i's
  positions 0 … period−1 for every i (each position one ``(n, …)`` array
  per leaf), then its suffix — the reference's layer order, as
  ``transformer.layer_kinds`` lists it; an MoE layer's ``ffn`` subtree
  (``router`` in float32, ``experts`` of ``(E, d, f)`` leaves, ``shared``)
  comes across like any other;
* rwkv6's ``{"ln0", "blocks": (L, …)}``: ``ln0`` at the top level and the
  blocks as ``layers``;
* deepseek-v3's ``mtp`` subtree (``proj``, ``norm_h``, ``norm_e`` and one
  unstacked ``mla_dense`` block) as it is; MLA layers' ``attn`` leaves
  (``wq_a``, ``q_a_norm``, ``wq_b``, ``wkv_a``, ``kv_a_norm``, ``wkv_b``,
  ``wo``) keep their names.

The parity tests use it; a run on the card initialises its own weights
there (``Model.init``) and never builds the model on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.runtime import resolve_device


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: no numpy→torch path
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) \
        if isinstance(tree, dict) else tree


def _unstack(stacked, dev):
    """One ``(n, …)``-leaved dict → n per-layer dicts."""
    n = len(np.asarray(_first_leaf(stacked)))
    return [_map(lambda a, i=i: _tensor(np.asarray(a)[i], dev), stacked)
            for i in range(n)]


def params_from_jax(np_tree, device=None):
    """A JAX LM or rwkv6 parameter tree (numpy leaves) → the port's params
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    out = {k: _map(lambda a: _tensor(a, dev), np_tree[k])
           for k in ("embed", "final_norm", "mtp") if k in np_tree}
    stack = np_tree["stack"]
    if isinstance(stack, dict) and "blocks" in stack:          # rwkv6
        out["ln0"] = _map(lambda a: _tensor(a, dev), stack["ln0"])
        out["layers"] = _unstack(stack["blocks"], dev)
        return out
    prefix, sup, suffix = (stack.prefix, stack.super, stack.suffix) \
        if hasattr(stack, "super") else (stack["prefix"], stack["super"],
                                         stack["suffix"])
    per_position = [_unstack(s, dev) for s in sup]
    out["layers"] = [_map(lambda a: _tensor(a, dev), p) for p in prefix] \
        + [layer for group in zip(*per_position) for layer in group] \
        + [_map(lambda a: _tensor(a, dev), p) for p in suffix]
    return out
