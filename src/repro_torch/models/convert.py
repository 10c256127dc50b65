"""JAX parameter trees → the port's parameters.

:func:`params_from_jax` takes the tree of ``repro.models.build_model(cfg)
.init(key)`` with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the port's dict: the same leaves under the same names, with the
reference's stacked ``StackParams.super`` (one ``(n, …)`` array per leaf)
unstacked into a per-layer list.  The parity tests use it; a run on the card
initialises its own weights there (``Model.init``) and never builds the
model on the host.
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


def params_from_jax(np_tree, device=None):
    """A dense LM's JAX parameter tree (numpy leaves) → the port's params on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    stack = np_tree["stack"]
    prefix, sup, suffix = (stack.prefix, stack.super, stack.suffix) \
        if hasattr(stack, "super") else (stack["prefix"], stack["super"],
                                         stack["suffix"])
    if prefix or suffix or len(sup) != 1:
        raise NotImplementedError("params_from_jax converts the dense plan "
                                  "([attn] × L) only")
    n = len(np.asarray(sup[0]["ln1"]["scale"]))
    layers = [_map(lambda a, i=i: _tensor(np.asarray(a)[i], dev), sup[0])
              for i in range(n)]
    return {"embed": _map(lambda a: _tensor(a, dev), np_tree["embed"]),
            "layers": layers,
            "final_norm": _map(lambda a: _tensor(a, dev),
                               np_tree["final_norm"])}
