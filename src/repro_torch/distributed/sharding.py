"""Mesh axis names, the counterpart of the axis half of
``repro/distributed/sharding.py``.

Parallelism map (DESIGN.md §6): TP is the ``model`` axis (attention heads,
FFN columns, the experts of an MoE layer); DP is ``("pod", "data")``, the
batch.  The reference's rules from parameter paths to PartitionSpecs
(``param_pspecs``, ``batch_pspecs``, ``cache_pspecs``) shard tensors over
devices; they come with the port's ``torch.distributed`` binding (ROADMAP
item 12).  On the stacked binding a participant dimension is explicit in
each tensor that has one.
"""
from __future__ import annotations

from typing import Tuple

DP = ("pod", "data")      # flattened data-parallel axes (pod absent → data)
TP = "model"


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes ``mesh`` has, pod before data."""
    return tuple(a for a in DP if a in mesh.shape)
