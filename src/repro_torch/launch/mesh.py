"""Meshes on the stacked binding, the counterpart of
``repro/launch/mesh.py``.

On one card a mesh is not a grid of devices: it is a list of named
participant dimensions (:mod:`repro_torch.core.runtime`'s stacked form), so
a tensor sharded over ``("data", "model")`` carries those two leading
dimensions on the one device.  :class:`StackedMesh` answers what code asks
of a ``jax.sharding.Mesh`` — ``mesh.shape[name]`` and ``mesh.axis_names``
— and nothing else.  Meshes of devices come with the port's
``torch.distributed`` binding (ROADMAP item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class StackedMesh:
    """Participant dimensions ``sizes`` named ``axis_names``, in order."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.sizes) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axis names "
                             f"{self.axis_names} do not pair up")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes {self.sizes} must be positive")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False, dp: int = 16,
                         tp: int = 16) -> StackedMesh:
    """Single pod: (data=dp, model=tp), dp·tp = 256 participants (default
    16×16).  Multi-pod: (pod=2, data=dp, model=tp) = 512."""
    assert dp * tp == 256, (dp, tp)
    if multi_pod:
        return StackedMesh((2, dp, tp), ("pod", "data", "model"))
    return StackedMesh((dp, tp), ("data", "model"))


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> StackedMesh:
    """A small (data, model) mesh."""
    return StackedMesh((n_data, n_model), ("data", "model"))
