"""Meshes, the counterpart of ``repro/launch/mesh.py``, in two bindings.

On the stacked binding a mesh is not a grid of devices: it is a list of
named participant dimensions (:mod:`repro_torch.core.runtime`'s stacked
form), so a tensor sharded over ``("data", "model")`` carries those two
leading dimensions on one device.  :class:`StackedMesh` answers what code
asks of a ``jax.sharding.Mesh`` — ``mesh.shape[name]`` and
``mesh.axis_names`` — and the size of a tuple of axes
(:meth:`StackedMesh.axis_size`), and nothing else.

On the process binding each rank of a ``torch.distributed`` world is one
point of the mesh and holds its own shard of every tensor.
:class:`ProcessMesh` answers the same two questions and adds what a rank's
program asks: the process group of each axis, this rank's coordinate on
it, and the device its tensors live on.  Where code names a tuple of
axes, such as the reference's flattened data-parallel axes ``("pod",
"data")`` (its ``DP``), the mesh answers for their product: one group of
the ranks that share every other coordinate, in the tuple's row-major
order (index = pod · n_data + data, as JAX's ``P(("pod", "data"))``),
the rank's index in it and its size.  It is built on
``torch.distributed.device_mesh.init_device_mesh`` after
:func:`init_distributed` has joined the world.  No DTensor is made: the
port's kernels take local tensors, and the collectives are explicit
(:mod:`repro_torch.distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Tuple

import torch

from ..core.runtime import resolve_device

#: The reference's axis names: (data, model), with pods before them; and
#: the channel layer's one participant axis.
AXES_1D = ("nodes",)
AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")

#: The device :func:`init_distributed` gave this rank, and the timeout of
#: its collectives.
_RANK_DEVICE: list = []
_TIMEOUT_S: list = []


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

    def axis_size(self, axes) -> int:
        """The size of an axis, or the product over a tuple of axes (those
        the mesh lacks count 1)."""
        return _axis_size(self.shape, axes)


def _names(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(shape, axes) -> int:
    return math.prod(shape.get(a, 1) for a in _names(axes))


def init_distributed(backend: str, world_size: int, rank: int,
                     init_method: str, device=None,
                     timeout_s: float = 300.0) -> torch.device:
    """Join a ``torch.distributed`` world of ``world_size`` ranks as
    ``rank`` (``init_method`` such as ``tcp://localhost:<port>``; nothing
    tells a program of a cluster, so the caller names it) and return the
    device this rank's tensors live on.

    ``device`` None means the card, ``cuda:<rank mod the card count>``,
    which is made the current device; with no card that raises, so the CPU
    is used only when asked for (``device="cpu"``, the gloo worlds of the
    tests).  ``backend`` is ``"nccl"`` (the cards) or ``"gloo"`` (the CPU,
    or ranks that share one card, which NCCL refuses).  A collective that
    waits longer than ``timeout_s`` raises."""
    import torch.distributed as dist
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs the card; use gloo on the "
                         "CPU")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE[:] = [dev]
    _TIMEOUT_S[:] = [timeout_s]
    return dev


def rendezvous_points(k: int) -> list:
    """``k`` addresses for worlds to come, fixed while every rank of this
    one is alive: rank 0 picks ``k`` distinct free ports on ``MASTER_ADDR``
    (localhost by default) and the others learn them in one broadcast over
    the whole world.  Every rank must call it."""
    import os

    import torch.distributed as dist

    from .world import free_port
    host = os.environ.get("MASTER_ADDR", "localhost")
    points = [None] * k
    if dist.get_rank() == 0:
        ports = []
        while len(ports) < k:
            p = free_port()
            if p not in ports:
                ports.append(p)
        points = [f"tcp://{host}:{p}" for p in ports]
    dist.broadcast_object_list(points, src=0)
    return points


def shrink_world(n: int, init_method: str) -> bool:
    """Re-form the ``torch.distributed`` world over its first ``n`` ranks:
    this rank leaves the old world without a collective on it, and ranks
    0 … n − 1 join a new one at ``init_method`` (an address that
    :func:`rendezvous_points` fixed while every rank was alive) on the
    same backend and devices.  Returns whether this rank is in it.  A rank
    ≥ n need not call it: one that died, or left without a word, holds
    no survivor up, and no collective of the new world waits on it."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    if n == world:
        return True
    if not 0 < n < world:
        raise ValueError(f"a world of {world} cannot shrink to {n}")
    backend = dist.get_backend()
    dist.destroy_process_group()
    if rank >= n:
        return False
    init_distributed(backend, n, rank, init_method, _RANK_DEVICE[0],
                     _TIMEOUT_S[0])
    return True


class ProcessMesh:
    """This rank's view of a mesh of ``torch.distributed`` ranks.

    ``ProcessMesh(n_data, n_model)`` is a (data, model) mesh,
    ``ProcessMesh(n_pod, n_data, n_model)`` a (pod, data, model) one and
    ``ProcessMesh(P)`` the channel layer's 1-D ``("nodes",)`` mesh of P
    participants (``core.runtime.make_manager(P, mesh=...)``); the
    world that :func:`init_distributed` joined must hold exactly that many
    ranks, laid out row-major (the last axis, model, varies fastest).
    ``device`` is where this rank's tensors live: the one
    :func:`init_distributed` returned.

    :meth:`group`, :meth:`coord` and :meth:`axis_size` take an axis name
    or a tuple of them.  A tuple's axes of size 1 (and those the mesh
    lacks) drop out; where one axis is left, its own group answers (so
    ``("pod", "data")`` on a (data, model) mesh, or on a mesh whose pod
    axis is 1, is the plain ``data`` group); where two or more are left,
    the group of their product, built in ``__init__`` on every rank in the
    same order (``dist.new_group`` is a collective call)."""

    def __init__(self, *sizes: int):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized() or not _RANK_DEVICE:
            raise RuntimeError("ProcessMesh needs a torch.distributed world: "
                               "call init_distributed first")
        self.sizes = tuple(int(s) for s in sizes)
        self.axis_names = {1: AXES_1D, 2: AXES_2D,
                           3: AXES_3D}.get(len(self.sizes))
        if self.axis_names is None:
            raise ValueError(f"a process mesh has 1, 2 or 3 axes, not "
                             f"{self.sizes}")
        StackedMesh(self.sizes, self.axis_names)      # the same checks
        world = dist.get_world_size()
        if math.prod(self.sizes) != world:
            raise ValueError(f"a mesh of {self.sizes} needs "
                             f"{math.prod(self.sizes)} ranks; the world has "
                             f"{world}")
        self.backend = dist.get_backend()
        self.device = _RANK_DEVICE[0]
        # the mesh's device type sets the groups' backend; the tensors'
        # device is ``self.device`` (a gloo world may hold card tensors)
        self.device_mesh = init_device_mesh(
            "cuda" if self.backend == "nccl" else "cpu", self.sizes,
            mesh_dim_names=self.axis_names)
        coords = self.device_mesh.get_coordinate()
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self._groups = {}
        if len(self.sizes) == 3 and self.sizes[0] > 1 and self.sizes[1] > 1:
            self._groups[("pod", "data")] = self._flat_group(("pod", "data"))

    def _flat_group(self, axes: Tuple[str, ...]):
        """The process group of this rank's plane along ``axes``, in their
        row-major order: every such plane's group is made, on every rank,
        in one order."""
        import itertools

        import torch.distributed as dist
        rest = [a for a in self.axis_names if a not in axes]
        strides = {a: math.prod(self.sizes[j + 1:])
                   for j, a in enumerate(self.axis_names)}
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            base = sum(c * strides[a] for a, c in zip(rest, fixed))
            ranks = [base + sum(c * strides[a] for a, c in zip(axes, pt))
                     for pt in itertools.product(*(range(self.shape[a])
                                                   for a in axes))]
            g = dist.new_group(ranks)
            if all(self.coords[a] == c for a, c in zip(rest, fixed)):
                mine = g
        return mine

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.sizes)

    def axis_size(self, axes) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        return _axis_size(self.shape, axes)

    def group(self, axes):
        """The process group of this rank's line along ``axes`` (a name or
        a tuple of names): the ranks that differ from it in those
        coordinates alone, in their row-major order."""
        live = tuple(a for a in _names(axes) if self.shape.get(a, 1) > 1)
        if len(live) > 1:
            if live not in self._groups:
                raise ValueError(f"no process group over {live}")
            return self._groups[live]
        if not live:          # every axis of size 1: this rank's own line
            live = tuple(a for a in _names(axes) if a in self.shape)
        return self.device_mesh.get_group(live[0])

    def coord(self, axes) -> int:
        """This rank's coordinate on an axis, or its index in the
        row-major order of a tuple of axes (those the mesh lacks count
        as axes of 1)."""
        if isinstance(axes, str):
            return self.coords[axes]
        index = 0
        for a in _names(axes):
            index = index * self.shape.get(a, 1) + self.coords.get(a, 0)
        return index


def make_production_mesh(*, multi_pod: bool = False, dp: int = 16,
                         tp: int = 16) -> StackedMesh:
    """Single pod: (data=dp, model=tp), dp·tp = 256 participants (default
    16×16).  Multi-pod: (pod=2, data=dp, model=tp) = 512.  Over processes
    the same mesh is ``ProcessMesh(dp, tp)`` (``ProcessMesh(2, dp, tp)``)."""
    assert dp * tp == 256, (dp, tp)
    if multi_pod:
        return StackedMesh((2, dp, tp), AXES_3D)
    return StackedMesh((dp, tp), AXES_2D)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> StackedMesh:
    """A small (data, model) mesh; over processes ``ProcessMesh(n_data,
    n_model)``."""
    return StackedMesh((n_data, n_model), AXES_2D)
