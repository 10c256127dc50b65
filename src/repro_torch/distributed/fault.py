"""Fault tolerance and elasticity, the counterpart of
``repro/distributed/fault.py`` (numpy only; copied, not imported).

* **Failure model**: a data-parallel slice drops out, injected as
  :class:`DeviceFailure`.
* **Elastic re-mesh**: channel membership is a constructor argument (the
  paper's ``expect_num``) — recovery = rebuild the step on the next smaller
  mesh, restore the last checkpoint into the new state, replay the data
  pipeline from the restored step (the pipeline is a pure function of the
  step).  On the stacked binding a mesh is a
  :class:`~repro_torch.launch.mesh.StackedMesh`; on the process binding a
  :class:`~repro_torch.launch.mesh.ProcessMesh`, the world shrunk to the
  smaller mesh (:func:`~repro_torch.launch.mesh.shrink_world`: the ranks
  outside it leave, and the survivors meet at an address fixed while the
  whole world was alive, so a rank that died holds them up in no
  collective) and the checkpoint restored onto its shardings
  (``shardings_fn``).
* **Crash schedules** for the channel layer: :class:`FaultPlan`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..launch.mesh import ProcessMesh, StackedMesh


class DeviceFailure(RuntimeError):
    """Injected/observed loss of a mesh slice."""

    def __init__(self, failed_slice: int, msg: str = ""):
        super().__init__(msg or f"lost data slice {failed_slice}")
        self.failed_slice = failed_slice


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which participant dies (and possibly revives) at which mutation
    window (DESIGN.md §12, §13).

    ``kills`` maps participant id → the window index *before* which it
    crashes: it never serves that window, its publishes are suppressed, its
    consumer cursor freezes and its heartbeats stop — the plan only silences
    the victim; the :class:`~repro_torch.core.FailureDetector` discovers the
    death from the stalled heartbeat column.  ``revives`` maps participant id
    → the window at which it comes back (the rejoin protocol of §13.3 decides
    snapshot or replay).  A plan is immutable and reusable."""
    kills: "dict[int, int]" = dataclasses.field(default_factory=dict)
    revives: "dict[int, int]" = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "kills",
                           {int(p): int(w) for p, w in self.kills.items()})
        object.__setattr__(self, "revives",
                           {int(p): int(w) for p, w in self.revives.items()})
        for p, w in self.revives.items():
            if p not in self.kills:
                raise ValueError(f"revive for never-killed participant {p}")
            if w <= self.kills[p]:
                raise ValueError(
                    f"participant {p} revives at window {w} but dies at "
                    f"{self.kills[p]} — revive must come after the kill")

    def dead_at(self, window: int) -> set:
        """Participants crashed while window ``window`` is served: kill
        window ≤ ``window`` and not (yet) revived."""
        return {p for p, w in self.kills.items()
                if w <= window and not (
                    p in self.revives and self.revives[p] <= window)}

    def alive_mask(self, P: int, window: int) -> np.ndarray:
        """(P,) bool — False for every participant dead while window
        ``window`` is served."""
        dead = self.dead_at(window)
        return np.asarray([p not in dead for p in range(P)], bool)

    def newly_dead(self, window: int) -> list:
        """Participants whose crash lands exactly before ``window``."""
        return sorted(p for p, w in self.kills.items() if w == window)

    def newly_alive(self, window: int) -> list:
        """Participants whose revival lands exactly at ``window``."""
        return sorted(p for p, w in self.revives.items() if w == window)

    def device_failures(self) -> dict:
        """An ``inject_failure_at``-shaped dict (step → True) for the
        training tier's elastic recovery; a fresh dict per call."""
        return {int(w): True for w in self.kills.values()}


@dataclasses.dataclass
class ElasticMeshSpec:
    """Allowed degraded configurations, largest first.

    e.g. shapes=[(4, 2), (2, 2), (1, 2)] with axis_names=('data', 'model'):
    lose half the data slices twice before giving up.

    ``binding``: ``"stacked"`` (a :class:`StackedMesh` a level) or
    ``"process"`` (a :class:`ProcessMesh` over the ``torch.distributed``
    world, which :meth:`mesh_for` shrinks to the level's size first).  On
    the process binding the first call, which every rank of the whole
    world makes, fixes each level's address
    (:func:`~repro_torch.launch.mesh.rendezvous_points`); a later level
    then needs only its own ranks: the first ``prod(shape)`` of the world,
    in rank order.
    """
    shapes: Sequence[tuple]
    axis_names: tuple
    binding: str = "stacked"
    _points: list = dataclasses.field(default_factory=list, init=False,
                                      repr=False)

    def mesh_for(self, level: int):
        """The level's mesh; on the process binding None on a rank that
        the smaller world leaves out."""
        shape = tuple(self.shapes[level])
        if self.binding == "stacked":
            return StackedMesh(shape, tuple(self.axis_names))
        from ..launch.mesh import rendezvous_points, shrink_world
        if not self._points:
            self._points = rendezvous_points(len(self.shapes))
        if not shrink_world(int(np.prod(shape)), self._points[level]):
            return None
        mesh = ProcessMesh(*shape)
        if mesh.axis_names != tuple(self.axis_names):
            raise ValueError(f"a process mesh of {shape} has axes "
                             f"{mesh.axis_names}, not {self.axis_names}")
        return mesh

    @property
    def levels(self) -> int:
        return len(self.shapes)


def run_elastic(spec: ElasticMeshSpec, build: Callable, ckpt,
                total_steps: int, get_batch: Callable,
                inject_failure_at: Optional[dict] = None,
                log: Callable = print):
    """Train with elastic recovery.

    build(mesh) → (state, step_fn, shardings_fn) where step_fn(state, batch)
    → (state, metrics).  A checkpoint restores into the freshly built state
    (each leaf on that state's device and in its dtype) through
    ``shardings_fn(mesh)``: None on the stacked binding, where every leaf
    is whole; on the process binding the tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` that cuts
    each rank's block (``ckpt.restore(step, state, shardings_fn(mesh))``,
    the reference's restore onto the new mesh).  On a
    :class:`DeviceFailure` the next level's mesh is built; on the process
    binding the ranks outside it leave, returning (None, their history);
    they may also die or go without a word, since the survivors re-form
    the world without them.
    ``inject_failure_at``: {step: True} test hook, read from a copy so the
    caller's plan is reusable.  Returns (state, history of (step,
    level)).
    """
    level = 0
    history: List[tuple] = []
    # consume a private copy: the schedule is drained below (pop marks a
    # failure delivered), and draining the caller's dict would make a
    # fault plan single-use
    inject_failure_at = dict(inject_failure_at or {})
    mesh = spec.mesh_for(level)
    state, step_fn, shard_fn = build(mesh)
    step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, state, shard_fn(mesh))
        step = latest + 1
        log(f"[elastic] restored step {latest}")
    while step < total_steps:
        try:
            if inject_failure_at and inject_failure_at.pop(step, False):
                raise DeviceFailure(0, f"injected at step {step}")
            state, _metrics = step_fn(state, get_batch(step))
            history.append((step, level))
            step += 1
        except DeviceFailure as e:
            if level + 1 >= spec.levels:
                raise RuntimeError("no smaller mesh left") from e
            level += 1
            log(f"[elastic] {e}; re-meshing to level {level} "
                f"{spec.shapes[level]}")
            del state, step_fn
            mesh = spec.mesh_for(level)
            if mesh is None:
                log(f"[elastic] this rank is outside the level-{level} "
                    f"mesh; it leaves")
                return None, history
            state, step_fn, shard_fn = build(mesh)
            latest = ckpt.latest_step()
            if latest is not None:
                state = ckpt.restore(latest, state, shard_fn(mesh))
                step = latest + 1
            else:
                step = 0
    return state, history
