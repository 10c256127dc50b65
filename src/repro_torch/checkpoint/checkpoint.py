"""Atomic, async checkpointing, the counterpart of
``repro/checkpoint/checkpoint.py``, with its layout:

  <dir>/step_<N>.tmp/...  →  atomic rename  →  <dir>/step_<N>/
    manifest.json       every leaf's path, file, shape and dtype, the step
    leaf_<i>.npy        one file per tree leaf

* atomic commit: readers only see fully renamed step directories, so a
  crash mid-save never corrupts the latest checkpoint;
* async save: the leaves are copied to the host before :meth:`save`
  returns (the trainer updates them in place afterwards), and a worker
  thread writes them; :meth:`wait` joins it and re-raises its error;
* ``keep_last`` garbage collection.

numpy has no bfloat16, so a bf16 leaf is written as its uint16 bits with
``"dtype": "bfloat16"`` in the manifest and viewed back on restore: every
leaf, optimizer state included, round-trips bitwise.  Reading the JAX
package's checkpoints is not a goal.

Across processes (a tree of each rank's blocks, ``shardings`` a tree of
:class:`~repro_torch.distributed.sharding.NamedSharding`): :meth:`save`
gathers each leaf whole, one leaf at a time, and the rank at coordinate 0
writes it in the same format, synchronously, before every rank passes a
barrier; :meth:`restore` reads each leaf whole and keeps the block its
sharding gives the rank, as the reference's ``device_put(arr, sh)`` does.
So a checkpoint written by one world restores onto a mesh of another
size.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import flatten, unflatten


def _host(t: torch.Tensor):
    """(numpy array of a host copy of ``t``, manifest dtype)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False,
             shardings: Any = None):
        """Copy every leaf to the host, then write them (on a worker thread
        unless ``blocking``).  With ``shardings`` (every rank of a process
        mesh calls it) each leaf is gathered whole from the ranks' blocks
        and only the rank at coordinate 0 writes, blocking; the ranks then
        meet at a barrier, so each sees the committed step."""
        self.wait()  # one in-flight save at a time
        flat = flatten(tree)
        if shardings is not None:
            self._save_gathered(step, flat, dict(flatten(shardings)))
            return
        host = [(path, *_host(leaf)) for path, leaf in flat]
        self._write(step, host, blocking)

    def _save_gathered(self, step, flat, shardings):
        import torch.distributed as dist

        from ..distributed.sharding import gather_leaf
        mesh = next(iter(shardings.values())).mesh
        writer = not any(mesh.coords.values())
        host = []
        for path, leaf in flat:
            sh = shardings[path]
            whole = gather_leaf(leaf.detach(), sh.spec, sh.mesh)
            if writer:
                host.append((path, *_host(whole)))
            del whole
        if writer:
            self._write(step, host, blocking=True)
        dist.barrier()

    def _write(self, step, host, blocking):
        def work():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for i, (path, arr, dtype) in enumerate(host):
                fname = f"leaf_{i}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append(
                    {"path": path, "file": fname, "shape": list(arr.shape),
                     "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)       # atomic commit
            self._gc()

        if blocking:
            work()
            return

        def run():
            try:
                work()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, tree_like: Any, shardings: Any = None):
        """A tree of ``tree_like``'s structure with step ``step``'s leaves,
        each on its ``tree_like`` leaf's device and in its dtype; with
        ``shardings`` each leaf the block of the whole one that its
        :class:`~repro_torch.distributed.sharding.NamedSharding` gives this
        rank (the elastic re-mesh's restore onto a new mesh)."""
        from ..distributed.sharding import shard
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        shs = dict(flatten(shardings)) if shardings is not None else None
        out = []
        for path, like in flatten(tree_like):
            entry = by_path[path]
            t = _tensor(np.load(os.path.join(d, entry["file"])),
                        entry["dtype"])
            if shs is not None:
                t = shard(t, shs[path].spec, shs[path].mesh)
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {path}: shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(like.shape)}")
            out.append(t.to(device=like.device, dtype=like.dtype))
        return unflatten(tree_like, out)
