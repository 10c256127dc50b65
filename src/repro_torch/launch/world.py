"""Worlds of processes on one host: :func:`spawn_world` starts one process
per rank (the ``spawn`` start method), joins each to a
``torch.distributed`` world over ``tcp://localhost`` with
:func:`~repro_torch.launch.mesh.init_distributed`, runs ``fn(rank,
*args)`` in it and returns every rank's result.

A rank that raises, dies or outlives the deadline fails the whole world:
the others are killed (a rank left waiting in a collective would wait for
ever) and :func:`spawn_world` raises with each failed rank's traceback.
Nothing of a world outlives the call.
"""
from __future__ import annotations

import multiprocessing as mp
import socket
import tempfile
import time
import traceback
from pathlib import Path


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, world, backend, device, port, out, timeout_s):
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed
    try:
        init_distributed(backend, world, rank, f"tcp://localhost:{port}",
                         device, timeout_s)
        result = fn(rank, *args)
        torch.save(result, out / f"rank{rank}.pt")
        if dist.is_initialized():   # a rank that left a shrunk world is not
            dist.barrier()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world_size: int, *, backend: str = "nccl",
                device=None, args=(), timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` on each rank of a new world of
    ``world_size`` processes; returns the ranks' results in rank order.

    ``fn`` must be importable by name (a module's function: ``spawn``
    pickles it by reference).  ``device``: the ranks' device, None for the
    card (rank r on card r mod the card count) or ``"cpu"``.  Each rank's collectives
    time out after ``timeout_s``, and the world after ``timeout_s`` in all;
    a timeout, a raise or an exit other than 0 in any rank raises
    ``RuntimeError`` here."""
    import torch
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        out = Path(tmp)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, tuple(args), world_size, backend,
                                   device, port, out, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        late = False
        try:
            while any(p.is_alive() for p in procs):
                late = time.monotonic() > deadline
                if late or any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = out / f"rank{r}.err"
            if err.exists():
                errors.append(f"rank {r}:\n{err.read_text()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit {p.exitcode}" + (
                    f" (killed after {timeout_s:g} s)" if late else
                    " (killed when another rank failed)"
                    if p.exitcode == -9 else ""))
        if errors:
            raise RuntimeError(f"a world of {world_size} on {backend} "
                               f"failed:\n" + "\n".join(errors))
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
