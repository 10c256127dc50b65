"""The JAX reference for the PyTorch port's parity tests.

``repro.core`` does not import on jax 0.9: ``repro/core/ack.py`` tests
``_opt_barrier_p not in batching.primitive_batchers``, and that object is now
a ``PrimitiveBatchersProxy`` that does not support ``in``, so the
``TypeError`` escapes the module's ``except``.  :func:`reference_core`
imports ``repro.core`` with a stand-in for ``primitive_batchers`` whose
``__contains__`` asks the batching rules jax 0.9 keeps, then puts the
original object back.  Nothing in the JAX package changes.

The module also holds what the parity tests share: the tree comparison and
the numpy conversions between the two packages.
"""
from __future__ import annotations

import numpy as np


def reference_core():
    """``repro.core``, imported through the primitive_batchers stand-in."""
    import jax  # noqa: F401  (the batching modules below need jax loaded)
    from jax._src.interpreters import batching as batching_src
    from jax.interpreters import batching

    original = batching.primitive_batchers
    if hasattr(type(original), "__contains__"):
        import repro.core as core
        return core

    class _Batchers(type(original)):
        def __contains__(self, prim):
            return prim in batching_src.fancy_primitive_batchers

    batching.primitive_batchers = object.__new__(_Batchers)
    try:
        import repro.core as core
    finally:
        batching.primitive_batchers = original
    return core


# Imported here, while the module loads: pytest collects every test file
# before it runs a test, an xdist worker too, so each process that collects
# a port test has ``repro.core`` in ``sys.modules`` before its first test.
# Tests that import ``repro.core`` themselves (``tests/test_examples.py``,
# through the examples) then pass whichever file their process ran first.
reference_core()


def locked_ledger(mgr):
    """Give a reference manager an enabled traffic ledger whose host
    callbacks update their totals under a lock.

    The reference's ledger adds into plain dicts from ``jax.debug.callback``;
    the CPU runtime may run the P per-participant callbacks of one verb
    concurrently, and an unlocked ``+=`` then loses an update now and then.
    The same rows, recorded the same way, under one lock."""
    import threading

    import jax
    import jax.numpy as jnp

    lock = threading.Lock()
    ledger = mgr.traffic

    def _add(table, verb, **amounts):
        with lock:
            e = table.setdefault(verb, {k: 0.0 for k in amounts}
                                 | ({"calls": 0} if "bytes" in amounts
                                    else {}))
            if "calls" in e:
                e["calls"] += 1
            for k, v in amounts.items():
                e[k] += float(v)

    def record(verb, wire_bytes):
        jax.debug.callback(lambda b: _add(ledger.counts, verb, bytes=b),
                           jnp.asarray(wire_bytes, jnp.float32))

    def record_rounds(verb, rounds):
        jax.debug.callback(lambda r: _add(ledger.round_counts, verb,
                                          rounds=r),
                           jnp.asarray(rounds, jnp.float32))

    def record_dma(verb, nbytes):
        jax.debug.callback(lambda b: _add(ledger.dma_counts, verb, bytes=b),
                           jnp.asarray(nbytes, jnp.float32))

    def record_cache(name, hits, lookups):
        jax.debug.callback(lambda h, lk: _add(ledger.cache_counts, name,
                                              hits=h, lookups=lk),
                           jnp.asarray(hits, jnp.float32),
                           jnp.asarray(lookups, jnp.float32))

    def record_fastpath(name, fast, windows):
        jax.debug.callback(lambda f, w: _add(ledger.fastpath_counts, name,
                                             fast_windows=f, windows=w),
                           jnp.asarray(fast, jnp.float32),
                           jnp.asarray(windows, jnp.float32))

    def _count(table, name, n):
        with lock:
            table[name] = table.get(name, 0.0) + float(n)

    def record_corrupt(name, count):
        jax.debug.callback(lambda n: _count(ledger.corrupt_counts, name, n),
                           jnp.asarray(count, jnp.float32))

    def record_fenced(name, count):
        jax.debug.callback(lambda n: _count(ledger.fenced_counts, name, n),
                           jnp.asarray(count, jnp.float32))

    ledger.record, ledger.record_rounds = record, record_rounds
    ledger.record_dma, ledger.record_cache = record_dma, record_cache
    ledger.record_corrupt, ledger.record_fenced = record_corrupt, record_fenced
    ledger.record_fastpath = record_fastpath
    return ledger.enable()


def ledger_rows(ledger):
    """Every tier of a traffic ledger — modeled bytes, rounds, measured DMA
    bytes, read-cache counters, lock-free-served windows, checksum failures,
    fenced entries — as plain dicts (the reference's and the port's have the
    same methods)."""
    return {"bytes": ledger.summary(), "rounds": ledger.rounds_summary(),
            "dma": ledger.dma_summary(), "cache": ledger.cache_summary(),
            "fastpath": ledger.fastpath_summary(),
            "corrupt": ledger.corrupt_summary(),
            "fenced": ledger.fenced_summary()}


def jax_to_numpy(tree):
    """Every leaf of a JAX pytree (NamedTuples kept) as a numpy array."""
    import jax
    return jax.tree.map(np.asarray, tree)


def torch_to_numpy(x):
    """A torch tensor or (nested) NamedTuple of tensors → numpy, with the
    port's int64 uint32 holders turned back into uint32."""
    import torch
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return (a & 0xFFFFFFFF).astype(np.uint32) if a.dtype == np.int64 \
            else a
    if isinstance(x, tuple):
        return type(x)(*(torch_to_numpy(v) for v in x))
    return np.asarray(x)


def leaves(tree, prefix=""):
    """(path, leaf) pairs of a NamedTuple tree, depth first."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += leaves(getattr(tree, f), f"{prefix}{f}.")
        return out
    return [(prefix.rstrip("."), tree)]


def assert_trees_equal(ref, port, what=""):
    """Bitwise leaf-by-leaf equality of a JAX tree (numpy leaves) and a
    port tree (numpy leaves): same paths, dtypes, shapes and bits."""
    lr, lp = leaves(ref), leaves(port)
    assert [p for p, _ in lr] == [p for p, _ in lp], what
    for (path, a), (_, b) in zip(lr, lp):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{what} {path}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
