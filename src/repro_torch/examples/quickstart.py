"""Quickstart: the LOCO channel-object model in five minutes, on the port
(the counterpart of ``examples/quickstart.py``).

Mirrors the paper's Fig. 1: construct a manager, build channels (note the
composition — the barrier is implemented *on top of* an SST, which is
itself composed of owned_vars), and run them across participants stacked
on one device.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (GET, INSERT, SST, Barrier, KVStore, SharedQueue,
                              TicketLock, make_manager)

P = 4  # participants ("nodes" of the memory network)


def main(device=None):
    mgr = make_manager(P, device=device)

    # --- channels are named and composable (paper §4.1)
    bar = Barrier(None, "bar", mgr)          # contains "bar/sst/ov0..3"
    sst = SST(None, "stats", mgr, shape=(2,))
    lock = TicketLock(None, "mutex", mgr)
    queue = SharedQueue(None, "work", mgr, slots_per_node=4, width=1)
    kv = KVStore(None, "kv", mgr, slots_per_node=4, value_width=2,
                 num_locks=4)
    print("registered channels:", sorted(mgr.channels)[:8], "...")
    print(f"network memory ledger: {mgr.memory_ledger_bytes()} B "
          f"per participant\n")

    # --- one program for every participant at once (the stacked binding)
    def prog(bar_st, sst_st, lock_st, q_st):
        me = mgr.runtime.my_id()
        # barrier: everyone synchronizes (Fig. 1a)
        bar_st = bar.wait(bar_st)
        # SST: everyone publishes a row, everyone sees all rows
        sst_st = sst.store_mine(sst_st, torch.stack([me, me * me], 1))
        sst_st, _ack = sst.push_broadcast(sst_st)
        # ticket lock: FIFO mutual exclusion; the holder pushes to the queue
        lock_st, ticket = lock.acquire(lock_st, want=True)
        for _round in range(P):
            holds = lock.holds(lock_st, ticket)
            q_st, _ok = queue.enqueue(q_st, (me * 100)[:, None], want=holds)
            lock_st = lock.release(lock_st, holds)
        return bar_st, sst_st, lock_st, q_st, sst.rows(sst_st)

    out = mgr.runtime.run(prog, bar.init_state(), sst.init_state(),
                          lock.init_state(), queue.init_state())
    # the SST's uint32 registers, printed as the reference's int32 rows
    rows = out[4].cpu().numpy().astype(np.int32)
    print("every participant's view of the SST:")
    print(rows[0], "\n")

    # --- the kvstore (paper §6): lock-free reads, locked writes
    kv_st = kv.init_state()
    kv_st, res = kv.op_round(kv_st, np.full(P, INSERT, np.int32),
                             np.arange(1, P + 1, dtype=np.uint32),
                             np.array([[i, i * 7] for i in range(1, P + 1)],
                                      np.int32))
    print("concurrent inserts ok:", res.found.cpu().numpy())
    kv_st, res = kv.op_round(kv_st, np.full(P, GET, np.int32),
                             np.array([4, 3, 2, 1], np.uint32),
                             np.zeros((P, 2), np.int32))
    print("lock-free gets:", res.value.cpu().tolist())
    print("\nquickstart done.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
