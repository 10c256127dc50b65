"""KV-store application demo (paper §6) on the port, the counterpart of
``examples/kvstore_app.py``: a YCSB-style workload over the linearizable
channel kvstore, reporting throughput and validating every read against a
sequential oracle online.

Run:  PYTHONPATH=src python -m repro_torch.examples.kvstore_app [--device cpu]
      [--backend onesided|active_message|pallas]
"""
import argparse
import time

import numpy as np

from repro_torch.core import DELETE, GET, INSERT, NOP, UPDATE, KVStore, \
    make_manager

P, KEYSPACE, ROUNDS = 8, 256, 40


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def main(keyspace=KEYSPACE, rounds=ROUNDS, device=None, backend=None):
    mgr = make_manager(P, device=device, backend=backend)
    kv = KVStore(None, "ycsb", mgr, slots_per_node=keyspace // P + 4,
                 value_width=2, num_locks=32, index_capacity=4 * keyspace)
    st = kv.init_state()
    rng = np.random.default_rng(0)
    oracle = {}

    # prefill 80%
    keys = rng.permutation(np.arange(1, keyspace + 1))[:int(keyspace * .8)]
    for i in range(0, len(keys), P):
        chunk = keys[i:i + P]
        op = np.full(P, NOP, np.int32)
        op[:len(chunk)] = INSERT
        kk = np.ones(P, np.uint32)
        kk[:len(chunk)] = chunk
        vv = np.zeros((P, 2), np.int32)
        vv[:len(chunk), 0] = chunk * 3
        st, res = kv.op_round(st, op, kk, vv)
        found = res.found.cpu().numpy()
        for j, key in enumerate(chunk):
            _check(bool(found[j]), f"prefill insert of {key} failed")
            oracle[int(key)] = (int(key) * 3, 0)
    print(f"prefilled {len(oracle)} keys")

    t0 = time.time()
    checked = ops = 0
    for r in range(rounds):
        op = rng.choice([GET, UPDATE, INSERT, DELETE], size=P,
                        p=[.6, .2, .1, .1]).astype(np.int32)
        kk = rng.integers(1, keyspace + 1, P).astype(np.uint32)
        vv = np.stack([kk.astype(np.int32) * 5 + r, np.full(P, r)], 1) \
            .astype(np.int32)
        pre = dict(oracle)
        st, res = kv.op_round(st, op, kk, vv)
        found, value = res.found.cpu().numpy(), res.value.cpu().numpy()
        # oracle replay in the channel's linearization order
        for j in range(P):
            if op[j] == GET:
                exp = pre.get(int(kk[j]))
                _check(bool(found[j]) == (exp is not None), (r, j))
                if exp is not None:
                    _check(tuple(int(x) for x in value[j]) == exp, (r, j))
                checked += 1
        for j in range(P):
            k = int(kk[j])
            if op[j] in (INSERT, UPDATE) and found[j]:
                oracle[k] = (int(vv[j, 0]), int(vv[j, 1]))
            elif op[j] == DELETE and found[j]:
                oracle.pop(k)
        ops += P
    dt = time.time() - t0
    print(f"{ops} ops in {dt:.2f}s ({ops / dt:.0f} ops/s wall, "
          f"{checked} reads oracle-validated, final size {len(oracle)})")
    print("linearizability holds.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend", default=None,
                    help="verb backend (default: REPRO_DEFAULT_BACKEND, "
                         "else onesided)")
    ap.add_argument("--keyspace", type=int, default=KEYSPACE)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    a = ap.parse_args()
    main(keyspace=a.keyspace, rounds=a.rounds, device=a.device,
         backend=a.backend)
