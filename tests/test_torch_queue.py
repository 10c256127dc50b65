"""The port's SharedQueue against the JAX package's, bitwise: the same
(P, B) windows of pushes and pops from one state, then the B=1 wrappers the
serving engine calls.  States (head/tail registers, the striped slots with
their bit-cast seq lane), grants, values and ``ok`` lanes must be equal bit
for bit — including a full queue that rejects a suffix of the lane order and
tickets that wrap past the capacity many times over."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            reference_core)

import repro_torch.core as pt  # noqa: E402
from repro_torch.core.queue import (SharedQueue,  # noqa: E402
                                    queue_state_to_numpy)

P, SLOTS, WIDTH = 4, 3, 2          # capacity 12


class _Pair:
    def __init__(self, name, backend):
        core = reference_core()
        self.jmgr = core.make_manager(P, backend=backend)
        self.jq = core.SharedQueue(None, name, self.jmgr,
                                   slots_per_node=SLOTS, width=WIDTH)
        run = self.jmgr.runtime.run
        self.jenq = jax.jit(lambda s, v, p: run(self.jq.enqueue_window,
                                                s, v, p))
        self.jdeq = jax.jit(lambda s, p: run(self.jq.dequeue_window, s, p))
        self.jenq1 = jax.jit(lambda s, v, w: run(self.jq.enqueue, s, v, w))
        self.jdeq1 = jax.jit(lambda s, w: run(self.jq.dequeue, s, w))
        self.tmgr = pt.make_manager(P, device="cpu", backend=backend)
        self.tq = SharedQueue(None, name, self.tmgr, slots_per_node=SLOTS,
                              width=WIDTH)
        self.jst, self.tst = self.jq.init_state(), self.tq.init_state()

    def check(self, what, jout, tout):
        assert_trees_equal(jax_to_numpy(self.jst),
                           queue_state_to_numpy(self.tst), f"{what} state")
        for j, t in zip(jout, tout):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=what)


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_windows_bitwise(backend):
    q = _Pair(f"q_{backend}", backend)
    rng = np.random.default_rng(41)
    assert_trees_equal(jax_to_numpy(q.jst), queue_state_to_numpy(q.tst),
                       "init")
    grants = oks = 0
    for i in range(14):
        B = int(rng.integers(1, 5))
        vals = rng.integers(-2 ** 31, 2 ** 31, (P, B, WIDTH),
                            dtype=np.int64).astype(np.int32)
        # early windows push more than they pop: the queue fills, rejects,
        # then drains and wraps
        pe = rng.random((P, B)) < (0.9 if i < 5 else 0.5)
        pd = rng.random((P, B)) < (0.2 if i < 5 else 0.7)
        q.jst, jg = q.jenq(q.jst, vals, pe)
        q.tst, tg = q.tq.enqueue_window(q.tst, vals, pe)
        q.check(f"enqueue {i}", [jg], [tg])
        q.jst, jv, jok = q.jdeq(q.jst, pd)
        q.tst, tv, tok = q.tq.dequeue_window(q.tst, pd)
        q.check(f"dequeue {i}", [jv, jok], [tv, tok])
        grants += int(tg.sum())
        oks += int(tok.sum())
        if i == 4:
            assert (np.asarray(jg) != pe).any(), "the full queue rejected"
    assert grants > 3 * P * SLOTS, "tickets wrapped past the capacity"
    assert oks > 0


def test_b1_wrappers_bitwise():
    """The engine's admission pattern: every participant enqueues one id,
    then participant 0 alone dequeues, round after round."""
    q = _Pair("q_b1", "onesided")
    for r in range(20):
        ids = np.arange(P * r, P * r + P, dtype=np.int32)[:, None] \
            .repeat(WIDTH, 1)
        want = np.arange(P) < (r % P) + 1
        q.jst, jok = q.jenq1(q.jst, ids, want)
        q.tst, tok = q.tq.enqueue(q.tst, ids, want)
        q.check(f"enqueue {r}", [jok], [tok])
        pop = np.array([True] + [r % 3 == 0] * (P - 1))
        q.jst, jv, jok = q.jdeq1(q.jst, pop)
        q.tst, tv, tok = q.tq.dequeue(q.tst, pop)
        q.check(f"dequeue {r}", [jv, jok], [tv, tok])
