"""The port's Ringbuffer against the JAX package's, bitwise, mirroring
tests/test_channels.py::TestRingbuffer and ::TestRingbufferWindows on the
one-sided, active-message and remote-DMA backends: after every step the ring
states (payload, seq, len, epoch, checksum, head, owner, alive and the SST of
cursors) and every returned value are equal bit for bit, and at the end the
traffic ledgers agree row for row, corrupt and fenced tiers included.  On the
``pallas`` backend the port's publish hop runs ``remote_copy``, whose plain
version is held here against a numpy oracle of the copy semantics; the JAX
package's ``remote_copy_tpu`` cannot run off a TPU
(``repro/kernels/remote_dma.py:250``), so it is held at the ring level."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            ledger_rows, locked_ledger, reference_core,
                            torch_to_numpy)

import torch  # noqa: E402

import repro_torch.core as pt  # noqa: E402
from repro_torch.kernels import remote_dma as rdma  # noqa: E402

P, B, WIDTH = 4, 4, 3
BACKENDS = ["onesided", "active_message", "pallas"]


def _pt(x):
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t.to(torch.int64) if a.dtype == np.uint32 else t


class RingPair:
    """The same ring in both packages, stepped together."""

    def __init__(self, backend, capacity=8, owner=0, width=WIDTH,
                 ledger=True):
        core = reference_core()
        self.jm = core.make_manager(P, backend=backend)
        self.tm = pt.make_manager(P, device="cpu", backend=backend)
        if ledger:
            locked_ledger(self.jm)
            self.tm.traffic.enable()
        self.jr = core.Ringbuffer(None, "rb", self.jm, owner=owner,
                                  capacity=capacity, width=width)
        self.tr = pt.Ringbuffer(None, "rb", self.tm, owner=owner,
                                capacity=capacity, width=width)
        self.js, self.ts = self.jr.init_state(), self.tr.init_state()
        self._jit = {}
        self.check("init")

    def check(self, what, jout=(), tout=()):
        assert_trees_equal(jax_to_numpy(self.js), torch_to_numpy(self.ts),
                           what)
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(np.asarray(a), torch_to_numpy(b),
                                          err_msg=what)

    def step(self, name, jprog, tfn, *args):
        """Run ``jprog`` (per participant, under the reference's runtime)
        and ``tfn`` (stacked) on the ring state and ``args``; both return
        (state, *outs)."""
        if name not in self._jit:
            run = self.jm.runtime.run
            self._jit[name] = jax.jit(lambda *a: run(jprog, *a))
        jres = self._jit[name](self.js, *args)
        tres = tfn(self.ts, *[_pt(a) for a in args])
        self.js, self.ts = jres[0], tres[0]
        self.check(name, jres[1:], tres[1:])
        return [torch_to_numpy(x) for x in tres[1:]]

    def publish(self, msgs, lens, preds=None, epoch=None):
        jr, tr = self.jr, self.tr
        args = [msgs, lens] + ([] if preds is None else [preds]) \
            + ([] if epoch is None else [epoch])
        tag = f"pub{preds is None}{epoch is None}"

        def jprog(s, m, ln, *rest):
            p = rest[0] if preds is not None else None
            e = rest[-1] if epoch is not None else None
            return jr.publish_window(s, m, ln, p, e)[:2]

        def tfn(s, m, ln, *rest):
            p = rest[0] if preds is not None else None
            e = rest[-1] if epoch is not None else None
            return tr.publish_window(s, m, ln, p, e)[:2]

        return self.step(tag, jprog, tfn, *args)[0]

    def recv(self, window=B, pred=None, expect_epoch=None):
        jr, tr = self.jr, self.tr
        args = ([] if pred is None else [pred]) \
            + ([] if expect_epoch is None else [expect_epoch])
        tag = f"recv{window}{pred is None}{expect_epoch is None}"

        def split(rest):
            p = rest[0] if pred is not None else True
            e = rest[-1] if expect_epoch is not None else None
            return p, e

        def jprog(s, *rest):
            p, e = split(rest)
            return jr.recv_window(s, window, p, expect_epoch=e)

        def tfn(s, *rest):
            p, e = split(rest)
            return tr.recv_window(s, window, p, expect_epoch=e)

        return self.step(tag, jprog, tfn, *args)

    def send(self, msg, ln, pred):
        jr, tr = self.jr, self.tr
        return self.step(
            "send", lambda s, m, ln, p: jr.send(s, m, ln, pred=p)[:2],
            lambda s, m, ln, p: tr.send(s, m, ln, pred=p)[:2], msg, ln,
            pred)[0]

    def recv_one(self, pred=None):
        jr, tr = self.jr, self.tr
        if pred is None:
            return self.step("recv1", jr.recv_one, tr.recv_one)
        return self.step("recv1p", lambda s, p: jr.recv_one(s, p),
                         lambda s, p: tr.recv_one(s, p), pred)

    def re_own(self, new_owner, alive, head):
        jr, tr = self.jr, self.tr
        self.step("re_own",
                  lambda s, o, a, h: (jr.re_own(s, o, a, h),),
                  lambda s, o, a, h: (tr.re_own(s, o, a, h),),
                  np.full((P,), new_owner, np.int32),
                  np.broadcast_to(np.asarray(alive, bool), (P, P)),
                  np.full((P,), head, np.uint32))

    def ledgers_equal(self):
        assert ledger_rows(self.jm.traffic) == ledger_rows(self.tm.traffic)


def _msgs(base):
    m = np.arange(B * WIDTH, dtype=np.int32).reshape(B, WIDTH) + 100 * base
    return np.broadcast_to(m, (P, B, WIDTH)).copy()


def _owner_only(owner=0):
    return np.arange(P) == owner


# ---------------------------------------------------------------------------
# TestRingbuffer: the scalar paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_broadcast_in_order(backend):
    r = RingPair(backend, capacity=4, width=2)
    for k in range(3):
        msg = np.broadcast_to(np.array([k + 1, (k + 1) * 10], np.int32),
                              (P, 2)).copy()
        sent = r.send(msg, np.full((P,), 2, np.int32), _owner_only())
        assert sent.tolist() == [True, False, False, False]
        m, _ln, got = r.recv_one()
        assert got.all()
        np.testing.assert_array_equal(m, msg)
    assert r.tr.publishes == 3
    r.ledgers_equal()


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_full_ring_blocks_sender_until_acks(backend):
    r = RingPair(backend, capacity=2, width=1)
    sents = [r.send(np.full((P, 1), k, np.int32), np.ones((P,), np.int32),
                    _owner_only())[0] for k in range(3)]
    assert sents == [True, True, False], "the third send finds no space"
    m, _ln, got = r.recv_one()
    assert got.all() and (m[:, 0] == 0).all()
    assert r.send(np.full((P, 1), 9, np.int32), np.ones((P,), np.int32),
                  _owner_only())[0], "an ack frees a slot"


def test_recv_one_pred_masks_consumption():
    r = RingPair("onesided")
    r.send(np.broadcast_to(np.arange(1, WIDTH + 1, dtype=np.int32),
                           (P, WIDTH)).copy(),
           np.full((P,), WIDTH, np.int32), _owner_only())
    pred = np.array([True, False, True, False])
    m, ln, got = r.recv_one(pred)
    assert got.tolist() == pred.tolist()
    assert (m[~pred] == 0).all() and (ln[~pred] == 0).all()
    m, _ln, got = r.recv_one(np.ones(P, bool))
    assert got.tolist() == (~pred).tolist(), "masked lanes did not consume"


# ---------------------------------------------------------------------------
# TestRingbufferWindows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_window_broadcast_in_order_with_wrap(backend):
    r = RingPair(backend, capacity=5)
    for rnd in range(3):
        msgs = _msgs(rnd)
        lens = np.broadcast_to(np.arange(1, B + 1, dtype=np.int32),
                               (P, B)).copy()
        sent = r.publish(msgs, lens, np.ones((P, B), bool))
        assert sent[0].all() and not sent[1:].any()
        m, ln, got, fenced = r.recv()
        assert got.all() and not fenced.any()
        np.testing.assert_array_equal(m, msgs)
        np.testing.assert_array_equal(ln, lens)
    assert r.tr.publishes == 3
    r.ledgers_equal()


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_full_ring_grants_prefix_and_resumes_after_acks(backend):
    r = RingPair(backend, capacity=6)
    lens = np.full((P, B), WIDTH, np.int32)
    assert r.publish(_msgs(0), lens)[0].all()
    sent2 = r.publish(_msgs(1), lens)
    np.testing.assert_array_equal(sent2[0], [True, True, False, False])
    _m, _ln, got, _f = r.recv()
    assert got.all()
    _m, _ln, got, _f = r.recv()
    assert got.sum(1).tolist() == [2] * P
    assert r.publish(_msgs(2), lens)[0].all(), "acks free the ring again"
    r.ledgers_equal()


def test_b1_window_pinned_to_scalar_send_recv():
    """The windowed B=1 path and the scalar path give the same states —
    in both packages, each equal to the other."""
    rw, rs = RingPair("onesided"), RingPair("onesided")
    rng = np.random.default_rng(5)
    for rnd in range(6):
        msg = np.broadcast_to(rng.integers(0, 99, WIDTH).astype(np.int32),
                              (P, WIDTH)).copy()
        ln = np.full((P,), int(rng.integers(1, WIDTH + 1)), np.int32)
        pred = np.full((P,), bool(rng.random() < 0.8))
        sw = rw.publish(msg[:, None, :], ln[:, None], pred[:, None])
        outw = rw.recv(window=1)
        ss = rs.send(msg, ln, pred)
        outs = rs.recv_one()
        assert_trees_equal(torch_to_numpy(rw.ts), torch_to_numpy(rs.ts),
                           f"window vs scalar, round {rnd}")
        np.testing.assert_array_equal(sw[:, 0], ss)
        for a, b in zip(outw[:3], outs):
            np.testing.assert_array_equal(a[:, 0], b)


@pytest.mark.parametrize("field,delta", [("length", 1), ("payload", 7),
                                         ("seq", 1), ("epoch", 1)])
def test_corrupt_field_never_validates_and_is_counted(field, delta):
    """A corrupted length, payload, seq or epoch word never delivers; the
    checksum failures (not the stale seq) land in the corrupt tier, and
    both ledgers agree."""
    r = RingPair("onesided")
    lens = np.full((P, B), 2, np.int32)
    r.publish(_msgs(0), lens)
    good_j, good_t = r.js, r.ts
    jbuf = np.asarray(getattr(r.js, field)).copy()
    r.js = r.js._replace(**{field: jnp.asarray(
        jbuf + np.asarray(delta, jbuf.dtype))})
    tbuf = getattr(r.ts, field).clone()
    r.ts = r.ts._replace(**{field: tbuf + delta})
    r.check(f"corrupt {field}")
    _m, _ln, got, _f = r.recv()
    assert not got.any(), f"corrupted {field} must never deliver"
    r.ledgers_equal()
    counted = r.tm.traffic.corrupt_summary()["rb"]
    assert counted == (0.0 if field == "seq" else float(P * B))
    r.js, r.ts = good_j, good_t
    m, _ln, got, _f = r.recv()
    assert got.all()
    np.testing.assert_array_equal(m, _msgs(0))


def test_checksum_failure_of_one_cached_copy_lands_in_ledger():
    r = RingPair("pallas")
    r.publish(_msgs(0), np.full((P, B), 2, np.int32))
    jbuf = np.asarray(r.js.payload).copy()
    jbuf[1, 0, 0] ^= 0x5A
    r.js = r.js._replace(payload=jnp.asarray(jbuf))
    tbuf = r.ts.payload.clone()
    tbuf[1, 0, 0] ^= 0x5A
    r.ts = r.ts._replace(payload=tbuf)
    _m, _ln, got, _f = r.recv()
    assert not got[1].any() and got[0].all() and got[2:].all()
    assert r.tm.traffic.corrupt_summary()["rb"] == 1.0
    r.ledgers_equal()


@pytest.mark.parametrize("backend", ["onesided", "pallas"])
def test_epoch_fencing_and_takeover(backend):
    """Entries stamped with an older epoch are consumed but not delivered
    (fenced, counted); ``re_own`` poisons seq and checksums, keeps the epoch
    stamps and cursors, and the new owner's publishes deliver."""
    r = RingPair(backend, capacity=6)
    lens = np.full((P, B), 2, np.int32)
    r.publish(_msgs(0), lens, epoch=np.full((P,), 0, np.uint32))
    m, _ln, got, fenced = r.recv(expect_epoch=np.full((P,), 1, np.uint32))
    assert fenced.all() and not got.any() and (m == 0).all()
    assert r.tm.traffic.fenced_summary()["rb"] == float(P * B)
    alive = np.array([False, True, True, True])
    r.re_own(2, alive, head=4)
    assert int(r.ts.owner[0]) == 2 and not r.ts.alive[:, 0].any()
    sent = r.publish(_msgs(1), lens, epoch=np.full((P, B), 1, np.uint32))
    assert sent[2].all() and not sent[[0, 1, 3]].any()
    m, _ln, got, fenced = r.recv(expect_epoch=np.full((P,), 1, np.uint32))
    assert got.all() and not fenced.any()
    np.testing.assert_array_equal(m, _msgs(1))
    r.ledgers_equal()


def test_dead_consumer_leaves_flow_control():
    """A dead consumer's frozen cursor never wedges the ring: with lane 3
    masked out of ``alive`` the owner keeps publishing past it."""
    r = RingPair("onesided", capacity=4)
    lens = np.full((P, B), 1, np.int32)
    r.re_own(0, [True, True, True, False], head=0)
    for rnd in range(3):
        assert r.publish(_msgs(rnd), lens)[0].all()
        _m, _ln, got, _f = r.recv(pred=np.array([True, True, True, False]))
        assert got[:3].all() and not got[3].any()


# ---------------------------------------------------------------------------
# the remote-copy kernel's plain version
# ---------------------------------------------------------------------------

def _copy_oracle(src, dst, sender):
    P_, n = src.shape
    out, sent, recv = dst.copy(), np.zeros(P_, np.int64), \
        np.zeros(P_, np.int64)
    for q in range(P_):
        s = int(sender[q])
        if 0 <= s < P_ and s != q:
            out[q] = src[s]
            recv[q] += 4 * n
            sent[s] += 4 * n
    return out, sent, recv


def _copy_cases():
    rng = np.random.default_rng(9)
    cases = []
    for P_, n in [(4, 640), (8, 20480), (4, 7), (3, 0), (5, 13)]:
        src = rng.integers(-2 ** 31, 2 ** 31, (P_, n), dtype=np.int64) \
            .astype(np.int32)
        dst = rng.integers(-2 ** 31, 2 ** 31, (P_, n), dtype=np.int64) \
            .astype(np.int32)
        owner = int(rng.integers(0, P_))
        cases += [
            (f"bcast P={P_} n={n}", src, dst,
             np.where(np.arange(P_) == owner, -1, owner)),
            (f"no senders P={P_} n={n}", src, dst, np.full(P_, -1)),
            (f"all from one P={P_} n={n}", src, dst, np.full(P_, owner)),
            (f"permutation P={P_} n={n}", src, dst, rng.permutation(P_)),
            (f"out of range P={P_} n={n}", src, dst,
             rng.integers(-3, P_ + 3, P_)),
        ]
    return cases


@pytest.mark.parametrize("label,src,dst,sender", _copy_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_remote_copy_plain_version_matches_the_oracle(label, src, dst,
                                                      sender):
    before = rdma.remote_copy.launches
    out, sent, recv = rdma.remote_copy(torch.from_numpy(src),
                                       torch.from_numpy(dst),
                                       torch.from_numpy(sender))
    eo, es, er = _copy_oracle(src, dst, sender)
    np.testing.assert_array_equal(out.numpy(), eo, err_msg=label)
    np.testing.assert_array_equal(sent.numpy(), es, err_msg=label)
    np.testing.assert_array_equal(recv.numpy(), er, err_msg=label)
    assert out.dtype == torch.int32 and sent.dtype == torch.int32
    assert rdma.remote_copy.launches == before, \
        "CPU tensors take the plain version and launch nothing"


def test_remote_copy_takes_a_misaligned_float_view():
    """A view whose rows start off a 16-byte boundary, in a 4-byte float
    dtype: the copy moves its bits."""
    flat = torch.arange(1 + 4 * 9, dtype=torch.float32)
    src = flat[1:].view(4, 9)
    dst = -src
    out, sent, recv = rdma.remote_copy(src, dst, torch.tensor([2, -1, -1, 2]))
    assert torch.equal(out[0], src[2]) and torch.equal(out[1], dst[1])
    assert torch.equal(out[3], src[2]) and torch.equal(out[2], dst[2])
    assert sent.tolist() == [0, 0, 72, 0] and recv.tolist() == [36, 0, 0, 36]
    with pytest.raises(ValueError, match="sender"):
        rdma.remote_copy(src, dst, torch.tensor([0, 1]))


@pytest.mark.parametrize("label,src,dst,sender", _copy_cases()[::2],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_remote_copy_takes_an_int32_or_int64_sender(label, src, dst,
                                                    sender):
    """The map is taken as the caller holds it, int32 or int64 (the kernel
    has a variant for each, so no cast runs per hop): both give the same
    copy and counters, the oracle's."""
    got = [rdma.remote_copy(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(sender.astype(dt)))
           for dt in (np.int32, np.int64)]
    eo, es, er = _copy_oracle(src, dst, sender)
    for out, sent, recv in got:
        np.testing.assert_array_equal(out.numpy(), eo, err_msg=label)
        np.testing.assert_array_equal(sent.numpy(), es, err_msg=label)
        np.testing.assert_array_equal(recv.numpy(), er, err_msg=label)
    for a, b in zip(*got):
        assert a.dtype == b.dtype and torch.equal(a, b), label
