"""The port's attention kernels (their plain versions, which CPU tensors
take) against the JAX package's Pallas kernels run in interpret mode, through
the reference wrappers ``repro.kernels.ops.flash_attention`` /
``decode_attention``.  Inputs are float32, made with numpy from a seed.

Tolerance: ``atol=2e-5, rtol=1e-5`` — both sides accumulate in float32, the
Pallas kernel block by block with an online softmax and the plain version in
one pass, so they differ by float32 rounding only.  The CUDA kernels run only
on the card; chip_smoke.py holds them against these plain versions there."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import decode_attention as pdec  # noqa: E402
from repro_torch.kernels import flash_attention as pfa  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B, Hq, Hkv, Sq, Sk, D, causal, window", [
    (2, 4, 4, 16, 16, 16, True, None),       # MHA, causal
    (1, 4, 2, 24, 24, 12, True, None),       # GQA 2, head_dim 12
    (2, 6, 2, 16, 40, 16, True, None),       # GQA 3, Sq < Sk: causal offset
    (1, 2, 1, 32, 32, 16, False, None),      # no mask
    (1, 4, 2, 40, 40, 8, True, 8),           # sliding window
    (1, 2, 2, 130, 130, 16, True, None),     # Sk padded to the tile: kv_valid
    (1, 3, 1, 16, 130, 16, True, None),      # padding shifts the diagonal
    (1, 2, 1, 130, 130, 8, False, None),     # padded, unmasked
    (1, 10, 1, 40, 40, 256, True, 16),       # head_dim 256, MQA G=10, window
    (1, 10, 1, 136, 136, 256, True, 64),     # the same, padded, tiles skipped
])
def test_flash_attention_matches_pallas(B, Hq, Hkv, Sq, Sk, D, causal,
                                        window):
    q, k, v = _inputs(Sq * 7 + Sk, (B, Hq, Sq, D), (B, Hkv, Sk, D),
                      (B, Hkv, Sk, D))
    ref = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal,
                                          window=window))
    got = pfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("B, Hq, Hkv, S, D, lengths", [
    (3, 4, 4, 32, 16, [1, 17, 32]),
    (2, 4, 2, 48, 12, [48, 5]),
    (4, 6, 2, 64, 16, [1, 64, 33, 2]),
    (1, 3, 1, 300, 16, [257]),               # cache padded to the tile
    (2, 10, 1, 48, 256, [48, 17]),           # head_dim 256, MQA G=10
])
def test_decode_attention_matches_pallas(B, Hq, Hkv, S, D, lengths):
    q, kc, vc = _inputs(S + B, (B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))
    lens = np.asarray(lengths, np.int32)
    ref = np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                           jnp.asarray(vc),
                                           jnp.asarray(lens)))
    got = pdec.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_rows_with_no_visible_key_are_zeros():
    """Sq > Sk aligns the diagonal below row 0: the first Sq - Sk rows see no
    key.  The Pallas kernels return zeros there (and for a zero-length
    decode), and so does the port — not ``ref.mha``'s uniform average."""
    q, k, v = _inputs(5, (1, 2, 16, 8), (1, 1, 8, 8), (1, 1, 8, 8))
    ref = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
    got = pfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[:, :, :8].any() and got[:, :, 8:].any()

    q, kc, vc = _inputs(6, (2, 4, 8), (2, 2, 16, 8), (2, 2, 16, 8))
    lens = np.asarray([0, 16], np.int32)
    ref = np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                           jnp.asarray(vc),
                                           jnp.asarray(lens)))
    got = pdec.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[0].any() and got[1].any()


def test_plain_versions_follow_repeat_kv():
    """The grouped decode equals the full mha over the cache prefix, and
    repeat_kv maps query head h to kv head h // G."""
    q, kc, vc = _inputs(7, (2, 6, 16), (2, 2, 20, 16), (2, 2, 20, 16))
    k_t = torch.from_numpy(kc)
    rep = pref.repeat_kv(k_t, 3)
    for h in range(6):
        assert torch.equal(rep[:, h], k_t[:, h // 3])
    got = pref.decode_attention(torch.from_numpy(q), k_t,
                                torch.from_numpy(vc),
                                torch.tensor([20, 20], dtype=torch.int32))
    full = pref.mha(torch.from_numpy(q)[:, :, None], k_t,
                    torch.from_numpy(vc), causal=False)[:, :, 0]
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 3, 4, 8))
    k = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError):
        pfa.flash_attention(q, k, k)           # Hq % Hkv != 0
    with pytest.raises(ValueError):
        pdec.decode_attention(q[:, :, 0], k, k, torch.zeros(2))
    launches = (pfa.flash_attention.launches,
                pdec.decode_attention.launches)
    pfa.flash_attention(torch.zeros((1, 2, 4, 8)), k, k)
    assert (pfa.flash_attention.launches,
            pdec.decode_attention.launches) == launches, \
        "CPU tensors take the plain version: no launch is counted"


@pytest.mark.parametrize("chunk_kind", ["1", "3", "S"])
@pytest.mark.parametrize("Hq, Hkv", [(2, 2), (16, 1), (40, 2)])
# G = 1, 16 and 20: a group past 16 query heads runs in two group tiles
def test_split_decode_matches_pallas(chunk_kind, Hq, Hkv):
    """The CUDA decode kernel's algorithm — per-chunk partials (m, l, acc),
    then the combine — in its plain version against the Pallas kernel.
    Lengths 0, 1, a chunk edge and S in one batch: the length-0 row (every
    chunk empty: zeros) and chunks past a sequence's length (m = -1e30,
    l = 0, skipped) are both pinned."""
    S, D = 12, 16
    chunk = {"1": 1, "3": 3, "S": S}[chunk_kind]
    lens = np.asarray([0, 1, min(2 * chunk, S), S], np.int32)
    B = lens.size
    q, kc, vc = _inputs(S + Hq + chunk, (B, Hq, D), (B, Hkv, S, D),
                        (B, Hkv, S, D))
    ref = np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                           jnp.asarray(vc),
                                           jnp.asarray(lens)))
    got = pref.decode_attention_split(torch.from_numpy(q),
                                      torch.from_numpy(kc),
                                      torch.from_numpy(vc),
                                      torch.from_numpy(lens), chunk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert not got[0].any() and got[1:].all()


@pytest.mark.parametrize("B, Hkv, S, expected", [
    (4, 8, 544, (9, 64)),        # llama3.2-3b's decode: 288 blocks
    (4, 1, 2048, (32, 64)),      # recurrentgemma-2b's ring: 128 blocks
    (1, 1, 64, (1, 64)),         # S fits one chunk: no partials
    (2, 2, 1, (1, 64)),
    (1, 1, 65, (2, 64)),
    (64, 8, 131072, (1, 131072)),  # the grid is full without a split
    (2, 4, 100_000, None),
    (3, 1, 0, (1, 64)),
])
def test_split_count_follows_the_slot_count(B, Hkv, S, expected):
    splits, chunk = pdec._split(B, Hkv, S)
    assert pdec._split(B, Hkv, S, pdec.GROUP_TILE) == (splits, chunk)
    assert chunk % pdec.CHUNK == 0 and chunk >= pdec.CHUNK
    assert splits * chunk >= S and (splits - 1) * chunk < max(S, 1)
    if S <= pdec.CHUNK:
        assert splits == 1
    if expected is not None:
        assert (splits, chunk) == expected
    if chunk > pdec.CHUNK:      # larger chunks only once the grid is full
        assert B * Hkv * splits >= pdec.TARGET_BLOCKS // 2


@pytest.mark.parametrize("B, Hkv, S, G, expected", [
    (4, 1, 544, 128, (9, 64)),    # MLA's absorbed decode: 8 group tiles
    (4, 1, 544, 17, (9, 64)),     # 2 group tiles: S caps the splits
    (1, 1, 2048, 16, (32, 64)),   # one tile: 33 splits wanted
    (1, 1, 4096, 128, (32, 128)),  # 8 tiles: 33 wanted, chunks of 128
    (1, 1, 4096, 16, (64, 64)),
])
def test_split_count_counts_the_group_tiles(B, Hkv, S, G, expected):
    """A group of more than GROUP_TILE query heads is tiled over the grid,
    and the split count aims at TARGET_BLOCKS over B·Hkv·tiles blocks."""
    tiles = -(-G // pdec.GROUP_TILE)
    assert pdec._group_tiles(G) == tiles
    assert pdec._split(B, Hkv, S, G) == expected
    assert pdec._split(B, Hkv, S, G) == pdec._split(B, Hkv * tiles, S)


_ALIGNED = dict(D=128, strides=(8 * 512 * 128, 128, 8 * 128) * 3,
                ptrs=(0x7f0000000000, 0x7f0000100000, 0x7f0000200000))


@pytest.mark.parametrize("change, expected", [
    ({}, "mma"),                                   # (B, S, H, D) views
    (dict(D=64), "mma"),
    (dict(D=200, strides=(200 * 64,) * 9), "mma"),  # zero-filled to 256
    (dict(dtype=torch.float32), "simt"),           # float32 stays exact
    (dict(D=12, strides=(12,) * 9), "simt"),       # rows of 24 bytes
    (dict(ptrs=(0x7f0000000002, 0x7f0000100000, 0x7f0000200000)), "simt"),
    (dict(strides=(8 * 512 * 128, 128, 8 * 128 + 1) + (1024,) * 6), "simt"),
    (dict(dtype=torch.float16), "simt"),
])
def test_flash_variant_dispatch(change, expected):
    """bf16 rows that 16-byte copies can take go to the tensor-core kernel;
    float32 and unaligned bf16 rows to the CUDA-core kernel."""
    kw = dict(dtype=torch.bfloat16, **_ALIGNED)
    kw.update(change)
    assert pfa._variant(kw["dtype"], kw["D"], kw["strides"],
                        kw["ptrs"]) == expected


@pytest.mark.parametrize("P, row_nbytes, refused", [
    (8, 307_000_000, True),      # 7 rows of 307 MB pass 2**31 bytes
    (2, 2 ** 31, True),
    (8, 20_488 * 4, False),      # the failover phase's ring hop
    (4, 648 * 4, False),         # the replicated engine's
    (8, (2 ** 31 - 1) // 7, False),
])
def test_remote_copy_refuses_what_its_counters_cannot_hold(P, row_nbytes,
                                                           refused):
    """A sender's int32 ``sent`` count reaches (P - 1)·row_nbytes; the
    guard refuses that before the CPU branch, so the kernel and the plain
    version refuse alike.  A zero-stride view stands in for the rows."""
    from repro_torch.kernels import remote_dma as rdma
    n = row_nbytes // 4
    if refused:
        with pytest.raises(ValueError, match="int32 byte counters"):
            rdma._check_counter_range(P, row_nbytes)
        src = torch.zeros((1, 1), dtype=torch.int32).expand(P, n)
        with pytest.raises(ValueError, match="int32 byte counters"):
            rdma.remote_copy(src, src, torch.zeros(P, dtype=torch.int32))
        return
    rdma._check_counter_range(P, row_nbytes)
    if n <= 20_488:
        src = torch.arange(P * n, dtype=torch.int32).reshape(P, n)
        sender = torch.full((P,), 1, dtype=torch.int32)
        sender[1] = -1
        out, sent, recv = rdma.remote_copy(src, torch.zeros_like(src),
                                           sender)
        assert torch.equal(out[0], src[1]) and int(sent[1]) == \
            (P - 1) * row_nbytes and int(recv[0]) == row_nbytes
