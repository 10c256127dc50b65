"""The MoE family's training pieces against the JAX package's, on the CPU:
the grouped matmul's backward and the MoE blocks' gradients.

* ``ref.gmm`` on ``w.transpose(1, 2)`` (the plain version of ``gmm_dx``)
  and ``ref.gmm_dw`` against ``jax.vjp`` of the reference's plain
  ``repro.kernels.ref.gmm`` with x's rows past each block's count zeroed
  (the port's function: those rows' outputs are zero whatever x holds,
  so they take no gradient), with row counts (0, partial and full), no
  counts, experts no block names and experts named by several blocks;
  where the tiles align, dx also against the Pallas ``gmm`` in interpret
  mode run on ``w``'s transpose (the Pallas kernel has no VJP rule:
  ``jax.vjp`` through it raises ``NotImplementedError``);
* :class:`GroupedMatmul` (which ``gmm`` takes when grad is enabled and x
  or w requires grad) through ``torch.autograd`` against the two plain
  versions, and ``gmm``'s direct call without grad;
* ``moe_block_local``'s gradients for every leaf and for x against
  ``jax.vjp`` of ``repro.models.moe.moe_block_local``, top-1 and top-2,
  with capacity drops and without; the cotangents of the output and of
  the load-balance loss are random (the aux weight is not zeroed);
* ``moe_block_a2a``'s gradients (every leaf through the experts' ``expand``
  over dp, and x) against ``jax.vjp`` of the reference's per-shard block
  under ``jax.vmap`` over "model" inside ``jax.vmap`` over "data", at P_tp
  1/2/4 and P_dp 1/2, with drops (each shard's aux cotangent random);
* the argument lists ``gmm_dx`` and ``gmm_dw`` hand their C entry points,
  and their routing, with ``on_card`` forced, as no kernel runs here;
* the persistent tensor-core kernels' launch geometry, as their C
  entries size it from the tile constants in ``csrc/moe_gmm_dx.cu`` and
  ``csrc/moe_gmm_dw.cu``: walked as the kernels walk it, every output
  tile exactly once and a pass's stores inside its pass, at
  ``chip_smoke.py``'s phase 2b shapes and SM counts of 132, 7 and 1.

Inputs are made with numpy from a seed.  Tolerances: the grouped matmul's
backward in float32 within 1e-5 of the largest |element| (both sides sum
the same float32 products in other orders), in bf16 within 2^-7 of it (the
port rounds each expert's float32 sum once; the reference's bf16 vjp
rounds each block's product to bf16 before it adds an expert's blocks in
bf16, so dw in bf16 is held against the reference's float32 vjp of the
same bf16 values, and dx, one block a row, against its bf16 vjp); a
block's gradients per leaf within 1e-4 of the leaf's largest
|element| (``GRAD_TOL``, chip_smoke.py's card-against-CPU limit: float32
through dispatch, three products, SiLU and combine in other orders)."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_port_ref import reference_core  # noqa: E402,F401

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import MoEConfig, get_smoke_config  # noqa: E402
from repro_torch.distributed.moe_ep import expert_views  # noqa: E402
from repro_torch.kernels import _nvcc  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v3-671b"]
GMM_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
GRAD_TOL = (1e-4, 1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _f32(a):
    return np.asarray(torch.as_tensor(a).float()) if isinstance(
        a, torch.Tensor) else np.asarray(a, dtype=np.float32)


def _close_to_largest(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# --------------------------------------------------- the grouped matmul
def _gmm_case(rng, E, T, Din, Dout, BT, order, counts):
    """x, dy, w (float32 numpy), block experts and counts (None or int)."""
    nb = T // BT
    x = rng.standard_normal((T, Din)).astype(np.float32)
    dy = rng.standard_normal((T, Dout)).astype(np.float32)
    w = (rng.standard_normal((E, Din, Dout)) * Din ** -0.5).astype(
        np.float32)
    if order == "arange":
        be = np.arange(nb) % E                # every expert, Pd = nb / E
    else:
        be = rng.integers(0, E - 1, size=nb)  # expert E - 1 never named
        be[:2] = be[0]                        # one expert twice in a row
    if counts is None:
        rows = None
    elif counts == "zero":
        rows = np.zeros(nb, np.int64)
    else:
        rows = rng.integers(0, BT + 1, size=nb)
        rows[:3] = [0, max(1, BT // 3), BT][:nb]
    return x, dy, w, be.astype(np.int32), rows


def _mask(rows, T, BT):
    """(T, 1) float32: 1 on the counted rows, 0 past each block's count."""
    if rows is None:
        return np.ones((T, 1), np.float32)
    return (np.arange(BT)[None, :] < rows[:, None]).reshape(T, 1).astype(
        np.float32)


GMM_CASES = [  # E, T, Din, Dout, block_t, block experts, counts
    (4, 256, 128, 256, 32, "arange", "partial"),     # Pd = 2: each twice
    (3, 96, 128, 256, 8, "random", "partial"),       # unsorted, repeats
    (5, 168, 64, 128, 24, "random", None),
    (4, 96, 100, 77, 12, "random", "partial"),       # ragged widths
    (3, 64, 128, 256, 16, "arange", "zero"),
    (6, 36, 40, 24, 1, "random", "partial"),         # one-row blocks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E, T, Din, Dout, BT, order, counts", GMM_CASES)
def test_gmm_backward_plain_versions_match_the_reference_vjp(
        E, T, Din, Dout, BT, order, counts, dtype):
    """``ref.gmm(dy, w.transpose(1, 2), ...)`` and ``ref.gmm_dw`` against
    ``jax.vjp`` of ``jref.gmm`` on x with the rows past the counts zeroed;
    an expert no counted row reaches has an exactly zero gradient; where
    the Pallas tiles align, dx against the Pallas kernel run on wᵀ."""
    rng = np.random.default_rng(E * 100 + T + BT)
    x, dy, w, be, rows = _gmm_case(rng, E, T, Din, Dout, BT, order, counts)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    m = jnp.asarray(_mask(rows, T, BT))
    jx, jdy, jw = (jnp.asarray(a).astype(jdt) for a in (x, dy, w))
    jbe = jnp.asarray(be)

    def f(x_, w_):
        return jref.gmm(x_ * m.astype(x_.dtype), w_, jbe, BT)
    _y, vjp = jax.vjp(f, jx, jw)
    want_dx, want_dw = vjp(jdy)
    if dtype == "bfloat16":     # dw: the same bf16 values, summed in float32
        _y, vjp = jax.vjp(f, jx.astype(jnp.float32), jw.astype(jnp.float32))
        want_dw = vjp(jdy.astype(jnp.float32))[1]
    tx, tdy, tw = (torch.from_numpy(a).to(tdt) for a in (x, dy, w))
    tbe = torch.from_numpy(be)
    trows = None if rows is None else torch.from_numpy(rows)
    dx = ref.gmm(tdy, tw.transpose(1, 2), tbe, BT, trows)
    dw = ref.gmm_dw(tx, tdy, tbe, BT, trows, E)
    assert dx.dtype == tdt and dx.shape == (T, Din)
    assert dw.dtype == tdt and dw.shape == (E, Din, Dout)
    _close_to_largest(dx, want_dx, GMM_TOL[dtype], "dx")
    _close_to_largest(dw, want_dw, GMM_TOL[dtype], "dw")
    n = np.full(len(be), BT) if rows is None else np.clip(rows, 0, BT)
    reached = np.bincount(be, weights=n, minlength=E) > 0
    assert not dw[torch.from_numpy(~reached)].any()
    assert order == "arange" or not reached[E - 1]
    if Din % 128 == 0 and Dout % 128 == 0 and BT % 8 == 0:
        pallas = jops.gmm(jdy * m.astype(jdt), jnp.swapaxes(jw, 1, 2), jbe,
                          block_t=BT, block_n=min(Din, 512),
                          block_k=min(Dout, 512))
        _close_to_largest(dx, pallas, GMM_TOL[dtype], "dx vs Pallas")


@pytest.mark.parametrize("needs", ["both", "x", "w"])
def test_grouped_matmul_function_runs_both_plain_backwards(needs):
    """``gmm`` with grad enabled and x or w requiring grad goes through
    ``GroupedMatmul``; its gradients are the two plain versions' on the
    same dy, bit for bit, and only the inputs that require grad get one;
    without grad (or with neither requiring it) ``gmm`` calls the plain
    version directly."""
    rng = np.random.default_rng(4)
    x, dy, w, be, rows = _gmm_case(rng, 3, 48, 16, 24, 8, "random",
                                   "partial")
    tx = torch.from_numpy(x).requires_grad_(needs in ("both", "x"))
    tw = torch.from_numpy(w).requires_grad_(needs in ("both", "w"))
    tbe, trows, tdy = (torch.from_numpy(a) for a in (be, rows, dy))
    y = MG.gmm(tx, tw, tbe, 8, trows)
    assert type(y.grad_fn).__name__ == "GroupedMatmulBackward"
    assert torch.equal(y.detach(), ref.gmm(tx.detach(), tw.detach(), tbe, 8,
                                           trows))
    ins = [t for t in (tx, tw) if t.requires_grad]
    got = torch.autograd.grad(y, ins, tdy)
    want = {"x": ref.gmm(tdy, tw.detach().transpose(1, 2), tbe, 8, trows),
            "w": ref.gmm_dw(tx.detach(), tdy, tbe, 8, trows, 3)}
    names = [n for n in ("x", "w") if needs in ("both", n)]
    for n, g in zip(names, got):
        assert torch.equal(g, want[n]), n
    with torch.no_grad():
        assert MG.gmm(tx, tw, tbe, 8, trows).grad_fn is None
    assert MG.gmm(tx.detach(), tw.detach(), tbe, 8, trows).grad_fn is None


# ---------------------------------------------------------- the MoE blocks
def _configs(arch, E=8, **moe):
    """The reference's and the port's float32 smoke configs with ``E``
    experts and the ``moe`` changes."""
    import dataclasses
    jcfg = jax_smoke(arch).replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, n_experts=E,
                                                **moe))
    return jcfg, get_smoke_config(arch).replace(
        dtype="float32", moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))


def _skewed(rng, shape):
    """Normal inputs plus one shared offset, twice their scale: the
    router's choices crowd some experts past capacity."""
    return (rng.standard_normal(shape)
            + 2 * rng.standard_normal(shape[-1])).astype(np.float32)


def _dropped(p, x, cfg):
    """Assignments the port's dispatch drops for x (..., B, S, d)."""
    xt = torch.from_numpy(x).reshape(*x.shape[:-3], -1, x.shape[-1])
    w, e, _ = PM.route(p, xt, cfg.moe)
    C = PM.capacity(xt.shape[-2], cfg.moe)
    _xs, slot, _kw = PM.dispatch(xt, e, w, cfg.moe.n_experts, C)
    return int((slot == cfg.moe.n_experts * C).sum())


def _jit_vjp(f, jp, x, ct, ct_aux):
    """The reference's gradients of ``f(params, x)`` → (out, aux) for the
    cotangents (ct, ct_aux), under ``jax.jit``."""
    def grads(q, xx, c, ca):
        return jax.vjp(f, q, xx)[1]((c, ca))
    return jax.jit(grads)(jp, jnp.asarray(x), jnp.asarray(ct),
                          jnp.asarray(ct_aux))


def _check_grads(p_leaves, got, want_tree, want_x, what):
    """Each leaf's and x's gradient within ``GRAD_TOL`` of its largest."""
    want = dict(flatten(_torch(_np(want_tree))))
    assert len(got) == len(p_leaves) + 1
    for (path, _t), g in zip(p_leaves, got[:-1]):
        w = want[path].float()
        scale = max(GRAD_TOL[1], float(w.abs().max()))
        d = float((g.float() - w).abs().max())
        assert d <= GRAD_TOL[0] * scale, f"{what} {path}: {d} of {scale}"
    w = torch.from_numpy(np.array(want_x))
    scale = max(GRAD_TOL[1], float(w.abs().max()))
    assert float((got[-1] - w).abs().max()) <= GRAD_TOL[0] * scale, \
        f"{what} x"


@pytest.mark.parametrize("top_k, cf, drops", [(1, 1.25, True),
                                               (2, 1.25, True),
                                               (1, 8.0, False),
                                               (2, 8.0, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_local_gradients_match_the_reference_vjp(arch, top_k, cf,
                                                           drops):
    jcfg, cfg = _configs(arch, top_k=top_k, capacity_factor=cf)
    jp = JM.init_moe(jax.random.PRNGKey(3), jcfg)
    p = _torch(_np(jp))
    rng = np.random.default_rng(11 + top_k)
    x = _skewed(rng, (2, 12, cfg.d_model))
    ct = rng.standard_normal(x.shape).astype(np.float32)
    ct_aux = np.float32(rng.uniform(0.5, 2.0))
    assert (_dropped(p, x[None, None], cfg) > 0) == drops
    want_p, want_x = _jit_vjp(lambda q, xx: JM.moe_block_local(q, xx, jcfg),
                              jp, x, ct, ct_aux)
    flat = flatten(p)
    ins = [t.requires_grad_(True) for _path, t in flat]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = PM.moe_block_local(p, tx, cfg)
    got = torch.autograd.grad((out, aux), ins + [tx],
                              (torch.from_numpy(ct), torch.tensor(ct_aux)),
                              allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(ins + [tx], got)]
    _check_grads(flat, got, want_p, want_x, f"{arch} local")


def _reference_a2a(jp, jcfg, x):
    """The reference's per-shard ``moe_block_a2a`` over x (P_dp, P_tp, B_l,
    S_l, d), as ``tests/test_torch_moe_ep.py`` runs it: vmap over "model"
    with each shard's slice of the experts, inside vmap over "data" with
    the experts broadcast."""
    Pt = x.shape[1]
    experts = jax.tree.map(lambda w: w.reshape(Pt, -1, *w.shape[1:]),
                           jp["experts"])
    rest = {k: v for k, v in jp.items() if k != "experts"}

    def shard(ex, xl):
        return JM.moe_block_a2a(dict(rest, experts=ex), xl, jcfg, "model")

    return jax.vmap(jax.vmap(shard, in_axes=(0, 0), axis_name="model"),
                    in_axes=(None, 0), axis_name="data")(experts, x)


@pytest.mark.parametrize("Pd", [1, 2])
@pytest.mark.parametrize("Pt", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_a2a_gradients_match_the_reference_under_vmap(arch, Pt,
                                                                Pd):
    """Every leaf's gradient (the experts' through their ``expand`` over
    the dp shards, reaching the leaf once) and x's, each shard dropping
    assignments past its capacity."""
    jcfg, cfg = _configs(arch)
    jp = JM.init_moe(jax.random.PRNGKey(1), jcfg)
    p = _torch(_np(jp))
    rng = np.random.default_rng(10 * Pt + Pd)
    x = _skewed(rng, (Pd, Pt, 2, 12, cfg.d_model))
    ct = rng.standard_normal(x.shape).astype(np.float32)
    ct_aux = rng.uniform(0.5, 2.0, (Pd, Pt)).astype(np.float32)
    assert _dropped(p, x, cfg) > 0
    want_p, want_x = _jit_vjp(lambda q, xx: _reference_a2a(q, jcfg, xx),
                              jp, x, ct, ct_aux)
    flat = flatten(p)
    ins = [t.requires_grad_(True) for _path, t in flat]
    tp = dict(p, experts=expert_views(p["experts"], Pd, Pt))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = PM.moe_block_a2a(tp, tx, cfg)
    assert out.shape == x.shape and aux.shape == (Pd, Pt)
    got = torch.autograd.grad((out, aux), ins + [tx],
                              (torch.from_numpy(ct), torch.from_numpy(ct_aux)))
    _check_grads(flat, got, want_p, want_x, f"{arch} a2a Pt={Pt} Pd={Pd}")


# ----------------------------------------------------------- the wrappers
@pytest.mark.parametrize("dtype, off, route", [
    (torch.bfloat16, 0, "mma"), (torch.float32, 0, "simt"),
    (torch.bfloat16, 1, "simt")])
def test_backward_wrappers_match_their_c_signatures(monkeypatch, dtype, off,
                                                    route):
    """On the card ``GroupedMatmul``'s backward hands ``gmm_dx`` and
    ``gmm_dw`` the forward's w (no copy: its data pointer), its int32
    block experts and counts, and the shapes (T, E, Din, Dout, block_t),
    each pointer an int (the counts None when there are none), exactly the
    arguments each C signature declares; the entry points follow
    ``_variant`` (``*_mma`` on the tensor-core route, ``gmm_dx_mma`` from
    its own library; the CUDA-core ones with their dtype code first), the
    stream last, and each wrapper counts one launch and its route.  Rehearsed on the CPU with ``on_card`` forced true and
    the library calls recorded, as no kernel runs here."""
    got = []
    monkeypatch.setattr(_nvcc, "on_card", lambda what, *t: True)
    monkeypatch.setattr(_nvcc, "stream", lambda t: 7)
    for lib in (MG._LIB, MG._DX_LIB, MG._DW_LIB):
        monkeypatch.setattr(lib, "call",
                            lambda fn, *a, lib=lib: got.append((lib, fn, a)))
    T, E, Din, Dout, BT = 48, 3, 64, 128, 8

    def buf(*shape):         # off > 0: a base one element into a buffer
        n = int(np.prod(shape))
        return torch.zeros(n + off, dtype=dtype)[off:].view(shape)
    x, w = buf(T, Din).requires_grad_(), buf(E, Din, Dout).requires_grad_()
    be = torch.tensor([2, 0, 2, 1, 0, 1])
    for rows in (torch.tensor([8, 0, 3, 8, 1, 5]), None):
        got.clear()
        before = {n: (getattr(MG, n).launches, dict(getattr(MG, n).routes))
                  for n in ("gmm_dx", "gmm_dw")}
        y = MG.gmm(x, w, be, BT, rows)
        torch.autograd.grad(y, (x, w), buf(T, Dout))
        names = [fn for _lib, fn, _a in got]
        sfx = "_mma" if route == "mma" else ""
        assert names == [f"gmm_fwd{sfx}", f"gmm_dx{sfx}", f"gmm_dw{sfx}"]
        libs = [lib for lib, _fn, _a in got]
        assert libs == [MG._LIB, MG._DX_LIB if route == "mma" else MG._LIB,
                        MG._DW_LIB]
        for lib, fn, args in got:
            sig = lib.signatures[fn]
            assert len(args) == len(sig)
            for a, ty in zip(args, sig):
                assert (a is None or isinstance(a, int)) \
                    if ty is ctypes.c_void_p else isinstance(a, int)
            a = args[1:] if route == "simt" else args
            if route == "simt":
                assert args[0] == {torch.float32: 0, torch.bfloat16: 1}[dtype]
            assert a[5:10] == (T, E, Din, Dout, BT)
            assert len(a) == 11 and a[-1] == 7
            assert (a[3] is None) == (rows is None)
            if fn != f"gmm_dw{sfx}":
                assert a[1] == w.data_ptr()
        for n in ("gmm_dx", "gmm_dw"):
            k = getattr(MG, n)
            assert k.launches == before[n][0] + 1
            assert k.routes[route] == before[n][1][route] + 1


# ------------------------------------------- the persistent kernels' walk
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _constants(source, *names):
    """The ``constexpr int`` constants ``names`` of ``csrc/<source>``."""
    text = (CSRC / source).read_text()
    out = []
    for name in names:
        found = re.findall(rf"constexpr int {name} = (\d+);", text)
        assert len(found) == 1, (source, name)
        out.append(int(found[0]))
    return out


def _phase_2b_shapes():
    """(E, Din, Dout, block_t, blocks) of every case of ``chip_smoke.py``'s
    phase 2b (its ``gmm_bwd_cases``, blocks as ``gmm_bwd_inputs`` makes
    them), each with Din and Dout swapped too (dx's product is Dout deep
    and Din wide)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shapes = set()
    for _label, E, din, dout, bt, pd, _dt, order, _kind, _mis in \
            cs.gmm_bwd_cases():
        nb = pd * E if order == "arange" else max(2 * E, 4)
        shapes |= {(E, din, dout, bt, nb), (E, dout, din, bt, nb)}
    return sorted(shapes)


@pytest.mark.parametrize("n_sm", [132, 7, 1])
def test_dx_geometry_covers_every_output_tile_once(n_sm):
    """``gmm_dx_mma``'s launch as its C entry sizes it (passes of
    min(block_t, kPass) rows, 256-column tiles for passes of at most kWide
    rows and 128-column ones above, min(items, SMs) persistent CTAs taking
    items c, c + ctas, ..., each decoded as ``item_at`` does: block, pass,
    column tile) covers every (row, column tile) of dx exactly once; a
    pass holds at most five m64 tiles, and its m64 tiles' 64-row stores,
    clipped to the block, stay inside the pass (so no pass writes zeros
    over the next one's rows)."""
    k_pass, k_wide = _constants("moe_gmm_dx.cu", "kPass", "kWide")
    assert k_pass <= 5 * 64
    for E, Din, Dout, bt, nb in _phase_2b_shapes():
        T = nb * bt
        pass_rows = min(bt, k_pass)
        tile_n = 256 if pass_rows <= k_wide else 128
        passes, tiles = -(-bt // pass_rows), -(-Din // tile_n)
        items = nb * passes * tiles
        ctas = min(items, n_sm)
        walked = sorted(it for c in range(ctas)
                        for it in range(c, items, ctas))
        assert walked == list(range(items))
        hits = np.zeros((T, tiles), np.int64)
        for it in walked:
            bp, tile = divmod(it, tiles)
            blk, p = divmod(bp, passes)
            p0 = p * pass_rows
            span = min(pass_rows, bt - p0)
            assert span >= 1
            stored = min(p0 + 64 * -(-span // 64), bt)
            assert stored == p0 + span, (bt, p0, span)
            hits[blk * bt + p0:blk * bt + p0 + span, tile] += 1
        assert (hits == 1).all(), (E, Din, Dout, bt, nb, n_sm)
        assert (tiles - 1) * tile_n < Din <= tiles * tile_n


@pytest.mark.parametrize("n_sm", [132, 7, 1])
def test_dw_geometry_covers_every_gradient_tile_once(n_sm):
    """``gmm_dw_mma``'s launch as its C entry sizes it: an item is (expert,
    pair of kTileM x kTileN tile rows, tile column), the tile column
    fastest; clusters of two CTAs, as many as fit the card at once (here
    at most ``n_sm // 2``, and at most one an item), take items c, c +
    clusters, ..., CTA rank r the item's tile row 2 * pair + r.  For every
    such cluster count the items cover every tile of every expert's (Din,
    Dout) gradient exactly once, an expert's tiles adjacent in item order;
    a second tile row past Din is only the odd tile count's last."""
    tm, tn = _constants("moe_gmm_dw.cu", "kTileM", "kTileN")
    for E, Din, Dout, _bt, _nb in _phase_2b_shapes():
        tiles_m, tiles_n = -(-Din // tm), -(-Dout // tn)
        pairs_m = -(-tiles_m // 2)
        items = E * pairs_m * tiles_n
        most = min(items, max(1, n_sm // 2))
        for pairs in sorted({most, max(1, most - 1), 1}):
            walked = sorted(it for c in range(pairs)
                            for it in range(c, items, pairs))
            assert walked == list(range(items))
            hits = np.zeros((E, 2 * pairs_m, tiles_n), np.int64)
            experts = []
            for it in walked:
                e, tile = divmod(it, pairs_m * tiles_n)
                p, col = divmod(tile, tiles_n)
                for rank in (0, 1):
                    hits[e, 2 * p + rank, col] += 1
                experts.append(e)
            assert (hits == 1).all(), (E, Din, Dout, n_sm, pairs)
            assert hits.shape[1] - tiles_m in (0, 1)
            assert experts == sorted(experts)
