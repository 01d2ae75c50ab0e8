"""m2dec_tpu_torch residual transforms and quarter-pel motion
compensation against the JAX package's functions (jnp on the CPU), on
seeded numpy inputs. Integer decode: every comparison is exact
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (pins torch to one thread)

from m2dec_tpu.codecs.h264 import reconstruct as R
from m2dec_tpu_torch.codecs.h264 import reconstruct as TR


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_idct4_idct8():
    rng = np.random.default_rng(0)
    c4 = rng.integers(-4096, 4096, (50, 16)).astype(np.int32)
    c8 = rng.integers(-4096, 4096, (30, 64)).astype(np.int32)
    _eq(TR.idct4_batch(_t(c4)), R.idct4_batch(jnp.asarray(c4), jnp))
    _eq(TR.idct8_batch(_t(c8)), R.idct8_batch(jnp.asarray(c8), jnp))


@pytest.mark.parametrize("has_i8", [True, False])
def test_residual_mb_and_chroma(has_i8):
    rng = np.random.default_rng(1)
    n = 12
    cl = rng.integers(-2000, 2000, (n, 256)).astype(np.int32)
    t8 = rng.integers(0, 2, n).astype(np.int32)
    cc = rng.integers(-2000, 2000, (n, 2, 4, 16)).astype(np.int32)
    _eq(TR.residual_mb(_t(cl), _t(t8), has_i8=has_i8),
        R.residual_mb(jnp.asarray(cl), jnp.asarray(t8), jnp, has_i8=has_i8))
    _eq(TR.residual_chroma(_t(cc)), R.residual_chroma(jnp.asarray(cc), jnp))


def _refs(R_, H, W, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (R_, H, W)).astype(np.uint8)


def test_pad_and_subpel_planes():
    refs = _refs(2, 32, 48, 2)
    rp = TR._pad_refs_edge(_t(refs))
    _eq(rp, R._pad_refs_edge(jnp.asarray(refs), jnp))
    p4 = TR._halfpel_planes(rp)
    j4 = R._halfpel_planes(jnp.asarray(rp.numpy()), jnp)
    _eq(p4, j4)
    _eq(TR._qpel_planes(p4, R._HP_TAB), R._qpel_planes(j4, jnp))


def _mc_inputs(B, H, W, R_, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1, R_ + 1, B).astype(np.int32),       # slot
            rng.integers(lo, hi + W, B).astype(np.int32),       # posx
            rng.integers(lo, hi + H, B).astype(np.int32),       # posy
            rng.integers(0, 8, B).astype(np.int32),             # fracx
            rng.integers(0, 8, B).astype(np.int32)]             # fracy


def test_luma_mc_qp():
    H, W, R_ = 32, 48, 2
    refs = _refs(R_, H, W, 3)
    jp = R._pad_refs_edge(jnp.asarray(refs), jnp)
    j16 = R._qpel_planes(R._halfpel_planes(jp, jnp), jnp)
    t16 = _t(np.asarray(j16))
    args = _mc_inputs(300, H, W, R_, 4, -30, 30)
    args[3] &= 3
    args[4] &= 3
    _eq(TR._luma_mc_qp(t16, *(_t(a) for a in args), H, W),
        R._luma_mc_qp(j16, *(jnp.asarray(a) for a in args), jnp, H, W))


def test_chroma_mc_ilv():
    Hc, Wc, R_ = 16, 24, 3
    cb, cr = _refs(R_, Hc, Wc, 5), _refs(R_, Hc, Wc, 6)
    jilv = R._interleave_chroma(R._pad_refs_edge(jnp.asarray(cb), jnp),
                                R._pad_refs_edge(jnp.asarray(cr), jnp), jnp)
    tilv = TR._interleave_chroma(TR._pad_refs_edge(_t(cb)),
                                 TR._pad_refs_edge(_t(cr)))
    _eq(tilv, jilv)
    args = _mc_inputs(300, Hc, Wc, R_, 7, -12, 12)
    gb, gr = TR._chroma_mc_ilv(tilv, *(_t(a) for a in args), Hc, Wc)
    wb, wr = R._chroma_mc_ilv(jilv, *(jnp.asarray(a) for a in args), jnp,
                              Hc, Wc)
    _eq(gb, wb)
    _eq(gr, wr)


def test_combine_wp():
    rng = np.random.default_rng(8)
    B = 400
    p0 = rng.integers(0, 256, (B, 4, 4)).astype(np.int32)
    p1 = rng.integers(0, 256, (B, 4, 4)).astype(np.int32)
    both = rng.integers(0, 2, (B, 1, 1)).astype(bool)
    w0 = rng.integers(-128, 128, (B, 1, 1)).astype(np.int32)
    w1 = rng.integers(-128, 128, (B, 1, 1)).astype(np.int32)
    o = rng.integers(-128, 128, (B, 1, 1)).astype(np.int32)
    s = rng.integers(0, 8, (B, 1, 1)).astype(np.int32)
    args = (p0, p1, both, w0, w1, o, s)
    _eq(TR._combine_wp(*(_t(a) for a in args)),
        R._combine_wp(*(jnp.asarray(a) for a in args), jnp))


def _rand_inter_plan(mb_w, mb_h, R_, seed):
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    slot = rng.integers(-1, R_, (n, 4, 2)).astype(np.int32)
    slot[rng.random(n) < 0.2] = -1          # intra MBs: no prediction
    mv = rng.integers(-160, 160, (n, 16, 2, 2)).astype(np.int32)
    wp = np.zeros((n, 4, 3, 4), np.int32)
    wp[..., 0] = rng.integers(-20, 64, (n, 4, 3))
    wp[..., 1] = rng.integers(-20, 64, (n, 4, 3))
    wp[..., 2] = rng.integers(-30, 30, (n, 4, 3))
    wp[..., 3] = rng.integers(0, 7, (n, 4, 3))
    return mv, slot, wp


@pytest.mark.parametrize("with_aux", [False, True])
def test_inter_pass_dense(with_aux):
    """The dense MC path, plain (both predictions for every cell) and
    with the host aux (compact used-slot list + bi-cell list); the port
    takes a leading stream axis (here one stream)."""
    mb_w, mb_h, pool = 3, 2, 4
    H, W = mb_h * 16, mb_w * 16
    mv, slot, wp = _rand_inter_plan(mb_w, mb_h, pool, 9)
    ry = _refs(pool, H, W, 10)
    rcb = _refs(pool, H // 2, W // 2, 11)
    rcr = _refs(pool, H // 2, W // 2, 12)
    used = bi = None
    if with_aux:
        sf = slot[None].copy()
        ((used, bi, _, _, _),) = R._derive_mc_aux(
            [sf], pool, [mv[None]], [wp[None]], [{}], mb_w, mb_h,
            compact=False)
        slot, used, bi = sf[0], used[0], bi[0]
        assert (bi < mb_w * mb_h * 16).any() and (bi == mb_w * mb_h * 16).any()
    got = TR.inter_pass(
        _t(mv), _t(slot), _t(wp), _t(ry)[None], _t(rcb)[None],
        _t(rcr)[None], mb_w, mb_h, R._HP_TAB,
        used=None if used is None else _t(used)[None],
        bi_idx=None if bi is None else _t(bi)[None])
    want = R.inter_pass(
        jnp.asarray(mv), jnp.asarray(slot), jnp.asarray(wp),
        jnp.asarray(ry), jnp.asarray(rcb), jnp.asarray(rcr), mb_w, mb_h,
        jnp, used=None if used is None else jnp.asarray(used),
        bi_idx=None if bi is None else jnp.asarray(bi))
    intra = (slot < 0).all(axis=(1, 2))
    for g, w in zip(got, want):
        # intra MBs' predictions are unused garbage in both packages
        _eq(g[torch.from_numpy(~intra)], np.asarray(w)[~intra])
