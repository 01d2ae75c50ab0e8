"""m2dec_tpu_torch intra/deblock math and wavefronts against the JAX
package: the mode and filter functions against their jnp originals, and
the port's run_wavefronts (the plain PyTorch scans on the CPU) against
the XLA scans (wavefront.intra_scan / deblock_scan) and the Pallas
kernels in interpret mode, on random plans as in
tests/test_pallas_kernels.py. Exact comparisons (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import rand_planes, rand_wavefront_plan, torch_plan

import m2dec_tpu.codecs.h264.pallas_wavefront as PW
import m2dec_tpu.codecs.h264.wavefront as WF
from m2dec_tpu.codecs.h264 import reconstruct as R
from m2dec_tpu.codecs.h264 import tables as T
from m2dec_tpu_torch.codecs.h264 import reconstruct as TR
from m2dec_tpu_torch.codecs.h264 import wavefront as TWF
from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
from m2dec_tpu_torch.codecs.h264.state import tables_to_torch

TABS = tables_to_torch("cpu")
JTABS = (jnp.asarray(np.asarray(T.DEBLOCK_ALPHA, np.int32)),
         jnp.asarray(np.asarray(T.DEBLOCK_BETA, np.int32)),
         jnp.asarray(np.asarray(T.DEBLOCK_TC0, np.int32)))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def _ri(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


def _both(fn_t, fn_j, *arrays, t_extra=(), j_extra=()):
    return (fn_t(*(torch.from_numpy(np.array(a)) for a in arrays), *t_extra),
            fn_j(*(jnp.asarray(a) for a in arrays), *j_extra))


def test_intra4_and_intra8_modes():
    rng = np.random.default_rng(0)
    L = 500
    got, want = _both(
        TR.intra4_modes, R.intra4_modes, _ri(rng, 0, 256, (L, 4)),
        _ri(rng, 0, 256, (L, 8)), _ri(rng, 0, 256, L), _ri(rng, 0, 16, L),
        _ri(rng, 0, 9, L), t_extra=(TABS["i4_mat"],), j_extra=(jnp,))
    _eq(got, want)
    got, want = _both(
        TR.intra8_modes, R.intra8_modes, _ri(rng, 0, 256, (L, 8)),
        _ri(rng, 0, 256, (L, 8)), _ri(rng, 0, 256, L),
        _ri(rng, 0, 256, (L, 8)), _ri(rng, 0, 16, L), _ri(rng, 0, 9, L),
        t_extra=(TABS["i8_mat"],), j_extra=(jnp,))
    _eq(got, want)


def test_intra16_and_chroma_modes():
    rng = np.random.default_rng(1)
    L = 500
    got, want = _both(
        TR.intra16_modes, R.intra16_modes, _ri(rng, 0, 256, (L, 16)),
        _ri(rng, 0, 256, (L, 16)), _ri(rng, 0, 256, L), _ri(rng, 0, 4, L),
        _ri(rng, 0, 4, L), j_extra=(jnp,))
    _eq(got, want)
    got, want = _both(
        TR.intra_chroma_modes, R.intra_chroma_modes,
        _ri(rng, 0, 256, (L, 8)), _ri(rng, 0, 256, (L, 8)),
        _ri(rng, 0, 256, L), _ri(rng, 0, 4, L), _ri(rng, 0, 4, L),
        j_extra=(jnp,))
    _eq(got, want)


@pytest.mark.parametrize("nlines,shift", [(16, 2), (8, 1)])
def test_deblock_edge_params_and_filters(nlines, shift):
    rng = np.random.default_rng(2 + nlines)
    L = 400
    args = (_ri(rng, 0, 256, L), _ri(rng, 0, 2, L), _ri(rng, -20, 40, (L, 2)))
    got = TR._edge_params(*(torch.from_numpy(a) for a in args), nlines,
                          shift, TABS["alpha"], TABS["beta"], TABS["tc0"])
    want = R._edge_params(*(jnp.asarray(a) for a in args), nlines, shift,
                          *JTABS, jnp)
    for g, w in zip(got, want):
        _eq(g, w)
    s, al, be, tc0 = (np.asarray(w) for w in want)
    # near-flat lines so that every filter branch is taken
    base = _ri(rng, 0, 256, (L, 1, 1))
    width = 8 if nlines == 16 else 4
    cols = np.clip(base + _ri(rng, -12, 12, (L, nlines, width)), 0, 255)
    fn_t, fn_j = ((TR._filter_lines_luma, R._filter_lines_luma)
                  if nlines == 16 else
                  (TR._filter_lines_chroma, R._filter_lines_chroma))
    got, want = _both(fn_t, fn_j, cols.astype(np.int32), s, al, be, tc0,
                      j_extra=(jnp,))
    _eq(got, want)
    assert (np.asarray(want) != cols).any()


def test_skew_roundtrip_matches_jax():
    mb_w, mb_h = 5, 3
    g = WF.get_geom(mb_w, mb_h)
    y, cb, _ = rand_planes(mb_w, mb_h, 0)
    sky = TWF.skew_luma(torch.from_numpy(y), g)
    _eq(sky, WF.skew_luma(jnp.asarray(y), g, jnp))
    skc = TWF.skew_chroma(torch.from_numpy(cb), g)
    _eq(skc, WF.skew_chroma(jnp.asarray(cb), g, jnp))
    _eq(TWF.unskew_luma(sky, g), y)
    _eq(TWF.unskew_chroma(skc, g), cb)


def _jax_scans(P, y, cb, cr, mb_w, mb_h, has_i8, deblock):
    g = WF.get_geom(mb_w, mb_h)
    Pd = WF.diag_gather(P, g, has_i8, deblock, jnp)
    sky = WF.skew_luma(jnp.asarray(y), g, jnp)
    skb = WF.skew_chroma(jnp.asarray(cb), g, jnp)
    skr = WF.skew_chroma(jnp.asarray(cr), g, jnp)
    ik = WF._INTRA_KEYS + (WF._I8_KEYS if has_i8 else ())
    sky, skb, skr = WF.intra_scan(sky, skb, skr, {k: Pd[k] for k in ik}, g,
                                  has_i8, jnp)
    if deblock:
        sky, skb, skr = WF.deblock_scan(
            sky, skb, skr, {k: Pd[k] for k in WF._DEB_KEYS}, g, jnp, JTABS)
    return (WF.unskew_luma(sky, g, jnp), WF.unskew_chroma(skb, g, jnp),
            WF.unskew_chroma(skr, g, jnp))


def _port(P, y, cb, cr, mb_w, mb_h, has_i8, deblock):
    return WK.run_wavefronts(
        torch.from_numpy(y.copy()), torch.from_numpy(cb.copy()),
        torch.from_numpy(cr.copy()), torch_plan(P), has_i8, deblock, mb_w,
        mb_h)


@pytest.mark.parametrize("mb_h,has_i8,wide", [
    (2, True, False), (3, False, False), (2, False, True), (3, True, True)])
def test_run_wavefronts_vs_xla_scans(mb_h, has_i8, wide):
    mb_w = 4
    P = rand_wavefront_plan(mb_w, mb_h, 10 + mb_h, wide=wide)
    y, cb, cr = rand_planes(mb_w, mb_h, 10 + mb_h)
    got = _port(P, y, cb, cr, mb_w, mb_h, has_i8, True)
    want = _jax_scans(P, y, cb, cr, mb_w, mb_h, has_i8, True)
    for gt, w in zip(got, want):
        _eq(gt, w)


def test_run_wavefronts_without_deblock():
    mb_w, mb_h = 3, 2
    P = rand_wavefront_plan(mb_w, mb_h, 7)
    y, cb, cr = rand_planes(mb_w, mb_h, 7)
    got = _port(P, y, cb, cr, mb_w, mb_h, True, False)
    want = _jax_scans(P, y, cb, cr, mb_w, mb_h, True, False)
    for gt, w in zip(got, want):
        _eq(gt, w)


@pytest.mark.parametrize("has_i8,mb_h", [(True, 2), (False, 3)])
def test_run_wavefronts_vs_pallas_interpret(has_i8, mb_h):
    """The same plans through the four Pallas kernels (interpret mode),
    which the CUDA kernels replace."""
    mb_w = 4
    g = WF.get_geom(mb_w, mb_h)
    P = rand_wavefront_plan(mb_w, mb_h, 3)
    y, cb, cr = rand_planes(mb_w, mb_h, 3)
    Pd = WF.diag_gather(P, g, has_i8, True, jnp, full=True)
    want = PW.run_wavefronts(
        jnp.asarray(y, jnp.int32), jnp.asarray(cb, jnp.int32),
        jnp.asarray(cr, jnp.int32), Pd, g, has_i8, True, mb_w, mb_h, jnp,
        interpret=True)
    got = _port(P, y, cb, cr, mb_w, mb_h, has_i8, True)
    for gt, w in zip(got, want):
        _eq(gt, w)
