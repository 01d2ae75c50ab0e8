"""The CUDA kernels of m2dec_tpu_torch against their plain PyTorch
versions, on the card: the four H.264 wavefront kernels (all on the row
schedule: one launch per pass) on random plans, all-intra and
zero-strength plans, 20 times over, and on stacks of S streams in one
launch against S single-stream launches, the MPEG-2 8x8 IDCT on
random blocks and on MPEG-2 streams, and the H.265 CTU-tile intra
wavefront on random op words and on H.265 streams (against its plain
version and the Python decoder's oracle), and H.265 picture steps
replayed as CUDA graphs against the CPU's eager steps; exact equality
(integer decode, tolerance 0). The
tests marked ``cuda`` skip on a machine without a GPU. CPU tests show
the kernel dispatch cannot fall back to the plain version."""

import ctypes
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from torch_helpers import (
    rand_planes,
    rand_tile_inputs,
    rand_wavefront_plan,
    torch_plan,
)

from m2dec_tpu_torch import _build
from m2dec_tpu_torch.codecs.h264 import wavefront as WF
from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
from m2dec_tpu_torch.codecs.h265 import reconstruct as R265
from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK
from m2dec_tpu_torch.kernels import idct_kernels as IK

sys.path.insert(0, str(pathlib.Path(__file__).parent))

#: (mb_w, mb_h): tiny, odd, CIF and 1080p geometries
GEOMS = [(4, 2), (5, 3), (11, 9), (120, 68)]
#: and one MB column, and more rows than the card has SMs (the ticket
#: loop of the row-schedule kernels)
ROW_GEOMS = GEOMS + [(1, 9), (3, 150)]
#: the kernel wrappers and their plain versions, by pass
PASSES = {"intra_luma": (WK.intra_luma, WF.intra_luma_plain),
          "intra_chroma": (WK.intra_chroma, WF.intra_chroma_plain),
          "deblock_luma": (WK.deblock_luma, WF.deblock_luma_plain),
          "deblock_chroma": (WK.deblock_chroma, WF.deblock_chroma_plain)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


def _inputs(mb_w, mb_h, seed, dev, kinds=None):
    P = torch_plan(rand_wavefront_plan(mb_w, mb_h, seed, wide=True,
                                       kinds=kinds), dev)
    y, cb, cr = (torch.from_numpy(a).to(dev)
                 for a in rand_planes(mb_w, mb_h, seed))
    return P, y, cb, cr


def _same(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
    assert diff == 0, f"max abs err {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", ROW_GEOMS)
@pytest.mark.parametrize("has_i8", [True, False])
def test_intra_luma_kernel(cuda, mb_w, mb_h, has_i8):
    P, y, _, _ = _inputs(mb_w, mb_h, 1, cuda)
    want = WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
    n0 = WK.LAUNCHES["intra_luma"]
    got = WK.intra_luma(y.clone(), P, has_i8, mb_w, mb_h)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["intra_luma"] == n0 + 1
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("has_i8", [True, False])
def test_intra_luma_kernel_all_intra(cuda, has_i8):
    """Every MB intra (kinds 1-3) at 1080p: no MB skips its wait, the
    longest chain of the row schedule."""
    mb_w, mb_h = 120, 68
    P, y, _, _ = _inputs(mb_w, mb_h, 6, cuda, kinds=(1, 2, 3))
    want = WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
    _same(WK.intra_luma(y.clone(), P, has_i8, mb_w, mb_h), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,kinds",
                         [g + (None,) for g in ROW_GEOMS]
                         + [(120, 68, (1, 2, 3))])
def test_intra_chroma_kernel(cuda, mb_w, mb_h, kinds):
    """Random plans, and one with every MB intra (kinds 1-3) at 1080p:
    no MB skips its wait, the longest chain of the row schedule."""
    P, _, cb, cr = _inputs(mb_w, mb_h, 2, cuda, kinds=kinds)
    want = WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)
    n0 = WK.LAUNCHES["intra_chroma"]
    got = WK.intra_chroma(cb.clone(), cr.clone(), P, mb_w, mb_h)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["intra_chroma"] == n0 + 1
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", ROW_GEOMS)
def test_deblock_luma_kernel(cuda, mb_w, mb_h):
    P, y, _, _ = _inputs(mb_w, mb_h, 3, cuda)
    want = WF.deblock_luma_plain(y, P, mb_w, mb_h)
    n0 = WK.LAUNCHES["deblock_luma"]
    got = WK.deblock_luma(y.clone(), P, mb_w, mb_h)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["deblock_luma"] == n0 + 1
    _same(got, want)


def _pass_planes(name, y, cb, cr):
    """The planes pass ``name`` works on."""
    return (y,) if name.endswith("luma") else (cb, cr)


def _pass_args(name, P, mb_w, mb_h):
    """The arguments of pass ``name`` after its planes."""
    return (P, True, mb_w, mb_h) if name == "intra_luma" else (P, mb_w,
                                                               mb_h)


def _outs(got):
    return got if isinstance(got, tuple) else (got,)


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", [(11, 9), (120, 68)])
@pytest.mark.parametrize("name", ["deblock_luma", "deblock_chroma"])
def test_deblock_luma_kernel_zero_strength(cuda, mb_w, mb_h, name):
    """All edges of strength 0 (the luma pass, and the chroma pass): every
    MB takes the skip path and the planes come back unchanged, as from
    the plain version."""
    P, y, cb, cr = _inputs(mb_w, mb_h, 7, cuda)
    P["deb_str"].zero_()
    P["deb_str4"].zero_()
    kern, plain = PASSES[name]
    planes = _pass_planes(name, y, cb, cr)
    want = _outs(plain(*planes, P, mb_w, mb_h))
    for w, pl in zip(want, planes):
        _same(w, pl)
    got = _outs(kern(*(t.clone() for t in planes), P, mb_w, mb_h))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PASSES))
def test_row_kernels_repeat(cuda, name):
    """The 1080p random plan through a row-schedule pass 20 times, each
    run byte-equal to the plain version and 1 launch: a race between
    CTAs (a missed flag, a stale line of the row above, intra chroma's
    wait on the MB above rather than the one to its right) shows as a
    run that differs."""
    mb_w, mb_h = 120, 68
    P, y, cb, cr = _inputs(mb_w, mb_h, 8, cuda)
    kern, plain = PASSES[name]
    planes = _pass_planes(name, y, cb, cr)
    args = _pass_args(name, P, mb_w, mb_h)
    want = _outs(plain(*planes, *args))
    n0 = WK.LAUNCHES[name]
    outs = [_outs(kern(*(t.clone() for t in planes), *args))
            for _ in range(20)]
    torch.cuda.synchronize()
    assert WK.LAUNCHES[name] == n0 + 20
    for got in outs:
        for g, w in zip(got, want):
            _same(g, w)


def _stack_inputs(mb_w, mb_h, S, dev):
    """S streams, each with its own plan and planes: stream 0 all intra
    (kinds 1-3), stream 1 with every deblock edge at strength 0, the
    rest random. Returns (per-stream plans, per-stream planes, the
    stacked plan [S * n, ...], the stacked planes [S, ...])."""
    Ps, planes = [], []
    for s in range(S):
        P, y, cb, cr = _inputs(mb_w, mb_h, 40 + s, dev,
                               kinds=(1, 2, 3) if s == 0 else None)
        if s == 1:
            P["deb_str"].zero_()
            P["deb_str4"].zero_()
        Ps.append(P)
        planes.append((y, cb, cr))
    P = {k: torch.cat([p[k] for p in Ps]) for k in Ps[0]}
    return Ps, planes, P, tuple(torch.stack(t) for t in zip(*planes))


def _single_launches(name, Ps, planes, mb_w, mb_h):
    """Pass ``name`` launched once per stream, stacked: [S, ...] per
    plane."""
    kern = PASSES[name][0]
    outs = [_outs(kern(*(t.clone() for t in _pass_planes(name, *pl)),
                       *_pass_args(name, P, mb_w, mb_h)))
            for P, pl in zip(Ps, planes)]
    return [torch.stack(o) for o in zip(*outs)]


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,S", [
    (120, 68, 2), (120, 68, 8), (11, 9, 2), (11, 9, 8), (3, 150, 32)])
@pytest.mark.parametrize("name", list(PASSES))
def test_row_kernels_stacked(cuda, name, mb_w, mb_h, S):
    """One launch over S streams ([S, H, W] planes, [S * n] plans, the
    streams' rows interleaved by ticket) equals S single-stream launches,
    and, at the small sizes, the plain version on streams 0 and 1. With
    32 streams of 150 rows there are more rows than resident CTAs, so
    CTAs take several rows."""
    Ps, planes, P, stacked = _stack_inputs(mb_w, mb_h, S, cuda)
    kern, plain = PASSES[name]
    n0 = WK.LAUNCHES[name]
    got = _outs(kern(*(t.clone() for t in _pass_planes(name, *stacked)),
                     *_pass_args(name, P, mb_w, mb_h)))
    torch.cuda.synchronize()
    assert WK.LAUNCHES[name] == n0 + 1
    for g, w in zip(got, _single_launches(name, Ps, planes, mb_w, mb_h)):
        _same(g, w)
    if mb_w * mb_h <= 450:
        for s in (0, 1):
            want = _outs(plain(*_pass_planes(name, *planes[s]),
                               *_pass_args(name, Ps[s], mb_w, mb_h)))
            for g, w in zip(got, want):
                _same(g[s], w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PASSES))
def test_row_kernels_stacked_repeat(cuda, name):
    """Eight 1080p streams through one stacked launch 20 times, each run
    byte-equal to the eight single-stream launches and 1 launch: the race
    check of the interleaved (stream, row) tickets."""
    mb_w, mb_h, S = 120, 68, 8
    Ps, planes, P, stacked = _stack_inputs(mb_w, mb_h, S, cuda)
    kern = PASSES[name][0]
    want = _single_launches(name, Ps, planes, mb_w, mb_h)
    args = _pass_args(name, P, mb_w, mb_h)
    n0 = WK.LAUNCHES[name]
    outs = [_outs(kern(*(t.clone() for t in _pass_planes(name, *stacked)),
                       *args)) for _ in range(20)]
    torch.cuda.synchronize()
    assert WK.LAUNCHES[name] == n0 + 20
    for got in outs:
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PASSES))
def test_row_kernels_refuse_misaligned_planes(cuda, name):
    """The kernels move samples in 4-byte words: a plane that does not
    start on a 4-byte boundary is refused before any launch."""
    mb_w, mb_h = 4, 2
    P, y, cb, cr = _inputs(mb_w, mb_h, 9, cuda)
    shifted = []
    for t in _pass_planes(name, y, cb, cr):
        flat = torch.zeros(t.numel() + 1, dtype=torch.uint8, device=cuda)
        flat[1:] = t.reshape(-1)
        shifted.append(flat[1:].view(t.shape))
    n0 = WK.LAUNCHES[name]
    with pytest.raises(ValueError, match="4-byte boundary"):
        PASSES[name][0](*shifted, *_pass_args(name, P, mb_w, mb_h))
    assert WK.LAUNCHES[name] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", ROW_GEOMS)
def test_deblock_chroma_kernel(cuda, mb_w, mb_h):
    P, _, cb, cr = _inputs(mb_w, mb_h, 4, cuda)
    want = WF.deblock_chroma_plain(cb, cr, P, mb_w, mb_h)
    n0 = WK.LAUNCHES["deblock_chroma"]
    got = WK.deblock_chroma(cb.clone(), cr.clone(), P, mb_w, mb_h)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["deblock_chroma"] == n0 + 1
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("has_i8,deblock", [(True, True), (False, True),
                                            (True, False)])
def test_run_wavefronts_cuda_vs_plain(cuda, has_i8, deblock):
    mb_w, mb_h = 7, 4
    P, y, cb, cr = _inputs(mb_w, mb_h, 5, cuda)
    want = WF.run_wavefronts_plain(y, cb, cr, P, has_i8, deblock, mb_w,
                                   mb_h)
    got = WK.run_wavefronts(y.clone(), cb.clone(), cr.clone(), P, has_i8,
                            deblock, mb_w, mb_h)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _same(g, w)


def _run_wavefront_kernels(monkeypatch):
    mb_w, mb_h = 4, 2
    P = torch_plan(rand_wavefront_plan(mb_w, mb_h, 0), "meta")
    y = torch.zeros((mb_h * 16, mb_w * 16), dtype=torch.uint8,
                    device="meta")
    c = torch.zeros((mb_h * 8, mb_w * 8), dtype=torch.uint8, device="meta")
    calls = []
    monkeypatch.setattr(WF, "run_wavefronts_plain",
                        lambda *a: calls.append(a))
    before = dict(WK.LAUNCHES)
    yield lambda: WK.run_wavefronts(y, c, c.clone(), P, True, True, mb_w,
                                    mb_h)
    assert not calls
    assert WK.LAUNCHES == before


def _run_idct_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(IK, "idct8x8_blocks_plain",
                        lambda *a: calls.append(a))
    before = dict(IK.LAUNCHES)
    yield lambda: IK.idct8x8_blocks(
        torch.zeros((3, 6, 64), dtype=torch.int16, device="meta"))
    assert not calls
    assert IK.LAUNCHES == before


def _run_tile_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(R265, "_wavefront_tile_plain",
                        lambda *a: calls.append(a))
    H, W = 32, 48
    y, c, ry, rc, zl, zc = (torch.from_numpy(a).to("meta") for a in
                            rand_tile_inputs(H, W, 4, 0))
    before = dict(TK.LAUNCHES)
    yield lambda: TK.tile_wavefront(y, c, ry, rc, zl, zc, H, W, 4, False)
    assert not calls
    assert TK.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["wavefront", "idct", "h265_tile"])
@pytest.mark.parametrize("missing", ["source", "nvcc"])
def test_kernel_dispatch_never_falls_back(monkeypatch, tmp_path, missing,
                                          kernel):
    """Non-CPU tensors go to the kernel or raise: with the kernel library
    unavailable the wrapper raises instead of running the plain path."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    if missing == "source":
        monkeypatch.setattr(_build, "CSRC", tmp_path / "no_csrc")
        exc = FileNotFoundError
    else:
        monkeypatch.setattr(_build, "nvcc_path", _no_nvcc)
        exc = RuntimeError
    steps = {"wavefront": _run_wavefront_kernels, "idct": _run_idct_kernel,
             "h265_tile": _run_tile_kernel}[kernel](monkeypatch)
    run = next(steps)
    with pytest.raises(exc):
        run()
    with pytest.raises(StopIteration):
        next(steps)


def _no_nvcc():
    raise RuntimeError("nvcc not found")


# ---------------------------------------------------------------------
# MPEG-2 8x8 IDCT
# ---------------------------------------------------------------------


def _same_np(got, want):
    got = got.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), \
        f"max abs err {np.abs(got.astype(np.int64) - want).max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1001, 8160])
def test_idct_kernel(cuda, n):
    """Odd block counts over the full int16 range (int32 wrap inside the
    butterflies), on [n, 6, 64] plan-shaped input."""
    rng = np.random.default_rng(n)
    coef = rng.integers(-32768, 32768, (n, 6, 64)).astype(np.int16)
    want = IK.idct8x8_blocks_plain(torch.from_numpy(coef)).numpy()
    n0 = IK.LAUNCHES["idct8x8"]
    got = IK.idct8x8_blocks(torch.from_numpy(coef).to(cuda))
    torch.cuda.synchronize()
    assert IK.LAUNCHES["idct8x8"] == n0 + 1
    _same_np(got, want)


@pytest.mark.cuda
def test_idct_kernel_int16_wrap(cuda):
    """The horizontal-store wraparound case of tests/test_pallas_kernels.py,
    and a misaligned view of the coefficients."""
    coef = np.zeros((5, 64), np.int16)
    coef[:, 0:8] = 2047
    coef[:, 56:64] = -2048
    want = IK.idct8x8_blocks_plain(torch.from_numpy(coef)).numpy()
    dev = torch.from_numpy(coef).to(cuda)
    _same_np(IK.idct8x8_blocks(dev), want)
    flat = torch.zeros(5 * 64 + 1, dtype=torch.int16, device=cuda)
    flat[1:] = dev.reshape(-1)
    _same_np(IK.idct8x8_blocks(flat[1:].reshape(5, 64)), want)
    torch.cuda.synchronize()


def _mpeg2_streams():
    from streamgen.mpeg2_enc import Mpeg2FieldMcGen, Mpeg2StreamGen

    return [Mpeg2StreamGen(80, 48, seed=11).generate("IPPBPBB"),
            Mpeg2FieldMcGen(80, 48, seed=9, field_prob=0.7).generate(
                "IPPBP")]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1])
def test_turbo_mpeg2_cuda_vs_cpu(cuda, k):
    """TurboMpeg2Decoder on the card (IDCT kernel) gives the frames of
    the port's CPU path."""
    from m2dec_tpu_torch.runtime.turbo import TurboMpeg2Decoder

    data = _mpeg2_streams()[k]
    n0 = IK.LAUNCHES["idct8x8"]
    got = TurboMpeg2Decoder(data, batch=3, device=cuda).decode_all()
    assert IK.LAUNCHES["idct8x8"] > n0
    exp = TurboMpeg2Decoder(data, batch=3, device="cpu").decode_all()
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        for pl in ("y", "cb", "cr"):
            assert np.array_equal(getattr(g, pl), getattr(e, pl))


@pytest.mark.cuda
def test_mpeg2_batch_kernel_vs_plain(cuda):
    """Mpeg2SeqPhaseB with the IDCT kernel and with the plain IDCT, both
    on the card, give the same pictures."""
    from m2dec_tpu_torch.codecs.mpeg2.decoder import Mpeg2Decoder
    from m2dec_tpu_torch.codecs.mpeg2.reconstruct import Mpeg2SeqPhaseB

    dec = Mpeg2Decoder(device=cuda, defer_recon=True)
    dec.set_data(_mpeg2_streams()[1])
    while dec.decode_data() == 1:
        pass
    geom = (dec.seq.mb_w, dec.seq.mb_h, len(dec.pool.frames))
    got = Mpeg2SeqPhaseB(*geom, device=cuda).run_async(dec.plans)
    want = Mpeg2SeqPhaseB(*geom, device=cuda,
                          idct=IK.idct8x8_blocks_plain).run_async(dec.plans)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_h264dec_turbo_cli_on_card(cuda, tmp_path, monkeypatch):
    """h264dec --turbo -O, and the flag-less -O (the per-picture native
    Phase A and torch Phase B), on the card by default: the MD5 lines of
    the port's CPU run of the tool, and one launch of each wavefront
    kernel per picture."""
    from streamgen.h264_enc import H264BGen

    from m2dec_tpu_torch.apps import h264dec

    (tmp_path / "b.264").write_bytes(H264BGen(
        176, 144, seed=5, num_ref_frames=2,
        disable_deblock=False).generate("IPBPBP"))
    monkeypatch.chdir(tmp_path)
    assert h264dec.main(["--turbo", "-O", "--device", "cpu", "b.264"]) == 0
    want = (tmp_path / "b.out").read_bytes()
    assert want.count(b"\r\n") == 6
    for flags in (["--turbo"], []):
        (tmp_path / "b.out").unlink()
        before = dict(WK.LAUNCHES)
        assert h264dec.main(flags + ["-O", "b.264"]) == 0
        torch.cuda.synchronize()
        assert (tmp_path / "b.out").read_bytes() == want
        assert {k: WK.LAUNCHES[k] - before[k] for k in PASSES} == {
            k: 6 for k in PASSES}


# ---------------------------------------------------------------------
# H.265 CTU-tile intra wavefront
# ---------------------------------------------------------------------

#: (H, W, ctb_log2, strong_en, rand_tile_inputs keywords) of the
#: random-word cases: small, 1080p CTB 16, CTB 32 with strong smoothing,
#: more CTU rows than the card holds CTAs (3 * 400 bands: the ticket
#: loop), the ends of the CTB range the wrapper takes: CTB 8 and CTB 64
#: (16 KB of int32 per luma CTU, a window over the 48 KB static limit);
#: at 1080p CTB 16 every slot holding a 4x4 op (the I picture's mix at
#: its worst: the longest chain of ops), and every luma op a DC op
#: carrying the stray pixel (into the window, and into the band below
#: at a CTU's bottom row)
TILE_GEOMS = [(64, 96, 4, False, {}), (1088, 1920, 4, False, {}),
              (96, 64, 5, True, {}), (256, 384, 5, True, {}),
              (6400, 32, 4, False, dict(density=0.05)),
              (64, 96, 3, False, {}), (256, 384, 3, False, {}),
              (128, 192, 6, True, {}), (256, 384, 6, True, {}),
              (1088, 1920, 4, False, dict(density=1.0, sl2_max=2)),
              (256, 384, 4, False, dict(modes=(1,), stray=1.0))]
TILE_IDS = ["-".join(str(v) for v in g[:4]) + "-" + "-".join(
    f"{k}={v}" for k, v in g[4].items()) for g in TILE_GEOMS]


def _tile_inputs(H, W, cl2, seed, dev, **kw):
    return [torch.from_numpy(a).to(dev)
            for a in rand_tile_inputs(H, W, cl2, seed, **kw)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,cl2,strong,kw", TILE_GEOMS, ids=TILE_IDS)
def test_tile_kernel_random_words(cuda, H, W, cl2, strong, kw):
    """The kernel against its plain version on the card, on random op
    words (every mode, sizes up to the slot's, stray pixels), one
    launch."""
    y, c, ry, rc, zl, zc = _tile_inputs(H, W, cl2, 3, cuda, **kw)
    want = R265._wavefront_tile_plain(y.clone(), c.clone(), ry, rc, zl, zc,
                                      H, W, cl2, strong)
    n0 = TK.LAUNCHES["h265_tile"]
    got = TK.tile_wavefront(y, c, ry, rc, zl, zc, H, W, cl2, strong)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["h265_tile"] == n0 + 1
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.cuda
def test_tile_kernel_grid(cuda):
    """The grid holds every (plane, band) of a 1080p picture at once at
    CTB 16 (3 x 68 CTAs) and CTB 64 (3 x 17)."""
    lib = _build.load_library("h265_tile")
    for cl2, bands in ((4, 204), (6, 51)):
        grid = ctypes.c_int(0)
        smem = lib.h265_tile_grid(1088, 1920, cl2, ctypes.addressof(grid))
        assert smem > 0 and grid.value == bands, (cl2, smem, grid.value)


@pytest.mark.cuda
def test_tile_kernel_probe_build(cuda):
    """The probe build (-DH265_TILE_PROBE, tools/probe_h265_tile_split.py)
    writes the plain version's bytes on random words, counts every op, and
    the spans of the warp that runs the ops add up to at most each band's
    cycles."""
    H, W = 256, 384
    y, c, ry, rc, zl, zc = _tile_inputs(H, W, 4, 6, cuda)
    want = R265._wavefront_tile_plain(y.clone(), c.clone(), ry, rc, zl, zc,
                                      H, W, 4, False)
    lib = _build.load_library("h265_tile_probe")
    rows = H >> 4
    probe = torch.zeros((3 * rows, 16), dtype=torch.int64, device=cuda)
    progress = TK._band_progress(cuda, rows)
    ang = TK._tile_table(cuda)
    err = lib.h265_tile_wavefront_probe(
        *(t.data_ptr() for t in (y, c, ry, rc, zl, zc)), ang.data_ptr(),
        progress.data_ptr(), probe.data_ptr(), H, W, 4, 0,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for g, w in zip((y, c), want):
        _same(g, w)
    # columns: 4 spans of the op warp, 8 of the data warp, then the
    # band's ops, cycles, nanoseconds and start
    p = probe.cpu()
    assert (p[:, :12] >= 0).all() and (p[:, :4].sum(1) <= p[:, 13]).all()
    assert p[:, 12].sum() == int((zl & 1).sum()) + 2 * int((zc & 1).sum())


@pytest.mark.cuda
def test_tile_kernel_repeat(cuda):
    """20 launches on one 1080p set of random words, byte-equal each time
    (the race check of the band handoffs and the stray pixel)."""
    H, W = 1088, 1920
    y, c, ry, rc, zl, zc = _tile_inputs(H, W, 4, 8, cuda)
    first = None
    for _ in range(20):
        got = TK.tile_wavefront(y.clone(), c.clone(), ry, rc, zl, zc, H, W,
                                4, False)
        torch.cuda.synchronize()
        if first is None:
            first = got
        for g, f in zip(got, first):
            _same(g, f)


def _h265_streams():
    from streamgen.h265_enc import ALL_MODES, H265StreamGen

    slices3 = H265StreamGen(64, 96, seed=203, qp=30, cbf_prob=0.5,
                            modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                            max_level=1)
    slices3.slices_per_pic = 3
    return {
        "ctb16_ipb": H265StreamGen(
            96, 64, seed=7, qp=30, cbf_prob=0.5, modes=ALL_MODES, deblock=1,
            sao=1, max_level=1).generate("IPB"),
        "ctb32_strong": H265StreamGen(
            96, 64, seed=22, ctb_log2=5, qp=14, cbf_prob=0.3,
            modes=ALL_MODES, strong_smoothing=1,
            split_prob=0.3).generate(2),
        "slices3": slices3.generate("IPBP"),
        "tskip_sdh": H265StreamGen(
            64, 48, seed=32, qp=14, cbf_prob=0.7, modes=ALL_MODES,
            transform_skip=1, sign_data_hiding=1, split_prob=0.7,
            nxn_prob=0.8).generate(2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ctb16_ipb", "ctb32_strong", "slices3",
                                  "tskip_sdh"])
def test_tile_kernel_streams(cuda, name):
    """Every picture replayed on the card on the tile schedule (the tile
    mode forced at CTB 32): one launch per picture, the planes of the
    plain version (the CPU replay) and of the Python decoder's oracle."""
    from m2dec_tpu_torch.codecs.h265.headers import H265Decoder

    dec = H265Decoder(device="cpu")
    dec.set_data(_h265_streams()[name])
    dec.decode_all(collect_plans=True, keep_oracle=True)
    n0 = TK.LAUNCHES["h265_tile"]
    got = R265.replay_plans(dec.plans, device=cuda, wf_mode="tile")
    assert TK.LAUNCHES["h265_tile"] == n0 + len(dec.plans)
    want = R265.replay_plans(dec.plans, device="cpu", wf_mode="tile")
    for k, (p, g, w) in enumerate(zip(dec.plans, got, want)):
        for c, a, b, o in zip(("y", "cb", "cr"), g, w, p.oracle):
            assert np.array_equal(a, b), f"picture {k} {c}: != plain"
            assert np.array_equal(a, o), f"picture {k} {c}: != oracle"


def _graph_stream():
    from streamgen.h265_enc import ALL_MODES, H265StreamGen

    return H265StreamGen(96, 64, seed=7, qp=30, cbf_prob=0.5,
                         modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                         max_level=1).generate("IPBPBP")


@pytest.mark.cuda
def test_h265_graph_steps(cuda):
    """The CTB-16 ``IPBPBP`` stream through ``H265SeqPhaseB`` on the card
    in batches of 2, twice over one pool: each picture step is replayed
    as the CUDA graph of its key (new inputs, another pool slot) after
    one eager run and one capture per key, byte-equal to the CPU's eager
    steps on the same batches, with one tile launch per picture."""
    from m2dec_tpu_torch.codecs.h265.headers import H265Decoder
    from m2dec_tpu_torch.runtime import trace

    dec = H265Decoder(device="cpu")
    dec.set_data(_graph_stream())
    dec.decode_all(collect_plans=True)
    plans = dec.plans
    assert len(plans) == 6 and not any(p.multi_slice for p in plans)
    keys = {R265._graph_key(R265._PicMeta(p)) for p in plans}
    batches = [plans[i:i + 2] for i in range(0, 6, 2)] * 2
    geom = (plans[0].H, plans[0].W, len(dec.pool))
    cpu = R265.H265SeqPhaseB(*geom, device="cpu")
    want = [cpu.run_async(b) for b in batches]
    ph = R265.H265SeqPhaseB(*geom, device=cuda)
    n0 = TK.LAUNCHES["h265_tile"]
    t0 = time.time_ns()
    trace.start()
    try:
        got = [ph.run_async(b) for b in batches]
        torch.cuda.synchronize()
    finally:
        trace.stop()
    counts = trace.events(t0, time.time_ns()).counts
    n = {k: sum(c for name, _, c in counts if name == k)
         for k in ("graph.capture", "graph.replay")}
    assert n["graph.capture"] == len(keys) == len(ph.graphs)
    assert n["graph.replay"] == 12 - len(keys) > 0
    assert TK.LAUNCHES["h265_tile"] == n0 + 12
    for k, (g, w) in enumerate(zip(got, want)):
        for c, a, b in zip(("y", "cb", "cr"), g, w):
            assert torch.equal(a.cpu(), b), f"batch {k} {c}: != CPU"


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("ctb16_ipb", "level"),
                                       ("slices3", "tile")])
def test_h265_graph_steps_not_taken(cuda, name, mode):
    """The level schedule and multi-slice pictures keep their eager
    steps on the card: no picture step is captured."""
    from m2dec_tpu_torch.codecs.h265.headers import H265Decoder

    dec = H265Decoder(device="cpu")
    dec.set_data(_h265_streams()[name])
    dec.decode_all(collect_plans=True)
    p = dec.plans
    ph = R265.H265SeqPhaseB(p[0].H, p[0].W, len(dec.pool), device=cuda,
                            wf_mode=mode)
    for q in p:
        ph.run_async_one(q) if q.multi_slice else ph.run_async([q])
    torch.cuda.synchronize()
    assert any(q.multi_slice for q in p) == (name == "slices3")
    assert ph.graphs == {}


# ------------------------------------------------ MB-row bands with a halo

def _band_plan(mb_w, mb_h, seed, dev):
    """A random whole plan (``_PLAN_KEYS``) of inter and intra MBs with
    random MVs into one reference picture, no IPCM, as int32 numpy."""
    from m2dec_tpu_torch.codecs.h264.plan_host import _PLAN_KEYS

    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    P = rand_wavefront_plan(mb_w, mb_h, seed, kinds=(0, 0, 1, 2, 3))
    P["t8x8"] = rng.integers(0, 2, n)
    P["coef_luma"] = rng.integers(-30, 30, (n, 256)) * (
        rng.random((n, 256)) < 0.1)
    P["coef_chroma"] = rng.integers(-30, 30, (n, 2, 4, 16)) * (
        rng.random((n, 2, 4, 16)) < 0.1)
    P["mv"] = rng.integers(-64, 64, (n, 16, 2, 2))
    P["slot"] = np.where(rng.random((n, 4, 2)) < 0.3, -1, 0)
    P["slot"][:, :, 0] = 0
    wp = np.zeros((n, 4, 3, 4))
    wp[..., 0] = wp[..., 1] = wp[..., 3] = 1
    P["wp"] = wp
    return {k: np.asarray(P[k], np.int32) for k in _PLAN_KEYS}


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,bh", [(5, 3), (120, 17)])
@pytest.mark.parametrize("name", list(PASSES))
def test_row_kernels_band_with_halo(cuda, name, mb_w, bh):
    """Each row kernel on an MB-row band launched with one extra MB row
    on top that holds random halo samples and whose plan entries touch
    no pixel (``parallel.mesh._with_halo_row``): byte-equal to its plain
    version on the same band layout, halo rows included (the deblock
    passes write the band above's bottom rows there)."""
    from m2dec_tpu_torch.parallel.mesh import _with_halo_row

    P = torch_plan(rand_wavefront_plan(mb_w, bh, 21, wide=True), cuda)
    Q = _with_halo_row(P, mb_w)
    planes = [torch.from_numpy(a).to(cuda)
              for a in rand_planes(mb_w, bh + 1, 21)]
    kern, plain = PASSES[name]
    planes = _pass_planes(name, *planes)
    want = _outs(plain(*planes, *_pass_args(name, Q, mb_w, bh + 1)))
    n0 = WK.LAUNCHES[name]
    got = _outs(kern(*(t.clone() for t in planes),
                     *_pass_args(name, Q, mb_w, bh + 1)))
    torch.cuda.synchronize()
    assert WK.LAUNCHES[name] == n0 + 1
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.cuda
def test_h264_tile_step_on_card(cuda):
    """The band step on 4 in-process shards on the card (each row kernel
    once per band) byte-equal to the same step on the CPU (the plain
    versions), on a random plan with 8x8 transforms."""
    from m2dec_tpu_torch.parallel import mesh as M

    mb_w, mb_h, nb = 11, 8, 4
    P = _band_plan(mb_w, mb_h, 31, cuda)
    tiled = {k: v.reshape((nb, -1) + v.shape[1:]) for k, v in P.items()}
    refs = [a[None] for a in rand_planes(mb_w, mb_h, 32)]
    outs = {}
    for dev in ("cpu", cuda):
        step = M.h264_tile_step(M.make_mesh(nb, in_process=True, device=dev),
                                mb_w, mb_h, has_i8=True)
        WK.reset_launch_counts()
        outs[str(dev)] = step(tiled, *refs)
    torch.cuda.synchronize()
    assert WK.LAUNCHES == {k: nb for k in PASSES}
    for g, w in zip(outs[str(cuda)], outs["cpu"]):
        _same(g, w)
