"""The CUDA kernels of m2dec_tpu_torch against their plain PyTorch
versions, on the card: the four H.264 wavefront kernels on random plans
and the MPEG-2 8x8 IDCT on random blocks and on MPEG-2 streams; exact
equality (integer decode, tolerance 0). The tests marked ``cuda`` skip
on a machine without a GPU. CPU tests show the kernel dispatch cannot
fall back to the plain version."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from torch_helpers import rand_planes, rand_wavefront_plan, torch_plan

from m2dec_tpu_torch import _build
from m2dec_tpu_torch.codecs.h264 import wavefront as WF
from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
from m2dec_tpu_torch.kernels import idct_kernels as IK

sys.path.insert(0, str(pathlib.Path(__file__).parent))

#: (mb_w, mb_h): tiny, odd, CIF and 1080p geometries
GEOMS = [(4, 2), (5, 3), (11, 9), (120, 68)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


def _inputs(mb_w, mb_h, seed, dev):
    P = torch_plan(rand_wavefront_plan(mb_w, mb_h, seed, wide=True), dev)
    y, cb, cr = (torch.from_numpy(a).to(dev)
                 for a in rand_planes(mb_w, mb_h, seed))
    return P, y, cb, cr


def _same(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
    assert diff == 0, f"max abs err {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", GEOMS)
@pytest.mark.parametrize("has_i8", [True, False])
def test_intra_luma_kernel(cuda, mb_w, mb_h, has_i8):
    P, y, _, _ = _inputs(mb_w, mb_h, 1, cuda)
    want = WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
    n0 = WK.LAUNCHES["intra_luma"]
    got = WK.intra_luma(y.clone(), P, has_i8, mb_w, mb_h)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["intra_luma"] > n0
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", GEOMS)
def test_intra_chroma_kernel(cuda, mb_w, mb_h):
    P, _, cb, cr = _inputs(mb_w, mb_h, 2, cuda)
    want = WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)
    got = WK.intra_chroma(cb.clone(), cr.clone(), P, mb_w, mb_h)
    torch.cuda.synchronize()
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", GEOMS)
def test_deblock_luma_kernel(cuda, mb_w, mb_h):
    P, y, _, _ = _inputs(mb_w, mb_h, 3, cuda)
    want = WF.deblock_luma_plain(y, P, mb_w, mb_h)
    got = WK.deblock_luma(y.clone(), P, mb_w, mb_h)
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h", GEOMS)
def test_deblock_chroma_kernel(cuda, mb_w, mb_h):
    P, _, cb, cr = _inputs(mb_w, mb_h, 4, cuda)
    want = WF.deblock_chroma_plain(cb, cr, P, mb_w, mb_h)
    got = WK.deblock_chroma(cb.clone(), cr.clone(), P, mb_w, mb_h)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("kernel", ["wavefront", "idct"])
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
    steps = (_run_wavefront_kernels if kernel == "wavefront"
             else _run_idct_kernel)(monkeypatch)
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
