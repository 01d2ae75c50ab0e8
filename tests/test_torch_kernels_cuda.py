"""The four CUDA wavefront kernels of m2dec_tpu_torch against their
plain PyTorch versions, on the card, on random plans; exact equality
(integer decode, tolerance 0). The tests marked ``cuda`` skip on a
machine without a GPU. One CPU test shows the kernel dispatch cannot
fall back to the plain version."""

import pytest
import torch

from torch_helpers import rand_planes, rand_wavefront_plan, torch_plan

from m2dec_tpu_torch import _build
from m2dec_tpu_torch.codecs.h264 import wavefront as WF
from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK

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


@pytest.mark.parametrize("missing", ["source", "nvcc"])
def test_kernel_dispatch_never_falls_back(monkeypatch, tmp_path, missing):
    """Non-CPU planes go to the kernel or raise: with the kernel library
    unavailable the wrapper raises instead of running the plain path."""
    mb_w, mb_h = 4, 2
    P = torch_plan(rand_wavefront_plan(mb_w, mb_h, 0), "meta")
    y = torch.zeros((mb_h * 16, mb_w * 16), dtype=torch.uint8,
                    device="meta")
    c = torch.zeros((mb_h * 8, mb_w * 8), dtype=torch.uint8, device="meta")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    if missing == "source":
        monkeypatch.setattr(_build, "SOURCE", tmp_path / "missing.cu")
        exc = FileNotFoundError
    else:
        monkeypatch.setattr(_build, "nvcc_path", _no_nvcc)
        exc = RuntimeError
    calls = []
    monkeypatch.setattr(WF, "run_wavefronts_plain",
                        lambda *a: calls.append(a))
    before = dict(WK.LAUNCHES)
    with pytest.raises(exc):
        WK.run_wavefronts(y, c, c.clone(), P, True, True, mb_w, mb_h)
    assert not calls
    assert WK.LAUNCHES == before


def _no_nvcc():
    raise RuntimeError("nvcc not found")
