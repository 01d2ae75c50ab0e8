"""The port's MPEG-2 Phase B (m2dec_tpu_torch.kernels.mpeg2_idct /
mpeg2_mc, codecs/mpeg2/reconstruct.py, TurboMpeg2Decoder) on the CPU
against the JAX package on the same seeded inputs: the plain IDCT
against ``idct8x8(xp=np)`` and the Pallas kernel in interpret mode, the
MC functions against their ``xp=np`` twins, ``reconstruct_arrays``
against the numpy spec path, and whole streams against the JAX
package's numpy decoder. Tolerance 0 throughout: integer decode."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (pins torch to one thread)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.mpeg2_enc import (  # noqa: E402
    Mpeg2FieldMcGen,
    Mpeg2FieldPicGen,
    Mpeg2StreamGen,
)

from m2dec_tpu.codecs.mpeg2 import reconstruct as JR  # noqa: E402
from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder  # noqa: E402
from m2dec_tpu.kernels import mpeg2_idct as JI  # noqa: E402
from m2dec_tpu.kernels import mpeg2_mc as JM  # noqa: E402
from m2dec_tpu_torch.codecs.mpeg2 import reconstruct as TR  # noqa: E402
from m2dec_tpu_torch.codecs.mpeg2.decoder import (  # noqa: E402
    Mpeg2Decoder as PortMpeg2Decoder,
)
from m2dec_tpu_torch.kernels import idct_kernels as IK  # noqa: E402
from m2dec_tpu_torch.kernels import mpeg2_mc as TM  # noqa: E402
from m2dec_tpu_torch.kernels.mpeg2_idct import idct8x8  # noqa: E402
from m2dec_tpu_torch.runtime.turbo import TurboMpeg2Decoder  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wrap_blocks():
    """The horizontal-store int16 wraparound case of
    tests/test_pallas_kernels.py."""
    c = np.zeros((4, 8, 8), np.int16)
    c[:, 0, :] = 2047
    c[:, 7, :] = -2048
    return c


def test_idct_plain_vs_jax_and_pallas():
    """Seeded int16 blocks over the full int16 range (int32 wrap inside
    the butterflies) plus the int16-store wrap case, against the numpy
    idct8x8 and idct8x8_pallas in interpret mode (one Pallas call)."""
    from m2dec_tpu.kernels.pallas_idct import idct8x8_pallas

    rng = np.random.default_rng(0)
    coef = np.concatenate([
        rng.integers(-2048, 2048, (500, 8, 8)),
        rng.integers(-32768, 32768, (251, 8, 8)),
        _wrap_blocks()]).astype(np.int16)
    want = JI.idct8x8(coef, np)
    got = idct8x8(_t(coef)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    pallas = np.asarray(idct8x8_pallas(coef.astype(np.int32), tile=256,
                                       interpret=True))
    assert np.array_equal(got, pallas)


@pytest.mark.parametrize("n", [1, 7, 300])
def test_idct_blocks_wrapper_on_cpu(n):
    """The kernel wrapper on CPU tensors runs the plain version over a
    plan-shaped [n, 6, 64] int16 array and counts no launch."""
    rng = np.random.default_rng(n)
    coef = rng.integers(-32768, 32768, (n, 6, 64)).astype(np.int16)
    before = IK.LAUNCHES["idct8x8"]
    got = IK.idct8x8_blocks(_t(coef))
    assert IK.LAUNCHES["idct8x8"] == before
    assert tuple(got.shape) == (n, 6, 8, 8)
    want = JI.idct8x8(coef.reshape(n, 6, 8, 8), np)
    assert np.array_equal(got.numpy(), want)


def test_idct_wrapper_refuses_wrong_input():
    with pytest.raises(ValueError, match="int16"):
        IK.idct8x8_blocks(torch.zeros((2, 6, 64), dtype=torch.int32))


# ---------------------------------------------------------------------
# motion compensation
# ---------------------------------------------------------------------

MB_W, MB_H = 5, 3


def _mc_inputs(seed, n=MB_W * MB_H):
    """A padded int32 luma plane, a chroma plane, and MVs that reach
    well outside the picture (the clamps)."""
    rng = np.random.default_rng(seed)
    H, W = MB_H * 16, MB_W * 16
    y = rng.integers(0, 256, (H + 1, W + 1)).astype(np.int32)
    c = rng.integers(0, 256, (H // 2 + 1, W // 2 + 1)).astype(np.int32)
    idx = np.arange(n, dtype=np.int32)
    return {
        "y": y, "c": c, "y2": rng.integers(0, 256, y.shape).astype(np.int32),
        "mbx": idx % MB_W, "mby": idx // MB_W,
        "mv1": rng.integers(-40, 40, (n, 2)).astype(np.int32),
        "mv2": rng.integers(-40, 40, (n, 2)).astype(np.int32),
        "sel": rng.integers(0, 4, n).astype(np.int32),
    }


MC_CASES = {
    "luma_pred": lambda m, x, xp: m.luma_pred(
        x["y"], x["mv1"][:, 0], x["mv1"][:, 1], x["mbx"], x["mby"],
        *xp),
    "chroma_pred": lambda m, x, xp: m.chroma_pred(
        x["c"], x["mv1"][:, 0], x["mv1"][:, 1], x["mbx"], x["mby"],
        *xp),
    "luma_pred_field": lambda m, x, xp: m.luma_pred_field(
        x["y"], x["mv1"], x["mv2"], x["sel"], x["mbx"], x["mby"], *xp),
    "chroma_pred_field": lambda m, x, xp: m.chroma_pred_field(
        x["c"], x["mv1"], x["mv2"], x["sel"], x["mbx"], x["mby"], *xp),
    "combine_bidir": lambda m, x, xp: m.combine_bidir(x["y"], x["y2"]),
}


@pytest.mark.parametrize("name", sorted(MC_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_mc_vs_numpy(name, seed):
    x = _mc_inputs(seed)
    want = MC_CASES[name](JM, x, (np,))
    got = MC_CASES[name](TM, {k: _t(v) for k, v in x.items()}, ())
    assert np.array_equal(got.numpy(), want)


def test_mc_gather_halfpel_flags():
    """mc_gather / mc_gather_field over every half-pel flag pair."""
    x = _mc_inputs(2, n=64)
    rng = np.random.default_rng(3)
    py = rng.integers(-5, 50, 64).astype(np.int32)
    px = rng.integers(-5, 85, 64).astype(np.int32)
    hx = np.arange(64, dtype=np.int32) & 1
    hy = (np.arange(64, dtype=np.int32) >> 1) & 1
    for fn, bh, bw in (("mc_gather", 16, 16), ("mc_gather_field", 8, 16)):
        want = getattr(JM, fn)(x["y"], py, px, hx, hy, bh, bw, np)
        got = getattr(TM, fn)(_t(x["y"]), _t(py), _t(px), _t(hx), _t(hy),
                              bh, bw)
        assert np.array_equal(got.numpy(), want), fn


# ---------------------------------------------------------------------
# reconstruct_arrays
# ---------------------------------------------------------------------


def _rand_picture(seed, mode):
    """Random plan arrays and reference planes for one picture. mode:
    "frame" (frame MC, frame and field DCT), "field" (field MC in a
    frame picture), "bwd_only" (no MB reads the forward prediction)."""
    rng = np.random.default_rng(seed)
    n = MB_W * MB_H
    H, W = MB_H * 16, MB_W * 16
    intra = rng.random(n) < 0.2
    if mode == "bwd_only":
        fwd = np.zeros(n, bool)
        bwd = ~intra
    else:
        fwd = rng.random(n) < 0.7
        bwd = rng.random(n) < 0.5
    p = {
        "intra": intra, "fwd": fwd, "bwd": bwd,
        "mvf": rng.integers(-30, 30, (n, 2)).astype(np.int32),
        "mvb": rng.integers(-30, 30, (n, 2)).astype(np.int32),
        "dct_type": rng.integers(0, 2, n).astype(np.int32),
        "coef": rng.integers(-300, 300, (n, 6, 64)).astype(np.int16),
    }
    if mode == "field":
        p.update(
            mvf2=rng.integers(-20, 20, (n, 2)).astype(np.int32),
            mvb2=rng.integers(-20, 20, (n, 2)).astype(np.int32),
            fsel=rng.integers(0, 16, n).astype(np.int32),
            fieldmc=rng.random(n) < 0.6)
    refs = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
            for _ in range(2)]
    return p, refs


@pytest.mark.parametrize("mode", ["frame", "field", "bwd_only"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruct_arrays_vs_numpy(mode, seed):
    p, refs = _rand_picture(seed, mode)
    field = {k: p[k] for k in ("mvf2", "mvb2", "fsel", "fieldmc")
             if k in p}
    want = JR.reconstruct_arrays(
        p["intra"], p["fwd"], p["bwd"], p["mvf"], p["mvb"], p["dct_type"],
        p["coef"], *refs[0], *refs[1], mb_w=MB_W, mb_h=MB_H, xp=np,
        **field)
    needs = TR._mc_needs(p["intra"], p["fwd"], p["bwd"],
                         field.get("fieldmc"))
    assert needs[0] == (mode != "bwd_only")
    got = TR.reconstruct_arrays(
        _t(p["intra"]), _t(p["fwd"]), _t(p["bwd"]), _t(p["mvf"]),
        _t(p["mvb"]), _t(p["dct_type"]),
        IK.idct8x8_blocks(_t(p["coef"])),
        tuple(_t(a) for a in refs[0]), tuple(_t(a) for a in refs[1]),
        mb_w=MB_W, mb_h=MB_H, needs=needs,
        **{k: _t(v) for k, v in field.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), w)


# ---------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------

STREAMS = {
    "ipb_80x48": lambda: Mpeg2StreamGen(80, 48, seed=11).generate(
        "IPPBPBB"),
    "multi_gop_96x64": lambda: Mpeg2StreamGen(96, 64, seed=3).generate(
        "IPPBIPPB"),
    "field_mc_80x48": lambda: Mpeg2FieldMcGen(
        80, 48, seed=9, field_prob=0.7).generate("IPPBP"),
    "field_pictures_80x48": lambda: Mpeg2FieldPicGen(
        80, 48, seed=5).generate("IIPPBBPP"),
}


def _assert_frames(got, exp):
    assert len(got) == len(exp)
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt, f"frame {k} cnt"
        assert g.crop == e.crop
        for pl in ("y", "cb", "cr"):
            assert np.array_equal(getattr(g, pl), getattr(e, pl)), \
                f"frame {k} {pl}"


@pytest.mark.parametrize("batch", [1, 3, 12])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_turbo_mpeg2_vs_numpy_decoder(name, batch):
    data = STREAMS[name]()
    ref = Mpeg2Decoder(backend="numpy")
    ref.set_data(data)
    exp = ref.decode_all()
    got = TurboMpeg2Decoder(data, batch=batch, device="cpu").decode_all()
    _assert_frames(got, exp)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_port_serial_mpeg2_decoder(name):
    """The port's serial decoder (one picture at a time through
    reconstruct_picture) against the JAX package's numpy decoder."""
    data = STREAMS[name]()
    ref = Mpeg2Decoder(backend="numpy")
    ref.set_data(data)
    dec = PortMpeg2Decoder(device="cpu")
    dec.set_data(data)
    _assert_frames(dec.decode_all(), ref.decode_all())


def test_turbo_mpeg2_truncated_drains():
    """A stream cut mid-picture: the port's driver emits what the JAX
    package's TurboMpeg2Decoder emits (the one test here that compiles a
    JAX graph). Both end one frame short of the serial decoder, which
    also outputs the abandoned picture's stale buffer."""
    from m2dec_tpu.runtime.turbo import TurboMpeg2Decoder as JaxTurbo

    data = Mpeg2StreamGen(80, 48, seed=11).generate("IPPBPBB")
    cut = data[: len(data) * 2 // 3]
    jt = JaxTurbo(cut, batch=4)
    exp = jt.decode_all()
    t = TurboMpeg2Decoder(cut, batch=4, device="cpu")
    _assert_frames(t.decode_all(), exp)
    assert t.error == jt.error < 0


def test_fast_mode_not_ported():
    with pytest.raises(NotImplementedError, match="fast"):
        PortMpeg2Decoder(device="cpu", fast=True)
