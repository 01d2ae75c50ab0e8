"""The frozen generators and the plain reference at small sizes: the
parallel assembly of a stream equals its one-pass generation, the
port's CPU path and the reference decode every picture alike, and the
control (the reference with one guarantee broken) is caught."""

import numpy as np
import pytest
import torch

from decode_bench import control, digest, reference, streams
from decode_bench.drivers import h264, h265

from ._small import SIZES, cell, config

SEED = 2**31 + 12345
CASES = [("h264-main-1080p", w, h) for w, h in SIZES] + \
    [("h265-main-1080p", w, h) for w, h in SIZES]


@pytest.mark.parametrize("name,width,height", CASES)
def test_port_and_reference_agree(name, width, height):
    cfg = config(name, width, height)
    datas = streams.make(cfg, SEED, 2)
    assert datas[0] != datas[1]
    for g, data in enumerate(datas):
        assert data == streams.gop_bytes_serial(cfg, SEED, g)
    ref = reference.make(cfg, SEED, datas)
    drv = (h264 if cfg["codec"] == "h264" else h265).Driver(
        cfg, {"streams": 1, "distinct_gops": 2}, torch.device("cpu"))
    drv.setup(datas)
    dd = digest.DeviceDigest(torch.device("cpu"))
    n = len(cfg["gop"])
    for g in (0, 1, 0):
        (outs,) = drv.dispatch([(g, 0, n)])
        got = torch.stack([dd.planes(p) for p in outs], 1).numpy()
        assert got.shape[0] == ref[g].shape[0] == n
        np.testing.assert_array_equal(got, ref[g][:, :3])


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_h264_parts_decode_as_the_whole_stream(parts):
    """The reference's parts of an H.264 GOP, decoded apart, give each
    picture once and as the whole stream's decode does."""
    data = streams.make(config("h264-main-1080p", 64, 48), SEED, 1)[0]
    whole = reference.gop_digests("h264", data)
    cut = reference._h264_parts(data, parts)
    assert 1 < len(cut) <= parts
    assert sorted(i for _, _, keep in cut for i in keep) == \
        list(range(len(whole)))
    got = np.zeros_like(whole)
    for b, dec, keep in cut:
        got[keep] = reference._task(("h264", b, dec, keep, None))
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("name,streams", [("h264-main-1080p", 2),
                                          ("h265-main-1080p", 1)])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_caught(name, streams, seed):
    """The control's digests, put in the program's place, fail the
    harness's own check."""
    c = cell(name, streams, 64, 48)
    for ctl, checks, correct in control.control_results(c, seed):
        assert not correct, ctl
        assert checks["mismatched_pictures"][0] > 0


def test_h265_store_wraps_as_a_c_int():
    """A uni-directional chroma lane value just under 2^31, the packed
    lanes' form of a negative prediction, stores 0 as the reference
    decoder's 32-bit sum gives (a Python int would store 255)."""
    from decode_bench.ref.h265 import inter

    plane = np.full((1, 3), 9, np.uint8)
    inter.store_onedir(plane, 0, 0, [[2**31 - 1280, 64 << 12, -5 << 12]],
                       12)
    assert plane.tolist() == [[0, 64, 0]]


def test_digest_sees_one_byte():
    x = np.random.default_rng(0).integers(0, 256, (32, 48), np.uint8)
    y = x.copy()
    y[17, 5] ^= 1
    assert digest.digest_np(x) != digest.digest_np(y)
    t = digest.DeviceDigest(torch.device("cpu")).planes(
        torch.from_numpy(np.stack([x, y])))
    assert t.tolist() == [digest.digest_np(x), digest.digest_np(y)]
