"""The port's MPEG-1/2 FAST_DECODE mode (DC-only 1/8-scale decode,
m2dec_tpu_torch/codecs/mpeg2/fast.py) against the JAX package's
``codecs/mpeg2/fast.py`` run with ``xp=np`` / ``backend="numpy"``:
the array function on seeded random plans (field MC, MVs past every
edge, DC values that wrap), and whole streams through
``Mpeg2Decoder(fast=True)`` compared in the output writer's bytes, pad
columns included. Integer decode: tolerance 0."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per worker)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.mpeg2_enc import Mpeg2FieldMcGen, Mpeg2StreamGen  # noqa: E402

from m2dec_tpu.codecs.mpeg2 import fast as jfast  # noqa: E402
from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder as JaxMpeg2  # noqa: E402
from m2dec_tpu.runtime.output import cropped_nv12_bytes as jax_bytes  # noqa: E402
from m2dec_tpu_torch.codecs.mpeg2 import fast as tfast  # noqa: E402
from m2dec_tpu_torch.codecs.mpeg2.decoder import Mpeg2Decoder  # noqa: E402
from m2dec_tpu_torch.runtime.output import cropped_nv12_bytes  # noqa: E402


def _rand_plan(mb_w, mb_h, seed, field):
    """Seeded inputs of reconstruct_fast_arrays: every MB kind and
    direction, half-pel MVs that reach up to 40 coarse samples past each
    edge, DCs over the whole dequantized range (stores wrap), and with
    ``field`` the field-MC arrays with both field selects."""
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    a = {
        "intra": rng.random(n) < 0.25,
        "fwd": rng.random(n) < 0.6,
        "bwd": rng.random(n) < 0.5,
        "mvf": rng.integers(-640, 640, (n, 2)).astype(np.int32),
        "mvb": rng.integers(-640, 640, (n, 2)).astype(np.int32),
        "dc0": rng.integers(-2048 * 8, 2048 * 8, (n, 6)).astype(np.int16),
    }
    refs = []
    for _ in range(2):
        refs += [rng.integers(0, 256, (mb_h * 2, mb_w * 2)).astype(np.uint8),
                 rng.integers(0, 256, (mb_h, mb_w)).astype(np.uint8),
                 rng.integers(0, 256, (mb_h, mb_w)).astype(np.uint8)]
    kw = {}
    if field:
        kw = {"mvf2": rng.integers(-640, 640, (n, 2)).astype(np.int32),
              "mvb2": rng.integers(-640, 640, (n, 2)).astype(np.int32),
              "fsel": rng.integers(0, 16, n).astype(np.int32),
              "fieldmc": rng.random(n) < 0.6}
    return a, refs, kw


@pytest.mark.parametrize("mb_w,mb_h,seed,field", [
    (5, 3, 1, False), (5, 3, 2, True), (1, 1, 3, True), (9, 7, 4, True)])
def test_reconstruct_fast_arrays_vs_jax(mb_w, mb_h, seed, field):
    a, refs, kw = _rand_plan(mb_w, mb_h, seed, field)
    names = ("intra", "fwd", "bwd", "mvf", "mvb", "dc0")
    want = jfast.reconstruct_fast_arrays(
        *(a[k] for k in names), *refs, mb_w=mb_w, mb_h=mb_h, xp=np, **kw)
    t = torch.from_numpy
    got = tfast.reconstruct_fast_arrays(
        *(t(a[k]) for k in names), *(t(r) for r in refs), mb_w=mb_w,
        mb_h=mb_h, **{k: t(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


def test_ctrunc2_and_pair_rounding_on_negative_mvs():
    """C division toward zero and the CbCr pair rounding on every MV in
    [-64, 64), against the JAX helpers."""
    v = np.arange(-64, 64, dtype=np.int32)
    np.testing.assert_array_equal(tfast._ctrunc2(torch.from_numpy(v)).numpy(),
                                  jfast._ctrunc2(v, np))
    ref = np.arange(8 * 40, dtype=np.uint8).reshape(8, 40)
    z = np.full(v.size, 3, np.int32)
    want = jfast._chroma_pred(ref, v * 5, v, z, z, np)
    got = tfast._chroma_pred(torch.from_numpy(ref), torch.from_numpy(v * 5),
                             torch.from_numpy(v), torch.from_numpy(z),
                             torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), want)


STREAMS = {
    "ipbb": lambda: Mpeg2StreamGen(64, 48, seed=1).generate("IPBB"),
    "mpeg1": lambda: Mpeg2StreamGen(80, 48, seed=6,
                                    mpeg1=True).generate("IPBP"),
    "fieldmc": lambda: Mpeg2FieldMcGen(96, 64, seed=8,
                                       field_prob=0.7).generate("IPBP"),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_fast_decoder_vs_jax(name):
    data = STREAMS[name]()
    ref = JaxMpeg2(backend="numpy", fast=True)
    ref.set_data(data)
    want = ref.decode_all()
    dec = Mpeg2Decoder(fast=True, device="cpu")
    dec.set_data(data)
    got = dec.decode_all()
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert (g.width, g.height, g.crop, g.raw_stride) == (
            w.width, w.height, w.crop, w.raw_stride)
        assert g.raw_stride > g.width  # the pad columns are in the bytes
        assert cropped_nv12_bytes(g) == jax_bytes(w)
    if name == "fieldmc":
        assert any(p.fieldmc.any() for p in _plans(data))


def _plans(data):
    dec = Mpeg2Decoder(device="cpu", defer_recon=True)
    dec.set_data(data)
    while dec.decode_data() == 1:
        pass
    return [it[0] for it in dec.plans]

