"""Mid-stream resolution change in the port, on the CPU: on the five
streams of tests/test_resolution_switch.py (48x32 to 128x96: growing,
shrinking, B pictures before a growing switch, a same-geometry SPS and
three switches) the port's TurboH264Decoder, which splits its pending
batch at each change and rebuilds its batcher, and its per-picture
native path give the same cropped-NV12 bytes as the JAX package's
Python decoder (that file holds those to the C reference binary, which
this machine lacks); and the port's RawWriter and Md5Writer write the
JAX package's bytes. Exact."""

import functools
import io

import pytest

import torch_helpers  # noqa: F401  (pins torch to one thread)
from test_resolution_switch import CASES

from m2dec_tpu.codecs.h264.decoder import H264Decoder as JaxH264Decoder
from m2dec_tpu.runtime import output as jax_output
from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder
from m2dec_tpu_torch.runtime import output
from m2dec_tpu_torch.runtime.turbo import TurboH264Decoder


@functools.lru_cache(maxsize=None)
def _stream(case):
    return CASES[case]()


@functools.lru_cache(maxsize=None)
def _jax_frames(case):
    dec = JaxH264Decoder()
    dec.set_data(_stream(case))
    return tuple(dec.decode_all())


def _nv12(frames, cropped=jax_output.cropped_nv12_bytes):
    return b"".join(cropped(f) for f in frames)


@functools.lru_cache(maxsize=None)
def _port_frames(case, path):
    data = _stream(case)
    if path == "turbo":
        return tuple(TurboH264Decoder(data, batch=3,
                                      device="cpu").decode_all())
    dec = H264Decoder(native=True, phase_b="torch", device="cpu")
    dec.set_data(data)
    return tuple(dec.decode_all())


@pytest.mark.parametrize("path", ["turbo", "native_torch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_switch(case, path):
    """The port's frames, cropped to NV12, byte-equal to the JAX
    package's Python decoder's, frame by frame."""
    want = _jax_frames(case)
    got = _port_frames(case, path)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g.width, g.height, g.crop) == (w.width, w.height, w.crop), k
        assert output.cropped_nv12_bytes(g) == \
            jax_output.cropped_nv12_bytes(w), f"frame {k}"
    assert _nv12(got, output.cropped_nv12_bytes) == _nv12(want)


@pytest.mark.parametrize("writer", ["RawWriter", "Md5Writer"])
def test_torch_writers(writer):
    """The port's writer on the port's frames of the growing switch
    (zero-byte frames included) writes the bytes of the JAX package's
    writer on the JAX decoder's frames."""
    got, want = io.BytesIO(), io.BytesIO()
    port_w = getattr(output, writer)(got)
    jax_w = getattr(jax_output, writer)(want)
    for f in _port_frames("grow", "turbo"):
        port_w.write_frame(f)
    for f in _jax_frames("grow"):
        jax_w.write_frame(f)
    assert got.getvalue() == want.getvalue()
    assert len(want.getvalue()) > 0
