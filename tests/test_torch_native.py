"""The port's own copy of the native C++ Phase A (m2dec_tpu_torch.native):
table files (and the H.265 sources) byte-identical to the JAX package's,
plans equal to the JAX package's native plans key by key, concurrent
first loads that all succeed, and a failed build that raises."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_helpers  # noqa: F401  (pins torch to one thread)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import H264BGen, H264HighGen  # noqa: E402
from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402
from streamgen.mpeg2_enc import Mpeg2FieldMcGen, Mpeg2StreamGen  # noqa: E402

import m2dec_tpu.native as JN  # noqa: E402
from m2dec_tpu.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu.codecs.h265.headers import H265Decoder  # noqa: E402
from m2dec_tpu.codecs.mpeg2.decoder import Mpeg2Decoder  # noqa: E402
import m2dec_tpu_torch.native as PN  # noqa: E402
from m2dec_tpu_torch.codecs.h264.decoder import (  # noqa: E402
    H264Decoder as PortH264Decoder,
)
from m2dec_tpu_torch.codecs.h265.headers import (  # noqa: E402
    H265Decoder as PortH265Decoder,
)
from m2dec_tpu_torch.codecs.mpeg2.decoder import (  # noqa: E402
    Mpeg2Decoder as PortMpeg2Decoder,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["h264_tables.inc", "mpeg2_tables.inc",
                                  "h265_tables.inc", "h265parse.cpp",
                                  "oplevel.cpp"])
def test_native_tables_identical(name):
    port = (REPO / "m2dec_tpu_torch" / "native" / name).read_bytes()
    assert port == (REPO / "m2dec_tpu" / "native" / name).read_bytes()


def _h264_plans(cls, data):
    dec = cls(native=True)
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    return dec.plans


H264_STREAMS = {
    "b_48x32": lambda: H264BGen(48, 32, seed=2, skip_prob=0.2,
                                intra_prob=0.15, num_ref_frames=2,
                                b_direct_prob=0.3, qp=30,
                                disable_deblock=False).generate("IPBBPB"),
    "high_176x144": lambda: H264HighGen(
        176, 144, seed=1, intra_prob=0.2, skip_prob=0.15, qp=29,
        disable_deblock=False).generate("IPPIP"),
}


@pytest.mark.parametrize("name", sorted(H264_STREAMS))
def test_native_h264_plans_equal(name):
    if JN.load_h264() is None:
        pytest.skip("the JAX package's native library did not load in "
                    "this process (its concurrent-build race, ROADMAP)")
    data = H264_STREAMS[name]()
    want = _h264_plans(H264Decoder, data)
    got = _h264_plans(PortH264Decoder, data)
    assert len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert vars(g).keys() == vars(w).keys()
        for key, b in vars(w).items():
            a = getattr(g, key)
            if isinstance(b, np.ndarray):
                assert np.array_equal(a, b), f"picture {k} {key}"
            elif key == "pcm":
                assert a.keys() == b.keys()
                for mb in b:
                    for x, y in zip(a[mb], b[mb]):
                        assert np.array_equal(x, y), f"picture {k} pcm"
            else:
                assert a == b, f"picture {k} {key}"


def _h265_plans(cls, data):
    dec = cls()
    dec.set_data(data)
    dec.begin_decode(backend="native", defer_recon=True)
    while dec.decode_picture() == 1:
        pass
    return dec.plans


H265_STREAMS = {
    "b_64x48": lambda: H265StreamGen(
        64, 48, seed=82, qp=32, cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
        deblock=1, sao=1, max_level=1).generate("IPBPB"),
    "ctb32_96x64": lambda: H265StreamGen(
        96, 64, seed=72, qp=14, ctb_log2=5, cbf_prob=0.3, modes=ALL_MODES,
        tmvp=1, amvp_prob=1.0, skip_prob=0.0, max_mvd=300,
        strong_smoothing=1).generate("IPP"),
    "tskip_sdh_64x48": lambda: H265StreamGen(
        64, 48, seed=32, qp=14, cbf_prob=0.7, modes=ALL_MODES,
        transform_skip=1, sign_data_hiding=1, split_prob=0.7,
        nxn_prob=0.8).generate(2),
}


@pytest.mark.parametrize("name", sorted(H265_STREAMS))
def test_native_h265_plans_equal(name):
    """The port's native H.265 Phase A (defer mode, as TurboH265Decoder
    runs it) fills the JAX package's plans field by field, so both Phase
    Bs consume equal plans."""
    if JN.load_h265() is None:
        pytest.skip("the JAX package's native library did not load in "
                    "this process (its concurrent-build race, ROADMAP)")
    data = H265_STREAMS[name]()
    want = _h265_plans(H265Decoder, data)
    got = _h265_plans(PortH265Decoder, data)
    assert len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert vars(g).keys() == vars(w).keys()
        for key, b in vars(w).items():
            a = getattr(g, key)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    f"picture {k} {key}"
            else:
                assert a == b, f"picture {k} {key}"


def _m2v_plans(dec, data):
    dec.set_data(data)
    while dec.decode_data() == 1:
        pass
    return dec.plans


@pytest.mark.parametrize("gen", ["frame", "field_mc"])
def test_native_mpeg2_plans_equal(gen):
    if JN.load_m2v() is None:
        pytest.skip("the JAX package's native library did not load in "
                    "this process (its concurrent-build race, ROADMAP)")
    data = (Mpeg2StreamGen(80, 48, seed=11).generate("IPPBPBB")
            if gen == "frame" else
            Mpeg2FieldMcGen(80, 48, seed=9, field_prob=0.7).generate(
                "IPPBP"))
    want = _m2v_plans(Mpeg2Decoder(backend="numpy", defer_recon=True),
                      data)
    got = _m2v_plans(PortMpeg2Decoder(device="cpu", defer_recon=True),
                     data)
    assert len(got) == len(want) > 0
    for k, ((gp, *gs), (wp, *ws)) in enumerate(zip(got, want)):
        assert gs == ws, f"picture {k} slots"
        for f in dataclasses.fields(wp):
            a, b = getattr(gp, f.name), getattr(wp, f.name)
            if isinstance(b, np.ndarray):
                assert np.array_equal(a, b), f"picture {k} {f.name}"
            else:
                assert a == b, f"picture {k} {f.name}"


def test_native_concurrent_first_loads(tmp_path):
    """Four processes load the m2v library at once into an empty build
    directory: every one gets a complete library (the build is locked
    and published with os.replace)."""
    code = ("import sys\n"
            "import m2dec_tpu_torch.native as N\n"
            "N.BUILD_ROOT = sys.argv[1]\n"
            "lib = N.load_m2v()\n"
            "assert lib.m2v_decode_picture is not None\n"
            "print('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "ok"
    assert len(list(tmp_path.glob("*/libm2vparse.so"))) == 1
    assert not list(tmp_path.glob("*/*.tmp"))


def test_native_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PN, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(PN, "CXX_FLAGS", PN.CXX_FLAGS + ("-DM2V=(",
                                                         "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PN.load_m2v()
    assert not list(tmp_path.glob("*/*.so"))
