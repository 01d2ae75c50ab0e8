"""The port's overlapped decoder (m2dec_tpu_torch.runtime.turbo) on the
CPU: frames, order and error containment identical to the serial
decoder (as tests/test_turbo.py holds the JAX twin to), the device
checksum against host_checksum, and a fresh interpreter showing that
the port decodes H.264 and MPEG-2 without importing jax or any module
of m2dec_tpu."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (pins torch to one thread)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import (  # noqa: E402
    H264BGen,
    H264HighGen,
    H264MmcoGen,
)
from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402
from streamgen.mpeg2_enc import Mpeg2StreamGen  # noqa: E402

from m2dec_tpu.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu.codecs.h264.reconstruct import host_checksum  # noqa: E402
from m2dec_tpu_torch.codecs.h264.reconstruct import BatchedPhaseB  # noqa: E402,E501
from m2dec_tpu_torch.runtime.golden import frame_checksums  # noqa: E402
from m2dec_tpu_torch.runtime.turbo import TurboH264Decoder  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def serial_frames(data):
    dec = H264Decoder()
    dec.set_data(data)
    return dec.decode_all()


def assert_equiv(data, batch):
    exp = serial_frames(data)
    got = TurboH264Decoder(data, batch=batch, device="cpu").decode_all()
    assert len(got) == len(exp)
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt, f"frame {k} poc"
        assert g.crop == e.crop
        assert np.array_equal(g.y, e.y), f"frame {k} y"
        assert np.array_equal(g.cb, e.cb), f"frame {k} cb"
        assert np.array_equal(g.cr, e.cr), f"frame {k} cr"


def _b_stream():
    return H264BGen(48, 32, seed=2, skip_prob=0.2, intra_prob=0.15,
                    num_ref_frames=2, b_direct_prob=0.3, qp=30,
                    disable_deblock=False).generate("IPBBPBBPB")


@pytest.mark.parametrize("batch", [1, 3, 12])
def test_torch_turbo_b_reordered(batch):
    assert_equiv(_b_stream(), batch)


def test_torch_turbo_multi_gop_high():
    gen = H264HighGen(48, 32, seed=4, skip_prob=0.25, intra_prob=0.15,
                      qp=27, disable_deblock=False)
    assert_equiv(gen.generate("IPPIPP"), 4)


def test_torch_turbo_mmco():
    gen = H264MmcoGen(48, 32, seed=1, skip_prob=0.2, intra_prob=0.15)
    assert_equiv(gen.generate("IPPPPP"), 4)


def test_torch_turbo_pcm():
    gen = H264BGen(48, 32, seed=5, skip_prob=0.2, intra_prob=0.3,
                   ipcm_prob=0.5, num_ref_frames=2, b_direct_prob=0.2)
    assert_equiv(gen.generate("IPBP"), 3)


def test_torch_turbo_truncated_drains():
    data = H264BGen(48, 32, seed=2, skip_prob=0.2, intra_prob=0.15,
                    num_ref_frames=2, b_direct_prob=0.3).generate("IPBBP")
    cut = data[: len(data) * 3 // 4]
    exp = serial_frames(cut)
    t = TurboH264Decoder(cut, batch=4, device="cpu")
    got = t.decode_all()
    assert t.error < 0
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g.y, e.y)


def test_torch_device_checksum_matches_host():
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(_b_stream())
    while dec.decode_picture() == 1:
        pass
    b = BatchedPhaseB(dec.max_x, dec.max_y, len(dec.frames), device="cpu")
    outs = b.run_async(dec.plans)
    cks = frame_checksums(*outs)
    assert cks.dtype == torch.int32
    assert tuple(cks.shape) == (len(dec.plans), 3, 2)
    for i in range(len(dec.plans)):
        want = host_checksum(*(o[i].numpy() for o in outs))
        assert np.array_equal(cks[i].numpy(), want), f"picture {i}"


def test_torch_batched_needs_native_plans():
    """Plans of the Python decoder carry no coded maps, which the native
    wire packer needs: BatchedPhaseB refuses them."""
    dec = H264Decoder(dpb_max=1, record_plans=True)
    dec.set_data(_b_stream())
    dec.decode_picture()
    assert dec.plans[0].coded is None
    b = BatchedPhaseB(dec.max_x, dec.max_y, len(dec.frames), device="cpu")
    with pytest.raises(ValueError, match="native"):
        b.run_async(dec.plans)


@pytest.mark.parametrize("crop", [(0, 0, 0, 0), (2, 6, 4, 8)])
def test_torch_golden_frame_checksum(crop):
    """The port's cropped-NV12 frame checksum against the JAX package's
    device_frame_cks on the same planes."""
    from m2dec_tpu.runtime.golden import device_frame_cks as jax_cks
    from m2dec_tpu_torch.runtime.golden import device_frame_cks

    rng = np.random.default_rng(sum(crop))
    y = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    cb = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    cr = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    got = device_frame_cks(torch.from_numpy(y), torch.from_numpy(cb),
                           torch.from_numpy(cr), crop)
    assert got == jax_cks(y, cb, cr, crop)


def test_torch_port_never_imports_jax(tmp_path):
    """In a fresh interpreter (the test process itself has jax loaded by
    conftest), the port imports every one of its modules and decodes a
    48x32 H.264 stream (TurboH264Decoder, and twice side by side through
    MultiStreamPhaseB), an 80x48 MPEG-2 stream and a 64x48 H.265 stream
    (TurboH265Decoder, on the CTU-tile schedule at its CTB 16: one tile
    wavefront per picture), and runs the h264dec --turbo and m2dec --fast
    tools in-process; neither jax nor any module of m2dec_tpu is
    loaded."""
    h264 = tmp_path / "s.264"
    h264.write_bytes(_b_stream())
    m2v = tmp_path / "s.m2v"
    m2v.write_bytes(Mpeg2StreamGen(80, 48, seed=11).generate("IPPBPBB"))
    h265 = tmp_path / "s.265"
    h265.write_bytes(H265StreamGen(
        64, 48, seed=82, qp=32, cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
        deblock=1, sao=1, max_level=1).generate("IPBPB"))
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import m2dec_tpu_torch\n"
        "for m in pkgutil.walk_packages(m2dec_tpu_torch.__path__,\n"
        "                               'm2dec_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from m2dec_tpu_torch.runtime.turbo import (TurboH264Decoder,\n"
        "                                           TurboMpeg2Decoder)\n"
        f"data = open({str(h264)!r}, 'rb').read()\n"
        "frames = TurboH264Decoder(data, batch=4, device='cpu')"
        ".decode_all()\n"
        "assert len(frames) == 9, len(frames)\n"
        "assert all(np.asarray(f.y).shape == (32, 48) for f in frames)\n"
        "from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder\n"
        "from m2dec_tpu_torch.codecs.h264.reconstruct import (\n"
        "    MultiStreamPhaseB)\n"
        "dec = H264Decoder(native=True, plan_alloc='empty')\n"
        "dec.set_data(data)\n"
        "while dec.decode_picture() == 1:\n"
        "    pass\n"
        "ms = MultiStreamPhaseB(2, dec.max_x, dec.max_y, len(dec.frames),\n"
        "                       device='cpu')\n"
        "cks = MultiStreamPhaseB.checksums(ms.run([dec.plans] * 2))\n"
        "assert cks.shape == (2, 3, 2) and (cks[0] == cks[1]).all()\n"
        f"data = open({str(m2v)!r}, 'rb').read()\n"
        "frames = TurboMpeg2Decoder(data, batch=3, device='cpu')"
        ".decode_all()\n"
        "assert len(frames) == 6, len(frames)\n"
        "assert all(np.asarray(f.y).shape == (48, 80) for f in frames)\n"
        "from m2dec_tpu_torch.runtime.turbo import TurboH265Decoder\n"
        "from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK\n"
        "tiles = []\n"
        "real = TK.tile_wavefront\n"
        "TK.tile_wavefront = lambda *a: (tiles.append(1), real(*a))[1]\n"
        f"data = open({str(h265)!r}, 'rb').read()\n"
        "frames = TurboH265Decoder(data, batch=2, device='cpu')"
        ".decode_all()\n"
        "TK.tile_wavefront = real\n"
        "assert len(tiles) == 5, len(tiles)\n"
        "assert len(frames) == 5, len(frames)\n"
        "assert [f.cnt for f in frames] == [0, 1, 2, 3, 4], frames\n"
        "assert all(f.y.shape == (48, 64) and f.y.any() for f in frames)\n"
        "import os\n"
        "from m2dec_tpu_torch.apps import h264dec, m2dec\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "assert h264dec.main(['--turbo', '-O', '--device', 'cpu',\n"
        "                     's.264']) == 0\n"
        "assert open('s.out', 'rb').read().count(b'\\r\\n') == 9\n"
        "assert m2dec.main(['--fast', '-o', 'fast.raw', '--device', 'cpu',\n"
        "                   's.m2v']) == 0\n"
        "assert os.path.getsize('fast.raw') == 6 * 10 * 6 * 3 // 2\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'm2dec_tpu'\n"
        "       or m.startswith(('jax.', 'm2dec_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
