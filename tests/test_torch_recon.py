"""reconstruct_plan_torch (the port's per-plan Phase B, on the CPU)
beside reconstruct_plan_jax and the interleaved decoder's own frames:
the roundtrip of tests/test_h264_plan.py. Exact (tolerance 0)."""

import pathlib
import sys

import numpy as np
import pytest

import torch_helpers  # noqa: F401  (pins torch to one thread)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import (  # noqa: E402
    H264BGen,
    H264CabacIGen,
    H264HighGen,
    H264IntraGen,
    H264InterGen,
    H264StreamGen,
    H264WeightedGen,
)

from m2dec_tpu.codecs.h264.decoder import Frame, H264Decoder  # noqa: E402
from m2dec_tpu.codecs.h264.reconstruct import (  # noqa: E402
    reconstruct_plan_jax,
)
from m2dec_tpu_torch.codecs.h264.reconstruct import (  # noqa: E402
    reconstruct_plan_torch,
)


def _torch_cpu(plan, frames):
    reconstruct_plan_torch(plan, frames, device="cpu")


def roundtrip(gen, pattern, with_jax=True):
    """The port (and the JAX graph, beside it) must reproduce the
    interleaved decoder's frames exactly."""
    data = gen.generate(pattern)
    dec = H264Decoder(dpb_max=1, record_plans=True)
    dec.set_data(data)
    backends = [(_torch_cpu, "torch")]
    if with_jax:
        backends.append((reconstruct_plan_jax, "jax"))
    shadows = None
    npics = 0
    while dec.decode_picture() == 1:
        if shadows is None:
            h, w = dec.frames[0].y.shape
            shadows = [[Frame(w, h) for _ in dec.frames] for _ in backends]
        plan = dec.plans[-1]
        ref = dec.frames[plan.cur_idx]
        for shadow, (recon, name) in zip(shadows, backends):
            recon(plan, shadow)
            ours = shadow[plan.cur_idx]
            for pl in ("y", "cb", "cr"):
                a, b = getattr(ours, pl), getattr(ref, pl)
                if not np.array_equal(a, b):
                    bad = np.argwhere(a != b)
                    raise AssertionError(
                        f"[{name}] pic {npics} plane {pl}: {len(bad)} "
                        f"mismatches, first at {bad[0]}")
        npics += 1
    assert npics == len(dec.plans) and npics > 0


def test_torch_plan_intra_cavlc():
    roundtrip(H264IntraGen(48, 32, seed=3, qp=28, disable_deblock=False),
              "II")


def test_torch_plan_ipcm():
    roundtrip(H264StreamGen(48, 32, seed=1), "III")


def test_torch_plan_intra_cabac():
    roundtrip(H264CabacIGen(48, 32, seed=7, qp=30, disable_deblock=False),
              "II")


def test_torch_plan_p_multiref():
    roundtrip(H264InterGen(48, 32, seed=5, num_ref_frames=4), "IPPPPI")


@pytest.mark.parametrize("spatial", [0, 1])
def test_torch_plan_b(spatial):
    roundtrip(
        H264BGen(48, 32, seed=spatial, skip_prob=0.25, intra_prob=0.15,
                 num_ref_frames=2, b_direct_prob=0.3,
                 direct_spatial=spatial), "IPBPBB")


def test_torch_plan_high_deblock():
    roundtrip(H264HighGen(48, 32, seed=1, intra_prob=0.2, skip_prob=0.15,
                          qp=29, disable_deblock=False), "IPPI")


def test_torch_plan_weighted_explicit():
    roundtrip(H264WeightedGen(48, 32, seed=0, skip_prob=0.15,
                              intra_prob=0.1, num_ref_frames=2,
                              b_direct_prob=0), "IPP")


@pytest.mark.parametrize("idc", [1, 2])
def test_torch_plan_weighted_b(idc):
    roundtrip(H264WeightedGen(48, 32, seed=idc, skip_prob=0.15,
                              intra_prob=0.1, num_ref_frames=2,
                              b_direct_prob=0.3, bipred_idc=idc), "IPBPB")


def test_torch_plan_cif_deblock():
    """A larger picture with deblocking across many diagonals; checked
    against the decoder only (the JAX graph's compile is the slow
    part)."""
    roundtrip(
        H264BGen(176, 144, seed=11, skip_prob=0.2, intra_prob=0.1,
                 num_ref_frames=4, b_direct_prob=0.3, direct_spatial=1,
                 qp=30, disable_deblock=False), "IPB", with_jax=False)
