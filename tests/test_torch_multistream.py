"""The port's stacked multi-stream Phase B (MultiStreamPhaseB) on the CPU:
S streams of different content through one batch, each picture byte-equal
to the JAX package's numpy plan interpreter (``recon_ref``) on the plans
of its Python decoder, and the per-stream checksums equal to the JAX
package's ``host_checksum``; the one-stream case against BatchedPhaseB,
across batches and after reset(); and the wavefront wrappers on [S, H, W]
stacks against one call per stream. Exact (tolerance 0). No JAX graph is
compiled: the JAX side is numpy."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from torch_helpers import rand_planes, rand_wavefront_plan, torch_plan

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import (  # noqa: E402
    H264BGen,
    H264HighGen,
    H264InterGen,
)

from m2dec_tpu.codecs.h264 import decoder as jax_decoder  # noqa: E402
from m2dec_tpu.codecs.h264.recon_ref import reconstruct_plan_np  # noqa: E402
from m2dec_tpu.codecs.h264.reconstruct import host_checksum  # noqa: E402
from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK  # noqa: E402
from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu_torch.codecs.h264.plan_host import dev_pool_size  # noqa: E402
from m2dec_tpu_torch.codecs.h264.reconstruct import (  # noqa: E402
    BatchedPhaseB,
    MultiStreamPhaseB,
)
from m2dec_tpu_torch.runtime import golden  # noqa: E402


def _mixed():
    """The two streams of tests/test_h264_plan.py's
    test_multistream_phase_b_mixed."""
    return [H264BGen(48, 32, seed=5, skip_prob=0.3, intra_prob=0.2,
                     num_ref_frames=2, qp=28).generate("IPPBPB"),
            H264BGen(48, 32, seed=21, skip_prob=0.1, intra_prob=0.05,
                     num_ref_frames=2, b_direct_prob=0.4, direct_spatial=1,
                     qp=33).generate("IPPBPB")]


def _i8_in_stream_1():
    """A Main stream, then a High stream with 8x8-transform MBs."""
    return [H264InterGen(48, 32, seed=3, skip_prob=0.2, intra_prob=0.2,
                         num_ref_frames=2, qp=29,
                         disable_deblock=False).generate("IPPI"),
            H264HighGen(48, 32, seed=1, intra_prob=0.2, skip_prob=0.15,
                        qp=29, disable_deblock=False).generate("IPPI")]


def _pcm_in_stream_0():
    """A stream with IPCM MBs, then one without."""
    return [H264BGen(48, 32, seed=5, skip_prob=0.2, intra_prob=0.3,
                     ipcm_prob=0.5, num_ref_frames=2,
                     b_direct_prob=0.2).generate("IPBP"),
            H264BGen(48, 32, seed=6, skip_prob=0.2, intra_prob=0.3,
                     ipcm_prob=0.0, num_ref_frames=2,
                     b_direct_prob=0.2).generate("IPBP")]


def _expected(data):
    """Each picture of ``data`` in decode order, from the JAX package's
    Python decoder's plans through its numpy plan interpreter."""
    dec = jax_decoder.H264Decoder(dpb_max=1, record_plans=True)
    dec.set_data(data)
    shadow = None
    exp = []
    while dec.decode_picture() == 1:
        if shadow is None:
            h, w = dec.frames[0].y.shape
            shadow = [jax_decoder.Frame(w, h) for _ in dec.frames]
        plan = dec.plans[-1]
        reconstruct_plan_np(plan, shadow)
        f = shadow[plan.cur_idx]
        exp.append((f.y.copy(), f.cb.copy(), f.cr.copy()))
    return exp


def _native(data):
    """(plans, (mb_w, mb_h, device pool size)) of the port's native
    Phase A."""
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    return dec.plans, (dec.max_x, dec.max_y,
                       dev_pool_size(dec.sps.num_ref_frames,
                                     len(dec.frames)))


def _has_i8(plans):
    return any(((p.kind == 2) | ((p.kind == 0) & (p.t8x8 != 0))).any()
               for p in plans)


@pytest.mark.parametrize("streams", [_mixed, _i8_in_stream_1,
                                     _pcm_in_stream_0])
def test_multistream_vs_recon_ref(streams):
    """S = 2 streams of one batch, each picture equal to recon_ref;
    checksums equal to host_checksum of the JAX package."""
    datas = streams()
    native = [_native(d) for d in datas]
    plans = [p for p, _ in native]
    if streams is _i8_in_stream_1:
        # the case that a flag taken from stream 0 alone gets wrong
        assert not _has_i8(plans[0]) and _has_i8(plans[1])
    if streams is _pcm_in_stream_0:
        assert any(p.pcm for p in plans[0])
        assert not any(p.pcm for p in plans[1])
    mb_w, mb_h, _ = native[0][1]
    pool = max(g[2] for _, g in native)
    ms = MultiStreamPhaseB(len(datas), mb_w, mb_h, pool, device="cpu")
    outs = ms.run(plans)
    cks = MultiStreamPhaseB.checksums(outs)
    assert cks.dtype == np.int32 and cks.shape == (len(datas), 3, 2)
    for s, data in enumerate(datas):
        exp = _expected(data)
        assert len(exp) == len(plans[s])
        for k, want in enumerate(exp):
            for pl, o, w in zip(("y", "cb", "cr"), outs[s], want):
                assert np.array_equal(o[k].numpy(), w), \
                    f"stream {s} picture {k} {pl}"
        stacks = [np.stack([e[i] for e in exp]) for i in range(3)]
        assert np.array_equal(cks[s], host_checksum(*stacks))
        assert np.array_equal(golden.host_checksum(*stacks),
                              host_checksum(*stacks))


def test_multistream_one_stream_is_batched():
    """S = 1 equals BatchedPhaseB; a GOP split over two run() calls equals
    one call (the pool and slot map carry over); after reset() the
    output repeats."""
    plans, geom = _native(_mixed()[0])
    want = BatchedPhaseB(*geom, device="cpu").run_async(plans)
    ms = MultiStreamPhaseB(1, *geom, device="cpu")
    first = ms.run([plans[:3]])[0]
    second = ms.run([plans[3:]])[0]
    split = tuple(torch.cat(ab) for ab in zip(first, second))
    ms.reset()
    again = ms.run([plans])[0]
    for got in (split, again):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["intra_luma", "intra_chroma",
                                  "deblock_luma", "deblock_chroma",
                                  "run_wavefronts"])
def test_wavefront_wrappers_stacked(name):
    """Each wrapper on [S, H, W] planes (S = 3, a different plan per
    stream) equals one call per stream."""
    mb_w, mb_h, S = 4, 2, 3
    Ps = [torch_plan(rand_wavefront_plan(mb_w, mb_h, 30 + s, wide=True))
          for s in range(S)]
    planes = [[torch.from_numpy(a) for a in rand_planes(mb_w, mb_h, 30 + s)]
              for s in range(S)]
    P = {k: torch.cat([p[k] for p in Ps]) for k in Ps[0]}
    y, cb, cr = (torch.stack(t) for t in zip(*planes))

    def call(y, cb, cr, P):
        if name == "run_wavefronts":
            return WK.run_wavefronts(y, cb, cr, P, True, True, mb_w, mb_h)
        fn = getattr(WK, name)
        if name == "intra_luma":
            return (fn(y, P, True, mb_w, mb_h),)
        if name == "deblock_luma":
            return (fn(y, P, mb_w, mb_h),)
        return fn(cb, cr, P, mb_w, mb_h)

    got = call(y, cb, cr, P)
    want = [call(*planes[s], Ps[s]) for s in range(S)]
    for i, g in enumerate(got):
        assert g.shape[0] == S
        for s in range(S):
            assert torch.equal(g[s], want[s][i]), f"stream {s} plane {i}"
