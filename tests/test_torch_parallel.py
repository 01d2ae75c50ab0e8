"""The port's multi-device decode (m2dec_tpu_torch.parallel.mesh) on the
CPU, on in-process meshes of 4 and 8 shards: every step byte-equal to
the JAX package's numpy references on the inputs of the JAX package's
own mesh tests (``reconstruct_arrays(xp=np)`` for MPEG-2, ``recon_ref``
for H.264) or, for H.265, to the port's single-device Phase B (which
``tests/test_torch_h265.py`` holds to the JAX package). The example
generators give the JAX ones' arrays. Exact (tolerance 0). No JAX graph is
compiled: the JAX side is numpy."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one intra-op thread)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import H264HighGen, H264InterGen  # noqa: E402

from m2dec_tpu.codecs.h264.decoder import Frame, H264Decoder  # noqa: E402
from m2dec_tpu.codecs.h264.plan import PicturePlan  # noqa: E402
from m2dec_tpu.codecs.h264.recon_ref import reconstruct_plan_np  # noqa: E402
from m2dec_tpu.codecs.mpeg2.reconstruct import (  # noqa: E402
    reconstruct_arrays as jax_reconstruct_arrays,
)
from m2dec_tpu.parallel import mesh as JM  # noqa: E402
from m2dec_tpu_torch.codecs.h264 import plan_host as host  # noqa: E402
from m2dec_tpu_torch.codecs.h264 import reconstruct as R  # noqa: E402
from m2dec_tpu_torch.codecs.h265.reconstruct import (  # noqa: E402
    H265SeqPhaseB,
)
from m2dec_tpu_torch.parallel import mesh as M  # noqa: E402

CPU = torch.device("cpu")


def _mesh(n):
    return M.make_mesh(n, in_process=True, device="cpu")


def _jax_plan(stacked, g, i, mb_w, mb_h, cur):
    """The JAX package's PicturePlan of GOP g's picture i."""
    p = PicturePlan(mb_w, mb_h)
    for k in host._PLAN_KEYS:
        setattr(p, k, np.asarray(stacked[k][g, i]))
    p.cur_idx = int(cur)
    return p


def _recon_ref(stacked, g, i, mb_w, mb_h, frames, cur):
    """recon_ref of GOP g's picture i on the pool ``frames`` as it was
    before the picture (Phase B's semantics: the example plans read the
    slot they write), into frames[cur]; returns that Frame."""
    p = _jax_plan(stacked, g, i, mb_w, mb_h, len(frames))
    out = Frame(mb_w * 16, mb_h * 16)
    reconstruct_plan_np(p, frames + [out])
    frames[cur] = out
    return out


def _frames(pools, g):
    """GOP g's pool as the JAX package's Frames."""
    py, pcb, pcr = pools
    out = []
    for s in range(py.shape[1]):
        f = Frame(py.shape[3], py.shape[2])
        f.y[:], f.cb[:], f.cr[:] = py[g, s], pcb[g, s], pcr[g, s]
        out.append(f)
    return out


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_example_generators_match_jax():
    for a, b in zip(M.example_batch(8, 4, 3, seed=3),
                    JM.example_batch(8, 4, 3, seed=3)):
        assert a.dtype == b.dtype and _eq(a, b)
    pools, stacked, cur = M.h264_example_gops(4, 2, 4, 4, seed=1)
    jpools, jstacked, jcur, _ = JM.h264_example_gops(4, 2, 4, 4, seed=1)
    assert all(_eq(a, b) for a, b in zip(pools, jpools))
    assert stacked.keys() == jstacked.keys()
    assert all(_eq(stacked[k], jstacked[k]) for k in stacked)
    assert _eq(cur, jcur)
    pools, plans = M.h265_example_gops(4, 2, 32, 32, ctb_log2=4, seed=7)
    jpools, xs = JM.h265_example_gops(4, 2, 32, 32, ctb_log2=4, seed=7)
    assert all(_eq(a, b) for a, b in zip(pools, jpools))
    for g, gop in enumerate(plans):
        for i, p in enumerate(gop):
            for k in ("coef_y", "tu_y", "coef_cb", "tu_cb", "coef_cr",
                      "tu_cr", "slot", "mv", "dbv", "dbh", "dbcv", "dbch",
                      "sao_idx", "sao_opt", "sao_off"):
                assert _eq(getattr(p, k), xs[k][g, i]), (g, i, k)
            assert p.cur_idx == xs["cur_idx"][g, i]


def test_sharded_decode_matches_numpy_reference():
    n, mb_w, mb_h = 8, 4, 3
    args = M.example_batch(n, mb_w, mb_h, seed=3)
    y, cb, cr = M.sharded_decode_step(_mesh(8), mb_w, mb_h)(*args)
    assert y.shape == (n, mb_h * 16, mb_w * 16)
    for b in range(n):
        want = jax_reconstruct_arrays(*(a[b] for a in args), mb_w=mb_w,
                                      mb_h=mb_h, xp=np)
        for got, w in zip((y, cb, cr), want):
            assert _eq(got[b], w), b


def test_h264_gop_step_matches_recon_ref():
    G, N, mb_w, mb_h = 4, 2, 4, 4
    pools, stacked, cur = M.h264_example_gops(G, N, mb_w, mb_h)
    pool, outs = M.h264_gop_step(_mesh(4), mb_w, mb_h)(*pools, stacked,
                                                       cur)
    assert outs[0].shape == (G, N, mb_h * 16, mb_w * 16)
    for g in range(G):
        frames = _frames(pools, g)
        for i in range(N):
            f = _recon_ref(stacked, g, i, mb_w, mb_h, frames, cur[g, i])
            for got, want in zip(outs, (f.y, f.cb, f.cr)):
                assert _eq(got[g, i], want), (g, i)
        for got, pl in zip(pool, ("y", "cb", "cr")):
            assert _eq(got[g], np.stack([getattr(f, pl) for f in frames]))


def test_h265_gop_step_matches_single_device():
    H = W = 32
    pools, plans = M.h265_example_gops(4, 2, H, W, ctb_log2=4, seed=7)
    pool, outs = M.h265_gop_step(_mesh(4), H, W, 4)(*pools, plans)
    assert outs[0].shape == (4, 2, H, W)
    for g in range(4):
        ph = H265SeqPhaseB(H, W, pools[0].shape[1], device="cpu")
        want = ph.run_async(plans[g])
        for a, b in zip(outs, want):
            assert torch.equal(a[g], b)
        for a, b in zip(pool, ph.pool):
            assert torch.equal(a[g], b)


def _tile_stream(gen, n_bands, has_i8):
    """Each picture of a stream through an n_bands band step on an
    in-process mesh, against recon_ref on the JAX decoder's plans."""
    dec = H264Decoder(record_plans=True)
    dec.set_data(gen)
    step = shadow = None
    npic = 0
    while dec.decode_picture() == 1:
        plan = dec.plans[-1]
        if shadow is None:
            h, w = dec.frames[0].y.shape
            shadow = [Frame(w, h) for _ in dec.frames]
            step = M.h264_tile_step(_mesh(n_bands), plan.mb_w, plan.mb_h,
                                    has_i8=has_i8)
        refs = [np.stack([getattr(f, k) for f in shadow])
                for k in ("y", "cb", "cr")]
        y, cb, cr = step(M.h264_tile_plan(plan, n_bands), *refs)
        reconstruct_plan_np(plan, shadow)
        f = shadow[plan.cur_idx]
        for got, want in zip((y, cb, cr), (f.y, f.cb, f.cr)):
            assert _eq(got, want), npic
        npic += 1
    return npic


def test_h264_tile_step_matches_recon_ref():
    data = H264InterGen(48, 128, seed=3, intra_prob=0.35, num_ref_frames=2,
                        disable_deblock=False).generate("IPPP")
    assert _tile_stream(data, 8, has_i8=False) == 4


def test_h264_tile_step_8x8_transforms():
    data = H264HighGen(48, 64, seed=1, intra_prob=0.3, skip_prob=0.15,
                       qp=29, disable_deblock=False).generate("IP")
    assert _tile_stream(data, 4, has_i8=True) == 2


def test_h264_tile_step_refuses_ipcm_and_ragged_bands():
    p = PicturePlan(3, 4)
    p.kind[5] = 4
    step = M.h264_tile_step(_mesh(2), 3, 4)
    refs = [np.zeros((1, 64, 48), np.uint8)] + [
        np.zeros((1, 32, 24), np.uint8)] * 2
    with pytest.raises(ValueError, match="IPCM"):
        step(M.h264_tile_plan(p, 2), *refs)
    with pytest.raises(ValueError, match="not divisible"):
        M.h264_tile_step(_mesh(3), 3, 4)


def _xchg_case(n_shards, pool_size, mb_w, mb_h, seed):
    """The JAX package's exchange test case: every MB inter from the
    cross-shard page (slot pool_size), random MVs."""
    H, W = mb_h * 16, mb_w * 16
    rng = np.random.default_rng(seed)
    pools = (rng.integers(0, 256, (n_shards, pool_size, H, W)),
             rng.integers(0, 256, (n_shards, pool_size, H // 2, W // 2)),
             rng.integers(0, 256, (n_shards, pool_size, H // 2, W // 2)))
    pools = tuple(p.astype(np.uint8) for p in pools)
    plans = []
    for _ in range(n_shards):
        p = PicturePlan(mb_w, mb_h)
        p.kind[:] = 0
        p.slot[:, :, 0] = pool_size
        p.mv[:] = rng.integers(-6, 6, p.mv.shape)
        p.wp[:, :, :, 0] = 1
        plans.append(p)
    stacked = {k: np.stack([getattr(p, k) for p in plans])[:, None]
               for k in host._PLAN_KEYS}
    return pools, stacked, np.ones((n_shards, 1), np.int32)


def test_h264_gop_xchg_cross_shard_reference():
    n, pool_size, mb_w, mb_h = 4, 2, 3, 2
    pools, stacked, cur = _xchg_case(n, pool_size, mb_w, mb_h, 7)
    step = M.h264_gop_xchg_step(_mesh(n), mb_w, mb_h, pool_size,
                                handoff_slot=0, has_i8=False,
                                deblock=False)
    _, outs = step(*pools, stacked, cur)
    for g in range(1, n):
        # the previous shard's page appended as slot pool_size
        frames = _frames(pools, g) + [_frames(pools, g - 1)[0]]
        f = _recon_ref(stacked, g, 0, mb_w, mb_h, frames, 1)
        for got, pl in zip(outs, ("y", "cb", "cr")):
            assert _eq(got[g, 0], getattr(f, pl)), g


def test_inter_pass_y_off_is_a_window_of_the_picture():
    mb_w, mb_h, r0, r1 = 3, 4, 1, 3
    rng = np.random.default_rng(5)
    n = mb_w * mb_h
    refs = [torch.from_numpy(rng.integers(0, 256, (1, 2, h, w))
                             .astype(np.uint8))
            for h, w in ((64, 48), (32, 24), (32, 24))]
    mv = torch.from_numpy(rng.integers(-40, 40, (n, 16, 2, 2))
                          .astype(np.int32))
    slot = torch.from_numpy(rng.integers(-1, 2, (n, 4, 2)).astype(np.int32))
    slot[:, :, 0] = slot[:, :, 0].clamp(min=0)
    wp = torch.zeros((n, 4, 3, 4), dtype=torch.int32)
    wp[..., 0] = 1
    wp[..., 1] = 1
    wp[..., 3] = 1
    whole = R.inter_pass(mv, slot, wp, *refs, mb_w, mb_h, host._HP_TAB)
    a, b = r0 * mb_w, r1 * mb_w
    band = R.inter_pass(mv[a:b], slot[a:b], wp[a:b], *refs, mb_w, r1 - r0,
                        host._HP_TAB, y_off=16 * r0)
    for w, g in zip(whole, band):
        assert torch.equal(w[a:b], g)
    with pytest.raises(ValueError, match="y_off"):
        R.inter_pass(mv[a:b], slot[a:b], wp[a:b], *refs, mb_w, r1 - r0,
                     host._HP_TAB, used=torch.zeros((1, 2), dtype=torch.int32),
                     y_off=16)


def test_recon_batch_with_extra_pages():
    """_recon_batch on 2 GOPs whose plans read an external page (slot
    pool_size) and their own pool, against recon_ref with the page
    appended to each GOP's frames."""
    G, pool_size, mb_w, mb_h = 2, 2, 3, 2
    pools, stacked, cur = _xchg_case(G, pool_size, mb_w, mb_h, 11)
    stacked["slot"][1, 0, 3:, :, 0] = 1  # GOP 1: some MBs from its slot 1
    rng = np.random.default_rng(12)
    extra = [rng.integers(0, 256, (G, 1) + p.shape[2:]).astype(np.uint8)
             for p in pools]
    tp = [torch.from_numpy(p.copy()) for p in pools]
    st = {k: torch.from_numpy(v).to(torch.int32) for k, v in stacked.items()}
    pool, outs = R._recon_batch(*tp, st, cur, mb_w=mb_w, mb_h=mb_h,
                                has_i8=True, deblock=True,
                                extra=[torch.from_numpy(e) for e in extra])
    for g in range(G):
        page = Frame(mb_w * 16, mb_h * 16)
        page.y[:], page.cb[:], page.cr[:] = (e[g, 0] for e in extra)
        frames = _frames(pools, g) + [page]
        f = _recon_ref(stacked, g, 0, mb_w, mb_h, frames, cur[g, 0])
        for got, pl in zip(outs, ("y", "cb", "cr")):
            assert _eq(got[g, 0], getattr(f, pl)), g
        assert _eq(pool[0][g, 1], f.y)


def test_make_mesh_needs_a_process_group_or_in_process():
    """Outside a torch.distributed process group make_mesh raises: it
    never falls back to shards in this process by itself."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="in_process=True"):
        M.make_mesh(2)
    m = M.make_mesh(3, in_process=True, device="cpu")
    assert (m.size, m.shards, m.device) == (3, [0, 1, 2], CPU)
    x = [torch.full((2,), i) for i in range(3)]
    assert [t.tolist() for t in m.shift(x, 1)] == [[0, 0], [0, 0], [1, 1]]
    assert [t.tolist() for t in m.shift(x, -1)] == [[1, 1], [2, 2], [0, 0]]
