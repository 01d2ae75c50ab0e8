"""Plans without a native coded map (the Python decoder's) in the one
wire packer, ``native_pack.pack_batches``, on the CPU: the map that
``plan_host.derive_coded`` gives them packs a native plan byte for byte
as its own map does; such plans unpack to their own tensors, with one
layout for S streams where the JAX fallback refuses differing layouts
and with the flags ORed over the streams where it reads stream 0's; the
int32 and dense fallbacks; and both batchers on the Python decoder's
plans byte-equal to the JAX package's numpy plan interpreter
(``recon_ref``). Exact (tolerance 0); the JAX side is numpy."""

import functools
import types

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (pins torch to one thread)
from streamgen.h264_enc import H264BGen
from test_torch_multistream import (
    _i8_in_stream_1,
    _mixed,
    _native,
    _pcm_in_stream_0,
)

from m2dec_tpu.codecs.h264 import reconstruct as JR
from m2dec_tpu.codecs.h264.decoder import Frame
from m2dec_tpu.codecs.h264.recon_ref import reconstruct_plan_np
from m2dec_tpu_torch.codecs.h264 import plan_host as host
from m2dec_tpu_torch.codecs.h264 import reconstruct as R
from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder
from m2dec_tpu_torch.codecs.h264.native_pack import pack_batches


@functools.lru_cache(maxsize=None)
def _plan_stream():
    """The stream of tests/test_h264_plan.py's test_batched_phase_b."""
    return H264BGen(48, 32, seed=3, skip_prob=0.25, intra_prob=0.15,
                    num_ref_frames=2, b_direct_prob=0.3, direct_spatial=1,
                    qp=30).generate("IPBPBB")


@functools.lru_cache(maxsize=None)
def _wide_pair():
    """Two 96x64 streams whose per-stream JAX layouts differ: the first
    has over 255 distinct MV rows (a uint16 palette index), the second
    fewer (uint8)."""
    return [H264BGen(96, 64, seed=21, num_ref_frames=2, mvd_range=64,
                     skip_prob=0.0, max_coefs=16,
                     b_direct_prob=0.2).generate("IPPBPB"),
            H264BGen(96, 64, seed=22, num_ref_frames=2,
                     skip_prob=0.6).generate("IPPBPB")]


@functools.lru_cache(maxsize=None)
def _python(data):
    """(plans, (mb_w, mb_h, pool size)) of the port's Python decoder.
    Cached: no consumer writes to a plan."""
    dec = H264Decoder(dpb_max=1, record_plans=True)
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    assert all(p.coded is None for p in dec.plans)
    return dec.plans, (dec.max_x, dec.max_y, len(dec.frames))


def _stacked(plans):
    return {k: np.stack([getattr(p, k) for p in plans])
            for k in host._PLAN_KEYS}


def _without_map(plan):
    """A native plan as the Python decoder would give it: its tensors,
    the blocks that its coded map leaves unwritten set to 0, no map."""
    out = types.SimpleNamespace(**{k: getattr(plan, k)
                                   for k in host._PLAN_KEYS},
                                n=plan.n, coded=None)
    out.coef_luma, out.coef_chroma = host.coded_coefs(plan)
    return out


def _assert_unpacks_to(packed, stacks):
    """Each stream's blob and palettes unpack (``_unpack_wire``, as the
    batchers unpack them) to that stream's stacked plan tensors."""
    blobs, layout, pals_list, _, _ = packed
    for s, st in enumerate(stacks):
        fields = R._device_views(torch.from_numpy(blobs[s])[None], layout)
        dense = R._unpack_wire(fields, {k: torch.from_numpy(v)[None]
                                        for k, v in pals_list[s].items()})
        for k, want in st.items():
            assert np.array_equal(dense[k][0].numpy(), want), (s, k)


@functools.lru_cache(maxsize=None)
def _expected(data):
    """Each picture of ``data`` in decode order: the JAX package's numpy
    plan interpreter (recon_ref) on the plans of the port's Python
    decoder."""
    plans, (mb_w, mb_h, pool) = _python(data)
    shadow = [Frame(mb_w * 16, mb_h * 16) for _ in range(pool)]
    exp = []
    for plan in plans:
        reconstruct_plan_np(plan, shadow)
        f = shadow[plan.cur_idx]
        exp.append((f.y.copy(), f.cb.copy(), f.cr.copy()))
    return exp


def _check_outs(outs, exps):
    """Each stream's (y, cb, cr) stacks against its expected pictures."""
    for s, (out, exp) in enumerate(zip(outs, exps)):
        assert out[0].shape[0] == len(exp)
        for k, want in enumerate(exp):
            for pl, o, w in zip(("y", "cb", "cr"), out, want):
                assert np.array_equal(o[k].numpy(), w), \
                    f"stream {s} picture {k} {pl}"


@pytest.mark.parametrize("make", [
    lambda: _mixed()[0], lambda: _i8_in_stream_1()[1],
    lambda: _pcm_in_stream_0()[0]], ids=["mixed0", "high", "ipcm"])
def test_derived_map_packs_as_native(make):
    """A native plan without its coded map packs byte for byte as with it:
    the derived map (``derive_coded``) marks a subset of the native
    map's blocks, and the blocks it leaves out hold only zeros."""
    plans, _ = _native(make())
    bare = [_without_map(p) for p in plans]
    for p, b in zip(plans, bare):
        assert not (host.derive_coded(b) & ~p.coded).any()
    (gb,), gl, (gp,), *gf = pack_batches([bare])
    (wb,), wl, (wp,), *wf = pack_batches([plans])
    assert gl == wl and gf == wf and gb.shape == wb.shape
    for path, _, _, off, nb in gl:
        assert np.array_equal(gb[off : off + nb], wb[off : off + nb]), path
    assert sorted(gp) == sorted(wp)
    for k in wp:
        assert np.array_equal(gp[k], wp[k]), k


@pytest.mark.parametrize("streams", [lambda: [_plan_stream()], _wide_pair],
                         ids=["plan", "wide_pair"])
def test_python_plans_pack_to_their_tensors(streams):
    """The Python decoder's plans through the native packer unpack to
    their own tensors. The wide pair at S = 2 gets one layout where the
    JAX package's per-stream packer gives two (it refuses them: "stream
    wire layouts differ")."""
    plans = [_python(d)[0] for d in streams()]
    if len(plans) == 2:
        jax_layouts = [JR._flatten_wire(JR._pack_wire(_stacked(p)))[1]
                       for p in plans]
        assert jax_layouts[0] != jax_layouts[1]
    _assert_unpacks_to(pack_batches(plans), [_stacked(p) for p in plans])


def test_python_plans_or_flags():
    """8x8-transform MBs only in stream 1: has_i8 is on for the batch
    (the JAX fallback takes it from stream 0)."""
    plans = [_python(d)[0] for d in _i8_in_stream_1()]
    assert [pack_batches([p])[3] for p in plans] == [False, True]
    assert pack_batches(plans)[3]


def _synthetic(n_pics, mb_w, mb_h, seed, big_coef=False, mv_rows=None):
    """Plan tensors with random values in the plan's ranges: one
    coefficient outside int16 (big_coef), MVs with mv_rows distinct rows
    (None: 4)."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    st = {k: np.zeros((n_pics,) + s, np.int32) for k, s in (
        ("coef_luma", (n, 256)), ("coef_chroma", (n, 2, 4, 16)),
        ("t8x8", (n,)), ("kind", (n,)), ("i4_modes", (n, 16)),
        ("i4_avail", (n, 16)), ("i8_modes", (n, 4)), ("i8_avail", (n, 4)),
        ("i16_mode", (n,)), ("chroma_mode", (n,)), ("mb_avail", (n,)),
        ("mv", (n, 16, 2, 2)), ("slot", (n, 4, 2)), ("wp", (n, 4, 3, 4)),
        ("deb_str", (n, 2, 4)), ("deb_str4", (n, 2)),
        ("deb_ab", (n, 2, 6, 2)))}
    sparse = rng.random(st["coef_luma"].shape) < 0.05
    st["coef_luma"][sparse] = rng.integers(-300, 300, sparse.sum())
    st["coef_chroma"][..., 0] = rng.integers(-50, 50,
                                             st["coef_chroma"].shape[:-1])
    if big_coef:
        st["coef_luma"][0, 0, 0] = 40000
    pick = (rng.permutation(st["mv"][..., 0, 0].size) % (mv_rows or 4)
            ).reshape(st["mv"].shape[:3])
    st["mv"] = np.stack([pick % 512 - 256, pick // 512, -pick % 97,
                         pick % 13], -1).reshape(st["mv"].shape)
    st["mv"] = st["mv"].astype(np.int32)
    st["wp"][..., 0] = 1
    st["deb_ab"][:] = rng.integers(-16, 30, st["deb_ab"].shape)
    return st


def _plans_of(st):
    """Plan objects without coded maps, one per picture of stacked plan
    tensors."""
    n = st["kind"].shape[1]
    return [types.SimpleNamespace(**{k: np.ascontiguousarray(v[b])
                                     for k, v in st.items()},
                                  n=n, coded=None)
            for b in range(st["kind"].shape[0])]


@pytest.mark.parametrize("case", ["int32", "dense", "one_dense"])
def test_packer_fallbacks(case):
    """Plans without coded maps: a coefficient outside int16 ships its
    field as dense int32; an MV palette over 65,535 rows ships the field
    dense in its wire dtype; at S = 2 a fallback of one stream is every
    stream's ("one_dense": only stream 1 overflows)."""
    if case == "int32":
        sts = [_synthetic(2, 4, 3, 1, big_coef=True)]
        want = {("coef_luma",): ("int32", (2, 12, 256))}
    elif case == "dense":
        sts = [_synthetic(2, 64, 48, 2, mv_rows=70000)]
        want = {("mv",): ("int16", (2, 3072, 16, 2, 2))}
    else:
        sts = [_synthetic(2, 64, 48, 3, mv_rows=50),
               _synthetic(2, 64, 48, 4, mv_rows=70000)]
        want = {("mv",): ("int16", (2, 3072, 16, 2, 2))}
    packed = pack_batches([_plans_of(st) for st in sts])
    got = {lay[0]: (lay[1], lay[2]) for lay in packed[1]}
    for path, v in want.items():
        assert got[path] == v
    _assert_unpacks_to(packed, sts)


def test_batched_python_plans():
    """BatchedPhaseB on the Python decoder's plans, over two batches (the
    pool and slot map carry over), equal to recon_ref."""
    data = _plan_stream()
    plans, geom = _python(data)
    b = R.BatchedPhaseB(*geom, device="cpu")
    outs = [torch.cat(ab) for ab in zip(b.run_async(plans[:3]),
                                         b.run_async(plans[3:]))]
    _check_outs([outs], [_expected(data)])


@pytest.mark.parametrize("streams", [_mixed, _i8_in_stream_1,
                                     _pcm_in_stream_0, _wide_pair,
                                     "native_and_python"])
def test_multistream_python_plans(streams):
    """MultiStreamPhaseB at S = 2 on the Python decoder's plans, each
    picture equal to recon_ref: 8x8-transform MBs only in stream 1,
    IPCM MBs only in stream 0, two layouts that the JAX fallback
    refuses, and a native stream beside a Python one in one batch."""
    if streams == "native_and_python":
        datas = _mixed()
        runs = [_native(datas[0]), _python(datas[1])]
    else:
        datas = streams()
        runs = [_python(d) for d in datas]
    plans = [p for p, _ in runs]
    mb_w, mb_h, _ = runs[0][1]
    pool = max(g[2] for _, g in runs)
    ms = R.MultiStreamPhaseB(2, mb_w, mb_h, pool, device="cpu")
    _check_outs(ms.run(plans), [_expected(d) for d in datas])
