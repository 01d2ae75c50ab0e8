"""The port's H.265 Phase B (m2dec_tpu_torch.codecs.h265) and its
overlapped driver on the CPU, held exactly against the JAX package.

The same numpy inputs go through the JAX package's Phase-B functions
run with ``xp=np`` and their torch counterparts (residual, MC, deblock,
SAO, the intra mode math, the level schedule); whole pictures replayed
through the port's Phase B equal the Python decoder's oracle planes;
``TurboH265Decoder(device="cpu")`` equals the JAX package's serial
decoder (Python pixels). Every comparison is exact. No JAX graph is
compiled, and each stream is decoded once (module-scoped fixtures)."""

import copy
import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (pins torch to one thread)

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402

from m2dec_tpu.codecs.h265 import reconstruct as JR  # noqa: E402
from m2dec_tpu.codecs.h265.headers import H265Decoder  # noqa: E402
from m2dec_tpu_torch.codecs.h265 import reconstruct as R  # noqa: E402
from m2dec_tpu_torch.codecs.h265.headers import (  # noqa: E402
    H265Decoder as PortH265Decoder,
)
from m2dec_tpu_torch.runtime.turbo import TurboH265Decoder  # noqa: E402

def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


class _MultiSliceGen(H265StreamGen):
    def __init__(self, *args, slices_per_pic=2, **kw):
        super().__init__(*args, **kw)
        self.slices_per_pic = slices_per_pic


#: the replay cases: those of tests/test_h265_plan.py that span intra
#: CTB 16, a non-aligned crop, CTB 32 with strong smoothing, transform
#: skip + sign-data hiding, SAO + deblocking, P AMVP, B and AMP, plus
#: row-aligned multi-slice pictures of 2 and 3 segments
STREAMS = {
    "intra_16ctb": lambda: H265StreamGen(64, 48, seed=1).generate(2),
    "intra_nonaligned": lambda: H265StreamGen(52, 36, seed=3).generate(2),
    "angular_ctb32_strong": lambda: H265StreamGen(
        96, 64, seed=22, ctb_log2=5, qp=14, cbf_prob=0.3, modes=ALL_MODES,
        strong_smoothing=1, split_prob=0.3).generate(2),
    "sdh_tskip": lambda: H265StreamGen(
        64, 48, seed=32, qp=14, cbf_prob=0.7, modes=ALL_MODES,
        transform_skip=1, sign_data_hiding=1, split_prob=0.7,
        nxn_prob=0.8).generate(2),
    "sao_deblock": lambda: H265StreamGen(
        64, 48, seed=53, qp=32, cbf_prob=0.5, modes=ALL_MODES, sao=1,
        deblock=1, max_level=1).generate(3),
    "p_amvp": lambda: H265StreamGen(
        64, 48, seed=71, qp=14, cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
        amvp_prob=1.0, skip_prob=0.0).generate("IPPP"),
    "b_filters": lambda: H265StreamGen(
        64, 48, seed=82, qp=32, cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
        deblock=1, sao=1, max_level=1).generate("IPBPB"),
    "amp": lambda: H265StreamGen(
        64, 48, seed=92, qp=14, cbf_prob=0.4, modes=ALL_MODES, tmvp=1,
        part_mode_prob=0.6, amp=1).generate("IPB"),
    "slices2": lambda: _MultiSliceGen(
        64, 96, seed=102, qp=30, cbf_prob=0.5, modes=ALL_MODES, deblock=1,
        sao=1, max_level=1, slices_per_pic=2).generate(3),
    "slices3": lambda: _MultiSliceGen(
        64, 96, seed=203, qp=30, cbf_prob=0.5, modes=ALL_MODES, tmvp=1,
        deblock=1, sao=1, max_level=1, slices_per_pic=3).generate("IPBP"),
}


@pytest.fixture(scope="module")
def decoded():
    """Each stream once through the JAX package's Python decoder and
    the port's copy of it: {name: (data, JAX plans, port plans)}, both
    with oracle planes."""
    out = {}
    for name, make in STREAMS.items():
        data = make()
        plans = []
        for cls in (H265Decoder, PortH265Decoder):
            dec = cls()
            dec.set_data(data)
            dec.decode_all(collect_plans=True, keep_oracle=True)
            plans.append(dec.plans)
        out[name] = (data, *plans)
    return out


_PLAN_FIELDS = ("coef_y", "coef_cb", "coef_cr", "tu_y", "tu_cb", "tu_cr",
                "slot", "mv", "dbv", "dbh", "dbcv", "dbch", "sao_idx",
                "sao_opt", "sao_off", "ops_l", "ops_c")


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_replay_equals_oracle(decoded, name):
    """The port's Python Phase A records the JAX package's plans, and
    its Phase B replays every picture to the oracle planes."""
    _, jplans, plans = decoded[name]
    assert len(plans) == len(jplans) > 0
    for k, (a, b) in enumerate(zip(plans, jplans)):
        for f in _PLAN_FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), \
                f"picture {k} {f}"
        assert (a.multi_slice, a.slice_rows) == (b.multi_slice,
                                                 b.slice_rows)
        for o, w in zip(a.oracle, b.oracle):
            assert np.array_equal(o, w), f"picture {k} oracle"
    if name.startswith("slices"):
        assert any(p.multi_slice and len(p.slice_rows) == int(name[-1])
                   for p in plans)
    outs = R.replay_plans(plans, device="cpu")
    for k, (p, planes) in enumerate(zip(plans, outs)):
        for c, a, b in zip(("y", "cb", "cr"), planes, p.oracle):
            assert np.array_equal(a, b), \
                f"picture {k} {c}: {np.count_nonzero(a != b)} diffs"


# ------------------------------------------------------------ residual --


def _rand_tu(rng, h4, w4, dst_tskip):
    """A random TU meta plane: every variant, DST and transform skip on
    4x4 TUs (dst_tskip), sizes 4-32 at aligned positions."""
    tu = np.zeros((h4, w4), np.int16)
    for y in range(h4):
        for x in range(w4):
            if rng.random() < 0.5:
                continue
            sl = rng.integers(0, 4)
            while sl and (y % (1 << sl) or x % (1 << sl)):
                sl -= 1
            meta = 1 | (sl << 1) | (int(rng.integers(0, 4)) << 3)
            if sl == 0 and dst_tskip:
                meta |= int(rng.integers(0, 2)) << 5
                meta |= int(rng.integers(0, 2)) << 6
            tu[y, x] = meta
    return tu


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_plane_random(seed):
    """Random coefficients over the whole int16 range and random TU
    metas: the float64 products are exact."""
    rng = np.random.default_rng(seed)
    for H, W, sizes, dst in ((64, 96, (4, 8, 16, 32), True),
                             (32, 48, (4, 8, 16), False)):
        coef = rng.integers(-32768, 32768, (H, W)).astype(np.int16)
        tu = _rand_tu(rng, H >> 2, W >> 2, dst)
        want = JR.residual_plane(coef, tu.astype(np.int32), sizes, np, dst)
        got = R.residual_plane(_t(coef), _t(tu), sizes, dst)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["sdh_tskip", "angular_ctb32_strong",
                                  "b_filters"])
def test_residual_plane_plans(decoded, name):
    for p in decoded[name][1]:
        for coef, tu, sizes, dst in (
                (p.coef_y, p.tu_y, (4, 8, 16, 32), True),
                (p.coef_cb, p.tu_cb, (4, 8, 16), False),
                (p.coef_cr, p.tu_cr, (4, 8, 16), False)):
            want = JR.residual_plane(coef, tu.astype(np.int32), sizes, np,
                                     dst)
            got = R.residual_plane(_t(coef), _t(tu),
                                   R._tu_sizes(tu, sizes), dst)
            assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ MC --


def _mc_inputs(seed, H=48, W=64, pool=8, mv_range=200):
    """A random pool and random per-cell slots/MVs: every quarter- and
    eighth-pel phase, MVs far outside the picture, bi- and
    uni-prediction and empty cells."""
    rng = np.random.default_rng(seed)
    py = rng.integers(0, 256, (pool, H, W), dtype=np.uint8)
    pcb = rng.integers(0, 256, (pool, H >> 1, W >> 1), dtype=np.uint8)
    pcr = rng.integers(0, 256, (pool, H >> 1, W >> 1), dtype=np.uint8)
    slot = rng.integers(-1, 4, (H >> 2, W >> 2, 2)).astype(np.int8)
    slot[..., 1][rng.random((H >> 2, W >> 2)) < 0.3] = 7
    mv = rng.integers(-mv_range, mv_range,
                      (H >> 2, W >> 2, 2, 2)).astype(np.int16)
    return slot, mv, py, pcb, pcr


def _assert_inter(slot, mv, py, pcb, pcr, W, H):
    """The port's inter_pass (phase-plane luma path over the used slots)
    against the JAX package's window path (mc_used=None): the cell mask
    exactly, and the predictions exactly on every predicted cell (a
    cell without prediction is masked out by its caller, and the two
    paths read different slots there)."""
    used = sorted({int(v) for v in np.unique(slot) if v >= 0})
    remap = np.zeros(16, np.int32)
    remap[used] = np.arange(len(used))
    want = JR.inter_pass(slot.astype(np.int32), mv.astype(np.int32), py,
                         pcb, pcr, W, H, np)
    got = R.inter_pass(_t(slot), _t(mv), _t(py), _t(pcb), _t(pcr), W, H,
                       torch.as_tensor(used, dtype=torch.int64), _t(remap))
    mask = np.asarray(want[0])
    assert mask.any()
    assert np.array_equal(got[0].numpy(), mask)
    for g, w, k in zip(got[1:], want[1:], (4, 2, 2)):
        m = np.kron(mask, np.ones((k, k), bool))
        assert np.array_equal(g.numpy()[m], np.asarray(w)[m])


@pytest.mark.parametrize("seed,mv_range", [(0, 200), (1, 12), (2, 3000)])
def test_inter_pass_random(seed, mv_range):
    """The port's phase-plane luma path against the JAX package's
    window path (mc_used=None), and the chroma lanes, on random MVs."""
    H, W = 48, 64
    _assert_inter(*_mc_inputs(seed, H, W, mv_range=mv_range), W, H)


def test_chroma_cell_mc_all_phases():
    """Every (fx, fy) eighth-pel phase at positions inside, on and
    beyond each picture edge: the int64 lanes equal the JAX package's
    uint32 lanes (negative intermediates and borrows included)."""
    rng = np.random.default_rng(5)
    pcb = rng.integers(0, 256, (3, 12, 16), dtype=np.uint8)
    pcr = rng.integers(0, 256, (3, 12, 16), dtype=np.uint8)
    fx, fy, px, py_ = np.meshgrid(np.arange(8), np.arange(8),
                                  np.array([-40, -1, 0, 7, 14, 40]),
                                  np.array([-30, 0, 5, 11, 30]),
                                  indexing="ij")
    n = fx.size
    mvx = (px.reshape(-1) * 8 + fx.reshape(-1)).astype(np.int32)
    mvy = (py_.reshape(-1) * 8 + fy.reshape(-1)).astype(np.int32)
    slot = rng.integers(0, 3, n).astype(np.int32)
    cx0 = rng.integers(0, 8, n).astype(np.int32) * 2
    cy0 = rng.integers(0, 6, n).astype(np.int32) * 2
    want = JR._chroma_cell_mc(pcb, pcr, slot, cx0, cy0, mvx, mvy, 16, 12,
                              np)
    got = R._chroma_cell_mc(_t(pcb), _t(pcr), *(torch.as_tensor(
        v, dtype=torch.int64) for v in (slot, cx0, cy0, mvx, mvy)), 16, 12)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", ["p_amvp", "b_filters", "amp"])
def test_inter_pass_plans(decoded, name):
    """The plans' own slots and MVs over the pool of oracle pictures."""
    plans = decoded[name][1]
    H, W = plans[0].H, plans[0].W
    py = np.zeros((8, H, W), np.uint8)
    pcb = np.zeros((8, H >> 1, W >> 1), np.uint8)
    pcr = np.zeros((8, H >> 1, W >> 1), np.uint8)
    for p in plans:
        if p.used_slots():
            _assert_inter(p.slot, p.mv, py, pcb, pcr, p.pic_width,
                          p.pic_height)
        py[p.cur_idx], pcb[p.cur_idx], pcr[p.cur_idx] = p.oracle


# ------------------------------------------------------ deblock and SAO --


@pytest.mark.parametrize("name", ["sao_deblock", "b_filters"])
def test_deblock_frame(decoded, name):
    """The plans' edge maps over natural planes (the oracle pictures)
    and over noise."""
    rng = np.random.default_rng(7)
    for p in decoded[name][1]:
        maps = [m.astype(np.int32) for m in (p.dbv, p.dbh, p.dbcv,
                                             p.dbch)]
        for planes in (p.oracle, [rng.integers(0, 256, a.shape)
                                  for a in p.oracle]):
            planes = [a.astype(np.int32) for a in planes]
            want = JR.deblock_frame(*planes, *maps, np)
            got = R.deblock_frame(*(_t(a) for a in planes),
                                  *(_t(m) for m in maps))
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), w)


def test_deblock_frame_random_maps():
    rng = np.random.default_rng(8)
    H, W = 48, 64
    y = rng.integers(100, 140, (H, W))
    cb = rng.integers(100, 140, (H >> 1, W >> 1))
    cr = rng.integers(0, 256, (H >> 1, W >> 1))
    strength = rng.integers(0, 3, (H >> 2, W >> 3))
    dbv = np.stack([strength, rng.integers(0, 64, strength.shape),
                    rng.integers(0, 25, strength.shape)], -1)
    strength = rng.integers(0, 3, (H >> 3, W >> 2))
    dbh = np.stack([strength, rng.integers(0, 64, strength.shape),
                    rng.integers(0, 25, strength.shape)], -1)
    dbcv = rng.integers(-1, 25, (H >> 2, W >> 4, 2))
    dbch = rng.integers(-1, 25, (H >> 4, W >> 2, 2))
    args = [a.astype(np.int32) for a in (y, cb, cr, dbv, dbh, dbcv, dbch)]
    want = JR.deblock_frame(*args, np)
    got = R.deblock_frame(*(_t(a) for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def _sao_both(plane, idx, opt, off, csl2, pw, ph):
    want = JR.sao_plane(plane, idx, opt, off, csl2, pw, ph, np)
    got = R.sao_plane(_t(plane), _t(idx), _t(opt), _t(off), csl2, pw, ph)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["sao_deblock", "b_filters",
                                  "intra_nonaligned"])
def test_sao_plane_plans(decoded, name):
    for p in decoded[name][1]:
        cl2 = p.size_log2
        for c, plane in enumerate(p.oracle):
            _sao_both(plane, p.sao_idx[:, :, min(c, 1)],
                      p.sao_opt[:, :, c], p.sao_off[:, :, c],
                      cl2 - (c > 0), p.pic_width >> (c > 0),
                      p.pic_height >> (c > 0))


def test_sao_plane_random():
    """Random band/edge parameters per CTU: every edge class and band
    position, offsets of both signs, a picture smaller than its plane."""
    rng = np.random.default_rng(9)
    rows, cols, cl2 = 3, 4, 4
    plane = rng.integers(0, 256, (rows << cl2, cols << cl2))
    idx = rng.integers(0, 3, (rows, cols)).astype(np.int8)
    opt = np.where(idx == 1, rng.integers(0, 32, (rows, cols)),
                   rng.integers(0, 4, (rows, cols))).astype(np.int8)
    off = rng.integers(-7, 8, (rows, cols, 4)).astype(np.int8)
    _sao_both(plane, idx, opt, off, cl2, cols * 16 - 5, rows * 16 - 3)


# --------------------------------------------------------------- intra --


def _rand_lanes(rng, n, S, is_luma, strong):
    """Random intra lanes of one bank: sizes up to S, every mode, valid
    counts from none to past the block's reach, random neighbours."""
    NV = 2 * S + 2
    sl2 = rng.integers(2, S.bit_length(), n)
    if strong:
        sl2[: n // 2] = 5
    mode = rng.integers(0, 35, n)
    two = 2 << sl2
    vx = np.where(rng.random(n) < 0.2, 0, rng.integers(1, two + 3))
    vy = np.where(rng.random(n) < 0.2, 0, rng.integers(1, two + 3))
    if strong:
        vx[: n // 4] = 64
        vy[: n // 4] = 64
    base = rng.integers(0, 256, (n, 1))
    noise = rng.integers(-3, 4, (n, NV + 2)) * rng.integers(0, 2, (n, 1))
    RAWL = np.clip(base + noise, 0, 255)
    RAWT = np.clip(base + rng.integers(-3, 4, (n, NV + 2)), 0, 255)
    RAWT[::3] = rng.integers(0, 256, (len(RAWT[::3]), NV + 2))
    return [a.astype(np.int32) for a in (RAWL, RAWT, sl2, mode, vx, vy)]


@pytest.mark.parametrize("S,is_luma,strong", [(8, True, False),
                                              (32, True, True),
                                              (8, False, False),
                                              (16, False, False)])
def test_intra_core_random(S, is_luma, strong):
    """The mode math of every lane inside its block, and the DC stray
    value, against the JAX package's _intra_core with xp=np."""
    rng = np.random.default_rng(S + is_luma)
    lanes = _rand_lanes(rng, 400, S, is_luma, strong)
    wg, wd = JR._intra_core(*lanes, S, is_luma, strong, JR._ANG_FUSED, np)
    t = [torch.as_tensor(a, dtype=torch.int64) for a in lanes]
    gg, gd = R._intra_core(*t, S, is_luma, strong,
                           torch.as_tensor(R._ANG_FUSED, dtype=torch.int64))
    assert np.array_equal(gd.numpy(), wd)
    size = 1 << lanes[2]
    inb = ((np.arange(S)[None, :, None] < size[:, None, None])
           & (np.arange(S)[None, None, :] < size[:, None, None]))
    assert np.array_equal(np.where(inb, gg.numpy(), 0), np.where(inb, wg, 0))


def test_angular_tables_equal():
    assert np.array_equal(R._ANG_FUSED, JR._ANG_FUSED)
    for s in (2, 3, 4, 5):
        assert np.array_equal(R._TMAT[s], JR._TMAT[s])
    assert np.array_equal(R._DMAT, JR._DMAT)


# ------------------------------------------------------ level schedule --


def _fresh(plan):
    """A copy of a plan without the level cache."""
    p = copy.copy(plan)
    p.__dict__.pop("_levels", None)
    return p


@pytest.mark.parametrize("name", ["angular_ctb32_strong", "sdh_tskip",
                                  "b_filters", "slices3"])
def test_plan_levels_equal(decoded, name):
    for p in decoded[name][1]:
        got = R._plan_levels(_fresh(p))
        want = JR._plan_levels(_fresh(p))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["angular_ctb32_strong", "sao_deblock",
                                  "amp"])
def test_native_scheduler_matches_python(decoded, name):
    """The native oplevel.cpp scheduler against the Python spec, at the
    default caps and with no cap."""
    for p in decoded[name][1]:
        for ops, chg, cwg, stray in (
                (p.ops_l, p.H >> 2, p.W >> 2, True),
                (p.ops_c, p.H >> 3, p.W >> 3, False)):
            flat = np.asarray(ops, np.int32).reshape(-1, 7)
            for caps in ((), (0, 0)):
                nat = R._schedule_levels(flat, chg, cwg, stray, *caps)
                assert np.array_equal(
                    nat, R._schedule_levels_py(flat, chg, cwg, stray,
                                               *caps))


# -------------------------------------------------------------- driver --


def _serial(data):
    dec = H265Decoder()
    dec.set_data(data)
    return dec.decode_all()


def _assert_turbo(data, batch):
    exp = _serial(data)
    t = TurboH265Decoder(data, batch=batch, device="cpu")
    got = t.decode_all()
    assert len(got) == len(exp) > 0
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt, f"frame {k} poc"
        assert g.crop == e.crop
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(g, c), getattr(e, c)), \
                f"frame {k} {c}"
    return t


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_turbo_b_stream(decoded, batch):
    _assert_turbo(decoded["b_filters"][0], batch)


@pytest.mark.parametrize("name", ["intra_nonaligned", "slices3"])
def test_turbo_crop_and_slices(decoded, name):
    _assert_turbo(decoded[name][0], 2)


def test_turbo_mixed_slices_and_truncation(decoded):
    """One-slice and 3-slice pictures in one stream (the stream of
    tests/test_turbo.py's mixed-batch case), then a stream cut
    mid-picture: the driver drains as the serial decoder does."""
    kw = dict(qp=31, cbf_prob=0.4, modes=ALL_MODES, tmvp=1, deblock=1,
              sao=1, max_level=1)
    one = H265StreamGen(64, 96, seed=77, **kw).generate("IPP")
    two = _MultiSliceGen(64, 96, seed=78, slices_per_pic=3,
                         **kw).generate("IPB")
    _assert_turbo(one + two, 4)
    cut = decoded["intra_16ctb"][0]
    cut = cut[: len(cut) - len(cut) // 4]
    assert _assert_turbo(cut, 2).error < 0


@pytest.mark.parametrize("backend", ["torch", "native"])
@pytest.mark.parametrize("name", ["b_filters", "slices2"])
def test_decoder_backends(decoded, name, backend):
    """The port's serial decoder with its Phase B on torch: the Python
    Phase A (backend="torch"; multi-slice pictures keep their Python
    pixels) or the native one, each picture reconstructed as it
    completes, frames equal to the JAX package's serial decoder."""
    data = decoded[name][0]
    dec = PortH265Decoder(device="cpu")
    dec.set_data(data)
    got = dec.decode_all(backend=backend)
    exp = _serial(data)
    assert len(got) == len(exp) > 0
    for k, (g, e) in enumerate(zip(got, exp)):
        assert g.cnt == e.cnt
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(g, c), getattr(e, c)), \
                f"frame {k} {c}"


def test_turbo_default_device_is_cuda(monkeypatch):
    """With no device argument the driver takes the CUDA device, and
    raises where there is none: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TurboH265Decoder(b"")
