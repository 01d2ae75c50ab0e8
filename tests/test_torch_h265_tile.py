"""The port's H.265 CTU-tile intra wavefront on the CPU, held exactly
against the JAX package: the host z-slot tables (``_zslot_table``,
``_tile_lanes_band``, ``_pack_zslots``, ``_plan_zslots``) equal to the
JAX package's numpy functions on recorded plans, ``wf_mode_for`` equal
to the JAX package's rule, whole pictures replayed through the port's
Phase B on the tile schedule (its plain version here) and on the level
schedule equal to the Python decoder's oracle planes (the frames the
JAX package's tile path is held to in tests/test_h265_tile.py), and
``TurboH265Decoder(device="cpu")`` taking the tile schedule by default
at CTB 16 and the level schedule at CTB 32, with the JAX package's
serial frames, and the chain of ops the kernel's time follows
(``op_chain``) against a walk of the dependency. Every comparison is
exact; no JAX graph is compiled.
The kernel itself is held to the plain version on the card in
tests/test_torch_kernels_cuda.py."""

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
from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK  # noqa: E402
from m2dec_tpu_torch.runtime.turbo import TurboH265Decoder  # noqa: E402


def _slices3():
    gen = H265StreamGen(64, 96, seed=203, qp=30, cbf_prob=0.5,
                        modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                        max_level=1)
    gen.slices_per_pic = 3
    return gen.generate("IPBP")


#: the CTB-16 IPB stream of tests/test_h265_tile.py (KW4), its CTB-32
#: strong-smoothing stream, the 3-slice stream of chip_smoke.py and the
#: transform-skip + sign-data-hiding stream
STREAMS = {
    "ctb16_ipb": lambda: H265StreamGen(
        96, 64, seed=7, qp=30, cbf_prob=0.5, modes=ALL_MODES, deblock=1,
        sao=1, max_level=1).generate("IPB"),
    "ctb32_strong": lambda: H265StreamGen(
        96, 64, seed=22, ctb_log2=5, qp=14, cbf_prob=0.3, modes=ALL_MODES,
        strong_smoothing=1, split_prob=0.3).generate(2),
    "slices3": _slices3,
    "tskip_sdh": lambda: H265StreamGen(
        64, 48, seed=32, qp=14, cbf_prob=0.7, modes=ALL_MODES,
        transform_skip=1, sign_data_hiding=1, split_prob=0.7,
        nxn_prob=0.8).generate(2),
}
#: the streams the z-slot tables are compared on
TABLE_STREAMS = ("ctb16_ipb", "ctb32_strong", "slices3")


@pytest.fixture(scope="module")
def decoded():
    """Each stream once through the JAX package's Python decoder, with
    its oracle planes: {name: (data, plans, output frames)}."""
    out = {}
    for name, make in STREAMS.items():
        data = make()
        dec = H265Decoder()
        dec.set_data(data)
        frames = dec.decode_all(collect_plans=True, keep_oracle=True)
        assert dec.plans
        out[name] = (data, dec.plans, frames)
    return out


def _fresh(plans):
    """Shallow copies of recorded plans without the schedules that both
    packages cache on a plan (``_zslots``, ``_levels``)."""
    out = []
    for p in plans:
        q = copy.copy(p)
        q.__dict__.pop("_zslots", None)
        q.__dict__.pop("_levels", None)
        out.append(q)
    return out


@pytest.fixture
def tile_calls(monkeypatch):
    """Counts the calls of the tile wavefront (kernel or plain version)."""
    calls = []
    real = TK.tile_wavefront

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(TK, "tile_wavefront", spy)
    return calls


# ------------------------------------------------------- host tables --


@pytest.mark.parametrize("cb_log2", [3, 4, 5])
def test_zslot_table_equal(cb_log2):
    assert R._zslot_table(cb_log2) == JR._zslot_table(cb_log2)


def test_tile_lanes_band_equal(decoded):
    geoms = {(p.columns, p.rows) for _, plans, _ in decoded.values()
             for p in plans} | {(120, 68), (1, 1), (1, 5), (7, 1)}
    for cols, rows in sorted(geoms):
        assert np.array_equal(R._tile_lanes_band(cols, rows),
                              JR._tile_lanes_band(cols, rows)), (cols, rows)


@pytest.mark.parametrize("name", TABLE_STREAMS)
def test_zslot_words_equal(decoded, name):
    """_pack_zslots of every picture's luma and chroma ops, and
    _plan_zslots (the per-diagonal words and op flags)."""
    _, plans, _ = decoded[name]
    for k, (p, q) in enumerate(zip(_fresh(plans), _fresh(plans))):
        cl2 = p.size_log2
        for ops, n, cb in ((p.ops_l, 1 << (2 * (cl2 - 2)), cl2),
                           (p.ops_c, 1 << (2 * (cl2 - 3)), cl2 - 1)):
            for a, b in zip(R._pack_zslots(ops, n, cb),
                            JR._pack_zslots(ops, n, cb)):
                assert np.array_equal(a, b), f"picture {k}"
        mine, ref = R._plan_zslots(p), JR._plan_zslots(q)
        assert len(mine) == len(ref) == 3
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"picture {k}"
        assert (mine[0] & 1).any(), "no luma op: the stream tests nothing"


@pytest.mark.parametrize("ctb_log2", [3, 4, 5, 6])
def test_wf_mode_for_equal(monkeypatch, ctb_log2):
    monkeypatch.delenv("M2DEC_TPU_H265_WF", raising=False)
    assert R.wf_mode_for(ctb_log2) == JR.wf_mode_for(ctb_log2)


def test_wf_mode_checked():
    with pytest.raises(ValueError):
        R.H265SeqPhaseB(64, 64, 2, device="cpu", wf_mode="diagonal")


#: edits of a P picture's plan that change what its step runs (a new
#: CUDA graph key) and edits of values alone (the same key)
NEW_KEY = {
    "no_mc": lambda p: {"slot": np.full_like(p.slot, -1)},
    "one_more_slot": lambda p: {"slot": _one_more_slot(p.slot)},
    "tu_sizes": lambda p: {"tu_y": p.tu_y & ~1},
    "no_deblock": lambda p: {"dbv": np.zeros_like(p.dbv),
                             "dbh": np.zeros_like(p.dbh),
                             "dbcv": np.full_like(p.dbcv, -1),
                             "dbch": np.full_like(p.dbch, -1)},
    "no_sao": lambda p: {"has_sao": False},
    "strong": lambda p: {"strong_intra": not p.strong_intra},
}
SAME_KEY = {
    "cur_idx": lambda p: {"cur_idx": (p.cur_idx + 1) % 8},
    "mv": lambda p: {"mv": p.mv + 4},
    "coef": lambda p: {"coef_y": p.coef_y ^ 1, "coef_cb": p.coef_cb + 2},
}


def _one_more_slot(slot):
    used = set(np.unique(slot).tolist())
    out = slot.copy()
    out[0, 0, 0] = min(set(range(8)) - used)
    return out


@pytest.mark.parametrize("edit", sorted(NEW_KEY) + sorted(SAME_KEY))
def test_graph_key(decoded, edit):
    """The key of a picture step's CUDA graph (``_graph_key``), on the
    host: an edit of what fixes the step's ops or shapes (MC, the number
    of used slots, the TU sizes, deblocking, SAO, strong smoothing) gives
    another key; an edit of values alone keeps the key."""
    plans = decoded["ctb16_ipb"][1]
    i, p = (R._PicMeta(q) for q in plans[:2])
    assert not i.has_mc and p.has_mc and p.deblock and p.has_sao
    assert R._graph_key(i) != R._graph_key(p)
    q = copy.copy(plans[1])
    for k, v in {**NEW_KEY, **SAME_KEY}[edit](plans[1]).items():
        setattr(q, k, v)
    assert (R._graph_key(R._PicMeta(q)) != R._graph_key(p)) == \
        (edit in NEW_KEY)


def _longest_path(counts):
    """The most ops on any path of the tile dependency (CTU (cy, cx) after
    (cy, cx - 1) and (cy - 1, min(cx + 1, cols - 1))), by a memoised walk
    over each CTU's predecessors."""
    rows, cols = counts.shape
    memo = {}

    def ending_at(cy, cx):
        if (cy, cx) not in memo:
            before = [ending_at(cy, cx - 1)] if cx else []
            if cy:
                before.append(ending_at(cy - 1, min(cx + 1, cols - 1)))
            memo[cy, cx] = int(counts[cy, cx]) + max(before, default=0)
        return memo[cy, cx]

    return max(ending_at(cy, cx) for cy in range(rows) for cx in range(cols))


@pytest.mark.parametrize("rows,cols,seed", [(2, 3, -1), (5, 7, 1),
                                            (1, 6, 2), (6, 1, 3)])
def test_op_chain(rows, cols, seed):
    """wavefront_kernels.op_chain (the chain of ops chip_smoke.py and the
    split probe report) against a walk of the dependency, on words with
    counted ops; (2, 3) by hand: 1 + 2 + 4 + 5 + 6 = 18."""
    if seed < 0:
        counts = np.arange(1, 7).reshape(2, 3)
    else:
        counts = np.random.default_rng(seed).integers(0, 9, (rows, cols))
    n_slots = 16
    words = np.zeros((rows * cols, n_slots), np.int32)
    for i, n in enumerate(counts.reshape(-1)):
        words[i, np.random.default_rng(i).permutation(n_slots)[:n]] = 0x31
    words[0, -1] |= 0x30  # no used bit: not an op
    want = 18 if seed < 0 else _longest_path(counts)
    assert TK.op_chain(words, cols, rows) == want
    assert TK.op_chain(torch.from_numpy(words), cols, rows) == want


# ----------------------------------------------------- whole pictures --


@pytest.mark.parametrize("mode", ["tile", "level"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_replay_equals_oracle(decoded, tile_calls, name, mode):
    """Every picture of the stream replayed on the schedule ``mode``
    equals the Python decoder's oracle planes (so the two schedules
    agree); the tile wavefront runs once per picture in tile mode and
    never in level mode, and each mode builds only its own schedule."""
    _, plans, _ = decoded[name]
    plans = _fresh(plans)
    outs = R.replay_plans(plans, device="cpu", wf_mode=mode)
    assert len(outs) == len(plans)
    for k, (p, planes) in enumerate(zip(plans, outs)):
        for c, a, b in zip(("y", "cb", "cr"), planes, p.oracle):
            assert np.array_equal(a, b), \
                f"picture {k} {c}: {np.count_nonzero(a != b)} diffs"
    assert len(tile_calls) == (len(plans) if mode == "tile" else 0)
    other = "_levels" if mode == "tile" else "_zslots"
    assert not any(other in p.__dict__ for p in plans)


@pytest.mark.parametrize("name,forced,mode", [
    ("ctb16_ipb", None, "tile"), ("ctb32_strong", None, "level"),
    ("slices3", None, "tile"), ("ctb32_strong", "tile", "tile")])
def test_turbo_default_schedule(decoded, tile_calls, name, forced, mode):
    """TurboH265Decoder(device="cpu") with no schedule given: tile at CTB
    16 (one tile wavefront per picture), level at CTB 32, where tile can
    be forced; its frames equal the JAX package's serial decoder's."""
    data, plans, exp = decoded[name]
    got = TurboH265Decoder(data, batch=2, device="cpu",
                           wf_mode=forced).decode_all()
    assert len(got) == len(exp) > 0
    for k, (g, e) in enumerate(zip(got, exp)):
        assert (g.cnt, g.crop) == (e.cnt, e.crop), f"frame {k}"
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(g, c), getattr(e, c)), \
                f"frame {k} {c}"
    assert len(tile_calls) == (len(plans) if mode == "tile" else 0)
