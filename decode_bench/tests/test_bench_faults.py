"""The whole run on the CPU, its look for a CUDA device skipped, with
the program's timed path broken underneath: each fault a cell can have
turns ``correct`` false. (One chip: no exchange between chips to
leave out.)"""

import time

import pytest
import torch

from decode_bench import harness
from m2dec_tpu_torch.codecs.h264 import reconstruct as R264
from m2dec_tpu_torch.codecs.h265 import reconstruct as R265

from ._small import cell


def _unchanged_h264(orig):
    # a picture step that leaves the pool as it was: returns slot 0
    def f(P, refs_y, refs_cb, refs_cr, *a, **k):
        return refs_y[:, 0].clone(), refs_cb[:, 0].clone(), \
            refs_cr[:, 0].clone()
    return f


def _unchanged_h265(orig):
    def f(x, m, pool_y, pool_cb, pool_cr, wf):
        return (pool_y[m.cur_idx].clone(), pool_cb[m.cur_idx].clone(),
                pool_cr[m.cur_idx].clone())
    return f


def _altered(orig):
    # one sample of the first picture of a batch changed where stored
    def f(self, b, cur, planes, outs):
        if b == 0:
            planes = (planes[0].clone(),) + tuple(planes[1:])
            planes[0].view(-1)[7] ^= 1
        return orig(self, b, cur, planes, outs)
    return f


def _half_left_out(orig):
    # only the first half of a batch's pictures reconstructed and stored
    def f(self, b, cur, planes, outs):
        if b < outs[0].shape[0] // 2:
            return orig(self, b, cur, planes, outs)
        for o in outs:
            o[b] = 0
    return f


FAULTS = {
    "h264": {"unchanged": (R264, "_recon_core", _unchanged_h264),
             "altered": (R264.MultiStreamPhaseB, "_store", _altered),
             "half_left_out": (R264.MultiStreamPhaseB, "_store",
                               _half_left_out)},
    "h265": {"unchanged": (R265, "_recon_picture", _unchanged_h265),
             "altered": (R265.H265SeqPhaseB, "_store", _altered),
             "half_left_out": (R265.H265SeqPhaseB, "_store",
                               _half_left_out)},
}
CELLS = {"h264": ("h264-main-1080p", 2), "h265": ("h265-main-1080p", 1)}


def _run(codec, **traffic):
    name, streams = CELLS[codec]
    c = cell(name, streams)
    c.traffic.update(traffic)
    return harness.run_cell(c, 31, 0.05, False, torch.device("cpu"),
                            time.perf_counter(), log=lambda *a, **k: None)


@pytest.mark.parametrize("codec", sorted(CELLS))
@pytest.mark.parametrize("per_call", [None, 2])
def test_sound_run_is_correct(codec, per_call):
    r = _run(codec, **({} if per_call is None else
                       {"pictures_per_call": per_call}))
    assert r["correct"] and r["checks"]["mismatched_pictures"]["value"] == 0
    assert r["checks"]["unchecked_pictures"]["value"] == 0
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("codec,fault", [(c, f) for c in sorted(FAULTS)
                                         for f in sorted(FAULTS[c])])
def test_fault_is_caught(codec, fault, monkeypatch):
    obj, attr, make = FAULTS[codec][fault]
    monkeypatch.setattr(obj, attr, make(getattr(obj, attr)))
    r = _run(codec)
    assert not r["correct"]
    assert r["checks"]["mismatched_pictures"]["value"] > 0
