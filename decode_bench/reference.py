"""The plain reference: every picture of a stream decoded by the frozen
pure-Python decoders of ``decode_bench/ref``, reduced to the digests of
``digest.py``, in coding order.

The reference reads only the stream's bytes. It imports numpy and the
frozen decoders, nothing of the program and no JAX. A GOP takes some
minutes on one core at 1080p, so the GOPs of a seed decode in parallel
processes, an H.264 GOP in several parts (``_h264_parts``), and their
digests are cached by seed beside the streams.

``control``: the reference with one guarantee of the configuration
broken (``CONTROLS``), the shortcut a faster decoder might take; the
benchmark's runs never use it, only its tests and the control runs.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from decode_bench import cache, digest

#: codec -> control name -> (module, function) made a no-op
CONTROLS = {
    "h264": {"no_deblock": ("decode_bench.ref.h264.deblock",
                            "deblock_picture")},
    "h265": {"no_sao": ("decode_bench.ref.h265.sao", "sao_oneframe")},
}


@contextlib.contextmanager
def _patched(obj, attr, make):
    """obj.attr replaced by make(obj.attr) while the block runs."""
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _pictures_h265(data, stats):
    from decode_bench.ref.h265 import intra
    from decode_bench.ref.h265.headers import H265Decoder

    def counting(predict):
        def counted(plane, y0, x0, size_log2, *args, **kwargs):
            stats[0] += 1 << (2 * size_log2)
            stats[1] += 1
            return predict(plane, y0, x0, size_log2, *args, **kwargs)
        return counted

    with _patched(intra, "predict", counting):
        dec = H265Decoder()
        dec.set_data(data)
        dec.begin_decode()
        while dec.decode_picture() == 1:  # one slice: one picture
            f = dec.pool[dec._cur]
            yield f["y"], f["cb"], f["cr"]


def _pictures_h264(data, stats):
    from decode_bench.ref.h264 import decoder as D

    def counting(dispatch):
        def counted(self, r, mbtype, avail):
            # intra-predicted macroblocks (I_NxN and I_16x16, not I_PCM)
            stats[0] += mbtype < D.MB_IPCM
            return dispatch(self, r, mbtype, avail)
        return counted

    with _patched(D.H264Decoder, "_mb_dispatch", counting):
        dec = D.H264Decoder()
        dec.set_data(data)
        while dec.decode_picture() == 1:
            f = dec.frames[dec.cur_idx]
            yield f.y, f.cb, f.cr


#: codec -> (pictures of a stream, the names of the counts it keeps of
#: each picture for the roofline readers)
_PICTURES = {"h264": (_pictures_h264, ("intra_mbs",)),
             "h265": (_pictures_h265, ("intra_samples", "intra_blocks"))}
STATS = {codec: names for codec, (_, names) in _PICTURES.items()}


def decode(codec: str, data: bytes, control: str | None = None):
    """Every picture of the stream in coding order: [((y, cb, cr) uint8
    copies, [the picture's counts, as STATS names them])]."""
    pictures, names = _PICTURES[codec]
    out, stats = [], [0] * len(names)
    with contextlib.ExitStack() as stack:
        if control is not None:
            mod, fn = CONTROLS[codec][control]
            stack.enter_context(_patched(importlib.import_module(mod), fn,
                                         lambda orig: lambda *a, **k: None))
        for pic in pictures(data, stats):
            out.append((tuple(p.copy() for p in pic), list(stats)))
            stats[:] = [0] * len(names)
    return out


def gop_digests(codec: str, data: bytes,
                control: str | None = None) -> np.ndarray:
    """int64 [pictures, 3 + len(STATS[codec])]: each coding-order
    picture's plane digests, then its counts."""
    return np.array([digest.picture_digests_np(*pic) + tuple(st)
                     for pic, st in decode(codec, data, control)],
                    np.int64).reshape(-1, 3 + len(STATS[codec]))


def _h264_units(data: bytes):
    """The Annex B stream as units, each from one start code to the
    next: [(the coding-order index of the picture whose slice it is, or
    None for a parameter set or another non-slice unit; its
    nal_ref_idc; its bytes)]. A picture starts at a slice (NAL type 1 or
    5) whose first_mb_in_slice is 0: the first bit of its payload."""
    starts, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\x00\x00\x01", i + 3)
    units, pic = [], -1
    for a, b in zip(starts, starts[1:] + [len(data)]):
        hdr = data[a + 3]
        if hdr & 31 in (1, 5):
            pic += data[a + 4] >> 7
            units.append((pic, (hdr >> 5) & 3, data[a:b]))
        else:
            units.append((None, 0, data[a:b]))
    return units


def _h264_parts(data: bytes, parts: int) -> list:
    """The stream cut into at most ``parts`` decodes that run side by
    side: [(bytes, the coding-order indices of the pictures it decodes,
    of those it keeps)]. The first decodes and keeps the reference
    pictures. Each other keeps a run of non-reference pictures and
    decodes the reference pictures before them too. A non-reference
    picture changes nothing that a later picture reads, so each picture
    decodes as in the whole stream. A run grows while its decode holds
    no more pictures than the first."""
    units = _h264_units(data)
    ref = {}
    for pic, nri, _ in units:
        if pic is not None:
            ref[pic] = ref.get(pic, False) or nri > 0
    refs = [i for i in sorted(ref) if ref[i]]
    runs = []
    for i in (i for i in sorted(ref) if not ref[i]):
        if runs and sum(j < i for j in refs) + len(runs[-1]) < len(refs):
            runs[-1].append(i)
        else:
            runs.append([i])
    while len(runs) > parts - 1 and len(runs) > 1:
        runs[-2:] = [runs[-2] + runs[-1]]
    if parts < 2 or not runs:
        return [(data, sorted(ref), sorted(ref))]
    out = []
    for keep in [refs] + runs:
        dec = [i for i in sorted(ref) if i <= keep[-1]
               and (ref[i] or i in keep)]
        out.append((b"".join(u for pic, _, u in units
                             if pic is None or pic in dec), dec, keep))
    return out


def _task(args):
    """(codec, bytes, the coding-order indices of the pictures it
    decodes and of those it keeps (None: all), control) -> the rows of
    ``gop_digests`` of the kept pictures."""
    codec, data, dec, keep, control = args
    rows = gop_digests(codec, data, control)
    if dec is None:  # the whole stream
        return rows
    if len(rows) != len(dec):
        raise RuntimeError(f"{len(rows)} pictures decoded, {len(dec)} "
                           f"expected")
    return rows[[dec.index(i) for i in keep]]


def make(config: dict, seed: int, datas: list,
         control: str | None = None) -> list:
    """Per distinct GOP of the seed its digests and counts (see
    ``gop_digests``): from the cache, or decoded in processes side by
    side (an H.264 GOP in parts, ``_h264_parts``) and then cached (a
    control's digests are never cached)."""
    tag = "" if control is None else f"_{control}"
    paths = [cache.path(config, f"s{seed}_g{g}{tag}.ref.npy")
             for g in range(len(datas))]
    out = [np.load(p) if control is None and p.is_file() else None
           for p in paths]
    missing = [g for g, d in enumerate(out) if d is None]
    if not missing:
        return out
    cores = os.cpu_count() or 1
    tasks = []
    for g in missing:
        if config["codec"] == "h264":
            parts = _h264_parts(datas[g], cores // len(missing))
        else:
            parts = [(datas[g], None, None)]
        tasks += [(g, (config["codec"], b, dec, keep, control))
                  for b, dec, keep in parts]
    with ProcessPoolExecutor(
            min(len(tasks), cores),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        got = list(ex.map(_task, [t for _, t in tasks]))
    for g in missing:
        mine = [(t[3], rows) for (h, t), rows in zip(tasks, got) if h == g]
        if mine[0][0] is None:
            d = mine[0][1]
        else:
            d = np.zeros((sum(len(k) for k, _ in mine), got[0].shape[1]),
                         np.int64)
            for keep, rows in mine:
                d[keep] = rows
        out[g] = d
        if control is None:
            buf = io.BytesIO()
            np.save(buf, d)
            cache.write_bytes(paths[g], buf.getvalue())
    return out
