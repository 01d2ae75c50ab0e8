"""Native (C++) batch wire packer glue.

Replaces the host-side ``np.stack`` + ``_pack_wire`` + ``_flatten_wire``
pipeline (reconstruct.py) with two C calls per picture batch
(h264pack_measure / h264pack_fill in native/h264parse.cpp).  Produces a
byte-layout-compatible transport blob: the layout tuple returned here
plugs straight into ``_jitted_recon_blob`` (single- and multi-stream).

Multi-stream batches are packed with ONE common layout (caps, palette
sizes, and dtype fallbacks are maxima over all streams) so a single
vmapped graph consumes every stream; palettes are per-stream (stacked
by the caller).
"""

from __future__ import annotations

import ctypes

import numpy as np

from m2dec_tpu_torch.native import load_h264
from m2dec_tpu_torch.runtime import trace

from .plan_host import derive_coded

_VOIDP = ctypes.c_void_p

#: per-picture plan fields in the order h264pack_* consumes them
_FIELDS = ("coef_luma", "coef_chroma", "t8x8", "kind", "i4_modes",
           "i4_avail", "i8_modes", "i8_avail", "i16_mode", "chroma_mode",
           "mb_avail", "mv", "slot", "wp", "deb_str", "deb_str4", "deb_ab")


def _next_pow2(v):
    r = 1
    while r < v:
        r *= 2
    return r


_PACK_POOL = None
_PACK_POOL_LOCK = __import__("threading").Lock()


def _pack_pool():
    """Persistent pack worker pool (per-stream measure/fill release the
    GIL; a persistent pool keeps its arenas' pages warm: first touch of
    fresh pages is slow on some hosts).
    Creation is locked: two racing callers must not leak an executor."""
    global _PACK_POOL
    with _PACK_POOL_LOCK:
        if _PACK_POOL is None:
            import os
            from concurrent.futures import ThreadPoolExecutor

            _PACK_POOL = ThreadPoolExecutor(
                max_workers=max(2, os.cpu_count() or 2))
        return _PACK_POOL


class _StreamCtx:
    """One PackCtx per stream: measure state must survive until fill."""

    def __init__(self, lib):
        self.lib = lib
        self.pk = lib.h264pack_new()
        self.meta = np.zeros(16, np.int64)
        self.ptrs = None
        self.keep = None

    def __del__(self):
        if getattr(self, "pk", None):
            self.lib.h264pack_free(self.pk)
            self.pk = None

    def measure(self, plans, n):
        with trace.span("pack.measure"):
            B = len(plans)
            ptr_list = []
            coded = [p.coded if p.coded is not None else derive_coded(p)
                     for p in plans]
            for p, c in zip(plans, coded):
                for f in _FIELDS:
                    ptr_list.append(getattr(p, f).ctypes.data)
                ptr_list.append(c.ctypes.data)
            self.keep = plans, coded
            self.ptrs = (_VOIDP * len(ptr_list))(*ptr_list)
            self.lib.h264pack_measure(
                self.pk, self.ptrs, B, n,
                self.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return self.meta


def _common_dims(metas):
    """Combine per-stream measure metas into one layout decision."""
    m = np.stack(metas)
    cl_maxcnt = int(m[:, 0].max())
    cl_min, cl_max = int(m[:, 1].min()), int(m[:, 2].max())
    cc_maxcnt = int(m[:, 3].max())
    cc_min, cc_max = int(m[:, 4].min()), int(m[:, 5].max())

    def pal_mode(rows_col, vmin, vmax, check16):
        if check16 and not (-32768 <= vmin and vmax <= 32767):
            return 3, 0  # dense int32
        if (m[:, rows_col] < 0).any():
            return 2, 0  # dense narrowed
        rows = int(m[:, rows_col].max())
        pad = max(8, _next_pow2(rows))
        return (0 if pad <= 256 else 1), pad

    mv_mode, mv_pad = pal_mode(6, int(m[:, 7].min()), int(m[:, 8].max()),
                               True)
    wp_mode, wp_pad = pal_mode(9, int(m[:, 10].min()), int(m[:, 11].max()),
                               True)
    ab_mode, ab_pad = pal_mode(12, 0, 0, False)
    cl_dense = not (-32768 <= cl_min and cl_max <= 32767)
    cc_dense = not (-32768 <= cc_min and cc_max <= 32767)
    cl_cap = 1 << max(9, cl_maxcnt.bit_length())
    cc_cap = 1 << max(9, cc_maxcnt.bit_length())
    has_i8 = bool(m[:, 13].any())
    deblock = bool(m[:, 14].any())
    return dict(cl_cap=cl_cap, cl_dense=cl_dense, cc_cap=cc_cap,
                cc_dense=cc_dense, mv_mode=mv_mode, mv_pad=mv_pad,
                wp_mode=wp_mode, wp_pad=wp_pad, ab_mode=ab_mode,
                ab_pad=ab_pad, has_i8=has_i8, deblock=deblock)


def _build_layout(B, n, d):
    """Leaf list in _flatten_wire's canonical order with its 8-byte
    alignment rule; returns (layout tuple, total bytes, leaf offsets)."""
    idx_dt = {0: "uint8", 1: "uint16"}
    leaves = [(("chroma_mode",), "int8", (B, n))]
    if d["cc_dense"]:
        leaves.append((("coef_chroma",), "int32", (B, n, 2, 4, 16)))
        leaves.append(None)
    else:
        leaves.append((("coef_chroma", "bits"), "uint8", (B, n * 16)))
        leaves.append((("coef_chroma", "vals"), "int16", (B, d["cc_cap"])))
    if d["cl_dense"]:
        leaves.append((("coef_luma",), "int32", (B, n, 256)))
        leaves.append(None)
    else:
        leaves.append((("coef_luma", "bits"), "uint8", (B, n * 32)))
        leaves.append((("coef_luma", "vals"), "int16", (B, d["cl_cap"])))
    if d["ab_mode"] <= 1:
        leaves.append((("deb_ab", "idx"), idx_dt[d["ab_mode"]], (B, n)))
    else:
        leaves.append((("deb_ab",), "int8", (B, n, 2, 6, 2)))
    leaves += [
        (("deb_str",), "uint8", (B, n, 2, 4)),
        (("deb_str4",), "int8", (B, n, 2)),
        (("i16_mode",), "int8", (B, n)),
        (("i4_avail",), "int8", (B, n, 16)),
        (("i4_modes",), "int8", (B, n, 16)),
        (("i8_avail",), "int8", (B, n, 4)),
        (("i8_modes",), "int8", (B, n, 4)),
        (("kind",), "int8", (B, n)),
        (("mb_avail",), "int8", (B, n)),
    ]
    if d["mv_mode"] <= 1:
        leaves.append((("mv", "idx"), idx_dt[d["mv_mode"]], (B, n, 16)))
    elif d["mv_mode"] == 2:
        leaves.append((("mv",), "int16", (B, n, 16, 2, 2)))
    else:
        leaves.append((("mv",), "int32", (B, n, 16, 2, 2)))
    leaves += [
        (("slot",), "int8", (B, n, 4, 2)),
        (("t8x8",), "int8", (B, n)),
    ]
    if d["wp_mode"] <= 1:
        leaves.append((("wp", "idx"), idx_dt[d["wp_mode"]], (B, n, 4)))
    elif d["wp_mode"] == 2:
        leaves.append((("wp",), "int16", (B, n, 4, 3, 4)))
    else:
        leaves.append((("wp",), "int32", (B, n, 4, 3, 4)))
    layout = []
    offsets = []  # per C++ leaf slot (19 entries incl. the None holes)
    total = 0
    for leaf in leaves:
        if leaf is None:
            offsets.append(0)
            continue
        path, dtname, shape = leaf
        nb = int(np.prod(shape)) * np.dtype(dtname).itemsize
        layout.append((path, dtname, shape, total, nb))
        offsets.append(total)
        total += (nb + 7) & ~7
    return tuple(layout), total, offsets


def pack_batches(plans_per_stream):
    """Pack N streams' equal-length plan batches.

    Returns (blobs, layout, pals_list, has_i8, deblock) with one blob +
    one pals dict per stream under a single common layout, or None when
    the lists differ in length. Plans of any Phase A: a plan without a
    coded map (the Python decoder's) gets one from its nonzero blocks
    (``plan_host.derive_coded``), and the two kinds mix in a batch.
    PCM macroblocks are fine: their coefficients carry no
    coded-map bits (pack as zeros, masked by the kind==4 pixel
    substitution) and their samples ride the pcm side-channel next to
    the blob (reconstruct._pcm_rows)."""
    lib = load_h264()
    n = plans_per_stream[0][0].n
    B = len(plans_per_stream[0])
    for plans in plans_per_stream:
        if len(plans) != B:
            return None
    ctxs = [_StreamCtx(lib) for _ in plans_per_stream]
    # measure each stream concurrently (the C call releases the GIL)
    if len(ctxs) > 1:
        metas = list(_pack_pool().map(
            lambda a: a[0].measure(a[1], n).copy(),
            zip(ctxs, plans_per_stream)))
    else:
        metas = [ctxs[0].measure(plans_per_stream[0], n).copy()]
    d = _common_dims(metas)
    layout, total, offsets = _build_layout(B, n, d)
    job = np.array([d["cl_cap"], int(d["cl_dense"]), d["cc_cap"],
                    int(d["cc_dense"]), d["mv_mode"], d["wp_mode"],
                    d["ab_mode"], d["mv_pad"], d["wp_pad"], d["ab_pad"],
                    0, 0], np.int64)
    def fill_one(sc):
        with trace.span("pack.fill"):
            blob = np.empty(total, np.uint8)
            base = blob.ctypes.data
            leaf_ptrs = (_VOIDP * len(offsets))(
                *[base + off for off in offsets])
            pals = {}
            mv_pal = wp_pal = ab_pal = None
            if d["mv_mode"] <= 1:
                mv_pal = np.empty((d["mv_pad"], 4), np.int16)
                pals["mv"] = mv_pal
            if d["wp_mode"] <= 1:
                wp_pal = np.empty((d["wp_pad"], 12), np.int16)
                pals["wp"] = wp_pal
            if d["ab_mode"] <= 1:
                ab_pal = np.empty((d["ab_pad"], 24), np.int8)
                pals["deb_ab"] = ab_pal
            lib.h264pack_fill(
                sc.pk, sc.ptrs, B, n, leaf_ptrs,
                job.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                None if mv_pal is None else mv_pal.ctypes.data,
                None if wp_pal is None else wp_pal.ctypes.data,
                None if ab_pal is None else ab_pal.ctypes.data)
            return blob, pals
    if len(ctxs) > 1:
        results = list(_pack_pool().map(fill_one, ctxs))
    else:
        results = [fill_one(ctxs[0])]
    blobs = [r[0] for r in results]
    pals_list = [r[1] for r in results]
    return blobs, layout, pals_list, d["has_i8"], d["deblock"]
