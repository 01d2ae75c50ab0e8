"""Multi-device decode sharding on torch.distributed: the counterpart of
``m2dec_tpu/parallel/mesh.py``.

Video decode parallelism lives at three levels; this module holds the
first two and the DPB page exchange between GOP shards:

1. **GOP / frame data parallelism** along the mesh's ``"frame"`` axis:
   independent pictures or GOPs reconstruct on different shards
   (``sharded_decode_step`` for MPEG-2, ``h264_gop_step``,
   ``h265_gop_step``), and an open GOP's shard predicts from the
   previous shard's handoff page (``h264_gop_xchg_step``).
2. **Spatial MB-row bands** of one H.264 picture, one per shard, with
   halo exchange (``h264_tile_step``).

A mesh is a 1-D row of ``size`` shards. Two kinds run the same steps:

* ``DistMesh``: one shard per rank of the default ``torch.distributed``
  process group (NCCL between GPUs, gloo on the CPU). Rank r runs on
  ``cuda:<local rank>`` unless the caller names a device.
* ``InProcessMesh``: ``size`` shards inside one process on one device
  (the JAX package's virtual devices; and on a machine with one GPU the
  only way to run several shards, since NCCL refuses two ranks on one
  GPU). Its exchange is a copy between the shards' tensors.

Both hold only the operations the steps use: ``shift`` (each shard's
tensor one hop down or up the row, zeros where no shard sends) and
``gather`` (the shards' outputs concatenated, on every rank). A step
takes global host arrays (numpy or tensors) with the shard axis leading,
runs the shards this process holds and returns their outputs
concatenated along that axis: the whole result on an in-process mesh,
the rank's own shard on a ``DistMesh`` (``gather`` joins them).
Traffic between devices goes through NCCL collectives outside the
kernels; every kernel a step launches is one the single-device path
launches, on new shapes.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..codecs.h264 import plan_host as host
from ..codecs.h264 import reconstruct as R
from ..codecs.h264 import wavefront_kernels as WK
from ..device import cuda_device, resolve_device
from ..kernels.idct_kernels import idct8x8_blocks

I32 = torch.int32
U8 = torch.uint8


# ---------------------------------------------------------------- mesh --

class Mesh:
    """A 1-D mesh of ``size`` shards; this process holds shards
    ``shards`` (in order) on ``device``."""

    def __init__(self, size, shards, device):
        self.size = size
        self.shards = list(shards)
        self.device = device

    def split(self, a):
        """The held shards' blocks of ``a`` along its leading axis, whose
        length must be a multiple of ``size``."""
        n = a.shape[0]
        if n % self.size:
            raise ValueError(f"leading axis {n} not divisible by the "
                             f"{self.size} shards of the mesh")
        k = n // self.size
        return [a[s * k:(s + 1) * k] for s in self.shards]

    def shift(self, xs, step):
        """One hop along the row: xs holds one tensor per held shard (one
        shape on every shard); shard i receives shard i - step's tensor,
        or zeros where i - step is off the mesh. Returns the received
        tensors, one per held shard."""
        raise NotImplementedError

    def gather(self, t):
        """The held shards' output ``t`` (concatenated along axis 0) ->
        every shard's, on every rank."""
        raise NotImplementedError


class InProcessMesh(Mesh):
    """All ``size`` shards in this process, on one device."""

    def __init__(self, size, device):
        super().__init__(size, range(size), device)

    def shift(self, xs, step):
        return [xs[i - step].clone() if 0 <= i - step < self.size
                else torch.zeros_like(xs[i]) for i in range(self.size)]

    def gather(self, t):
        return t


class DistMesh(Mesh):
    """One shard per rank of the default process group."""

    def __init__(self, device):
        super().__init__(dist.get_world_size(), [dist.get_rank()], device)

    def shift(self, xs, step):
        (x,) = xs
        rank = self.shards[0]
        x = x.contiguous()
        buf = torch.zeros_like(x)
        ops = []
        if 0 <= rank + step < self.size:
            ops.append(dist.P2POp(dist.isend, x, rank + step))
        if 0 <= rank - step < self.size:
            ops.append(dist.P2POp(dist.irecv, buf, rank - step))
        if ops:  # a rank with no peer posts nothing
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [buf]

    def gather(self, t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts)


def make_mesh(n_devices=None, *, in_process=False, device=None):
    """A 1-D mesh; its shard axis is the leading axis of the steps'
    arrays (the JAX mesh's ``"frame"`` axis). in_process=True:
    ``n_devices`` (default 1)
    shards in this process on ``device`` (default: the CUDA device;
    raises without one). Otherwise one shard per rank of the initialized
    default process group (``n_devices`` None or its world size), on
    ``device`` or, by default, ``cuda:<local rank>`` (``LOCAL_RANK``, else
    rank modulo the GPU count). Without a process group it raises: it
    never picks the in-process mesh by itself."""
    if in_process:
        return InProcessMesh(n_devices or 1, resolve_device(device))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no torch.distributed process group "
                           "is initialized; initialize one, or pass "
                           "in_process=True for shards in this process")
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the "
                         f"process group has {world} ranks")
    if device is None:
        cuda_device()  # raises without a GPU
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    return DistMesh(torch.device(device))


def gather(mesh, x):
    """``mesh.gather`` over a tensor or nested tuples of tensors."""
    if isinstance(x, (tuple, list)):
        return type(x)(gather(mesh, v) for v in x)
    return mesh.gather(x)


# ------------------------------------------------------------- helpers --

def _host(a):
    """A numpy view of a host array or tensor (copied from a device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _dev(a, device, dtype=None, copy=False):
    """``a`` (numpy or tensor) on ``device``; copy: never share the
    caller's memory (the steps write pools in place)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t.to(device=device, dtype=dtype, copy=copy)


def _no_ipcm(kind, step):
    """Raise on IPCM macroblocks (kind 4): these steps take no PCM
    samples, so such a picture cannot come out right (the JAX steps
    return zeros for them)."""
    if bool((_host(kind) == 4).any()):
        raise ValueError(f"{step}: the plan has IPCM macroblocks, which "
                         f"this step does not reconstruct")


def _local(parts):
    """The held shards' outputs -> one tensor (or tuple) along axis 0."""
    if isinstance(parts[0], tuple):
        return tuple(_local(list(p)) for p in zip(*parts))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


# -------------------------------------------------------------- MPEG-2 --

def batched_reconstruct(mb_w, mb_h):
    """MPEG-2 Phase B of a batch of pictures, each with its own two
    reference frames, on one device: fn(intra, fwd, bwd, mvf, mvb,
    dct_type, coef, r0y, r0cb, r0cr, r1y, r1cb, r1cr), every argument
    with a leading batch axis n (numpy or tensors; the plan arrays as
    ``example_batch`` makes them), on ``device`` -> (y, cb, cr) uint8
    [n, H, W] / [n, H/2, W/2]. One IDCT launch over the batch's
    coefficients, then ``codecs.mpeg2.reconstruct_arrays`` per picture."""
    from ..codecs.mpeg2.reconstruct import _mc_needs, reconstruct_arrays

    def fn(intra, fwd, bwd, mvf, mvb, dct_type, coef, *refs, device=None):
        dev = resolve_device(device)
        hints = [_host(a) for a in (intra, fwd, bwd)]
        needs = [_mc_needs(i, f, b, None) for i, f, b in zip(*hints)]
        res = idct8x8_blocks(_dev(coef, dev, torch.int16))
        intra, fwd, bwd = (_dev(a, dev, torch.bool) for a in hints)
        mvf, mvb, dct_type = (_dev(a, dev, I32) for a in (mvf, mvb,
                                                          dct_type))
        refs = [_dev(r, dev, U8) for r in refs]
        outs = []
        for b in range(res.shape[0]):
            outs.append(reconstruct_arrays(
                intra[b], fwd[b], bwd[b], mvf[b], mvb[b], dct_type[b],
                res[b], tuple(r[b] for r in refs[:3]),
                tuple(r[b] for r in refs[3:]), mb_w=mb_w, mb_h=mb_h,
                needs=needs[b]))
        return tuple(torch.stack(p) for p in zip(*outs))

    return fn


def sharded_decode_step(mesh, mb_w, mb_h):
    """MPEG-2 batched reconstruction with the batch axis sharded over the
    mesh (``batched_reconstruct`` on each held shard's pictures): one
    IDCT launch per shard. Returns fn(*args) -> (y, cb, cr) of the held
    shards (``gather`` for all)."""
    one = batched_reconstruct(mb_w, mb_h)

    def fn(*args):
        parts = [one(*blocks, device=mesh.device)
                 for blocks in zip(*(mesh.split(a) for a in args))]
        return _local(parts)

    return fn


def example_batch(n, mb_w, mb_h, seed=0):
    """Synthetic plan batch + refs for compile checks and benchmarks (the
    JAX package's generator, numpy only: the same arrays for a seed)."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    h, w = mb_h * 16, mb_w * 16
    plans = dict(
        intra=rng.random((n, nmb)) < 0.2,
        fwd=np.ones((n, nmb), bool),
        bwd=rng.random((n, nmb)) < 0.5,
        mvf=rng.integers(-8, 8, (n, nmb, 2)).astype(np.int32),
        mvb=rng.integers(-8, 8, (n, nmb, 2)).astype(np.int32),
        dct_type=np.zeros((n, nmb), np.int32),
        coef=(rng.integers(-64, 64, (n, nmb, 6, 64)) *
              (rng.random((n, nmb, 6, 64)) < 0.1)).astype(np.int16),
    )
    # keep MV interpolation windows inside the frame: zero MVs on border MBs
    mbx = np.arange(nmb) % mb_w
    mby = np.arange(nmb) // mb_w
    interior = (mbx >= 1) & (mbx < mb_w - 1) & (mby >= 1) & (mby < mb_h - 1)
    plans["mvf"] *= interior[None, :, None]
    plans["mvb"] *= interior[None, :, None]
    refs = [
        rng.integers(0, 256, (n, h, w)).astype(np.uint8),
        rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
        rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
    ] * 2
    return (plans["intra"], plans["fwd"], plans["bwd"], plans["mvf"],
            plans["mvb"], plans["dct_type"], plans["coef"], *refs)


# ---------------------------------------------------------------- H.264 --

def _gop_upload(mesh, py, pcb, pcr, stacked, cur_idx, step):
    """Per held shard: (pools [g, P, H, W] copied to the mesh's device,
    int32 plan tensors [g, N, ...], cur_idx [g, N] numpy)."""
    _no_ipcm(stacked["kind"], step)
    dev = mesh.device
    pools = [tuple(_dev(p, dev, U8, copy=True) for p in t)
             for t in zip(*(mesh.split(p) for p in (py, pcb, pcr)))]
    keys = [k for k in stacked if k in host._PLAN_KEYS
            or k in ("mc_used", "mc_bi")]
    sts = [dict(zip(keys, blocks)) for blocks in
           zip(*(mesh.split(stacked[k]) for k in keys))]
    sts = [{k: _dev(v, dev, I32) for k, v in st.items()} for st in sts]
    curs = [_host(c) for c in mesh.split(cur_idx)]
    return list(zip(pools, sts, curs))


def h264_gop_step(mesh, mb_w, mb_h):
    """Multi-device H.264 decode: each shard reconstructs its own GOPs
    (independent picture groups or streams), each GOP with its own
    frame pool on the shard's device.

    fn(py, pcb, pcr, stacked, cur_idx): pools [G, P, H, W], dense plan
    tensors {key of _PLAN_KEYS: [G, N, ...]} (optionally with the
    dense-MC aux mc_used / mc_bi [G, N, ...]), cur_idx [G, N]; G sharded
    over the mesh. Per shard, ``reconstruct._recon_batch`` with S = the
    shard's GOPs (one launch per wavefront pass per picture step for all
    of them); has_i8 and deblock on, as in the JAX step. Returns ((pool
    y, cb, cr), (y, cb, cr) [G, N, H, W]) of the held shards."""
    def fn(py, pcb, pcr, stacked, cur_idx):
        parts = []
        for pools, st, cur in _gop_upload(mesh, py, pcb, pcr, stacked,
                                          cur_idx, "h264_gop_step"):
            parts.append(R._recon_batch(*pools, st, cur, mb_w=mb_w,
                                        mb_h=mb_h, has_i8=True,
                                        deblock=True))
        return _local(parts)

    return fn


def h264_example_gops(n_gops, n_pics, mb_w, mb_h, pool_size=4, seed=0):
    """Tiny synthetic GOP batch (the JAX package's generator: the same
    arrays for a seed): (pools, stacked, cur_idx). The JAX one also
    returns the diagonal lanes of its XLA scans, which the port has no
    use for."""
    from ..codecs.h264.plan import PicturePlan

    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(n_gops * n_pics):
        p = PicturePlan(mb_w, mb_h)
        p.kind[:] = rng.integers(0, 2, p.n)  # mix of inter / intra4x4
        p.i4_avail[:] = 0
        p.mv[:] = rng.integers(-8, 8, p.mv.shape)
        p.slot[:, :, 0] = 0
        p.wp[:, :, :, 0] = 1
        plans.append(p)
    stacked = {
        k: np.stack([getattr(p, k) for p in plans]).reshape(
            (n_gops, n_pics) + getattr(plans[0], k).shape)
        for k in host._PLAN_KEYS
    }
    cur_idx = np.tile(np.arange(n_pics, dtype=np.int32) % pool_size,
                      (n_gops, 1))
    H, W = mb_h * 16, mb_w * 16
    pools = (np.zeros((n_gops, pool_size, H, W), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8))
    return pools, stacked, cur_idx


# ---------------------------------------------------------------- H.265 --

def h265_gop_step(mesh, H, W, ctb_log2):
    """Multi-device H.265 decode: each shard reconstructs its own GOPs,
    each with its own frame pool (the shape of ``h264_gop_step``).

    fn(py, pcb, pcr, plans): pools [G, P, H, W], plans G lists of N
    ``H265Plan`` (one picture geometry, CTB 1 << ctb_log2) in decode
    order; G sharded over the mesh. Per GOP, ``H265SeqPhaseB``'s batch
    (``stack_plans``, one upload, ``_recon_picture`` per picture: the
    tile kernel once per picture at CTB 16) on the GOP's pool. Returns
    ((pool y, cb, cr), (y, cb, cr) [G, N, H, W]) of the held shards."""
    from ..codecs.h265.reconstruct import H265SeqPhaseB

    def fn(py, pcb, pcr, plans):
        for gop in plans:
            for p in gop:
                if (p.H, p.W, p.size_log2) != (H, W, ctb_log2):
                    raise ValueError(f"h265_gop_step: a plan of {p.W}x{p.H} "
                                     f"at CTB log2 {p.size_log2}, want "
                                     f"{W}x{H} at {ctb_log2}")
        idx = mesh.split(np.arange(len(plans)))
        parts = []
        for gops, blocks in zip(idx, zip(*(mesh.split(p)
                                           for p in (py, pcb, pcr)))):
            ph = H265SeqPhaseB(H, W, blocks[0].shape[1],
                               device=mesh.device)
            pools = [[], [], []]
            outs = [[], [], []]
            for j, g in enumerate(gops):
                for dst, src in zip(ph.pool, blocks):
                    dst.copy_(_dev(src[j], mesh.device, U8))
                for acc, o in zip(outs, ph.run_async(plans[g])):
                    acc.append(o)
                for acc, p in zip(pools, ph.pool):
                    acc.append(p.clone())
            parts.append((tuple(torch.stack(a) for a in pools),
                          tuple(torch.stack(a) for a in outs)))
        return _local(parts)

    return fn


def h265_example_gops(n_gops, n_pics, H, W, ctb_log2=4, pool_size=4,
                      seed=0):
    """Tiny synthetic H.265 GOP batch (the JAX package's generator: the
    same plans for a seed): (pools, plans), plans n_gops lists of n_pics
    port ``H265Plan``s (the JAX one returns them stacked for its scan)."""
    from ..codecs.h265.plan import H265Plan

    rng = np.random.default_rng(seed)
    cols, rows = W >> ctb_log2, H >> ctb_log2
    sps = types.SimpleNamespace(pic_width=W, pic_height=H,
                                strong_intra_smoothing=0)

    def pack(lists):
        cap = max(1, max((len(o) for o in lists), default=0))
        b = 1
        while b < cap:
            b *= 2
        arr = np.zeros((len(lists), b, 7), np.int32)
        for i, ops in enumerate(lists):
            if ops:
                arr[i, : len(ops)] = ops
        return arr

    plans = []
    for gi in range(n_gops * n_pics):
        p = H265Plan(sps, cols, rows, ctb_log2)
        # an intra DC op + a residual TU per CTU, inter cells elsewhere
        for cy in range(rows):
            for cx in range(cols):
                ci = cy * cols + cx
                y0, x0 = cy << ctb_log2, cx << ctb_log2
                p._ops_l[ci].append([1, y0, x0, 2, 1, -1, -1])
                p._ops_c[ci].append([1, y0 >> 1, x0 >> 1, 2, 1, -1, -1])
                p.tu_y[y0 >> 2, x0 >> 2] = 1 | (3 << 3)
                p.coef_y[y0 : y0 + 4, x0 : x0 + 4] = rng.integers(
                    -40, 40, (4, 4))
        p.slot[rows << 1 :, :, 0] = 0  # lower cells inter, zero MV
        p.has_sao = True
        p.cur_idx = gi % pool_size
        p.ops_l = pack(p._ops_l)
        p.ops_c = pack(p._ops_c)
        plans.append(p)
    pools = (np.zeros((n_gops, pool_size, H, W), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8),
             np.zeros((n_gops, pool_size, H >> 1, W >> 1), np.uint8))
    return pools, [plans[g * n_pics:(g + 1) * n_pics]
                   for g in range(n_gops)]


# ------------------------------------------------------- H.264 bands --

#: the wavefront passes' per-MB plan tensors (with the residuals)
_WF_KEYS = ("kind", "res_y", "res_c", "i4_modes", "i4_avail", "i8_modes",
            "i8_avail", "i16_mode", "chroma_mode", "mb_avail", "deb_str",
            "deb_str4", "deb_ab")


def _with_halo_row(P, mb_w):
    """A band's wavefront plan tensors [n, ...] with one MB row on top
    whose entries touch no pixel (kind 0, every edge strength 0): the
    row that holds the halo samples, so that the passes read the band
    above's samples as their row above."""
    return {k: torch.cat([P[k].new_zeros((mb_w,) + P[k].shape[1:]), P[k]])
            for k in _WF_KEYS}


def h264_tile_step(mesh, mb_w, mb_h, has_i8=False):
    """Spatial band parallelism: ONE H.264 picture's Phase B in MB-row
    bands, one band per shard, with halo exchange.

    - residual + quarter-pel MC: parallel per band; the reference
      pictures are replicated and MVs address them in picture
      coordinates (``inter_pass(y_off=...)``).
    - the passes run on each band with one extra MB row on top that
      holds the halo and whose plan entries touch no pixel, so the
      band's first row reads the halo as its row above: the same
      kernels (on CUDA) and plain versions (on the CPU) as a picture.
    - intra: bands in order; each band's bottom pixel line before
      deblocking (the next band's row above, over the whole width) goes
      one hop down.
    - deblock: bands in order, after every band's intra; a band's first
      row reads and filters the band above's bottom 4 rows after that
      band has filtered them, and one hop up sends them back at the end.

    fn(P_tiled, refs_y, refs_cb, refs_cr): P_tiled from
    ``h264_tile_plan`` ([n_bands, nmb_local, ...]), refs the whole
    reference pictures [R, H, W] (replicated). has_i8 as in the JAX
    step: pass True for a plan with 8x8 transforms. A plan with IPCM
    MBs raises (the step has no PCM samples). Returns (y, cb, cr) of the
    held bands, their rows concatenated (``gather`` for the picture)."""
    nb = mesh.size
    if mb_h % nb:
        raise ValueError(f"mb_h={mb_h} not divisible by {nb} bands")
    bh = mb_h // nb
    Hl, W = bh * 16, mb_w * 16
    dev = mesh.device

    def fn(P_tiled, refs_y, refs_cb, refs_cr):
        _no_ipcm(P_tiled["kind"], "h264_tile_step")
        refs = [_dev(r, dev, U8)[None] for r in (refs_y, refs_cb, refs_cr)]
        held = {k: mesh.split(v) for k, v in P_tiled.items()}
        bands = []
        for i, b in enumerate(mesh.shards):
            P = {k: _dev(v[i][0], dev, I32) for k, v in held.items()}
            P["res_y"], P["res_c"] = R._residuals(P, has_i8)
            pred = R.inter_pass(P["mv"], P["slot"], P["wp"], *refs, mb_w,
                                bh, host._HP_TAB, y_off=b * Hl)
            is_inter = (P["kind"] == 0)[:, None, None]
            res = (P["res_y"], P["res_c"][:, 0], P["res_c"][:, 1])
            planes = []
            for p, r, blk in zip(pred, res, (16, 8, 8)):
                v = torch.where(is_inter, (p + r).clamp(0, 255), 0)
                band = R._assemble(v, blk, mb_w, bh)[0].to(U8)
                planes.append(F.pad(band, (0, 0, blk, 0)))
            bands.append([*planes, _with_halo_row(P, mb_w)])

        def pack(rows):
            """Each held band's rows (the 1 or 4 pixel rows of each plane
            a hop sends) as one flat tensor."""
            return [torch.cat([t.reshape(-1) for t in rows(y, cb, cr)])
                    for y, cb, cr, _ in bands]

        def unpack(flat, n):
            """pack's tensor of n rows -> (y [n, W], cb, cr [n, W/2])."""
            y, cb, cr = flat.split([n * W, n * W // 2, n * W // 2])
            return y.view(n, W), cb.view(n, W // 2), cr.view(n, W // 2)

        def pipeline(n, passes):
            """Band s runs at step s with the n rows above it from band
            s - 1 installed in its halo row; then each band's bottom n
            rows go one hop down."""
            halo = None
            for s in range(nb):
                for i, b in enumerate(mesh.shards):
                    if b != s:
                        continue
                    y, cb, cr, Q = bands[i]
                    if s:
                        hy, hcb, hcr = unpack(halo[i], n)
                        y[16 - n:16] = hy
                        cb[8 - n:8] = hcb
                        cr[8 - n:8] = hcr
                    bands[i][:3] = passes(y, cb, cr, Q)
                if s < nb - 1:
                    halo = mesh.shift(pack(lambda y, cb, cr: (
                        y[-n:], cb[-n:], cr[-n:])), 1)

        pipeline(1, lambda y, cb, cr, Q: (
            WK.intra_luma(y, Q, has_i8, mb_w, bh + 1),
            *WK.intra_chroma(cb, cr, Q, mb_w, bh + 1)))
        pipeline(4, lambda y, cb, cr, Q: (
            WK.deblock_luma(y, Q, mb_w, bh + 1),
            *WK.deblock_chroma(cb, cr, Q, mb_w, bh + 1)))
        # the halo rows as this band's boundary edges left them go back
        # up into the band above's bottom rows
        back = mesh.shift(pack(lambda y, cb, cr: (
            y[12:16], cb[4:8], cr[4:8])), -1)
        outs = []
        for (y, cb, cr, _), flat, b in zip(bands, back, mesh.shards):
            if b < nb - 1:
                hy, hcb, hcr = unpack(flat, 4)
                y[-4:] = hy
                cb[-4:] = hcb
                cr[-4:] = hcr
            outs.append((y[16:], cb[8:], cr[8:]))
        return _local(outs)

    return fn


def h264_tile_plan(plan, n_bands):
    """Split a PicturePlan's tensors into [n_bands, nmb_local, ...] for
    ``h264_tile_step`` (MB-row bands)."""
    out = {}
    for k in host._PLAN_KEYS:
        v = np.asarray(getattr(plan, k))
        out[k] = v.reshape((n_bands, v.shape[0] // n_bands) + v.shape[1:])
    return out


# ------------------------------------------- cross-GOP DPB exchange --

def h264_gop_xchg_step(mesh, mb_w, mb_h, pool_size, handoff_slot=0,
                       has_i8=True, deblock=True):
    """Open-GOP data parallelism with cross-shard references: each shard
    decodes its own GOP, and its pictures may also reference the
    PREVIOUS shard's DPB handoff page (the anchor a leading B picture of
    an open GOP predicts from).

    The handoff page (pool slot ``handoff_slot`` as of step entry: shard
    g consumes what shard g - 1 made in the previous round) goes one hop
    down the mesh and is appended to the local pool as slot
    ``pool_size``; plan slots equal to pool_size address it. Shard 0
    receives zeros (its plans must not use the extra slot). Writes stay
    local: cur_idx < pool_size.

    fn(py, pcb, pcr, stacked, cur_idx) as ``h264_gop_step``'s, with one
    GOP per shard (G = the mesh's size); per shard
    ``reconstruct._recon_batch`` with the page as ``extra``."""
    H, W = mb_h * 16, mb_w * 16

    def fn(py, pcb, pcr, stacked, cur_idx):
        if len(cur_idx) != mesh.size:
            raise ValueError(f"h264_gop_xchg_step: {len(cur_idx)} GOPs on "
                             f"{mesh.size} shards, want one each")
        shards = _gop_upload(mesh, py, pcb, pcr, stacked, cur_idx,
                             "h264_gop_xchg_step")
        if shards[0][0][0].shape[1] != pool_size:
            raise ValueError(f"pools of {shards[0][0][0].shape[1]} slots, "
                             f"want {pool_size}")
        pages = mesh.shift([torch.cat([p[0, handoff_slot].reshape(-1)
                                       for p in pools])
                            for pools, _, _ in shards], 1)
        parts = []
        for (pools, st, cur), page in zip(shards, pages):
            y, cb, cr = page.split([H * W, H * W // 4, H * W // 4])
            extra = (y.view(1, 1, H, W), cb.view(1, 1, H // 2, W // 2),
                     cr.view(1, 1, H // 2, W // 2))
            parts.append(R._recon_batch(*pools, st, cur, mb_w=mb_w,
                                        mb_h=mb_h, has_i8=has_i8,
                                        deblock=deblock, extra=extra))
        return _local(parts)

    return fn
