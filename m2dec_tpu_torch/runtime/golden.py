"""Device-side checksums of decoded pictures.

``device_frame_cks`` is the twin of
``m2dec_tpu/runtime/golden.py::device_frame_cks``: over the frame's
cropped NV12 byte stream b (cropped luma rows, then interleaved CbCr
rows — the bytes the reference's raw writer emits),

    cks(frame) = (sum(b_i) mod 2^32, sum(b_i * ((i mod 8191) + 1)) mod 2^32)

computed on the device in int64, so only two numbers leave it.
``frame_checksums`` is the twin of the JAX package's per-picture
``_jitted_checksum`` (H.264 ``reconstruct.py``), for any codec's
[N, ...] plane stacks; ``stack_checksum`` takes a stream's whole picture
stack as one unit, as the JAX ``MultiStreamPhaseB.checksums`` does, and
``host_checksum`` is the numpy copy of the JAX package's
``host_checksum`` that both are held to.
"""

from __future__ import annotations

import numpy as np
import torch


def device_frame_cks(y, cb, cr, crop) -> tuple[int, int]:
    """Checksum of a frame's uint8 planes on any device; crop = (left,
    right, top, bottom) in luma pixels."""
    cl, cr_, ct, cb_ = crop
    H, W = y.shape
    w, h = W - cl - cr_, H - ct - cb_
    ys = y[ct : ct + h, cl : cl + w].reshape(-1)
    rows = slice(ct // 2, (ct + h) // 2)
    cols = slice(cl // 2, (cl + w) // 2)
    nv = torch.stack([cb[rows, cols], cr[rows, cols]], dim=-1).reshape(-1)
    b = torch.cat([ys, nv]).to(torch.int64)
    wv = torch.arange(b.numel(), dtype=torch.int64, device=b.device)
    out = torch.stack([b.sum(), (b * (wv % 8191 + 1)).sum()]) & 0xFFFFFFFF
    s, ws = out.tolist()
    return int(s), int(ws)


def frame_checksums(y, cb, cr):
    """Per-picture checksums of [N,...] uint8 plane stacks on the
    device: int32 [N,3,2] with (sum, sum of b_i*((i mod 8191)+1)) mod
    2^32 per plane — row i equals host_checksum(y[i], cb[i], cr[i])."""
    def one(a):
        flat = a.reshape(a.shape[0], -1).to(torch.int64)
        w = torch.arange(flat.shape[1], dtype=torch.int64,
                         device=flat.device) % 8191 + 1
        return torch.stack([flat.sum(dim=1), (flat * w).sum(dim=1)],
                           dim=-1) & 0xFFFFFFFF

    v = torch.stack([one(y), one(cb), one(cr)], dim=1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def stack_checksum(y, cb, cr):
    """One stream's whole picture stack [N, ...] as one flat unit: int32
    [3, 2] on the device, equal to host_checksum(y, cb, cr)."""
    return frame_checksums(y[None], cb[None], cr[None])[0]


def host_checksum(y, cb, cr):
    """The host (numpy) checksum of planes or plane stacks: int32 [3, 2],
    (sum, sum of b_i*((i mod 8191)+1)) mod 2^32 over each plane's bytes
    in C order."""
    out = np.zeros((3, 2), np.uint64)
    for i, a in enumerate((y, cb, cr)):
        flat = np.ascontiguousarray(a).reshape(-1).astype(np.uint64)
        w = (np.arange(flat.size, dtype=np.uint64) % 8191) + 1
        out[i, 0] = flat.sum() & 0xFFFFFFFF
        out[i, 1] = (flat * w % (1 << 32)).sum() & 0xFFFFFFFF
    return out.astype(np.int64).astype(np.uint32).view(np.int32)
