"""The MPEG-2 8x8 IDCT as a CUDA kernel, with its plain version beside it.

The counterpart of ``m2dec_tpu/kernels/pallas_idct.py::idct8x8_pallas``.
The kernel lives in ``m2dec_tpu_torch/csrc/mpeg2_idct.cu``; this wrapper
checks dtype, shape, alignment and device. It runs the plain PyTorch
version (``mpeg2_idct.idct8x8``) only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises, never falling back.

``LAUNCHES`` counts kernel launches, so a run can show it went through
the kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from .mpeg2_idct import idct8x8

#: kernel launches since the last reset
LAUNCHES = {"idct8x8": 0}


def reset_launch_counts():
    LAUNCHES["idct8x8"] = 0


def idct8x8_blocks_plain(coef: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`idct8x8_blocks` on any device."""
    return idct8x8(coef.reshape(tuple(coef.shape[:-1]) + (8, 8)))


def idct8x8_blocks(coef: torch.Tensor) -> torch.Tensor:
    """IDCT of int16 coefficient blocks [..., 64] (raster order within
    each 8x8 block, e.g. a plan's [N, 6, 64]) -> int32 [..., 8, 8],
    bit-equal to :func:`idct8x8`, not clipped. CPU: the plain version;
    CUDA: one kernel launch over all blocks."""
    if coef.dtype != torch.int16 or coef.shape[-1] != 64:
        raise ValueError(f"want int16 [..., 64] coefficients, got "
                         f"{coef.dtype} {tuple(coef.shape)}")
    if coef.device.type == "cpu":
        return idct8x8_blocks_plain(coef)
    lib = _build.load_library("mpeg2_idct")
    if coef.device.type != "cuda":
        raise RuntimeError(f"the IDCT kernel needs a CUDA tensor, got "
                           f"{coef.device}")
    coef = coef.contiguous()
    if coef.data_ptr() % 16:
        coef = coef.clone()  # the kernel loads rows as 16-byte vectors
    out = torch.empty(tuple(coef.shape[:-1]) + (8, 8), dtype=torch.int32,
                      device=coef.device)
    nblk = coef.numel() // 64
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream(coef.device).cuda_stream
        err = lib.mpeg2_idct8x8(coef.data_ptr(), out.data_ptr(), nblk,
                                stream)
    if err != 0:
        raise RuntimeError(f"mpeg2_idct8x8: CUDA launch failed with error "
                           f"{err}")
    if nblk:
        LAUNCHES["idct8x8"] += 1
    return out
