"""MPEG-2 8x8 fixed-point inverse DCT on torch tensors: the plain
version of the CUDA kernel in ``csrc/mpeg2_idct.cu``.

The counterpart of ``m2dec_tpu/kernels/mpeg2_idct.py::idct8x8``: the
reference's Wang-style fast IDCT (reference: src/lib/idct.cpp:35-40 W
constants, :144-235 horizontal, :286-358 vertical) as int32 arithmetic
with C semantics:

* int16 wraparound where the horizontal pass stores its results back
  into the int16 coefficient array (idct.cpp:223-230);
* arithmetic right shifts of negative int32 values (torch's ``>>`` on
  signed integers);
* no clipping: the caller's ClipStore/AddStore clips (idct.cpp:364-382).

The reference's zero shortcuts are identities of the full path, so
every block runs the full path.
"""

from __future__ import annotations

import torch

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565


def idct8x8(coef: torch.Tensor) -> torch.Tensor:
    """Inverse DCT of a batch of 8x8 blocks.

    coef: integer tensor [..., 8, 8] of dequantized coefficients (int16
    range), raster order (row, col). Returns int32 [..., 8, 8], the
    reference's ``(...) >> 14`` store operands before clipping.
    """
    c = coef.to(torch.int32)

    # --- horizontal pass (per row; reference idct.cpp:144-235) ------------
    s = [c[..., :, k] for k in range(8)]
    x0 = s[0] * 2048 + 128
    x1 = s[4] * 2048
    x0, x1 = x0 - x1, x0 + x1
    t = W7 * (s[1] + s[7])
    x4 = t + (W1 - W7) * s[1]
    x5 = t - (W1 + W7) * s[7]
    t = W3 * (s[5] + s[3])
    x6 = t - (W3 - W5) * s[5]
    x7 = t - (W3 + W5) * s[3]
    x4, x6 = x4 - x6, x4 + x6
    x5, x7 = x5 - x7, x5 + x7
    x5, x4 = ((x4 + x5) * 181 + 128) >> 8, ((x4 - x5) * 181 + 128) >> 8
    t = W6 * (s[2] + s[6])
    x2 = t - (W2 + W6) * s[6]
    x3 = t + (W2 - W6) * s[2]
    x0, x2 = x0 - x2, x0 + x2
    x1, x3 = x1 - x3, x1 + x3
    h = torch.stack(
        [
            (x3 + x6) >> 8,
            (x2 + x5) >> 8,
            (x0 + x4) >> 8,
            (x1 + x7) >> 8,
            (x1 - x7) >> 8,
            (x0 - x4) >> 8,
            (x2 - x5) >> 8,
            (x3 - x6) >> 8,
        ],
        dim=-1,
    )
    # the reference stores horizontal results back into the int16_t
    # coefficient array (idct.cpp:223-230): the wraparound is observable
    h = h.to(torch.int16).to(torch.int32)

    # --- vertical pass (per column; reference idct.cpp:286-358) -----------
    v = [h[..., k, :] for k in range(8)]
    x8 = W3 * (v[5] + v[3]) + 4
    x6 = (x8 - (W3 - W5) * v[5]) >> 3
    x7 = (x8 - (W3 + W5) * v[3]) >> 3
    x8 = W7 * (v[1] + v[7]) + 4
    x4 = (x8 + (W1 - W7) * v[1]) >> 3
    x5 = (x8 - (W1 + W7) * v[7]) >> 3
    x1t = W6 * (v[2] + v[6]) + 4
    x2 = (x1t - (W2 + W6) * v[6]) >> 3
    x3 = (x1t + (W2 - W6) * v[2]) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x0 = v[0] * 256 + 8192
    x7 = v[4] * 256
    x8 = x0 + x7
    x0 = x0 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = ((x4 + x5) * 181 + 128) >> 8
    x4 = ((x4 - x5) * 181 + 128) >> 8
    return torch.stack(
        [
            (x7 + x1) >> 14,
            (x3 + x2) >> 14,
            (x0 + x4) >> 14,
            (x8 + x6) >> 14,
            (x8 - x6) >> 14,
            (x0 - x4) >> 14,
            (x3 - x2) >> 14,
            (x7 - x1) >> 14,
        ],
        dim=-2,
    )
