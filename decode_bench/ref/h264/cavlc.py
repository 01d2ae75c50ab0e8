"""H.264 CAVLC residual block parsing.

Mirrors the reference's residual_block_cavlc exactly
(reference: src/lib/h264.cpp:2038-2110), including:
* nC selection (get_nC, :1739-1754) with -1 meaning unavailable;
* level decode incl. suffix-length adaptation via the squared-threshold
  trick (:2067-2090, equivalent to the spec's 3<<(suffixLength-1) rule);
* coefficient write-back with dequant multiply at parse time
  (coeff_writeback :2005-2022); write-back order runs from the LAST
  coefficient backwards with index masking.

Block categories (cat) follow the reference's coeff_ofs table (:1996-2003):
0=luma DC (16), 1=luma AC (15), 2=luma 4x4 (16), 3=chroma DC (4),
4=chroma AC (15), 5=luma 8x8 (64).
"""

from __future__ import annotations

import numpy as np

from . import tables as T

# cat -> (coeff_offset, num_coeff, dc_mask)
COEFF_OFS = {
    0: (0, 16, 0),
    1: (1, 15, 15),
    2: (0, 16, 15),
    3: (0, 4, 0),
    4: (1, 15, 15),
    5: (0, 64, 63),
}

_ERR_MASK = {0: 15, 1: 15, 2: 15, 3: 3, 4: 15, 5: 63}

_ZIGZAG = {
    0: T.ZIGZAG4x4,
    1: T.ZIGZAG4x4,
    2: T.ZIGZAG4x4,
    3: (0, 1, 2, 3),
    4: T.ZIGZAG4x4,
    5: T.ZIGZAG8x8,
}


def get_nc(na, nb):
    """h264.cpp:1739-1754 (-1 = unavailable)."""
    if na >= 0:
        return (na + nb + 1) >> 1 if nb >= 0 else na
    return nb if nb >= 0 else 0


def _coeff_token(r, na, nb, cat):
    if COEFF_OFS[cat][1] <= 4:
        dec = T.COEFF_TOKEN_DEC[4]
    else:
        nc = get_nc(na, nb)
        if nc >= 8:
            dec = T.COEFF_TOKEN_DEC[3]
        elif nc >= 4:
            dec = T.COEFF_TOKEN_DEC[2]
        elif nc >= 2:
            dec = T.COEFF_TOKEN_DEC[1]
        else:
            dec = T.COEFF_TOKEN_DEC[0]
    return dec.read(r)


def _level_prefix(r):
    n = 0
    while r.get_bits(1) == 0:
        n += 1
    return n


def residual_block(r, na, nb, coeff, qmat, cat):
    """Parse one residual block into `coeff` (int64, raster layout).

    Returns the reference's return value: min(total_coeff, 15)
    (used as the nC for later neighbors and as a nonzero flag).
    """
    ofs, num_coeff, dc_mask = COEFF_OFS[cat]
    total_coeff, trailing_ones = _coeff_token(r, na, nb, cat)
    if total_coeff == 0:
        return 0
    level = [0] * total_coeff
    if trailing_ones:
        ones = r.get_bits(trailing_ones)
        for i in range(trailing_ones):
            # MSB-first: first read bit is sign of level[0]
            level[i] = -1 if (ones >> (trailing_ones - 1 - i)) & 1 else 1
    suffix_len = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        lvl_prefix = _level_prefix(r)
        lvl = lvl_prefix << suffix_len
        if suffix_len > 0 or lvl_prefix >= 14:
            size = suffix_len
            if lvl_prefix == 14 and size == 0:
                size = 4
            elif lvl_prefix == 15:
                size = 12
            if size:
                lvl += r.get_bits(size)
        if suffix_len == 0 and lvl_prefix == 15:
            lvl += 15
        if i == trailing_ones and trailing_ones < 3:
            lvl += 2
        # map to signed: even lvl -> +(lvl+2)/2, odd -> -(lvl+1)/2
        level[i] = lvl = (-(lvl + 1) >> 1) if (lvl & 1) else ((lvl + 2) >> 1)
        if suffix_len == 0:
            suffix_len = 1
        if suffix_len < 6 and (3 << (suffix_len - 1)) ** 2 < lvl * lvl:
            suffix_len += 1
    if total_coeff < num_coeff:
        if num_coeff > 4:
            zeros_left = T.TOTAL_ZEROS_DEC[total_coeff].read(r)
        else:
            zeros_left = T.TOTAL_ZEROS_CHROMA_DEC[total_coeff].read(r)
    else:
        zeros_left = 0
    run = [0] * total_coeff
    for i in range(total_coeff - 1):
        rb = T.RUN_BEFORE_DEC[min(zeros_left, 7)].read(r) if zeros_left else 0
        run[i] = rb
        zeros_left -= rb
    run[total_coeff - 1] = zeros_left
    # write-back (coeff_writeback, h264.cpp:2005-2022)
    zigzag = _ZIGZAG[cat]
    err_mask = _ERR_MASK[cat]
    coeff[ofs : ofs + num_coeff] = 0
    idx = ofs - 1
    for i in range(total_coeff - 1, -1, -1):
        idx = (idx + 1 + run[i]) & err_mask
        zi = zigzag[idx]
        coeff[zi] = level[i] * int(qmat[zi & dc_mask])
    return min(total_coeff, 15)
