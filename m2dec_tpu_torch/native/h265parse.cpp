/* Native H.265 Phase-A: slice entropy decode -> dense picture plan.
 *
 * Host-side bit-serial front end of the two-phase TPU engine: walks a
 * picture's slices once (CABAC, quad-tree, intra-mode derivation,
 * residual parse+dequant, merge/AMVP motion derivation, deblock edge
 * recording, SAO parameter parse) and fills the H265Plan tensors that
 * the batched XLA Phase B consumes (m2dec_tpu/codecs/h265/
 * reconstruct.py).  Semantics mirror the verified Python Phase A
 * (m2dec_tpu/codecs/h265/{ctu,residual,inter_cu,deblock,sao}.py)
 * function-for-function, which in turn is bit-exact with the reference
 * decoder (reference: src/lib/h265.cpp slice_data :4836-4846 and the
 * coding_tree_unit recursion).
 *
 * Python owns NAL walking, VPS/SPS/PPS/slice headers, POC, RPS-derived
 * ref lists and the DPB; this module owns everything per-CTU, plus the
 * persistent cross-picture state the reference keeps in h265d_ctu_t
 * (coeff_buf staleness, qp-scale cache, sao_map) and the pool's
 * colocated-MV pages.
 */

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <initializer_list>

#include "h265_tables.inc"

namespace {

// ---------------------------------------------------------------------
// bit reader (payload already emulation-prevention-stripped)
// ---------------------------------------------------------------------
struct BitReader {
    const uint8_t *base;
    const uint8_t *p;
    const uint8_t *end;
    uint64_t cache;  // MSB-aligned
    int ncache;
    int64_t pos;

    void init(const uint8_t *data, int64_t len_bytes, int64_t bit_offset) {
        base = data;
        end = data + len_bytes;
        seek(bit_offset);
    }
    void seek(int64_t bit) {
        pos = bit;
        p = base + (bit >> 3);
        cache = 0;
        ncache = 0;
        int drop = bit & 7;
        fill();
        if (drop) {
            cache <<= drop;
            ncache -= drop;
            fill();
        }
    }
    void fill() {
        while (ncache <= 56) {
            uint64_t b = (p < end) ? *p++ : 0;
            cache |= b << (56 - ncache);
            ncache += 8;
        }
    }
    uint32_t get(int n) {
        uint32_t v = (uint32_t)(cache >> (64 - n));
        cache <<= n;
        ncache -= n;
        pos += n;
        fill();
        return v;
    }
    uint32_t get1() { return get(1); }
    /* consumed bits ran past the payload (the reader zero-pads):
     * the reference's dec_bits would have longjmp'd (bitio.c:112-128)
     * — the picture must be abandoned, never completed from padding.
     * 32 bits of slack absorb the CABAC engine's legitimate pre-read
     * lookahead at a slice ending flush with the payload. */
    bool past_end() const {
        return pos > (int64_t)(end - base) * 8 + 32;
    }
};

// ---------------------------------------------------------------------
// prediction / neighbour records (ctu.py Neighbour / PredInfo)
// ---------------------------------------------------------------------
struct PredInfo {
    int16_t mv[2][2];
    int8_t ref[2];
    void reset() { mv[0][0] = mv[0][1] = mv[1][0] = mv[1][1] = 0;
                   ref[0] = ref[1] = -1; }
    bool same(const PredInfo &o) const {
        return ref[0] == o.ref[0] && ref[1] == o.ref[1]
            && mv[0][0] == o.mv[0][0] && mv[0][1] == o.mv[0][1]
            && mv[1][0] == o.mv[1][0] && mv[1][1] == o.mv[1][1];
    }
};

struct Neighbour {
    int8_t skip, pu_intra, depth, pu_nonzero_coef;
    int8_t tu_intra, tu_nonzero_coef;
    int16_t pred_mode;
    PredInfo pred;
    void init_fresh() {
        skip = 0; pu_intra = 1; pred_mode = 1; depth = 0;
        pu_nonzero_coef = 0; tu_intra = 1; tu_nonzero_coef = 0;
        pred.reset();
    }
    void reset() {  // neighbour_init: only these four (h265.cpp:4743)
        skip = 0; pu_intra = 1; pred_mode = 1; depth = 0;
    }
};

struct ColCell {  // colpics.py ColCell
    int16_t mv[2][2];
    int8_t ref[2];
    int8_t pu_intra;
};

struct SaoMapC {  // sao.py SaoMap
    int8_t merge_left, luma_idx, chroma_idx;
    int8_t off[3][4];
    int8_t opt[3];
};

struct Boundary { int16_t str, qp; };

// ---------------------------------------------------------------------
// slice params (filled by Python from the slice header / SPS / PPS)
// ---------------------------------------------------------------------
struct H265SliceParams {
    int32_t slice_type;        // 0=B 1=P 2=I
    int32_t slice_qpy, cabac_init_flag;
    int32_t sao_luma, sao_chroma;
    int32_t slice_addr;
    int32_t max_merge, mvd_l1_zero, temporal_mvp;
    int32_t colocated_from_l0, collocated_ref_idx;
    int32_t num_ref_idx_minus1[2];
    int32_t deblock_disabled, beta_offset_div2, tc_offset_div2;
    int32_t qpc_delta[2];
    int32_t sign_data_hiding, transform_skip, cu_qp_delta;
    int32_t max_hier_intra, max_hier_inter, amp;
    int32_t log2_parallel_merge;
    int32_t min_cb_log2, max_tb_log2, min_tb_log2;
    int64_t bit_offset;
    int32_t ref_poc[2][16];
    int32_t ref_fidx[2][16];
    int32_t col_page;          // pool idx of the colocated page (-1)
    int32_t lowdelay;
    int32_t colmv[64];         // [8][8] temporal scales (Python calc)
    int32_t tmv[64];
    int32_t fidx_curr[2][16];
    int32_t fidx_col[2][16];
    int32_t cb_qp_offset, cr_qp_offset;  // PPS offsets (deblock chroma)
};

struct Ctx;
static void quad_tree(Ctx &s, BitReader &r, int size_log2, int unavail,
                      int offset_x, int valid_x, int offset_y,
                      int valid_y, Neighbour *left, Neighbour *top,
                      Neighbour lefttop);
static void transform_tree(Ctx &s, BitReader &r, int size_log2,
                           int unavail, int depth, int upper_cbf,
                           int offset_x, int valid_x, int offset_y,
                           int valid_y, int idx, int pred_idx,
                           bool is_intra, Neighbour *left,
                           Neighbour *top);

struct Ctx {
    int cols, rows, ctb_log2, W, H;
    int pic_w, pic_h;          // cropped picture dims (colpics bounds)
    int col_stride, n16;       // 16x16 col grid
    int err;
    // persistent (h265d_ctu_t zero-init semantics)
    int32_t coeff_buf[32 * 32];
    int qpy;
    int qp_scale[3];
    int qpc_delta_c[2];
    Neighbour *ntop;           // [cols * 16]
    Neighbour nleft[18];
    SaoMapC *sao_map;          // [cols * rows], persistent
    Boundary boundary[2][8 * 17];
    Boundary *topedge;         // [cols * edgemax]
    int edgemax;
    int qp_history[2][17];
    ColCell *colpics[8];       // per pool slot
    // per-slice
    H265SliceParams sp;
    int pos_x, pos_y, idx_in_slice, valid_x, valid_y;
    int order_luma[4], order_chroma, intra_split, qp_delta_req;
    ColCell *col_curr, *col_ref;
    // CABAC
    uint32_t cab_range, cab_offset;
    int32_t cab_ctx[157];
    // plan outputs
    int16_t *coef_y, *coef_cb, *coef_cr;
    int16_t *tu_y, *tu_cb, *tu_cr;
    int8_t *slot;              // [H/4][W/4][2]
    int16_t *mv;               // [H/4][W/4][2][2]
    int32_t *ops_l, *opsl_cnt; // [nctu][capl][7], [nctu]
    int32_t *ops_c, *opsc_cnt;
    int opsl_cap, opsc_cap;
    int16_t *dbv, *dbh, *dbcv, *dbch;
};

// ---------------------------------------------------------------------
// CABAC engine (shared spec 9.3 engine, m2d.h:130-279 semantics)
// ---------------------------------------------------------------------
static void cabac_init_context(Ctx &s, int slice_qp, int idc) {
    for (int i = 0; i < 157; i++) {
        int m = H265_INIT_MN[(idc * 157 + i) * 2];
        int n = H265_INIT_MN[(idc * 157 + i) * 2 + 1];
        int pre = ((m * slice_qp) >> 4) + n;
        if (pre < 64) {
            if (pre <= 0) pre = 1;
            s.cab_ctx[i] = (63 - pre) * 2;
        } else {
            if (pre > 126) pre = 126;
            s.cab_ctx[i] = (pre - 64) * 2 + 1;
        }
    }
}

static void cabac_init_engine(Ctx &s, BitReader &r) {
    s.cab_range = 0x1FE;
    s.cab_offset = r.get(9);
}

static inline void cabac_renorm(Ctx &s, BitReader &r, uint32_t rng,
                                uint32_t off) {
    int bits = rng ? (9 - (32 - __builtin_clz(rng))) : 9;
    s.cab_range = rng << bits;
    s.cab_offset = (off << bits) | r.get(bits);
}

static int cabac_decision(Ctx &s, BitReader &r, int idx) {
    int c = s.cab_ctx[idx];
    int mps = c & 1;
    int st = c >> 1;
    uint32_t lps = RANGE_TAB_LPS[st * 4 + ((s.cab_range >> 6) & 3)];
    uint32_t rng = s.cab_range - lps;
    uint32_t off = s.cab_offset;
    if (off < rng) {
        s.cab_ctx[idx] = ((st + (st < 62)) * 2) | mps;
        if (rng >= 256) {
            s.cab_range = rng;
            return mps;
        }
    } else {
        off -= rng;
        rng = lps;
        s.cab_ctx[idx] = STATE_TRANS[st] ^ mps;
        mps ^= 1;
    }
    cabac_renorm(s, r, rng, off);
    return mps;
}

static int cabac_bypass(Ctx &s, BitReader &r) {
    uint32_t off = (s.cab_offset << 1) | r.get1();
    if (off < s.cab_range) {
        s.cab_offset = off;
        return 0;
    }
    s.cab_offset = off - s.cab_range;
    return 1;
}

static uint32_t cabac_multibypass(Ctx &s, BitReader &r, int num) {
    if (!num) return 0;
    uint64_t rng = s.cab_range;
    uint64_t off = ((uint64_t)s.cab_offset << num) | r.get(num);
    uint32_t out = 0;
    int n = num;
    while (n) {
        out *= 2;
        if (rng <= (off >> (n - 1))) {
            off -= rng << (n - 1);
            out |= 1;
        }
        n -= 1;
    }
    s.cab_offset = (uint32_t)off;
    return out;
}

static int cabac_terminate(Ctx &s, BitReader &r) {
    uint32_t rng = s.cab_range - 2;
    if (rng <= s.cab_offset) {
        s.cab_range = rng;
        return 1;
    }
    if (rng < 256)
        cabac_renorm(s, r, rng, s.cab_offset);
    else
        s.cab_range = rng;
    return 0;
}

// context-bank offsets (cabac_tables.py / h265d_cabac_context_t)
enum {
    CTX_SAO_MERGE = 0, CTX_SAO_TYPE = 1, CTX_SPLIT_CU = 2,
    CTX_CU_SKIP = 6, CTX_PRED_MODE = 9, CTX_PART_MODE = 10,
    CTX_PREV_INTRA = 14, CTX_CHROMA_MODE = 15, CTX_RQT_ROOT = 16,
    CTX_MERGE_FLAG = 17, CTX_MERGE_IDX = 18, CTX_INTER_IDC = 19,
    CTX_REF_IDX = 24, CTX_MVP_FLAG = 26, CTX_SPLIT_TR = 27,
    CTX_CBF_LUMA = 30, CTX_CBF_CHROMA = 32, CTX_MVD_GT = 36,
    CTX_TSKIP = 40, CTX_LAST_X = 42, CTX_LAST_Y = 60, CTX_CSBF = 78,
    CTX_SIG = 82, CTX_GT1 = 124, CTX_GT2 = 148,
};

// -- syntax readers (cabac.py) -----------------------------------------
static int se_split_cu(Ctx &s, BitReader &r, int size_log2, int ld,
                       int td) {
    int inc = (6 < size_log2 + ld) + (6 < size_log2 + td);
    return cabac_decision(s, r, CTX_SPLIT_CU + inc);
}

static int se_merge_idx(Ctx &s, BitReader &r, int maxidx) {
    if (maxidx <= 1 || !cabac_decision(s, r, CTX_MERGE_IDX)) return 0;
    int idx = 1;
    while (idx < maxidx - 1 && cabac_bypass(s, r)) idx++;
    return idx;
}

static int se_mpm_idx(Ctx &s, BitReader &r) {
    if (!cabac_bypass(s, r)) return 0;
    return 1 + cabac_bypass(s, r);
}

static int se_rem_intra(Ctx &s, BitReader &r, const int *cand) {
    int mode = (int)cabac_multibypass(s, r, 5);
    int sorted[3] = {cand[0], cand[1], cand[2]};
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2 - i; j++)
            if (sorted[j] > sorted[j + 1]) {
                int t = sorted[j]; sorted[j] = sorted[j + 1];
                sorted[j + 1] = t;
            }
    for (int i = 0; i < 3; i++) mode += (sorted[i] <= mode);
    return mode;
}

static int se_chroma_mode(Ctx &s, BitReader &r) {
    if (cabac_decision(s, r, CTX_CHROMA_MODE))
        return (int)cabac_multibypass(s, r, 2);
    return 4;
}

static int se_part_mode_inter(Ctx &s, BitReader &r, int size_log2,
                              int min_size_log2, int amp) {
    auto inter0 = [&]() {
        if (cabac_decision(s, r, CTX_PART_MODE)) return 0;
        return 2 - cabac_decision(s, r, CTX_PART_MODE + 1);
    };
    if (min_size_log2 < size_log2) {
        if (!amp) return inter0();
        int base = inter0();
        if (base == 0 || cabac_decision(s, r, CTX_PART_MODE + 3))
            return base;
        return (base + 1) * 2 + cabac_bypass(s, r);
    }
    if (size_log2 == 3) return inter0();
    int base = inter0();
    if (base < 2) return base;
    return base + (cabac_decision(s, r, CTX_PART_MODE + 2) ^ 1);
}

static int se_inter_pred_idc(Ctx &s, BitReader &r, int width, int height,
                             int depth) {
    if (width + height != 12
        && cabac_decision(s, r, CTX_INTER_IDC + depth))
        return 2;
    return cabac_decision(s, r, CTX_INTER_IDC + 4);
}

static int se_ref_idx(Ctx &s, BitReader &r, int lx, const int32_t *nri) {
    int num = nri[lx];
    if (num <= 0) return 0;
    int idx = 0;
    int lim = num < 2 ? num : 2;
    while (idx < lim) {
        if (!cabac_decision(s, r, CTX_REF_IDX + idx)) return idx;
        idx++;
    }
    while (idx < num) {
        if (!cabac_bypass(s, r)) break;
        idx++;
    }
    return idx;
}

static int se_abs_mvd_minus2(Ctx &s, BitReader &r) {
    int bits = 0;
    while (cabac_bypass(s, r)) bits++;
    return (2 << bits) - 2 + (int)cabac_multibypass(s, r, bits + 1);
}

static void se_mvd_coding(Ctx &s, BitReader &r, int mvd[2]) {
    int m0 = cabac_decision(s, r, CTX_MVD_GT);
    int m1 = cabac_decision(s, r, CTX_MVD_GT);
    if (m0) m0 += cabac_decision(s, r, CTX_MVD_GT + 1);
    if (m1) m1 += cabac_decision(s, r, CTX_MVD_GT + 1);
    int v[2] = {m0, m1};
    for (int k = 0; k < 2; k++) {
        if (v[k]) {
            if (v[k] > 1) v[k] += se_abs_mvd_minus2(s, r);
            if (cabac_bypass(s, r)) v[k] = -v[k];
        }
    }
    mvd[0] = v[0];
    mvd[1] = v[1];
}

static int se_last_prefix(Ctx &s, BitReader &r, int base, int shift,
                          int maxval) {
    int idx = 0;
    while (idx < maxval) {
        if (!cabac_decision(s, r, base + (idx >> shift))) break;
        idx++;
    }
    return idx;
}

static int se_last_suffix(Ctx &s, BitReader &r, int prefix) {
    if (prefix < 4) return prefix;
    return PREFIX_ADJ[prefix - 4]
        + (int)cabac_multibypass(s, r, (prefix >> 1) - 1);
}

static int se_coeff_remaining(Ctx &s, BitReader &r, int rice) {
    int i = 0;
    while (i < 20 && cabac_bypass(s, r)) i++;
    if (i < 4)
        return rice ? ((i << rice) + (int)cabac_multibypass(s, r, rice))
                    : i;
    i -= 4;
    return (1 << (i + rice + 1)) + (2 << rice)
        + (int)cabac_multibypass(s, r, i + rice + 1);
}

}  // namespace

namespace {

// ---------------------------------------------------------------------
// residual (residual.py residual_coding + plan sanitization)
// ---------------------------------------------------------------------
static inline int sat16i(int v) {
    return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

static void qp_to_scale_c(Ctx &s, int qpy, const int32_t *qpc_delta) {
    s.qp_scale[0] = QP_SCALE_TAB[qpy];
    for (int c = 0; c < 2; c++) {
        int q = qpy + qpc_delta[c];
        q %= 52;
        if (q < 0) q += 52;
        s.qp_scale[1 + c] = QP_SCALE_TAB[QPC_ADJ_TAB[q]];
    }
}

static void residual_coding(Ctx &s, BitReader &r, int size_log2,
                            int colour, int y0, int x0, int order_idx,
                            bool is_intra) {
    bool tskip = false;
    if (size_log2 == 2 && s.sp.transform_skip
        && cabac_decision(s, r, CTX_TSKIP + ((colour + 1) >> 1)))
        tskip = true;
    int maxpre = size_log2 * 2 - 1;
    int raw = LAST_SIG_PARAM[((colour + 1) >> 1) * 4 + (size_log2 - 2)];
    int ofs = raw & 15, shift = raw >> 4;
    int px = se_last_prefix(s, r, CTX_LAST_X + ofs, shift, maxpre);
    int py = se_last_prefix(s, r, CTX_LAST_Y + ofs, shift, maxpre);
    int last_x = se_last_suffix(s, r, px);
    int last_y = se_last_suffix(s, r, py);
    int32_t *coeff = s.coeff_buf;
    int size = 1 << size_log2;
    if (last_x || last_y)
        memset(coeff, 0, sizeof(int32_t) << (size_log2 * 2));
    if (order_idx == 2) { int t = last_x; last_x = last_y; last_y = t; }
    int si = size_log2 - 2;
    const int32_t *sub_num = &SCAN_SUB_NUM[(order_idx * 4 + si) * 64];
    const int32_t *sub_pos = &SCAN_SUB_POS[(order_idx * 4 + si) * 64];
    const int32_t *mxy = &SCAN_MACRO_XY[(order_idx * 4 + si) * 16];
    // SIG_INC_TBLIDX[order][colgrp][size][2][4]
    const int32_t *inc_idx = &SIG_INC_TBLIDX[
        ((order_idx * 2 + ((colour + 1) >> 1)) * 4 + si) * 8];
    int inc_ofs = SIG_INC_OFS[
        (order_idx * 2 + ((colour + 1) >> 1)) * 4 + si];
    int sub_log2 = size_log2 - 2;
    int pos_max = (1 << sub_log2) - 1;
    int last_sb = sub_num[((last_y >> 2) << sub_log2) + (last_x >> 2)];
    int i = last_sb;
    int greater1ctx = 1;
    int num = INNER_INV[order_idx * 16 + ((last_y & 3) << 2)
                        + (last_x & 3)];
    int scale = s.qp_scale[colour];
    uint32_t flags[9] = {0};
    int xy_pos_sum = 0;
    int sign_hiding = s.sp.sign_data_hiding;
    while (i >= 0) {
        int sxy = sub_pos[i];
        int sx = sxy & pos_max;
        int sy = sxy >> sub_log2;
        int prev_sbf = ((flags[sy] >> (sx + 1)) & 1)
            + (((flags[sy + 1] >> sx) & 1) * 2);
        bool coded;
        if ((uint32_t)(last_sb - 1) <= (uint32_t)(i - 1))
            coded = true;
        else {
            int inc = ((prev_sbf & 1) | (prev_sbf >> 1))
                + ((colour + 1) & 2);
            coded = cabac_decision(s, r, CTX_CSBF + inc);
        }
        if (coded) {
            flags[sy] |= 1u << sx;
            const int32_t *inc_tbl = &SIG_INC_TBL[
                inc_idx[(sxy != 0) * 4 + prev_sbf] * 16];
            int cpos[16], cval[16];
            int ncoef = 0;
            int pos = num;
            if (i == last_sb) { cpos[ncoef] = pos; cval[ncoef++] = 1;
                                pos--; }
            while (0 < pos) {
                if (cabac_decision(s, r, CTX_SIG + inc_ofs
                                   + inc_tbl[pos])) {
                    cpos[ncoef] = pos; cval[ncoef++] = 1;
                }
                pos--;
            }
            if (pos == 0 && ((ncoef == 0 && sxy)
                             || cabac_decision(s, r, CTX_SIG + inc_ofs
                                               + inc_tbl[0]))) {
                cpos[ncoef] = 0; cval[ncoef++] = 1;
            }
            if (ncoef == 0) break;
            int ctxset = (2 * (colour == 0 && i != 0))
                + (greater1ctx == 0);
            int g1ofs = ctxset * 4 + (colour == 0 ? 0 : 16);
            greater1ctx = 1;
            uint32_t max_flags = 0;
            int last_g1 = -1;
            int lim = ncoef < 8 ? ncoef : 8;
            for (int j = 0; j < lim; j++) {
                if (cabac_decision(s, r, CTX_GT1 + g1ofs + greater1ctx)) {
                    greater1ctx = 0;
                    cval[j] = 2;
                    if (last_g1 >= 0) max_flags |= 1u << j;
                    else last_g1 = j;
                } else if ((uint32_t)(greater1ctx - 1) < 2) {
                    greater1ctx++;
                }
            }
            if (last_g1 >= 0) {
                if (cabac_decision(s, r, CTX_GT2
                                   + (colour == 0 ? ctxset
                                                  : ctxset + 4))) {
                    cval[last_g1] = 3;
                    max_flags |= 1u << last_g1;
                }
            }
            if (ncoef > 8)
                max_flags |= ((1u << ncoef) - 1) & ~255u;
            int hidden = (sign_hiding
                          && 3 < cpos[0] - cpos[ncoef - 1]) ? 1 : 0;
            uint32_t sign_flags = cabac_multibypass(s, r, ncoef - hidden);
            int rice = 0;
            uint32_t sign_mask = 1u << (ncoef - 1 - hidden);
            int level_sum = 0;
            int write_pos = ((sy << (sub_log2 + 2)) + sx) * 4;
            uint32_t mf = max_flags;
            int last_wp = 0;
            for (int j = 0; j < ncoef; j++) {
                int abs_level = cval[j];
                if (mf & 1) {
                    abs_level += se_coeff_remaining(s, r, rice);
                    rice += ((3 << rice) < abs_level);
                    if (rice > 4) rice = 4;
                }
                level_sum += abs_level;
                last_wp = write_pos + mxy[cpos[j]];
                xy_pos_sum |= last_wp;
                int v = (sign_flags & sign_mask) ? -abs_level : abs_level;
                int64_t dq = ((int64_t)v * scale
                              + (1 << (size_log2 - 2))) >> (size_log2 - 1);
                coeff[last_wp] = sat16i((int)dq);
                sign_mask >>= 1;
                mf >>= 1;
            }
            if (hidden && (level_sum & 1))
                coeff[last_wp] = -coeff[last_wp];
        }
        num = 15;
        i--;
    }
    // -- sanitized plan write (plan.py PlanRecorder.residual) ----------
    bool use_dst = is_intra && colour == 0 && size_log2 == 2;
    int variant = ((size <= xy_pos_sum) ? 2 : 0)
        + ((xy_pos_sum & (size - 1)) != 0);
    int16_t *cp;
    int16_t *tu;
    int cw, tw;
    if (colour == 0) { cp = s.coef_y; tu = s.tu_y; cw = s.W;
                       tw = s.W >> 2; }
    else if (colour == 1) { cp = s.coef_cb; tu = s.tu_cb; cw = s.W >> 1;
                            tw = s.W >> 3; }
    else { cp = s.coef_cr; tu = s.tu_cr; cw = s.W >> 1; tw = s.W >> 3; }
    int16_t *dst = cp + y0 * cw + x0;
    for (int yy = 0; yy < size; yy++)
        memset(dst + yy * cw, 0, size * sizeof(int16_t));
    bool full = (tskip && xy_pos_sum) || (use_dst && variant != 0)
        || (!tskip && !use_dst && variant == 3);
    if (full) {
        for (int yy = 0; yy < size; yy++)
            for (int xx = 0; xx < size; xx++)
                dst[yy * cw + xx] = (int16_t)coeff[yy * size + xx];
    } else if (!tskip && !use_dst && variant == 1) {
        for (int xx = 0; xx < size; xx++)
            dst[xx] = (int16_t)coeff[xx];
    } else if (!tskip && !use_dst && variant == 2) {
        for (int yy = 0; yy < size; yy++)
            dst[yy * cw] = (int16_t)coeff[yy << size_log2];
    } else {
        dst[0] = (int16_t)coeff[0];
    }
    tu[(y0 >> 2) * tw + (x0 >> 2)] = (int16_t)(
        1 | ((size_log2 - 2) << 1) | (variant << 3)
        | ((use_dst ? 1 : 0) << 5) | ((tskip ? 1 : 0) << 6));
}

// ---------------------------------------------------------------------
// deblock recorder (deblock.py Deblocking minus the pixel filters)
// ---------------------------------------------------------------------
static void db_reset_slice(Ctx &s) {
    memset(s.boundary, 0, sizeof(s.boundary));
    memset(s.topedge, 0,
           sizeof(Boundary) * s.cols * s.edgemax);
}

static void db_fill_base(Ctx &s, int dirn, int offset_x, int offset_y,
                         int *base, int *ygap, int *org_y) {
    int n = s.edgemax;
    int xg = dirn == 0 ? 1 : (n * 2 + 1);
    int yg = dirn == 0 ? n : 1;
    int ox = offset_x >> 3;
    int oy = offset_y >> 2;
    *base = ox * xg + (oy + 1) * yg;
    *ygap = yg;
    *org_y = oy;
}

static void db_record_onedir(Ctx &s, int qpy, int dirn, int offset_x,
                             int offset_y, int unavail, int length) {
    if ((offset_x & 7) || (offset_x == 0 && ((unavail >> dirn) & 1)))
        return;
    int base, ygap, org_y;
    db_fill_base(s, dirn, offset_x, offset_y, &base, &ygap, &org_y);
    int qp = qpy + 1;
    for (int k = 0; k < length; k++) {
        Boundary &e = s.boundary[dirn][base + k * ygap];
        e.qp = (int16_t)((qp + s.qp_history[dirn][org_y + k]) >> 1);
        e.str = 2;
    }
}

static inline int db_strength_tu(const Neighbour &nb) {
    return nb.tu_intra ? 2 : (nb.tu_nonzero_coef ? 1 : 0);
}

static void db_record_tu_onedir(Ctx &s, int qpy, int dirn, int offset_x,
                                int offset_y, int unavail, int length,
                                int strength, const Neighbour *arr) {
    if ((offset_x & 7) || (offset_x == 0 && ((unavail >> dirn) & 1)))
        return;
    int base, ygap, org_y;
    db_fill_base(s, dirn, offset_x, offset_y, &base, &ygap, &org_y);
    int qp = qpy + 1;
    for (int k = 0; k < length; k++) {
        Boundary &e = s.boundary[dirn][base + k * ygap];
        e.qp = (int16_t)((qp + s.qp_history[dirn][org_y + k]) >> 1);
        int st = db_strength_tu(arr[k]);
        int mx = strength > st ? strength : st;
        if (e.str < mx) e.str = (int16_t)mx;
    }
}

static void db_record_tu(Ctx &s, int qpy, int size_log2, int offset_x,
                         int offset_y, int unavail, int strength,
                         const Neighbour *left, const Neighbour *top) {
    if (s.sp.deblock_disabled) return;
    int length = 1 << (size_log2 - 2);
    db_record_tu_onedir(s, qpy, 0, offset_x, offset_y, unavail, length,
                        strength, left);
    db_record_tu_onedir(s, qpy, 1, offset_y, offset_x, unavail, length,
                        strength, top);
}

static void db_record_tu_intra(Ctx &s, int qpy, int size_log2,
                               int offset_x, int offset_y, int unavail) {
    if (s.sp.deblock_disabled) return;
    int length = 1 << (size_log2 - 2);
    db_record_onedir(s, qpy, 0, offset_x, offset_y, unavail, length);
    db_record_onedir(s, qpy, 1, offset_y, offset_x, unavail, length);
}

static inline bool mv_diff_large(const int16_t a[2], const int16_t b[2]) {
    int dx = a[0] - b[0], dy = a[1] - b[1];
    return dx * dx >= 16 || dy * dy >= 16;
}

static int db_inter_strength(int nf0, int nf1, int cf0, int cf1,
                             const int16_t nmv[2][2],
                             const int16_t cmv[2][2], int n_sw,
                             int c_sw) {
    if (nf0 != cf0 || nf1 != cf1) return 1;
    if (nf0 == nf1) {
        return ((mv_diff_large(nmv[0], cmv[0])
                 || mv_diff_large(nmv[1], cmv[1]))
                && (mv_diff_large(nmv[0], cmv[1])
                    || mv_diff_large(nmv[1], cmv[0]))) ? 1 : 0;
    }
    return ((nf0 >= 0 && mv_diff_large(nmv[n_sw], cmv[c_sw]))
            || (nf1 >= 0 && mv_diff_large(nmv[n_sw ^ 1],
                                          cmv[c_sw ^ 1]))) ? 1 : 0;
}

static inline int refidx_to_frameidx(Ctx &s, int refidx, int lx) {
    return refidx >= 0 ? s.sp.ref_fidx[lx][refidx] : -1;
}

static void db_record_pu_onedir(Ctx &s, int qpy, int dirn, int offset_x,
                                int offset_y, int unavail, int length,
                                const Neighbour *arr, int refidx0,
                                int refidx1, const int16_t mvxy[2][2]) {
    if ((offset_x & 7) || (offset_x == 0 && ((unavail >> dirn) & 1)))
        return;
    int frm0 = refidx_to_frameidx(s, refidx0, 0);
    int frm1 = refidx_to_frameidx(s, refidx1, 1);
    int c_sw = 0;
    if (frm0 < frm1) { int t = frm0; frm0 = frm1; frm1 = t; c_sw = 1; }
    int base, ygap, org_y;
    db_fill_base(s, dirn, offset_x, offset_y, &base, &ygap, &org_y);
    int qp = qpy + 1;
    for (int i = 0; i < (length >> 2); i++) {
        Boundary &e = s.boundary[dirn][base + i * ygap];
        e.qp = (int16_t)((qp + s.qp_history[dirn][org_y + i]) >> 1);
        const Neighbour &nb = arr[i];
        int st;
        if (nb.pu_intra) st = 2;
        else if (nb.pu_nonzero_coef) st = 1;
        else {
            int nf0 = refidx_to_frameidx(s, nb.pred.ref[0], 0);
            int nf1 = refidx_to_frameidx(s, nb.pred.ref[1], 1);
            int n_sw = 0;
            if (nf0 < nf1) { int t = nf0; nf0 = nf1; nf1 = t; n_sw = 1; }
            st = db_inter_strength(nf0, nf1, frm0, frm1, nb.pred.mv,
                                   mvxy, c_sw, n_sw);
        }
        e.str = (int16_t)st;
    }
}

static void db_record_pu(Ctx &s, int qpy, int width, int height,
                         int offset_x, int offset_y, int unavail,
                         const Neighbour *left, const Neighbour *top,
                         int refidx0, int refidx1,
                         const int16_t mvxy[2][2]) {
    if (s.sp.deblock_disabled) return;
    db_record_pu_onedir(s, qpy, 0, offset_x, offset_y, unavail, height,
                        left, refidx0, refidx1, mvxy);
    db_record_pu_onedir(s, qpy, 1, offset_y, offset_x, unavail, width,
                        top, refidx0, refidx1, mvxy);
}

static inline int clip2i(int v, int lim) {
    return v < 0 ? 0 : (v > lim ? lim : v);
}

// emit one vertical/horizontal luma edge record (the filter-time
// parameter resolution of deblock.py:_edge_luma_block, minus pixels)
static void db_emit_luma(Ctx &s, const Boundary &e, int beta_ofs,
                         int tc_ofs, int y, int x, bool vert) {
    if (e.str == 0) return;
    int qp = e.qp;
    int beta_qp = (beta_ofs ? clip2i(qp + beta_ofs, 51) : qp) - 16;
    if (beta_qp < 0) return;
    int ofs = tc_ofs + (e.str & 2);
    int tc_qp = (ofs ? clip2i(qp + ofs, 51) : qp) - 16;
    if (tc_qp < 0) return;
    int h = s.H, w = s.W;
    if (vert) {
        if (!(0 <= y && y + 3 < h && 0 <= x && x + 7 < w)) return;
        int16_t *d = s.dbv + ((y >> 2) * (s.W >> 3) + ((x - 4) >> 3)) * 3;
        d[0] = e.str; d[1] = (int16_t)Q_THR_TAB[beta_qp * 2];
        d[2] = (int16_t)Q_THR_TAB[tc_qp * 2 + 1];
    } else {
        if (!(0 <= x && x + 3 < w && 0 <= y && y + 7 < h)) return;
        int16_t *d = s.dbh + (((y - 4) >> 3) * (s.W >> 2) + (x >> 2)) * 3;
        d[0] = e.str; d[1] = (int16_t)Q_THR_TAB[beta_qp * 2];
        d[2] = (int16_t)Q_THR_TAB[tc_qp * 2 + 1];
    }
}

static void db_emit_chroma(Ctx &s, int qp, int qpc_offset, int tc_ofs,
                           int ci, int y, int x, bool vert) {
    int q = QPC_ADJ12_TAB[qp + qpc_offset + 12];
    q = clip2i(q + 2 + tc_ofs, 53) - 16;
    if (q < 0) return;
    int tc = Q_THR_TAB[q * 2 + 1];
    int h = s.H >> 1, w = s.W >> 1;
    if (vert) {
        if (!(0 <= y && y + 1 < h && 0 <= x && x + 3 < w)) return;
        s.dbcv[((y >> 1) * (s.W >> 4) + ((x - 6) >> 3)) * 2 + ci] =
            (int16_t)tc;
    } else {
        if (!(0 <= x && x + 1 < w && 0 <= y && y + 3 < h)) return;
        s.dbch[(((y - 6) >> 3) * (s.W >> 2) + (x >> 1)) * 2 + ci] =
            (int16_t)tc;
    }
}

static void db_pre(Ctx &s) {
    int n = s.edgemax;
    int base = s.pos_x * n;
    for (int k = 0; k < n; k++)
        s.boundary[0][k] = s.topedge[base + k];
}

static void db_post(Ctx &s) {
    int n = s.edgemax;
    if (s.pos_x < s.cols - 1) {
        Boundary *left = s.boundary[1];
        int p = 0, ln = n * 2;
        for (int j = 0; j < n; j++) {
            left[p] = left[p + ln];
            for (int k = 1; k <= ln; k++)
                left[p + k] = Boundary{0, 0};
            p += ln + 1;
        }
    } else {
        for (int k = 0; k < 8 * 17; k++)
            s.boundary[1][k] = Boundary{0, 0};
    }
    int base = s.pos_x * n;
    for (int k = 0; k < n; k++)
        s.topedge[base + k] = s.boundary[0][n * n * 2 + k];
    for (int k = n; k < 8 * 17; k++)
        s.boundary[0][k] = Boundary{0, 0};
}

static void deblock_ctu(Ctx &s, int cb_qp_offset, int cr_qp_offset) {
    if (s.sp.deblock_disabled) return;
    int n = s.edgemax;
    db_pre(s);
    int beta_ofs = s.sp.beta_offset_div2 * 2;
    int tc_ofs = s.sp.tc_offset_div2 * 2;
    int y_ctu = s.pos_y << s.ctb_log2;
    int x_ctu = s.pos_x << s.ctb_log2;
    int ly = y_ctu - 4, lx = x_ctu - 4;
    int blkv = n * 2 + (s.pos_y == s.rows - 1);
    int blkh = n * 2 + (s.pos_x == s.cols - 1);
    for (int by = 0; by < blkv; by++)
        for (int ex = 0; ex < n; ex++)
            db_emit_luma(s, s.boundary[0][by * n + ex], beta_ofs,
                         tc_ofs, ly + by * 4, lx + ex * 8, true);
    int p = 0;
    for (int ey = 0; ey < n; ey++) {
        for (int bx = 0; bx < blkh; bx++)
            db_emit_luma(s, s.boundary[1][p + bx], beta_ofs, tc_ofs,
                         ly + ey * 8, lx + bx * 4, false);
        p += n * 2 + 1;
    }
    int cy = (y_ctu >> 1) - 2, cx = (x_ctu >> 1) - 2;
    for (int by = 0; by < blkv; by++)
        for (int ex = 0; ex < (n >> 1); ex++) {
            const Boundary &e = s.boundary[0][by * n + ex * 2];
            if (e.str == 2) {
                db_emit_chroma(s, e.qp, cb_qp_offset, tc_ofs, 0,
                               cy + by * 2, cx + ex * 8, true);
                db_emit_chroma(s, e.qp, cr_qp_offset, tc_ofs, 1,
                               cy + by * 2, cx + ex * 8, true);
            }
        }
    p = 0;
    for (int ey = 0; ey < (n >> 1); ey++) {
        for (int bx = 0; bx < blkh; bx++) {
            const Boundary &e = s.boundary[1][p + bx];
            if (e.str == 2) {
                db_emit_chroma(s, e.qp, cb_qp_offset, tc_ofs, 0,
                               cy + ey * 8, cx + bx * 2, false);
                db_emit_chroma(s, e.qp, cr_qp_offset, tc_ofs, 1,
                               cy + ey * 8, cx + bx * 2, false);
            }
        }
        p += 2 * (n * 2 + 1);
    }
    db_post(s);
}

// ---------------------------------------------------------------------
// SAO parse (sao.py sao_read; maps persistent across pictures)
// ---------------------------------------------------------------------
static int sao_offset_abs(Ctx &s, BitReader &r, int max_bits) {
    int bits = max_bits;
    while (bits) {
        if (cabac_bypass(s, r) == 0) break;
        bits--;
    }
    return max_bits - bits;
}

static void sao_band_tail(Ctx &s, BitReader &r, int8_t off[4],
                          int8_t *opt) {
    for (int j = 0; j < 4; j++)
        if (off[j] && cabac_bypass(s, r)) off[j] = -off[j];
    *opt = (int8_t)cabac_multibypass(s, r, 5);
}

static void sao_read_offsets(Ctx &s, BitReader &r, int8_t off[4],
                             int8_t *opt, int idx) {
    for (int j = 0; j < 4; j++)
        off[j] = (int8_t)sao_offset_abs(s, r, 7);
    if (idx == 1) {
        sao_band_tail(s, r, off, opt);
    } else {
        *opt = (int8_t)cabac_multibypass(s, r, 2);
        off[2] = -off[2];
        off[3] = -off[3];
    }
}

static void sao_read(Ctx &s, BitReader &r) {
    SaoMapC *maps = s.sao_map;
    int i = s.pos_y * s.cols + s.pos_x;
    SaoMapC &m = maps[i];
    m.merge_left = 0;
    if (s.pos_x != 0) {
        m.merge_left = (int8_t)cabac_decision(s, r, CTX_SAO_MERGE);
        if (m.merge_left) return;
    }
    if (s.pos_y != 0) {
        if (cabac_decision(s, r, CTX_SAO_MERGE)) {
            int j = i - s.cols;
            int steps = s.pos_x;
            while (steps && maps[j].merge_left) { j--; steps--; }
            m.luma_idx = maps[j].luma_idx;
            m.chroma_idx = maps[j].chroma_idx;
            memcpy(m.off, maps[j].off, sizeof(m.off));
            memcpy(m.opt, maps[j].opt, sizeof(m.opt));
            return;
        }
    }
    m.luma_idx = 0;
    if (s.sp.sao_luma) {
        int idx = 0;
        if (cabac_decision(s, r, CTX_SAO_TYPE))
            idx = 1 + cabac_bypass(s, r);
        if (idx) {
            m.luma_idx = (int8_t)idx;
            sao_read_offsets(s, r, m.off[0], &m.opt[0], idx);
        }
    }
    m.chroma_idx = 0;
    if (s.sp.sao_chroma) {
        int idx = 0;
        if (cabac_decision(s, r, CTX_SAO_TYPE))
            idx = 1 + cabac_bypass(s, r);
        if (idx) {
            m.chroma_idx = (int8_t)idx;
            sao_read_offsets(s, r, m.off[1], &m.opt[1], idx);
            for (int j = 0; j < 4; j++)
                m.off[2][j] = (int8_t)sao_offset_abs(s, r, 7);
            if (idx == 1) {
                sao_band_tail(s, r, m.off[2], &m.opt[2]);
            } else {
                m.opt[2] = m.opt[1];
                m.off[2][2] = -m.off[2][2];
                m.off[2][3] = -m.off[2][3];
            }
        }
    }
}

}  // namespace

namespace {

// ---------------------------------------------------------------------
// intra (ctu.py pred_intra / _intra_luma / _intra_chroma: Phase A only
// emits z-ordered op records; Phase B predicts the pixels)
// ---------------------------------------------------------------------
static inline int minu(int64_t v, int b) {
    uint32_t u = (uint32_t)v;
    return u < (uint32_t)b ? (int)u : b;
}

static void emit_op(Ctx &s, bool luma, int y0, int x0, int sl2, int mode,
                    int vx, int vy) {
    int ci = s.pos_y * s.cols + s.pos_x;
    int used = 1;
    if (luma && mode == 1 && sl2 < 5 && vx > 0 && vy <= 0
        && y0 + (1 << sl2) < s.H)
        used |= 2;  // DC top-only stray-row candidate
    int32_t *cnt = luma ? s.opsl_cnt : s.opsc_cnt;
    int cap = luma ? s.opsl_cap : s.opsc_cap;
    if (cnt[ci] >= cap) { s.err = -10; return; }
    int32_t *buf = (luma ? s.ops_l : s.ops_c)
        + ((int64_t)ci * cap + cnt[ci]) * 7;
    buf[0] = used; buf[1] = y0; buf[2] = x0; buf[3] = sl2;
    buf[4] = mode; buf[5] = vx; buf[6] = vy;
    cnt[ci]++;
}

static void intra_pred_candidate(int a, int b, int cand[3]) {
    if (a == b) {
        if (a <= 1) { cand[0] = 0; cand[1] = 1; cand[2] = 26; return; }
        cand[0] = a;
        cand[1] = ((a - 3) & 31) + 2;
        cand[2] = ((a - 1) & 31) + 2;
        return;
    }
    int c;
    if (a != 0 && b != 0) c = 0;
    else if (a != 1 && b != 1) c = 1;
    else c = 26;
    cand[0] = a; cand[1] = b; cand[2] = c;
}

static int intra_chroma_dir(int idx, int luma_mode) {
    switch (idx) {
    case 0: return luma_mode == 0 ? 34 : 0;
    case 1: return luma_mode == 26 ? 34 : 26;
    case 2: return luma_mode == 10 ? 34 : 10;
    case 3: return luma_mode == 1 ? 34 : 1;
    }
    return luma_mode;
}

static inline int order_map_c(int idx) {
    idx = (idx - 6) & 31;
    return ((idx & 15) <= 8 ? 1 : 0) << (idx <= 15 ? 1 : 0);
}

// ---------------------------------------------------------------------
// colpics (colpics.py)
// ---------------------------------------------------------------------
static int scale_mv_c(int mv, int scale) {
    int64_t v = (int64_t)mv * scale;
    if (v >= 0) {
        v = (v + 127) >> 8;
        return v > 32767 ? 32767 : (int)v;
    }
    v = -((127 - v) >> 8);
    return v < -32768 ? -32768 : (int)v;
}

static inline int colmv_scale(Ctx &s, int lx_a, int ri_a, int lx_b,
                              int ri_b) {
    return s.sp.colmv[s.sp.fidx_curr[lx_a][ri_a] * 8
                      + s.sp.fidx_col[lx_b][ri_b]];
}

static inline int tmv_scale(Ctx &s, int lx_a, int ri_a, int lx_b,
                            int ri_b) {
    return s.sp.tmv[s.sp.fidx_curr[lx_a][ri_a] * 8
                    + s.sp.fidx_curr[lx_b][ri_b]];
}

static const ColCell *col_get_ref(Ctx &s, int offset_x, int offset_y,
                                  int width, int height) {
    int base_x = s.pos_x << s.ctb_log2;
    int base_y = s.pos_y << s.ctb_log2;
    int brx = offset_x + width;
    int bry = offset_y + height;
    if (!(bry >> s.ctb_log2) && base_x + brx < s.pic_w
        && base_y + bry < s.pic_h) {
        const ColCell &c = s.col_ref[
            ((base_y + bry) >> 4) * s.col_stride + ((base_x + brx) >> 4)];
        if (!c.pu_intra) return &c;
    }
    brx = offset_x + (width >> 1);
    bry = offset_y + (height >> 1);
    return &s.col_ref[((base_y + bry) >> 4) * s.col_stride
                      + ((base_x + brx) >> 4)];
}

static void col_fill(Ctx &s, int offset_x, int offset_y, int width,
                     int height, bool intra, const PredInfo *pred,
                     int ref0, int ref1) {
    int base_x = s.pos_x << s.ctb_log2;
    int base_y = s.pos_y << s.ctb_log2;
    for (int y = offset_y; y < offset_y + height; y += 4) {
        if ((base_y + y) & 15) continue;
        for (int x = offset_x; x < offset_x + width; x += 4) {
            if ((base_x + x) & 15) continue;
            ColCell &c = s.col_curr[((base_y + y) >> 4) * s.col_stride
                                    + ((base_x + x) >> 4)];
            if (intra) {
                c.pu_intra = 1;
            } else {
                c.pu_intra = 0;
                c.ref[0] = (int8_t)ref0;
                c.ref[1] = (int8_t)ref1;
                memcpy(c.mv, pred->mv, sizeof(c.mv));
            }
        }
    }
}

// ---------------------------------------------------------------------
// inter CU (inter_cu.py)
// ---------------------------------------------------------------------
static inline int i16wrap(int v) {
    return ((v + 0x8000) & 0xFFFF) - 0x8000;
}

static bool merge_available(int cx, int cy, int px, int py, int sh) {
    return ((cx >> sh) != (px >> sh)) || ((cy >> sh) != (py >> sh));
}

static void add_merge_cand(PredInfo *lst, int *n, int cx, int cy, int nx,
                           int ny, int par, const Neighbour &nb) {
    if (nb.pu_intra || !merge_available(cx, cy, nx, ny, par)) return;
    for (int i = 0; i < *n; i++)
        if (lst[i].same(nb.pred)) return;
    lst[(*n)++] = nb.pred;
}

static void add_colpic_cand(Ctx &s, PredInfo &p, const ColCell *col,
                            int lx, int ref_idx) {
    int col_lx = s.sp.lowdelay ? lx : s.sp.colocated_from_l0;
    int col_ri = col->ref[col_lx];
    if (col_ri < 0) {
        col_lx ^= 1;
        col_ri = col->ref[col_lx];
    }
    p.ref[lx] = (int8_t)ref_idx;
    int sc = colmv_scale(s, lx, ref_idx, col_lx, col_ri);
    p.mv[lx][0] = (int16_t)scale_mv_c(col->mv[col_lx][0], sc);
    p.mv[lx][1] = (int16_t)scale_mv_c(col->mv[col_lx][1], sc);
}

static void merge_zero_mv(Ctx &s, int idx, int num, PredInfo &p) {
    bool p_slice = s.sp.slice_type > 0;
    int nri;
    if (p_slice) nri = s.sp.num_ref_idx_minus1[0] + 1;
    else nri = (s.sp.num_ref_idx_minus1[0] < s.sp.num_ref_idx_minus1[1]
                ? s.sp.num_ref_idx_minus1[0]
                : s.sp.num_ref_idx_minus1[1]) + 1;
    int m = idx - num;
    int ref = m < nri ? m : 0;
    p.reset();
    p.ref[0] = (int8_t)ref;
    p.ref[1] = (int8_t)(p_slice ? -1 : ref);
}

static void add_combined(Ctx &s, PredInfo *lst, int *n, int idx_max) {
    int idx = *n;
    int cutoff = idx * (idx - 1);
    for (int comb = 0; comb < cutoff; comb++) {
        int l0i = L0_CAND_IDX[comb];
        int l1i = L0_CAND_IDX[comb ^ 1];
        if (idx_max <= l0i || idx_max <= l1i) break;
        const PredInfo &c0 = lst[l0i];
        const PredInfo &c1 = lst[l1i];
        if (c0.ref[0] >= 0 && c1.ref[1] >= 0) {
            bool mv_diff = c0.mv[0][0] != c1.mv[1][0]
                || c0.mv[0][1] != c1.mv[1][1];
            if (mv_diff || s.sp.ref_poc[0][c0.ref[0]]
                           != s.sp.ref_poc[1][c1.ref[1]]) {
                PredInfo p;
                p.mv[0][0] = c0.mv[0][0]; p.mv[0][1] = c0.mv[0][1];
                p.mv[1][0] = c1.mv[1][0]; p.mv[1][1] = c1.mv[1][1];
                p.ref[0] = c0.ref[0];
                p.ref[1] = c1.ref[1];
                lst[(*n)++] = p;
                idx++;
                if (idx_max < idx) break;
            }
        }
    }
}

static int merge_list_c(Ctx &s, int idx, int unavail, int ox, int oy,
                        int width, int height, const Neighbour *left,
                        const Neighbour *top, const Neighbour &lefttop,
                        PredInfo &out) {
    int par = s.sp.log2_parallel_merge;
    PredInfo lst[12];
    int n = 0;
    if (!(unavail & 1))
        add_merge_cand(lst, &n, ox, oy, ox - 1, oy + height - 1, par,
                       left[(height >> 2) - 1]);
    if (n <= idx) {
        if (!(unavail & 2))
            add_merge_cand(lst, &n, ox, oy, ox + width - 1, oy - 1, par,
                           top[(width >> 2) - 1]);
        if (!(unavail & 8))
            add_merge_cand(lst, &n, ox, oy, ox + width, oy - 1, par,
                           top[width >> 2]);
        if (!(unavail & 4))
            add_merge_cand(lst, &n, ox, oy, ox - 1, oy + height, par,
                           left[height >> 2]);
        if (n <= idx && n < 4)
            add_merge_cand(lst, &n, ox, oy, ox - 1, oy - 1, par, lefttop);
    }
    if (n <= idx && s.sp.temporal_mvp) {
        const ColCell *col = col_get_ref(s, ox, oy, width, height);
        if (!col->pu_intra) {
            if (s.sp.slice_type != 0)
                return -3;  // reference-indeterminate: P temporal merge
            PredInfo p;
            p.reset();
            add_colpic_cand(s, p, col, 0, 0);
            add_colpic_cand(s, p, col, 1, 0);
            lst[n++] = p;
        }
    }
    if (1 < n && n <= idx && s.sp.slice_type == 0)
        add_combined(s, lst, &n, idx);
    while (n <= idx) {
        merge_zero_mv(s, idx, n, lst[n]);
        n++;
    }
    out = lst[idx];
    return 0;
}

// -- AMVP (inter_cu.py calc_mv machinery) ------------------------------
struct MvpState { bool skip2nd, match2nd; int mvp2[2]; };

static void mvp2nd(Ctx &s, int lx, int refidx, const PredInfo &np,
                   int out[2]) {
    int lx_i = lx;
    for (int k = 0; k < 2; k++) {
        int nri = np.ref[lx_i];
        if (nri >= 0) {
            int sc = tmv_scale(s, lx, refidx, lx_i, nri);
            out[0] = scale_mv_c(np.mv[lx_i][0], sc);
            out[1] = scale_mv_c(np.mv[lx_i][1], sc);
            return;
        }
        lx_i ^= 1;
    }
    out[0] = out[1] = 0;
}

static const int16_t *find_spatial_mvp(Ctx &s, const Neighbour &nb,
                                       int lx, int refpoc, int ref_idx,
                                       MvpState &st) {
    if (nb.pu_intra) return nullptr;
    int lx_i = lx;
    for (int k = 0; k < 2; k++) {
        int nri = nb.pred.ref[lx_i];
        if (nri >= 0) {
            int npoc = s.sp.ref_poc[lx_i][nri];
            if (npoc == refpoc) {
                st.skip2nd = true;
                return nb.pred.mv[lx_i];
            }
            if (!st.skip2nd && !st.match2nd) {
                mvp2nd(s, lx, ref_idx, nb.pred, st.mvp2);
                st.match2nd = true;
            }
        }
        lx_i ^= 1;
    }
    st.skip2nd = true;
    return nullptr;
}

static bool mvp_one_dir(Ctx &s, int unavail, const Neighbour *arr,
                        const Neighbour *lefttop, int span, int lx,
                        int ref_idx, MvpState &st, int out[2]) {
    int dir_flag = lefttop ? (unavail >> 1) : unavail;
    int refpoc = s.sp.ref_poc[lx][ref_idx];
    st.match2nd = false;
    span >>= 2;
    const int16_t *mv;
    if (!(dir_flag & 4)) {
        mv = find_spatial_mvp(s, arr[span], lx, refpoc, ref_idx, st);
        if (mv) { out[0] = mv[0]; out[1] = mv[1]; return true; }
    }
    if (!(dir_flag & 1)) {
        mv = find_spatial_mvp(s, arr[span - 1], lx, refpoc, ref_idx, st);
        if (mv) { out[0] = mv[0]; out[1] = mv[1]; return true; }
    }
    if (lefttop && !(unavail & 3)) {
        mv = find_spatial_mvp(s, *lefttop, lx, refpoc, ref_idx, st);
        if (mv) { out[0] = mv[0]; out[1] = mv[1]; return true; }
    }
    if (st.match2nd) {
        out[0] = st.mvp2[0];
        out[1] = st.mvp2[1];
        return true;
    }
    return false;
}

static bool add_mvp(const int mv[2], int (*lst)[2], int *n, int mvp_idx) {
    for (int i = 0; i < *n; i++)
        if (lst[i][0] == mv[0] && lst[i][1] == mv[1]) return false;
    lst[*n][0] = mv[0];
    lst[(*n)++][1] = mv[1];
    return mvp_idx < *n;
}

static void calc_mv_c(Ctx &s, int unavail, int width, int height,
                      const Neighbour *left, const Neighbour *top,
                      const Neighbour &lefttop, int lx, int ref_idx,
                      int mvp_idx, const int mvd[2], const ColCell *col,
                      int16_t out[2]) {
    int lst[4][2];
    int n = 0;
    MvpState st = {false, false, {0, 0}};
    int mv[2];
    bool got = mvp_one_dir(s, unavail, left, nullptr, height, lx,
                           ref_idx, st, mv);
    if (!got || !add_mvp(mv, lst, &n, mvp_idx)) {
        got = mvp_one_dir(s, unavail, top, &lefttop, width, lx, ref_idx,
                          st, mv);
        if (!got || !add_mvp(mv, lst, &n, mvp_idx)) {
            bool ok = false;
            if (col) {
                PredInfo p;
                p.reset();
                add_colpic_cand(s, p, col, lx, ref_idx);
                int side = p.ref[lx] >= 0 ? lx : (lx ^ 1);
                int cmv[2] = {p.mv[side][0], p.mv[side][1]};
                ok = add_mvp(cmv, lst, &n, mvp_idx);
            }
            if (!ok)
                while (n < 2) { lst[n][0] = lst[n][1] = 0; n++; }
        }
    }
    out[0] = (int16_t)i16wrap(mvd[0] + lst[mvp_idx][0]);
    out[1] = (int16_t)i16wrap(mvd[1] + lst[mvp_idx][1]);
}

// -- MC recording (dense per-4x4-cell slot/mv, plan.py inter) ----------
static void record_mc(Ctx &s, int offset_x, int offset_y, int width,
                      int height, const PredInfo &pred, bool no_bidir) {
    int x0 = (s.pos_x << s.ctb_log2) + offset_x;
    int y0 = (s.pos_y << s.ctb_log2) + offset_y;
    int ref0 = pred.ref[0], ref1 = pred.ref[1];
    bool bidir = ref0 >= 0 && ref1 >= 0 && !no_bidir;
    int s0 = ref0 >= 0 ? s.sp.ref_fidx[0][ref0] : -1;
    int s1 = (ref1 >= 0 && bidir) ? s.sp.ref_fidx[1][ref1] : -1;
    if (s0 < 0 && !bidir && ref1 >= 0)
        s1 = s.sp.ref_fidx[1][ref1];  // uni-L1 routes through slot1
    int cw = s.W >> 2;
    for (int cy = y0 >> 2; cy < (y0 + height) >> 2; cy++)
        for (int cx = x0 >> 2; cx < (x0 + width) >> 2; cx++) {
            int8_t *sl = s.slot + (cy * cw + cx) * 2;
            int16_t *mvp = s.mv + ((int64_t)cy * cw + cx) * 4;
            sl[0] = (int8_t)s0;
            sl[1] = (int8_t)s1;
            if (s0 >= 0) { mvp[0] = pred.mv[0][0]; mvp[1] = pred.mv[0][1]; }
            if (s1 >= 0) { mvp[2] = pred.mv[1][0]; mvp[3] = pred.mv[1][1]; }
        }
}

static void copy_predinfo(Neighbour *arr, int length, const PredInfo &p,
                          bool no_bidir, int skip) {
    for (int k = 0; k < (length >> 2); k++) {
        Neighbour &nb = arr[k];
        nb.pu_nonzero_coef = 0;
        nb.pu_intra = 0;
        nb.skip = (int8_t)skip;
        nb.pred = p;
        if (no_bidir) nb.pred.ref[1] = -1;
    }
}

}  // namespace

namespace {

// ---------------------------------------------------------------------
// prediction units (inter_cu.py prediction_unit*)
// ---------------------------------------------------------------------
static void prediction_unit_merge(Ctx &s, BitReader &r, int unavail,
                                  int offset_x, int offset_y, int width,
                                  int height, Neighbour *left,
                                  Neighbour *top,
                                  const Neighbour &lefttop) {
    int idx = se_merge_idx(s, r, s.sp.max_merge);
    PredInfo pred;
    pred.reset();
    int e = merge_list_c(s, idx, unavail, offset_x, offset_y, width,
                         height, left, top, lefttop, pred);
    if (e < 0) { s.err = e; return; }
    bool no_bidir = pred.ref[0] >= 0 && pred.ref[1] >= 0
        && width + height == 12;
    record_mc(s, offset_x, offset_y, width, height, pred, no_bidir);
    db_record_pu(s, s.qpy, width, height, offset_x, offset_y, unavail,
                 left, top, pred.ref[0],
                 no_bidir ? -1 : pred.ref[1], pred.mv);
    copy_predinfo(left, height, pred, no_bidir, 1);
    copy_predinfo(top, width, pred, no_bidir, 1);
    col_fill(s, offset_x, offset_y, width, height, false, &pred,
             pred.ref[0], no_bidir ? -1 : pred.ref[1]);
}

static bool prediction_unit(Ctx &s, BitReader &r, int size_log2,
                            int unavail, int offset_x, int offset_y,
                            int width, int height, Neighbour *left,
                            Neighbour *top, const Neighbour &lefttop,
                            int pred_unavail = 0) {
    if (cabac_decision(s, r, CTX_MERGE_FLAG)) {
        prediction_unit_merge(s, r, unavail | pred_unavail, offset_x,
                              offset_y, width, height, left, top,
                              lefttop);
        return true;
    }
    int pred_idc;
    if (s.sp.slice_type == 0) {
        int depth = s.ctb_log2 - size_log2;
        pred_idc = se_inter_pred_idc(s, r, width, height, depth);
    } else {
        pred_idc = 0;
    }
    const ColCell *col = s.sp.temporal_mvp
        ? col_get_ref(s, offset_x, offset_y, width, height) : nullptr;
    if (col && col->pu_intra) col = nullptr;
    PredInfo pred;
    pred.reset();
    if (pred_idc != 1) {
        int ref0 = se_ref_idx(s, r, 0, s.sp.num_ref_idx_minus1);
        int mvd[2];
        se_mvd_coding(s, r, mvd);
        int mvp_idx = cabac_decision(s, r, CTX_MVP_FLAG);
        pred.ref[0] = (int8_t)ref0;
        calc_mv_c(s, unavail, width, height, left, top, lefttop, 0,
                  ref0, mvp_idx, mvd, col, pred.mv[0]);
    }
    if (pred_idc != 0) {
        int ref1 = se_ref_idx(s, r, 1, s.sp.num_ref_idx_minus1);
        int mvd[2] = {0, 0};
        if (pred_idc == 1 || !s.sp.mvd_l1_zero)
            se_mvd_coding(s, r, mvd);
        int mvp_idx = cabac_decision(s, r, CTX_MVP_FLAG);
        pred.ref[1] = (int8_t)ref1;
        calc_mv_c(s, unavail, width, height, left, top, lefttop, 1,
                  ref1, mvp_idx, mvd, col, pred.mv[1]);
    }
    record_mc(s, offset_x, offset_y, width, height, pred, false);
    db_record_pu(s, s.qpy, width, height, offset_x, offset_y, unavail,
                 left, top, pred.ref[0], pred.ref[1], pred.mv);
    for (int k = 0; k < (height >> 2); k++) {
        Neighbour &nb = left[k];
        nb.pu_intra = 0; nb.pu_nonzero_coef = 0; nb.skip = 0;
        nb.pred = pred;
    }
    for (int k = 0; k < (width >> 2); k++) {
        Neighbour &nb = top[k];
        nb.pu_intra = 0; nb.pu_nonzero_coef = 0; nb.skip = 0;
        nb.pred = pred;
    }
    col_fill(s, offset_x, offset_y, width, height, false, &pred,
             pred.ref[0], pred.ref[1]);
    return false;
}

static int prediction_unit_cases(Ctx &s, BitReader &r, int size_log2,
                                 int unavail, int offset_x, int offset_y,
                                 Neighbour *left, Neighbour *top,
                                 const Neighbour &lefttop,
                                 bool *inferred) {
    int mode = se_part_mode_inter(s, r, size_log2, s.sp.min_cb_log2,
                                  s.sp.amp);
    int length = 1 << size_log2;
    *inferred = false;
    Neighbour lt0;
    int ls;
    switch (mode) {
    case 0:
        *inferred = prediction_unit(s, r, size_log2, unavail, offset_x,
                                    offset_y, length, length, left, top,
                                    lefttop);
        break;
    case 1:
        ls = length >> 1;
        lt0 = left[(length >> 3) - 1];
        prediction_unit(s, r, size_log2, AVAIL2X1IDX0[unavail], offset_x,
                        offset_y, length, ls, left, top, lefttop);
        prediction_unit(s, r, size_log2, AVAIL2X1IDX1[unavail], offset_x,
                        offset_y + ls, length, ls, left + (length >> 3),
                        top, lt0, 2);
        break;
    case 2:
        ls = length >> 1;
        lt0 = top[(length >> 3) - 1];
        prediction_unit(s, r, size_log2, AVAIL1X2IDX0[unavail], offset_x,
                        offset_y, ls, length, left, top, lefttop);
        prediction_unit(s, r, size_log2, AVAIL1X2IDX1[unavail],
                        offset_x + ls, offset_y, ls, length, left,
                        top + (length >> 3), lt0, 1);
        break;
    case 3:
        s.err = -4;  // reference-indeterminate: NxN inter
        break;
    case 4:
        ls = length >> 2;
        lt0 = left[(length >> 4) - 1];
        prediction_unit(s, r, size_log2, AVAIL2X1IDX0[unavail], offset_x,
                        offset_y, length, ls, left, top, lefttop);
        prediction_unit(s, r, size_log2, AVAIL2X1IDX1[unavail], offset_x,
                        offset_y + ls, length, length - ls,
                        left + (length >> 4), top, lt0, 2);
        break;
    case 5:
        ls = length >> 2;
        lt0 = left[((length - ls) >> 2) - 1];
        prediction_unit(s, r, size_log2, AVAIL2X1IDX0[unavail], offset_x,
                        offset_y, length, length - ls, left, top,
                        lefttop);
        prediction_unit(s, r, size_log2, AVAIL2X1IDX1[unavail], offset_x,
                        offset_y + length - ls, length, ls,
                        left + ((length - ls) >> 2), top, lt0, 2);
        break;
    case 6:
        ls = length >> 2;
        lt0 = top[(length >> 4) - 1];
        prediction_unit(s, r, size_log2, AVAIL1X2IDX0[unavail], offset_x,
                        offset_y, ls, length, left, top, lefttop);
        prediction_unit(s, r, size_log2, AVAIL1X2IDX1[unavail],
                        offset_x + ls, offset_y, length - ls, length,
                        left, top + (length >> 4), lt0, 1);
        break;
    case 7:
        ls = length >> 2;
        lt0 = top[((length - ls) >> 2) - 1];
        prediction_unit(s, r, size_log2, AVAIL1X2IDX0[unavail], offset_x,
                        offset_y, length - ls, length, left, top,
                        lefttop);
        prediction_unit(s, r, size_log2, AVAIL1X2IDX1[unavail],
                        offset_x + length - ls, offset_y, ls, length,
                        left, top + ((length - ls) >> 2), lt0, 1);
        break;
    }
    return mode;
}

// ---------------------------------------------------------------------
// transform tree + units (ctu.py transform_tree / transform_unit)
// ---------------------------------------------------------------------
static void transform_unit(Ctx &s, BitReader &r, int size_log2, int cbf,
                           int idx, int pred_idx, int offset_x,
                           int offset_y, bool is_intra) {
    int y0 = (s.pos_y << s.ctb_log2) + offset_y;
    int x0 = (s.pos_x << s.ctb_log2) + offset_x;
    if (cbf & 1) {
        int order = (is_intra && size_log2 <= 3)
            ? order_map_c(s.order_luma[pred_idx]) : 0;
        residual_coding(s, r, size_log2, 0, y0, x0, order, is_intra);
    }
    if (cbf & 6) {
        if (2 < size_log2) {
            size_log2 -= 1;
        } else if (idx != 3) {
            return;
        } else {
            x0 -= 4;
            y0 -= 4;
        }
        int order = (is_intra && size_log2 == 2)
            ? order_map_c(s.order_chroma) : 0;
        if (cbf & 4)
            residual_coding(s, r, size_log2, 1, y0 >> 1, x0 >> 1, order,
                            false);
        if (cbf & 2)
            residual_coding(s, r, size_log2, 2, y0 >> 1, x0 >> 1, order,
                            false);
    }
}

static void emit_intra_luma(Ctx &s, int size_log2, int offset_x,
                            int offset_y, int unavail, int valid_x,
                            int valid_y, int pred_idx) {
    int vx = (unavail & 2) ? -1 : valid_x;
    int vy = (unavail & 1) ? -1 : valid_y;
    int y0 = (s.pos_y << s.ctb_log2) + offset_y;
    int x0 = (s.pos_x << s.ctb_log2) + offset_x;
    emit_op(s, true, y0, x0, size_log2, s.order_luma[pred_idx], vx, vy);
    if (size_log2 == 2) return;
    emit_op(s, false, y0 >> 1, x0 >> 1, size_log2 - 1, s.order_chroma,
            vx >> 1, vy >> 1);
}

static void emit_intra_chroma_split(Ctx &s, int size_log2, int offset_x,
                                    int offset_y, int unavail,
                                    int valid_x, int valid_y) {
    int y0 = (s.pos_y << s.ctb_log2) + offset_y;
    int x0 = (s.pos_x << s.ctb_log2) + offset_x;
    int vx = (unavail & 2) ? -1 : (valid_x >> 1);
    int vy = (unavail & 1) ? -1 : (valid_y >> 1);
    emit_op(s, false, y0 >> 1, x0 >> 1, size_log2, s.order_chroma, vx,
            vy);
}

static void transform_tree(Ctx &s, BitReader &r, int size_log2,
                           int unavail, int depth, int upper_cbf,
                           int offset_x, int valid_x, int offset_y,
                           int valid_y, int idx, int pred_idx,
                           bool is_intra, Neighbour *left,
                           Neighbour *top) {
    if (s.err) return;
    int split;
    if (s.sp.max_tb_log2 < size_log2) {
        split = 1;
    } else if (is_intra) {
        if (depth == 0 && s.intra_split) split = 2;
        else if (s.sp.min_tb_log2 < size_log2
                 && depth < s.sp.max_hier_intra)
            split = cabac_decision(s, r, CTX_SPLIT_TR + 5 - size_log2);
        else split = 0;
    } else if (s.sp.min_tb_log2 < size_log2
               && depth < s.sp.max_hier_inter) {
        split = cabac_decision(s, r, CTX_SPLIT_TR + 5 - size_log2);
    } else {
        split = (depth == 0) && s.intra_split;
    }
    int cbf;
    if (2 < size_log2) {
        cbf = (upper_cbf & 2)
            ? cabac_decision(s, r, CTX_CBF_CHROMA + depth) * 2 : 0;
        if (upper_cbf & 1)
            cbf |= cabac_decision(s, r, CTX_CBF_CHROMA + depth);
    } else {
        cbf = upper_cbf;
    }
    if (split) {
        int pi = split == 2 ? 0 : pred_idx;
        int pinc = split == 2 ? 1 : 0;
        size_log2 -= 1;
        if (is_intra && size_log2 == 2)
            emit_intra_chroma_split(s, size_log2, offset_x, offset_y,
                                    unavail, valid_x, valid_y);
        depth += 1;
        int block_len = 1 << size_log2;
        int blen = 1 << (size_log2 - 2);
        transform_tree(s, r, size_log2, unavail, depth, cbf, offset_x,
                       valid_x, offset_y, valid_y, 0, pi, is_intra,
                       left, top);
        pi += pinc;
        transform_tree(s, r, size_log2, unavail & ~1, depth, cbf,
                       offset_x + block_len, valid_x - block_len,
                       offset_y, minu(valid_y, block_len), 1, pi,
                       is_intra, left, top + blen);
        pi += pinc;
        transform_tree(s, r, size_log2, unavail & ~2, depth, cbf,
                       offset_x, minu(valid_x, block_len * 2),
                       offset_y + block_len, valid_y - block_len, 2, pi,
                       is_intra, left + blen, top);
        pi += pinc;
        transform_tree(s, r, size_log2, 0, depth, cbf,
                       offset_x + block_len,
                       minu((int64_t)valid_x - block_len, block_len),
                       offset_y + block_len,
                       minu((int64_t)valid_y - block_len, block_len), 3,
                       pi, is_intra, left + blen, top + blen);
    } else {
        if (is_intra)
            emit_intra_luma(s, size_log2, offset_x, offset_y, unavail,
                            valid_x, valid_y, pred_idx);
        if (is_intra || depth || cbf)
            cbf = cbf * 2 | cabac_decision(s, r, CTX_CBF_LUMA
                                           + (depth == 0));
        else
            cbf = cbf * 2 | 1;
        if (s.qp_delta_req) {
            s.qp_delta_req = 0;
            if (s.sp.cu_qp_delta) { s.err = -5; return; }
        }
        if (cbf)
            transform_unit(s, r, size_log2, cbf, idx, pred_idx,
                           offset_x, offset_y, is_intra);
        if (is_intra) {
            db_record_tu_intra(s, s.qpy, size_log2, offset_x, offset_y,
                               unavail);
        } else {
            db_record_tu(s, s.qpy, size_log2, offset_x, offset_y,
                         unavail, cbf & 1, left, top);
            int num = 1 << (size_log2 - 2);
            for (int k = 0; k < num; k++) {
                for (Neighbour *nb : {left + k, top + k}) {
                    nb->pu_nonzero_coef = (int8_t)(cbf & 1);
                    nb->tu_intra = 0;
                    nb->tu_nonzero_coef = (int8_t)(cbf & 1);
                    nb->pu_intra = 0;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------
// coding units (ctu.py pred_intra / inter_cu.py pred_inter)
// ---------------------------------------------------------------------
static void pred_intra(Ctx &s, BitReader &r, int size_log2, int unavail,
                       int offset_x, int offset_y, int valid_x,
                       int valid_y, Neighbour *left, Neighbour *top) {
    int part_num = 1;
    s.intra_split = 0;
    if (s.sp.min_cb_log2 == size_log2
        && cabac_decision(s, r, CTX_PART_MODE) == 0) {
        s.intra_split = 1;
        part_num = 4;
    }
    int pred_flag = 0;
    for (int i = 0; i < part_num; i++)
        pred_flag |= cabac_decision(s, r, CTX_PREV_INTRA) << i;
    int nn = 1 << (size_log2 - 2 - (part_num == 4));
    for (int i = 0; i < part_num; i++) {
        Neighbour *lt = left + (i >> 1) * nn;
        Neighbour *tt = top + (i & 1) * nn;
        int cand[3];
        intra_pred_candidate(lt->pred_mode, tt->pred_mode, cand);
        int mode;
        if (pred_flag & 1)
            mode = cand[se_mpm_idx(s, r)];
        else
            mode = se_rem_intra(s, r, cand);
        s.order_luma[i] = mode;
        pred_flag >>= 1;
        for (int k = 0; k < nn; k++) {
            for (Neighbour *nb : {lt + k, tt + k}) {
                nb->pred_mode = (int16_t)mode;
                nb->tu_intra = 1;
                nb->pu_intra = 1;
                nb->skip = 0;
            }
        }
    }
    if (part_num != 4)
        s.order_luma[1] = s.order_luma[2] = s.order_luma[3] =
            s.order_luma[0];
    int cidx = se_chroma_mode(s, r);
    s.order_chroma = intra_chroma_dir(cidx, s.order_luma[0]);
    col_fill(s, offset_x, offset_y, 1 << size_log2, 1 << size_log2,
             true, nullptr, -1, -1);
    transform_tree(s, r, size_log2, unavail, 0, 3, offset_x, valid_x,
                   offset_y, valid_y, 0, 0, true, left, top);
}

static void pred_inter(Ctx &s, BitReader &r, int size_log2, int unavail,
                       int offset_x, int offset_y, int valid_x,
                       int valid_y, Neighbour *left, Neighbour *top,
                       const Neighbour &lefttop) {
    int num = 1 << (size_log2 - 2);
    int inc = ((!(unavail & 1)) && left[0].skip)
        + ((!(unavail & 2)) && top[0].skip);
    int skip = cabac_decision(s, r, CTX_CU_SKIP + inc);
    int size = 1 << size_log2;
    if (skip) {
        prediction_unit_merge(s, r, unavail, offset_x, offset_y, size,
                              size, left, top, lefttop);
        for (int k = 0; k < num; k++) {
            for (Neighbour *nb : {left + k, top + k}) {
                nb->tu_intra = 0;
                nb->skip = 1;
                nb->pred_mode = 1;
                nb->pu_nonzero_coef = 0;
                nb->tu_nonzero_coef = 0;
            }
        }
        return;
    }
    if (cabac_decision(s, r, CTX_PRED_MODE)) {
        pred_intra(s, r, size_log2, unavail, offset_x, offset_y,
                   valid_x, valid_y, left, top);
        return;
    }
    bool inferred = false;
    int mode = prediction_unit_cases(s, r, size_log2, unavail, offset_x,
                                     offset_y, left, top, lefttop,
                                     &inferred);
    if (s.err) return;
    if (inferred || cabac_decision(s, r, CTX_RQT_ROOT)) {
        s.order_luma[0] = s.order_luma[1] = s.order_luma[2] =
            s.order_luma[3] = 0;
        s.order_chroma = 0;
        s.intra_split = (mode != 0 && s.sp.max_hier_inter == 0) ? 1 : 0;
        transform_tree(s, r, size_log2, unavail, 0, 3, offset_x,
                       valid_x, offset_y, valid_y, 0, 0, false, left,
                       top);
    } else {
        for (int k = 0; k < num; k++) {
            for (Neighbour *nb : {left + k, top + k}) {
                nb->pu_nonzero_coef = 0;
                nb->tu_nonzero_coef = 0;
            }
        }
    }
    for (int k = 0; k < num; k++) {
        for (Neighbour *nb : {left + k, top + k}) {
            nb->tu_intra = 0;
            nb->skip = 0;
            nb->pred_mode = 1;
        }
    }
}

static void coding_unit_header(Ctx &s, int size_log2, Neighbour *left,
                               Neighbour *top) {
    int depth = 6 - size_log2;
    int num = 1 << (size_log2 - 2);
    for (int i = 0; i < num; i++) {
        left[i].depth = (int8_t)depth;
        top[i].depth = (int8_t)depth;
    }
    if (s.sp.cu_qp_delta) s.qp_delta_req = 1;
}

static void quad_tree(Ctx &s, BitReader &r, int size_log2, int unavail,
                      int offset_x, int valid_x, int offset_y,
                      int valid_y, Neighbour *left, Neighbour *top,
                      Neighbour lefttop) {
    if (s.err || valid_x <= 0 || valid_y <= 0) return;
    int size = 1 << size_log2;
    bool boundary = valid_x < size || valid_y < size;
    if (s.sp.min_cb_log2 < size_log2
        && (boundary || se_split_cu(s, r, size_log2, left[0].depth,
                                    top[0].depth))) {
        size_log2 -= 1;
        int block_len = 1 << size_log2;
        int info = 1 << (size_log2 - 2);
        Neighbour lefttop1 = top[info - 1];
        Neighbour lefttop2 = left[info - 1];
        quad_tree(s, r, size_log2, AVAIL4X4IDX0[unavail], offset_x,
                  valid_x, offset_y, valid_y, left, top, lefttop);
        Neighbour lefttop3 = left[info - 1];
        quad_tree(s, r, size_log2, AVAIL4X4IDX1[unavail],
                  offset_x + block_len, valid_x - block_len, offset_y,
                  minu(valid_y, block_len), left, top + info, lefttop1);
        quad_tree(s, r, size_log2, AVAIL4X4IDX2[unavail], offset_x,
                  minu(valid_x, block_len * 2), offset_y + block_len,
                  valid_y - block_len, left + info, top, lefttop2);
        quad_tree(s, r, size_log2, 12, offset_x + block_len,
                  minu((int64_t)valid_x - block_len, block_len),
                  offset_y + block_len,
                  minu((int64_t)valid_y - block_len, block_len),
                  left + info, top + info, lefttop3);
    } else {
        coding_unit_header(s, size_log2, left, top);
        if (s.sp.slice_type < 2)
            pred_inter(s, r, size_log2, unavail, offset_x, offset_y,
                       valid_x, valid_y, left, top, lefttop);
        else
            pred_intra(s, r, size_log2, unavail, offset_x, offset_y,
                       valid_x, valid_y, left, top);
    }
}

// ---------------------------------------------------------------------
// CTU walk (ctu.py decode_ctu / pos_increment / init_slice)
// ---------------------------------------------------------------------
static void decode_ctu(Ctx &s, BitReader &r) {
    if (s.sp.sao_luma || s.sp.sao_chroma)
        sao_read(s, r);
    int idx = s.idx_in_slice;
    int unavail = (((!s.pos_y || idx < s.cols) ? 10 : 0)
                   | ((!s.pos_x || !idx) ? 5 : 0) | 4);
    quad_tree(s, r, s.ctb_log2, unavail, 0, s.valid_x, 0, s.valid_y,
              s.nleft + 2, s.ntop + s.pos_x * 16, s.nleft[1]);
    deblock_ctu(s, s.sp.cb_qp_offset, s.sp.cr_qp_offset);
}

static bool pos_increment(Ctx &s) {
    int pos_x = s.pos_x + 1;
    if (s.cols <= pos_x) {
        for (int i = 1; i < 18; i++) s.nleft[i].reset();
        s.pos_y += 1;
        s.valid_x = s.pic_w;
        if (s.pos_y == s.rows - 1) {
            int v = s.pic_h - (s.pos_y << s.ctb_log2);
            s.valid_y = v < (1 << s.ctb_log2) ? v : (1 << s.ctb_log2);
        }
        pos_x = 0;
    } else {
        s.valid_x -= 1 << s.ctb_log2;
        s.nleft[1] = s.nleft[0];
    }
    s.nleft[0] = s.ntop[((pos_x + 1) << (s.ctb_log2 - 2)) - 1];
    s.pos_x = pos_x;
    s.idx_in_slice += 1;
    Neighbour *top = s.ntop + pos_x * 16;
    for (int i = 0; i < 16; i++) top[i].pred_mode = 1;
    return s.rows <= s.pos_y;
}

static void init_slice(Ctx &s) {
    const H265SliceParams &sp = s.sp;
    int idc = sp.slice_type < 2
        ? (2 - (sp.slice_type ^ sp.cabac_init_flag)) : 0;
    cabac_init_context(s, sp.slice_qpy, idc);
    int addr = sp.slice_addr;
    s.pos_y = addr / s.cols;
    s.pos_x = addr - s.pos_y * s.cols;
    s.idx_in_slice = 0;
    s.valid_x = s.pic_w - (s.pos_x << s.ctb_log2);
    int vy = s.pic_h - (s.pos_y << s.ctb_log2);
    s.valid_y = vy < (1 << s.ctb_log2) ? vy : (1 << s.ctb_log2);
    if (s.qpy != sp.slice_qpy) {
        s.qpy = sp.slice_qpy;
        qp_to_scale_c(s, s.qpy, sp.qpc_delta);
        s.qpc_delta_c[0] = sp.qpc_delta[0];
        s.qpc_delta_c[1] = sp.qpc_delta[1];
    }
    for (int i = 0; i < 18; i++) s.nleft[i].reset();
    for (int i = 0; i < s.cols * 16; i++) s.ntop[i].reset();
    db_reset_slice(s);
    for (int d = 0; d < 2; d++)
        for (int k = 0; k < 17; k++)
            s.qp_history[d][k] = s.qpy;
}

}  // namespace

// ---------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------
extern "C" {

void *h265p_new(int cols, int rows, int ctb_log2, int pic_w, int pic_h) {
    Ctx *s = new Ctx();
    memset(s, 0, sizeof(Ctx));
    s->cols = cols;
    s->rows = rows;
    s->ctb_log2 = ctb_log2;
    s->W = cols << ctb_log2;
    s->H = rows << ctb_log2;
    s->pic_w = pic_w;
    s->pic_h = pic_h;
    s->edgemax = 1 << (ctb_log2 - 3);
    s->ntop = new Neighbour[cols * 16];
    for (int i = 0; i < cols * 16; i++) s->ntop[i].init_fresh();
    for (int i = 0; i < 18; i++) s->nleft[i].init_fresh();
    s->sao_map = new SaoMapC[cols * rows]();
    s->topedge = new Boundary[cols * s->edgemax]();
    s->col_stride = (pic_w + 15) >> 4;
    s->n16 = s->col_stride * ((pic_h + 15) >> 4);
    for (int i = 0; i < 8; i++) {
        s->colpics[i] = new ColCell[s->n16];
        for (int k = 0; k < s->n16; k++) {
            s->colpics[i][k].pu_intra = 1;
            s->colpics[i][k].ref[0] = s->colpics[i][k].ref[1] = -1;
            memset(s->colpics[i][k].mv, 0, sizeof(s->colpics[i][k].mv));
        }
    }
    return s;
}

void h265p_free(void *ctx) {
    Ctx *s = (Ctx *)ctx;
    delete[] s->ntop;
    delete[] s->sao_map;
    delete[] s->topedge;
    for (int i = 0; i < 8; i++) delete[] s->colpics[i];
    delete s;
}

void h265p_begin_picture(void *ctx, void **ptrs, int opsl_cap,
                         int opsc_cap, int cur_idx) {
    Ctx *s = (Ctx *)ctx;
    int k = 0;
    s->coef_y = (int16_t *)ptrs[k++];
    s->coef_cb = (int16_t *)ptrs[k++];
    s->coef_cr = (int16_t *)ptrs[k++];
    s->tu_y = (int16_t *)ptrs[k++];
    s->tu_cb = (int16_t *)ptrs[k++];
    s->tu_cr = (int16_t *)ptrs[k++];
    s->slot = (int8_t *)ptrs[k++];
    s->mv = (int16_t *)ptrs[k++];
    s->ops_l = (int32_t *)ptrs[k++];
    s->opsl_cnt = (int32_t *)ptrs[k++];
    s->ops_c = (int32_t *)ptrs[k++];
    s->opsc_cnt = (int32_t *)ptrs[k++];
    s->dbv = (int16_t *)ptrs[k++];
    s->dbh = (int16_t *)ptrs[k++];
    s->dbcv = (int16_t *)ptrs[k++];
    s->dbch = (int16_t *)ptrs[k++];
    s->opsl_cap = opsl_cap;
    s->opsc_cap = opsc_cap;
    s->col_curr = s->colpics[cur_idx & 7];
    s->err = 0;
}

int h265p_slice(void *ctx, const uint8_t *payload, long long nbytes,
                const H265SliceParams *sp) {
    Ctx *s = (Ctx *)ctx;
    s->sp = *sp;
    s->col_ref = s->colpics[sp->col_page & 7];
    init_slice(*s);
    BitReader r;
    r.init(payload, nbytes, sp->bit_offset);
    cabac_init_engine(*s, r);
    while (!s->err) {
        decode_ctu(*s, r);
        if (s->err) break;
        if (r.past_end()) return -2;  // truncated mid-slice
        if (pos_increment(*s)) break;
        if (cabac_terminate(*s, r)) break;
    }
    if (!s->err && r.past_end()) return -2;
    return s->err;
}

void h265p_finish(void *ctx, int8_t *sao_idx, int8_t *sao_opt,
                  int8_t *sao_off) {
    Ctx *s = (Ctx *)ctx;
    for (int y = 0; y < s->rows; y++)
        for (int x = 0; x < s->cols; x++) {
            int i = y * s->cols + x;
            int j = i, steps = x;
            while (steps && s->sao_map[j].merge_left) { j--; steps--; }
            const SaoMapC &m = s->sao_map[j];
            sao_idx[i * 2] = m.luma_idx;
            sao_idx[i * 2 + 1] = m.chroma_idx;
            for (int e = 0; e < 3; e++) {
                sao_opt[i * 3 + e] = m.opt[e];
                for (int o = 0; o < 4; o++)
                    sao_off[(i * 3 + e) * 4 + o] = m.off[e][o];
            }
        }
}

}  // extern "C"
