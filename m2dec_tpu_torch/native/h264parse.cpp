/* Native H.264 Phase-A: slice entropy decode -> dense picture plan.
 *
 * Host-side bit-serial front end of the two-phase TPU engine: walks a
 * picture's slices once (CAVLC/CABAC, MV prediction, deblock-strength
 * recording) and fills the PicturePlan tensors that the batched XLA
 * Phase B consumes (m2dec_tpu/codecs/h264/reconstruct.py).  Semantics
 * mirror the verified Python Phase A (m2dec_tpu/codecs/h264/decoder.py
 * and friends) function-for-function, which in turn is bit-exact with
 * the reference decoder (reference: src/lib/h264.cpp slice_data
 * :10210-10251 and the mb_decode dispatch tables).
 *
 * Python owns NAL walking, SPS/PPS/slice headers, POC, ref lists, DPB
 * and marking; this module owns everything per-MB.
 */

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <initializer_list>

#include "h264_tables.inc"
#include <x86intrin.h>

static uint64_t g_prof[8];
/* rdtsc scopes are opt-in (M2DEC_TPU_PROF=1): the always-on pair of
 * rdtscs per residual block measured ~10-15% of the whole slice decode
 * (r5) — the profiler must not be the profile */
static const bool g_prof_on = [] {
    const char *e = getenv("M2DEC_TPU_PROF");
    return e && e[0] && e[0] != '0';
}();

namespace {
struct ProfScope {
    int slot;
    uint64_t t0;
    ProfScope(int k) : slot(k), t0(g_prof_on ? __rdtsc() : 0) {}
    ~ProfScope() { if (g_prof_on) g_prof[slot] += __rdtsc() - t0; }
};

// ---------------------------------------------------------------------
// bit reader (payload is already emulation-prevention-stripped)
// ---------------------------------------------------------------------
struct BitReader {
    const uint8_t *base;
    int64_t nbits;     // total payload bits
    int64_t pos;       // consumed bits
    const uint8_t *p;
    const uint8_t *end;
    uint64_t cache;    // MSB-aligned
    int ncache;
    int64_t stop_bit;  // index of rbsp_stop_one_bit (last set bit)

    void init(const uint8_t *data, int64_t len_bytes, int64_t bit_offset) {
        base = data;
        nbits = len_bytes * 8;
        end = data + len_bytes;
        stop_bit = -1;
        for (int64_t i = len_bytes - 1; i >= 0 && stop_bit < 0; i--) {
            uint8_t b = data[i];
            if (b) {
                int tz = __builtin_ctz(b);
                stop_bit = i * 8 + (7 - tz);
            }
        }
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
        // unaligned 32-bit loads replace the byte loop (bit-exact: same
        // bytes, same order); cache stays >= 33 valid bits, enough for
        // every show/get caller (max field width is 32)
        while (ncache <= 32 && p + 4 <= end) {
            uint32_t v;
            memcpy(&v, p, 4);
            cache |= (uint64_t)__builtin_bswap32(v) << (32 - ncache);
            p += 4;
            ncache += 32;
        }
        while (ncache <= 56 && p < end) {
            cache |= (uint64_t)*p++ << (56 - ncache);
            ncache += 8;
        }
        if (ncache <= 32) ncache = 64;  // past EOF: zero-padded tail
    }
    uint32_t show(int n) { return (uint32_t)(cache >> (64 - n)); }
    void skip(int n) {
        cache <<= n;
        ncache -= n;
        pos += n;
        if (ncache < 33) fill();  // lazy: keep the >=33-bit invariant
    }
    uint32_t get(int n) {
        uint32_t v = show(n);
        skip(n);
        return v;
    }
    uint32_t get1() { return get(1); }
    void byte_align() {
        int r = (int)(pos & 7);
        if (r) skip(8 - r);
    }
    int ue() {
        // count leading zeros of the next bits
        uint32_t probe = show(32);
        if (probe == 0) { skip(32); return -1; }  // malformed; caller errors
        int lz = __builtin_clz(probe);
        skip(lz);
        return (int)get(lz + 1) - 1;
    }
    int se() {
        int v = ue();
        int sign = v & 1;
        v = (v + 1) >> 1;
        return sign ? v : -v;
    }
    bool more_rbsp_data() const { return pos < stop_bit; }
    /* reads past the payload end consumed zero-padding — the
     * reference's dec_bits would have longjmp'd out of the parse
     * (bitio.c:112-128); callers abandon the picture (-2).
     *
     * The 32-bit slack is the engine's maximum legal lookahead, not a
     * guess: every CABAC read primitive fetches <= 32 bits per call
     * (cab_offset init get(9), cabac_renorm get(bits<=8 per decision,
     * amortized one renorm per bin), multibypass get(num<=32)), and
     * the offset register never holds more than 32 fetched-but-
     * unresolved bits.  A conforming slice that ends flush with the
     * payload can therefore legitimately read at most 32 bits of
     * padding; anything beyond means decoded state consumed fabricated
     * input.  Truncations shorter than that final lookahead window are
     * indistinguishable from a flush ending by construction — the
     * reference's word-granular dec_bits cache has the same blind spot
     * (bitio.c:68-89 refills cache_t words). */
    bool past_end() const { return pos > nbits + 32; }
};

static int read_te(BitReader &r, int range) {
    if (range == 1) return r.get1() ^ 1;
    int v = r.ue();
    return v <= range ? v : range;
}

// ---------------------------------------------------------------------
// plan output pointers (numpy buffers owned by Python)
// ---------------------------------------------------------------------
struct PlanPtrs {
    int32_t *kind;         // [n]
    int32_t *t8x8;         // [n]
    int32_t *coef_luma;    // [n][256]
    int32_t *coef_chroma;  // [n][2][4][16]
    int32_t *i4_modes;     // [n][16]
    int32_t *i4_avail;     // [n][16]
    int32_t *i8_modes;     // [n][4]
    int32_t *i8_avail;     // [n][4]
    int32_t *i16_mode;     // [n]
    int32_t *chroma_mode;  // [n]
    int32_t *mb_avail;     // [n]
    int32_t *mv;           // [n][16][2][2]
    int32_t *slot;         // [n][4][2]
    int32_t *wp;           // [n][4][3][4]
    uint8_t *pcm;          // [n][384]
    // raw deblock records (finalized by Python)
    int32_t *deb_idc;      // [n]
    int32_t *deb_qpy;      // [n]
    int32_t *deb_qpc;      // [n][2]
    int32_t *deb_slicehdr; // [n][2]
    int32_t *deb_str4;     // [n][2]  (vert, horiz)
    int64_t *deb_str;      // [n][2]  (str_vert, str_horiz)
    // per-MB coded-block bitmap for the batch packer: bits 0..15 luma
    // (0..3 when the MB uses the 8x8 layout), 16+c*4+b chroma. A set
    // bit means the corresponding coef block was fully written; clear
    // bits mean the block is semantically zero and its memory may be
    // uninitialized (the arena path skips zeroing the coef tensors).
    uint32_t *coded;       // [n]
};

// ---------------------------------------------------------------------
// parse state (mirrors h264d_mb_current neighbor caches, h264.h:374-419)
// ---------------------------------------------------------------------
struct PrevMb {   // decoder.PrevMb
    int32_t type, cbp, cbf, chroma_pred_mode, transform8x8, mb_skip,
        direct8x8;
    int32_t ref[2][2];
    int32_t frmidx[2][2];
    int32_t mov[4][2][2];
    int32_t mvd[4][2][2];
};

struct RefInfo {  // per list per idx, filled by Python per slice
    int32_t frame_idx;
    int32_t poc;
    int32_t in_use;    // 0 none, 1 short, 2 long
    int32_t col_idx;   // index into col pages (L1 only), -1
};

struct SliceParams {
    int32_t slice_type;       // 0 P, 1 B, 2 I
    int32_t is_cabac;
    int32_t cabac_init_idc;   // post-adjust: 0 for I else idc+1
    int32_t qp;               // slice initial qp (already wrapped)
    int32_t first_mb;
    int32_t num_ref_idx[2];
    int32_t constrained_intra;
    int32_t t8x8_mode;
    int32_t chroma_qp_index[2];
    int32_t direct_spatial;
    int32_t weighted_mode;    // 0/1/2
    int32_t deb_idc_plus1;    // stored at first_mb
    int32_t alpha_ofs, beta_ofs;
    int32_t poc;              // current picture POC (temporal direct)
    int32_t is_field;         // field_pic_flag (CABAC sig ctx offsets)
    int64_t bit_offset;       // slice-header size in bits
};

enum { MB_INxN = 0, MB_I16x16 = 1, MB_IPCM = 25, MB_P16x16 = 26,
       MB_P16x8 = 27, MB_P8x16 = 28, MB_P8x8 = 29, MB_P8x8REF0 = 30,
       MB_PSKIP = 31 };
enum { P_SLICE = 0, B_SLICE = 1, I_SLICE = 2 };

struct CabacCtx;  // fwd

struct Ctx {
    int max_x, max_y, nmb;
    PlanPtrs plan;
    // persistent neighbor caches (across slices and pictures)
    int32_t left_pred[4];
    int32_t *top_pred;      // [max_x][4]
    int32_t left_coef[8];
    int32_t *top_coef;      // [max_x][8]
    PrevMb *mbtop;          // [max_x + 2]
    PrevMb mbleft;
    int32_t lefttop_ref[2];
    int32_t lefttop_mv[2][2];
    // per-slice / per-MB running state
    SliceParams sp;
    RefInfo refs[2][16];
    // weighted pred tables: per list per idx per plane (w, o); shifts
    int32_t wtab[2][32][3][2];
    int32_t wshift[2];  // (luma, chroma)
    int32_t implicit_w[32][32][2];  // [idx0][idx1] -> (w0, w1)
    // temporal direct scale tables (bdirect), per col ref
    // colocated pages
    int32_t *col_type;   // [n] (mutated by pred_direct16x16)
    int32_t *col_ref;    // [n][4]
    int32_t *col_mv;     // [n][16][2]
    const int32_t *col_map;    // map_col_frameidx [16]
    int32_t *curr_type;        // current picture col page
    int32_t *curr_ref;
    int32_t *curr_mv;
    // temporal-direct scaling inputs (Python precomputes)
    int32_t map_col_to_list0[16];   // bdirect_map
    int32_t scale_tab[16];          // bdirect_scale
    int mb_x, mb_y, mb_pos, firstline;
    int qp, qp_chroma[2];
    int32_t qmaty[16], qmaty8[64], qmatc_buf[2][16];
    const int32_t *qmatc[2];
    int prev_qp_delta;
    uint32_t cab_range, cab_offset;
    int32_t cab_ctx[460];
    int cbp;
    uint32_t cbf;
    int mb_type;
    int chroma_pred_mode;
    int64_t avail_saved;
    CabacCtx *cb;
};

// ---------------------------------------------------------------------
// dequant matrices (transforms.qmat4/qmat8/qpc_from_qpy)
// ---------------------------------------------------------------------
static void qmat4_fill(int qp, int32_t *m) {
    int32_t v[3];
    for (int i = 0; i < 3; i++) v[i] = NORM_ADJ4[qp % 6][i] << (qp / 6);
    for (int i = 0; i < 16; i++) {
        int r = i >> 2, c = i & 3;
        m[i] = (!((r & 1) || (c & 1))) ? v[0]
             : (((r & 1) && (c & 1)) ? v[1] : v[2]);
    }
}

static void qmat8_fill(int qp, int32_t *m) {
    int shift = qp / 6 - 2;
    int32_t v[6];
    for (int i = 0; i < 6; i++) {
        int32_t x = NORM_ADJ8[qp % 6][i];
        v[i] = shift >= 0 ? (x << shift) : (x >> -shift);
    }
    for (int i = 0; i < 64; i++) {
        int r = i >> 3, c = i & 7;
        int rm = r & 3, cm = c & 3, k;
        if (rm == 0 && cm == 0) k = 0;
        else if ((r & 1) && (c & 1)) k = 1;
        else if (rm == 2 && cm == 2) k = 2;
        else if ((rm == 0 && (c & 1)) || (cm == 0 && (r & 1))) k = 3;
        else if (rm == 0 || cm == 0) k = 4;
        else k = 5;
        m[i] = v[k];
    }
}

static int qpc_from_qpy(int qpy, int diff) {
    int qpc = qpy + diff;
    if (qpc <= 0) return 0;
    if (qpc >= 30) return QPC_ADJUST[(qpc < 51 ? qpc : 51) - 30];
    return qpc;
}

static void set_qp(Ctx &s, int qpy) {
    if (qpy < 0) qpy += 52;
    else if (qpy >= 52) qpy -= 52;
    s.qp = qpy;
    qmat4_fill(qpy, s.qmaty);
    if (s.sp.t8x8_mode) qmat8_fill(qpy, s.qmaty8);
    for (int i = 0; i < 2; i++) {
        int qpc = qpc_from_qpy(qpy, s.sp.chroma_qp_index[i]);
        s.qp_chroma[i] = qpc;
        if (qpc == qpy) {
            s.qmatc[i] = s.qmaty;
        } else {
            qmat4_fill(qpc, s.qmatc_buf[i]);
            s.qmatc[i] = s.qmatc_buf[i];
        }
    }
}

// ---------------------------------------------------------------------
// position / availability (h264.cpp:556-635, :9704-9715)
// ---------------------------------------------------------------------
static void set_mb_pos(Ctx &s, int mbpos) {
    s.mb_y = mbpos / s.max_x;
    s.mb_x = mbpos % s.max_x;
    s.firstline = s.max_x;
    s.prev_qp_delta = 0;
    s.mb_pos = mbpos;
    for (int x = 0; x < s.max_x; x++)
        for (int k = 0; k < 4; k++) s.top_pred[x * 4 + k] = 2;
    for (int k = 0; k < 4; k++) s.left_pred[k] = 0;
    for (int k = 0; k < 4; k++) s.top_pred[s.mb_x * 4 + k] = 0;
    for (int k = 0; k < 8; k++) s.left_coef[k] = 0;
    memset(&s.mbleft, 0, sizeof(PrevMb));
    s.lefttop_ref[0] = s.lefttop_ref[1] = 0;
    memset(s.lefttop_mv, 0, sizeof(s.lefttop_mv));
    s.cbf = 0;
    s.cbp = 0;
    s.mb_type = 0;
    s.chroma_pred_mode = 0;
}

static int get_avail(const Ctx &s) {
    int mbx = s.mb_x, fl = s.firstline;
    return ((mbx != 0 && fl < 0) << 3)
         | ((mbx != s.max_x - 1 && fl <= 1) << 2)
         | ((fl <= 0) << 1)
         | (mbx != 0 && fl != s.max_x);
}

static inline PrevMb &top_of(Ctx &s) { return s.mbtop[1 + s.mb_x]; }
static inline PrevMb &topright_of(Ctx &s) { return s.mbtop[2 + s.mb_x]; }

static uint32_t cbf_top(uint32_t cbf) {
    return ((cbf >> 16) & 0x700) | ((cbf >> 14) & 0xC0)
         | ((cbf >> 12) & 0x3C) | ((cbf >> 10) & 3);
}
static uint32_t cbf_left(uint32_t cbf) {
    return ((cbf >> 16) & 0x600) | ((cbf >> 15) & 0x100)
         | ((cbf >> 14) & 0x80) | ((cbf >> 13) & 0x40)
         | ((cbf >> 12) & 0x38) | ((cbf >> 11) & 4)
         | ((cbf >> 6) & 2) | ((cbf >> 5) & 1);
}

static int increment_mb_pos(Ctx &s) {
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    t.type = l.type = s.mb_type;
    t.cbp = l.cbp = s.cbp;
    t.chroma_pred_mode = l.chroma_pred_mode = s.chroma_pred_mode;
    t.cbf = cbf_top(s.cbf);
    l.cbf = cbf_left(s.cbf);
    s.cbf = 0;
    s.mb_pos += 1;
    int x = s.mb_x + 1;
    if (x >= s.max_x) {
        x = 0;
        s.mb_y += 1;
        if (s.mb_y >= s.max_y) {
            s.mb_x = x;
            return -1;
        }
    }
    s.mb_x = x;
    if (s.firstline >= 0) s.firstline -= 1;
    return 0;
}

// ---------------------------------------------------------------------
// CAVLC residual (cavlc.py / reference residual_block_cavlc :2038-2110)
// ---------------------------------------------------------------------
struct CatInfo { int ofs, num, dc_mask, err_mask; const uint8_t *zz; };
static const uint8_t ZZ_CHROMA_DC[4] = {0, 1, 2, 3};
static const CatInfo CATS[6] = {
    {0, 16, 0, 15, ZIGZAG4},
    {1, 15, 15, 15, ZIGZAG4},
    {0, 16, 15, 15, ZIGZAG4},
    {0, 4, 0, 3, ZZ_CHROMA_DC},
    {1, 15, 15, 15, ZIGZAG4},
    {0, 64, 63, 63, ZIGZAG8},
};

static inline int get_nc(int na, int nb) {
    if (na >= 0) return nb >= 0 ? ((na + nb + 1) >> 1) : na;
    return nb >= 0 ? nb : 0;
}

static inline int read_lut(BitReader &r, const uint16_t *lut, int bits,
                           int *val) {
    uint32_t probe = r.show(bits);
    uint16_t e = lut[probe];
    int len = e & 31;
    if (!len) return -2;
    r.skip(len);
    *val = e >> 5;
    return 0;
}

static int level_prefix(BitReader &r) {
    /* leading-zero count via one cache probe (legal prefixes are <=15,
     * so 32 bits always cover prefix+stop bit; a zero probe means a
     * malformed/truncated stream — consume and let the caller's
     * past_end/err checks fire, bit-identical to the bitwise loop) */
    uint32_t probe = r.show(32);
    if (probe == 0) {
        r.skip(32);
        return 32;
    }
    int lz = __builtin_clz(probe);
    r.skip(lz + 1);
    return lz;
}

/* returns min(total_coeff,15) or negative error; writes dequantized
 * coefficients into coeff[] (raster) for positions it touches. */
static int cavlc_residual(Ctx &s, BitReader &r, int na, int nb,
                          int32_t *coeff, const int32_t *qmat, int cat) {
    const CatInfo &ci = CATS[cat];
    int ctv;
    if (ci.num <= 4) {
        if (read_lut(r, CT_LUTS[4], CT_BITS[4], &ctv) < 0) return -2;
    } else {
        int nc = get_nc(na, nb);
        int cls = nc >= 8 ? 3 : (nc >= 4 ? 2 : (nc >= 2 ? 1 : 0));
        if (read_lut(r, CT_LUTS[cls], CT_BITS[cls], &ctv) < 0) return -2;
    }
    int total_coeff = (ctv >> 2) & 31;
    int trailing_ones = ctv & 3;
    if (total_coeff == 0) return 0;
    int32_t level[64];
    if (trailing_ones) {
        uint32_t ones = r.get(trailing_ones);
        for (int i = 0; i < trailing_ones; i++)
            level[i] = (ones >> (trailing_ones - 1 - i)) & 1 ? -1 : 1;
    }
    int suffix_len = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
    for (int i = trailing_ones; i < total_coeff; i++) {
        int lvl_prefix = level_prefix(r);
        int64_t lvl = (int64_t)lvl_prefix << suffix_len;
        if (suffix_len > 0 || lvl_prefix >= 14) {
            int size = suffix_len;
            if (lvl_prefix == 14 && size == 0) size = 4;
            else if (lvl_prefix == 15) size = 12;
            if (size) lvl += r.get(size);
        }
        if (suffix_len == 0 && lvl_prefix == 15) lvl += 15;
        if (i == trailing_ones && trailing_ones < 3) lvl += 2;
        lvl = (lvl & 1) ? (-(lvl + 1) >> 1) : ((lvl + 2) >> 1);
        level[i] = (int32_t)lvl;
        if (suffix_len == 0) suffix_len = 1;
        int64_t th = (int64_t)(3 << (suffix_len - 1));
        if (suffix_len < 6 && th * th < lvl * lvl) suffix_len++;
    }
    int zeros_left = 0;
    if (total_coeff < ci.num) {
        if (ci.num > 4) {
            if (read_lut(r, TZ_LUTS[total_coeff], TZ_BITS[total_coeff],
                         &zeros_left) < 0) return -2;
        } else {
            if (read_lut(r, TZC_LUTS[total_coeff], TZC_BITS[total_coeff],
                         &zeros_left) < 0) return -2;
        }
    }
    int run[64];
    for (int i = 0; i < total_coeff - 1; i++) {
        int rb = 0;
        if (zeros_left) {
            int zl = zeros_left < 7 ? zeros_left : 7;
            if (read_lut(r, RB_LUTS[zl], RB_BITS[zl], &rb) < 0) return -2;
        }
        run[i] = rb;
        zeros_left -= rb;
    }
    run[total_coeff - 1] = zeros_left;
    for (int k = ci.ofs; k < ci.ofs + ci.num; k++) coeff[k] = 0;
    int idx = ci.ofs - 1;
    for (int i = total_coeff - 1; i >= 0; i--) {
        idx = (idx + 1 + run[i]) & ci.err_mask;
        int zi = ci.zz[idx];
        coeff[zi] = level[i] * qmat[zi & ci.dc_mask];
    }
    return total_coeff < 15 ? total_coeff : 15;
}

// ---------------------------------------------------------------------
// DC transforms (transforms.py luma_dc_transform / chroma_dc_transform)
// ---------------------------------------------------------------------
static void luma_dc_transform(const int32_t *c, int32_t *dc) {
    int64_t t[16];
    // rows: H4 @ x
    for (int j = 0; j < 4; j++) {
        int64_t a = c[0 * 4 + j], b = c[1 * 4 + j], cc = c[2 * 4 + j],
                d = c[3 * 4 + j];
        t[0 * 4 + j] = a + b + cc + d;
        t[1 * 4 + j] = a + b - cc - d;
        t[2 * 4 + j] = a - b - cc + d;
        t[3 * 4 + j] = a - b + cc - d;
    }
    for (int i = 0; i < 4; i++) {
        int64_t a = t[i * 4 + 0], b = t[i * 4 + 1], cc = t[i * 4 + 2],
                d = t[i * 4 + 3];
        dc[i * 4 + 0] = (int32_t)((a + b + cc + d + 2) >> 2);
        dc[i * 4 + 1] = (int32_t)((a + b - cc - d + 2) >> 2);
        dc[i * 4 + 2] = (int32_t)((a - b - cc + d + 2) >> 2);
        dc[i * 4 + 3] = (int32_t)((a - b + cc - d + 2) >> 2);
    }
}

static void chroma_dc_transform(const int32_t *c, int32_t *dc) {
    int64_t t0 = (int64_t)c[0] + c[1], t1 = (int64_t)c[2] + c[3];
    int64_t u0 = (int64_t)c[0] - c[1], u1 = (int64_t)c[2] - c[3];
    dc[0] = (int32_t)((t0 + t1) >> 1);
    dc[1] = (int32_t)((u0 + u1) >> 1);
    dc[2] = (int32_t)((t0 - t1) >> 1);
    dc[3] = (int32_t)((u0 - u1) >> 1);
}

// ---------------------------------------------------------------------
// deblock records / intra save info
// ---------------------------------------------------------------------
static void store_strength_intra(Ctx &s, int64_t str_all) {
    int p = s.mb_pos;
    s.plan.deb_qpy[p] = s.qp;
    s.plan.deb_qpc[p * 2] = s.qp_chroma[0];
    s.plan.deb_qpc[p * 2 + 1] = s.qp_chroma[1];
    /* index 0 = vertical-edge set (reference str4_horiz/str_horiz),
     * index 1 = horizontal-edge set (str4_vert/str_vert) */
    s.plan.deb_str4[p * 2] = 1;
    s.plan.deb_str4[p * 2 + 1] = 1;
    s.plan.deb_str[p * 2] = str_all;
    s.plan.deb_str[p * 2 + 1] = str_all;
}

static void intra_save_info(Ctx &s, int transform8x8) {
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    s.lefttop_ref[0] = t.ref[1][0];
    s.lefttop_ref[1] = t.ref[1][1];
    s.lefttop_mv[0][0] = t.mov[3][0][0];
    s.lefttop_mv[0][1] = t.mov[3][0][1];
    s.lefttop_mv[1][0] = t.mov[3][1][0];
    s.lefttop_mv[1][1] = t.mov[3][1][1];
    for (PrevMb *n : {&t, &l}) {
        n->transform8x8 = transform8x8;
        n->direct8x8 = 0;
        memset(n->mov, 0, sizeof(n->mov));
        memset(n->mvd, 0, sizeof(n->mvd));
        for (int a = 0; a < 2; a++)
            for (int b = 0; b < 2; b++) n->ref[a][b] = n->frmidx[a][b] = -1;
    }
    s.curr_type[s.mb_pos] = 0;  // COL_MB16x16
    for (int k = 0; k < 4; k++) s.curr_ref[s.mb_pos * 4 + k] = -1;
}

static int avail_intra_of(Ctx &s, int avail) {
    if (s.sp.constrained_intra) {
        int clear = 0;
        if (MB_IPCM < topright_of(s).type) clear |= 4;
        if (MB_IPCM < top_of(s).type) clear |= 2;
        if (MB_IPCM < s.mbleft.type) clear |= 1;
        avail &= ~clear;
    }
    return avail;
}

// ---------------------------------------------------------------------
// CAVLC intra macroblocks (decoder.py _mb_intra*)
// ---------------------------------------------------------------------
struct Reader;  // unified CAVLC/CABAC reader facade comes with CABAC stage

static int read_me_cbp(BitReader &r, int inter) {
    int v = r.ue();
    if (v < 0) return -2;
    if (v >= 48) v = 0;
    return ME_CBP[inter][v];
}

static int read_qp_delta_cavlc(Ctx &s, BitReader &r) {
    int delta = r.se();
    delta = delta < -26 ? -26 : (delta > 25 ? 25 : delta);
    s.prev_qp_delta = delta;
    return delta;
}

// nC wiring for the 16 luma blocks in Z order (_LUMA_NC_WIRING):
// kind 0 = left cache, 1 = top cache, 2 = previous block of this MB
struct NcSpec { uint8_t kind, k; };
static const NcSpec NC_WIRING[16][2] = {
    {{0, 0}, {1, 0}}, {{2, 0}, {1, 1}}, {{0, 1}, {2, 0}}, {{2, 2}, {2, 1}},
    {{2, 1}, {1, 2}}, {{2, 4}, {1, 3}}, {{2, 3}, {2, 4}}, {{2, 6}, {2, 5}},
    {{0, 2}, {2, 2}}, {{2, 8}, {2, 3}}, {{0, 3}, {2, 8}}, {{2, 10}, {2, 9}},
    {{2, 9}, {2, 6}}, {{2, 12}, {2, 7}}, {{2, 11}, {2, 12}},
    {{2, 14}, {2, 13}},
};

static int nc_resolve(const Ctx &s, NcSpec spec, const int *nc, int avail,
                      bool is_left) {
    if (spec.kind == 2) return nc[spec.k];
    if (is_left) return (avail & 1) ? s.left_coef[spec.k] : -1;
    return (avail & 2) ? s.top_coef[s.mb_x * 8 + spec.k] : -1;
}

static void intra4x4_block_avail(int ai, int *out) {
    const int v[16] = {
        ai | ((ai & 2) ? 4 : 0), ai | ((ai & 2) ? 5 : 1), ai | 6, 3,
        ai | ((ai & 2) ? 5 : 1), ai | 1, 7, 3,
        ai | 6, 7, ai | 6, 3,
        7, 3, 7, 3};
    for (int i = 0; i < 16; i++) out[i] = v[i];
}

static const int ZPOS_Y[16] = {0, 0, 4, 4, 0, 0, 4, 4, 8, 8, 12, 12, 8, 8,
                               12, 12};
static const int ZPOS_X[16] = {0, 4, 0, 4, 8, 12, 8, 12, 0, 4, 0, 4, 8, 12,
                               8, 12};

// forward decls for CABAC variants (implemented in the CABAC stage)
struct AeFns;
static int residual_block_any(Ctx &s, BitReader &r, int na, int nb,
                              int32_t *coeff, const int32_t *qmat, int cat,
                              int pos4x4, int avail);
static int read_cbp_any(Ctx &s, BitReader &r, int avail, int inter);
static int read_qp_delta_any(Ctx &s, BitReader &r);
static int read_intra_pred_mode_any(Ctx &s, BitReader &r, int pa, int pb);
static int read_chroma_mode_any(Ctx &s, BitReader &r, int avail_intra);
static int read_transform8x8_any(Ctx &s, BitReader &r, int avail);

static void pred_intra4x4_modes(Ctx &s, BitReader &r, int a, int *pr) {
    int32_t *left = s.left_pred;
    int32_t *top = &s.top_pred[s.mb_x * 4];
    pr[0] = read_intra_pred_mode_any(s, r, (a & 2) ? left[0] : 2,
                                     (a & 1) ? top[0] : 2);
    pr[1] = read_intra_pred_mode_any(s, r, (a & 2) ? pr[0] : 2, top[1]);
    pr[2] = read_intra_pred_mode_any(s, r, left[1], (a & 1) ? pr[0] : 2);
    pr[3] = read_intra_pred_mode_any(s, r, pr[2], pr[1]);
    pr[4] = read_intra_pred_mode_any(s, r, (a & 2) ? pr[1] : 2, top[2]);
    pr[5] = read_intra_pred_mode_any(s, r, (a & 2) ? pr[4] : 2, top[3]);
    pr[6] = read_intra_pred_mode_any(s, r, pr[3], pr[4]);
    pr[7] = read_intra_pred_mode_any(s, r, pr[6], pr[5]);
    pr[8] = read_intra_pred_mode_any(s, r, left[2], (a & 1) ? pr[2] : 2);
    pr[9] = read_intra_pred_mode_any(s, r, pr[8], pr[3]);
    pr[10] = read_intra_pred_mode_any(s, r, left[3], (a & 1) ? pr[8] : 2);
    pr[11] = read_intra_pred_mode_any(s, r, pr[10], pr[9]);
    pr[12] = read_intra_pred_mode_any(s, r, pr[9], pr[6]);
    pr[13] = read_intra_pred_mode_any(s, r, pr[12], pr[7]);
    pr[14] = read_intra_pred_mode_any(s, r, pr[11], pr[12]);
    pr[15] = read_intra_pred_mode_any(s, r, pr[14], pr[13]);
    left[0] = pr[5]; left[1] = pr[7]; left[2] = pr[13]; left[3] = pr[15];
    top[0] = pr[10]; top[1] = pr[11]; top[2] = pr[14]; top[3] = pr[15];
}

static void intra_chroma_pred(Ctx &s, BitReader &r, int avail_intra) {
    int mode = read_chroma_mode_any(s, r, avail_intra);
    s.plan.chroma_mode[s.mb_pos] = mode;
    s.plan.mb_avail[s.mb_pos] = avail_intra;
}

static void residual_chroma(Ctx &s, BitReader &r, int cbp, int avail) {
    int cbp_c = cbp >> 4;
    int32_t *lc = s.left_coef;
    int32_t *tc = &s.top_coef[s.mb_x * 8];
    if (!cbp_c) {
        lc[4] = lc[5] = lc[6] = lc[7] = 0;
        tc[4] = tc[5] = tc[6] = tc[7] = 0;
        return;
    }
    int32_t coeff[64];
    int32_t dc[2][4];
    for (int i = 0; i < 2; i++) {
        if (residual_block_any(s, r, 0, 0, coeff, s.qmatc[i], 3, 16 + i,
                               avail)) {
            chroma_dc_transform(coeff, dc[i]);
        } else {
            dc[i][0] = dc[i][1] = dc[i][2] = dc[i][3] = 0;
        }
    }
    int32_t *pc = &s.plan.coef_chroma[s.mb_pos * 128];  // [2][4][16]
    if (cbp_c & 2) {
        int32_t left[4] = {lc[4], lc[5], lc[6], lc[7]};
        int32_t topv[4] = {tc[4], tc[5], tc[6], tc[7]};
        int32_t new_left[4] = {0, 0, 0, 0}, new_top[4] = {0, 0, 0, 0};
        for (int i = 0; i < 2; i++) {
            int c0l = (avail & 1) ? left[i * 2] : -1;
            int c2l = (avail & 1) ? left[i * 2 + 1] : -1;
            int c0t = (avail & 2) ? topv[i * 2] : -1;
            int c1t = (avail & 2) ? topv[i * 2 + 1] : -1;
            int nc[4] = {0, 0, 0, 0};
            for (int b = 0; b < 4; b++) {
                int na, nb2;
                if (b == 0) { na = c0l; nb2 = c0t; }
                else if (b == 1) { na = nc[0]; nb2 = c1t; }
                else if (b == 2) { na = c2l; nb2 = nc[0]; }
                else { na = nc[2]; nb2 = nc[1]; }
                int cnum = residual_block_any(s, r, na, nb2, coeff,
                                              s.qmatc[i], 4,
                                              18 + i * 4 + b, avail);
                if (cnum < 0) return;  // propagated error unreachable here
                nc[b] = cnum;
                int32_t *dst = pc + i * 64 + b * 16;
                if (cnum) {
                    coeff[0] = dc[i][b];
                    memcpy(dst, coeff, 16 * sizeof(int32_t));
                    s.plan.coded[s.mb_pos] |= 1u << (16 + i * 4 + b);
                } else if (dc[i][b]) {
                    memset(dst, 0, 16 * sizeof(int32_t));
                    dst[0] = dc[i][b];
                    s.plan.coded[s.mb_pos] |= 1u << (16 + i * 4 + b);
                }
            }
            new_left[i * 2] = nc[1];
            new_left[i * 2 + 1] = nc[3];
            new_top[i * 2] = nc[2];
            new_top[i * 2 + 1] = nc[3];
        }
        for (int k = 0; k < 4; k++) {
            lc[4 + k] = new_left[k];
            tc[4 + k] = new_top[k];
        }
    } else {
        for (int i = 0; i < 2; i++)
            for (int b = 0; b < 4; b++)
                if (dc[i][b]) {
                    int32_t *dst = pc + i * 64 + b * 16;
                    memset(dst, 0, 16 * sizeof(int32_t));
                    dst[0] = dc[i][b];
                    s.plan.coded[s.mb_pos] |= 1u << (16 + i * 4 + b);
                }
        lc[4] = lc[5] = lc[6] = lc[7] = 0;
        tc[4] = tc[5] = tc[6] = tc[7] = 0;
    }
}

static int mb_intra4x4(Ctx &s, BitReader &r, int avail) {
    int avail_intra = avail_intra_of(s, avail);
    if (!(avail_intra & 1))
        for (int k = 0; k < 4; k++) s.left_pred[k] = 2;
    if (!(avail_intra & 2))
        for (int k = 0; k < 4; k++) s.top_pred[s.mb_x * 4 + k] = 2;
    int pr[16];
    pred_intra4x4_modes(s, r, avail_intra, pr);
    intra_chroma_pred(s, r, avail_intra);
    int cbp = read_cbp_any(s, r, avail, 0);
    if (cbp < 0) return -2;
    if (cbp) {
        int qp_delta = read_qp_delta_any(s, r);
        if (qp_delta) set_qp(s, s.qp + qp_delta);
    } else {
        s.prev_qp_delta = 0;
    }
    s.plan.kind[s.mb_pos] = 1;
    int blk_avail[16];
    intra4x4_block_avail(avail_intra, blk_avail);
    int nc[16] = {0};
    int32_t coeff[64];
    int32_t *cl = &s.plan.coef_luma[s.mb_pos * 256];
    int32_t *i4m = &s.plan.i4_modes[s.mb_pos * 16];
    int32_t *i4a = &s.plan.i4_avail[s.mb_pos * 16];
    for (int i = 0; i < 16; i++) {
        int by = ZPOS_Y[i], bx = ZPOS_X[i];
        int blk = (by >> 2) * 4 + (bx >> 2);
        i4m[blk] = pr[i];
        i4a[blk] = blk_avail[i];
        if (cbp & (1 << (i >> 2))) {
            int na = nc_resolve(s, NC_WIRING[i][0], nc, avail, true);
            int nb = nc_resolve(s, NC_WIRING[i][1], nc, avail, false);
            int cnum = residual_block_any(s, r, na, nb, coeff, s.qmaty, 2,
                                          i, avail_intra);
            if (cnum < 0) return -2;
            nc[i] = cnum;
            if (cnum) {
                memcpy(cl + blk * 16, coeff, 16 * sizeof(int32_t));
                s.plan.coded[s.mb_pos] |= 1u << blk;
            }
        }
    }
    s.left_coef[0] = nc[5]; s.left_coef[1] = nc[7];
    s.left_coef[2] = nc[13]; s.left_coef[3] = nc[15];
    int32_t *tc = &s.top_coef[s.mb_x * 8];
    tc[0] = nc[10]; tc[1] = nc[11]; tc[2] = nc[14]; tc[3] = nc[15];
    store_strength_intra(s, 0xFFFFFFFFll);
    intra_save_info(s, 0);
    s.cbp = cbp;
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static void pred_intra8x8_modes(Ctx &s, BitReader &r, int a, int *pr) {
    int32_t *left = s.left_pred;
    int32_t *top = &s.top_pred[s.mb_x * 4];
    pr[0] = read_intra_pred_mode_any(s, r, (a & 2) ? left[0] : 2,
                                     (a & 1) ? top[0] : 2);
    pr[1] = read_intra_pred_mode_any(s, r, (a & 2) ? pr[0] : 2, top[2]);
    pr[2] = read_intra_pred_mode_any(s, r, left[2], (a & 1) ? pr[0] : 2);
    pr[3] = read_intra_pred_mode_any(s, r, pr[2], pr[1]);
    left[0] = pr[1]; left[1] = pr[1]; left[2] = pr[3]; left[3] = pr[3];
    top[0] = pr[2]; top[1] = pr[2]; top[2] = pr[3]; top[3] = pr[3];
}

static int mb_intra8x8(Ctx &s, BitReader &r, int avail) {
    int avail_intra = avail_intra_of(s, avail);
    if (!(avail_intra & 1))
        for (int k = 0; k < 4; k++) s.left_pred[k] = 2;
    if (!(avail_intra & 2))
        for (int k = 0; k < 4; k++) s.top_pred[s.mb_x * 4 + k] = 2;
    int pr[4];
    pred_intra8x8_modes(s, r, avail_intra, pr);
    intra_chroma_pred(s, r, avail_intra);
    int cbp = read_cbp_any(s, r, avail, 0);
    if (cbp < 0) return -2;
    if (cbp) {
        int qp_delta = read_qp_delta_any(s, r);
        if (qp_delta) set_qp(s, s.qp + qp_delta);
    } else {
        s.prev_qp_delta = 0;
    }
    s.plan.kind[s.mb_pos] = 2;
    s.plan.t8x8[s.mb_pos] = 1;
    int blkav[4] = {
        (avail_intra & ~4) | ((avail_intra & 2) * 2),
        (avail_intra & ~8) | ((avail_intra & 2) * 4) | 1,
        6 | ((avail_intra & 1) * 9),
        11};
    int32_t coeff[64];
    int cs[4] = {0, 0, 0, 0};
    int32_t *lc = s.left_coef;
    int32_t *tcf = &s.top_coef[s.mb_x * 8];
    int32_t *cl = &s.plan.coef_luma[s.mb_pos * 256];
    for (int b = 0; b < 4; b++) {
        s.plan.i8_modes[s.mb_pos * 4 + b] = pr[b];
        s.plan.i8_avail[s.mb_pos * 4 + b] = blkav[b];
        if (cbp & (1 << b)) {
            int na, nb;
            if (b == 0) {
                na = (avail & 1) ? lc[0] : -1;
                nb = (avail & 2) ? tcf[0] : -1;
            } else if (b == 1) {
                na = cs[0];
                nb = (avail & 2) ? tcf[2] : -1;
            } else if (b == 2) {
                na = (avail & 1) ? lc[2] : -1;
                nb = cs[1];
            } else {
                na = cs[2];
                nb = cs[1];
            }
            int cnum = residual_block_any(s, r, na, nb, coeff, s.qmaty8, 5,
                                          b * 4, avail_intra);
            if (cnum < 0) return -2;
            cs[b] = cnum;
            if (cnum) {
                memcpy(cl + b * 64, coeff, 64 * sizeof(int32_t));
                s.plan.coded[s.mb_pos] |= 1u << b;
            }
        }
    }
    lc[0] = cs[1]; lc[1] = cs[1]; lc[2] = cs[3]; lc[3] = cs[3];
    tcf[0] = cs[2]; tcf[1] = cs[2]; tcf[2] = cs[3]; tcf[3] = cs[3];
    store_strength_intra(s, 0x00FF00FFll);
    intra_save_info(s, 1);
    s.cbp = cbp;
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static int mb_intra16x16(Ctx &s, BitReader &r, int mbtype, int avail) {
    int k = mbtype - 1;
    int pred_mode = k & 3;
    static const int CBP_HI[3] = {0, 0x10, 0x20};
    int cbp = CBP_HI[(k >> 2) % 3] | (k >= 12 ? 0x0F : 0);
    int avail_intra = avail_intra_of(s, avail);
    s.plan.kind[s.mb_pos] = 3;
    s.plan.i16_mode[s.mb_pos] = pred_mode;
    s.plan.mb_avail[s.mb_pos] = avail_intra;
    intra_chroma_pred(s, r, avail_intra);
    int qp_delta = read_qp_delta_any(s, r);
    if (qp_delta) set_qp(s, s.qp + qp_delta);
    int na = (avail & 1) ? s.left_coef[0] : -1;
    int nb = (avail & 2) ? s.top_coef[s.mb_x * 8] : -1;
    int32_t coeff[64];
    int32_t dc[16] = {0};
    int cnum0 = residual_block_any(s, r, na, nb, coeff, s.qmaty, 0, 26,
                                   avail_intra);
    if (cnum0 < 0) return -2;
    if (cnum0) luma_dc_transform(coeff, dc);
    int32_t *cl = &s.plan.coef_luma[s.mb_pos * 256];
    if (cbp & 0x0F) {
        int nc[16] = {0};
        int new_left[4], new_top[4];
        for (int i = 0; i < 16; i++) {
            int na2 = nc_resolve(s, NC_WIRING[i][0], nc, avail, true);
            int nb2 = nc_resolve(s, NC_WIRING[i][1], nc, avail, false);
            int cnum = residual_block_any(s, r, na2, nb2, coeff, s.qmaty,
                                          1, i, avail_intra);
            if (cnum < 0) return -2;
            nc[i] = cnum;
            int by = ZPOS_Y[i], bx = ZPOS_X[i];
            int blk = (by >> 2) * 4 + (bx >> 2);
            int dci = blk;
            if (cnum) {
                coeff[0] = dc[dci];
                memcpy(cl + blk * 16, coeff, 16 * sizeof(int32_t));
                s.plan.coded[s.mb_pos] |= 1u << blk;
            } else if (dc[dci]) {
                memset(cl + blk * 16, 0, 16 * sizeof(int32_t));
                cl[blk * 16] = dc[dci];
                s.plan.coded[s.mb_pos] |= 1u << blk;
            }
        }
        new_left[0] = nc[5]; new_left[1] = nc[7];
        new_left[2] = nc[13]; new_left[3] = nc[15];
        new_top[0] = nc[10]; new_top[1] = nc[11];
        new_top[2] = nc[14]; new_top[3] = nc[15];
        for (int j = 0; j < 4; j++) {
            s.left_coef[j] = new_left[j];
            s.top_coef[s.mb_x * 8 + j] = new_top[j];
        }
    } else {
        for (int blk = 0; blk < 16; blk++)
            if (dc[blk]) {
                memset(cl + blk * 16, 0, 16 * sizeof(int32_t));
                cl[blk * 16] = dc[blk];
                s.plan.coded[s.mb_pos] |= 1u << blk;
            }
        for (int j = 0; j < 4; j++) {
            s.left_coef[j] = 0;
            s.top_coef[s.mb_x * 8 + j] = 0;
        }
    }
    for (int j = 0; j < 4; j++) {
        s.left_pred[j] = 2;
        s.top_pred[s.mb_x * 4 + j] = 2;
    }
    store_strength_intra(s, 0xFFFFFFFFll);
    intra_save_info(s, 0);
    s.cbp = cbp;
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static int mb_intrapcm(Ctx &s, BitReader &r) {
    r.byte_align();
    uint8_t *dst = &s.plan.pcm[s.mb_pos * 384];
    for (int i = 0; i < 384; i++) dst[i] = (uint8_t)r.get(8);
    s.plan.kind[s.mb_pos] = 4;
    for (int k = 0; k < 4; k++) {
        s.left_coef[k] = 15;
        s.left_coef[4 + k] = 15;
        s.top_coef[s.mb_x * 8 + k] = 15;
        s.top_coef[s.mb_x * 8 + 4 + k] = 15;
        s.left_pred[k] = 2;
        s.top_pred[s.mb_x * 4 + k] = 2;
    }
    int p = s.mb_pos;
    s.plan.deb_qpy[p] = 0;
    s.plan.deb_qpc[p * 2] = s.qp_chroma[0] - s.qp;
    s.plan.deb_qpc[p * 2 + 1] = s.qp_chroma[1] - s.qp;
    s.plan.deb_str4[p * 2] = 1;
    s.plan.deb_str4[p * 2 + 1] = 1;
    s.plan.deb_str[p * 2] = 0xFF00FFll;
    s.plan.deb_str[p * 2 + 1] = 0xFF00FFll;
    s.prev_qp_delta = 0;
    s.cbp = 0x3F;
    s.cbf = 0x7FFFFFF;
    intra_save_info(s, 0);
    return 0;
}

// ---------------------------------------------------------------------
// CAVLC/CABAC syntax dispatchers (CABAC arms filled in the CABAC stage)
// ---------------------------------------------------------------------
static int cabac_residual(Ctx &s, BitReader &r, int32_t *coeff,
                          const int32_t *qmat, int avail, int pos4x4,
                          int cat);
static int cabac_cbp(Ctx &s, BitReader &r, int avail);
static int cabac_qp_delta(Ctx &s, BitReader &r);
static int cabac_intra4x4_pred_mode(Ctx &s, BitReader &r, int pa, int pb);
static int cabac_intra_chroma_pred_mode(Ctx &s, BitReader &r, int avail);
static int cabac_transform8x8_flag(Ctx &s, BitReader &r, int avail);

static int residual_block_any(Ctx &s, BitReader &r, int na, int nb,
                              int32_t *coeff, const int32_t *qmat, int cat,
                              int pos4x4, int avail) {
    ProfScope _p(1);
    int cnum;
    if (s.sp.is_cabac) {
        cnum = cabac_residual(s, r, coeff, qmat, avail, pos4x4, cat);
        return cnum;
    }
    cnum = cavlc_residual(s, r, na, nb, coeff, qmat, cat);
    if (cnum > 0)
        s.cbf |= (uint32_t)(cat == 5 ? 0xF : 1) << pos4x4;
    return cnum;
}

static int read_cbp_any(Ctx &s, BitReader &r, int avail, int inter) {
    if (s.sp.is_cabac) return cabac_cbp(s, r, avail);
    return read_me_cbp(r, inter);
}

static int read_qp_delta_any(Ctx &s, BitReader &r) {
    if (s.sp.is_cabac) return cabac_qp_delta(s, r);
    return read_qp_delta_cavlc(s, r);
}

static int read_intra_pred_mode_any(Ctx &s, BitReader &r, int pa, int pb) {
    if (s.sp.is_cabac) return cabac_intra4x4_pred_mode(s, r, pa, pb);
    int p = pa < pb ? pa : pb;
    if (!r.get1()) {
        int rem = r.get(3);
        p = rem < p ? rem : rem + 1;
    }
    return p;
}

static int read_chroma_mode_any(Ctx &s, BitReader &r, int avail_intra) {
    int mode;
    if (s.sp.is_cabac) {
        mode = cabac_intra_chroma_pred_mode(s, r, avail_intra);
    } else {
        mode = r.ue();
        mode = (mode >= 0 && mode <= 3) ? mode : 0;
        s.chroma_pred_mode = mode;
    }
    return mode;
}

static int read_transform8x8_any(Ctx &s, BitReader &r, int avail) {
    if (s.sp.is_cabac) return cabac_transform8x8_flag(s, r, avail);
    return r.get1();
}

// ---------------------------------------------------------------------
// MB layer dispatch (intra kinds; inter added in later stages)
// ---------------------------------------------------------------------
static int mb_inter_dispatch(Ctx &s, BitReader &r, int mbtype, int avail);

static int mb_dispatch(Ctx &s, BitReader &r, int mbtype, int avail) {
    ProfScope _p6(6);
    if (mbtype == MB_INxN) {
        if (s.sp.t8x8_mode) {
            if (read_transform8x8_any(s, r, avail))
                return mb_intra8x8(s, r, avail);
            return mb_intra4x4(s, r, avail);
        }
        return mb_intra4x4(s, r, avail);
    }
    if (mbtype < MB_IPCM) return mb_intra16x16(s, r, mbtype, avail);
    if (mbtype == MB_IPCM) return mb_intrapcm(s, r);
    return mb_inter_dispatch(s, r, mbtype, avail);
}

static inline void deb_idc_entry_clear(Ctx &s) {
    /* the entered MB's slice-start idc mark clears unless THIS slice's
     * preamble wrote it — placed at entry (not in increment_mb_pos) so
     * concurrent slice workers never write across a slice boundary */
    if (s.mb_pos != s.sp.first_mb) s.plan.deb_idc[s.mb_pos] = 0;
}

static int macroblock_layer(Ctx &s, BitReader &r) {
    ProfScope _p5(5);
    deb_idc_entry_clear(s);
    {   // hide plan-array write-miss latency: warm the NEXT MB's hot
        // output lines while this MB parses (the 1080p plan spans
        // ~13 MB/picture; ~half the parse cycles are memory stalls)
        int nmb = s.mb_pos + 1;
        char *cl = (char *)&s.plan.coef_luma[nmb * 256];
        for (int o = 0; o < 1024; o += 64)
            __builtin_prefetch(cl + o, 1);
        char *cc = (char *)&s.plan.coef_chroma[nmb * 128];
        for (int o = 0; o < 512; o += 64)
            __builtin_prefetch(cc + o, 1);
        char *cm = (char *)&s.plan.mv[nmb * 64];
        for (int o = 0; o < 256; o += 64)
            __builtin_prefetch(cm + o, 1);
        __builtin_prefetch(&s.plan.deb_str[nmb * 2], 1);
    }
    int mbtype = r.ue();
    if (mbtype < 0) return -2;
    int st = s.sp.slice_type;
    if (st == P_SLICE) {
        mbtype -= 5;
        if (mbtype < 0) mbtype += MB_PSKIP;
    } else if (st == B_SLICE) {
        mbtype -= 23;
        if (mbtype < 0) mbtype += 23 + MB_PSKIP;
    }
    s.mb_type = mbtype;
    int avail = get_avail(s);
    return mb_dispatch(s, r, mbtype, avail);
}

// ---------------------------------------------------------------------
// slice data loop (slice_data, h264.cpp:10210-10251)
// ---------------------------------------------------------------------
static int skip_mbs(Ctx &s, int skip_num);  // inter stage
static int slice_data_cabac(Ctx &s, BitReader &r);

static int slice_data(Ctx &s, BitReader &r) {
    if (s.sp.is_cabac) return slice_data_cabac(s, r);
    for (;;) {
        if (s.sp.slice_type != I_SLICE) {
            int skip_num = r.ue();
            if (skip_num < 0) return -2;
            if (skip_num) {
                int e = skip_mbs(s, skip_num);
                if (e == -1) break;
                if (e < -1) return e;
            }
            if (!r.more_rbsp_data()) break;
        }
        int e = macroblock_layer(s, r);
        if (e < 0) return e;
        if (r.past_end()) return -2;  // truncated mid-slice
        s.mbleft.mb_skip = 0;
        top_of(s).mb_skip = 0;
        if (increment_mb_pos(s) < 0) break;
        if (!r.more_rbsp_data()) break;
    }
    return r.past_end() ? -2 : 0;
}


// =====================================================================
// Inter stage: MV prediction, partitions, skip, B-direct, strengths
// (mirrors m2dec_tpu/codecs/h264/inter.py and bdirect.py)
// =====================================================================
typedef int32_t V2[2];
static const V2 ZMV = {0, 0};

struct Prev8x8 {  // prev8x8_t (h264.h:350-354)
    int32_t ref[2];
    int32_t mv[4][2][2];
    int32_t mvd[4][2][2];
    void init() {
        ref[0] = ref[1] = -1;
        memset(mv, 0, sizeof(mv));
        memset(mvd, 0, sizeof(mvd));
    }
};

static inline int med3(int a, int b, int c) {
    return (a <= b) ? ((b <= c) ? b : (a <= c ? c : a))
                    : ((a <= c) ? a : (b <= c ? c : b));
}

struct PMV {
    int32_t pmx, pmy;
    const int32_t *mvd_a, *mvd_b;
};

static PMV determine_pmv(const int32_t *mva, const int32_t *mvb,
                         const int32_t *mvc, int avail, int idx_map,
                         const int32_t *mvd_a, const int32_t *mvd_b) {
    PMV o;
    o.mvd_a = mvd_a;
    o.mvd_b = mvd_b;
    if ((avail & 7) == 1 || idx_map == 1) {
        o.pmx = mva[0]; o.pmy = mva[1];
    } else if (0xE9 & (1 << idx_map)) {
        o.pmx = med3(mva[0], mvb[0], mvc[0]);
        o.pmy = med3(mva[1], mvb[1], mvc[1]);
    } else if (idx_map == 2) {
        o.pmx = mvb[0]; o.pmy = mvb[1];
    } else {
        o.pmx = mvc[0]; o.pmy = mvc[1];
    }
    return o;
}

static PMV calc_mv16x16(Ctx &s, int lx, int ref_idx, int avail) {
    PrevMb &left = s.mbleft;
    PrevMb &top = top_of(s);
    PrevMb &topr = topright_of(s);
    int idx_map = 0;
    const int32_t *mva = ZMV, *mvd_a = ZMV, *mvb = ZMV, *mvd_b = ZMV,
                  *mvc = ZMV;
    if (avail & 1) {
        idx_map = (ref_idx == left.ref[0][lx]);
        mva = left.mov[0][lx];
        mvd_a = left.mvd[0][lx];
    }
    if (avail & 2) {
        idx_map |= (ref_idx == top.ref[0][lx]) * 2;
        mvb = top.mov[0][lx];
        mvd_b = top.mvd[0][lx];
    }
    if (avail & 4) {
        idx_map |= (ref_idx == topr.ref[0][lx]) * 4;
        mvc = topr.mov[0][lx];
    } else if (avail & 8) {
        idx_map |= (ref_idx == s.lefttop_ref[lx]) * 4;
        mvc = s.lefttop_mv[lx];
    }
    return determine_pmv(mva, mvb, mvc, avail, idx_map, mvd_a, mvd_b);
}

static PMV calc_mv16x8top(Ctx &s, int lx, int ref_idx, int avail) {
    PrevMb &left = s.mbleft;
    PrevMb &top = top_of(s);
    PrevMb &topr = topright_of(s);
    const int32_t *mva = ZMV, *mvd_a = ZMV, *mvb = ZMV, *mvd_b = ZMV,
                  *mvc = ZMV;
    int idx_map = 0;
    if (avail & 2) {
        mvd_b = top.mvd[0][lx];
        if (ref_idx == top.ref[0][lx]) {
            mvd_a = (avail & 1) ? left.mvd[0][lx] : ZMV;
            PMV o = {top.mov[0][lx][0], top.mov[0][lx][1], mvd_a, mvd_b};
            return o;
        }
        mvb = top.mov[0][lx];
    }
    if (avail & 1) {
        idx_map = (ref_idx == left.ref[0][lx]);
        mva = left.mov[0][lx];
        mvd_a = left.mvd[0][lx];
    }
    if (avail & 4) {
        idx_map |= (ref_idx == topr.ref[0][lx]) * 4;
        mvc = topr.mov[0][lx];
    } else if (avail & 8) {
        idx_map |= (ref_idx == s.lefttop_ref[lx]) * 4;
        mvc = s.lefttop_mv[lx];
    }
    if (avail & 2) idx_map |= (ref_idx == top.ref[0][lx]) * 2;
    return determine_pmv(mva, mvb, mvc, avail, idx_map, mvd_a, mvd_b);
}

static PMV calc_mv16x8bottom(Ctx &s, int lx, int ref_idx, int avail,
                             int prev_ref, const V2 *prev_mv,
                             const V2 *prev_mvd) {
    PrevMb &left = s.mbleft;
    const int32_t *mva = ZMV, *mvd_a = ZMV, *mvc = ZMV;
    int idx_map = 0;
    if (avail & 1) {
        mvd_a = left.mvd[2][lx];
        if (ref_idx == left.ref[1][lx]) {
            PMV o = {left.mov[2][lx][0], left.mov[2][lx][1], mvd_a,
                     prev_mvd[lx]};
            return o;
        }
        idx_map = (ref_idx == left.ref[0][lx]) * 4;
        mva = left.mov[2][lx];
        mvc = left.mov[1][lx];
    }
    const int32_t *mvb = prev_mv[lx];
    const int32_t *mvd_b = prev_mvd[lx];
    idx_map |= (ref_idx == prev_ref) * 2;
    return determine_pmv(mva, mvb, mvc, avail | 2, idx_map, mvd_a, mvd_b);
}

static PMV calc_mv8x16left(Ctx &s, int lx, int ref_idx, int avail) {
    PrevMb &left = s.mbleft;
    PrevMb &top = top_of(s);
    const int32_t *mva = ZMV, *mvd_a = ZMV, *mvb = ZMV, *mvd_b = ZMV,
                  *mvc = ZMV;
    if (avail & 1) {
        mvd_a = left.mvd[0][lx];
        if (ref_idx == left.ref[0][lx]) {
            mvd_b = (avail & 2) ? top.mvd[0][lx] : ZMV;
            PMV o = {left.mov[0][lx][0], left.mov[0][lx][1], mvd_a, mvd_b};
            return o;
        }
        mva = left.mov[0][lx];
    }
    int idx_map = 0;
    if (avail & 2) {
        idx_map |= (ref_idx == top.ref[0][lx]) * 2;
        idx_map |= (ref_idx == top.ref[1][lx]) * 4;
        avail |= 4;
        mvb = top.mov[0][lx];
        mvd_b = top.mvd[0][lx];
        mvc = top.mov[2][lx];
    } else {
        avail &= ~4;
        if (avail & 8) {
            idx_map |= (ref_idx == s.lefttop_ref[lx]) * 4;
            mvc = s.lefttop_mv[lx];
        }
    }
    if ((avail & 1) && ref_idx == left.ref[0][lx]) idx_map |= 1;
    return determine_pmv(mva, mvb, mvc, avail, idx_map, mvd_a, mvd_b);
}

static PMV calc_mv8x16right(Ctx &s, int lx, int ref_idx, int avail,
                            int prev_ref, const V2 *prev_mv,
                            const V2 *prev_mvd) {
    PrevMb &top = top_of(s);
    PrevMb &topr = topright_of(s);
    int idx_map = 0;
    const int32_t *mva = ZMV, *mvd_a = ZMV, *mvb = ZMV, *mvd_b = ZMV,
                  *mvc = ZMV;
    if (avail & 4) {
        if (ref_idx == topr.ref[0][lx]) {
            mvd_a = prev_mvd[lx];
            mvd_b = (avail & 2) ? top.mvd[2][lx] : ZMV;
            PMV o = {topr.mov[0][lx][0], topr.mov[0][lx][1], mvd_a, mvd_b};
            return o;
        }
        mvc = topr.mov[0][lx];
    } else if (avail & 2) {
        idx_map = (ref_idx == top.ref[0][lx]) * 4;
        mvd_b = top.mvd[2][lx];
        if (idx_map) {
            mvd_a = prev_mvd[lx];
            PMV o = {top.mov[1][lx][0], top.mov[1][lx][1], mvd_a, mvd_b};
            return o;
        }
        mvc = top.mov[1][lx];
    }
    idx_map |= (ref_idx == prev_ref);
    mva = prev_mv[lx];
    mvd_a = prev_mvd[lx];
    avail |= 1;
    if (avail & 2) {
        idx_map |= (ref_idx == top.ref[1][lx]) * 2;
        mvb = top.mov[2][lx];
        mvd_b = top.mvd[2][lx];
    } else {
        mvb = ZMV;
        mvd_b = ZMV;
    }
    return determine_pmv(mva, mvb, mvc, avail, idx_map, mvd_a, mvd_b);
}

struct CRes { const int32_t *mvc; int idx; int avail; };

static CRes calc8x8_c(Ctx &s, int sub_kind, int lx, int ref_idx, int avail,
                      int blk_idx, Prev8x8 *pblk, int sub) {
    PrevMb &left = s.mbleft;
    PrevMb &top = top_of(s);
    PrevMb &topr = topright_of(s);
    CRes o = {ZMV, 0, avail};
    if (sub_kind == 0) {
        if (blk_idx == 0) {
            if (avail & 2) {
                o.idx = (ref_idx == top.ref[1][lx]) * 4;
                o.mvc = top.mov[2][lx];
                o.avail = avail | 4;
            } else if (avail & 8) {
                o.idx = (ref_idx == s.lefttop_ref[lx]) * 4;
                o.mvc = s.lefttop_mv[lx];
                o.avail = avail | 4;
            } else {
                o.avail = avail & ~4;
            }
        } else if (blk_idx == 1) {
            if (avail & 4) {
                o.idx = (ref_idx == topr.ref[0][lx]) * 4;
                o.mvc = topr.mov[0][lx];
            } else if (avail & 2) {
                o.idx = (ref_idx == top.ref[0][lx]) * 4;
                o.mvc = top.mov[1][lx];
            }
        } else if (blk_idx == 2) {
            o.idx = (ref_idx == pblk[1].ref[lx]) * 4;
            o.mvc = pblk[1].mv[2][lx];
            o.avail = avail | 4;
        } else {
            o.idx = (ref_idx == pblk[0].ref[lx]) * 4;
            o.mvc = pblk[0].mv[3][lx];
            o.avail = avail | 4;
        }
        return o;
    }
    if (sub_kind == 1) {
        int y = sub;
        if (blk_idx == 0) {
            if (y == 0) {
                if (avail & 2) {
                    o.idx = (ref_idx == top.ref[1][lx]) * 4;
                    o.mvc = top.mov[2][lx];
                    o.avail = avail | 4;
                } else if (avail & 8) {
                    o.idx = (ref_idx == s.lefttop_ref[lx]) * 4;
                    o.mvc = s.lefttop_mv[lx];
                    o.avail = avail | 4;
                } else {
                    o.avail = avail & ~4;
                }
            } else if (avail & 1) {
                o.idx = (ref_idx == left.ref[0][lx]) * 4;
                o.mvc = left.mov[0][lx];
                o.avail = avail | 4;
            } else {
                o.avail = avail & ~4;
            }
        } else if (blk_idx == 1) {
            if (y == 0) {
                if (avail & 4) {
                    o.idx = (ref_idx == topr.ref[0][lx]) * 4;
                    o.mvc = topr.mov[0][lx];
                    o.avail = avail | 4;
                } else if (avail & 2) {
                    o.idx = (ref_idx == top.ref[0][lx]) * 4;
                    o.mvc = top.mov[1][lx];
                    o.avail = avail | 4;
                }
            } else {
                o.idx = (ref_idx == pblk[0].ref[lx]) * 4;
                o.mvc = pblk[0].mv[1][lx];
                o.avail = avail | 4;
            }
        } else if (blk_idx == 2) {
            if (y == 0) {
                o.idx = (ref_idx == pblk[1].ref[lx]) * 4;
                o.mvc = pblk[1].mv[2][lx];
                o.avail = avail | 4;
            } else if (avail & 1) {
                o.idx = (ref_idx == left.ref[1][lx]) * 4;
                o.mvc = left.mov[2][lx];
                o.avail = avail | 4;
            } else {
                o.avail = avail & ~4;
            }
        } else {
            o.idx = (ref_idx == pblk[y * 2].ref[lx]) * 4;
            o.mvc = pblk[y * 2].mv[3 - y * 2][lx];
            o.avail = avail | 4;
        }
        return o;
    }
    if (sub_kind == 2) {
        int x = sub;
        if (blk_idx == 0) {
            if (avail & 2) {
                o.idx = (ref_idx == top.ref[x][lx]) * 4;
                o.mvc = top.mov[x + 1][lx];
                o.avail = avail | 4;
            } else {
                o.avail = avail & ~4;
                if (x == 0 && (o.avail & 8)) {
                    o.idx = (ref_idx == s.lefttop_ref[lx]) * 4;
                    o.mvc = s.lefttop_mv[lx];
                }
            }
        } else if (blk_idx == 1) {
            if (x == 0) {
                if (avail & 2) {
                    o.idx = (ref_idx == top.ref[1][lx]) * 4;
                    o.mvc = top.mov[3][lx];
                    o.avail = avail | 4;
                } else {
                    o.avail = avail & ~4;
                }
            } else if (avail & 4) {
                o.idx = (ref_idx == topr.ref[0][lx]) * 4;
                o.mvc = topr.mov[0][lx];
            } else if (avail & 2) {
                o.idx = (ref_idx == top.ref[1][lx]) * 4;
                o.mvc = (top.ref[1][lx] >= 0) ? top.mov[2][lx] : ZMV;
            }
        } else if (blk_idx == 2) {
            o.idx = (ref_idx == pblk[x].ref[lx]) * 4;
            o.mvc = pblk[x].mv[3 - x][lx];
            o.avail = avail | 4;
        } else {
            o.idx = (ref_idx == pblk[1].ref[lx]) * 4;
            o.mvc = pblk[1].mv[3 - x][lx];
            o.avail = avail | 4;
        }
        return o;
    }
    // sub_kind == 3 (4x4)
    int xy = sub;
    if (blk_idx == 0) {
        if (xy == 0) {
            if (avail & 2) {
                o.idx = (ref_idx == top.ref[0][lx]) * 4;
                o.mvc = top.mov[1][lx];
                o.avail = avail | 4;
            } else if (avail & 8) {
                o.idx = (ref_idx == s.lefttop_ref[lx]) * 4;
                o.mvc = s.lefttop_mv[lx];
                o.avail = avail & ~4;
            } else {
                o.avail = avail & ~4;
            }
        } else if (xy == 1) {
            if (avail & 2) {
                o.idx = (ref_idx == top.ref[1][lx]) * 4;
                o.mvc = top.mov[2][lx];
                o.avail = avail | 4;
            } else {
                o.avail = avail & ~4;
            }
        } else {
            o.idx = 4;
            o.mvc = pblk[blk_idx].mv[3 - xy][lx];
            o.avail = avail | 4;
        }
        return o;
    }
    if (blk_idx == 1) {
        if (xy == 0) {
            if (avail & 2) {
                o.idx = (ref_idx == top.ref[1][lx]) * 4;
                o.mvc = top.mov[3][lx];
                o.avail = avail | 4;
            } else {
                o.avail = avail & ~4;
            }
        } else if (xy == 1) {
            if (avail & 4) {
                o.idx = (ref_idx == topr.ref[0][lx]) * 4;
                o.mvc = topr.mov[0][lx];
            } else if (avail & 2) {
                o.idx = (ref_idx == top.ref[1][lx]) * 4;
                o.mvc = top.mov[2][lx];
                o.avail = avail | 4;
            }
        } else {
            o.idx = 4;
            o.mvc = pblk[blk_idx].mv[3 - xy][lx];
            o.avail = avail | 4;
        }
        return o;
    }
    if (blk_idx == 2) {
        if (xy == 0 || xy == 1) {
            o.idx = (ref_idx == pblk[xy].ref[lx]) * 4;
            o.mvc = pblk[xy].mv[3 - xy][lx];
            o.avail = avail | 4;
        } else {
            o.idx = 4;
            o.mvc = pblk[2].mv[3 - xy][lx];
            o.avail = avail | 4;
        }
        return o;
    }
    if (xy == 0 || xy == 1) {
        o.idx = (ref_idx == pblk[1].ref[lx]) * 4;
        o.mvc = pblk[1].mv[3 - xy][lx];
        o.avail = avail | 4;
    } else {
        o.idx = 4;
        o.mvc = pblk[3].mv[3 - xy][lx];
        o.avail = avail | 4;
    }
    return o;
}

static PMV calc_mv8x8(Ctx &s, int sub_kind, int lx, int ref_idx, int avail,
                      int blk_idx, Prev8x8 *pblk, int sub) {
    PrevMb &left = s.mbleft;
    PrevMb &top = top_of(s);
    int idx_map = 0;
    const int32_t *mva = ZMV, *mvd_a = ZMV, *mvb = ZMV, *mvd_b = ZMV;
    // A neighbor
    if (sub_kind == 2 && sub != 0) {
        idx_map = 1;
        mva = pblk[blk_idx].mv[0][lx];
        mvd_a = pblk[blk_idx].mvd[0][lx];
        avail |= 1;
    } else if (sub_kind == 3 && (sub & 1)) {
        idx_map = 1;
        mva = pblk[blk_idx].mv[sub - 1][lx];
        mvd_a = pblk[blk_idx].mvd[sub - 1][lx];
        avail |= 1;
    } else if (blk_idx & 1) {
        idx_map = (ref_idx == pblk[blk_idx - 1].ref[lx]);
        if (sub_kind == 1) {
            mva = pblk[blk_idx - 1].mv[sub * 2 + 1][lx];
            mvd_a = pblk[blk_idx - 1].mvd[sub * 2 + 1][lx];
        } else if (sub_kind == 3) {
            mva = pblk[blk_idx - 1].mv[sub + 1][lx];
            mvd_a = pblk[blk_idx - 1].mvd[sub + 1][lx];
        } else {
            mva = pblk[blk_idx - 1].mv[1][lx];
            mvd_a = pblk[blk_idx - 1].mvd[1][lx];
        }
        avail |= 1;
    } else if (avail & 1) {
        idx_map = (ref_idx == left.ref[blk_idx >> 1][lx]);
        int k;
        if (sub_kind == 1) k = (blk_idx & 2) + sub;
        else if (sub_kind == 3) k = blk_idx + (sub >> 1);
        else k = blk_idx;
        mva = left.mov[k][lx];
        mvd_a = left.mvd[k][lx];
    }
    // B neighbor
    if (sub_kind == 1 && sub != 0) {
        idx_map |= 2;
        mvb = pblk[blk_idx].mv[0][lx];
        mvd_b = pblk[blk_idx].mvd[0][lx];
        avail |= 2;
    } else if (sub_kind == 3 && (sub & 2)) {
        idx_map |= 2;
        mvb = pblk[blk_idx].mv[sub - 2][lx];
        mvd_b = pblk[blk_idx].mvd[sub - 2][lx];
        avail |= 2;
    } else if (blk_idx & 2) {
        idx_map |= (ref_idx == pblk[blk_idx - 2].ref[lx]) * 2;
        if (sub_kind == 2 || sub_kind == 3) {
            int x = (sub_kind == 2) ? sub : (sub & 1);
            mvb = pblk[blk_idx - 2].mv[2 + x][lx];
            mvd_b = pblk[blk_idx - 2].mvd[2 + x][lx];
        } else {
            mvb = pblk[blk_idx - 2].mv[2][lx];
            mvd_b = pblk[blk_idx - 2].mvd[2][lx];
        }
        avail |= 2;
    } else if (avail & 2) {
        int ri = (sub_kind == 0) ? blk_idx : (blk_idx & 1);
        idx_map |= (ref_idx == top.ref[ri][lx]) * 2;
        int k;
        if (sub_kind == 2) k = blk_idx * 2 + sub;
        else if (sub_kind == 3) k = blk_idx * 2 + (sub & 1);
        else k = blk_idx * 2;
        mvb = top.mov[k][lx];
        mvd_b = top.mvd[k][lx];
    }
    CRes c = calc8x8_c(s, sub_kind, lx, ref_idx, avail, blk_idx, pblk, sub);
    idx_map |= c.idx;
    return determine_pmv(mva, mvb, c.mvc, c.avail, idx_map, mvd_a, mvd_b);
}

// ---------------------------------------------------------------------
// plan recording for inter partitions (PlanRecorder.inter semantics)
// ---------------------------------------------------------------------
static void rec_inter_impl(Ctx &s, int ox, int oy, int bw, int bh,
                      const int32_t *ref_idx, const int32_t mv[2][2],
                      const int32_t wp[3][4]);
static void rec_inter(Ctx &s, int ox, int oy, int bw, int bh,
                      const int32_t *ref_idx, const int32_t mv[2][2],
                      const int32_t wp[3][4]) {
    ProfScope _p(2);
    rec_inter_impl(s, ox, oy, bw, bh, ref_idx, mv, wp);
}
static void rec_inter_impl(Ctx &s, int ox, int oy, int bw, int bh,
                      const int32_t *ref_idx, const int32_t mv[2][2],
                      const int32_t wp[3][4]) {
    int slots[2] = {-1, -1};
    for (int lx = 0; lx < 2; lx++)
        if (ref_idx[lx] >= 0) slots[lx] = s.refs[lx][ref_idx[lx]].frame_idx;
    int mb = s.mb_pos;
    PlanPtrs &p = s.plan;
    for (int by = oy >> 2; by < (oy + bh) >> 2; by++) {
        for (int bx = ox >> 2; bx < (ox + bw) >> 2; bx++) {
            int blk = by * 4 + bx;
            int q = (by >> 1) * 2 + (bx >> 1);
            p.slot[(mb * 4 + q) * 2] = slots[0];
            p.slot[(mb * 4 + q) * 2 + 1] = slots[1];
            memcpy(&p.wp[(mb * 4 + q) * 12], wp, 12 * sizeof(int32_t));
            for (int lx = 0; lx < 2; lx++) {
                if (slots[lx] >= 0) {
                    p.mv[((mb * 16 + blk) * 2 + lx) * 2] = mv[lx][0];
                    p.mv[((mb * 16 + blk) * 2 + lx) * 2 + 1] = mv[lx][1];
                }
            }
        }
    }
}

/* inter_pred_basic / weighted1 / weighted2: in the plan engine these
 * only RECORD the partition (Phase B does the pixels). */
static void inter_pred_basic(Ctx &s, const int32_t *ref_idx,
                             const int32_t mv[2][2], int bw, int bh,
                             int ox, int oy) {
    int r0 = ref_idx[0], r1 = ref_idx[1];
    if (r0 < 0 && r1 < 0) return;
    int wm = s.sp.weighted_mode;
    int32_t wp[3][4];
    if (wm == 1) {
        int sy = s.wshift[0], sc = s.wshift[1];
        if (r0 >= 0 && r1 >= 0) {
            for (int pl = 0; pl < 3; pl++) {
                int sh = pl == 0 ? sy : sc;
                wp[pl][0] = s.wtab[0][r0][pl][0];
                wp[pl][1] = s.wtab[1][r1][pl][0];
                wp[pl][2] = (s.wtab[0][r0][pl][1] + s.wtab[1][r1][pl][1]
                             + 1) >> 1;
                wp[pl][3] = sh + 1;
            }
        } else {
            int lx = r0 >= 0 ? 0 : 1;
            int idx = r0 >= 0 ? r0 : r1;
            for (int pl = 0; pl < 3; pl++) {
                int sh = pl == 0 ? sy : sc;
                wp[pl][0] = s.wtab[lx][idx][pl][0];
                wp[pl][1] = 0;
                wp[pl][2] = s.wtab[lx][idx][pl][1];
                wp[pl][3] = sh;
            }
        }
    } else if (wm == 2 && r0 >= 0 && r1 >= 0) {
        const int32_t *iw = &s.implicit_w[r0][r1][0];
        for (int pl = 0; pl < 3; pl++) {
            wp[pl][0] = iw[0];
            wp[pl][1] = iw[1];
            wp[pl][2] = 0;
            wp[pl][3] = 6;
        }
    } else if (r0 >= 0 && r1 >= 0) {
        for (int pl = 0; pl < 3; pl++) {
            wp[pl][0] = 1; wp[pl][1] = 1; wp[pl][2] = 0; wp[pl][3] = 1;
        }
    } else {
        for (int pl = 0; pl < 3; pl++) {
            wp[pl][0] = 1; wp[pl][1] = 0; wp[pl][2] = 0; wp[pl][3] = 0;
        }
    }
    rec_inter(s, ox, oy, bw, bh, ref_idx, mv, wp);
}

// ---------------------------------------------------------------------
// inter residual (decoder.py _residual_luma_inter*)
// ---------------------------------------------------------------------
static const int64_t EXPAND_STR8x8[16] = {
    0x00000000, 0x000A000A, 0x00A000A0, 0x00AA00AA,
    0x000A0000, 0x000A000A, 0x00AA00A0, 0x00AA00AA,
    0x00A00000, 0x00AA000A, 0x00A000A0, 0x00AA00AA,
    0x00AA0000, 0x00AA000A, 0x00AA00A0, 0x00AA00AA};
static const int CBP_TRANS8x8[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13,
                                     10, 11, 14, 15};
static const int64_t STR_MAP_BIT[16] = {
    0x2, 0x8, 0x200, 0x800, 0x20, 0x80, 0x2000, 0x8000,
    0x20000, 0x80000, 0x2000000, 0x8000000, 0x200000, 0x800000,
    0x20000000, 0x80000000ll};

static int64_t transposition(int64_t a) {
    int64_t b = 0;
    for (int y = 0; y < 8; y += 2)
        for (int x = 0; x < 32; x += 8) {
            b |= (a & 3) << (x + y);
            a >>= 2;
        }
    return b;
}

static void no_residual_inter(Ctx &s) {
    s.prev_qp_delta = 0;
    for (int k = 0; k < 8; k++) {
        s.left_coef[k] = 0;
        s.top_coef[s.mb_x * 8 + k] = 0;
    }
    s.mbleft.transform8x8 = 0;
    top_of(s).transform8x8 = 0;
    s.plan.deb_str[s.mb_pos * 2] = 0;      // vertical-edge set
    s.plan.deb_str[s.mb_pos * 2 + 1] = 0;  // horizontal-edge set
}

static int residual_luma_inter4x4(Ctx &s, BitReader &r, int cbp) {
    int avail = (int)s.avail_saved;
    int nc[16] = {0};
    int64_t str_map = 0;
    int32_t coeff[64];
    int32_t *cl = &s.plan.coef_luma[s.mb_pos * 256];
    for (int i = 0; i < 16; i++) {
        if (!(cbp & (1 << (i >> 2)))) continue;
        int na = nc_resolve(s, NC_WIRING[i][0], nc, avail, true);
        int nb = nc_resolve(s, NC_WIRING[i][1], nc, avail, false);
        int cnum = residual_block_any(s, r, na, nb, coeff, s.qmaty, 2, i,
                                      avail);
        if (cnum < 0) return -2;
        nc[i] = cnum;
        if (cnum) {
            int by = ZPOS_Y[i], bx = ZPOS_X[i];
            int blk = (by >> 2) * 4 + (bx >> 2);
            memcpy(cl + blk * 16, coeff, 16 * sizeof(int32_t));
            s.plan.coded[s.mb_pos] |= 1u << blk;
            str_map |= STR_MAP_BIT[i];
        }
    }
    s.left_coef[0] = nc[5]; s.left_coef[1] = nc[7];
    s.left_coef[2] = nc[13]; s.left_coef[3] = nc[15];
    int32_t *tc = &s.top_coef[s.mb_x * 8];
    tc[0] = nc[10]; tc[1] = nc[11]; tc[2] = nc[14]; tc[3] = nc[15];
    int64_t str_h = transposition(str_map);
    /* plan index 0 = vertical-edge set (reference str_horiz, the
     * TRANSPOSED map); index 1 = horizontal-edge set (str_vert) */
    s.plan.deb_str[s.mb_pos * 2] = ((str_h << 8) | str_h) & 0xFFFFFFFFll;
    s.plan.deb_str[s.mb_pos * 2 + 1] = ((str_map << 8) | str_map)
                                       & 0xFFFFFFFFll;
    return 0;
}

static int residual_luma_inter8x8(Ctx &s, BitReader &r, int cbp) {
    int avail = (int)s.avail_saved;
    int32_t coeff[64];
    cbp &= 15;
    int cs[4] = {0, 0, 0, 0};
    int32_t *lc = s.left_coef;
    int32_t *tcf = &s.top_coef[s.mb_x * 8];
    int32_t *cl = &s.plan.coef_luma[s.mb_pos * 256];
    for (int b = 0; b < 4; b++) {
        if (!(cbp & (1 << b))) continue;
        int na, nb;
        if (b == 0) {
            na = (avail & 1) ? lc[0] : -1;
            nb = (avail & 2) ? tcf[0] : -1;
        } else if (b == 1) {
            na = cs[0];
            nb = (avail & 2) ? tcf[2] : -1;
        } else if (b == 2) {
            na = (avail & 1) ? lc[2] : -1;
            nb = cs[1];
        } else {
            na = cs[2];
            nb = cs[1];
        }
        int cnum = residual_block_any(s, r, na, nb, coeff, s.qmaty8, 5,
                                      b * 4, avail);
        if (cnum < 0) return -2;
        cs[b] = cnum;
        if (cnum) {
            memcpy(cl + b * 64, coeff, 64 * sizeof(int32_t));
            s.plan.coded[s.mb_pos] |= 1u << b;
        }
    }
    lc[0] = cs[1]; lc[1] = cs[1]; lc[2] = cs[3]; lc[3] = cs[3];
    tcf[0] = cs[2]; tcf[1] = cs[2]; tcf[2] = cs[3]; tcf[3] = cs[3];
    s.plan.deb_str[s.mb_pos * 2] = EXPAND_STR8x8[CBP_TRANS8x8[cbp]];
    s.plan.deb_str[s.mb_pos * 2 + 1] = EXPAND_STR8x8[cbp];
    return 0;
}

static int residual_luma_inter(Ctx &s, BitReader &r, int cbp) {
    /* cbp carries NeedTransform8x8 at 0x80 (decoder.py) */
    if (s.sp.t8x8_mode && s.sp.is_cabac) {
        int t8 = 0;
        if ((cbp & 0x8F) > 0x80) {
            t8 = read_transform8x8_any(s, r, (int)s.avail_saved);
            if (t8 < 0) return -2;
        }
        int qp_delta = read_qp_delta_any(s, r);
        if (qp_delta) set_qp(s, s.qp + qp_delta);
        s.mbleft.transform8x8 = t8 ? 1 : 0;
        top_of(s).transform8x8 = t8 ? 1 : 0;
        if (t8) {
            s.plan.t8x8[s.mb_pos] = 1;
            return residual_luma_inter8x8(s, r, cbp);
        }
        return residual_luma_inter4x4(s, r, cbp);
    }
    int qp_delta = read_qp_delta_any(s, r);
    if (qp_delta) set_qp(s, s.qp + qp_delta);
    return residual_luma_inter4x4(s, r, cbp);
}

// ---------------------------------------------------------------------
// deblock strength recording (inter.py)
// ---------------------------------------------------------------------
static inline bool dif4(int a, int b) { return 16 <= (a - b) * (a - b); }

static inline int frame_idx_of(Ctx &s, int ref_idx, int lx) {
    return ref_idx >= 0 ? s.refs[lx][ref_idx].frame_idx : -1;
}

static int64_t str_previous_coef(int64_t map, const int32_t *prev4x4) {
    for (int i = 0; i < 4; i++)
        if (prev4x4[i]) map |= 2ll << (i * 2);
    return map;
}

static inline int64_t str_or_mask(int64_t str, int64_t mask) {
    return str | (((str >> 1) ^ mask) & mask);
}

static int64_t str_mv16x16_mv(int64_t str, int ref0, int ref1, int prev_ref0,
                              int offset, const int32_t mvs[2][2],
                              const PrevMb &prev) {
    if (ref0 >= 0 && ref1 >= 0) {
        if (ref0 == ref1) {
            for (int j = 0; j < 2; j++) {
                int64_t mask = 2ll << ((j + offset) * 2);
                if (!(str & mask)) {
                    const int32_t *p0 = prev.mov[j + offset][0];
                    const int32_t *p1 = prev.mov[j + offset][1];
                    const int32_t *c0 = mvs[0], *c1 = mvs[1];
                    if ((dif4(c0[0], p0[0]) || dif4(c0[1], p0[1])
                         || dif4(c1[0], p1[0]) || dif4(c1[1], p1[1]))
                        && (dif4(c0[0], p1[0]) || dif4(c0[1], p1[1])
                            || dif4(c1[0], p0[0]) || dif4(c1[1], p0[1])))
                        str |= mask >> 1;
                }
            }
        } else {
            int lx0 = (ref0 != prev_ref0);
            int lx1 = lx0 ^ 1;
            for (int j = 0; j < 2; j++) {
                int64_t mask = 2ll << ((j + offset) * 2);
                if (!(str & mask)) {
                    if (dif4(mvs[lx0][0], prev.mov[j + offset][0][0])
                        || dif4(mvs[lx0][1], prev.mov[j + offset][0][1])
                        || dif4(mvs[lx1][0], prev.mov[j + offset][1][0])
                        || dif4(mvs[lx1][1], prev.mov[j + offset][1][1]))
                        str |= mask >> 1;
                }
            }
        }
    } else {
        int lx_curr, lx_prev;
        if (ref0 >= 0) { lx_curr = 0; lx_prev = (ref0 != prev_ref0); }
        else { lx_curr = 1; lx_prev = (ref1 != prev_ref0); }
        for (int j = 0; j < 2; j++) {
            int64_t mask = 2ll << ((j + offset) * 2);
            if (!(str & mask)) {
                const int32_t *p = prev.mov[j + offset][lx_prev];
                if (dif4(mvs[lx_curr][0], p[0]) || dif4(mvs[lx_curr][1], p[1]))
                    str |= mask >> 1;
            }
        }
    }
    return str;
}

static int64_t str_mv_calc16x16(Ctx &s, int64_t str, const int32_t mvs[2][2],
                                const int32_t *ref_idx, const PrevMb &prev) {
    int ref0 = frame_idx_of(s, ref_idx[0], 0);
    int ref1 = frame_idx_of(s, ref_idx[1], 1);
    int64_t mask = 0xA;
    for (int i = 0; i < 2; i++) {
        if ((str & mask) != mask) {
            int prev0 = prev.frmidx[i][0];
            int prev1 = prev.frmidx[i][1];
            if ((prev0 != ref0 || prev1 != ref1)
                && (prev1 != ref0 || prev0 != ref1)) {
                str = str_or_mask(str, mask >> 1);
            } else {
                str = str_mv16x16_mv(str, ref0, ref1, prev0, i * 2, mvs,
                                     prev);
            }
        }
        mask <<= 4;
    }
    return str;
}

struct StrRet { int64_t str; int s4; };

static StrRet store_str_inter16xedge(Ctx &s, const PrevMb &prev,
                                     const int32_t mvs[2][2],
                                     const int32_t *ref_idx, int64_t str,
                                     const int32_t *coeff4x4) {
    if (prev.type <= MB_IPCM) return {str | 0xAA, 1};
    str = str_previous_coef(str, coeff4x4);
    str = str_mv_calc16x16(s, str, mvs, ref_idx, prev);
    return {str, 0};
}

static int64_t str_mv_calc16x8_left(Ctx &s, int64_t str,
                                    const int32_t pairs[2][2],
                                    const int32_t mv_sets[2][2][2],
                                    const PrevMb &prev) {
    for (int i = 0; i < 2; i++) {
        int64_t mask = 0xAll << (i * 4);
        if ((str & mask) != mask) {
            int prev0 = prev.frmidx[i][0];
            int prev1 = prev.frmidx[i][1];
            int ref0 = frame_idx_of(s, pairs[i][0], 0);
            int ref1 = frame_idx_of(s, pairs[i][1], 1);
            if ((prev0 != ref0 || prev1 != ref1)
                && (prev1 != ref0 || prev0 != ref1)) {
                str = str_or_mask(str, mask >> 1);
            } else {
                str = str_mv16x16_mv(str, ref0, ref1, prev0, i * 2,
                                     mv_sets[i], prev);
            }
        }
    }
    return str;
}

static StrRet store_str_inter8xedge(Ctx &s, const PrevMb &prev,
                                    const int32_t mv_sets[2][2][2],
                                    const int32_t pairs[2][2], int64_t str,
                                    const int32_t *coeff4x4) {
    if (prev.type <= MB_IPCM) return {str | 0xAA, 1};
    str = str_previous_coef(str, coeff4x4);
    str = str_mv_calc16x8_left(s, str, pairs, mv_sets, prev);
    return {str, 0};
}

static int64_t str_mv_calc16x8_vert(Ctx &s, int64_t str,
                                    const int32_t *ref_idx4,
                                    const int32_t mv_sets[2][2][2]) {
    if ((str & 0xAA0000) == 0xAA0000) return str;
    int t0 = frame_idx_of(s, ref_idx4[0], 0);
    int t1 = frame_idx_of(s, ref_idx4[1], 1);
    int b0 = frame_idx_of(s, ref_idx4[2], 0);
    int b1 = frame_idx_of(s, ref_idx4[3], 1);
    bool diff = (t0 != b0 || t1 != b1) && (t1 != b0 || t0 != b1);
    if (!diff) {
        if (t0 >= 0 && t1 >= 0) {
            const int32_t *ta, *tb;
            if (t0 == b0) { ta = mv_sets[0][0]; tb = mv_sets[0][1]; }
            else { tb = mv_sets[0][0]; ta = mv_sets[0][1]; }
            const int32_t *ba = mv_sets[1][0];
            const int32_t *bb = mv_sets[1][1];
            diff = dif4(ta[0], ba[0]) || dif4(tb[0], bb[0])
                || dif4(ta[1], ba[1]) || dif4(tb[1], bb[1]);
        } else {
            const int32_t *t = mv_sets[0][t0 < 0 ? 1 : 0];
            const int32_t *b = mv_sets[1][b0 < 0 ? 1 : 0];
            diff = dif4(t[0], b[0]) || dif4(t[1], b[1]);
        }
    }
    if (diff) str = str_or_mask(str, 0x550000);
    return str;
}

static int64_t str_mv_calc8x8_edge(Ctx &s, int64_t str, Prev8x8 *pblk,
                                   const PrevMb &prev, int n) {
    for (int i = 0; i < 2; i++) {
        int64_t mask = 0xAll << (i * 4);
        if ((str & mask) != mask) {
            Prev8x8 &p = pblk[i * n];
            int prev0 = prev.frmidx[i][0];
            int prev1 = prev.frmidx[i][1];
            int ref0 = frame_idx_of(s, p.ref[0], 0);
            int ref1 = frame_idx_of(s, p.ref[1], 1);
            if ((prev0 != ref0 || prev1 != ref1)
                && (prev1 != ref0 || prev0 != ref1)) {
                str = str_or_mask(str, mask >> 1);
            } else if (ref0 >= 0 && ref1 >= 0) {
                int lx = (ref0 != prev0);
                for (int j = 0; j < 2; j++) {
                    int64_t bit = 2ll << ((j + i * 2) * 2);
                    if (!(str & bit)) {
                        const int32_t *cm0 = p.mv[j * n][lx];
                        const int32_t *cm1 = p.mv[j * n][lx ^ 1];
                        const int32_t *pm0 = prev.mov[j + i * 2][0];
                        const int32_t *pm1 = prev.mov[j + i * 2][1];
                        if (dif4(cm0[0], pm0[0]) || dif4(cm0[1], pm0[1])
                            || dif4(cm1[0], pm1[0]) || dif4(cm1[1], pm1[1]))
                            str |= bit >> 1;
                    }
                }
            } else {
                int lx_s, lx_d;
                if (ref0 >= 0) { lx_s = 0; lx_d = (ref0 != prev0); }
                else { lx_s = 1; lx_d = (ref1 != prev0); }
                for (int j = 0; j < 2; j++) {
                    int64_t bit = 2ll << ((j + i * 2) * 2);
                    if (!(str & bit)) {
                        const int32_t *cm = p.mv[j * n][lx_s];
                        const int32_t *pm = prev.mov[j + i * 2][lx_d];
                        if (dif4(cm[0], pm[0]) || dif4(cm[1], pm[1]))
                            str |= bit >> 1;
                    }
                }
            }
        }
    }
    return str;
}

static int64_t str8x8_mv_mid(Ctx &s, int64_t str, Prev8x8 &p, int offset,
                             int n) {
    int ref0 = frame_idx_of(s, p.ref[0], 0);
    int ref1 = frame_idx_of(s, p.ref[1], 1);
    for (int j = 0; j < 2; j++) {
        int64_t bit = 2ll << ((j + offset) * 2);
        if (str & bit) continue;
        const int32_t (*a)[2] = p.mv[j * n];
        const int32_t (*b)[2] = p.mv[j * n + (3 - n)];
        bool d;
        if (ref0 >= 0 && ref1 >= 0) {
            if (ref0 == ref1) {
                d = ((dif4(a[0][0], b[0][0]) || dif4(a[0][1], b[0][1])
                      || dif4(a[1][0], b[1][0]) || dif4(a[1][1], b[1][1]))
                     && (dif4(a[0][0], b[1][0]) || dif4(a[0][1], b[1][1])
                         || dif4(a[1][0], b[0][0]) || dif4(a[1][1], b[0][1])));
            } else {
                d = (dif4(a[0][0], b[0][0]) || dif4(a[0][1], b[0][1])
                     || dif4(a[1][0], b[1][0]) || dif4(a[1][1], b[1][1]));
            }
        } else {
            int lx = (ref1 >= 0);
            d = dif4(a[lx][0], b[lx][0]) || dif4(a[lx][1], b[lx][1]);
        }
        if (d) str |= bit >> 1;
    }
    return str;
}

static int64_t str_mv_calc8x8_inner_blk(Ctx &s, int64_t str, Prev8x8 *pblk,
                                        int n) {
    for (int i = 0; i < 2; i++) {
        int64_t mask = 0xA00ll << (i * 4);
        if ((str & mask) != mask)
            str = str8x8_mv_mid(s, str, pblk[i * n], i * 2 + 4, n);
    }
    for (int i = 0; i < 2; i++) {
        int64_t mask = 0xA0000ll << (i * 4);
        if ((str & mask) != mask) {
            Prev8x8 &p0 = pblk[i * n];
            Prev8x8 &p1 = pblk[i * n + (3 - n)];
            int prev0 = frame_idx_of(s, p0.ref[0], 0);
            int prev1 = frame_idx_of(s, p0.ref[1], 1);
            int ref0 = frame_idx_of(s, p1.ref[0], 0);
            int ref1 = frame_idx_of(s, p1.ref[1], 1);
            int offset = i * 2 + 8;
            if ((prev0 != ref0 || prev1 != ref1)
                && (prev1 != ref0 || prev0 != ref1)) {
                str = str_or_mask(str, 5ll << (offset * 2));
            } else if (ref0 >= 0 && ref1 >= 0) {
                int lx = (ref0 != prev0);
                for (int j = 0; j < 2; j++) {
                    int64_t bit = 2ll << ((j + offset) * 2);
                    if (!(str & bit)) {
                        const int32_t *mv0a = p0.mv[j * n + (3 - n)][0];
                        const int32_t *mv0b = p0.mv[j * n + (3 - n)][1];
                        const int32_t *mv1a = p1.mv[j * n][lx];
                        const int32_t *mv1b = p1.mv[j * n][lx ^ 1];
                        if (dif4(mv0a[0], mv1a[0]) || dif4(mv0a[1], mv1a[1])
                            || dif4(mv0b[0], mv1b[0])
                            || dif4(mv0b[1], mv1b[1]))
                            str |= bit >> 1;
                    }
                }
            } else {
                int lx_d, lx_s;
                if (ref0 >= 0) { lx_d = 0; lx_s = (ref0 != prev0); }
                else { lx_d = 1; lx_s = (ref1 != prev0); }
                for (int j = 0; j < 2; j++) {
                    int64_t bit = 2ll << ((j + offset) * 2);
                    if (!(str & bit)) {
                        const int32_t *mv0 = p0.mv[j * n + (3 - n)][lx_s];
                        const int32_t *mv1 = p1.mv[j * n][lx_d];
                        if (dif4(mv0[0], mv1[0]) || dif4(mv0[1], mv1[1]))
                            str |= bit >> 1;
                    }
                }
            }
        }
    }
    for (int i = 0; i < 2; i++) {
        int64_t mask = 0xA000000ll << (i * 4);
        if ((str & mask) != mask)
            str = str8x8_mv_mid(s, str, pblk[i * n + (3 - n)], i * 2 + 12, n);
    }
    return str;
}

// ---------------------------------------------------------------------
// store_info (inter.py store_info_*)
// ---------------------------------------------------------------------
static void deb_qp_store(Ctx &s) {
    s.plan.deb_qpy[s.mb_pos] = s.qp;
    s.plan.deb_qpc[s.mb_pos * 2] = s.qp_chroma[0];
    s.plan.deb_qpc[s.mb_pos * 2 + 1] = s.qp_chroma[1];
}

#define STRV (s.plan.deb_str[s.mb_pos * 2])       // vertical-edge set
#define STRH (s.plan.deb_str[s.mb_pos * 2 + 1])   // horizontal-edge set
#define STR4V (s.plan.deb_str4[s.mb_pos * 2])
#define STR4H (s.plan.deb_str4[s.mb_pos * 2 + 1])

/* NOTE on naming: the Python DeblockInfo "str_vert" holds the strengths
 * consumed for HORIZONTAL edges in deblock.py (curr.str_vert -> strh) —
 * an inherited reference quirk.  In the plan arrays, index [1]
 * corresponds to str_vert and [0] to str_horiz. */

static void store_info_inter16x16(Ctx &s, const int32_t mvs[2][2],
                                  const int32_t mvds[2][2],
                                  const int32_t *ref_idx,
                                  const int32_t *left4x4,
                                  const int32_t *top4x4) {
    ProfScope _p(3);
    deb_qp_store(s);
    if (s.mb_y != 0) {
        StrRet rr = store_str_inter16xedge(s, top_of(s), mvs, ref_idx,
                                           STRH, top4x4);
        STRH = rr.str;
        if (rr.s4) STR4H = 1;
    }
    if (s.mb_x != 0) {
        StrRet rr = store_str_inter16xedge(s, s.mbleft, mvs, ref_idx,
                                           STRV, left4x4);
        STRV = rr.str;
        if (rr.s4) STR4V = 1;
    }
    for (int k = 0; k < 4; k++) {
        s.top_pred[s.mb_x * 4 + k] = 2;
        s.left_pred[k] = 2;
    }
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    t.direct8x8 = l.direct8x8 = 0;
    for (int i = 0; i < 2; i++) {
        s.lefttop_ref[i] = t.ref[1][i];
        s.lefttop_mv[i][0] = t.mov[3][i][0];
        s.lefttop_mv[i][1] = t.mov[3][i][1];
        int ref = ref_idx[i];
        int frm = frame_idx_of(s, ref, i);
        for (int j = 0; j < 2; j++) {
            t.ref[j][i] = ref;
            t.frmidx[j][i] = frm;
            l.ref[j][i] = ref;
            l.frmidx[j][i] = frm;
        }
    }
    for (int i = 0; i < 4; i++)
        for (int lx = 0; lx < 2; lx++) {
            memcpy(l.mov[i][lx], mvs[lx], 8);
            memcpy(l.mvd[i][lx], mvds[lx], 8);
            memcpy(t.mov[i][lx], mvs[lx], 8);
            memcpy(t.mvd[i][lx], mvds[lx], 8);
        }
    int refcol;
    const int32_t *mvcol;
    if (ref_idx[0] >= 0) { refcol = ref_idx[0]; mvcol = mvs[0]; }
    else { refcol = ref_idx[1]; mvcol = mvs[1]; }
    s.curr_type[s.mb_pos] = 0;
    for (int k = 0; k < 4; k++) s.curr_ref[s.mb_pos * 4 + k] = refcol;
    for (int k = 0; k < 16; k++) {
        s.curr_mv[(s.mb_pos * 16 + k) * 2] = mvcol[0];
        s.curr_mv[(s.mb_pos * 16 + k) * 2 + 1] = mvcol[1];
    }
}

static void store_info_inter16x8(Ctx &s, const int32_t mv_sets[2][2][2],
                                 const int32_t mvd_sets[2][2][2],
                                 const int32_t *ref_idx,
                                 const int32_t *left4x4,
                                 const int32_t *top4x4) {
    ProfScope _p(3);
    deb_qp_store(s);
    int32_t pairs[2][2] = {{ref_idx[0], ref_idx[1]},
                           {ref_idx[2], ref_idx[3]}};
    if (s.mb_y != 0) {
        StrRet rr = store_str_inter16xedge(s, top_of(s), mv_sets[0],
                                           ref_idx, STRH, top4x4);
        STRH = rr.str;
        if (rr.s4) STR4H = 1;
    }
    STRH = str_mv_calc16x8_vert(s, STRH, ref_idx, mv_sets);
    if (s.mb_x != 0) {
        StrRet rr = store_str_inter8xedge(s, s.mbleft, mv_sets, pairs,
                                          STRV, left4x4);
        STRV = rr.str;
        if (rr.s4) STR4V = 1;
    }
    for (int k = 0; k < 4; k++) {
        s.left_pred[k] = 2;
        s.top_pred[s.mb_x * 4 + k] = 2;
    }
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    s.lefttop_ref[0] = t.ref[1][0];
    s.lefttop_ref[1] = t.ref[1][1];
    for (int i = 0; i < 2; i++) {
        s.lefttop_mv[i][0] = t.mov[3][i][0];
        s.lefttop_mv[i][1] = t.mov[3][i][1];
    }
    l.direct8x8 = t.direct8x8 = 0;
    for (int i = 0; i < 4; i++)
        for (int lx = 0; lx < 2; lx++) {
            memcpy(t.mov[i][lx], mv_sets[1][lx], 8);
            memcpy(t.mvd[i][lx], mvd_sets[1][lx], 8);
        }
    int r2 = pairs[1][0], r3 = pairs[1][1];
    int f2 = frame_idx_of(s, r2, 0);
    int f3 = frame_idx_of(s, r3, 1);
    for (int i = 0; i < 2; i++) {
        t.ref[i][0] = r2;
        t.ref[i][1] = r3;
        t.frmidx[i][0] = f2;
        t.frmidx[i][1] = f3;
        for (int lx = 0; lx < 2; lx++) {
            memcpy(l.mov[i][lx], mv_sets[0][lx], 8);
            memcpy(l.mvd[i][lx], mvd_sets[0][lx], 8);
            memcpy(l.mov[2 + i][lx], mv_sets[1][lx], 8);
            memcpy(l.mvd[2 + i][lx], mvd_sets[1][lx], 8);
        }
        l.ref[0][i] = ref_idx[i];
        l.frmidx[0][i] = frame_idx_of(s, ref_idx[i], i);
    }
    l.ref[1][0] = r2;
    l.ref[1][1] = r3;
    l.frmidx[1][0] = f2;
    l.frmidx[1][1] = f3;
    s.curr_type[s.mb_pos] = 1;
    for (int y = 0; y < 2; y++) {
        int refcol;
        const int32_t *mvcol;
        if (pairs[y][0] >= 0) { refcol = pairs[y][0]; mvcol = mv_sets[y][0]; }
        else { refcol = pairs[y][1]; mvcol = mv_sets[y][1]; }
        s.curr_ref[s.mb_pos * 4 + y * 2] = refcol;
        s.curr_ref[s.mb_pos * 4 + y * 2 + 1] = refcol;
        for (int k = 0; k < 8; k++) {
            s.curr_mv[(s.mb_pos * 16 + y * 8 + k) * 2] = mvcol[0];
            s.curr_mv[(s.mb_pos * 16 + y * 8 + k) * 2 + 1] = mvcol[1];
        }
    }
}

static void store_info_inter8x16(Ctx &s, const int32_t mv_sets[2][2][2],
                                 const int32_t mvd_sets[2][2][2],
                                 const int32_t *ref_idx,
                                 const int32_t *left4x4,
                                 const int32_t *top4x4) {
    ProfScope _p(3);
    deb_qp_store(s);
    int32_t pairs[2][2] = {{ref_idx[0], ref_idx[1]},
                           {ref_idx[2], ref_idx[3]}};
    if (s.mb_y != 0) {
        StrRet rr = store_str_inter8xedge(s, top_of(s), mv_sets, pairs,
                                          STRH, top4x4);
        STRH = rr.str;
        if (rr.s4) STR4H = 1;
    }
    if (s.mb_x != 0) {
        StrRet rr = store_str_inter16xedge(s, s.mbleft, mv_sets[0],
                                           ref_idx, STRV, left4x4);
        STRV = rr.str;
        if (rr.s4) STR4V = 1;
    }
    STRV = str_mv_calc16x8_vert(s, STRV, ref_idx, mv_sets);
    for (int k = 0; k < 4; k++) {
        s.left_pred[k] = 2;
        s.top_pred[s.mb_x * 4 + k] = 2;
    }
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    l.direct8x8 = t.direct8x8 = 0;
    int r2 = pairs[1][0], r3 = pairs[1][1];
    int f2 = frame_idx_of(s, r2, 0);
    int f3 = frame_idx_of(s, r3, 1);
    int32_t new_lt_ref[2] = {t.ref[1][0], t.ref[1][1]};
    int32_t new_lt_mv[2][2] = {{t.mov[3][0][0], t.mov[3][0][1]},
                               {t.mov[3][1][0], t.mov[3][1][1]}};
    for (int i = 0; i < 2; i++) {
        s.lefttop_ref[i] = new_lt_ref[i];
        l.ref[i][0] = r2;
        l.ref[i][1] = r3;
        l.frmidx[i][0] = f2;
        l.frmidx[i][1] = f3;
        t.ref[0][i] = ref_idx[i];
        t.frmidx[0][i] = frame_idx_of(s, ref_idx[i], i);
        s.lefttop_mv[i][0] = new_lt_mv[i][0];
        s.lefttop_mv[i][1] = new_lt_mv[i][1];
        for (int lx = 0; lx < 2; lx++) {
            memcpy(t.mov[i][lx], mv_sets[0][lx], 8);
            memcpy(t.mvd[i][lx], mvd_sets[0][lx], 8);
            memcpy(t.mov[i + 2][lx], mv_sets[1][lx], 8);
            memcpy(t.mvd[i + 2][lx], mvd_sets[1][lx], 8);
        }
    }
    t.ref[1][0] = r2;
    t.ref[1][1] = r3;
    t.frmidx[1][0] = f2;
    t.frmidx[1][1] = f3;
    for (int i = 0; i < 4; i++)
        for (int lx = 0; lx < 2; lx++) {
            memcpy(l.mov[i][lx], mv_sets[1][lx], 8);
            memcpy(l.mvd[i][lx], mvd_sets[1][lx], 8);
        }
    s.curr_type[s.mb_pos] = 2;
    for (int x = 0; x < 2; x++) {
        int refcol;
        const int32_t *mvcol;
        if (pairs[x][0] >= 0) { refcol = pairs[x][0]; mvcol = mv_sets[x][0]; }
        else { refcol = pairs[x][1]; mvcol = mv_sets[x][1]; }
        s.curr_ref[s.mb_pos * 4 + x] = refcol;
        s.curr_ref[s.mb_pos * 4 + x + 2] = refcol;
        for (int row = 0; row < 4; row++)
            for (int c = 0; c < 2; c++) {
                int k = row * 4 + x * 2 + c;
                s.curr_mv[(s.mb_pos * 16 + k) * 2] = mvcol[0];
                s.curr_mv[(s.mb_pos * 16 + k) * 2 + 1] = mvcol[1];
            }
    }
}

static void store_info_intermb8x8(Ctx &s, Prev8x8 *pblk,
                                  const int32_t *left4x4,
                                  const int32_t *top4x4) {
    ProfScope _p(3);
    deb_qp_store(s);
    if (s.mb_y != 0) {
        if (top_of(s).type <= MB_IPCM) {
            STR4H = 1;
            STRH |= 0xAA;
        } else {
            STRH = str_mv_calc8x8_edge(
                s, str_previous_coef(STRH, top4x4), pblk, top_of(s), 1);
        }
    }
    STRH = str_mv_calc8x8_inner_blk(s, STRH, pblk, 1);
    if (s.mb_x != 0) {
        if (s.mbleft.type <= MB_IPCM) {
            STR4V = 1;
            STRV |= 0xAA;
        } else {
            STRV = str_mv_calc8x8_edge(
                s, str_previous_coef(STRV, left4x4), pblk, s.mbleft, 2);
        }
    }
    STRV = str_mv_calc8x8_inner_blk(s, STRV, pblk, 2);
    for (int k = 0; k < 4; k++) {
        s.left_pred[k] = 2;
        s.top_pred[s.mb_x * 4 + k] = 2;
    }
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    for (int i = 0; i < 2; i++) {
        s.lefttop_mv[i][0] = t.mov[3][i][0];
        s.lefttop_mv[i][1] = t.mov[3][i][1];
        s.lefttop_ref[i] = t.ref[1][i];
        memcpy(t.mov[0][i], pblk[2].mv[2][i], 8);
        memcpy(t.mov[1][i], pblk[2].mv[3][i], 8);
        memcpy(t.mov[2][i], pblk[3].mv[2][i], 8);
        memcpy(t.mov[3][i], pblk[3].mv[3][i], 8);
        memcpy(t.mvd[0][i], pblk[2].mvd[2][i], 8);
        memcpy(t.mvd[1][i], pblk[2].mvd[3][i], 8);
        memcpy(t.mvd[2][i], pblk[3].mvd[2][i], 8);
        memcpy(t.mvd[3][i], pblk[3].mvd[3][i], 8);
        l.ref[0][i] = pblk[1].ref[i];
        l.frmidx[0][i] = frame_idx_of(s, pblk[1].ref[i], i);
        l.ref[1][i] = pblk[3].ref[i];
        l.frmidx[1][i] = frame_idx_of(s, pblk[3].ref[i], i);
        t.ref[0][i] = pblk[2].ref[i];
        t.frmidx[0][i] = frame_idx_of(s, pblk[2].ref[i], i);
        t.ref[1][i] = pblk[3].ref[i];
        t.frmidx[1][i] = frame_idx_of(s, pblk[3].ref[i], i);
    }
    for (int i = 0; i < 4; i++) {
        Prev8x8 &p = pblk[(i & 2) + 1];
        int idx = (i & 1) * 2 + 1;
        for (int j = 0; j < 2; j++) {
            memcpy(l.mov[i][j], p.mv[idx][j], 8);
            memcpy(l.mvd[i][j], p.mvd[idx][j], 8);
        }
    }
    s.curr_type[s.mb_pos] = 3;
    int base = 0;
    for (int blk = 0; blk < 4; blk++) {
        int refcol = pblk[blk].ref[0];
        int lx = 0;
        if (refcol < 0) {
            lx = 1;
            refcol = pblk[blk].ref[1];
        }
        s.curr_ref[s.mb_pos * 4 + blk] = refcol;
        const int32_t *flat = &pblk[blk].mv[0][0][0];  // [8][2] flattened
        int32_t *mvdst = &s.curr_mv[s.mb_pos * 16 * 2];
        memcpy(mvdst + (base + 0) * 2, flat + (0 + lx) * 2, 8);
        memcpy(mvdst + (base + 1) * 2, flat + (2 + lx) * 2, 8);
        memcpy(mvdst + (base + 4) * 2, flat + (4 + lx) * 2, 8);
        memcpy(mvdst + (base + 5) * 2, flat + (6 + lx) * 2, 8);
        base += (blk & 1) ? 6 : 2;
    }
}

// ---------------------------------------------------------------------
// B-direct / B-skip (bdirect.py)
// ---------------------------------------------------------------------
enum { COL_MB16x16 = 0, COL_MB16x8 = 1, COL_MB8x16 = 2, COL_MB8x8 = 3 };
enum { NOT_IN_USE = 0, SHORT_TERM = 1, LONG_TERM = 2 };

static void b_skip_ref_mv(Ctx &s, int avail, int32_t *ref_out,
                          int32_t mv_out[2][2]) {
    static const int32_t non_ref[4] = {-1, -1, -1, -1};
    static const int32_t zero2[2][2] = {{0, 0}, {0, 0}};
    const int32_t *ref_a, *ref_b, *ref_c;
    const int32_t (*mv_a)[2], (*mv_b)[2], (*mv_c)[2];
    if (avail & 1) { ref_a = s.mbleft.ref[0]; mv_a = s.mbleft.mov[0]; }
    else { ref_a = non_ref; mv_a = zero2; }
    if (avail & 2) { ref_b = top_of(s).ref[0]; mv_b = top_of(s).mov[0]; }
    else { ref_b = non_ref; mv_b = zero2; }
    if (avail & 4) {
        ref_c = topright_of(s).ref[0];
        mv_c = topright_of(s).mov[0];
    } else if (avail & 8) {
        ref_c = s.lefttop_ref;
        mv_c = s.lefttop_mv;
    } else {
        ref_c = non_ref;
        mv_c = zero2;
    }
    for (int lx = 0; lx < 2; lx++) {
        uint32_t ra = (uint32_t)ref_a[lx], rb = (uint32_t)ref_b[lx],
                 rc = (uint32_t)ref_c[lx];
        uint32_t cand = ra < rb ? ra : rb;
        if (rc < cand) cand = rc;
        int32_t ref = (int32_t)cand;
        int32_t ira = ref_a[lx], irb = ref_b[lx], irc = ref_c[lx];
        if (ref < 0) {
            mv_out[lx][0] = mv_out[lx][1] = 0;
        } else if (ira == ref && irb != ref && irc != ref) {
            mv_out[lx][0] = mv_a[lx][0]; mv_out[lx][1] = mv_a[lx][1];
        } else if (ira != ref && irb == ref && irc != ref) {
            mv_out[lx][0] = mv_b[lx][0]; mv_out[lx][1] = mv_b[lx][1];
        } else if (ira != ref && irb != ref && irc == ref) {
            mv_out[lx][0] = mv_c[lx][0]; mv_out[lx][1] = mv_c[lx][1];
        } else {
            mv_out[lx][0] = med3(mv_a[lx][0], mv_b[lx][0], mv_c[lx][0]);
            mv_out[lx][1] = med3(mv_a[lx][1], mv_b[lx][1], mv_c[lx][1]);
        }
        ref_out[lx] = ref;
    }
}

static inline bool mvcol_small(const int32_t *mv) {
    return mv[0] >= -1 && mv[0] <= 1 && mv[1] >= -1 && mv[1] <= 1;
}

static inline bool mv2_any(const int32_t m[2][2]) {
    return m[0][0] || m[0][1] || m[1][0] || m[1][1];
}

typedef int32_t MSet[2][2];

static void col_zero_pred(Ctx &s, int refs_mask, const int32_t *mvcol,
                          MSet *msets, int set_idx, const int32_t *ref_idx,
                          int bw, int bh, int ox, int oy) {
    MSet &cur = msets[set_idx];
    if (refs_mask == 3) {
        if (mv2_any(cur) && mvcol_small(mvcol)) {
            memset(cur, 0, sizeof(MSet));
            static const int32_t both0[2] = {0, 0};
            inter_pred_basic(s, both0, cur, bw, bh, ox, oy);
        } else {
            inter_pred_basic(s, ref_idx, cur, bw, bh, ox, oy);
        }
    } else {
        int lx = (refs_mask == 1) ? 0 : 1;
        if ((cur[lx][0] || cur[lx][1]) && mvcol_small(mvcol)) {
            cur[lx][0] = cur[lx][1] = 0;
        }
        inter_pred_basic(s, ref_idx, cur, bw, bh, ox, oy);
    }
}

static void pred_direct16x16(Ctx &s, int32_t *ref_idx2, MSet *msets) {
    RefInfo &colpic = s.refs[1][0];
    int pos = s.mb_pos;
    if (ref_idx2[0] < 0 && ref_idx2[1] < 0) {
        ref_idx2[0] = 0;
        ref_idx2[1] = 0;
        s.col_type[pos] = COL_MB16x16;
        memset(msets[1], 0, sizeof(MSet));
        inter_pred_basic(s, ref_idx2, msets[0], 16, 16, 0, 0);
        return;
    }
    if (colpic.in_use != SHORT_TERM) {
        s.col_type[pos] = COL_MB16x16;
        memset(msets[1], 0, sizeof(MSet));
        inter_pred_basic(s, ref_idx2, msets[0], 16, 16, 0, 0);
        return;
    }
    int refs_mask = (ref_idx2[0] == 0) + (ref_idx2[1] == 0) * 2;
    int col_type = s.col_type[pos];
    const int32_t *colmv = &s.col_mv[pos * 16 * 2];
    const int32_t *colref = &s.col_ref[pos * 4];
    if (refs_mask == 0) {
        inter_pred_basic(s, ref_idx2, msets[0], 16, 16, 0, 0);
        s.col_type[pos] = COL_MB16x16;
        memset(msets[1], 0, sizeof(MSet));
        return;
    }
    if (col_type == COL_MB16x16) {
        if (colref[0] == 0)
            col_zero_pred(s, refs_mask, colmv, msets, 0, ref_idx2,
                          16, 16, 0, 0);
        else
            inter_pred_basic(s, ref_idx2, msets[0], 16, 16, 0, 0);
        memset(msets[1], 0, sizeof(MSet));
    } else if (col_type == COL_MB16x8) {
        memcpy(msets[1], msets[0], sizeof(MSet));
        for (int y = 0; y < 2; y++) {
            if (colref[y * 2] == 0)
                col_zero_pred(s, refs_mask, colmv + y * 8 * 2, msets, y,
                              ref_idx2, 16, 8, 0, y * 8);
            else
                inter_pred_basic(s, ref_idx2, msets[y], 16, 8, 0, y * 8);
        }
        memset(msets[2], 0, sizeof(MSet));
        memset(msets[3], 0, sizeof(MSet));
    } else if (col_type == COL_MB8x16) {
        memcpy(msets[1], msets[0], sizeof(MSet));
        for (int x = 0; x < 2; x++) {
            if (colref[x] == 0)
                col_zero_pred(s, refs_mask, colmv + x * 2 * 2, msets, x,
                              ref_idx2, 8, 16, x * 8, 0);
            else
                inter_pred_basic(s, ref_idx2, msets[x], 8, 16, x * 8, 0);
        }
        memset(msets[2], 0, sizeof(MSet));
        memset(msets[3], 0, sizeof(MSet));
    } else {
        for (int k = 1; k < 4; k++) memcpy(msets[k], msets[0], sizeof(MSet));
        for (int blk = 0; blk < 4; blk++) {
            int ox = (blk & 1) * 8, oy = (blk & 2) * 4;
            if (colref[blk] == 0) {
                int mvi = (blk & 2) * 6 + (blk & 1) * 3;
                col_zero_pred(s, refs_mask, colmv + mvi * 2, msets, blk,
                              ref_idx2, 8, 8, ox, oy);
            } else {
                inter_pred_basic(s, ref_idx2, msets[blk], 8, 8, ox, oy);
            }
        }
    }
}

static void b_skip_mb_spatial(Ctx &s, int32_t *ref_idx8, MSet *msets) {
    int avail = get_avail(s);
    int32_t ref2[2];
    int32_t mv2[2][2];
    b_skip_ref_mv(s, avail, ref2, mv2);
    memcpy(msets[0], mv2, sizeof(MSet));
    for (int i = 0; i < 4; i++) {
        ref_idx8[i * 2] = ref2[0];
        ref_idx8[i * 2 + 1] = ref2[1];
    }
    pred_direct16x16(s, ref_idx8, msets);  // mutates ref_idx8[0..1]
}

static void pred_direct8x8_spatial(Ctx &s, int blk_idx, Prev8x8 *pblk,
                                   int avail, int32_t *shared_ref,
                                   int32_t shared_mv[2][2], int type0_cnt) {
    if (type0_cnt == 0)
        b_skip_ref_mv(s, avail, shared_ref, shared_mv);
    Prev8x8 &p = pblk[blk_idx];
    p.ref[0] = shared_ref[0];
    p.ref[1] = shared_ref[1];
    for (int k = 0; k < 4; k++) {
        memcpy(p.mv[k][0], shared_mv[0], 8);
        memcpy(p.mv[k][1], shared_mv[1], 8);
    }
    int xoffset = (blk_idx & 1) * 8;
    int yoffset = (blk_idx & 2) * 4;
    if (p.ref[0] >= 0 || p.ref[1] >= 0) {
        RefInfo &colpic = s.refs[1][0];
        int pos = s.mb_pos;
        const int32_t *colref = &s.col_ref[pos * 4];
        if (colpic.in_use == SHORT_TERM && colref[blk_idx] == 0) {
            int refs_mask = (p.ref[0] == 0) + (p.ref[1] == 0) * 2;
            int mvi = (blk_idx & 2) * 6 + (blk_idx & 1) * 3;
            const int32_t *mvcol = &s.col_mv[(pos * 16 + mvi) * 2];
            if (refs_mask == 0) {
                inter_pred_basic(s, p.ref, p.mv[0], 8, 8, xoffset, yoffset);
            } else if (refs_mask == 3) {
                if ((p.mv[0][0][0] || p.mv[0][0][1] || p.mv[0][1][0]
                     || p.mv[0][1][1]) && mvcol_small(mvcol)) {
                    memset(p.mv, 0, sizeof(p.mv));
                    static const int32_t both0[2] = {0, 0};
                    inter_pred_basic(s, both0, p.mv[0], 8, 8, xoffset,
                                     yoffset);
                } else {
                    inter_pred_basic(s, p.ref, p.mv[0], 8, 8, xoffset,
                                     yoffset);
                }
            } else {
                int lx = (refs_mask == 1) ? 0 : 1;
                if ((p.mv[0][lx][0] || p.mv[0][lx][1])
                    && mvcol_small(mvcol)) {
                    for (int k = 0; k < 4; k++)
                        p.mv[k][lx][0] = p.mv[k][lx][1] = 0;
                }
                inter_pred_basic(s, p.ref, p.mv[0], 8, 8, xoffset, yoffset);
            }
        } else {
            inter_pred_basic(s, p.ref, p.mv[0], 8, 8, xoffset, yoffset);
        }
    } else {
        p.ref[0] = 0;
        p.ref[1] = 0;
        memset(p.mv, 0, sizeof(p.mv));
        inter_pred_basic(s, p.ref, p.mv[0], 8, 8, xoffset, yoffset);
    }
}

// temporal direct
static void temporal_vector(int mvcol, int scale, int32_t *t0, int32_t *t1) {
    int t = (mvcol * scale + 128) >> 8;
    *t0 = t;
    *t1 = t - mvcol;
}

static void temporal_block8(Ctx &s, int blk_idx, MSet *msets, int set_idx,
                            int bw, int bh, int ox, int oy, int32_t *rp) {
    int pos = s.mb_pos;
    int colref = s.col_ref[pos * 4 + blk_idx];
    int ref = colref >= 0 ? s.map_col_to_list0[colref] : 0;
    rp[0] = ref;
    rp[1] = 0;
    MSet &mv = msets[set_idx];
    if (colref >= 0 && s.refs[0][ref].in_use != LONG_TERM) {
        int mvi = (blk_idx & 2) * 6 + (blk_idx & 1) * 3;
        const int32_t *mvcol = &s.col_mv[(pos * 16 + mvi) * 2];
        int scale = s.scale_tab[ref];
        temporal_vector(mvcol[0], scale, &mv[0][0], &mv[1][0]);
        temporal_vector(mvcol[1], scale, &mv[0][1], &mv[1][1]);
    } else {
        memset(mv, 0, sizeof(MSet));
    }
    inter_pred_basic(s, rp, mv, bw, bh, ox, oy);
}

static void b_skip_mb_temporal(Ctx &s, int32_t *ref_idx8, MSet *msets) {
    int col_type = s.col_type[s.mb_pos];
    int32_t rp[2];
    if (col_type == COL_MB16x16) {
        temporal_block8(s, 0, msets, 0, 16, 16, 0, 0, rp);
        for (int i = 0; i < 4; i++) {
            ref_idx8[i * 2] = rp[0];
            ref_idx8[i * 2 + 1] = rp[1];
        }
        memset(msets[1], 0, sizeof(MSet));
    } else if (col_type == COL_MB16x8) {
        for (int y = 0; y < 2; y++) {
            temporal_block8(s, y * 2, msets, y, 16, 8, 0, y * 8, rp);
            ref_idx8[y * 2] = rp[0];
            ref_idx8[y * 2 + 1] = rp[1];
        }
        for (int k = 0; k < 4; k++) ref_idx8[4 + k] = ref_idx8[k];
        memset(msets[2], 0, sizeof(MSet));
        memset(msets[3], 0, sizeof(MSet));
    } else if (col_type == COL_MB8x16) {
        for (int x = 0; x < 2; x++) {
            temporal_block8(s, x, msets, x, 8, 16, x * 8, 0, rp);
            ref_idx8[x * 2] = rp[0];
            ref_idx8[x * 2 + 1] = rp[1];
        }
        for (int k = 0; k < 4; k++) ref_idx8[4 + k] = ref_idx8[k];
        memset(msets[2], 0, sizeof(MSet));
        memset(msets[3], 0, sizeof(MSet));
    } else {
        for (int blk = 0; blk < 4; blk++) {
            temporal_block8(s, blk, msets, blk, 8, 8, (blk & 1) * 8,
                            (blk & 2) * 4, rp);
            ref_idx8[blk * 2] = rp[0];
            ref_idx8[blk * 2 + 1] = rp[1];
        }
    }
}

static void pred_direct8x8_temporal(Ctx &s, int blk_idx, Prev8x8 *pblk) {
    Prev8x8 &p = pblk[blk_idx];
    int pos = s.mb_pos;
    int colref = s.col_ref[pos * 4 + blk_idx];
    int ref = colref >= 0 ? s.map_col_to_list0[colref] : 0;
    p.ref[0] = ref;
    p.ref[1] = 0;
    if (colref >= 0 && s.refs[0][ref].in_use != LONG_TERM) {
        int mvi = (blk_idx & 2) * 6 + (blk_idx & 1) * 3;
        const int32_t *mvcol = &s.col_mv[(pos * 16 + mvi) * 2];
        int scale = s.scale_tab[ref];
        int32_t l0x, l1x, l0y, l1y;
        temporal_vector(mvcol[0], scale, &l0x, &l1x);
        temporal_vector(mvcol[1], scale, &l0y, &l1y);
        for (int k = 0; k < 4; k++) {
            p.mv[k][0][0] = l0x; p.mv[k][0][1] = l0y;
            p.mv[k][1][0] = l1x; p.mv[k][1][1] = l1y;
        }
    } else {
        memset(p.mv, 0, sizeof(p.mv));
    }
    inter_pred_basic(s, p.ref, p.mv[0], 8, 8, (blk_idx & 1) * 8,
                     (blk_idx & 2) * 4);
}

// store for skip / direct16x16 (vector-set layout)
static int64_t str8x8_inner_vecset(Ctx &s, int64_t str, const int32_t *ref8,
                                   MSet *msets, int is_horiz) {
    int64_t mask_acc = 0;
    for (int x = 0; x < 2; x++) {
        int shift = x * 4;
        int t0, t1, b0, b1;
        const MSet *mv_top, *mv_bot;
        if (is_horiz) {
            t0 = frame_idx_of(s, ref8[x * 4 + 0], 0);
            t1 = frame_idx_of(s, ref8[x * 4 + 1], 1);
            b0 = frame_idx_of(s, ref8[x * 4 + 2], 0);
            b1 = frame_idx_of(s, ref8[x * 4 + 3], 1);
            mv_top = &msets[x * 2];
            mv_bot = &msets[x * 2 + 1];
        } else {
            t0 = frame_idx_of(s, ref8[x * 2 + 0], 0);
            t1 = frame_idx_of(s, ref8[x * 2 + 1], 1);
            b0 = frame_idx_of(s, ref8[x * 2 + 4], 0);
            b1 = frame_idx_of(s, ref8[x * 2 + 5], 1);
            mv_top = &msets[x];
            mv_bot = &msets[x + 2];
        }
        int64_t center_mask = 0xA0000ll << shift;
        int64_t bits;
        if ((t0 != b0 || t1 != b1) && (t1 != b0 || t0 != b1)) {
            bits = 0x50000ll << shift;
        } else {
            bits = 0;
            if ((str & center_mask) != center_mask) {
                bool d;
                if (t0 >= 0 && t1 >= 0) {
                    int lx = (t0 != b0);
                    d = dif4((*mv_top)[0][0], (*mv_bot)[lx][0])
                        || dif4((*mv_top)[0][1], (*mv_bot)[lx][1])
                        || dif4((*mv_top)[1][0], (*mv_bot)[lx ^ 1][0])
                        || dif4((*mv_top)[1][1], (*mv_bot)[lx ^ 1][1]);
                } else {
                    int tlx = (t0 < 0);
                    int blx = (b0 < 0);
                    d = dif4((*mv_top)[tlx][0], (*mv_bot)[blx][0])
                        || dif4((*mv_top)[tlx][1], (*mv_bot)[blx][1]);
                }
                if (d) bits = center_mask >> 1;
            }
        }
        mask_acc |= bits;
    }
    return str | (((str >> 1) ^ mask_acc) & mask_acc);
}

static void store_info_inter8x8_vecset(Ctx &s, MSet *msets,
                                       const int32_t *ref8,
                                       const int32_t *left4x4,
                                       const int32_t *top4x4) {
    deb_qp_store(s);
    if (s.mb_y != 0) {
        int32_t pairs[2][2] = {{ref8[0], ref8[1]}, {ref8[2], ref8[3]}};
        int32_t mvs2[2][2][2];
        memcpy(mvs2[0], msets[0], sizeof(MSet));
        memcpy(mvs2[1], msets[1], sizeof(MSet));
        StrRet rr = store_str_inter8xedge(s, top_of(s), mvs2, pairs,
                                          STRH, top4x4);
        STRH = rr.str;
        if (rr.s4) STR4H = 1;
    }
    STRH = str8x8_inner_vecset(s, STRH, ref8, msets, 0);
    if (s.mb_x != 0) {
        int32_t pairs[2][2] = {{ref8[0], ref8[1]}, {ref8[4], ref8[5]}};
        int32_t mvs2[2][2][2];
        memcpy(mvs2[0], msets[0], sizeof(MSet));
        memcpy(mvs2[1], msets[2], sizeof(MSet));
        StrRet rr = store_str_inter8xedge(s, s.mbleft, mvs2, pairs,
                                          STRV, left4x4);
        STRV = rr.str;
        if (rr.s4) STR4V = 1;
    }
    STRV = str8x8_inner_vecset(s, STRV, ref8, msets, 1);
    for (int k = 0; k < 4; k++) {
        s.left_pred[k] = 2;
        s.top_pred[s.mb_x * 4 + k] = 2;
    }
    PrevMb &t = top_of(s);
    PrevMb &l = s.mbleft;
    for (int i = 0; i < 2; i++) {
        s.lefttop_ref[i] = t.ref[1][i];
        s.lefttop_mv[i][0] = t.mov[3][i][0];
        s.lefttop_mv[i][1] = t.mov[3][i][1];
        int r = ref8[i * 2 + 4];
        t.ref[i][0] = r;
        t.frmidx[i][0] = frame_idx_of(s, r, 0);
        r = ref8[i * 2 + 5];
        t.ref[i][1] = r;
        t.frmidx[i][1] = frame_idx_of(s, r, 1);
        r = ref8[i * 4 + 2];
        l.ref[i][0] = r;
        l.frmidx[i][0] = frame_idx_of(s, r, 0);
        r = ref8[i * 4 + 3];
        l.ref[i][1] = r;
        l.frmidx[i][1] = frame_idx_of(s, r, 1);
    }
    for (int i = 0; i < 4; i++) {
        memcpy(t.mov[i], msets[(i >> 1) + 2], sizeof(MSet));
        memcpy(l.mov[i], msets[(i >> 1) * 2 + 1], sizeof(MSet));
    }
    memset(t.mvd, 0, sizeof(t.mvd));
    memset(l.mvd, 0, sizeof(l.mvd));
    s.curr_type[s.mb_pos] = 3;
    int base = 0;
    for (int blk = 0; blk < 4; blk++) {
        int refcol = ref8[blk * 2];
        int lx = 0;
        if (refcol < 0) {
            lx = 1;
            refcol = ref8[blk * 2 + 1];
        }
        s.curr_ref[s.mb_pos * 4 + blk] = refcol;
        const int32_t *src = msets[blk][lx];
        int32_t *mvdst = &s.curr_mv[s.mb_pos * 16 * 2];
        memcpy(mvdst + (base + 0) * 2, src, 8);
        memcpy(mvdst + (base + 1) * 2, src, 8);
        memcpy(mvdst + (base + 4) * 2, src, 8);
        memcpy(mvdst + (base + 5) * 2, src, 8);
        base += (blk & 1) ? 6 : 2;
    }
}

static void store_info_direct(Ctx &s, MSet *msets, const int32_t *ref8,
                              const int32_t *left4x4, const int32_t *top4x4,
                              int col_type) {
    if (col_type == COL_MB16x16) {
        store_info_inter16x16(s, msets[0], msets[1], ref8, left4x4, top4x4);
    } else if (col_type == COL_MB16x8) {
        store_info_inter16x8(s, &msets[0], &msets[2], ref8, left4x4,
                             top4x4);
    } else if (col_type == COL_MB8x16) {
        store_info_inter8x16(s, &msets[0], &msets[2], ref8, left4x4,
                             top4x4);
    } else {
        store_info_inter8x8_vecset(s, msets, ref8, left4x4, top4x4);
    }
}

// ---------------------------------------------------------------------
// inter MB layer (decoder.py _PSliceMixin + B extensions)
// ---------------------------------------------------------------------
static int cabac_ref_idx_sub(Ctx &s, BitReader &r, int inc);
static int cabac_mvd_xy(Ctx &s, BitReader &r, const int32_t *mvd_a,
                        const int32_t *mvd_b, int32_t *out);
static int cabac_sub_mb_type_p(Ctx &s, BitReader &r);
static int cabac_sub_mb_type_b_one(Ctx &s, BitReader &r);

static int read_mvd_xy(Ctx &s, BitReader &r, const int32_t *mvd_a,
                       const int32_t *mvd_b, int32_t *out) {
    if (s.sp.is_cabac) return cabac_mvd_xy(s, r, mvd_a, mvd_b, out);
    out[0] = r.se();
    out[1] = r.se();
    return 0;
}

// CABAC ref_idx context increments (decoder.py _ref_inc*)
static int ref_inc16x16(Ctx &s, int lx, int avail) {
    PrevMb &l = s.mbleft;
    PrevMb &tp = top_of(s);
    return ((avail & 1) && !(l.direct8x8 & 1) && l.ref[0][lx] > 0)
         + ((avail & 2) && !(tp.direct8x8 & 1) && tp.ref[0][lx] > 0) * 2;
}

static int read_ref16x16(Ctx &s, BitReader &r, int lx, int avail) {
    int t = s.sp.num_ref_idx[lx];
    if (!t) return 0;
    if (!s.sp.is_cabac) return read_te(r, t);
    return cabac_ref_idx_sub(s, r, ref_inc16x16(s, lx, avail));
}

static int ref_inc16x8_p1(Ctx &s, int lx, int avail, const int32_t *ref_idx,
                          int vertical) {
    PrevMb &l = s.mbleft;
    PrevMb &tp = top_of(s);
    if (vertical)
        return (ref_idx[lx] > 0)
             + ((avail & 2) && !(tp.direct8x8 & 2) && tp.ref[1][lx] > 0) * 2;
    return ((avail & 1) && !(l.direct8x8 & 2) && l.ref[1][lx] > 0)
         + (ref_idx[lx] > 0) * 2;
}

static int read_ref16x8_p1(Ctx &s, BitReader &r, int lx, int avail,
                           const int32_t *ref_idx, int vertical) {
    int t = s.sp.num_ref_idx[lx];
    if (!t) return 0;
    if (!s.sp.is_cabac) return read_te(r, t);
    return cabac_ref_idx_sub(s, r,
                             ref_inc16x8_p1(s, lx, avail, ref_idx, vertical));
}

static int ref_inc8x8(Ctx &s, int lx, int avail, int i, Prev8x8 *pblk,
                      const int *sub_dirs) {
    PrevMb &l = s.mbleft;
    PrevMb &tp = top_of(s);
    auto vb = [&](int b) {
        return (int)(sub_dirs[b] >= 0 && pblk[b].ref[lx] > 0);
    };
    if (i == 0)
        return ((avail & 1) && !(l.direct8x8 & 1) && l.ref[0][lx] > 0)
             + ((avail & 2) && !(tp.direct8x8 & 1) && tp.ref[0][lx] > 0) * 2;
    if (i == 1)
        return vb(0)
             + ((avail & 2) && !(tp.direct8x8 & 2) && tp.ref[1][lx] > 0) * 2;
    if (i == 2)
        return ((avail & 1) && !(l.direct8x8 & 2) && l.ref[1][lx] > 0)
             + vb(0) * 2;
    return vb(2) + vb(1) * 2;
}

static int read_ref8x8(Ctx &s, BitReader &r, int lx, int avail, int i,
                       Prev8x8 *pblk, const int *sub_dirs, int t) {
    if (!t) return 0;
    if (!s.sp.is_cabac) return read_te(r, t);
    return cabac_ref_idx_sub(s, r, ref_inc8x8(s, lx, avail, i, pblk,
                                              sub_dirs));
}

static int mb_inter16x16(Ctx &s, BitReader &r, int avail, int refmap) {
    s.avail_saved = avail;
    int32_t ref_idx[2] = {-1, -1};
    for (int lx = 0; lx < 2; lx++)
        if (refmap & (1 << lx)) {
            ref_idx[lx] = read_ref16x16(s, r, lx, avail);
            if (ref_idx[lx] < 0) return -2;
        }
    int32_t mvs[2][2] = {{0, 0}, {0, 0}};
    int32_t mvds[2][2] = {{0, 0}, {0, 0}};
    for (int lx = 0; lx < 2; lx++)
        if (refmap & (1 << lx)) {
            PMV p = calc_mv16x16(s, lx, ref_idx[lx], avail);
            int32_t d[2];
            if (read_mvd_xy(s, r, p.mvd_a, p.mvd_b, d) < 0) return -2;
            mvds[lx][0] = d[0];
            mvds[lx][1] = d[1];
            mvs[lx][0] = p.pmx + d[0];
            mvs[lx][1] = p.pmy + d[1];
        }
    inter_pred_basic(s, ref_idx, mvs, 16, 16, 0, 0);
    int32_t left4x4[4], top4x4[4];
    memcpy(left4x4, s.left_coef, 16);
    memcpy(top4x4, &s.top_coef[s.mb_x * 8], 16);
    int cbp = read_cbp_any(s, r, avail, 1);
    if (cbp < 0) return -2;
    s.cbp = cbp;
    if (cbp) {
        if (residual_luma_inter(s, r, 0x80 | cbp) < 0) return -2;
    } else {
        no_residual_inter(s);
    }
    store_info_inter16x16(s, mvs, mvds, ref_idx, left4x4, top4x4);
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static int mb_inter16x8(Ctx &s, BitReader &r, int avail, int refmap,
                        int vertical) {
    s.avail_saved = avail;
    int32_t ref_idx[4] = {-1, -1, -1, -1};
    for (int lx = 0; lx < 2; lx++) {
        int m = refmap >> (lx * 2);
        if (m & 1) {
            ref_idx[lx] = read_ref16x16(s, r, lx, avail);
            if (ref_idx[lx] < 0) return -2;
        }
        if (m & 2) {
            ref_idx[lx + 2] = read_ref16x8_p1(s, r, lx, avail, ref_idx,
                                              vertical);
            if (ref_idx[lx + 2] < 0) return -2;
        }
    }
    int32_t mv_sets[2][2][2] = {};
    int32_t mvd_sets[2][2][2] = {};
    for (int lx = 0; lx < 2; lx++) {
        int m = refmap >> (lx * 2);
        if (m & 1) {
            PMV p = vertical ? calc_mv8x16left(s, lx, ref_idx[lx], avail)
                             : calc_mv16x8top(s, lx, ref_idx[lx], avail);
            int32_t d[2];
            if (read_mvd_xy(s, r, p.mvd_a, p.mvd_b, d) < 0) return -2;
            mvd_sets[0][lx][0] = d[0];
            mvd_sets[0][lx][1] = d[1];
            mv_sets[0][lx][0] = p.pmx + d[0];
            mv_sets[0][lx][1] = p.pmy + d[1];
        }
        if (m & 2) {
            PMV p = vertical
                ? calc_mv8x16right(s, lx, ref_idx[lx + 2], avail,
                                   ref_idx[lx], mv_sets[0], mvd_sets[0])
                : calc_mv16x8bottom(s, lx, ref_idx[lx + 2], avail,
                                    ref_idx[lx], mv_sets[0], mvd_sets[0]);
            int32_t d[2];
            if (read_mvd_xy(s, r, p.mvd_a, p.mvd_b, d) < 0) return -2;
            mvd_sets[1][lx][0] = d[0];
            mvd_sets[1][lx][1] = d[1];
            mv_sets[1][lx][0] = p.pmx + d[0];
            mv_sets[1][lx][1] = p.pmy + d[1];
        }
    }
    if (vertical) {
        inter_pred_basic(s, ref_idx, mv_sets[0], 8, 16, 0, 0);
        inter_pred_basic(s, ref_idx + 2, mv_sets[1], 8, 16, 8, 0);
    } else {
        inter_pred_basic(s, ref_idx, mv_sets[0], 16, 8, 0, 0);
        inter_pred_basic(s, ref_idx + 2, mv_sets[1], 16, 8, 0, 8);
    }
    int32_t left4x4[4], top4x4[4];
    memcpy(left4x4, s.left_coef, 16);
    memcpy(top4x4, &s.top_coef[s.mb_x * 8], 16);
    int cbp = read_cbp_any(s, r, avail, 1);
    if (cbp < 0) return -2;
    s.cbp = cbp;
    if (cbp) {
        if (residual_luma_inter(s, r, 0x80 | cbp) < 0) return -2;
    } else {
        no_residual_inter(s);
    }
    if (vertical)
        store_info_inter8x16(s, mv_sets, mvd_sets, ref_idx, left4x4,
                             top4x4);
    else
        store_info_inter16x8(s, mv_sets, mvd_sets, ref_idx, left4x4,
                             top4x4);
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static void sub_mb_mv(Ctx &s, BitReader &r, int avail, int blk_idx,
                      Prev8x8 *pblk, int lx, int sub_type, int *err) {
    Prev8x8 &p = pblk[blk_idx];
    if (p.ref[lx] < 0) return;
    int idx = p.ref[lx];
    int32_t d[2];
    if (sub_type == 0) {
        PMV pm = calc_mv8x8(s, 0, lx, idx, avail, blk_idx, pblk, 0);
        if (read_mvd_xy(s, r, pm.mvd_a, pm.mvd_b, d) < 0) { *err = -2; return; }
        for (int k = 0; k < 4; k++) {
            p.mv[k][lx][0] = pm.pmx + d[0];
            p.mv[k][lx][1] = pm.pmy + d[1];
            p.mvd[k][lx][0] = d[0];
            p.mvd[k][lx][1] = d[1];
        }
    } else if (sub_type == 1) {
        for (int y = 0; y < 2; y++) {
            PMV pm = calc_mv8x8(s, 1, lx, idx, avail, blk_idx, pblk, y);
            if (read_mvd_xy(s, r, pm.mvd_a, pm.mvd_b, d) < 0) { *err = -2; return; }
            for (int c = 0; c < 2; c++) {
                p.mv[y * 2 + c][lx][0] = pm.pmx + d[0];
                p.mv[y * 2 + c][lx][1] = pm.pmy + d[1];
                p.mvd[y * 2 + c][lx][0] = d[0];
                p.mvd[y * 2 + c][lx][1] = d[1];
            }
        }
    } else if (sub_type == 2) {
        for (int x = 0; x < 2; x++) {
            PMV pm = calc_mv8x8(s, 2, lx, idx, avail, blk_idx, pblk, x);
            if (read_mvd_xy(s, r, pm.mvd_a, pm.mvd_b, d) < 0) { *err = -2; return; }
            for (int c = 0; c < 2; c++) {
                p.mv[x + c * 2][lx][0] = pm.pmx + d[0];
                p.mv[x + c * 2][lx][1] = pm.pmy + d[1];
                p.mvd[x + c * 2][lx][0] = d[0];
                p.mvd[x + c * 2][lx][1] = d[1];
            }
        }
    } else {
        for (int xy = 0; xy < 4; xy++) {
            PMV pm = calc_mv8x8(s, 3, lx, idx, avail, blk_idx, pblk, xy);
            if (read_mvd_xy(s, r, pm.mvd_a, pm.mvd_b, d) < 0) { *err = -2; return; }
            p.mv[xy][lx][0] = pm.pmx + d[0];
            p.mv[xy][lx][1] = pm.pmy + d[1];
            p.mvd[xy][lx][0] = d[0];
            p.mvd[xy][lx][1] = d[1];
        }
    }
}

static void sub_mb_dec(Ctx &s, int blk_idx, Prev8x8 *pblk, int sub_type) {
    Prev8x8 &p = pblk[blk_idx];
    int ox = (blk_idx & 1) * 8;
    int oy = (blk_idx & 2) * 4;
    if (sub_type == 0) {
        inter_pred_basic(s, p.ref, p.mv[0], 8, 8, ox, oy);
    } else if (sub_type == 1) {
        for (int y = 0; y < 2; y++)
            inter_pred_basic(s, p.ref, p.mv[y * 2], 8, 4, ox, oy + y * 4);
    } else if (sub_type == 2) {
        for (int x = 0; x < 2; x++)
            inter_pred_basic(s, p.ref, p.mv[x], 4, 8, ox + x * 4, oy);
    } else {
        for (int xy = 0; xy < 4; xy++)
            inter_pred_basic(s, p.ref, p.mv[xy], 4, 4, ox + (xy & 1) * 4,
                             oy + (xy & 2) * 2);
    }
}

static int mb_inter8x8p(Ctx &s, BitReader &r, int avail, int ref0) {
    ProfScope _px7(7);
    s.avail_saved = avail;
    Prev8x8 pblk[4];
    for (int i = 0; i < 4; i++) pblk[i].init();
    int sub_mb_type[4];
    if (s.sp.is_cabac) {
        for (int i = 0; i < 4; i++) {
            sub_mb_type[i] = cabac_sub_mb_type_p(s, r);
            if (sub_mb_type[i] < 0) return -2;
        }
    } else {
        for (int i = 0; i < 4; i++) {
            sub_mb_type[i] = r.ue();
            if (sub_mb_type[i] < 0 || sub_mb_type[i] > 3) return -2;
        }
    }
    static const int subdirs1[4] = {1, 1, 1, 1};
    int t = ref0 ? 0 : s.sp.num_ref_idx[0];
    for (int i = 0; i < 4; i++) {
        pblk[i].ref[0] = read_ref8x8(s, r, 0, avail, i, pblk, subdirs1, t);
        if (pblk[i].ref[0] < 0) return -2;
    }
    int err = 0;
    for (int i = 0; i < 4; i++) {
        sub_mb_mv(s, r, avail, i, pblk, 0, sub_mb_type[i], &err);
        if (err) return err;
    }
    for (int i = 0; i < 4; i++) sub_mb_dec(s, i, pblk, sub_mb_type[i]);
    int32_t left4x4[4], top4x4[4];
    memcpy(left4x4, s.left_coef, 16);
    memcpy(top4x4, &s.top_coef[s.mb_x * 8], 16);
    int cbp = read_cbp_any(s, r, avail, 1);
    if (cbp < 0) return -2;
    s.cbp = cbp;
    bool need8 = sub_mb_type[0] == 0 && sub_mb_type[1] == 0
              && sub_mb_type[2] == 0 && sub_mb_type[3] == 0;
    if (cbp) {
        if (residual_luma_inter(s, r, (need8 ? 0x80 : 0) | cbp) < 0)
            return -2;
    } else {
        no_residual_inter(s);
    }
    store_info_intermb8x8(s, pblk, left4x4, top4x4);
    s.mbleft.direct8x8 = 0;
    top_of(s).direct8x8 = 0;
    residual_chroma(s, r, cbp, avail);
    return 0;
}

// -- P skip -------------------------------------------------------------
static void p_skip_mb(Ctx &s, int32_t mvs[2][2], int32_t *ref_idx) {
    int avail = get_avail(s);
    mvs[0][0] = mvs[0][1] = mvs[1][0] = mvs[1][1] = 0;
    if ((avail & 3) == 3) {
        PrevMb &left = s.mbleft;
        PrevMb &top = top_of(s);
        bool l_zero = left.ref[0][0] == 0 && !left.mov[0][0][0]
                   && !left.mov[0][0][1];
        bool t_zero = top.ref[0][0] == 0 && !top.mov[0][0][0]
                   && !top.mov[0][0][1];
        if (!l_zero && !t_zero) {
            PMV p = calc_mv16x16(s, 0, 0, avail);
            mvs[0][0] = p.pmx;
            mvs[0][1] = p.pmy;
        }
    }
    ref_idx[0] = 0;
    ref_idx[1] = -1;
    inter_pred_basic(s, ref_idx, mvs, 16, 16, 0, 0);
}

// -- B-direct 16x16 / skip run -------------------------------------------
static int mb_bdirect16x16(Ctx &s, BitReader &r, int avail) {
    s.avail_saved = avail;
    MSet msets[16];
    memset(msets, 0, sizeof(msets));
    int32_t ref8[8];
    for (int k = 0; k < 8; k++) ref8[k] = -1;
    if (s.sp.direct_spatial)
        b_skip_mb_spatial(s, ref8, msets);
    else
        b_skip_mb_temporal(s, ref8, msets);
    int32_t left4x4[4], top4x4[4];
    memcpy(left4x4, s.left_coef, 16);
    memcpy(top4x4, &s.top_coef[s.mb_x * 8], 16);
    int cbp = read_cbp_any(s, r, avail, 1);
    if (cbp < 0) return -2;
    s.cbp = cbp;
    if (cbp) {
        if (residual_luma_inter(s, r, 0x80 | cbp) < 0) return -2;
    } else {
        no_residual_inter(s);
    }
    int col_type = s.col_type[s.mb_pos];
    store_info_direct(s, msets, ref8, left4x4, top4x4, col_type);
    s.mbleft.direct8x8 = 3;
    top_of(s).direct8x8 = 3;
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static int skip_mbs(Ctx &s, int skip_num) {
    ProfScope _p(4);
    int slice_type = s.sp.slice_type;
    int max_run = s.nmb - s.mb_pos;
    if (skip_num > max_run) skip_num = max_run;
    for (int k = 0; k < 4; k++) s.left_pred[k] = 2;
    int32_t left4x4[4], top4x4[4];
    memcpy(left4x4, s.left_coef, 16);
    for (int k = 0; k < 4; k++) s.left_coef[k] = 0;
    s.cbp = 0;
    s.cbf = 0;
    int32_t mvds[2][2] = {};
    while (skip_num) {
        deb_idc_entry_clear(s);
        int32_t mvs[2][2];
        int32_t ref_idx[2];
        MSet msets[16];
        int32_t ref8[8];
        int col_type = 0;
        if (slice_type == P_SLICE) {
            p_skip_mb(s, mvs, ref_idx);
        } else {
            memset(msets, 0, sizeof(msets));
            for (int k = 0; k < 8; k++) ref8[k] = -1;
            if (s.sp.direct_spatial)
                b_skip_mb_spatial(s, ref8, msets);
            else
                b_skip_mb_temporal(s, ref8, msets);
        }
        for (int k = 0; k < 4; k++) s.top_pred[s.mb_x * 4 + k] = 2;
        memcpy(top4x4, &s.top_coef[s.mb_x * 8], 16);
        for (int k = 0; k < 4; k++) s.top_coef[s.mb_x * 8 + k] = 0;
        if (slice_type == B_SLICE) col_type = s.col_type[s.mb_pos];
        no_residual_inter(s);
        if (slice_type == P_SLICE)
            store_info_inter16x16(s, mvs, mvds, ref_idx, left4x4, top4x4);
        else
            store_info_direct(s, msets, ref8, left4x4, top4x4, col_type);
        for (int k = 0; k < 4; k++) left4x4[k] = 0;
        s.prev_qp_delta = 0;
        s.mb_type = MB_PSKIP;
        for (PrevMb *n : {&s.mbleft, &top_of(s)}) {
            n->type = MB_PSKIP;
            n->mb_skip = 1;
            n->direct8x8 = 3;
        }
        if (increment_mb_pos(s) < 0) return -1;
        skip_num -= 1;
    }
    return 0;
}

// -- B partitions ----------------------------------------------------------
// adjusted B mb_type -> (kind, refmap); kind 0 direct, 1 16x16, 2 16x8,
// 3 8x16, 4 8x8 (decoder.py _B_MB_TABLE)
static void b_mb_table(int mbtype, int *kind, int *refmap) {
    static const int cbps[9] = {0x3, 0xC, 0x9, 0x6, 0xB, 0xE, 0x7, 0xD,
                                0xF};
    if (mbtype == 31) { *kind = 0; *refmap = 0; return; }
    if (mbtype <= 34) { *kind = 1; *refmap = mbtype - 31; return; }
    if (mbtype == 53) { *kind = 4; *refmap = 0; return; }
    int i = (mbtype - 35) >> 1;
    *kind = (mbtype - 35) & 1 ? 3 : 2;
    *refmap = cbps[i];
}

// sub_mb_type -> (shape, dir); shape 0=8x8,1=8x4,2=4x8,3=4x4; dir -1 direct
static const int B_SUB_SHAPE[13] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 3, 3};
static const int B_SUB_DIR[13] = {-1, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};

static int mb_inter8x8b(Ctx &s, BitReader &r, int avail) {
    ProfScope _px7(7);
    s.avail_saved = avail;
    Prev8x8 pblk[4];
    for (int i = 0; i < 4; i++) pblk[i].init();
    int sub_mb_type[4];
    int type0_cnt = 0;
    int32_t shared_ref[2] = {0, 0};
    int32_t shared_mv[2][2] = {};
    for (int i = 0; i < 4; i++) {
        int t;
        if (s.sp.is_cabac) {
            t = cabac_sub_mb_type_b_one(s, r);
        } else {
            t = r.ue();
        }
        if (t < 0 || t > 12) return -2;
        sub_mb_type[i] = t;
        if (t == 0) {
            if (s.sp.direct_spatial)
                pred_direct8x8_spatial(s, i, pblk, avail, shared_ref,
                                       shared_mv, type0_cnt);
            else
                pred_direct8x8_temporal(s, i, pblk);
            type0_cnt++;
        }
    }
    int sub_dirs[4];
    for (int i = 0; i < 4; i++) sub_dirs[i] = B_SUB_DIR[sub_mb_type[i]];
    for (int lx = 0; lx < 2; lx++) {
        int t = s.sp.num_ref_idx[lx];
        int dirbit = 1 << lx;
        for (int i = 0; i < 4; i++) {
            int dmask = sub_dirs[i];
            if (dmask >= 0) {
                if (dirbit & dmask) {
                    pblk[i].ref[lx] = read_ref8x8(s, r, lx, avail, i, pblk,
                                                  sub_dirs, t);
                    if (pblk[i].ref[lx] < 0) return -2;
                } else {
                    pblk[i].ref[lx] = -1;
                }
            }
        }
    }
    int err = 0;
    for (int lx = 0; lx < 2; lx++)
        for (int i = 0; i < 4; i++)
            if (sub_mb_type[i] != 0) {
                sub_mb_mv(s, r, avail, i, pblk, lx,
                          B_SUB_SHAPE[sub_mb_type[i]], &err);
                if (err) return err;
            }
    for (int i = 0; i < 4; i++)
        if (sub_mb_type[i] != 0)
            sub_mb_dec(s, i, pblk, B_SUB_SHAPE[sub_mb_type[i]]);
    int32_t left4x4[4], top4x4[4];
    memcpy(left4x4, s.left_coef, 16);
    memcpy(top4x4, &s.top_coef[s.mb_x * 8], 16);
    int cbp = read_cbp_any(s, r, avail, 1);
    if (cbp < 0) return -2;
    s.cbp = cbp;
    if (cbp) {
        if (residual_luma_inter(s, r, 0x80 | cbp) < 0) return -2;
    } else {
        no_residual_inter(s);
    }
    store_info_intermb8x8(s, pblk, left4x4, top4x4);
    s.mbleft.direct8x8 = ((sub_mb_type[3] == 0) * 2) | (sub_mb_type[1] == 0);
    top_of(s).direct8x8 = ((sub_mb_type[3] == 0) * 2) | (sub_mb_type[2] == 0);
    residual_chroma(s, r, cbp, avail);
    return 0;
}

static int mb_inter_dispatch(Ctx &s, BitReader &r, int mbtype,
                                  int avail) {
    if (s.sp.slice_type == B_SLICE && mbtype > MB_IPCM) {
        int kind, refmap;
        b_mb_table(mbtype, &kind, &refmap);
        switch (kind) {
        case 0: return mb_bdirect16x16(s, r, avail);
        case 1: return mb_inter16x16(s, r, avail, refmap);
        case 2: return mb_inter16x8(s, r, avail, refmap, 0);
        case 3: return mb_inter16x8(s, r, avail, refmap, 1);
        default: return mb_inter8x8b(s, r, avail);
        }
    }
    switch (mbtype) {
    case MB_P16x16: return mb_inter16x16(s, r, avail, 1);
    case MB_P16x8: return mb_inter16x8(s, r, avail, 3, 0);
    case MB_P8x16: return mb_inter16x8(s, r, avail, 3, 1);
    case MB_P8x8: return mb_inter8x8p(s, r, avail, 0);
    case MB_P8x8REF0: return mb_inter8x8p(s, r, avail, 1);
    default: return -9;
    }
}


// =====================================================================
// CABAC stage (mirrors m2dec_tpu/codecs/h264/cabac.py; engine semantics
// from the reference's shared core, m2d.h:130-279)
// =====================================================================

static void cabac_init_context(Ctx &s, int slice_qp, int idc) {
    for (int i = 0; i < 460; i++) {
        int m = CTX_MN[idc][i][0], n = CTX_MN[idc][i][1];
        int pre = ((m * slice_qp) >> 4) + n;
        if (pre < 64) {
            pre = pre <= 0 ? 1 : pre;
            s.cab_ctx[i] = (63 - pre) * 2;
        } else {
            pre = pre > 126 ? 126 : pre;
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
    uint32_t lps = RANGE_TAB_LPS[st][(s.cab_range >> 6) & 3];
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

// -- syntax elements -------------------------------------------------
static int cabac_mb_type_I(Ctx &s, BitReader &r, int avail, int ctx_idx,
                           int slice_type) {
    int is_i = slice_type == I_SLICE;
    if (is_i) {
        int add = (((avail & 2) && top_of(s).type != MB_INxN) ? 1 : 0)
                + (((avail & 1) && s.mbleft.type != MB_INxN) ? 1 : 0);
        if (!cabac_decision(s, r, ctx_idx + add)) return MB_INxN;
        ctx_idx = 5;
    } else if (!cabac_decision(s, r, ctx_idx)) {
        return MB_INxN;
    }
    if (cabac_terminate(s, r)) return MB_IPCM;
    int mb_type = cabac_decision(s, r, ctx_idx + 1) * 12 + 1;
    if (cabac_decision(s, r, ctx_idx + 2))
        mb_type += cabac_decision(s, r, ctx_idx + 2 + is_i) * 4 + 4;
    mb_type += cabac_decision(s, r, ctx_idx + 3 + is_i) * 2;
    mb_type += cabac_decision(s, r, ctx_idx + 3 + is_i * 2);
    return mb_type;
}

static int cabac_mb_type_P(Ctx &s, BitReader &r, int avail) {
    if (cabac_decision(s, r, 14))
        return 5 + cabac_mb_type_I(s, r, avail, 17, P_SLICE);
    if (cabac_decision(s, r, 15))
        return cabac_decision(s, r, 17) ? 1 : 2;
    return cabac_decision(s, r, 16) ? 3 : 0;
}

static int cabac_mb_type_B(Ctx &s, BitReader &r, int avail) {
    int idx = 27 + (((avail & 1) && s.mbleft.type != MB_PSKIP) ? 1 : 0)
            + (((avail & 2) && top_of(s).type != MB_PSKIP) ? 1 : 0);
    if (!cabac_decision(s, r, idx)) return 0;
    if (!cabac_decision(s, r, 27 + 3))
        return 1 + cabac_decision(s, r, 27 + 5);
    idx = 27 + 4;
    int mode = cabac_decision(s, r, idx) * 8;
    idx += 1;
    mode += cabac_decision(s, r, idx) * 4;
    mode += cabac_decision(s, r, idx) * 2;
    mode += cabac_decision(s, r, idx);
    if (mode < 8) return mode + 3;
    if (mode < 13) return mode * 2 + cabac_decision(s, r, idx) - 4;
    if (mode == 13) return 23 + cabac_mb_type_I(s, r, avail, 32, P_SLICE);
    if (mode == 14) return 11;
    return 22;
}

static int cabac_mb_skip(Ctx &s, BitReader &r, int slice_type) {
    int avail = get_avail(s);
    int ofs = slice_type == P_SLICE ? 11 : 24;
    if ((avail & 1) && s.mbleft.mb_skip == 0) ofs += 1;
    if ((avail & 2) && top_of(s).mb_skip == 0) ofs += 1;
    return cabac_decision(s, r, ofs);
}

static int cabac_intra4x4_pred_mode(Ctx &s, BitReader &r, int pa, int pb) {
    int pred = pa < pb ? pa : pb;
    if (!cabac_decision(s, r, 68)) {
        int rem = cabac_decision(s, r, 69);
        rem += cabac_decision(s, r, 69) * 2;
        rem += cabac_decision(s, r, 69) * 4;
        pred = rem < pred ? rem : rem + 1;
    }
    return pred;
}

static int cabac_intra_chroma_pred_mode(Ctx &s, BitReader &r, int avail) {
    int idx = 64
        + (((avail & 2) && top_of(s).type < MB_IPCM
            && top_of(s).chroma_pred_mode != 0) ? 1 : 0)
        + (((avail & 1) && s.mbleft.type < MB_IPCM
            && s.mbleft.chroma_pred_mode != 0) ? 1 : 0);
    int mode = cabac_decision(s, r, idx);
    if (mode) {
        while (mode < 3 && cabac_decision(s, r, 64 + 3)) mode += 1;
    }
    s.chroma_pred_mode = mode;
    return mode;
}

static int cabac_cbp(Ctx &s, BitReader &r, int avail) {
    int cbp_a = (avail & 1) ? s.mbleft.cbp : 0x0F;
    int cbp_b = (avail & 2) ? top_of(s).cbp : 0x0F;
    int inc = (!(cbp_a & 2)) + (!(cbp_b & 4)) * 2;
    int v = cabac_decision(s, r, 73 + inc);
    inc = (!(v & 1)) + (!(cbp_b & 8)) * 2;
    v += cabac_decision(s, r, 73 + inc) * 2;
    inc = (!(cbp_a & 8)) + (!(v & 1)) * 2;
    v += cabac_decision(s, r, 73 + inc) * 4;
    inc = (!(v & 4)) + (!(v & 2)) * 2;
    v += cabac_decision(s, r, 73 + inc) * 8;
    cbp_a >>= 4;
    cbp_b >>= 4;
    inc = (cbp_a != 0) + (cbp_b != 0) * 2;
    if (cabac_decision(s, r, 77 + inc)) {
        inc = (cbp_a >> 1) + (cbp_b & 2);
        v = v + cabac_decision(s, r, 77 + 4 + inc) * 16 + 16;
    }
    return v;
}

static int cabac_qp_delta(Ctx &s, BitReader &r) {
    int idx = 60 + (s.prev_qp_delta != 0);
    int v = cabac_decision(s, r, idx);
    if (v) {
        int x = 0;
        int uidx = 62;
        int limit = 52;
        while (limit) {
            if (cabac_decision(s, r, uidx)) {
                x += 1;
                uidx = 63;
            } else {
                break;
            }
            limit -= 1;
        }
        v = x + 1;
        v = (((v & 1) ? v : -v) + 1) >> 1;
    }
    s.prev_qp_delta = v;
    return v;
}

static int cabac_mvd_one(Ctx &s, BitReader &r, int ctx_base, int mva,
                         int mvb) {
    int sum = (mva < 0 ? -mva : mva) + (mvb < 0 ? -mvb : mvb);
    int inc = sum < 3 ? 0 : (sum <= 32 ? 1 : 2);
    if (!cabac_decision(s, r, ctx_base + inc)) return 0;
    int v = 1;
    int idx = ctx_base + 3;
    while (cabac_decision(s, r, idx)) {
        idx += v < 4 ? 1 : 0;
        v += 1;
        if (v >= 9) {
            int exp = 3;
            while (cabac_bypass(s, r) && exp < 16) {
                v += 1 << exp;
                exp += 1;
            }
            while (exp) {
                exp -= 1;
                v += cabac_bypass(s, r) << exp;
            }
            break;
        }
    }
    return cabac_bypass(s, r) ? -v : v;
}

static int cabac_mvd_xy(Ctx &s, BitReader &r, const int32_t *mvd_a,
                        const int32_t *mvd_b, int32_t *out) {
    out[0] = cabac_mvd_one(s, r, 40, mvd_a[0], mvd_b[0]);
    out[1] = cabac_mvd_one(s, r, 47, mvd_a[1], mvd_b[1]);
    return 0;
}

static int cabac_ref_idx_sub(Ctx &s, BitReader &r, int inc) {
    int idx = 0;
    while (cabac_decision(s, r, 54 + inc)) {
        inc = (inc >> 2) + 4;
        idx += 1;
        if (idx > 32) return -2;
    }
    return idx;
}

static int cabac_sub_mb_type_p(Ctx &s, BitReader &r) {
    if (cabac_decision(s, r, 21)) return 0;
    if (!cabac_decision(s, r, 22)) return 1;
    return cabac_decision(s, r, 23) ? 2 : 3;
}

static int cabac_sub_mb_type_b_one(Ctx &s, BitReader &r) {
    if (!cabac_decision(s, r, 36)) return 0;
    if (!cabac_decision(s, r, 37))
        return 1 + cabac_decision(s, r, 39);
    int t;
    if (cabac_decision(s, r, 38)) {
        if (cabac_decision(s, r, 39))
            return 11 + cabac_decision(s, r, 39);
        t = 7;
    } else {
        t = 3;
    }
    t += cabac_decision(s, r, 39) * 2;
    return t + cabac_decision(s, r, 39);
}

static int cabac_transform8x8_flag(Ctx &s, BitReader &r, int avail) {
    int ofs = 399 + (((avail & 2) && top_of(s).transform8x8 != 0) ? 1 : 0)
            + (((avail & 1) && s.mbleft.transform8x8 != 0) ? 1 : 0);
    return cabac_decision(s, r, ofs);
}

// -- residual ---------------------------------------------------------
static uint32_t cabac_bypass_coeff(Ctx &s, BitReader &r) {
    int ln = 0;
    while (cabac_bypass(s, r)) {
        ln += 1;
        if (ln > 30) return 0;
    }
    uint32_t v0 = (1u << ln) - 1;
    if (ln) v0 += cabac_multibypass(s, r, ln);
    return v0;
}

static inline int lt_ipcm(Ctx &s) { return s.mb_type < MB_IPCM; }

static int ctxidxinc_cbf(Ctx &s, int pos4x4, uint32_t cbf, int avail) {
    PrevMb &l = s.mbleft;
    PrevMb &t = top_of(s);
    switch (pos4x4) {
    case 0: {
        int ab = (avail & 1) ? (l.cbf & 1) : lt_ipcm(s);
        ab += (avail & 2) ? (t.cbf & 1) * 2 : lt_ipcm(s) * 2;
        return ab;
    }
    case 1: {
        int ab = cbf & 1;
        ab += (avail & 2) ? (t.cbf & 2) : lt_ipcm(s) * 2;
        return ab;
    }
    case 2: {
        int ab = (avail & 1) ? ((l.cbf >> 1) & 1) : lt_ipcm(s);
        return ab + ((cbf * 2) & 2);
    }
    case 3: return ((cbf >> 2) & 1) | (cbf & 2);
    case 4: {
        int ab = (cbf >> 1) & 1;
        ab += (avail & 2) ? ((t.cbf >> 1) & 2) : lt_ipcm(s) * 2;
        return ab;
    }
    case 5: {
        int ab = (cbf >> 4) & 1;
        ab += (avail & 2) ? ((t.cbf >> 2) & 2) : lt_ipcm(s) * 2;
        return ab;
    }
    case 6: return (cbf >> 3) & 3;
    case 7: return ((cbf >> 6) & 1) | ((cbf >> 4) & 2);
    case 8: {
        int ab = (avail & 1) ? ((l.cbf >> 2) & 1) : lt_ipcm(s);
        return ab + ((cbf >> 1) & 2);
    }
    case 9: return ((cbf >> 8) & 1) | ((cbf >> 2) & 2);
    case 10: {
        int ab = (avail & 1) ? ((l.cbf >> 3) & 1) : lt_ipcm(s);
        return ab + ((cbf >> 7) & 2);
    }
    case 11: return ((cbf >> 10) & 1) | ((cbf >> 8) & 2);
    case 12: return ((cbf >> 9) & 1) | ((cbf >> 5) & 2);
    case 13: return ((cbf >> 12) & 1) | ((cbf >> 6) & 2);
    case 14: return (cbf >> 11) & 3;
    case 15: return ((cbf >> 14) & 1) | ((cbf >> 12) & 2);
    case 16: case 17: {
        int n = pos4x4 - 16;
        int ab = (avail & 1) ? ((l.cbf >> (4 + n)) & 1) : lt_ipcm(s);
        ab += (avail & 2) ? ((t.cbf >> (3 + n)) & 2) : lt_ipcm(s) * 2;
        return ab;
    }
    case 18: case 22: {
        int n = pos4x4 == 18 ? 0 : 1;
        int ab = (avail & 1) ? ((l.cbf >> (6 + n * 2)) & 1) : lt_ipcm(s);
        ab += (avail & 2) ? ((t.cbf >> (5 + n * 2)) & 2) : lt_ipcm(s) * 2;
        return ab;
    }
    case 19: case 23: {
        int n = pos4x4 == 19 ? 0 : 1;
        int ab = (cbf >> (18 + n * 4)) & 1;
        ab += (avail & 2) ? ((t.cbf >> (6 + n * 2)) & 2) : lt_ipcm(s) * 2;
        return ab;
    }
    case 20: case 24: {
        int n = pos4x4 == 20 ? 0 : 1;
        int ab = (cbf >> (17 + n * 4)) & 2;
        ab += (avail & 1) ? ((l.cbf >> (7 + n * 2)) & 1) : lt_ipcm(s);
        return ab;
    }
    case 21: case 25: {
        int n = pos4x4 == 21 ? 18 : 22;
        return ((cbf >> (n + 2)) & 1) | ((cbf >> n) & 2);
    }
    default: {  // 26: intra16x16 DC
        int inc = (avail & 1) ? ((l.cbf >> 10) & 1) : 1;
        inc += (avail & 2) ? ((t.cbf >> 9) & 2) : 2;
        return inc;
    }
    }
}

static int cabac_residual(Ctx &s, BitReader &r, int32_t *coeff,
                          const int32_t *qmat, int avail, int pos4x4,
                          int cat) {
    uint32_t flag;
    if (cat != 5) {
        int inc = ctxidxinc_cbf(s, pos4x4, s.cbf, avail);
        flag = cabac_decision(s, r, 85 + inc + cat * 4);
        if (!flag) return 0;
    } else {
        flag = 0xF;
    }
    s.cbf |= flag << pos4x4;
    const CatInfo &ci = CATS[cat];
    /* field slices use the field significance-map context offsets
     * (significant_coeff_flag_offset[2][6][2], h264.cpp:11492-11503) */
    static const int16_t SIG_OFS_FIELD[6][2] = {
        {277, 338}, {292, 353}, {306, 367}, {321, 382}, {324, 385},
        {436, 451}};
    int sig_ofs, last_ofs;
    if (s.sp.is_field) {
        sig_ofs = SIG_OFS_FIELD[cat][0];
        last_ofs = SIG_OFS_FIELD[cat][1];
    } else {
        sig_ofs = SIG_OFS[cat][0];
        last_ofs = SIG_OFS[cat][1];
    }
    const int16_t (*latter)[3] = (cat == 5) ? SIG64 : SIG16;
    int coeff_map[64];
    int nmap = 0;
    bool ended = false;
    for (int i = 0; i < ci.num - 1; i++) {
        if (cabac_decision(s, r, sig_ofs + latter[i][1])) {
            coeff_map[nmap++] = i;
            if (cabac_decision(s, r, last_ofs + latter[i][0])) {
                ended = true;
                break;
            }
        }
    }
    if (!ended) coeff_map[nmap++] = ci.num - 1;
    int abs_base = ABS_LEVEL_OFS[cat] + 227;
    for (int k = ci.ofs; k < ci.ofs + ci.num; k++) coeff[k] = 0;
    int node = 0;
    for (int mp = nmap - 1; mp >= 0; mp--) {
        int64_t lvl;
        if (!cabac_decision(s, r, abs_base + COEFF_ABS_LEVEL_CTX[0][node])) {
            lvl = 1;
            node = COEFF_ABS_LEVEL_TRANS[0][node];
        } else {
            lvl = 2;
            int idx = abs_base + COEFF_ABS_LEVEL_CTX[1][node];
            node = COEFF_ABS_LEVEL_TRANS[1][node];
            while (lvl < 15 && cabac_decision(s, r, idx)) lvl += 1;
            if (lvl == 15) lvl += cabac_bypass_coeff(s, r);
        }
        int zi = ci.zz[coeff_map[mp] + ci.ofs];
        if (cabac_bypass(s, r)) lvl = -lvl;
        coeff[zi] = (int32_t)(lvl * qmat[zi & ci.dc_mask]);
    }
    return nmap <= 15 ? nmap : 15;
}

// -- CABAC slice loop --------------------------------------------------
static int macroblock_layer_cabac(Ctx &s, BitReader &r) {
    deb_idc_entry_clear(s);
    int st = s.sp.slice_type;
    int avail = get_avail(s);
    int mbtype;
    if (st == P_SLICE) {
        mbtype = cabac_mb_type_P(s, r, avail) - 5;
        if (mbtype < 0) mbtype += MB_PSKIP;
    } else if (st == B_SLICE) {
        mbtype = cabac_mb_type_B(s, r, avail) - 23;
        if (mbtype < 0) mbtype += 23 + MB_PSKIP;
    } else {
        mbtype = cabac_mb_type_I(s, r, avail, 3, st);
    }
    s.mb_type = mbtype;
    int e = mb_dispatch(s, r, mbtype, avail);
    if (e < 0) return e;
    if (mbtype == MB_IPCM) cabac_init_engine(s, r);
    return 0;
}

static int slice_data_cabac(Ctx &s, BitReader &r) {
    cabac_init_context(s, s.qp, s.sp.cabac_init_idc);
    r.byte_align();
    cabac_init_engine(s, r);
    for (;;) {
        if (s.sp.slice_type != I_SLICE) {
            if (cabac_mb_skip(s, r, s.sp.slice_type)) {
                int e = skip_mbs(s, 1);
                if (e == -1) break;
                if (e < -1) return e;
                if (cabac_terminate(s, r)) break;
                continue;
            }
        }
        int e = macroblock_layer_cabac(s, r);
        if (e < 0) return e;
        if (r.past_end()) return -2;  // truncated mid-slice
        s.mbleft.mb_skip = 0;
        top_of(s).mb_skip = 0;
        if (increment_mb_pos(s) < 0) break;
        if (cabac_terminate(s, r)) break;
    }
    return r.past_end() ? -2 : 0;
}

}  // namespace

// ---------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------
extern "C" {

void *h264p_new(int max_x, int max_y) {
    Ctx *s = new Ctx();
    memset(s, 0, sizeof(Ctx));
    s->max_x = max_x;
    s->max_y = max_y;
    s->nmb = max_x * max_y;
    s->top_pred = new int32_t[max_x * 4]();
    s->top_coef = new int32_t[max_x * 8]();
    s->mbtop = new PrevMb[max_x + 2]();
    return s;
}

void h264p_free(void *ctx) {
    Ctx *s = (Ctx *)ctx;
    delete[] s->top_pred;
    delete[] s->top_coef;
    delete[] s->mbtop;
    delete s;
}

/* clear != 0: the caller passed uninitialized (np.empty) plan buffers;
 * memset every densely-consumed field here (single warm-page pass in C)
 * EXCEPT the coefficient planes and the PCM store, whose unwritten
 * regions are gated by the per-MB coded map / kind==4 scan. */
void h264p_begin_picture(void *ctx, void **plan_ptrs, int clear) {
    Ctx *s = (Ctx *)ctx;
    PlanPtrs &p = s->plan;
    int i = 0;
    p.kind = (int32_t *)plan_ptrs[i++];
    p.t8x8 = (int32_t *)plan_ptrs[i++];
    p.coef_luma = (int32_t *)plan_ptrs[i++];
    p.coef_chroma = (int32_t *)plan_ptrs[i++];
    p.i4_modes = (int32_t *)plan_ptrs[i++];
    p.i4_avail = (int32_t *)plan_ptrs[i++];
    p.i8_modes = (int32_t *)plan_ptrs[i++];
    p.i8_avail = (int32_t *)plan_ptrs[i++];
    p.i16_mode = (int32_t *)plan_ptrs[i++];
    p.chroma_mode = (int32_t *)plan_ptrs[i++];
    p.mb_avail = (int32_t *)plan_ptrs[i++];
    p.mv = (int32_t *)plan_ptrs[i++];
    p.slot = (int32_t *)plan_ptrs[i++];
    p.wp = (int32_t *)plan_ptrs[i++];
    p.pcm = (uint8_t *)plan_ptrs[i++];
    p.deb_idc = (int32_t *)plan_ptrs[i++];
    p.deb_qpy = (int32_t *)plan_ptrs[i++];
    p.deb_qpc = (int32_t *)plan_ptrs[i++];
    p.deb_slicehdr = (int32_t *)plan_ptrs[i++];
    p.deb_str4 = (int32_t *)plan_ptrs[i++];
    p.deb_str = (int64_t *)plan_ptrs[i++];
    s->curr_type = (int32_t *)plan_ptrs[i++];
    s->curr_ref = (int32_t *)plan_ptrs[i++];
    s->curr_mv = (int32_t *)plan_ptrs[i++];
    p.coded = (uint32_t *)plan_ptrs[i++];
    int64_t n = s->nmb;
    /* clear: 1 = new picture, clear dense fields + coded map;
       0 = new picture, caller pre-zeroed (numpy) — clear coded only;
       -1 = bind pointers only (secondary slice-worker contexts joining
       a picture already begun by the primary context) */
    if (clear >= 0) memset(p.coded, 0, n * 4);
    if (clear > 0) {
        memset(p.kind, 0, n * 4);
        memset(p.t8x8, 0, n * 4);
        memset(p.i4_modes, 0, n * 64);
        memset(p.i4_avail, 0, n * 64);
        memset(p.i8_modes, 0, n * 16);
        memset(p.i8_avail, 0, n * 16);
        memset(p.i16_mode, 0, n * 4);
        memset(p.chroma_mode, 0, n * 4);
        memset(p.mb_avail, 0, n * 4);
        memset(p.mv, 0, n * 256);
        memset(p.slot, 0xFF, n * 32);  // -1 = list unused
        memset(p.wp, 0, n * 192);
        memset(p.deb_idc, 0, n * 4);
        memset(p.deb_qpy, 0, n * 4);
        memset(p.deb_qpc, 0, n * 8);
        memset(p.deb_slicehdr, 0, n * 8);
        memset(p.deb_str4, 0, n * 8);
        memset(p.deb_str, 0, n * 16);
    }
}

void h264p_set_refs(void *ctx, const int32_t *refs /* [2][16][4] */,
                    const int32_t *col_type, const int32_t *col_ref,
                    const int32_t *col_mv, const int32_t *col_map,
                    const int32_t *map_col_to_list0 /* [16] */,
                    const int32_t *scale_tab /* [16] */,
                    const int32_t *wtab /* [2][32][3][2] */,
                    const int32_t *wshift /* [2] */,
                    const int32_t *implicit_w /* [32][32][2] */) {
    Ctx *s = (Ctx *)ctx;
    for (int lx = 0; lx < 2; lx++)
        for (int k = 0; k < 16; k++) {
            const int32_t *e = refs + (lx * 16 + k) * 4;
            s->refs[lx][k].frame_idx = e[0];
            s->refs[lx][k].poc = e[1];
            s->refs[lx][k].in_use = e[2];
            s->refs[lx][k].col_idx = e[3];
        }
    s->col_type = (int32_t *)col_type;
    s->col_ref = (int32_t *)col_ref;
    s->col_mv = (int32_t *)col_mv;
    s->col_map = col_map;
    if (map_col_to_list0)
        memcpy(s->map_col_to_list0, map_col_to_list0, 16 * sizeof(int32_t));
    if (scale_tab) memcpy(s->scale_tab, scale_tab, 16 * sizeof(int32_t));
    if (wtab) memcpy(s->wtab, wtab, sizeof(s->wtab));
    if (wshift) { s->wshift[0] = wshift[0]; s->wshift[1] = wshift[1]; }
    if (implicit_w) memcpy(s->implicit_w, implicit_w, sizeof(s->implicit_w));
}

/* Returns 0 ok / negative error; out_state = {mb_pos, mb_x, mb_y,
 * firstline} after the slice. */
int h264p_slice(void *ctx, const uint8_t *payload, int64_t nbytes,
                const SliceParams *sp, int32_t *out_state) {
    Ctx *s = (Ctx *)ctx;
    s->sp = *sp;
    set_mb_pos(*s, sp->first_mb);
    set_qp(*s, sp->qp);
    s->plan.deb_slicehdr[sp->first_mb * 2] = sp->alpha_ofs;
    s->plan.deb_slicehdr[sp->first_mb * 2 + 1] = sp->beta_ofs;
    s->plan.deb_idc[sp->first_mb] = sp->deb_idc_plus1;
    BitReader r;
    r.init(payload, nbytes, sp->bit_offset);
    uint64_t t0 = __rdtsc();
    int e = slice_data(*s, r);
    g_prof[0] += __rdtsc() - t0;
    out_state[0] = s->mb_pos;
    out_state[1] = s->mb_x;
    out_state[2] = s->mb_y;
    out_state[3] = s->firstline;
    return e;
}


/* finalize_deblock (plan.py): flatten raw per-MB deblock records into
 * edge parameters with deblock_pb's raster-order running state
 * (h264.cpp:10540-10663). out arrays: str [n][2][4], str4 [n][2],
 * ab [n][2][6][2] (pre-filled with -16 by the caller). */
void h264p_finalize_deblock(void *ctx, int firstline, int32_t *out_str,
                            int32_t *out_str4, int32_t *out_ab) {
    Ctx *s = (Ctx *)ctx;
    int max_x = s->max_x, max_y = s->max_y;
    int idc = 0, a_ofs = 0, b_ofs = 0;
    /* initialize outputs here so callers may pass np.empty buffers */
    memset(out_str, 0, (int64_t)s->nmb * 8 * 4);
    memset(out_str4, 0, (int64_t)s->nmb * 2 * 4);
    for (int64_t i = 0; i < (int64_t)s->nmb * 24; i++) out_ab[i] = -16;
    for (int y = 0; y < max_y; y++) {
        for (int x = 0; x < max_x; x++) {
            int p = y * max_x + x;
            if (s->plan.deb_idc[p]) {
                idc = s->plan.deb_idc[p] - 1;
                a_ofs = s->plan.deb_slicehdr[p * 2];
                b_ofs = s->plan.deb_slicehdr[p * 2 + 1];
            }
            if (idc == 1) continue;
            int qpy = s->plan.deb_qpy[p];
            int qpc0 = s->plan.deb_qpc[p * 2];
            int qpc1 = s->plan.deb_qpc[p * 2 + 1];
            int64_t strv = s->plan.deb_str[p * 2];
            int64_t strh = s->plan.deb_str[p * 2 + 1];
            int32_t *ab = out_ab + p * 24;       // [2][6][2]
            int32_t *st = out_str + p * 8;       // [2][4]
            int32_t *s4 = out_str4 + p * 2;
#define AB(dst, qp)                                                           do {                                                                          int q_ = (qp);                                                            (dst)[0] = (q_ + a_ofs < 51 ? q_ + a_ofs : 51) - 16;                      (dst)[1] = (q_ + b_ofs < 51 ? q_ + b_ofs : 51) - 16;                  } while (0)
            if (x != 0 && (!idc || firstline != max_x) && (strv & 255)) {
                st[0] = strv & 255;
                s4[0] = s->plan.deb_str4[p * 2];
                AB(ab + 0, (qpy + s->plan.deb_qpy[p - 1] + 1) >> 1);
                AB(ab + 2, (qpc0 + s->plan.deb_qpc[(p - 1) * 2] + 1) >> 1);
                AB(ab + 4, (qpc1 + s->plan.deb_qpc[(p - 1) * 2 + 1] + 1) >> 1);
            }
            if (strv & ~255ll) {
                AB(ab + 6, qpy);
                for (int e = 1; e < 4; e++) st[e] = (strv >> (8 * e)) & 255;
                if ((strv >> 16) & 255) {
                    AB(ab + 8, qpc0);
                    AB(ab + 10, qpc1);
                }
            }
            if (y != 0 && (!idc || firstline < 0) && (strh & 255)) {
                int tp = p - max_x;
                st[4] = strh & 255;
                s4[1] = s->plan.deb_str4[p * 2 + 1];
                AB(ab + 12, (qpy + s->plan.deb_qpy[tp] + 1) >> 1);
                AB(ab + 14, (qpc0 + s->plan.deb_qpc[tp * 2] + 1) >> 1);
                AB(ab + 16, (qpc1 + s->plan.deb_qpc[tp * 2 + 1] + 1) >> 1);
            }
            if (strh & ~255ll) {
                AB(ab + 18, qpy);
                for (int e = 1; e < 4; e++)
                    st[4 + e] = (strh >> (8 * e)) & 255;
                if ((strh >> 16) & 255) {
                    AB(ab + 20, qpc0);
                    AB(ab + 22, qpc1);
                }
            }
#undef AB
        }
    }
}

uint64_t *h264p_profile() { return g_prof; }

}  // extern "C"

namespace {
// placeholder stubs (replaced by the inter/CABAC stages)
}  // namespace

// =====================================================================
// Batch wire packer: PicturePlan batch -> single transport blob.
//
// Replaces the Python np.stack + _pack_wire + _flatten_wire path
// (m2dec_tpu/codecs/h264/reconstruct.py) which cost ~1 s/frame at
// 1080p in numpy. Semantics are identical: coefficient planes ship
// sparse (big-endian bitmap of nonzero positions + packed values),
// heavily-repeating row tensors (mv/wp/deb_ab) ship as unique-row
// palettes + small indices, everything else ships narrowed. The
// coded-block map lets the scan skip untouched coefficient memory, so
// the coef tensors never need zero-initialization on the fast path.
//
// Protocol: Python calls h264pack_measure once per batch (builds the
// palettes, counts nonzeros, range-checks), derives the layout/caps/
// dtypes from meta, allocates the blob, then calls h264pack_fill with
// per-leaf destination pointers. Measure and fill must see the same
// pictures in the same order.
// =====================================================================

#include <vector>
#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define H264PACK_AVX512 1
#endif

namespace {

struct K24 {
    uint64_t a, b, c;
    bool operator==(const K24 &o) const {
        return a == o.a && b == o.b && c == o.c;
    }
};
struct K24Hash {
    size_t operator()(const K24 &k) const {
        uint64_t h = 1469598103934665603ull;
        for (uint64_t v : {k.a, k.b, k.c}) {
            h ^= v;
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};

/* Open-addressing key->palette-id table.  std::unordered_map's
 * node-per-entry layout made h264pack_measure cache-miss-bound on
 * high-entropy MV content (65k unique rows, 1.5M probes per 1080p
 * GOP); linear probing over one contiguous array is several times
 * faster.  ids[] == -1 marks an empty slot so any 64-bit key value is
 * representable. */
struct FlatMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> ids;
    size_t mask = 0;

    void reset(size_t cap_pow2) {
        if (keys.size() != cap_pow2) {
            keys.assign(cap_pow2, 0);
            ids.assign(cap_pow2, -1);
        } else {
            std::fill(ids.begin(), ids.end(), -1);
        }
        mask = cap_pow2 - 1;
    }
    static inline size_t mix(uint64_t key) {
        return (size_t)((key * 0x9E3779B97F4A7C15ull) >> 29);
    }
};

// per-picture plan pointer block (the _PLAN_KEYS order + coded)
struct PicPtrs {
    const int32_t *coef_luma, *coef_chroma, *t8x8, *kind;
    const int32_t *i4_modes, *i4_avail, *i8_modes, *i8_avail;
    const int32_t *i16_mode, *chroma_mode, *mb_avail;
    const int32_t *mv, *slot, *wp;
    const int32_t *deb_str, *deb_str4, *deb_ab;
    const uint32_t *coded;
};

static PicPtrs pic_of(void **pp, int b) {
    void **q = pp + b * 18;
    PicPtrs o;
    o.coef_luma = (const int32_t *)q[0];
    o.coef_chroma = (const int32_t *)q[1];
    o.t8x8 = (const int32_t *)q[2];
    o.kind = (const int32_t *)q[3];
    o.i4_modes = (const int32_t *)q[4];
    o.i4_avail = (const int32_t *)q[5];
    o.i8_modes = (const int32_t *)q[6];
    o.i8_avail = (const int32_t *)q[7];
    o.i16_mode = (const int32_t *)q[8];
    o.chroma_mode = (const int32_t *)q[9];
    o.mb_avail = (const int32_t *)q[10];
    o.mv = (const int32_t *)q[11];
    o.slot = (const int32_t *)q[12];
    o.wp = (const int32_t *)q[13];
    o.deb_str = (const int32_t *)q[14];
    o.deb_str4 = (const int32_t *)q[15];
    o.deb_ab = (const int32_t *)q[16];
    o.coded = (const uint32_t *)q[17];
    return o;
}

struct PackCtx {
    // palettes (insertion-ordered rows) + flat probe tables
    FlatMap mv_map, wp_map, ab_map;  // wp/ab key = K24 digest, verified
    std::vector<uint64_t> mv_rows;
    std::vector<K24> wp_rows, ab_rows;
    // measured per-row indices (u16; downcast at fill if palette small)
    std::vector<uint16_t> mv_idx, wp_idx, ab_idx;
    bool mv_pal_ok = true, wp_pal_ok = true, ab_pal_ok = true;
};

/* find-or-insert for 24-byte keys: the table stores the digest; the
 * insertion-ordered rows vector resolves digest collisions exactly. */
template <typename Rows>
static inline int32_t k24_find_or_add(FlatMap &m, Rows &rows,
                                      const K24 &key, bool *overflow) {
    uint64_t dig = (uint64_t)K24Hash()(key);
    size_t i = FlatMap::mix(dig) & m.mask;
    for (;;) {
        int32_t id = m.ids[i];
        if (id < 0) {
            int32_t nid = (int32_t)rows.size();
            if (nid > 65535) {
                *overflow = true;
                return -1;
            }
            m.keys[i] = dig;
            m.ids[i] = nid;
            rows.push_back(key);
            return nid;
        }
        if (m.keys[i] == dig && rows[id] == key) return id;
        i = (i + 1) & m.mask;
    }
}

// walk one picture's coded coefficient blocks; F(flat_base, width, ptr)
template <typename F>
static void for_coded_luma(const PicPtrs &P, int n, F f) {
    for (int mb = 0; mb < n; mb++) {
        uint32_t cb = P.coded[mb] & 0xFFFFu;
        if (!cb) continue;
        bool wide = P.t8x8[mb] || P.kind[mb] == 2;
        int w = wide ? 64 : 16;
        while (cb) {
            int blk = __builtin_ctz(cb);
            cb &= cb - 1;
            f((int64_t)mb * 256 + blk * w, w, P.coef_luma + mb * 256 + blk * w);
        }
    }
}

template <typename F>
static void for_coded_chroma(const PicPtrs &P, int n, F f) {
    for (int mb = 0; mb < n; mb++) {
        uint32_t cb = P.coded[mb] >> 16;
        if (!cb) continue;
        while (cb) {
            int k = __builtin_ctz(cb);  // c*4 + b
            cb &= cb - 1;
            f((int64_t)mb * 128 + k * 16, 16, P.coef_chroma + mb * 128 + k * 16);
        }
    }
}

}  // namespace

extern "C" {

void *h264pack_new() { return new PackCtx(); }
void h264pack_free(void *pk) { delete (PackCtx *)pk; }

/* meta[16]: 0 cl_maxcnt, 1 cl_min, 2 cl_max, 3 cc_maxcnt, 4 cc_min,
 * 5 cc_max, 6 mv_rows(-1 overflow), 7 mv_min, 8 mv_max,
 * 9 wp_rows(-1), 10 wp_min, 11 wp_max, 12 ab_rows */
void h264pack_measure(void *pk_, void **pp, int B, int n, int64_t *meta) {
    PackCtx &pk = *(PackCtx *)pk_;
    pk.mv_rows.clear();
    pk.wp_rows.clear();
    pk.ab_rows.clear();
    pk.mv_map.reset(1 << 18);   // 65536 ids at 25% load
    pk.wp_map.reset(1 << 18);
    pk.ab_map.reset(1 << 18);
    pk.mv_pal_ok = pk.wp_pal_ok = pk.ab_pal_ok = true;
    pk.mv_idx.resize((size_t)B * n * 16);
    pk.wp_idx.resize((size_t)B * n * 4);
    pk.ab_idx.resize((size_t)B * n);
    int64_t cl_maxcnt = 0, cc_maxcnt = 0;
    int64_t cl_min = 0, cl_max = 0, cc_min = 0, cc_max = 0;
    int64_t mv_min = 0, mv_max = 0, wp_min = 0, wp_max = 0;
    int64_t has_i8 = 0, deblock = 0;
    for (int b = 0; b < B; b++) {
        PicPtrs P = pic_of(pp, b);
        // jit-variant flags (has_i8 / deblock in reconstruct.py)
        if (!has_i8)
            for (int mb = 0; mb < n; mb++)
                if (P.kind[mb] == 2 || (P.t8x8[mb] && P.kind[mb] == 0)) {
                    has_i8 = 1;
                    break;
                }
        if (!deblock) {
            for (int64_t k = 0; k < (int64_t)n * 8 && !deblock; k++)
                if (P.deb_str[k]) deblock = 1;
            for (int64_t k = 0; k < (int64_t)n * 2 && !deblock; k++)
                if (P.deb_str4[k]) deblock = 1;
        }
        int64_t cnt = 0;
#ifdef H264PACK_AVX512
        {
            __m512i vmin = _mm512_setzero_si512(), vmax = vmin;
            for_coded_luma(P, n,
                           [&](int64_t, int w, const int32_t *v) {
                for (int k = 0; k < w; k += 16) {
                    __m512i x = _mm512_loadu_si512(v + k);
                    cnt += _mm_popcnt_u32(
                        _mm512_test_epi32_mask(x, x));
                    vmin = _mm512_min_epi32(vmin, x);
                    vmax = _mm512_max_epi32(vmax, x);
                }
            });
            // zeros in the lanes can't move min below / max above the
            // 0-initialized accumulators, matching the nonzero-only
            // scalar reduction
            int32_t mn = _mm512_reduce_min_epi32(vmin);
            int32_t mx = _mm512_reduce_max_epi32(vmax);
            if (mn < cl_min) cl_min = mn;
            if (mx > cl_max) cl_max = mx;
        }
#else
        for_coded_luma(P, n, [&](int64_t, int w, const int32_t *v) {
            for (int k = 0; k < w; k++) {
                int32_t x = v[k];
                if (x) {
                    cnt++;
                    if (x < cl_min) cl_min = x;
                    if (x > cl_max) cl_max = x;
                }
            }
        });
#endif
        if (cnt > cl_maxcnt) cl_maxcnt = cnt;
        cnt = 0;
#ifdef H264PACK_AVX512
        {
            __m512i vmin = _mm512_setzero_si512(), vmax = vmin;
            for_coded_chroma(P, n,
                             [&](int64_t, int w, const int32_t *v) {
                __m512i x = _mm512_loadu_si512(v);
                cnt += _mm_popcnt_u32(_mm512_test_epi32_mask(x, x));
                vmin = _mm512_min_epi32(vmin, x);
                vmax = _mm512_max_epi32(vmax, x);
            });
            int32_t mn = _mm512_reduce_min_epi32(vmin);
            int32_t mx = _mm512_reduce_max_epi32(vmax);
            if (mn < cc_min) cc_min = mn;
            if (mx > cc_max) cc_max = mx;
        }
#else
        for_coded_chroma(P, n, [&](int64_t, int w, const int32_t *v) {
            for (int k = 0; k < w; k++) {
                int32_t x = v[k];
                if (x) {
                    cnt++;
                    if (x < cc_min) cc_min = x;
                    if (x > cc_max) cc_max = x;
                }
            }
        });
#endif
        if (cnt > cc_maxcnt) cc_maxcnt = cnt;
        // mv palette: rows of 4 int16. MV fields are piecewise-constant
        // (one MV per partition), so a previous-row memo skips the hash
        // lookup for the vast majority of rows.  High-entropy MV
        // content defeats palettization (~65k uniques at 1080p random
        // MVs): when the first picture dedups worse than 4:1, bail to
        // the dense-int16 wire mode and skip the hashing entirely —
        // ~40 ms of host time per 12-picture batch traded against
        // ~9 MB of extra (fast) h2d transfer.
        if (b == 1 && pk.mv_pal_ok &&
            (int64_t)pk.mv_rows.size() * 4 > (int64_t)n * 16)
            pk.mv_pal_ok = false;
        uint16_t *mi = pk.mv_idx.data() + (size_t)b * n * 16;
        uint64_t mv_prev_key = ~0ull;
        int32_t mv_prev_id = 0;
#ifdef H264PACK_AVX512
        if (!pk.mv_pal_ok) {
            // min/max only (int16 range check), vectorized
            __m512i vmin = _mm512_setzero_si512(), vmax = vmin;
            const int32_t *mvp = P.mv;
            int64_t cnt = (int64_t)n * 64;
            for (int64_t k = 0; k + 16 <= cnt; k += 16) {
                __m512i x = _mm512_loadu_si512(mvp + k);
                vmin = _mm512_min_epi32(vmin, x);
                vmax = _mm512_max_epi32(vmax, x);
            }
            int32_t mn = _mm512_reduce_min_epi32(vmin);
            int32_t mx = _mm512_reduce_max_epi32(vmax);
            if (mn < mv_min) mv_min = mn;
            if (mx > mv_max) mv_max = mx;
            goto mv_done;
        }
#endif
        for (int64_t r = 0; r < (int64_t)n * 16; r++) {
            const int32_t *v = P.mv + r * 4;
            uint64_t key = 0;
            for (int k = 0; k < 4; k++) {
                int32_t x = v[k];
                if (x < mv_min) mv_min = x;
                if (x > mv_max) mv_max = x;
                key |= (uint64_t)(uint16_t)(int16_t)x << (k * 16);
            }
            if (pk.mv_pal_ok) {
                int32_t id;
                if (key == mv_prev_key) {
                    id = mv_prev_id;
                } else {
                    FlatMap &m = pk.mv_map;
                    size_t i = FlatMap::mix(key) & m.mask;
                    for (;;) {
                        int32_t id0 = m.ids[i];
                        if (id0 < 0) {
                            id = (int32_t)pk.mv_rows.size();
                            if (id > 65535) {
                                pk.mv_pal_ok = false;
                                break;
                            }
                            m.keys[i] = key;
                            m.ids[i] = id;
                            pk.mv_rows.push_back(key);
                            break;
                        }
                        if (m.keys[i] == key) {
                            id = id0;
                            break;
                        }
                        i = (i + 1) & m.mask;
                    }
                    if (!pk.mv_pal_ok) continue;
                    mv_prev_key = key;
                    mv_prev_id = id;
                }
                mi[r] = (uint16_t)id;
            }
        }
#ifdef H264PACK_AVX512
    mv_done:;
#endif
        // wp palette: rows of 12 int16 (24 bytes)
        uint16_t *wi = pk.wp_idx.data() + (size_t)b * n * 4;
        K24 wp_prev_key = {~0ull, 0, 0};
        int32_t wp_prev_id = 0;
        for (int64_t r = 0; r < (int64_t)n * 4; r++) {
            const int32_t *v = P.wp + r * 12;
            K24 key = {0, 0, 0};
            uint64_t *kp = &key.a;
            for (int k = 0; k < 12; k++) {
                int32_t x = v[k];
                if (x < wp_min) wp_min = x;
                if (x > wp_max) wp_max = x;
                kp[k >> 2] |= (uint64_t)(uint16_t)(int16_t)x
                              << ((k & 3) * 16);
            }
            if (pk.wp_pal_ok) {
                int32_t id;
                if (key == wp_prev_key) {
                    id = wp_prev_id;
                } else {
                    bool ovf = false;
                    id = k24_find_or_add(pk.wp_map, pk.wp_rows, key,
                                         &ovf);
                    if (ovf) {
                        pk.wp_pal_ok = false;
                        continue;
                    }
                    wp_prev_key = key;
                    wp_prev_id = id;
                }
                wi[r] = (uint16_t)id;
            }
        }
        // deb_ab palette: rows of 24 int8 (values always fit int8)
        uint16_t *ai = pk.ab_idx.data() + (size_t)b * n;
        K24 ab_prev_key = {~0ull, 0, 0};
        int32_t ab_prev_id = 0;
        for (int64_t r = 0; r < n; r++) {
            const int32_t *v = P.deb_ab + r * 24;
            K24 key = {0, 0, 0};
            uint8_t *kb = (uint8_t *)&key;
            for (int k = 0; k < 24; k++) kb[k] = (uint8_t)(int8_t)v[k];
            if (!pk.ab_pal_ok) continue;
            int32_t id;
            if (key == ab_prev_key) {
                id = ab_prev_id;
            } else {
                bool ovf = false;
                id = k24_find_or_add(pk.ab_map, pk.ab_rows, key, &ovf);
                if (ovf) {
                    pk.ab_pal_ok = false;  // dense fallback (meta -1)
                    continue;
                }
                ab_prev_key = key;
                ab_prev_id = id;
            }
            ai[r] = (uint16_t)id;
        }
    }
    meta[0] = cl_maxcnt; meta[1] = cl_min; meta[2] = cl_max;
    meta[3] = cc_maxcnt; meta[4] = cc_min; meta[5] = cc_max;
    meta[6] = pk.mv_pal_ok ? (int64_t)pk.mv_rows.size() : -1;
    meta[7] = mv_min; meta[8] = mv_max;
    meta[9] = pk.wp_pal_ok ? (int64_t)pk.wp_rows.size() : -1;
    meta[10] = wp_min; meta[11] = wp_max;
    meta[12] = pk.ab_pal_ok ? (int64_t)pk.ab_rows.size() : -1;
    meta[13] = has_i8;
    meta[14] = deblock;
    meta[15] = 0;
}

/* leaf destination pointers, canonical (alphabetical) wire order:
 *  0 chroma_mode  1 coef_chroma.bits|dense  2 coef_chroma.vals
 *  3 coef_luma.bits|dense  4 coef_luma.vals  5 deb_ab.idx|dense
 *  6 deb_str  7 deb_str4  8 i16_mode  9 i4_avail  10 i4_modes
 *  11 i8_avail  12 i8_modes  13 kind  14 mb_avail  15 mv.idx|dense
 *  16 slot  17 t8x8  18 wp.idx|dense
 * job: 0 cl_cap, 1 cl_dense, 2 cc_cap, 3 cc_dense, 4 mv_mode,
 *      5 wp_mode, 6 ab_mode (0 pal-u8, 1 pal-u16, 2 dense-narrow,
 *      3 dense-int32), 7/8/9 mv/wp/ab palette padded row counts */
#ifdef H264PACK_AVX512
#define R2(n) n, n + 2 * 64, n + 1 * 64, n + 3 * 64
#define R4(n) R2(n), R2(n + 2 * 16), R2(n + 1 * 16), R2(n + 3 * 16)
#define R6(n) R4(n), R4(n + 2 * 4), R4(n + 1 * 4), R4(n + 3 * 4)
static const uint8_t BITREV8[256] = {R6(0), R6(2), R6(1), R6(3)};
#undef R2
#undef R4
#undef R6

/* pack 16 coefficients at bit offset `ofs` (16-aligned): bitmap bytes
 * are MSB-first (bits[j>>3] |= 0x80 >> (j&7)), i.e. bit-reversed
 * nonzero masks; values compress in ascending order (vpcompressd).
 * The 32-byte value store may overwrite up to 16 entries past c with
 * zeros — identical to the memset baseline, and guarded against the
 * buffer end by the cap check. */
static inline int64_t pack_block16(uint8_t *bits, int16_t *vals,
                                   int64_t c, int64_t cap, int64_t ofs,
                                   const int32_t *v) {
    __m512i x = _mm512_loadu_si512(v);
    __mmask16 mz = _mm512_test_epi32_mask(x, x);
    int pc = _mm_popcnt_u32(mz);
    if (!pc) return c;
    if (c + 16 <= cap) {
        __m512i comp = _mm512_maskz_compress_epi32(mz, x);
        _mm256_storeu_si256((__m256i *)(vals + c),
                            _mm512_cvtepi32_epi16(comp));
    } else {
        int64_t cc = c;
        for (int k = 0; k < 16; k++)
            if (v[k]) vals[cc++] = (int16_t)v[k];
    }
    bits[ofs >> 3] = BITREV8[mz & 0xFF];
    bits[(ofs >> 3) + 1] = BITREV8[(mz >> 8) & 0xFF];
    return c + pc;
}
#endif

void h264pack_fill(void *pk_, void **pp, int B, int n, void **leaves,
                   const int64_t *job, int16_t *mv_pal, int16_t *wp_pal,
                   int8_t *ab_pal) {
    PackCtx &pk = *(PackCtx *)pk_;
    const int64_t cl_cap = job[0], cc_cap = job[2];
    const bool cl_dense = job[1] != 0, cc_dense = job[3] != 0;
    const int mv_mode = (int)job[4], wp_mode = (int)job[5],
              ab_mode = (int)job[6];
    // palettes (pad rows zeroed)
    if (mv_mode <= 1) {
        memset(mv_pal, 0, (size_t)job[7] * 4 * 2);
        memcpy(mv_pal, pk.mv_rows.data(), pk.mv_rows.size() * 8);
    }
    if (wp_mode <= 1) {
        memset(wp_pal, 0, (size_t)job[8] * 12 * 2);
        memcpy(wp_pal, pk.wp_rows.data(), pk.wp_rows.size() * 24);
    }
    if (ab_mode <= 1) {
        memset(ab_pal, 0, (size_t)job[9] * 24);
        memcpy(ab_pal, pk.ab_rows.data(), pk.ab_rows.size() * 24);
    }
    for (int b = 0; b < B; b++) {
        PicPtrs P = pic_of(pp, b);
        // --- narrowed dense fields ------------------------------------
        auto narrow8 = [&](int leaf, const int32_t *src, int64_t cnt) {
            int8_t *d = (int8_t *)leaves[leaf] + (int64_t)b * cnt;
            int64_t k = 0;
#ifdef H264PACK_AVX512
            for (; k + 16 <= cnt; k += 16)
                _mm_storeu_si128(
                    (__m128i *)(d + k),
                    _mm512_cvtepi32_epi8(_mm512_loadu_si512(src + k)));
#endif
            for (; k < cnt; k++) d[k] = (int8_t)src[k];
        };
        narrow8(0, P.chroma_mode, n);
        narrow8(6, P.deb_str, (int64_t)n * 8);   // uint8 == same bits
        narrow8(7, P.deb_str4, (int64_t)n * 2);
        narrow8(8, P.i16_mode, n);
        narrow8(9, P.i4_avail, (int64_t)n * 16);
        narrow8(10, P.i4_modes, (int64_t)n * 16);
        narrow8(11, P.i8_avail, (int64_t)n * 4);
        narrow8(12, P.i8_modes, (int64_t)n * 4);
        narrow8(13, P.kind, n);
        narrow8(14, P.mb_avail, n);
        narrow8(16, P.slot, (int64_t)n * 8);
        narrow8(17, P.t8x8, n);
        // --- coefficient planes ---------------------------------------
        if (cl_dense) {
            int32_t *d = (int32_t *)leaves[3] + (int64_t)b * n * 256;
            memset(d, 0, (int64_t)n * 256 * 4);
            for_coded_luma(P, n, [&](int64_t ofs, int w, const int32_t *v) {
                memcpy(d + ofs, v, w * 4);
            });
        } else {
            uint8_t *bits = (uint8_t *)leaves[3] + (int64_t)b * n * 32;
            int16_t *vals = (int16_t *)leaves[4] + (int64_t)b * cl_cap;
            memset(bits, 0, (int64_t)n * 32);
            memset(vals, 0, cl_cap * 2);
            int64_t c = 0;
#ifdef H264PACK_AVX512
            for_coded_luma(P, n,
                           [&](int64_t ofs, int w, const int32_t *v) {
                for (int k = 0; k < w; k += 16)
                    c = pack_block16(bits, vals, c, cl_cap, ofs + k,
                                     v + k);
            });
#else
            for_coded_luma(P, n, [&](int64_t ofs, int w, const int32_t *v) {
                for (int k = 0; k < w; k++) {
                    int32_t x = v[k];
                    if (x) {
                        int64_t j = ofs + k;
                        bits[j >> 3] |= 0x80u >> (j & 7);
                        vals[c++] = (int16_t)x;
                    }
                }
            });
#endif
        }
        if (cc_dense) {
            int32_t *d = (int32_t *)leaves[1] + (int64_t)b * n * 128;
            memset(d, 0, (int64_t)n * 128 * 4);
            for_coded_chroma(P, n, [&](int64_t ofs, int w, const int32_t *v) {
                memcpy(d + ofs, v, w * 4);
            });
        } else {
            uint8_t *bits = (uint8_t *)leaves[1] + (int64_t)b * n * 16;
            int16_t *vals = (int16_t *)leaves[2] + (int64_t)b * cc_cap;
            memset(bits, 0, (int64_t)n * 16);
            memset(vals, 0, cc_cap * 2);
            int64_t c = 0;
#ifdef H264PACK_AVX512
            for_coded_chroma(P, n,
                             [&](int64_t ofs, int w, const int32_t *v) {
                c = pack_block16(bits, vals, c, cc_cap, ofs, v);
            });
#else
            for_coded_chroma(P, n, [&](int64_t ofs, int w, const int32_t *v) {
                for (int k = 0; k < w; k++) {
                    int32_t x = v[k];
                    if (x) {
                        int64_t j = ofs + k;
                        bits[j >> 3] |= 0x80u >> (j & 7);
                        vals[c++] = (int16_t)x;
                    }
                }
            });
#endif
        }
        // --- paletted / dense-fallback row tensors ---------------------
        auto put_idx = [&](int leaf, int mode, const uint16_t *idx,
                           int64_t rows) {
            if (mode == 0) {
                uint8_t *d = (uint8_t *)leaves[leaf] + (int64_t)b * rows;
                for (int64_t k = 0; k < rows; k++) d[k] = (uint8_t)idx[k];
            } else {
                uint16_t *d = (uint16_t *)leaves[leaf] + (int64_t)b * rows;
                memcpy(d, idx, rows * 2);
            }
        };
        auto narrow16 = [&](int leaf, const int32_t *src, int64_t cnt) {
            int16_t *d = (int16_t *)leaves[leaf] + (int64_t)b * cnt;
            int64_t k = 0;
#ifdef H264PACK_AVX512
            for (; k + 16 <= cnt; k += 16)
                _mm256_storeu_si256(
                    (__m256i *)(d + k),
                    _mm512_cvtepi32_epi16(_mm512_loadu_si512(src + k)));
#endif
            for (; k < cnt; k++) d[k] = (int16_t)src[k];
        };
        if (mv_mode <= 1) {
            put_idx(15, mv_mode, pk.mv_idx.data() + (size_t)b * n * 16,
                    (int64_t)n * 16);
        } else if (mv_mode == 2) {
            narrow16(15, P.mv, (int64_t)n * 64);
        } else {
            memcpy((int32_t *)leaves[15] + (int64_t)b * n * 64, P.mv,
                   (int64_t)n * 64 * 4);
        }
        if (wp_mode <= 1) {
            put_idx(18, wp_mode, pk.wp_idx.data() + (size_t)b * n * 4,
                    (int64_t)n * 4);
        } else if (wp_mode == 2) {
            narrow16(18, P.wp, (int64_t)n * 48);
        } else {
            memcpy((int32_t *)leaves[18] + (int64_t)b * n * 48, P.wp,
                   (int64_t)n * 48 * 4);
        }
        if (ab_mode <= 1) {
            put_idx(5, ab_mode, pk.ab_idx.data() + (size_t)b * n, n);
        } else {
            narrow8(5, P.deb_ab, (int64_t)n * 24);
        }
    }
}

}  // extern "C"
