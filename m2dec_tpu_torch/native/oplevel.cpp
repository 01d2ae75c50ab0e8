// H.265 intra-op dependency-level scheduler (native port of
// codecs/h265/reconstruct._schedule_levels — see its docstring for the
// dependency model: flow/anti/output deps on the 4x4-cell grid,
// conservative read regions covering the strong-filter past-valid
// reads).  The Python loop costs ~700 ms per 1080p I-picture; this
// runs the identical algorithm in ~1 ms.  Reference decode order being
// replayed: the CTU walk at src/lib/h265.cpp:4752-4799 with z-ordered
// intra ops per CTU.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int h265_schedule_levels(const int32_t *ops, int64_t n,
                                    int32_t chg, int32_t cwg,
                                    int32_t stray, int32_t cap,
                                    int32_t cap_big, int32_t *lv_out) {
    std::vector<int32_t> lw((size_t)chg * cwg, 0);  // last writer level
    std::vector<int32_t> lr((size_t)chg * cwg, 0);  // latest reader
    std::vector<int32_t> occ;   // small-bank occupancy per level
    std::vector<int32_t> occb;  // big-bank (sl2>=4) occupancy
    for (int64_t i = 0; i < n; i++) {
        const int32_t *op = ops + i * 7;
        lv_out[i] = 0;
        int used = op[0];
        if (!(used & 1))
            continue;
        int y0 = op[1], x0 = op[2], sl2 = op[3];
        int s = 1 << sl2;
        int c0 = x0 >> 2, c1 = (x0 + s - 1) >> 2;
        int r0 = y0 >> 2, r1 = (y0 + s - 1) >> 2;
        int rr0 = std::max(0, r0 - 1), rc0 = std::max(0, c0 - 1);
        int rr1 = std::min(chg - 1, (y0 + 2 * s) >> 2);
        int rc1 = std::min(cwg - 1, (x0 + 2 * s) >> 2);
        int m = 0, a = 0;
        for (int r = r0; r <= r1; r++)
            for (int c = c0; c <= c1; c++) {
                m = std::max(m, lw[(size_t)r * cwg + c]);
                a = std::max(a, lr[(size_t)r * cwg + c]);
            }
        for (int r = rr0; r <= rr1; r++)
            m = std::max(m, lw[(size_t)r * cwg + rc0]);
        for (int c = rc0; c <= rc1; c++)
            m = std::max(m, lw[(size_t)rr0 * cwg + c]);
        int sy = (stray && (used & 2)) ? ((y0 + s) >> 2) : -1;
        if (sy >= chg)
            sy = -1;
        if (sy >= 0) {
            m = std::max(m, lw[(size_t)sy * cwg + c0]);
            a = std::max(a, lr[(size_t)sy * cwg + c0]);
        }
        int level = std::max(m + 1, a);
        if (cap > 0) {
            // lane-capacity cap: delaying an op past its minimum level
            // is safe — every later op's constraints read the ASSIGNED
            // levels below, so anti/flow deps propagate through the
            // bumped value.  Keeps the packed lane count (hence the
            // per-step tensor width of the device wavefront) bounded.
            // Big TUs (sl2>=4) have their own (tighter) cap: their
            // apply tensors are S=32-sized, so one big lane costs
            // ~16 small ones.
            bool big = sl2 >= 4;
            std::vector<int32_t> &o = big ? occb : occ;
            int c = big ? cap_big : cap;
            if ((size_t)level >= o.size())
                o.resize(level + 64, 0);
            while (o[level] >= c) {
                level++;
                if ((size_t)level >= o.size())
                    o.resize(level + 64, 0);
            }
            o[level]++;
        }
        lv_out[i] = level;
        for (int r = rr0; r <= rr1; r++) {
            int32_t &v = lr[(size_t)r * cwg + rc0];
            v = std::max(v, level);
        }
        for (int c = rc0; c <= rc1; c++) {
            int32_t &v = lr[(size_t)rr0 * cwg + c];
            v = std::max(v, level);
        }
        for (int r = r0; r <= r1; r++)
            for (int c = c0; c <= c1; c++) {
                int32_t &v = lr[(size_t)r * cwg + c];
                v = std::max(v, level);
                lw[(size_t)r * cwg + c] = level;
            }
        if (sy >= 0) {
            lw[(size_t)sy * cwg + c0] = level;
            int32_t &v = lr[(size_t)sy * cwg + c0];
            v = std::max(v, level);
        }
    }
    return 0;
}
