// Host routines of the port's host mapping path (map/pipeline.py
// map_frag_core and its callees), copied from minimap2_tpu/native/mmtpu.cpp:
// mm_sketch_nt4 :43, mm_collect_anchors :157, ksw_extd2_cpp :390,
// ksw_extz2_cpp :679, ksw_exts2_cpp :880, mg_lchain_dp_cpp :1333,
// mg_lchain_rmq_cpp :1480 and ksw_ll_cpp :1619, with the helpers they use;
// build_hash2_table :2084, the device index's h2 table
// (parallel/batch.py DeviceIndex.from_host); and the host index build's
// mm_sketch_many :296 and radix_sort_u64_pair :1814
// (index/index.py MiniIndex.build_codes).  The plain NumPy versions of the same routines (index/sketch.py,
// map/seed.py, map/chain.py, ops/ksw2_np.py, ops/ksw2_exts.py) hold them
// in the tests.  Built with g++ into build/minimap2_tpu_torch/ at first use
// and bound with ctypes by minimap2_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>
#include <set>
#include <limits>

extern "C" {

// ---------------------------------------------------------------------
// hash64 (sketch.c:28-38)
// ---------------------------------------------------------------------
static inline uint64_t hash64(uint64_t key, uint64_t mask)
{
    key = (~key + (key << 21)) & mask;
    key = key ^ key >> 24;
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ key >> 14;
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ key >> 28;
    key = (key + (key << 31)) & mask;
    return key;
}

// ---------------------------------------------------------------------
// (w,k)-minimizer sketch over nt4 codes; identical scan structure to the
// plain sketch (index/sketch.py), incl. HPC and tie emission.
// Returns number of minimizers written (<= cap).
// ---------------------------------------------------------------------
int64_t mm_sketch_nt4(const uint8_t *codes, int64_t len, int w, int k,
                      uint32_t rid, int is_hpc,
                      uint64_t *out_x, uint64_t *out_y, int64_t cap)
{
    const uint64_t MAXV = ~0ULL;
    uint64_t shift1 = 2 * (k - 1), mask = (1ULL << (2 * k)) - 1;
    uint64_t kmer[2] = {0, 0};
    std::vector<uint64_t> bx(w, MAXV), by(w, MAXV);
    int tq[256];
    int tq_front = 0, tq_count = 0;
    int kmer_span = 0;
    uint64_t mnx = MAXV, mny = MAXV;
    int64_t i = 0, n_out = 0, l = 0;
    int buf_pos = 0, min_pos = 0;

    auto emit = [&](uint64_t x, uint64_t y) {
        if (n_out < cap) { out_x[n_out] = x; out_y[n_out] = y; }
        ++n_out;
    };

    while (i < len) {
        int c = codes[i];
        uint64_t ix = MAXV, iy = MAXV;
        if (c < 4) {
            if (is_hpc) {
                int64_t skip_len = 1;
                if (i + 1 < len && codes[i + 1] == c) {
                    skip_len = 2;
                    while (i + skip_len < len && codes[i + skip_len] == c)
                        ++skip_len;
                    i += skip_len - 1;
                }
                tq[(tq_front + tq_count) & 255] = (int)skip_len;
                ++tq_count;
                kmer_span += (int)skip_len;
                if (tq_count > k) {
                    kmer_span -= tq[tq_front];
                    tq_front = (tq_front + 1) & 255;
                    --tq_count;
                }
            } else {
                kmer_span = l + 1 < k ? (int)(l + 1) : k;
            }
            kmer[0] = (kmer[0] << 2 | c) & mask;
            kmer[1] = (kmer[1] >> 2) | ((uint64_t)(3 ^ c) << shift1);
            if (kmer[0] == kmer[1]) { ++i; continue; }  // symmetric k-mer
            int z = kmer[0] < kmer[1] ? 0 : 1;
            ++l;
            if (l >= k && kmer_span < 256) {
                ix = hash64(kmer[z], mask) << 8 | (uint64_t)kmer_span;
                iy = ((uint64_t)rid << 32) | ((uint64_t)i << 1) | (uint64_t)z;
            }
        } else {
            l = 0;
            tq_front = tq_count = 0;
            kmer_span = 0;
        }
        bx[buf_pos] = ix; by[buf_pos] = iy;
        if (l == w + k - 1 && mnx != MAXV) {
            for (int j = buf_pos + 1; j < w; ++j)
                if (mnx == bx[j] && by[j] != mny) emit(bx[j], by[j]);
            for (int j = 0; j < buf_pos; ++j)
                if (mnx == bx[j] && by[j] != mny) emit(bx[j], by[j]);
        }
        if (ix <= mnx) {
            if (l >= w + k && mnx != MAXV) emit(mnx, mny);
            mnx = ix; mny = iy; min_pos = buf_pos;
        } else if (buf_pos == min_pos) {
            if (l >= w + k - 1 && mnx != MAXV) emit(mnx, mny);
            mnx = MAXV; mny = MAXV;
            for (int j = buf_pos + 1; j < w; ++j)
                if (mnx >= bx[j]) { mnx = bx[j]; mny = by[j]; min_pos = j; }
            for (int j = 0; j <= buf_pos; ++j)
                if (mnx >= bx[j]) { mnx = bx[j]; mny = by[j]; min_pos = j; }
            if (l >= w + k - 1 && mnx != MAXV) {
                for (int j = buf_pos + 1; j < w; ++j)
                    if (mnx == bx[j] && mny != by[j]) emit(bx[j], by[j]);
                for (int j = 0; j <= buf_pos; ++j)
                    if (mnx == bx[j] && mny != by[j]) emit(bx[j], by[j]);
            }
        }
        if (++buf_pos == w) buf_pos = 0;
        ++i;
    }
    if (mnx != MAXV) emit(mnx, mny);
    return n_out;
}

// ---------------------------------------------------------------------
// binary search over sorted u64 keys (index.c:93-110 analogue)
// ---------------------------------------------------------------------
static inline int64_t lower_bound_u64(const uint64_t *keys, int64_t n,
                                      uint64_t q)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (keys[mid] < q) lo = mid + 1; else hi = mid;
    }
    return lo;
}

struct SeedRec {
    uint32_t q_pos;
    int32_t q_span, seg_id;
    int64_t start, n;
    uint8_t is_tandem, flt;
};

// ---------------------------------------------------------------------
// mm_collect_matches + collect_seed_hits (seed.c:98-132, map.c:168-204),
// single-segment path (no ava skip_seed / qstrand; caller guards).
// Writes sorted (ax, ay) anchors; returns count (<= cap), rep_len via ptr.
// ---------------------------------------------------------------------
int64_t mm_collect_anchors(const uint64_t *mx, const uint64_t *my,
                           int64_t n_m, const uint64_t *keys,
                           const int64_t *starts, int64_t n_keys,
                           const uint64_t *pos, int64_t qlen,
                           int64_t max_occ, int64_t max_max_occ,
                           int64_t dist,
                           uint64_t *ax, uint64_t *ay, int64_t cap,
                           int64_t *rep_len_out,
                           uint64_t *mini_pos, int64_t *n_mini_out,
                           int64_t *sf_out, int64_t *n_sf_out)
{
    std::vector<SeedRec> seeds;
    seeds.reserve(n_m);
    // seed_collect_all (seed.c:30-52)
    for (int64_t i = 0; i < n_m; ++i) {
        uint64_t h = mx[i] >> 8;
        int64_t ki = lower_bound_u64(keys, n_keys, h);
        if (ki >= n_keys || keys[ki] != h) continue;
        SeedRec s;
        s.q_pos = (uint32_t)my[i];
        s.q_span = (int32_t)(mx[i] & 0xFF);
        s.seg_id = (int32_t)(my[i] >> 32);
        s.start = starts[ki];
        s.n = starts[ki + 1] - starts[ki];
        s.is_tandem = 0;
        s.flt = 0;
        if (i > 0 && (mx[i - 1] >> 8) == h) s.is_tandem = 1;
        if (i + 1 < n_m && (mx[i + 1] >> 8) == h) s.is_tandem = 1;
        seeds.push_back(s);
    }
    int64_t n = (int64_t)seeds.size();
    // seed_select (seed.c:56-96) or plain max_occ filter
    if (dist > 0 && max_max_occ > max_occ) {
        const int MAX_MAX_HIGH_OCC = 128;
        if (n > 1) {
            int64_t last0 = -1;
            for (int64_t i = 0; i <= n; ++i) {
                if (i == n || seeds[i].n <= max_occ) {
                    if (i - last0 > 1) {
                        int64_t ps = last0 < 0 ? 0
                            : (int64_t)(seeds[last0].q_pos >> 1);
                        int64_t pe = i == n ? qlen
                            : (int64_t)(seeds[i].q_pos >> 1);
                        int64_t st = last0 + 1, en = i;
                        int64_t mho = (int64_t)((double)(pe - ps) / dist
                                                + 0.499);
                        if (mho > 0) {
                            if (mho > MAX_MAX_HIGH_OCC)
                                mho = MAX_MAX_HIGH_OCC;
                            std::vector<uint64_t> keyv;
                            keyv.reserve(en - st);
                            for (int64_t j = st; j < en; ++j)
                                keyv.push_back(((uint64_t)seeds[j].n << 32)
                                               | (uint64_t)j);
                            std::stable_sort(keyv.begin(), keyv.end());
                            int64_t kk = mho < (int64_t)keyv.size()
                                ? mho : (int64_t)keyv.size();
                            for (int64_t j = st; j < en; ++j)
                                seeds[j].flt = 1;
                            for (int64_t j = 0; j < kk; ++j)
                                seeds[keyv[j] & 0xFFFFFFFF].flt = 0;
                        } else {
                            for (int64_t j = st; j < en; ++j)
                                seeds[j].flt = 1;
                        }
                        for (int64_t j = st; j < en; ++j)
                            if (seeds[j].n > max_max_occ)
                                seeds[j].flt = 1;
                    }
                    last0 = i;
                }
            }
        }
    } else {
        for (auto &s : seeds)
            if (s.n > max_occ) s.flt = 1;
    }
    // --dbg-seed-occ: each seed's (pos, occurrences, filtered) for the
    // caller's SF lines (seed.c:115-116), when sf_out is given (3n slots)
    if (sf_out) {
        for (int64_t i = 0; i < n; ++i) {
            sf_out[3 * i] = (int64_t)(seeds[i].q_pos >> 1);
            sf_out[3 * i + 1] = seeds[i].n;
            sf_out[3 * i + 2] = seeds[i].flt;
        }
        *n_sf_out = n;
    }
    // rep_len: merged interval union of filtered seeds, in seed order
    int64_t rep_len = 0, rep_st = 0, rep_en = 0;
    for (auto &s : seeds) {
        if (!s.flt) continue;
        int64_t en2 = (int64_t)(s.q_pos >> 1) + 1;
        int64_t st2 = en2 - s.q_span;
        if (st2 > rep_en) {
            rep_len += rep_en - rep_st;
            rep_st = st2; rep_en = en2;
        } else {
            rep_en = en2;
        }
    }
    rep_len += rep_en - rep_st;
    *rep_len_out = rep_len;
    // mini_pos of kept seeds (span<<32 | pos), for mm_est_err
    int64_t n_mini = 0;
    for (auto &s : seeds)
        if (!s.flt && n_mini < cap)
            mini_pos[n_mini++] = ((uint64_t)s.q_span << 32)
                | (uint64_t)(s.q_pos >> 1);
    *n_mini_out = n_mini;
    // anchor expansion (map.c:168-204), forward/reverse coordinates
    int64_t n_a = 0;
    for (auto &s : seeds) {
        if (s.flt) continue;
        for (int64_t j = 0; j < s.n; ++j) {
            if (n_a >= cap) return n_a;  // capacity clip (caller re-tries)
            uint64_t r = pos[s.start + j];
            uint64_t rpos = (uint32_t)r >> 1;
            int same = (int)((r & 1) == (s.q_pos & 1));
            uint64_t hi = r & 0xFFFFFFFF00000000ULL;
            uint64_t qp = s.q_pos >> 1;
            uint64_t x, y;
            if (same) {
                x = hi | rpos;
                y = ((uint64_t)s.q_span << 32) | qp;
            } else {
                x = (1ULL << 63) | hi | rpos;
                y = ((uint64_t)s.q_span << 32)
                    | ((uint64_t)qlen - (qp + 1 - (uint64_t)s.q_span) - 1);
            }
            y |= (uint64_t)s.seg_id << 48;
            if (s.is_tandem) y |= 1ULL << 42;  // MM_SEED_TANDEM (mmpriv.h:21)
            ax[n_a] = x; ay[n_a] = y;
            ++n_a;
        }
    }
    // stable sort by x (radix_sort_128x semantics)
    std::vector<int64_t> ord(n_a);
    for (int64_t i = 0; i < n_a; ++i) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(),
                     [&](int64_t a, int64_t b) { return ax[a] < ax[b]; });
    std::vector<uint64_t> tx(n_a), ty(n_a);
    for (int64_t i = 0; i < n_a; ++i) { tx[i] = ax[ord[i]]; ty[i] = ay[ord[i]]; }
    std::memcpy(ax, tx.data(), n_a * 8);
    std::memcpy(ay, ty.data(), n_a * 8);
    return n_a;
}

}  // extern "C"

// =====================================================================
// ksw2 extension kernels: scalar C++ ports of this framework's verified
// NumPy oracles (ops/ksw2_np.py), themselves bit-exact with the
// reference SIMD kernels (ksw2_extz2_sse.c / ksw2_extd2_sse.c).
// The host mapping path's only route for these DPs: the NumPy versions
// serve the tests alone.
// =====================================================================

extern "C" {

static const int KSW_NEG_INF = -0x40000000;
enum { EZF_SCORE_ONLY = 1, EZF_RIGHT = 2, EZF_GENERIC_SC = 4,
       EZF_APPROX_MAX = 8, EZF_APPROX_DROP = 0x10, EZF_EXTZ_ONLY = 0x40,
       EZF_REV_CIGAR = 0x80 };

struct EzOut {
    int32_t max, zdropped, max_q, max_t, mqe, mqe_t, mte, mte_q, score,
        reach_end, n_cigar, pad;
};

static inline int8_t wrap8(int v) { return (int8_t)(((v + 128) & 255) - 128); }

static void push_cigar(std::vector<uint32_t> &c, int op, int len)
{
    if (c.empty() || (int)(c.back() & 0xF) != op)
        c.push_back((uint32_t)len << 4 | op);
    else
        c.back() += (uint32_t)len << 4;
}

static int apply_zdrop(EzOut *ez, int64_t H, int r, int t, int zdrop, int e)
{
    if (H > ez->max) {
        ez->max = (int32_t)H; ez->max_t = t; ez->max_q = r - t;
    } else if (t >= ez->max_t && r - t >= ez->max_q) {
        int tl = t - ez->max_t, ql = (r - t) - ez->max_q;
        int l = tl > ql ? tl - ql : ql - tl;
        if (zdrop >= 0 && ez->max - H > zdrop + (int64_t)l * e) {
            ez->zdropped = 1;
            return 1;
        }
    }
    return 0;
}

// backtrack over rotated rows (ksw2.h:130-162, is_rot=1, forward cigar)
static void bt_rot(const uint8_t *p, const int64_t *p_off,
                   const int64_t *off, const int64_t *off_end,
                   int i0, int j0, int min_intron,
                   std::vector<uint32_t> &cigar)
{
    int i = i0, j = j0, state = 0;
    while (i >= 0 && j >= 0) {
        int r = i + j, force_state = -1;
        if (i < off[r]) force_state = 2;
        if (off_end && i > off_end[r]) force_state = 1;
        int tmp = force_state < 0 ? p[p_off[r] + (i - off[r])] : 0;
        if (state == 0) state = tmp & 7;
        else if (!(tmp >> (state + 2) & 1)) state = 0;
        if (state == 0) state = tmp & 7;
        if (force_state >= 0) state = force_state;
        if (state == 0) { push_cigar(cigar, 0, 1); --i; --j; }
        else if (state == 1 || (state == 3 && min_intron <= 0)) {
            push_cigar(cigar, 2, 1); --i;
        } else if (state == 3 && min_intron > 0) {
            push_cigar(cigar, 3, 1); --i;
        } else { push_cigar(cigar, 1, 1); --j; }
    }
    if (i >= 0)
        push_cigar(cigar, (min_intron > 0 && i >= min_intron) ? 3 : 2, i + 1);
    if (j >= 0) push_cigar(cigar, 1, j + 1);
    std::vector<uint32_t> rv(cigar.rbegin(), cigar.rend());
    cigar.swap(rv);
}

// ksw_extd2 (dual affine), scalar port of ops/ksw2_np.ksw_extd2
int64_t ksw_extd2_cpp(int qlen, const uint8_t *query, int tlen,
                      const uint8_t *target, int m, const int8_t *mat,
                      int q, int e, int q2, int e2, int w, int zdrop,
                      int end_bonus, int flag, EzOut *ez,
                      uint32_t *cigar_out, int64_t cigar_cap)
{
    ez->max = 0; ez->zdropped = 0; ez->max_q = ez->max_t = -1;
    ez->mqe = ez->mte = KSW_NEG_INF; ez->mqe_t = ez->mte_q = -1;
    ez->score = KSW_NEG_INF; ez->reach_end = 0; ez->n_cigar = 0;
    if (m <= 1 || qlen <= 0 || tlen <= 0) return 0;
    int with_cigar = !(flag & EZF_SCORE_ONLY);
    int approx_max = !!(flag & EZF_APPROX_MAX);
    int right_mode = !!(flag & EZF_RIGHT);
    int generic = !!(flag & EZF_GENERIC_SC);
    if (q2 + e2 < q + e) { int t = q; q = q2; q2 = t; t = e; e = e2; e2 = t; }
    int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)-e2 : mat[m * m - 1];
    if (w < 0) w = tlen > qlen ? tlen : qlen;
    int64_t tlen_ = (tlen + 15) / 16;
    int64_t n_col_ = qlen < tlen ? qlen : tlen;
    n_col_ = ((n_col_ < w + 1 ? n_col_ : w + 1) + 15) / 16 + 1;
    int max_sc = mat[0], min_sc = mat[1];
    for (int i = 0; i < m * m; ++i) {
        if (mat[i] > max_sc) max_sc = mat[i];
        if (i >= 1 && mat[i] < min_sc) min_sc = mat[i];
    }
    if (-min_sc > 2 * (q + e)) return 0;
    int long_thres = e != e2 ? (q2 - q) / (e - e2) - 1 : 0;
    if (q2 + e2 + long_thres * e2 > q + e + long_thres * e) ++long_thres;
    int long_diff = long_thres * (e - e2) - (q2 - q) - e2;

    int64_t L = tlen_ * 16 + 16;
    std::vector<int8_t> u(L, wrap8(-q - e)), v(L, wrap8(-q - e));
    std::vector<int8_t> x(L, wrap8(-q - e)), y(L, wrap8(-q - e));
    std::vector<int8_t> x2(L, wrap8(-q2 - e2)), y2(L, wrap8(-q2 - e2));
    std::vector<int8_t> s(L, 0);
    std::vector<uint8_t> sf(L, 0);
    std::memcpy(sf.data(), target, tlen);
    int64_t qpad = (qlen + 15) / 16 * 16 + 32;
    std::vector<uint8_t> qr(qpad, 0);
    for (int i = 0; i < qlen; ++i) qr[i] = query[qlen - 1 - i];
    std::vector<int32_t> H;   // int32 like the reference's H row
    if (!approx_max) H.assign(tlen_ * 16 + 16, KSW_NEG_INF);
    int64_t R = (int64_t)qlen + tlen - 1;
    std::vector<int64_t> off(R, 0), off_end(R, 0), p_off(R, 0);
    std::vector<uint8_t> p;
    if (with_cigar) p.reserve((size_t)(R * (n_col_ * 16 + 16) < (int64_t)5e8
                                       ? R * (n_col_ * 16 + 16) : 1));
    int qe_pen = q + e, qe2_pen = q2 + e2;
    int8_t sc_mch = mat[0];
    int64_t H0 = 0; int last_H0_t = 0;
    int64_t last_st = -1, last_en = -1;

    for (int64_t r = 0; r < R; ++r) {
        int64_t st = 0, en = tlen - 1;
        if (st < r - qlen + 1) st = r - qlen + 1;
        if (en > r) en = r;
        if (st < (r - w + 1) >> 1) st = (r - w + 1) >> 1;
        if (en > (r + w) >> 1) en = (r + w) >> 1;
        if (st > en) { ez->zdropped = 1; break; }
        int64_t st0 = st, en0 = en;
        st = st / 16 * 16;
        en = (en + 16) / 16 * 16 - 1;
        int x1, x21, v1;
        if (st > 0) {
            if (last_st <= st - 1 && st - 1 <= last_en) {
                x1 = x[st - 1]; x21 = x2[st - 1]; v1 = v[st - 1];
            } else { x1 = -q - e; x21 = -q2 - e2; v1 = -q - e; }
        } else {
            x1 = -q - e; x21 = -q2 - e2;
            v1 = r == 0 ? -q - e : r < long_thres ? -e
                : r == long_thres ? long_diff : -e2;
        }
        if (en >= r) {
            y[r] = wrap8(-q - e); y2[r] = wrap8(-q2 - e2);
            u[r] = wrap8(r == 0 ? -q - e : r < long_thres ? -e
                         : r == long_thres ? long_diff : -e2);
        }
        int64_t base = qlen - 1 - r;
        if (!generic) {
            // flat branch-free profile build (vpcmpeqb + blends); covers the
            // same cells as the reference's 16-blocked build from st0
            int64_t ns = (en0 - st0) / 16 * 16 + 16;
            const uint8_t *__restrict tgp = sf.data() + st0;
            const uint8_t *__restrict qqp = qr.data() + (base + st0);
            int8_t *__restrict sw = s.data() + st0;
            uint8_t mN = (uint8_t)(m - 1);
            int8_t m0 = mat[0], m1 = mat[1];
            for (int64_t k2 = 0; k2 < ns; ++k2) {
                uint8_t aq = tgp[k2], bq = qqp[k2];
                sw[k2] = (aq == mN || bq == mN) ? sc_N : (aq == bq ? m0 : m1);
            }
        } else {
            for (int64_t k2 = st0; k2 <= en0; ++k2)
                s[k2] = mat[(int)sf[k2] * m + qr[base + k2]];
        }
        uint8_t *__restrict prow = 0;
        if (with_cigar) {
            p_off[r] = (int64_t)p.size();
            p.resize(p.size() + (en - st + 1));
            prow = p.data() + p_off[r];
        }
        // shifted old-state temps kill the loop-carried dependency so the
        // compiler can vectorize the int8 lanes (the SSE kernel's layout)
        int64_t W2 = en - st + 1;
        int8_t xs_[4096 + 18], vs_[4096 + 18], x2s_[4096 + 18];
        std::vector<int8_t> xs_h, vs_h, x2s_h;
        int8_t *__restrict xt, *__restrict vt, *__restrict x2t;
        if (W2 + 1 <= 4096 + 18) { xt = xs_; vt = vs_; x2t = x2s_; }
        else {
            xs_h.resize(W2 + 1); vs_h.resize(W2 + 1); x2s_h.resize(W2 + 1);
            xt = xs_h.data(); vt = vs_h.data(); x2t = x2s_h.data();
        }
        xt[0] = (int8_t)x1; vt[0] = (int8_t)v1; x2t[0] = (int8_t)x21;
        std::memcpy(xt + 1, &x[st], W2 - 1);
        std::memcpy(vt + 1, &v[st], W2 - 1);
        std::memcpy(x2t + 1, &x2[st], W2 - 1);
        typedef uint8_t u8;
        int8_t *__restrict up = u.data() + st, *__restrict vp_ = v.data() + st;
        int8_t *__restrict xp_ = x.data() + st, *__restrict yp = y.data() + st;
        int8_t *__restrict x2p_ = x2.data() + st;
        int8_t *__restrict y2p = y2.data() + st;
        const int8_t *__restrict sp = s.data() + st;
        if (with_cigar && !right_mode) {
            for (int64_t k3 = 0; k3 < W2; ++k3) {
                int8_t z = sp[k3];
                int8_t vt1 = vt[k3], ut = up[k3];
                int8_t a = (int8_t)(u8)((u8)xt[k3] + (u8)vt1);
                int8_t b = (int8_t)(u8)((u8)yp[k3] + (u8)ut);
                int8_t a2 = (int8_t)(u8)((u8)x2t[k3] + (u8)vt1);
                int8_t b2 = (int8_t)(u8)((u8)y2p[k3] + (u8)ut);
                uint8_t d = a > z ? 1 : 0;
                z = a > z ? a : z;
                d = b > z ? 2 : d; z = b > z ? b : z;
                d = a2 > z ? 3 : d; z = a2 > z ? a2 : z;
                d = b2 > z ? 4 : d; z = b2 > z ? b2 : z;
                z = z < sc_mch ? z : sc_mch;
                up[k3] = (int8_t)(u8)((u8)z - (u8)vt1);
                vp_[k3] = (int8_t)(u8)((u8)z - (u8)ut);
                int8_t t1 = (int8_t)(u8)((u8)z - (u8)q);
                a = (int8_t)(u8)((u8)a - (u8)t1);
                b = (int8_t)(u8)((u8)b - (u8)t1);
                int8_t t2 = (int8_t)(u8)((u8)z - (u8)q2);
                a2 = (int8_t)(u8)((u8)a2 - (u8)t2);
                b2 = (int8_t)(u8)((u8)b2 - (u8)t2);
                bool ga = a > 0, gb = b > 0, ga2 = a2 > 0, gb2 = b2 > 0;
                xp_[k3] = (int8_t)(u8)((u8)(ga ? a : 0) - (u8)qe_pen);
                yp[k3] = (int8_t)(u8)((u8)(gb ? b : 0) - (u8)qe_pen);
                x2p_[k3] = (int8_t)(u8)((u8)(ga2 ? a2 : 0) - (u8)qe2_pen);
                y2p[k3] = (int8_t)(u8)((u8)(gb2 ? b2 : 0) - (u8)qe2_pen);
                d |= ga ? 0x08 : 0; d |= gb ? 0x10 : 0;
                d |= ga2 ? 0x20 : 0; d |= gb2 ? 0x40 : 0;
                prow[k3] = d;
            }
        } else if (with_cigar) {   // right_mode
            for (int64_t k3 = 0; k3 < W2; ++k3) {
                int8_t z = sp[k3];
                int8_t vt1 = vt[k3], ut = up[k3];
                int8_t a = (int8_t)(u8)((u8)xt[k3] + (u8)vt1);
                int8_t b = (int8_t)(u8)((u8)yp[k3] + (u8)ut);
                int8_t a2 = (int8_t)(u8)((u8)x2t[k3] + (u8)vt1);
                int8_t b2 = (int8_t)(u8)((u8)y2p[k3] + (u8)ut);
                uint8_t d = z > a ? 0 : 1; z = a > z ? a : z;
                d = z > b ? d : 2; z = b > z ? b : z;
                d = z > a2 ? d : 3; z = a2 > z ? a2 : z;
                d = z > b2 ? d : 4; z = b2 > z ? b2 : z;
                z = z < sc_mch ? z : sc_mch;
                up[k3] = (int8_t)(u8)((u8)z - (u8)vt1);
                vp_[k3] = (int8_t)(u8)((u8)z - (u8)ut);
                int8_t t1 = (int8_t)(u8)((u8)z - (u8)q);
                a = (int8_t)(u8)((u8)a - (u8)t1);
                b = (int8_t)(u8)((u8)b - (u8)t1);
                int8_t t2 = (int8_t)(u8)((u8)z - (u8)q2);
                a2 = (int8_t)(u8)((u8)a2 - (u8)t2);
                b2 = (int8_t)(u8)((u8)b2 - (u8)t2);
                bool ga = a >= 0, gb = b >= 0, ga2 = a2 >= 0, gb2 = b2 >= 0;
                xp_[k3] = (int8_t)(u8)((u8)(ga ? a : 0) - (u8)qe_pen);
                yp[k3] = (int8_t)(u8)((u8)(gb ? b : 0) - (u8)qe_pen);
                x2p_[k3] = (int8_t)(u8)((u8)(ga2 ? a2 : 0) - (u8)qe2_pen);
                y2p[k3] = (int8_t)(u8)((u8)(gb2 ? b2 : 0) - (u8)qe2_pen);
                d |= ga ? 0x08 : 0; d |= gb ? 0x10 : 0;
                d |= ga2 ? 0x20 : 0; d |= gb2 ? 0x40 : 0;
                prow[k3] = d;
            }
        } else {                    // score-only
            int8_t zth = right_mode ? -1 : 0;   // a > zth == (a>0 | a>=0)
            for (int64_t k3 = 0; k3 < W2; ++k3) {
                int8_t z = sp[k3];
                int8_t vt1 = vt[k3], ut = up[k3];
                int8_t a = (int8_t)(u8)((u8)xt[k3] + (u8)vt1);
                int8_t b = (int8_t)(u8)((u8)yp[k3] + (u8)ut);
                int8_t a2 = (int8_t)(u8)((u8)x2t[k3] + (u8)vt1);
                int8_t b2 = (int8_t)(u8)((u8)y2p[k3] + (u8)ut);
                z = a > z ? a : z; z = b > z ? b : z;
                z = a2 > z ? a2 : z; z = b2 > z ? b2 : z;
                z = z < sc_mch ? z : sc_mch;
                up[k3] = (int8_t)(u8)((u8)z - (u8)vt1);
                vp_[k3] = (int8_t)(u8)((u8)z - (u8)ut);
                int8_t t1 = (int8_t)(u8)((u8)z - (u8)q);
                a = (int8_t)(u8)((u8)a - (u8)t1);
                b = (int8_t)(u8)((u8)b - (u8)t1);
                int8_t t2 = (int8_t)(u8)((u8)z - (u8)q2);
                a2 = (int8_t)(u8)((u8)a2 - (u8)t2);
                b2 = (int8_t)(u8)((u8)b2 - (u8)t2);
                xp_[k3] = (int8_t)(u8)((u8)(a > zth ? a : 0) - (u8)qe_pen);
                yp[k3] = (int8_t)(u8)((u8)(b > zth ? b : 0) - (u8)qe_pen);
                x2p_[k3] = (int8_t)(u8)((u8)(a2 > zth ? a2 : 0) - (u8)qe2_pen);
                y2p[k3] = (int8_t)(u8)((u8)(b2 > zth ? b2 : 0) - (u8)qe2_pen);
            }
        }
        if (with_cigar) { off[r] = st; off_end[r] = en; }
        if (!approx_max) {
            int64_t max_H, max_t;
            if (r > 0) {
                if (en0 > 0) H[en0] = H[en0 - 1] + u[en0];
                else H[en0] = H[en0] + v[en0];
                {
                    int32_t *__restrict Hp = H.data() + st0;
                    const int8_t *__restrict vv = v.data() + st0;
                    int64_t nh = en0 - st0;
                    for (int64_t t = 0; t < nh; ++t) Hp[t] += vv[t];
                    int32_t mh = H[en0]; max_t = en0;
                    for (int64_t t = 0; t < nh; ++t)
                        if (Hp[t] > mh) mh = Hp[t];
                    max_H = mh;
                    if (max_H > H[en0])
                        for (int64_t t = 0; t < nh; ++t)
                            if (Hp[t] == max_H) { max_t = st0 + t; break; }
                }
            } else {
                H[0] = v[0] - qe_pen;
                max_H = H[0]; max_t = 0;
            }
            if (en0 == tlen - 1 && H[en0] > ez->mte) {
                ez->mte = (int32_t)H[en0]; ez->mte_q = (int32_t)(r - en0);
            }
            if (r - st0 == qlen - 1 && H[st0] > ez->mqe) {
                ez->mqe = (int32_t)H[st0]; ez->mqe_t = (int32_t)st0;
            }
            if (apply_zdrop(ez, max_H, (int)r, (int)max_t, zdrop, e2)) break;
            if (r == R - 1 && en0 == tlen - 1) ez->score = (int32_t)H[tlen - 1];
        } else {
            if (r > 0) {
                if (st0 <= last_H0_t && last_H0_t <= en0
                        && st0 <= last_H0_t + 1 && last_H0_t + 1 <= en0) {
                    int d0 = v[last_H0_t], d1 = u[last_H0_t + 1];
                    if (d0 > d1) H0 += d0;
                    else { H0 += d1; ++last_H0_t; }
                } else if (st0 <= last_H0_t && last_H0_t <= en0) {
                    H0 += v[last_H0_t];
                } else {
                    ++last_H0_t; H0 += u[last_H0_t];
                }
                if ((flag & EZF_APPROX_DROP)
                        && apply_zdrop(ez, H0, (int)r, last_H0_t, zdrop, e2))
                    break;
            } else { H0 = v[0] - qe_pen; last_H0_t = 0; }
            if (r == R - 1 && en0 == tlen - 1) ez->score = (int32_t)H0;
        }
        last_st = st; last_en = en;
    }
    if (with_cigar) {
        std::vector<uint32_t> cig;
        if (!ez->zdropped && !(flag & EZF_EXTZ_ONLY))
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   tlen - 1, qlen - 1, 0, cig);
        else if (!ez->zdropped && (flag & EZF_EXTZ_ONLY)
                 && ez->mqe + end_bonus > ez->max) {
            ez->reach_end = 1;
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   ez->mqe_t, qlen - 1, 0, cig);
        } else if (ez->max_t >= 0 && ez->max_q >= 0)
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   ez->max_t, ez->max_q, 0, cig);
        if (flag & EZF_REV_CIGAR)
            std::reverse(cig.begin(), cig.end());
        ez->n_cigar = (int32_t)cig.size();
        int64_t n = (int64_t)cig.size() < cigar_cap ? (int64_t)cig.size()
            : cigar_cap;
        std::memcpy(cigar_out, cig.data(), n * 4);
    }
    return 0;
}

}  // extern "C"

extern "C" {

// ksw_extz2 (single affine), scalar port of ops/ksw2_np.ksw_extz2;
// DP state kept as offset uint8 exactly like the SSE kernel.
int64_t ksw_extz2_cpp(int qlen, const uint8_t *query, int tlen,
                      const uint8_t *target, int m, const int8_t *mat,
                      int q, int e, int w, int zdrop, int end_bonus,
                      int flag, EzOut *ez, uint32_t *cigar_out,
                      int64_t cigar_cap)
{
    ez->max = 0; ez->zdropped = 0; ez->max_q = ez->max_t = -1;
    ez->mqe = ez->mte = KSW_NEG_INF; ez->mqe_t = ez->mte_q = -1;
    ez->score = KSW_NEG_INF; ez->reach_end = 0; ez->n_cigar = 0;
    if (m <= 0 || qlen <= 0 || tlen <= 0) return 0;
    int with_cigar = !(flag & EZF_SCORE_ONLY);
    int approx_max = !!(flag & EZF_APPROX_MAX);
    int right_mode = !!(flag & EZF_RIGHT);
    int generic = !!(flag & EZF_GENERIC_SC);
    int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)-e : mat[m * m - 1];
    int qe2 = (q + e) * 2;
    uint8_t max_sc_clip = (uint8_t)(mat[0] + (q + e) * 2);
    if (w < 0) w = tlen > qlen ? tlen : qlen;
    int64_t tlen_ = (tlen + 15) / 16;
    int min_sc = mat[0];
    for (int i = 0; i < m * m; ++i) if (mat[i] < min_sc) min_sc = mat[i];
    if (-min_sc > 2 * (q + e)) return 0;
    int64_t L = tlen_ * 16 + 16;
    std::vector<uint8_t> u(L, 0), v(L, 0), x(L, 0), y(L, 0);
    std::vector<int8_t> s(L, 0);
    std::vector<uint8_t> sf(L, 0);
    std::memcpy(sf.data(), target, tlen);
    int64_t qpad = (qlen + 15) / 16 * 16 + 32;
    std::vector<uint8_t> qr(qpad, 0);
    for (int i = 0; i < qlen; ++i) qr[i] = query[qlen - 1 - i];
    std::vector<int32_t> H;
    if (!approx_max) H.assign(tlen_ * 16 + 16, KSW_NEG_INF);
    int64_t R = (int64_t)qlen + tlen - 1;
    std::vector<int64_t> off(R, 0), off_end(R, 0), p_off(R, 0);
    std::vector<uint8_t> p;
    int qe_pen = q + e;
    int64_t H0 = 0; int last_H0_t = 0;
    int64_t last_st = -1, last_en = -1;

    for (int64_t r = 0; r < R; ++r) {
        int64_t st = 0, en = tlen - 1;
        if (st < r - qlen + 1) st = r - qlen + 1;
        if (en > r) en = r;
        if (st < (r - w + 1) >> 1) st = (r - w + 1) >> 1;
        if (en > (r + w) >> 1) en = (r + w) >> 1;
        if (st > en) { ez->zdropped = 1; break; }
        int64_t st0 = st, en0 = en;
        st = st / 16 * 16;
        en = (en + 16) / 16 * 16 - 1;
        uint8_t x1, v1;
        if (st > 0) {
            if (last_st <= st - 1 && st - 1 <= last_en) {
                x1 = x[st - 1]; v1 = v[st - 1];
            } else { x1 = 0; v1 = 0; }
        } else { x1 = 0; v1 = (uint8_t)(r ? q : 0); }
        if (en >= r) { y[r] = 0; u[r] = (uint8_t)(r ? q : 0); }
        int64_t base = qlen - 1 - r;
        if (!generic) {
            // flat branch-free profile build (vpcmpeqb + blends); covers the
            // same cells as the reference's 16-blocked build from st0
            int64_t ns = (en0 - st0) / 16 * 16 + 16;
            const uint8_t *__restrict tgp = sf.data() + st0;
            const uint8_t *__restrict qqp = qr.data() + (base + st0);
            int8_t *__restrict sw = s.data() + st0;
            uint8_t mN = (uint8_t)(m - 1);
            int8_t m0 = mat[0], m1 = mat[1];
            for (int64_t k2 = 0; k2 < ns; ++k2) {
                uint8_t aq = tgp[k2], bq = qqp[k2];
                sw[k2] = (aq == mN || bq == mN) ? sc_N : (aq == bq ? m0 : m1);
            }
        } else {
            for (int64_t k2 = st0; k2 <= en0; ++k2)
                s[k2] = mat[(int)sf[k2] * m + qr[base + k2]];
        }
        uint8_t *prow = 0;
        if (with_cigar) {
            p_off[r] = (int64_t)p.size();
            p.resize(p.size() + (en - st + 1));
            prow = p.data() + p_off[r];
        }
        uint8_t xp = x1, vp = v1;
        for (int64_t k2 = st; k2 <= en; ++k2) {
            int8_t z = wrap8((int)s[k2] + qe2);
            uint8_t xt1 = xp, vt1 = vp;
            xp = x[k2]; vp = v[k2];
            uint8_t ut = u[k2];
            int8_t a = wrap8((int8_t)xt1 + (int8_t)vt1);
            int8_t b = wrap8((int8_t)y[k2] + (int8_t)ut);
            uint8_t d = 0;
            if (with_cigar) {
                if (!right_mode) {
                    d = a > z ? 1 : 0; if (a > z) z = a;
                    if (b > z) d = 2;
                } else {
                    d = z > a ? 0 : 1; if (a > z) z = a;
                    if (!(z > b)) d = 2;
                }
            } else { if (a > z) z = a; }
            uint8_t zu = (uint8_t)z > (uint8_t)b ? (uint8_t)z : (uint8_t)b;
            if (zu > max_sc_clip) zu = max_sc_clip;
            u[k2] = (uint8_t)wrap8((int8_t)zu - (int8_t)vt1);
            v[k2] = (uint8_t)wrap8((int8_t)zu - (int8_t)ut);
            int8_t zq = wrap8((int8_t)zu - q);
            a = wrap8(a - zq);
            b = wrap8((int8_t)b - zq);
            bool ga, gb;
            if (!right_mode) { ga = a > 0; gb = b > 0; }
            else { ga = a >= 0; gb = b >= 0; }
            x[k2] = (uint8_t)(ga ? a : 0);
            y[k2] = (uint8_t)(gb ? b : 0);
            if (with_cigar) {
                if (ga) d |= 0x08; if (gb) d |= 0x10;
                prow[k2 - st] = d;
            }
        }
        if (with_cigar) { off[r] = st; off_end[r] = en; }
        if (!approx_max) {
            int64_t max_H, max_t;
            if (r > 0) {
                if (en0 > 0) H[en0] = H[en0 - 1] + u[en0] - qe_pen;
                else H[en0] = H[en0] + v[en0] - qe_pen;
                {
                    int32_t *__restrict Hp = H.data() + st0;
                    const uint8_t *__restrict vv = v.data() + st0;
                    int64_t nh = en0 - st0;
                    for (int64_t t = 0; t < nh; ++t)
                        Hp[t] += (int32_t)vv[t] - qe_pen;
                    int32_t mh = H[en0]; max_t = en0;
                    for (int64_t t = 0; t < nh; ++t)
                        if (Hp[t] > mh) mh = Hp[t];
                    max_H = mh;
                    if (max_H > H[en0])
                        for (int64_t t = 0; t < nh; ++t)
                            if (Hp[t] == max_H) { max_t = st0 + t; break; }
                }
            } else {
                H[0] = (int32_t)v[0] - qe_pen - qe_pen;
                max_H = H[0]; max_t = 0;
            }
            if (en0 == tlen - 1 && H[en0] > ez->mte) {
                ez->mte = (int32_t)H[en0]; ez->mte_q = (int32_t)(r - en0);
            }
            if (r - st0 == qlen - 1 && H[st0] > ez->mqe) {
                ez->mqe = (int32_t)H[st0]; ez->mqe_t = (int32_t)st0;
            }
            if (apply_zdrop(ez, max_H, (int)r, (int)max_t, zdrop, e)) break;
            if (r == R - 1 && en0 == tlen - 1) ez->score = (int32_t)H[tlen - 1];
        } else {
            if (r > 0) {
                if (st0 <= last_H0_t && last_H0_t <= en0
                        && st0 <= last_H0_t + 1 && last_H0_t + 1 <= en0) {
                    int d0 = (int)v[last_H0_t] - qe_pen;
                    int d1 = (int)u[last_H0_t + 1] - qe_pen;
                    if (d0 > d1) H0 += d0;
                    else { H0 += d1; ++last_H0_t; }
                } else if (st0 <= last_H0_t && last_H0_t <= en0) {
                    H0 += (int)v[last_H0_t] - qe_pen;
                } else {
                    ++last_H0_t; H0 += (int)u[last_H0_t] - qe_pen;
                }
                if ((flag & EZF_APPROX_DROP)
                        && apply_zdrop(ez, H0, (int)r, last_H0_t, zdrop, e))
                    break;
            } else { H0 = (int64_t)v[0] - qe_pen - qe_pen; last_H0_t = 0; }
            if (r == R - 1 && en0 == tlen - 1) ez->score = (int32_t)H0;
        }
        last_st = st; last_en = en;
    }
    if (with_cigar) {
        std::vector<uint32_t> cig;
        if (!ez->zdropped && !(flag & EZF_EXTZ_ONLY))
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   tlen - 1, qlen - 1, 0, cig);
        else if (!ez->zdropped && (flag & EZF_EXTZ_ONLY)
                 && ez->mqe + end_bonus > ez->max) {
            ez->reach_end = 1;
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   ez->mqe_t, qlen - 1, 0, cig);
        } else if (ez->max_t >= 0 && ez->max_q >= 0)
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   ez->max_t, ez->max_q, 0, cig);
        if (flag & EZF_REV_CIGAR)
            std::reverse(cig.begin(), cig.end());
        ez->n_cigar = (int32_t)cig.size();
        int64_t n = (int64_t)cig.size() < cigar_cap ? (int64_t)cig.size()
            : cigar_cap;
        std::memcpy(cigar_out, cig.data(), n * 4);
    }
    return 0;
}

}  // extern "C"

extern "C" {

enum { EZF_SPLICE_FOR = 0x100, EZF_SPLICE_REV = 0x200,
       EZF_SPLICE_FLANK = 0x400, EZF_SPLICE_CMPLX = 0x800,
       EZF_SPLICE_SCORE = 0x1000 };
static const int KSW_SPSC_OFFSET2 = 64;

// ksw_exts2 (splice-aware), scalar port of ops/ksw2_exts.ksw_exts2
int64_t ksw_exts2_cpp(int qlen, const uint8_t *query, int tlen,
                      const uint8_t *target, int m, const int8_t *mat,
                      int q, int e, int q2, int noncan, int zdrop,
                      int end_bonus, int junc_bonus, int junc_pen,
                      int flag, const uint8_t *junc, EzOut *ez,
                      uint32_t *cigar_out, int64_t cigar_cap)
{
    ez->max = 0; ez->zdropped = 0; ez->max_q = ez->max_t = -1;
    ez->mqe = ez->mte = KSW_NEG_INF; ez->mqe_t = ez->mte_q = -1;
    ez->score = KSW_NEG_INF; ez->reach_end = 0; ez->n_cigar = 0;
    if (m <= 1 || qlen <= 0 || tlen <= 0 || q2 <= q + e) return 0;
    int with_cigar = !(flag & EZF_SCORE_ONLY);
    int approx_max = !!(flag & EZF_APPROX_MAX);
    int right_mode = !!(flag & EZF_RIGHT);
    int generic = !!(flag & EZF_GENERIC_SC);
    int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)-e : mat[m * m - 1];
    int min_sc = mat[0];
    for (int i = 0; i < m * m; ++i) if (mat[i] < min_sc) min_sc = mat[i];
    if (-min_sc > 2 * (q + e)) return 0;
    int long_thres = (q2 - q) / e - 1;
    if (q2 > q + e + long_thres * e) ++long_thres;
    int long_diff = long_thres * e - (q2 - q);
    int64_t tlen_ = (tlen + 15) / 16;
    int64_t L = tlen_ * 16 + 16;
    std::vector<int8_t> u(L, wrap8(-q - e)), v(L, wrap8(-q - e));
    std::vector<int8_t> x(L, wrap8(-q - e)), y(L, wrap8(-q - e));
    std::vector<int8_t> x2(L, wrap8(-q2)), s(L, 0);
    std::vector<uint8_t> sf(L, 0);
    std::memcpy(sf.data(), target, tlen);
    int64_t qpad = (qlen + 15) / 16 * 16 + 32;
    std::vector<uint8_t> qr(qpad, 0);
    for (int i = 0; i < qlen; ++i) qr[i] = query[qlen - 1 - i];

    // donor/acceptor arrays (ksw2_exts2_sse.c:120-192)
    std::vector<int64_t> donor64(L, 0), acceptor64(L, 0);
    if (flag & (EZF_SPLICE_FOR | EZF_SPLICE_REV)) {
        int sp0[4] = {8, 15, 21, 30};
        int sp[4];
        if (flag & EZF_SPLICE_CMPLX)
            for (int i = 0; i < 4; ++i)
                sp[i] = (int)(sp0[i] / 3.0 + 0.499);
        else {
            sp[0] = (flag & EZF_SPLICE_FLANK) ? noncan / 2 : 0;
            sp[1] = sp[2] = sp[3] = noncan;
        }
        for (int64_t i = 0; i < L; ++i) donor64[i] = acceptor64[i] = -sp[3];
        const uint8_t *tg = target;
        if (!(flag & EZF_REV_CIGAR)) {
            for (int t = 0; t < tlen - 4; ++t) {
                int z = 3;
                if (flag & EZF_SPLICE_FOR) {
                    if (tg[t+1] == 2 && tg[t+2] == 3)
                        z = (tg[t+3] == 0 || tg[t+3] == 2) ? -1 : 0;
                    else if (tg[t+1] == 2 && tg[t+2] == 1) z = 1;
                    else if (tg[t+1] == 0 && tg[t+2] == 3) z = 2;
                } else if (flag & EZF_SPLICE_REV) {
                    if (tg[t+1] == 1 && tg[t+2] == 3)
                        z = (tg[t+3] == 0 || tg[t+3] == 2) ? -1 : 0;
                    else if (tg[t+1] == 2 && tg[t+2] == 3) z = 2;
                }
                donor64[t] = z < 0 ? 0 : -sp[z];
            }
            for (int t = 2; t < tlen; ++t) {
                int z = 3;
                if (flag & EZF_SPLICE_FOR) {
                    if (tg[t-1] == 0 && tg[t] == 2)
                        z = (tg[t-2] == 1 || tg[t-2] == 3) ? -1 : 0;
                    else if (tg[t-1] == 0 && tg[t] == 1) z = 2;
                } else if (flag & EZF_SPLICE_REV) {
                    if (tg[t-1] == 0 && tg[t] == 1)
                        z = (tg[t-2] == 1 || tg[t-2] == 3) ? -1 : 0;
                    else if (tg[t-1] == 2 && tg[t] == 1) z = 1;
                    else if (tg[t-1] == 0 && tg[t] == 3) z = 2;
                }
                acceptor64[t] = z < 0 ? 0 : -sp[z];
            }
        } else {
            for (int t = 0; t < tlen - 4; ++t) {
                int z = 3;
                if (flag & EZF_SPLICE_FOR) {
                    if (tg[t+1] == 2 && tg[t+2] == 0)
                        z = (tg[t+3] == 1 || tg[t+3] == 3) ? -1 : 0;
                    else if (tg[t+1] == 1 && tg[t+2] == 0) z = 2;
                } else if (flag & EZF_SPLICE_REV) {
                    if (tg[t+1] == 1 && tg[t+2] == 0)
                        z = (tg[t+3] == 1 || tg[t+3] == 3) ? -1 : 0;
                    else if (tg[t+1] == 1 && tg[t+2] == 2) z = 1;
                    else if (tg[t+1] == 3 && tg[t+2] == 0) z = 2;
                }
                donor64[t] = z < 0 ? 0 : -sp[z];
            }
            for (int t = 2; t < tlen; ++t) {
                int z = 3;
                if (flag & EZF_SPLICE_FOR) {
                    if (tg[t-1] == 3 && tg[t] == 2)
                        z = (tg[t-2] == 0 || tg[t-2] == 2) ? -1 : 0;
                    else if (tg[t-1] == 1 && tg[t] == 2) z = 1;
                    else if (tg[t-1] == 3 && tg[t] == 0) z = 2;
                } else if (flag & EZF_SPLICE_REV) {
                    if (tg[t-1] == 3 && tg[t] == 1)
                        z = (tg[t-2] == 0 || tg[t-2] == 2) ? -1 : 0;
                    else if (tg[t-1] == 3 && tg[t] == 2) z = 2;
                }
                acceptor64[t] = z < 0 ? 0 : -sp[z];
            }
        }
    }
    if (junc && (flag & EZF_SPLICE_SCORE)) {
        int donor_val = ((!!(flag & EZF_SPLICE_FOR))
                         == !(flag & EZF_REV_CIGAR)) ? 0 : 1;
        for (int t = 0; t < tlen - 1; ++t) {
            int jv = junc[t + 1];
            donor64[t] += (jv == 0xFF || (jv & 1) != donor_val)
                ? -junc_pen : (int)(int8_t)(jv >> 1) - KSW_SPSC_OFFSET2;
            acceptor64[t] += (jv == 0xFF || (jv & 1) != (1 - donor_val))
                ? -junc_pen : (int)(int8_t)(jv >> 1) - KSW_SPSC_OFFSET2;
        }
    } else if (junc) {
        if (!(flag & EZF_REV_CIGAR)) {
            for (int t = 0; t < tlen - 1; ++t)
                if (((flag & EZF_SPLICE_FOR) && (junc[t+1] & 1))
                        || ((flag & EZF_SPLICE_REV) && (junc[t+1] & 8)))
                    donor64[t] += junc_bonus;
            for (int t = 0; t < tlen; ++t)
                if (((flag & EZF_SPLICE_FOR) && (junc[t] & 2))
                        || ((flag & EZF_SPLICE_REV) && (junc[t] & 4)))
                    acceptor64[t] += junc_bonus;
        } else {
            for (int t = 0; t < tlen - 1; ++t)
                if (((flag & EZF_SPLICE_FOR) && (junc[t+1] & 2))
                        || ((flag & EZF_SPLICE_REV) && (junc[t+1] & 4)))
                    donor64[t] += junc_bonus;
            for (int t = 0; t < tlen; ++t)
                if (((flag & EZF_SPLICE_FOR) && (junc[t] & 1))
                        || ((flag & EZF_SPLICE_REV) && (junc[t] & 8)))
                    acceptor64[t] += junc_bonus;
        }
    }
    std::vector<int8_t> donor(L), acceptor(L);
    for (int64_t i = 0; i < L; ++i) {
        donor[i] = (int8_t)donor64[i];
        acceptor[i] = (int8_t)acceptor64[i];
    }

    std::vector<int32_t> H;
    if (!approx_max) H.assign(tlen_ * 16 + 16, KSW_NEG_INF);
    int64_t R = (int64_t)qlen + tlen - 1;
    std::vector<int64_t> off(R, 0), off_end(R, 0), p_off(R, 0);
    std::vector<uint8_t> p;
    int qe_pen = q + e;
    int64_t H0 = 0; int last_H0_t = 0;
    int64_t last_st = -1, last_en = -1;

    for (int64_t r = 0; r < R; ++r) {
        int64_t st = 0, en = tlen - 1;
        if (st < r - qlen + 1) st = r - qlen + 1;
        if (en > r) en = r;
        int64_t st0 = st, en0 = en;
        st = st / 16 * 16;
        en = (en + 16) / 16 * 16 - 1;
        int x1, x21, v1;
        if (st > 0) {
            if (last_st <= st - 1 && st - 1 <= last_en) {
                x1 = x[st - 1]; x21 = x2[st - 1]; v1 = v[st - 1];
            } else { x1 = -q - e; x21 = -q2; v1 = -q - e; }
        } else {
            x1 = -q - e; x21 = -q2;
            v1 = r == 0 ? -q - e : r < long_thres ? -e
                : r == long_thres ? long_diff : 0;
        }
        if (en >= r) {
            y[r] = wrap8(-q - e);
            u[r] = wrap8(r == 0 ? -q - e : r < long_thres ? -e
                         : r == long_thres ? long_diff : 0);
        }
        int64_t base = qlen - 1 - r;
        if (!generic) {
            // flat branch-free profile build (vpcmpeqb + blends); covers the
            // same cells as the reference's 16-blocked build from st0
            int64_t ns = (en0 - st0) / 16 * 16 + 16;
            const uint8_t *__restrict tgp = sf.data() + st0;
            const uint8_t *__restrict qqp = qr.data() + (base + st0);
            int8_t *__restrict sw = s.data() + st0;
            uint8_t mN = (uint8_t)(m - 1);
            int8_t m0 = mat[0], m1 = mat[1];
            for (int64_t k2 = 0; k2 < ns; ++k2) {
                uint8_t aq = tgp[k2], bq = qqp[k2];
                sw[k2] = (aq == mN || bq == mN) ? sc_N : (aq == bq ? m0 : m1);
            }
        } else {
            for (int64_t k2 = st0; k2 <= en0; ++k2)
                s[k2] = mat[(int)sf[k2] * m + qr[base + k2]];
        }
        uint8_t *prow = 0;
        if (with_cigar) {
            p_off[r] = (int64_t)p.size();
            p.resize(p.size() + (en - st + 1));
            prow = p.data() + p_off[r];
        }
        int8_t xp = (int8_t)x1, vp = (int8_t)v1, x2p = (int8_t)x21;
        for (int64_t k2 = st; k2 <= en; ++k2) {
            int8_t z = s[k2];
            int8_t xt1 = xp, vt1 = vp, x2t1 = x2p;
            xp = x[k2]; vp = v[k2]; x2p = x2[k2];
            int8_t ut = u[k2];
            int8_t a = wrap8(xt1 + vt1);
            int8_t b = wrap8(y[k2] + ut);
            int8_t a2 = wrap8(x2t1 + vt1);
            int8_t a2a = wrap8(a2 + acceptor[k2]);
            uint8_t d = 0;
            if (with_cigar) {
                if (!right_mode) {
                    d = a > z ? 1 : 0; if (a > z) z = a;
                    if (b > z) { d = 2; z = b; }
                    if (a2a > z) { d = 3; z = a2a; }
                } else {
                    d = z > a ? 0 : 1; if (a > z) z = a;
                    if (!(z > b)) d = 2; if (b > z) z = b;
                    if (!(z > a2a)) d = 3; if (a2a > z) z = a2a;
                }
            } else {
                if (a > z) z = a; if (b > z) z = b; if (a2a > z) z = a2a;
            }
            u[k2] = wrap8(z - vt1);
            v[k2] = wrap8(z - ut);
            int8_t t1 = wrap8(z - q);
            a = wrap8(a - t1); b = wrap8(b - t1);
            a2 = wrap8(a2 - wrap8(z - q2));
            bool ga, gb, g2;
            if (!right_mode) { ga = a > 0; gb = b > 0; }
            else { ga = a >= 0; gb = b >= 0; }
            x[k2] = wrap8((ga ? a : 0) - qe_pen);
            y[k2] = wrap8((gb ? b : 0) - qe_pen);
            int8_t dn = donor[k2];
            if (!right_mode) g2 = a2 > dn; else g2 = a2 >= dn;
            x2[k2] = wrap8((g2 ? a2 : dn) - q2);
            if (with_cigar) {
                if (ga) d |= 0x08; if (gb) d |= 0x10; if (g2) d |= 0x20;
                prow[k2 - st] = d;
            }
        }
        if (with_cigar) { off[r] = st; off_end[r] = en; }
        if (!approx_max) {
            int64_t max_H, max_t;
            if (r > 0) {
                if (en0 > 0) H[en0] = H[en0 - 1] + u[en0];
                else H[en0] = H[en0] + v[en0];
                {
                    int32_t *__restrict Hp = H.data() + st0;
                    const int8_t *__restrict vv = v.data() + st0;
                    int64_t nh = en0 - st0;
                    for (int64_t t = 0; t < nh; ++t) Hp[t] += vv[t];
                    int32_t mh = H[en0]; max_t = en0;
                    for (int64_t t = 0; t < nh; ++t)
                        if (Hp[t] > mh) mh = Hp[t];
                    max_H = mh;
                    if (max_H > H[en0])
                        for (int64_t t = 0; t < nh; ++t)
                            if (Hp[t] == max_H) { max_t = st0 + t; break; }
                }
            } else {
                H[0] = v[0] - qe_pen;
                max_H = H[0]; max_t = 0;
            }
            if (en0 == tlen - 1 && H[en0] > ez->mte) {
                ez->mte = (int32_t)H[en0]; ez->mte_q = (int32_t)(r - en0);
            }
            if (r - st0 == qlen - 1 && H[st0] > ez->mqe) {
                ez->mqe = (int32_t)H[st0]; ez->mqe_t = (int32_t)st0;
            }
            if (apply_zdrop(ez, max_H, (int)r, (int)max_t, zdrop, 0)) break;
            if (r == R - 1 && en0 == tlen - 1) ez->score = (int32_t)H[tlen - 1];
        } else {
            if (r > 0) {
                if (st0 <= last_H0_t && last_H0_t <= en0
                        && st0 <= last_H0_t + 1 && last_H0_t + 1 <= en0) {
                    int d0 = v[last_H0_t], d1 = u[last_H0_t + 1];
                    if (d0 > d1) H0 += d0;
                    else { H0 += d1; ++last_H0_t; }
                } else if (st0 <= last_H0_t && last_H0_t <= en0) {
                    H0 += v[last_H0_t];
                } else { ++last_H0_t; H0 += u[last_H0_t]; }
                if ((flag & EZF_APPROX_DROP)
                        && apply_zdrop(ez, H0, (int)r, last_H0_t, zdrop, 0))
                    break;
            } else { H0 = v[0] - qe_pen; last_H0_t = 0; }
            if (r == R - 1 && en0 == tlen - 1) ez->score = (int32_t)H0;
        }
        last_st = st; last_en = en;
    }
    if (with_cigar) {
        std::vector<uint32_t> cig;
        if (!ez->zdropped && !(flag & EZF_EXTZ_ONLY))
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   tlen - 1, qlen - 1, long_thres, cig);
        else if (!ez->zdropped && (flag & EZF_EXTZ_ONLY)
                 && ez->mqe + end_bonus > ez->max) {
            ez->reach_end = 1;
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   ez->mqe_t, qlen - 1, long_thres, cig);
        } else if (ez->max_t >= 0 && ez->max_q >= 0)
            bt_rot(p.data(), p_off.data(), off.data(), off_end.data(),
                   ez->max_t, ez->max_q, long_thres, cig);
        if (flag & EZF_REV_CIGAR)
            std::reverse(cig.begin(), cig.end());
        ez->n_cigar = (int32_t)cig.size();
        int64_t n = (int64_t)cig.size() < cigar_cap ? (int64_t)cig.size()
            : cigar_cap;
        std::memcpy(cigar_out, cig.data(), n * 4);
    }
    return 0;
}

}  // extern "C"

extern "C" {

// =====================================================================
// chaining DP (mg_lchain_dp, lchain.c:148-217) + backtrack/compact
// (lchain.c:9-111): scalar port of the verified map/chain.py oracle.
// =====================================================================

static inline float mg_log2f(float x)
{
    uint32_t zi;
    std::memcpy(&zi, &x, 4);
    float log2i = (float)(int)((zi >> 23 & 255) - 128);
    zi = (zi & 0x007FFFFFu) | (127u << 23);
    float zf;
    std::memcpy(&zf, &zi, 4);
    return log2i + ((-0.34484843f * zf + 2.02466578f) * zf - 0.67487759f);
}

static const int64_t CH_NEG_INF = -((int64_t)1 << 62);

static inline int64_t comput_sc(uint64_t xi, uint64_t yi, uint64_t xj,
                                uint64_t yj, int64_t max_dist_x,
                                int64_t max_dist_y, int64_t bw,
                                float chn_pen_gap, float chn_pen_skip,
                                int is_cdna, int n_seg)
{
    int64_t dq = (int64_t)(int32_t)(uint32_t)yi - (int64_t)(uint32_t)yj;
    int sidi = (int)(yi >> 48 & 0xFF), sidj = (int)(yj >> 48 & 0xFF);
    int64_t dr = (int32_t)(xi - xj);
    int same = sidi == sidj;
    if (dq <= 0 || dq > max_dist_x) return CH_NEG_INF;
    if (same && (dr == 0 || dq > max_dist_y)) return CH_NEG_INF;
    int64_t dd = dr > dq ? dr - dq : dq - dr;
    if (same && dd > bw) return CH_NEG_INF;
    if (n_seg > 1 && !is_cdna && same && dr > max_dist_y) return CH_NEG_INF;
    int64_t dg = dr < dq ? dr : dq;
    int64_t q_span = (int64_t)(yj >> 32 & 0xFF);
    int64_t sc = q_span < dg ? q_span : dg;
    if (dd || dg > q_span) {
        float lin_pen = chn_pen_gap * (float)dd + chn_pen_skip * (float)dg;
        float log_pen = dd >= 1 ? mg_log2f((float)(dd + 1)) : 0.0f;
        if (is_cdna || sidi != sidj) {
            if (sidi != sidj && dr == 0) ++sc;            // weird splice gap
            else if (dr > dq || sidi != sidj)
                sc -= (int64_t)(lin_pen < log_pen ? lin_pen : log_pen);
            else
                sc -= (int64_t)(lin_pen + 0.5f * log_pen);
        } else {
            sc -= (int64_t)(lin_pen + 0.5f * log_pen);
        }
    }
    return sc;
}

static int64_t chain_bk_end(int64_t max_drop, const int64_t *zx,
                            const int64_t *zy, const int64_t *f,
                            const int64_t *pp, int64_t *t, int64_t k)
{
    int64_t i = zy[k], end_i = -1, max_i = i;
    int32_t max_s = 0;
    if (i < 0 || t[i] != 0) return i;
    do {
        t[i] = 2;
        i = pp[i];
        end_i = i;
        int32_t s = (int32_t)(i < 0 ? zx[k] : zx[k] - f[i]);
        if (s > max_s) { max_s = s; max_i = i; }
        else if (max_s - s > max_drop) break;
    } while (i >= 0 && t[i] == 0);
    for (i = zy[k]; i >= 0 && i != end_i; i = pp[i])
        t[i] = 0;
    return max_i;
}

// mg_chain_backtrack + compact_a shared by the DP and RMQ chainers
static int64_t backtrack_compact_c(int64_t n, const int64_t *f,
                                   const int64_t *pp, int64_t min_cnt,
                                   int64_t min_sc, int64_t max_drop,
                                   const uint64_t *ax, const uint64_t *ay,
                                   uint64_t *out_u, uint64_t *out_ax,
                                   uint64_t *out_ay, int64_t *out_n_anchor)
{
    std::vector<int64_t> t(n, 0);
    std::vector<int64_t> sel;
    for (int64_t i = 0; i < n; ++i)
        if (f[i] >= min_sc) sel.push_back(i);
    if (sel.empty()) return 0;
    std::stable_sort(sel.begin(), sel.end(),
                     [&](int64_t a, int64_t b) { return f[a] < f[b]; });
    int64_t n_z = (int64_t)sel.size();
    std::vector<int64_t> zx(n_z), zy(n_z);
    for (int64_t k = 0; k < n_z; ++k) { zx[k] = f[sel[k]]; zy[k] = sel[k]; }
    std::vector<int64_t> v_list;
    std::vector<std::pair<int64_t, int64_t>> u_list;   // (sc, cnt)
    for (int64_t k = n_z - 1; k >= 0; --k) {
        if (t[zy[k]] != 0) continue;
        size_t n_v0 = v_list.size();
        int64_t end_i = chain_bk_end(max_drop, zx.data(), zy.data(),
                                     f, pp, t.data(), k);
        for (int64_t i = zy[k]; i != end_i; i = pp[i]) {
            v_list.push_back(i);
            t[i] = 1;
        }
        int64_t sc = (int32_t)(end_i < 0 ? zx[k] : zx[k] - f[end_i]);
        int64_t n_vi = (int64_t)(v_list.size() - n_v0);
        if (sc >= min_sc && n_vi > 0 && n_vi >= min_cnt)
            u_list.push_back({sc, n_vi});
        else
            v_list.resize(n_v0);
    }
    if (u_list.empty()) return 0;
    int64_t n_u = (int64_t)u_list.size();
    std::vector<int64_t> starts(n_u + 1, 0);
    for (int64_t j = 0; j < n_u; ++j)
        starts[j + 1] = starts[j] + u_list[j].second;
    std::vector<int64_t> corder(n_u);
    for (int64_t j = 0; j < n_u; ++j) corder[j] = j;
    std::stable_sort(corder.begin(), corder.end(), [&](int64_t a, int64_t b) {
        uint64_t fa = ax[v_list[starts[a + 1] - 1]];
        uint64_t fb = ax[v_list[starts[b + 1] - 1]];
        return fa < fb;
    });
    int64_t kpos = 0;
    for (int64_t jj = 0; jj < n_u; ++jj) {
        int64_t j = corder[jj];
        out_u[jj] = (uint64_t)u_list[j].first << 32
            | (uint64_t)u_list[j].second;
        for (int64_t i = starts[j + 1] - 1; i >= starts[j]; --i) {
            out_ax[kpos] = ax[v_list[i]];
            out_ay[kpos] = ay[v_list[i]];
            ++kpos;
        }
    }
    *out_n_anchor = kpos;
    return n_u;
}

// returns number of chains; fills u (score<<32|cnt), out_ax/out_ay
int64_t mg_lchain_dp_cpp(int64_t max_dist_x, int64_t max_dist_y, int64_t bw,
                         int64_t max_skip, int64_t max_iter,
                         int64_t min_cnt, int64_t min_sc,
                         float chn_pen_gap, float chn_pen_skip,
                         int is_cdna, int n_seg, int64_t n,
                         const uint64_t *ax, const uint64_t *ay,
                         uint64_t *out_u, uint64_t *out_ax,
                         uint64_t *out_ay, int64_t *out_n_anchor)
{
    *out_n_anchor = 0;
    if (n == 0) return 0;
    int64_t max_drop = bw;
    if (max_dist_x < bw) max_dist_x = bw;
    if (max_dist_y < bw && !is_cdna) max_dist_y = bw;
    if (is_cdna) max_drop = 0x7FFFFFFF;
    std::vector<int64_t> f(n, 0), pp(n, -1), vv(n, 0), t(n, -1);
    int64_t st = 0, max_ii = -1;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t ri = ax[i];
        int64_t max_f = (int64_t)(ay[i] >> 32 & 0xFF);
        int64_t max_j = -1;
        int n_skip = 0;
        while (st < i && ((ri >> 32) != (ax[st] >> 32)
                          || ri > ax[st] + (uint64_t)max_dist_x))
            ++st;
        if (i - st > max_iter) st = i - max_iter;
        int64_t end_j = st - 1;
        int64_t j;
        for (j = i - 1; j >= st; --j) {
            int64_t sc = comput_sc(ri, ay[i], ax[j], ay[j], max_dist_x,
                                   max_dist_y, bw, chn_pen_gap,
                                   chn_pen_skip, is_cdna, n_seg);
            if (sc == CH_NEG_INF) continue;
            sc += f[j];
            if (sc > max_f) {
                max_f = sc; max_j = j;
                if (n_skip > 0) --n_skip;
            } else if (t[j] == i) {
                if (++n_skip > max_skip) { end_j = j; break; }
            }
            if (pp[j] >= 0) t[pp[j]] = i;
        }
        if (j < st) end_j = st - 1;
        if (max_ii < 0 || (int64_t)(ri - ax[max_ii]) > max_dist_x) {
            max_ii = -1;
            if (st < i) {
                // rightmost argmax (C scans descending with strict '<')
                int64_t max_fj = CH_NEG_INF;
                for (int64_t jj = i - 1; jj >= st; --jj)
                    if (f[jj] > max_fj) { max_fj = f[jj]; max_ii = jj; }
                // rightmost: prefer larger index on ties
                for (int64_t jj = i - 1; jj >= st; --jj)
                    if (f[jj] == max_fj) { max_ii = jj; break; }
            }
        }
        if (max_ii >= 0 && max_ii < end_j) {
            int64_t tsc = comput_sc(ri, ay[i], ax[max_ii], ay[max_ii],
                                    max_dist_x, max_dist_y, bw, chn_pen_gap,
                                    chn_pen_skip, is_cdna, n_seg);
            if (tsc != CH_NEG_INF && max_f < tsc + f[max_ii]) {
                max_f = tsc + f[max_ii];
                max_j = max_ii;
            }
        }
        f[i] = max_f; pp[i] = max_j;
        vv[i] = (max_j >= 0 && vv[max_j] > max_f) ? vv[max_j] : max_f;
        if (max_ii < 0 || ((int64_t)(ri - ax[max_ii]) <= max_dist_x
                           && f[max_ii] < f[i]))
            max_ii = i;
        t[i] = 0;   // oracle uses -1 sentinel; reuse as 'not marked'
    }
    return backtrack_compact_c(n, f.data(), pp.data(), min_cnt, min_sc,
                               max_drop, ax, ay, out_u, out_ax, out_ay,
                               out_n_anchor);
}

// comput_sc_simple (lchain.c:232-248)
static inline int64_t comput_sc_simple_c(uint64_t xi, uint64_t yi,
                                         uint64_t xj, uint64_t yj,
                                         float chn_pen_gap,
                                         float chn_pen_skip,
                                         int *exact, int64_t *width)
{
    int64_t dq = (int64_t)(int32_t)(uint32_t)yi - (int64_t)(int32_t)(uint32_t)yj;
    int64_t dr = (int32_t)(xi - xj);
    int64_t dd = dr > dq ? dr - dq : dq - dr;
    int64_t dg = dr < dq ? dr : dq;
    int64_t q_span = (int64_t)(yj >> 32 & 0xFF);
    int64_t sc = q_span < dg ? q_span : dg;
    *exact = (dd == 0 && dg <= q_span);
    if (dd || dq > q_span) {
        float lin_pen = chn_pen_gap * (float)dd + chn_pen_skip * (float)dg;
        float log_pen = dd >= 1 ? mg_log2f((float)(dd + 1)) : 0.0f;
        sc -= (int64_t)(lin_pen + 0.5f * log_pen);
    }
    *width = dd;
    return sc;
}

// max-segment-tree over (pri, -index): higher priority wins, ties -> the
// smaller anchor index (matches the oracle's first-argmax semantics)
struct RmqSeg {
    int64_t sz;
    std::vector<double> pri;
    std::vector<int64_t> idx;
    void init(int64_t n) {
        sz = 1;
        while (sz < n) sz <<= 1;
        pri.assign(2 * sz, -std::numeric_limits<double>::infinity());
        idx.assign(2 * sz, -1);
    }
    void set(int64_t pos, double v, int64_t id) {
        int64_t x = pos + sz;
        pri[x] = v; idx[x] = id;
        for (x >>= 1; x >= 1; x >>= 1) {
            int64_t l = 2 * x, r = 2 * x + 1;
            if (pri[l] > pri[r] || (pri[l] == pri[r] && idx[l] < idx[r])) {
                pri[x] = pri[l]; idx[x] = idx[l];
            } else { pri[x] = pri[r]; idx[x] = idx[r]; }
        }
    }
    // best over rank range [l, r)
    void query(int64_t l, int64_t r, double *bp, int64_t *bi) const {
        double p_ = -std::numeric_limits<double>::infinity();
        int64_t i_ = -1;
        for (l += sz, r += sz; l < r; l >>= 1, r >>= 1) {
            if (l & 1) {
                if (pri[l] > p_ || (pri[l] == p_ && idx[l] < i_)) {
                    p_ = pri[l]; i_ = idx[l];
                }
                ++l;
            }
            if (r & 1) {
                --r;
                if (pri[r] > p_ || (pri[r] == p_ && idx[r] < i_)) {
                    p_ = pri[r]; i_ = idx[r];
                }
            }
        }
        *bp = p_; *bi = i_;
    }
};

// mg_lchain_rmq (lchain.c:250-368) as an offline sweep: the krmq AVL tree
// becomes a segment tree over (y, index) rank with activation toggles, the
// inner small-gap tree an ordered set walked in descending (y, index).
// Bit-exact with the Python oracle chain_rmq (map/chain.py).
int64_t mg_lchain_rmq_cpp(int64_t max_dist, int64_t max_dist_inner,
                          int64_t bw, int64_t max_chn_skip,
                          int64_t cap_rmq_size, int64_t min_cnt,
                          int64_t min_sc, float chn_pen_gap,
                          float chn_pen_skip, int64_t n,
                          const uint64_t *ax, const uint64_t *ay,
                          uint64_t *out_u, uint64_t *out_ax,
                          uint64_t *out_ay, int64_t *out_n_anchor)
{
    *out_n_anchor = 0;
    if (n == 0) return 0;
    if (max_dist < bw) max_dist = bw;
    if (max_dist_inner < 0) max_dist_inner = 0;
    if (max_dist_inner > max_dist) max_dist_inner = max_dist;
    std::vector<int64_t> f(n, 0), pp(n, -1), vv(n, 0), t(n, -1);
    std::vector<int64_t> y32(n), x32(n), xhi(n);
    for (int64_t i = 0; i < n; ++i) {
        y32[i] = (int32_t)(uint32_t)ay[i];
        x32[i] = (int32_t)(uint32_t)ax[i];
        xhi[i] = (int64_t)(ax[i] >> 32);
    }
    // rank anchors by (y32, index) for the segment tree
    std::vector<int64_t> order(n), rank(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return y32[a] < y32[b];
    });
    std::vector<int64_t> ys(n);
    for (int64_t r = 0; r < n; ++r) { rank[order[r]] = r; ys[r] = y32[order[r]]; }
    RmqSeg seg;
    seg.init(n);
    std::set<std::pair<int64_t, int64_t>> inner;   // (y32, index)
    std::vector<uint8_t> in_tree(n, 0), in_inner(n, 0);
    int64_t st = 0, st_inner = 0, i0 = 0;
    int64_t tree_size = 0, inner_size = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t q_span = (int64_t)(ay[i] >> 32 & 0xFF);
        int64_t max_f = q_span, max_j = -1;
        if (i0 < i && ax[i0] != ax[i]) {
            for (int64_t j = i0; j < i; ++j) {
                double pj = (double)f[j]
                    + 0.5 * (double)chn_pen_gap
                    * ((double)x32[j] + (double)y32[j]);
                seg.set(rank[j], pj, j);
                in_tree[j] = 1;
                ++tree_size;
                if (max_dist_inner > 0) {
                    inner.insert({y32[j], j});
                    in_inner[j] = 1;
                    ++inner_size;
                }
            }
            i0 = i;
        }
        while (st < i && (xhi[i] != xhi[st]
                          || ax[i] > ax[st] + (uint64_t)max_dist
                          || tree_size > cap_rmq_size)) {
            if (in_tree[st]) {
                in_tree[st] = 0;
                seg.set(rank[st],
                        -std::numeric_limits<double>::infinity(), -1);
                --tree_size;
            }
            ++st;
        }
        if (max_dist_inner > 0) {
            while (st_inner < i
                   && (xhi[i] != xhi[st_inner]
                       || ax[i] > ax[st_inner] + (uint64_t)max_dist_inner
                       || inner_size > cap_rmq_size)) {
                if (in_inner[st_inner]) {
                    in_inner[st_inner] = 0;
                    inner.erase({y32[st_inner], st_inner});
                    --inner_size;
                }
                ++st_inner;
            }
        }
        int64_t lo_y = y32[i] - max_dist, hi_y = y32[i];
        if (tree_size > 0) {
            // rank range for y in (lo_y, hi_y) exclusive on both ends
            int64_t lo_r = std::lower_bound(ys.begin(), ys.end(), lo_y + 1)
                - ys.begin();
            int64_t hi_r = std::lower_bound(ys.begin(), ys.end(), hi_y)
                - ys.begin();
            if (lo_r < hi_r) {
                double bp; int64_t q;
                seg.query(lo_r, hi_r, &bp, &q);
                if (q >= 0) {
                    int exact; int64_t width;
                    int64_t sc = comput_sc_simple_c(
                        ax[i], ay[i], ax[q], ay[q], chn_pen_gap,
                        chn_pen_skip, &exact, &width);
                    int64_t scf = sc + f[q];
                    if (width <= bw && scf > max_f) {
                        max_f = scf; max_j = q;
                    }
                    int n_skip = 0;
                    if (!exact && max_dist_inner > 0 && y32[i] > 0) {
                        auto it = inner.lower_bound({y32[i] - 1,
                                                     INT64_MAX});
                        while (it != inner.begin()) {
                            --it;
                            int64_t q2 = it->second;
                            if (y32[q2] < y32[i] - max_dist_inner) break;
                            int ex2; int64_t w2;
                            int64_t sc2 = comput_sc_simple_c(
                                ax[i], ay[i], ax[q2], ay[q2], chn_pen_gap,
                                chn_pen_skip, &ex2, &w2);
                            sc2 += f[q2];
                            if (w2 <= bw) {
                                if (sc2 > max_f) {
                                    max_f = sc2; max_j = q2;
                                    if (n_skip > 0) --n_skip;
                                } else if (t[q2] == i) {
                                    if (++n_skip > max_chn_skip) break;
                                }
                                if (pp[q2] >= 0) t[pp[q2]] = i;
                            }
                        }
                    }
                }
            }
        }
        f[i] = max_f; pp[i] = max_j;
        vv[i] = (max_j >= 0 && vv[max_j] > max_f) ? vv[max_j] : max_f;
    }
    return backtrack_compact_c(n, f.data(), pp.data(), min_cnt, min_sc,
                               bw, ax, ay, out_u, out_ax, out_ay,
                               out_n_anchor);
}

}  // extern "C"

extern "C" {

// ksw_ll (Farrar striped local SW, score+end only), scalar port of
// ops/ksw2_np.ksw_ll (ksw2_ll_sse.c:85-152 semantics incl. the lazy-F
// early exit). Returns score; fills qe/te.
int64_t ksw_ll_cpp(int qlen, const uint8_t *query, int tlen,
                   const uint8_t *target, int m, const int8_t *mat,
                   int gapo, int gape, int32_t *qe_out, int32_t *te_out)
{
    *qe_out = *te_out = -1;
    if (qlen <= 0 || tlen <= 0) return 0;
    int slen = (qlen + 7) / 8;
    int W = slen * 8;
    // striped profile: prof[a][j*8+lane] = mat[a][q[lane*slen+j]] or -1
    std::vector<int64_t> prof((size_t)m * W);
    for (int a = 0; a < m; ++a)
        for (int j = 0; j < slen; ++j)
            for (int lane = 0; lane < 8; ++lane) {
                int pos = j + lane * slen;
                prof[(size_t)a * W + j * 8 + lane] =
                    pos < qlen ? mat[(size_t)a * m + query[pos]] : -1;
            }
    int gapoe = gapo + gape;
    std::vector<int64_t> H0(W, 0), H1(W, 0), E(W, 0), Hmax(W, 0);
    int64_t gmax = 0;
    int te = -1;
    auto subs = [](int64_t a, int64_t b) { return a > b ? a - b : 0; };
    for (int i = 0; i < tlen; ++i) {
        const int64_t *S = &prof[(size_t)target[i] * W];
        int64_t h[8], f[8] = {0};
        // h = H0[slen-1] shifted one lane up
        h[0] = 0;
        for (int lane = 1; lane < 8; ++lane)
            h[lane] = H0[(slen - 1) * 8 + lane - 1];
        int64_t rowmax[8] = {0};
        for (int j = 0; j < slen; ++j) {
            for (int lane = 0; lane < 8; ++lane) {
                int64_t hh = h[lane] + S[j * 8 + lane];
                int64_t e = E[j * 8 + lane];
                if (e > hh) hh = e;
                if (f[lane] > hh) hh = f[lane];
                if (hh > rowmax[lane]) rowmax[lane] = hh;
                H1[j * 8 + lane] = hh;
                int64_t h2 = subs(hh, gapoe);
                e = subs(e, gape);
                E[j * 8 + lane] = e > h2 ? e : h2;
                f[lane] = subs(f[lane], gape);
                if (h2 > f[lane]) f[lane] = h2;
                h[lane] = H0[j * 8 + lane];
            }
        }
        // lazy F propagation
        bool done = false;
        for (int k = 0; k < 8 && !done; ++k) {
            for (int lane = 7; lane >= 1; --lane) f[lane] = f[lane - 1];
            f[0] = 0;
            for (int j = 0; j < slen; ++j) {
                bool any = false;
                for (int lane = 0; lane < 8; ++lane) {
                    int64_t hh = H1[j * 8 + lane];
                    if (f[lane] > hh) hh = f[lane];
                    H1[j * 8 + lane] = hh;
                    int64_t h2 = subs(hh, gapoe);
                    f[lane] = subs(f[lane], gape);
                    if (f[lane] > h2) any = true;
                }
                if (!any) { done = true; break; }
            }
        }
        int64_t imax = 0;
        for (int lane = 0; lane < 8; ++lane)
            if (rowmax[lane] > imax) imax = rowmax[lane];
        if (imax >= gmax) {
            gmax = imax; te = i;
            std::memcpy(Hmax.data(), H1.data(), W * 8);
        }
        H0.swap(H1);
    }
    int qe = -1;
    for (int iflat = 0; iflat < W; ++iflat)
        if (Hmax[iflat] == gmax)
            qe = iflat / 8 + (iflat % 8) * slen;
    *qe_out = qe; *te_out = te;
    return gmax;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// 2-choice bucketed hash table of the device seed lookup (the h2 layout
// of parallel/batch.py): each key goes into the emptier of two candidate
// buckets of S slots, so a device probe is two row gathers.  Layouts
// (empty slot marker in [0]):
//   key32=1 (key bits < 32): (NB, S, 3) int32 [key_lo, start, cnt],
//            empty key_lo = -1 (unreachable: keys < 2^31)
//   key32=0: (NB, S, 4) int32 [key_hi, key_lo, start, cnt], empty
//            key_hi = -1 (unreachable: keys < 2^56)
// The b1/b2 mixing matches the probe in parallel/batch.py bit for bit:
// mulhi=1 maps a hash h to ((u64)h * NB) >> 32 (any NB), mulhi=0 to a
// low-bits mask (NB a power of two).  Returns the number of keys that fit
// neither bucket (0 on success).
// ---------------------------------------------------------------------
int64_t build_hash2_table(const uint64_t* keys, const int64_t* starts,
                          int64_t n, int64_t NB, int S, int key32,
                          int mulhi, int32_t* table)
{
    uint32_t mask = (uint32_t)(NB - 1);
    int st = key32 ? 3 : 4;
    std::vector<uint8_t> occ((size_t)NB, 0);
    std::memset(table, 0, (size_t)NB * S * st * sizeof(int32_t));
    for (int64_t b = 0; b < NB; ++b)
        for (int s = 0; s < S; ++s)
            table[(b * S + s) * st] = -1;
    int64_t overflow = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t key = keys[i];
        uint32_t lo = (uint32_t)key, hi = (uint32_t)(key >> 32);
        uint32_t k11 = (uint32_t)((lo >> 11) | (hi << 21)) * 2654435761u;
        uint32_t b1, b2;
        if (mulhi) {
            uint32_t m1 = lo * 2654435769u;
            b1 = (uint32_t)(((uint64_t)m1 * (uint64_t)NB) >> 32);
            b2 = (uint32_t)(((uint64_t)k11 * (uint64_t)NB) >> 32);
        } else {
            b1 = lo & mask;
            b2 = (k11 >> 7) & mask;
        }
        uint32_t b = occ[b1] <= occ[b2] ? b1 : b2;
        if (occ[b] >= S) b = (b == b1) ? b2 : b1;
        if (occ[b] >= S) { ++overflow; continue; }
        int32_t* slot = table + ((int64_t)b * S + occ[b]) * st;
        if (key32) {
            slot[0] = (int32_t)lo;
            slot[1] = (int32_t)starts[i];
            slot[2] = (int32_t)(starts[i + 1] - starts[i]);
        } else {
            slot[0] = (int32_t)hi;
            slot[1] = (int32_t)lo;
            slot[2] = (int32_t)starts[i];
            slot[3] = (int32_t)(starts[i + 1] - starts[i]);
        }
        ++occ[b];
    }
    return overflow;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// Batched sketch of the index build: the contigs concatenated in codes,
// contig r at offs[r] of lens[r] bases (rid r); contigs shorter than k
// give nothing.  Returns the total written, or a count above cap when
// the output does not fit (the caller grows it and calls again).
// ---------------------------------------------------------------------
int64_t mm_sketch_many(const uint8_t *codes, const int64_t *offs,
                       const int64_t *lens, int64_t n_seq, int w, int k,
                       int is_hpc, uint64_t *out_x, uint64_t *out_y,
                       int64_t cap)
{
    int64_t total = 0;
    for (int64_t r = 0; r < n_seq; ++r) {
        if (lens[r] < k) continue;
        int64_t m = mm_sketch_nt4(codes + offs[r], lens[r], w, k,
                                  (uint32_t)r, is_hpc, out_x + total,
                                  out_y + total, cap - total);
        total += m;
        if (total > cap) return total;
    }
    return total;
}

// ---------------------------------------------------------------------
// Stable LSD radix sort of (key, payload) u64 pairs by the low key_bits
// of the key, 16 bits a pass (the flat-array counterpart of the
// reference's radix_sort_128x): in place, with one n-sized scratch pair.
// ---------------------------------------------------------------------
void radix_sort_u64_pair(uint64_t *keys, uint64_t *vals, int64_t n,
                         int key_bits)
{
    if (n <= 1) return;
    int passes = (key_bits + 15) / 16;
    std::vector<uint64_t> tk((size_t)n), tv((size_t)n);
    uint64_t *k0 = keys, *v0 = vals, *k1 = tk.data(), *v1 = tv.data();
    std::vector<int64_t> cnt(1 << 16);
    for (int p = 0; p < passes; ++p) {
        int sh = p * 16;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; ++i) ++cnt[(k0[i] >> sh) & 0xFFFF];
        int64_t acc = 0;
        for (int b = 0; b < (1 << 16); ++b) {
            int64_t c = cnt[b]; cnt[b] = acc; acc += c;
        }
        for (int64_t i = 0; i < n; ++i) {
            int64_t d = cnt[(k0[i] >> sh) & 0xFFFF]++;
            k1[d] = k0[i]; v1[d] = v0[i];
        }
        std::swap(k0, k1); std::swap(v0, v1);
    }
    if (k0 != keys) {
        std::memcpy(keys, k0, (size_t)n * 8);
        std::memcpy(vals, v0, (size_t)n * 8);
    }
}

}  // extern "C"
