// Banded dual-affine extension with direction bytes (ksw_extd2) on Hopper.
//
// Replaces minimap2_tpu/ops/extend_pallas2.py: extd2_batch2 ->
// _extd2_kernel_v2 (the Pallas kernel at extend_pallas2.py:102-541, called
// at :658) in each of its modes, one template instantiation a mode:
// approx-max (the -c/-a path's, with or without approx-drop) or exact-max,
// left- or right-aligned, with or without the direction matrix (a runtime
// flag).  Per anti-diagonal r the
// Suzuki-Kasahara difference rows u, v, x, y, x2, y2 and the score row s
// advance over W lanes; lane l is target position wstart_chunk(r) + l, the
// window origin shared by the RB diagonals of a chunk, and the rows shift
// left by dsh lanes (fill -q-e, -q2-e2 or 0) at each chunk boundary, as in
// the Pallas kernel, because stale lanes of s and the boundary values at
// st-1 depend on that layout.  The score comes from the greedy H0 walk
// along the main diagonal, or in the exact mode from the H row.  Outputs p
// (N, RT, W) u8 direction bytes and ez (N, 16) i32; EZ_DEAD is set by the
// wrapper (ops/extend.py), which also passes the block -> job order.
//
// The exact mode (EXACT, :398-448) keeps H in GL more registers a thread
// (circular like the other rows: the lanes that wrap at a chunk shift
// take NEG_INF32, chunk_shift's fill).  The owner of lane en0 computes
// h_en0 from its own u, v and H, and H at en0 - 1, which is its previous
// register or, in lane 0, the previous group's last H, published in the
// edge int4's fourth field; lane en0 - 1 left of the window reads 0, as the
// Pallas kernel's one-hot sum does.  The row's maximum over [st0, en0] and
// its key (-t for a body lane, so that the lowest lane wins a tie, and
// INT_MAX for en0, which wins a tie with the body: the Pallas kernel's
// strict body_max > h_en0) go through two __reduce_max_sync a warp into
// shared memory; the owners of en0 and st0 export h_en0 and H[st0].  Every
// thread reads them after the diagonal's one barrier, at the start of the
// next diagonal, as it runs the H0 walk in the approx mode, and updates
// mqe/mte, the score and ksw_apply_zdrop (ksw2.h:171-187) alike, so no
// second barrier is needed.  approx_drop (ADROP, :476-489) runs the same
// z-drop test on the H0 walk.  A z-drop stops the job after its diagonal
// and is reported in ez lane 14 for the wrapper.  RIGHT takes the >= forms
// of the direction-byte compares (:333-390).
//
// What bounds it: not the N*RT*W bytes of p (9.2 GB for a 576-job launch
// at QP=12288, TP=12800, W=640, RT=25088: 2.7 ms at 3.35 TB/s) nor the ~40
// integer operations per band cell, but the latency of one diagonal times
// the longest job's ~22k diagonals, and once an SM holds four or more jobs,
// its issue rate.  Three limits of the earlier design (one block of W
// threads a job, 64 jobs a launch, 9 launches a 512-read batch) and what
// this one does about each:
// 1. Idle SMs and many launches.  The caller sends a whole batch's jobs in
//    one launch (padded only to a multiple of G), and blocks take jobs
//    longest first (qlen + tlen, the `order` array), so the longest jobs
//    start first, spread over the SMs, and the launch costs about one
//    longest job plus the issue time of the rest.
// 2. Work per diagonal.  A thread owns GL consecutive lanes in registers
//    (GL = 4: W = 640 takes 160 threads, five warps instead of twenty) and
//    updates them with no shared-memory row traffic: a lane's left
//    neighbour is the previous register, and across threads the previous
//    group's last x, v, x2, which every thread publishes to a
//    double-buffered shared int4 each diagonal.  The values other lanes
//    read -- x, v, x2 at st - 1 of the next diagonal and the H0 walk's
//    v[t0], u[t0 + 1] -- are known a diagonal ahead, so their owner thread
//    exports them to shared scalars; every thread computes the per-job
//    scalars itself, the H0 walk of diagonal r at the start of r + 1.  One
//    __syncthreads a diagonal serves all of it.  The gap rows fold into
//    three-operand add-max (max(a - (z - q), 0) - q - e = max(a - z - e,
//    -q - e)).  Lanes stay int32: the band's 16-aligned edges [st, st0)
//    and (en0, en] update lanes outside the DP matrix, whose y and y2
//    reach 117 and 149 with map-ont scoring (scripts/torch_extd2_ranges.py),
//    so int8 lanes, as in ksw2's SSE code and exts2.cu, would change those
//    lanes' direction bytes (the matrix cells and ez would agree).
// 3. Memory traffic.  The rows are circular in the lanes: physical slot ph
//    holds target position t with t = ph (mod W), so the chunk shift by dsh
//    moves no data: the groups whose lanes wrap take the fill values (on
//    the shift's diagonal no band lane and no boundary lane has wrapped:
//    the band ends at most w + 30 lanes past the new origin, and W - dsh >
//    w + 30 by _check).  Every thread stores its GL direction bytes each
//    diagonal (0 off the band) with one store, and the block zeroes the
//    rows past its job's end, so p needs no memset.
// A group rewrites the score row only where it meets [st0, s_hi] (which can
// pass en) and updates its rows only inside [st, en] (16-aligned, so a
// group is wholly in or out); other lanes keep their registers, which is
// what the reference leaves there.  The job's target (zero past TP) and
// reversed query (zero outside [0, qlen)) sit in shared memory.  A job
// stops at its first dead diagonal.  (8 and 16 lanes a thread were
// slower on the card: fewer warps, each with a longer serial path.)
// Resources (`nvcc -Xptxas -v` for sm_90a, printed by chip_smoke.py's
// build phase), the -c/-a path's instantiation <false, false, false>: at
// GL = 4, 64 registers a thread, no spills; 30,336 bytes
// of dynamic shared memory a block at QP=12288, TP=12800, W=640 (2 W/GL
// int4 + 64 + TP + QP + 64), so 6 blocks of 160 threads fit on an SM
// (register-bound; cudaOccupancyMaxActiveBlocksPerMultiprocessor through
// mm2_extd2_occupancy).  The exact instantiations add 2 x 8 x 2 ints of
// shared memory for the warps' maxima; PERF.md lists every
// instantiation's registers.
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF32 = -0x40000000;
constexpr int EZ_N = 16;
constexpr int GL = 4;           // lanes a thread
constexpr int MAX_T = 256;      // threads a block: W <= 1024
constexpr int QM = 16;          // zero bytes before the query in shared memory
constexpr int QTAIL = 48;       // and after it
constexpr int NX = 8;           // exported scalars a diagonal: 7 used, 8
                                // keep the planes after them 16-byte aligned
constexpr int NWARP = MAX_T / 32;
constexpr int NRED = 2 * NWARP * 2;   // [2][warp] (max, key) of the H row

__device__ __forceinline__ int sext8(int v) {
  return (int)(signed char)(v & 255);
}

// lane i (0 .. GL - 1) of a thread's registers
__device__ __forceinline__ int lane_of(const int (&a)[GL], unsigned i) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < GL; ++k)
    if (i == k) v = a[k];
  return v;
}

// uniform window start of diagonal r (>> on int is arithmetic: floor)
__device__ __forceinline__ int wstart(int r, int w) {
  const int a = (r - w + 1) >> 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

// greedy H0 walk of one live diagonal pr (extend_pallas2.py:450-491) from
// the bytes its owners exported: hv = v[t0] (v at lane 0 on diagonal 0)
// and hu = u[t0 + 1]
__device__ __forceinline__ void h0_walk(int hv, int hu, int W, int pr,
                                        int pws, int pst0, int pen0,
                                        bool pfin, int qe, int& H0, int& h0t,
                                        int& score) {
  if (pr == 0) {
    H0 = hv - qe;
    h0t = 0;
  } else {
    const int lx = h0t + 1 - pws;
    const bool ok = lx >= 0 && lx < W;
    const int d0 = ok ? hv : 0, d1 = ok ? hu : 0;
    const bool in0 = pst0 <= h0t && h0t <= pen0;
    const bool in1 = pst0 <= h0t + 1 && h0t + 1 <= pen0;
    const bool case12 = in0 && in1;
    const bool step_t = case12 && d1 >= d0;
    H0 += case12 ? (step_t ? d1 : d0) : (in0 ? d0 : d1);
    h0t += (step_t || !in0) ? 1 : 0;
  }
  if (pfin) score = H0;
}

// ksw_apply_zdrop (ksw2.h:171-187) on diagonal r's maximum H at t: true
// when the job z-drops
__device__ __forceinline__ bool apply_zdrop(int H, int t, int r, int zdrop,
                                            int e2, int& mx, int& mxt,
                                            int& mxq) {
  if (H > mx) {
    mx = H;
    mxt = t;
    mxq = r - t;
    return false;
  }
  if (zdrop < 0 || t < mxt || r - t < mxq) return false;
  const int l = abs((t - mxt) - (r - t - mxq));
  return mx - H > zdrop + l * e2;
}

// (the approx instantiations at most 64 registers, 4 blocks of MAX_T: the
// -c/-a path's keeps its occupancy)
template <bool EXACT, bool RIGHT, bool ADROP>
__global__ void __launch_bounds__(MAX_T, EXACT ? 1 : 4) extd2_kernel(
    const uint8_t* __restrict__ qr, const uint8_t* __restrict__ sf,
    const int* __restrict__ lens, const int* __restrict__ order,
    uint8_t* __restrict__ p, int* __restrict__ ez, int QP, int TP, int W,
    int RB, int RT, int w, int q, int e, int q2, int e2, int long_thres,
    int long_diff, int sc_mch, int sc_mis, int sc_N, int with_cigar,
    int zdrop) {
  extern __shared__ uint4 smem[];
  const int NG = W / GL, TPP = (TP + 15) & ~15, NW = NG / 32;
  int4* edge = reinterpret_cast<int4*>(smem);           // [2][NG] x, v, x2, H
  int* xs = reinterpret_cast<int*>(edge + 2 * NG);      // [2][NX]
  int* red = xs + 2 * NX;                               // [2][NW][2], EXACT
  uint8_t* ts = reinterpret_cast<uint8_t*>(red + (EXACT ? NRED : 0));
  uint8_t* qs = ts + TPP;                               // QM + QP + QTAIL

  const int g = threadIdx.x;
  const int n = order[blockIdx.x];
  const int qlen = lens[2 * n], tlen = lens[2 * n + 1];
  const int rstar = qlen + tlen - 1;
  for (int i = g; i < TPP; i += NG)
    ts[i] = i < TP ? sf[(size_t)n * TP + i] : 0;
  for (int i = g; i < QP + QM + QTAIL; i += NG) {
    const int j = i - QM;
    qs[i] = (j >= 0 && j < qlen) ? qr[(size_t)n * QP + j] : 0;
  }
  uint8_t* prow = p + (size_t)n * RT * W;

  const int qe = q + e, qe2 = q2 + e2;
  int U[GL], V[GL], X[GL], Y[GL], X2[GL], Y2[GL], S[GL], H[GL];
#pragma unroll
  for (int i = 0; i < GL; ++i) {
    U[i] = V[i] = X[i] = Y[i] = -qe;
    X2[i] = Y2[i] = -qe2;
    S[i] = 0;
    H[i] = NEG_INF32;
  }
  edge[NG + g] = make_int4(-qe, -qe, -qe2, NEG_INF32);   // "before" r = 0
  int zdr = 0, last_st = 0, nr = 0, H0 = 0, h0t = 0, score = NEG_INF32;
  // ez lanes of the exact and approx-drop modes, and the z-drop flag
  int mx = 0, mxq = -1, mxt = -1, mqe = NEG_INF32, mqet = -1;
  int mte = NEG_INF32, mteq = -1, zflag = 0;
  // the per-job step of the previous diagonal (the H0 walk, or the H row's
  // maximum and lanes), run after the next barrier; true on a z-drop
  int pw_r = -1, pw_ws = 0, pw_st0 = 0, pw_en0 = 0;
  bool pw_fin = false;
  auto step = [&](const int* xp, const int* rp) -> bool {
    int mH, mt;
    if constexpr (EXACT) {
      mH = INT_MIN;
      int k = INT_MIN;
      for (int i = 0; i < NW; ++i) {
        const int vm = rp[2 * i], vk = rp[2 * i + 1];
        if (vm > mH || (vm == mH && vk > k)) {
          mH = vm;
          k = vk;
        }
      }
      mt = k == INT_MAX ? pw_en0 : -k;
      const int hen0 = xp[5], hst0 = xp[6];
      if (pw_en0 == tlen - 1 && hen0 > mte) {
        mte = hen0;
        mteq = pw_r - pw_en0;
      }
      if (pw_r - pw_st0 == qlen - 1 && hst0 > mqe) {
        mqe = hst0;
        mqet = pw_st0;
      }
      if (pw_fin) score = hen0;
    } else {
      h0_walk(xp[3], xp[4], W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe, H0,
              h0t, score);
      mH = H0;
      mt = h0t;
    }
    if constexpr (EXACT || ADROP) {
      if (apply_zdrop(mH, mt, pw_r, zdrop, e2, mx, mxt, mxq)) {
        zdr = zflag = 1;
        return true;
      }
    }
    return false;
  };
  int ws = 0, off = 0;        // window start and its physical slot
  int rc = 0;                 // r % RB
  int l0 = g * GL, t0 = l0;   // this thread's first logical lane, position
  __syncthreads();

  int r = 0;
  for (; r < RT; ++r) {
    const int cur = r & 1, prv = cur ^ 1;
    const int* xp = xs + NX * prv;
    if (pw_r >= 0) {
      const bool dropped = step(xp, red + 2 * NWARP * prv);
      pw_r = -1;
      if (dropped) break;
    }
    // band of diagonal r (the same in every thread: uniform break)
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    if (r >= rstar || st0 > en0) {
      if (r < rstar) zdr = 1;      // the band died before the last cell
      break;
    }
    // chunk boundary: the window moves right by dsh lanes (chunk_shift,
    // :186-200); the dsh slots that wrap take the fill values below.  On
    // that diagonal the band ends at most w + 30 lanes past the new origin
    // and the wrapped lanes start at W - dsh >= w + 48 + drift - dsh >
    // w + 30 (_check: W >= w + 48 + drift, dsh <= drift + 15), so neither
    // a band lane's left neighbour nor the boundary lane st - 1 has wrapped
    if (rc == 0 && r > 0) {
      const int ws_new = wstart(r, w);
      const int dsh = ws_new - ws;
      ws = ws_new;
      off += dsh;
      if (off >= W) off -= W;
      l0 = g * GL - off;
      if (l0 < 0) l0 += W;
      t0 = ws + l0;
      if (l0 >= W - dsh) {        // the shift's fill values
#pragma unroll
        for (int i = 0; i < GL; ++i) {
          U[i] = V[i] = X[i] = Y[i] = -qe;
          X2[i] = Y2[i] = -qe2;
          S[i] = 0;
          H[i] = NEG_INF32;
        }
      }
    }
    if (++rc == RB) rc = 0;
    const int st = (st0 >> 4) << 4;
    const int en = (((en0 + 16) >> 4) << 4) - 1;
    // boundary values at st - 1 (0 left of the window, else what the owner
    // exported on diagonal r - 1)
    const bool use_prev = st - last_st == 16 && st > 0;
    const bool pre_ok = st - 1 - ws >= 0;
    // v at lane st (st == 0) and u at lane r start the diagonal's long-gap
    // ramp: -q-e, then -e below long_thres, long_diff at it, -e2 above
    const int v1_edge = r == 0 ? -qe
                        : r < long_thres ? -e
                        : r == long_thres ? long_diff : -e2;
    const int s_hi = st0 + (((en0 - st0) >> 4) << 4) + 15;

    if (t0 + GL - 1 >= st0 && t0 <= s_hi) {
      // score row: only [st0, s_hi] is rewritten; other lanes keep stale s
      const uint32_t Tw =
          t0 < TPP ? *reinterpret_cast<const uint32_t*>(ts + t0) : 0u;
      // reversed-query bytes qi0 .. qi0 + GL - 1, qi0 = t0 - r + qlen - 1
      // >= -15 (the query position of lane t is r - t)
      const int o = QM + t0 - r + qlen - 1;
      const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs + (o & ~3));
      const uint32_t Qw = __funnelshift_r(q32[0], q32[1], (o & 3) * 8);
      // lanes lo .. hi - 1 of the group lie in [st0, s_hi]
      const int lo = max(st0 - t0, 0), hi = min(s_hi - t0 + 1, GL);
      int sv[GL];
#pragma unroll
      for (int i = 0; i < GL; ++i) {
        const int tq = (Tw >> (8 * i)) & 255, qq = (Qw >> (8 * i)) & 255;
        sv[i] = (tq == 4 || qq == 4) ? sc_N : tq == qq ? sc_mch : sc_mis;
      }
      if (lo == 0 && hi == GL) {
#pragma unroll
        for (int i = 0; i < GL; ++i) S[i] = sv[i];
      } else {
#pragma unroll
        for (int i = 0; i < GL; ++i)
          if (i >= lo && i < hi) S[i] = sv[i];
      }
    }
    uint32_t P = 0u;               // direction bytes: 0 off the band
    int hb = INT_MIN, hk = INT_MIN;  // EXACT: best H of [st0, en0], its key
    int* xc = xs + NX * cur;
    if (t0 >= st && t0 <= en) {
      // the left neighbour of lane l0: the boundary values at st, else the
      // previous group's last lane (lane 0 in the band is lane st - ws, so
      // l0 >= GL there)
      // (the exact mode reads the previous group's H in either case)
      int4 E;
      if constexpr (EXACT) E = edge[NG * prv + (g == 0 ? NG - 1 : g - 1)];
      int xl, vl, x2l;
      if (t0 == st) {
        xl = use_prev ? (pre_ok ? xp[0] : 0) : -qe;
        vl = use_prev ? (pre_ok ? xp[1] : 0) : (st > 0 ? -qe : v1_edge);
        x2l = use_prev ? (pre_ok ? xp[2] : 0) : -qe2;
      } else {
        if constexpr (!EXACT) E = edge[NG * prv + (g == 0 ? NG - 1 : g - 1)];
        xl = E.x; vl = E.y; x2l = E.z;
      }
      // y, y2 and u reset at lane r (which lies in [st, en] when en >= r)
      const int ir = r - t0;
      if (en >= r && ir < GL) {
#pragma unroll
        for (int i = 0; i < GL; ++i) {
          if (i == ir) {
            Y[i] = -qe;
            Y2[i] = -qe2;
            U[i] = v1_edge;
          }
        }
      }
      // lanes from the last down, so lane i reads lane i - 1's old x, v, x2
#pragma unroll
      for (int i = GL - 1; i >= 0; --i) {
        const int xt1 = i ? X[i - 1] : xl, vt1 = i ? V[i - 1] : vl;
        const int x2t1 = i ? X2[i - 1] : x2l;
        const int y_p = Y[i], y2_p = Y2[i], u_p = U[i];
        const int a = xt1 + vt1, b = y_p + u_p, a2 = x2t1 + vt1,
                  b2 = y2_p + u_p;
        int z = S[i], d = 0;
        if constexpr (RIGHT) {
          d = z > a ? 0 : 1;
          z = max(z, a);
          d = z > b ? d : 2;
          z = max(z, b);
          d = z > a2 ? d : 3;
          z = max(z, a2);
          d = z > b2 ? d : 4;
        } else {
          if (a > z) d = 1;
          z = max(z, a);
          if (b > z) d = 2;
          z = max(z, b);
          if (a2 > z) d = 3;
          z = max(z, a2);
          if (b2 > z) d = 4;
        }
        z = min(max(z, b2), sc_mch);
        U[i] = z - vt1;
        V[i] = z - u_p;
        // max(a - (z - q), 0) - q - e = max(a - z - e, -q - e), and the
        // continuation bit a - (z - q) > 0 is x > -q - e (>= 0 under
        // RIGHT: a - z - e >= -q - e before the max)
        const int ze = -(z + e), ze2 = -(z + e2);
        if constexpr (RIGHT) {
          d |= (a + ze >= -qe ? 0x08 : 0) | (b + ze >= -qe ? 0x10 : 0)
               | (a2 + ze2 >= -qe2 ? 0x20 : 0)
               | (b2 + ze2 >= -qe2 ? 0x40 : 0);
        }
        X[i] = __viaddmax_s32(a, ze, -qe);
        Y[i] = __viaddmax_s32(b, ze, -qe);
        X2[i] = __viaddmax_s32(a2, ze2, -qe2);
        Y2[i] = __viaddmax_s32(b2, ze2, -qe2);
        if constexpr (!RIGHT)
          d |= (X[i] > -qe ? 0x08 : 0) | (Y[i] > -qe ? 0x10 : 0)
               | (X2[i] > -qe2 ? 0x20 : 0) | (Y2[i] > -qe2 ? 0x40 : 0);
        P |= (uint32_t)d << (8 * i);
      }
      if constexpr (EXACT) {
        // H row (:398-420): the body [st0, en0) adds v, en0 takes h_en0
        if (t0 + GL - 1 >= st0 && t0 <= en0) {
          int Hp[GL];
#pragma unroll
          for (int i = 0; i < GL; ++i) Hp[i] = H[i];
#pragma unroll
          for (int i = 0; i < GL; ++i) {
            const int t = t0 + i;
            if (t == en0) {
              int h;
              if (r == 0) {
                h = V[i] - qe;
              } else if (en0 > 0) {
                const int hm1 = i ? Hp[i ? i - 1 : 0]
                                  : (en0 - 1 - ws >= 0 ? E.w : 0);
                h = hm1 + sext8(U[i]);
              } else {
                h = Hp[i] + sext8(V[i]);
              }
              H[i] = h;
              xc[5] = h;
            } else if (t >= st0 && t < en0) {
              H[i] = Hp[i] + V[i];
            }
            if (t == st0) xc[6] = H[i];
            if (t >= st0 && t <= en0) {
              const int k = t == en0 ? INT_MAX : -t;
              if (H[i] > hb || (H[i] == hb && k > hk)) {
                hb = H[i];
                hk = k;
              }
            }
          }
        }
      }
    }
    if constexpr (EXACT) {
      // each warp's (max, key); the block's at the next diagonal's start
      const int m = __reduce_max_sync(0xFFFFFFFFu, hb);
      const int k = __reduce_max_sync(0xFFFFFFFFu, hb == m ? hk : INT_MIN);
      if ((g & 31) == 0) {
        red[2 * (NWARP * cur + (g >> 5))] = m;
        red[2 * (NWARP * cur + (g >> 5)) + 1] = k;
      }
    }
    if (with_cigar) *reinterpret_cast<uint32_t*>(prow + l0) = P;
    edge[NG * cur + g] =
        make_int4(X[GL - 1], V[GL - 1], X2[GL - 1], EXACT ? H[GL - 1] : 0);
    // exports for the next diagonal: x, v, x2 at st(r + 1) - 1 (in this
    // diagonal's window) and the H0 walk's v[t0], u[t0 + 1] of this one
    const int st0n = max(max(0, r + 2 - qlen), (r + 2 - w) >> 1);
    // (a thread's lanes are the logical lanes l0 .. l0 + GL - 1)
    const unsigned ib = ((st0n >> 4) << 4) - 1 - t0;
    if (ib < GL) {
      xc[0] = sext8(lane_of(X, ib));
      xc[1] = sext8(lane_of(V, ib));
      xc[2] = sext8(lane_of(X2, ib));
    }
    if constexpr (!EXACT) {
      const int lx = r == 0 ? 1 : h0t + 1 - ws;
      if (lx >= 0 && lx < W) {
        const unsigned iv = (lx == 0 ? W - 1 : lx - 1) - l0, iu = lx - l0;
        if (iv < GL) xc[3] = sext8(lane_of(V, iv));
        if (iu < GL && r > 0) xc[4] = sext8(lane_of(U, iu));
      }
    }
    prow += W;
    pw_r = r; pw_ws = ws; pw_st0 = st0; pw_en0 = en0;
    pw_fin = r == rstar - 1 && en0 == tlen - 1;
    last_st = st;
    nr = r + 1;
    __syncthreads();
  }
  if (with_cigar) {          // rows past the job's end are 0
    uint4* z4 = reinterpret_cast<uint4*>(prow);
    const size_t n16 = (size_t)(RT - r) * W / 16;
    for (size_t i = g; i < n16; i += NG) z4[i] = make_uint4(0, 0, 0, 0);
  }
  if (pw_r >= 0)             // every diagonal was live: the last one's step
    step(xs + NX * ((r - 1) & 1), red + 2 * NWARP * ((r - 1) & 1));
  if (g == 0) {
    int* o = ez + (size_t)n * EZ_N;
    const int vals[EZ_N] = {mx, zdr, mxq, mxt, mqe, mqet, mte, mteq,
                            score, last_st, 0, nr, H0, h0t, zflag, 0};
    for (int i = 0; i < EZ_N; ++i) o[i] = vals[i];
  }
}

using Extd2Fn = void (*)(const uint8_t*, const uint8_t*, const int*,
                         const int*, uint8_t*, int*, int, int, int, int, int,
                         int, int, int, int, int, int, int, int, int, int,
                         int, int);

// the instantiation of a mode (approx_drop counts only in the approx mode)
inline Extd2Fn extd2_variant(int exact, int right, int adrop) {
  if (exact)
    return right ? extd2_kernel<true, true, false>
                 : extd2_kernel<true, false, false>;
  if (adrop)
    return right ? extd2_kernel<false, true, true>
                 : extd2_kernel<false, false, true>;
  return right ? extd2_kernel<false, true, false>
               : extd2_kernel<false, false, false>;
}

}  // namespace

// threads and dynamic shared memory of a launch at these widths (W % 128
// == 0 keeps the shared planes 16-byte aligned)
static int launch_shape(Extd2Fn fn, int exact, int W, int QP, int TP,
                        int* threads, size_t* smem) {
  if (W % 128 || W / GL > MAX_T) return (int)cudaErrorInvalidValue;
  *threads = W / GL;
  *smem = (size_t)2 * *threads * sizeof(int4) + 2 * NX * 4
          + (exact ? NRED * 4 : 0)
          + (size_t)((TP + 15) & ~15) + QP + QM + QTAIL;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

extern "C" int mm2_extd2(const void* qr, const void* sf, const void* lens,
                         const void* order, void* p, void* ez, int N, int QP,
                         int TP, int W, int RB, int RT, int w, int q, int e,
                         int q2, int e2, int long_thres, int long_diff,
                         int sc_mch, int sc_mis, int sc_N, int with_cigar,
                         int exact, int right, int adrop, int zdrop,
                         void* stream) {
  if (N == 0) return 0;
  const Extd2Fn fn = extd2_variant(exact, right, adrop);
  int threads;
  size_t smem;
  const int err = launch_shape(fn, exact, W, QP, TP, &threads, &smem);
  if (err) return err;
  fn<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)qr, (const uint8_t*)sf, (const int*)lens,
      (const int*)order, (uint8_t*)p, (int*)ez, QP, TP, W, RB, RT, w, q, e,
      q2, e2, long_thres, long_diff, sc_mch, sc_mis, sc_N, with_cigar, zdrop);
  return (int)cudaGetLastError();
}

// blocks of a mode's kernel one SM holds at once at these widths (mode =
// exact | right << 1 | adrop << 2)
extern "C" int mm2_extd2_occupancy(int W, int QP, int TP, int mode,
                                   int* blocks) {
  const Extd2Fn fn = extd2_variant(mode & 1, mode >> 1 & 1, mode >> 2 & 1);
  int threads;
  size_t smem;
  const int err = launch_shape(fn, mode & 1, W, QP, TP, &threads, &smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, threads, smem);
}
