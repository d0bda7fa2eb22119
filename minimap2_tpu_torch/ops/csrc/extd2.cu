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
//
// Every W and every QP, TP: three routes, picked by the shapes alone
// (plan_of, the first whose block holds the job):
// - REG: the design above, W / 4 threads a block, as many as the
//   instantiation's registers allow (cudaFuncGetAttributes'
//   maxThreadsPerBlock: 1024 for the approx modes, capped at 64
//   registers, fewer for the exact ones), planes staged in shared memory.
// - REG_GP: the same with the target and query read from device memory
//   (__ldg, a byte at a time with the bounds the staged planes had) when
//   they pass the 227 KB a block may stage (QP + TP past ~225,000: reads
//   past ~110 kb at QP = L, TP = L + 512).  The row buffers stay shared.
// - SLAB: past the threads one block holds (W past 4096 in the approx
//   modes).  The job's eight rows (u v x y x2 y2 s H) live in device
//   memory, physical slots as above, and T threads walk the groups the
//   diagonal changes -- those meeting [st, en] or [st0, s_hi], and the
//   ones that wrap -- a group at a time: load its four lanes a row, run
//   the same update, store them back, in place (one thread a group a
//   diagonal).  A group's left neighbour as diagonal r - 1 left it is the
//   edge that r - 1 wrote to device memory if r - 1 updated it, the fill
//   values if it lies past r - 1's band (nothing has touched it since it
//   last wrapped), else its rows, which nothing writes on diagonal r (it
//   lies left of the band); the H0 walk's lanes in groups the diagonal
//   leaves alone come from their rows the same way.  The planes come from
//   device memory, and p comes zeroed from the wrapper (the walk stores
//   band groups only).  Why not a thread-block cluster: 8 blocks (the
//   portable cluster) of the exact instantiations' ~736 threads reach
//   23,552 lanes, short of W 32768, and a bigger cluster is not portable;
//   the slab route takes any W, its work a diagonal follows the band, not
//   W, and a job's rows (36 W bytes with the edges) stay in L2 at the
//   widths the presets reach.  It pays a load and a store of each band
//   lane's rows a diagonal.
// Resources (`nvcc -Xptxas -v` for sm_90a, printed by chip_smoke.py's
// build phase), no spills in any instantiation
// <EXACT, RIGHT, ADROP> on a route: REG approx 61-64 registers (the -c/-a
// path's <0,0,0> 61), exact 77 and 80; REG_GP approx 59-64, exact 72;
// SLAB approx 102-119 (bounded at 512 threads), exact 111 and 118.  The
// -c/-a path's launch at QP=12288, TP=12800, W=640 takes 30,336 bytes of
// dynamic shared memory a block (2 W/GL int4 + 64 + TP + QP + 64), so 6
// blocks of 160 threads fit on an SM (register-bound;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor through mm2_extd2_plan).
// The exact instantiations add 2 x 32 x 2 ints for the warps' maxima;
// REG_GP keeps the edge rows only, SLAB the scalars (64 or 576 bytes) and
// 32 W + 8 W bytes of rows and edges a job in device memory.
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF32 = -0x40000000;
constexpr int EZ_N = 16;
constexpr int GL = 4;           // lanes a thread (a group)
constexpr int MAX_T = 1024;     // threads a block
constexpr int QM = 16;          // zero bytes before the query in shared memory
constexpr int QTAIL = 48;       // and after it
constexpr int NX = 8;           // exported scalars a diagonal: 7 used, 8
                                // keep the planes after them 16-byte aligned
constexpr int NWARP = MAX_T / 32;
constexpr int NRED = 2 * NWARP * 2;   // [2][warp] (max, key) of the H row
constexpr int NROW = 8;         // the slab route's rows: U V X Y X2 Y2 S H

// the routes: a job's lanes in registers with its planes staged in shared
// memory, the same with the planes read from device memory, or the rows
// in device memory, walked a group at a time (the slab route)
enum Route { REG = 0, REG_GP = 1, SLAB = 2 };

struct Extd2Args {
  const uint8_t* qr;
  const uint8_t* sf;
  const int* lens;
  const int* order;
  uint8_t* p;
  int* ez;
  int* rows;          // the slab route's rows and edges, one slice a job
  int QP, TP, W, RB, RT, w, q, e, q2, e2, long_thres, long_diff, sc_mch,
      sc_mis, sc_N, with_cigar, zdrop;
};

// threads, dynamic shared memory and device-memory scratch (bytes a job)
// of a launch on a route
struct Plan {
  int route, threads;
  size_t smem, scratch;
};

// the route a shape takes: the first of REG, REG_GP, SLAB whose block
// holds it.  tmax[route]: the threads an instantiation of the route takes
// at most (a multiple of 32); smax: the shared memory a block may use
__host__ __device__ inline Plan plan_of(int exact, int W, int QP, int TP,
                                        const int* tmax, size_t smax) {
  const int NG = W / GL;
  const size_t xs = 2 * NX * 4 + (exact ? NRED * 4 : 0);
  const size_t rows = (size_t)2 * NG * sizeof(int4) + xs;
  const size_t planes = (size_t)((TP + 15) & ~15) + QP + QM + QTAIL;
  if (NG <= tmax[REG] && rows + planes <= smax)
    return {REG, NG, rows + planes, 0};
  if (NG <= tmax[REG_GP] && rows <= smax) return {REG_GP, NG, rows, 0};
  return {SLAB, NG < tmax[SLAB] ? NG : tmax[SLAB], xs,
          ((size_t)NROW * W + (size_t)2 * NG * 4) * 4};
}

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

// 4 plane bytes from j on, 0 outside [0, len) (read-only: __ldg)
__device__ __forceinline__ uint32_t gbytes4(const uint8_t* base, int j,
                                            int len) {
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if ((unsigned)(j + i) < (unsigned)len)
      v |= (uint32_t)__ldg(base + j + i) << (8 * i);
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

// a group's four lanes of one row from / to the slab route's rows
__device__ __forceinline__ void ld4(int (&a)[GL], const int* p) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void st4(int* p, const int (&a)[GL]) {
  *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ uint4* dyn_smem() {
  extern __shared__ uint4 smem[];
  return smem;
}

// fill values of a group's rows (the initial state and the lanes that
// wrap on a chunk shift)
__device__ __forceinline__ void fill_group(int (&U)[GL], int (&V)[GL],
                                           int (&X)[GL], int (&Y)[GL],
                                           int (&X2)[GL], int (&Y2)[GL],
                                           int (&S)[GL], int (&H)[GL],
                                           int qe, int qe2) {
#pragma unroll
  for (int i = 0; i < GL; ++i) {
    U[i] = V[i] = X[i] = Y[i] = -qe;
    X2[i] = Y2[i] = -qe2;
    S[i] = 0;
    H[i] = NEG_INF32;
  }
}

template <bool EXACT, bool RIGHT, bool ADROP, int ROUTE>
__device__ __forceinline__ void extd2_body(const Extd2Args& A) {
  constexpr bool SL = ROUTE == SLAB;
  const int QP = A.QP, TP = A.TP, W = A.W, RB = A.RB, RT = A.RT, w = A.w;
  const int e = A.e, e2 = A.e2, long_thres = A.long_thres;
  const int long_diff = A.long_diff, sc_mch = A.sc_mch, sc_mis = A.sc_mis;
  const int sc_N = A.sc_N, with_cigar = A.with_cigar, zdrop = A.zdrop;
  uint4* smem = dyn_smem();
  const int NG = W / GL, TPP = (TP + 15) & ~15;
  const int T = blockDim.x, NW = T / 32;
  int4* edge = reinterpret_cast<int4*>(smem);           // [2][NG] x, v, x2, H
  int* xs = reinterpret_cast<int*>(edge + (SL ? 0 : 2 * NG));   // [2][NX]
  int* red = xs + 2 * NX;                               // [2][NW][2], EXACT
  uint8_t* ts = reinterpret_cast<uint8_t*>(red + (EXACT ? NRED : 0));
  uint8_t* qs = ts + TPP;                               // QM + QP + QTAIL

  const int g = threadIdx.x;
  const int n = A.order[blockIdx.x];
  const int qlen = A.lens[2 * n], tlen = A.lens[2 * n + 1];
  const int rstar = qlen + tlen - 1;
  const uint8_t* sfn = A.sf + (size_t)n * TP;
  const uint8_t* qrn = A.qr + (size_t)n * QP;
  if constexpr (ROUTE == REG) {
    for (int i = g; i < TPP; i += T) ts[i] = i < TP ? sfn[i] : 0;
    for (int i = g; i < QP + QM + QTAIL; i += T) {
      const int j = i - QM;
      qs[i] = (j >= 0 && j < qlen) ? qrn[j] : 0;
    }
  }
  uint8_t* prow = A.p + (size_t)n * RT * W;
  // the slab route's rows [NROW][W] (physical slots) and edges [2][NG]
  int* rw = A.rows + (SL ? (size_t)n * (NROW * (size_t)W + 8 * (size_t)NG)
                         : 0);
  int4* gedge = reinterpret_cast<int4*>(rw + NROW * (size_t)W);

  const int qe = A.q + e, qe2 = A.q2 + e2;
  int U[GL], V[GL], X[GL], Y[GL], X2[GL], Y2[GL], S[GL], H[GL];
  fill_group(U, V, X, Y, X2, Y2, S, H, qe, qe2);
  if constexpr (SL) {
    for (int i = g; i < NG; i += T)
#pragma unroll
      for (int k = 0; k < NROW; ++k) {
        const int f = k < 4 ? -qe : k < 6 ? -qe2 : k == 6 ? 0 : NEG_INF32;
        reinterpret_cast<int4*>(rw + (size_t)k * W)[i] =
            make_int4(f, f, f, f);
      }
  } else {
    edge[NG + g] = make_int4(-qe, -qe, -qe2, NEG_INF32);   // "before" r = 0
  }
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
  int pst = 0, pen = -1;      // [st, en] of the previous diagonal
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
    // :186-200); the dsh slots that wrap take the fill values.  On that
    // diagonal the band ends at most w + 30 lanes past the new origin and
    // the wrapped lanes start at W - dsh >= w + 48 + drift - dsh > w + 30
    // (_check: W >= w + 48 + drift, dsh <= drift + 15), so neither a band
    // lane's left neighbour nor the boundary lane st - 1 has wrapped
    int dsh = 0;
    if (rc == 0 && r > 0) {
      const int ws_new = wstart(r, w);
      dsh = ws_new - ws;
      ws = ws_new;
      off += dsh;
      if (off >= W) off -= W;
      if constexpr (!SL) {
        l0 = g * GL - off;
        if (l0 < 0) l0 += W;
        t0 = ws + l0;
        if (l0 >= W - dsh) fill_group(U, V, X, Y, X2, Y2, S, H, qe, qe2);
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
    int hb = INT_MIN, hk = INT_MIN;  // EXACT: best H of [st0, en0], its key
    int* xc = xs + NX * cur;
    const int st0n = max(max(0, r + 2 - qlen), (r + 2 - w) >> 1);

    // one group's diagonal (its lanes at positions t0 .. t0 + GL - 1;
    // fetch_e: the left group's last x, v, x2 and H as diagonal r - 1 left
    // them, fetched where the group needs them).  Returns the direction
    // bytes (0 off the band).
    auto group = [&](int (&U)[GL], int (&V)[GL], int (&X)[GL], int (&Y)[GL],
                     int (&X2)[GL], int (&Y2)[GL], int (&S)[GL], int (&H)[GL],
                     int t0, auto fetch_e) -> uint32_t {
      if (t0 + GL - 1 >= st0 && t0 <= s_hi) {
        // score row: only [st0, s_hi] is rewritten; other lanes keep stale s
        uint32_t Tw, Qw;
        if constexpr (ROUTE == REG) {
          Tw = t0 < TPP ? *reinterpret_cast<const uint32_t*>(ts + t0) : 0u;
          // reversed-query bytes qi0 .. qi0 + GL - 1, qi0 = t0 - r + qlen
          // - 1 >= -15 (the query position of lane t is r - t)
          const int o = QM + t0 - r + qlen - 1;
          const uint32_t* q32 =
              reinterpret_cast<const uint32_t*>(qs + (o & ~3));
          Qw = __funnelshift_r(q32[0], q32[1], (o & 3) * 8);
        } else {
          Tw = gbytes4(sfn, t0, TP);
          Qw = gbytes4(qrn, t0 - r + qlen - 1, qlen);
        }
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
      uint32_t P = 0u;
      if (t0 >= st && t0 <= en) {
        // the left neighbour of lane l0: the boundary values at st, else
        // the previous group's last lane (lane 0 in the band is lane st -
        // ws, so l0 >= GL there); the exact mode reads the previous
        // group's H in either case
        int4 E = make_int4(0, 0, 0, 0);
        if constexpr (EXACT) E = fetch_e();
        int xl, vl, x2l;
        if (t0 == st) {
          xl = use_prev ? (pre_ok ? xp[0] : 0) : -qe;
          vl = use_prev ? (pre_ok ? xp[1] : 0) : (st > 0 ? -qe : v1_edge);
          x2l = use_prev ? (pre_ok ? xp[2] : 0) : -qe2;
        } else {
          if constexpr (!EXACT) E = fetch_e();
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
        // lanes from the last down, so lane i reads lane i - 1's old x, v,
        // x2
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
      return P;
    };
    // exports for the next diagonal from a group's registers: x, v, x2 at
    // st(r + 1) - 1 (in this diagonal's window) and the H0 walk's v[t0],
    // u[t0 + 1] of this one
    const int lx = r == 0 ? 1 : h0t + 1 - ws;
    const int iv = lx == 0 ? W - 1 : lx - 1;
    auto exports = [&](const int (&U)[GL], const int (&V)[GL],
                       const int (&X)[GL], const int (&X2)[GL], int l0,
                       int t0) {
      // (a thread's lanes are the logical lanes l0 .. l0 + GL - 1)
      const unsigned ib = ((st0n >> 4) << 4) - 1 - t0;
      if (ib < GL) {
        xc[0] = sext8(lane_of(X, ib));
        xc[1] = sext8(lane_of(V, ib));
        xc[2] = sext8(lane_of(X2, ib));
      }
      if constexpr (!EXACT) {
        if (lx >= 0 && lx < W) {
          const unsigned jv = iv - l0, ju = lx - l0;
          if (jv < GL) xc[3] = sext8(lane_of(V, jv));
          if (ju < GL && r > 0) xc[4] = sext8(lane_of(U, ju));
        }
      }
    };

    if constexpr (!SL) {
      const int4* ep = edge + NG * prv + (g == 0 ? NG - 1 : g - 1);
      const uint32_t P =
          group(U, V, X, Y, X2, Y2, S, H, t0, [&] { return *ep; });
      if (with_cigar) *reinterpret_cast<uint32_t*>(prow + l0) = P;
      edge[NG * cur + g] =
          make_int4(X[GL - 1], V[GL - 1], X2[GL - 1], EXACT ? H[GL - 1] : 0);
      exports(U, V, X, X2, l0, t0);
    } else {
      // the groups this diagonal changes, in logical groups: those that
      // meet [st, en] or [st0, s_hi] (one run), and the ones that wrapped
      const int jlo = max(st - ws, 0) / GL;
      const int jhi = min(max(en, s_hi) - ws, W - 1) / GL;
      const int jwr = dsh > 0 ? max((W - dsh) / GL, jhi + 1) : NG;
      const int nA = jhi - jlo + 1, nall = nA + NG - jwr;
      const int goff = off / GL;
      for (int k = g; k < nall; k += T) {
        const int j = k < nA ? jlo + k : jwr + k - nA;
        const int G = j + goff < NG ? j + goff : j + goff - NG;
        const int gl0 = j * GL, gt0 = ws + gl0;
        int* base = rw + G * GL;
        if (gl0 >= W - dsh) {
          fill_group(U, V, X, Y, X2, Y2, S, H, qe, qe2);
        } else {
          ld4(U, base); ld4(V, base + W); ld4(X, base + 2 * W);
          ld4(Y, base + 3 * W); ld4(X2, base + 4 * W); ld4(Y2, base + 5 * W);
          ld4(S, base + 6 * W); ld4(H, base + 7 * W);
        }
        // the left group's last lane as diagonal r - 1 left it: its edge
        // if r - 1 updated it, the fill values if it lies past r - 1's
        // band (never updated since it last wrapped), else its rows, which
        // nothing writes on this diagonal (it lies left of the band)
        const int Gm = G == 0 ? NG - 1 : G - 1;
        auto fetch = [&]() -> int4 {
          const int tl = gt0 - 1;
          if (tl >= pst && tl <= pen) return gedge[NG * prv + Gm];
          if (tl > pen) return make_int4(-qe, -qe, -qe2, NEG_INF32);
          const int ph = Gm * GL + GL - 1;
          return make_int4(rw[2 * W + ph], rw[W + ph], rw[4 * W + ph],
                           rw[7 * W + ph]);
        };
        const uint32_t P = group(U, V, X, Y, X2, Y2, S, H, gt0, fetch);
        st4(base, U); st4(base + W, V); st4(base + 2 * W, X);
        st4(base + 3 * W, Y); st4(base + 4 * W, X2); st4(base + 5 * W, Y2);
        st4(base + 6 * W, S); st4(base + 7 * W, H);
        if (gt0 >= st && gt0 <= en) {
          if (with_cigar) *reinterpret_cast<uint32_t*>(prow + gl0) = P;
          gedge[NG * cur + G] = make_int4(X[GL - 1], V[GL - 1], X2[GL - 1],
                                          H[GL - 1]);
        }
        exports(U, V, X, X2, gl0, gt0);
      }
      if constexpr (!EXACT) {
        // the H0 walk's lanes in groups this diagonal leaves alone: their
        // rows, which nothing writes on this diagonal
        if (g == 0 && lx >= 0 && lx < W) {
          auto kept = [&](int l) {
            const int j = l / GL;
            return !(j >= jlo && j <= jhi) && j < jwr;
          };
          auto slot = [&](int l) { return l + off < W ? l + off : l + off - W; };
          if (kept(iv)) xc[3] = sext8(rw[W + slot(iv)]);
          if (kept(lx) && r > 0) xc[4] = sext8(rw[slot(lx)]);
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
    prow += W;
    pw_r = r; pw_ws = ws; pw_st0 = st0; pw_en0 = en0;
    pw_fin = r == rstar - 1 && en0 == tlen - 1;
    last_st = st;
    pst = st;
    pen = en;
    nr = r + 1;
    __syncthreads();
  }
  if (with_cigar && !SL) {   // rows past the job's end are 0 (the slab
    uint4* z4 = reinterpret_cast<uint4*>(prow);   // route's p comes zeroed)
    const size_t n16 = (size_t)(RT - r) * W / 16;
    for (size_t i = g; i < n16; i += T) z4[i] = make_uint4(0, 0, 0, 0);
  }
  if (pw_r >= 0)             // every diagonal was live: the last one's step
    step(xs + NX * ((r - 1) & 1), red + 2 * NWARP * ((r - 1) & 1));
  if (g == 0) {
    int* o = A.ez + (size_t)n * EZ_N;
    const int vals[EZ_N] = {mx, zdr, mxq, mxt, mqe, mqet, mte, mteq,
                            score, last_st, 0, nr, H0, h0t, zflag, 0};
    for (int i = 0; i < EZ_N; ++i) o[i] = vals[i];
  }
}

// the approx instantiations at most 64 registers (1024 threads a block)
// on the register routes, 128 on the slab route (512 threads: its walk
// keeps more live, and 64 spilled); the exact ones as many as they need,
// so fewer threads
template <bool RIGHT, bool ADROP, int ROUTE>
__global__ void __launch_bounds__(ROUTE == SLAB ? MAX_T / 2 : MAX_T, 1)
    extd2_approx(Extd2Args a) {
  extd2_body<false, RIGHT, ADROP, ROUTE>(a);
}

template <bool RIGHT, int ROUTE>
__global__ void extd2_exact(Extd2Args a) {
  extd2_body<true, RIGHT, false, ROUTE>(a);
}

using Extd2Fn = void (*)(Extd2Args);

template <int ROUTE>
inline Extd2Fn extd2_route_variant(int exact, int right, int adrop) {
  if (exact)
    return right ? extd2_exact<true, ROUTE> : extd2_exact<false, ROUTE>;
  if (adrop)
    return right ? extd2_approx<true, true, ROUTE>
                 : extd2_approx<false, true, ROUTE>;
  return right ? extd2_approx<true, false, ROUTE>
               : extd2_approx<false, false, ROUTE>;
}

// the instantiation of a mode on a route (approx_drop counts only in the
// approx mode)
inline Extd2Fn extd2_variant(int exact, int right, int adrop, int route) {
  return route == REG ? extd2_route_variant<REG>(exact, right, adrop)
         : route == REG_GP ? extd2_route_variant<REG_GP>(exact, right, adrop)
                           : extd2_route_variant<SLAB>(exact, right, adrop);
}

}  // namespace

namespace {

// the launch plan of a mode at these widths on this card, its dynamic
// shared memory granted
int launch_plan(int exact, int right, int adrop, int W, int QP, int TP,
                Plan* pl) {
  if (W % 128 || W <= 0) return (int)cudaErrorInvalidValue;
  int dev, smax;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(
        &smax, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int tmax[3];
  for (int rt = 0; rt < 3 && !err; ++rt) {
    cudaFuncAttributes at;
    err = cudaFuncGetAttributes(
        &at, (const void*)extd2_variant(exact, right, adrop, rt));
    tmax[rt] = at.maxThreadsPerBlock / 32 * 32;
  }
  if (err) return (int)err;
  *pl = plan_of(exact, W, QP, TP, tmax, (size_t)smax);
  if (pl->smem > (size_t)smax) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      (const void*)extd2_variant(exact, right, adrop, pl->route),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl->smem);
}

}  // namespace

// route, threads, dynamic shared memory and scratch bytes a job of a mode
// (exact | right << 1 | adrop << 2) at these widths, and its blocks an SM
// holds at once
extern "C" int mm2_extd2_plan(int W, int QP, int TP, int mode, long long* out) {
  Plan pl;
  const int exact = mode & 1, right = mode >> 1 & 1, adrop = mode >> 2 & 1;
  int err = launch_plan(exact, right, adrop, W, QP, TP, &pl);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, extd2_variant(exact, right, adrop, pl.route), pl.threads,
      pl.smem);
  out[0] = pl.route;
  out[1] = pl.threads;
  out[2] = (long long)pl.smem;
  out[3] = (long long)pl.scratch;
  out[4] = blocks;
  return err;
}

extern "C" int mm2_extd2(const void* qr, const void* sf, const void* lens,
                         const void* order, void* p, void* ez, void* rows,
                         int N, int QP, int TP, int W, int RB, int RT, int w,
                         int q, int e, int q2, int e2, int long_thres,
                         int long_diff, int sc_mch, int sc_mis, int sc_N,
                         int with_cigar, int exact, int right, int adrop,
                         int zdrop, void* stream) {
  if (N == 0) return 0;
  Plan pl;
  const int err = launch_plan(exact, right, adrop, W, QP, TP, &pl);
  if (err) return err;
  if (pl.route == SLAB && rows == nullptr) return (int)cudaErrorInvalidValue;
  const Extd2Args a = {(const uint8_t*)qr, (const uint8_t*)sf,
                       (const int*)lens, (const int*)order, (uint8_t*)p,
                       (int*)ez, (int*)rows, QP, TP, W, RB, RT, w, q, e, q2,
                       e2, long_thres, long_diff, sc_mch, sc_mis, sc_N,
                       with_cigar, zdrop};
  extd2_variant(exact, right, adrop, pl.route)<<<N, pl.threads, pl.smem,
                                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// blocks of a mode's kernel one SM holds at once at these widths, on the
// route the widths take (mode = exact | right << 1 | adrop << 2)
extern "C" int mm2_extd2_occupancy(int W, int QP, int TP, int mode,
                                   int* blocks) {
  long long out[5];
  const int err = mm2_extd2_plan(W, QP, TP, mode, out);
  *blocks = (int)out[4];
  return err;
}
