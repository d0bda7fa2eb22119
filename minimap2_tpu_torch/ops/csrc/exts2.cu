// Splice-aware extension with direction bytes (ksw_exts2) on Hopper.
//
// Replaces minimap2_tpu/ops/exts_pallas.py: exts2_batch -> _exts2_call ->
// _exts2_kernel (the Pallas kernel at exts_pallas.py:111-425, called at
// :525) in each of its modes, one template instantiation a mode: approx-max
// (the --batch -x splice path's, with or without approx-drop) or
// exact-max, left- or right-aligned, with or without the direction matrix
// (a runtime flag).  Per anti-diagonal r the
// Suzuki-Kasahara difference rows u, v, x, y, the intron row x2 and the
// score row s advance over W lanes with int8 wrap arithmetic; the intron
// opens at q2 plus the target's acceptor value and closes against its donor
// value.  The DP is unbanded and lane l is target position wstart_q(r) + l:
// the window follows the query edge and steps by 16 lanes (the carried rows
// shift left with the fills -q-e, -q2, 0), so r - ws(r) is a sawtooth.  The
// score comes from the greedy H0 walk, or in the exact mode from the H
// row.  Outputs p (N, RT, W) u8 and ez (N, 16) i32; EZ_DEAD is set by the
// wrapper (ops/extend.py), which also zeroes p and passes the block -> job
// order.
//
// The exact mode (EXACT, :297-345): H is int32 and does not fit the packed
// byte words, so each thread keeps its 16 lanes of H in 16 more registers
// (circular like the rows; the wrapped slots take NEG_INF32, the roll's
// fill), exported and reduced as in extd2.cu: the owner of en0 computes
// h_en0 from its own u, v, H and H at en0 - 1 (its previous register, or
// the previous group's last H from a double-buffered shared int, 0 left of
// the window), the row's maximum and first argmax go through two
// __reduce_max_sync a warp into shared memory, the owners of en0 and st0
// export h_en0 and H[st0], and every thread applies them, mqe/mte, the
// score and ksw_apply_zdrop with e = 0 (introns are free) after the next
// barrier.  approx_drop (ADROP, :371-376) runs that z-drop test on the H0
// walk.  A z-drop stops the job after its diagonal and is reported in ez
// lane 14 for the wrapper.  RIGHT takes the >= forms of the byte compares
// (:245-292): the complements of the reversed > compares.
//
// What bounds it: the N*RT*W bytes of p (11.4 GB for a 512-job launch at
// QP=2048, TP=8192, W=2176, RT=10240) against ~45 integer operations per DP
// cell.  Three limits of a block-per-job layout with int32 lanes, and what
// this design does about each:
// 1. Idle SMs.  The caller packs both strand rounds of up to 256 jobs into
//    one launch, so 512 blocks cover the 132 SMs several times over, and
//    blocks take jobs longest first (qlen + tlen, the `order` array), so
//    the longest jobs spread one to an SM and none starts last.
// 2. Work on every lane of every diagonal.  The recurrence is int8 modular
//    arithmetic, so four lanes pack into one 32-bit word and advance with
//    byte-wise SIMD (__vadd4, __vsub4, __vmaxs4, __vcmpgts4) and LOP3
//    selects, as ksw2's SSE does.  Each thread owns 16 consecutive slots
//    (four words in registers): W = 2176 takes 136 threads, five warps.  A
//    thread works only when its 16 lanes touch the updated band [st, en]
//    (16-aligned, so a group is wholly in or out), the score row's rewrite
//    range [st0, s_hi] (which can pass en), or are the 16 slots that wrap
//    on a window step; other lanes keep their registers, which is what
//    the reference leaves in them.
// 3. Narrow stores.  The wrapper zeroes p once; a working group stores its
//    16 direction bytes with one 16-byte store, only on band rows.
// The rows are circular in the lanes: physical slot ph holds target
// position t with t = ph (mod W), so the window step moves no data (the 16
// wrapped slots take the fill values) and a lane's left neighbour is the
// previous slot: a byte shift inside a word, a funnel shift across words,
// and across threads the neighbour group's last bytes (x, v, x2), which
// every thread publishes to a double-buffered shared word each diagonal.
// The values other lanes read -- the boundary bytes at st - 1 of the next
// diagonal and the H0 walk's v[t0], u[t0 + 1] -- are known a diagonal
// ahead, so their owner thread exports them to shared scalars; one
// __syncthreads per diagonal serves all of it, and every thread computes the
// per-job scalars itself (the H0 walk of diagonal r at the start of r + 1).
// The slot of a position comes from the window origin kept by
// compare-and-subtract (no % by W).  The job's target and donor/acceptor
// planes (zero past TP) and its reversed query (zero outside [0, qlen))
// sit in shared memory.  A job stops at its first dead diagonal.
//
// Every W and every QP, TP: three routes, picked by the shapes alone
// (plan_of, the first whose block holds the job):
// - REG: the design above, W / 16 threads a block (rounded up to a warp),
//   as many as the instantiation's registers allow
//   (cudaFuncGetAttributes' maxThreadsPerBlock: 1024 for the approx
//   modes, capped at 64 registers, W 16384; fewer for the exact ones),
//   planes staged in shared memory.
// - REG_GP: the same with the target, donor, acceptor and query read from
//   device memory (__ldg, a byte at a time with the bounds the staged
//   planes had) when they pass the 227 KB a block may stage (3 TP + QP
//   past ~232,000: TP past ~75,000, genes whose introns span more; the
//   splice preset's max_gap_ref is 200,000).  The row buffers stay shared.
// - SLAB: past the threads one block holds.  The job's packed rows (u v x
//   y x2 s, W bytes each), its H row and its edges live in device memory,
//   physical slots as above, and T threads walk the groups the diagonal
//   changes -- those meeting [st, en] or [st0, s_hi], and the one that
//   wrapped -- a group at a time: load its four words a row, run the same
//   update, store them back, in place.  A group's left neighbour as
//   diagonal r - 1 left it is the edge r - 1 wrote to device memory if r -
//   1 updated it, the fill values if it lies past r - 1's band, else its
//   rows, which nothing writes on diagonal r; the H0 walk's lanes in groups
//   the diagonal leaves alone come from their rows.  The planes come from
//   device memory.  Why not a thread-block cluster: extd2.cu says; here 8
//   blocks of the exact instantiations' ~512 threads reach 65,536 lanes,
//   but one design for both kernels keeps one host-shim emulation and one
//   argument for bit-equality.
// Resources (`nvcc -Xptxas -v` for sm_90a, printed by chip_smoke.py's
// build phase) <EXACT, RIGHT, ADROP> on a route: REG
// approx 64 registers (a 64-byte frame, no spills; the splice path's
// <0,0,0>), exact 119 and 121; REG_GP approx 64 (<0,0,1> spills 12
// bytes, the approx-drop right ones 124), exact 127 and 128; SLAB approx
// 128 (bounded at 512 threads, 4 bytes spilled), exact 167 and 168.  The
// splice path's launch at QP=2048, TP=8192, W=2176 takes 27,840 bytes of
// dynamic shared memory a block (8 W/16 + 64 + 3 TP + QP + 64), so 6
// blocks of 160 threads fit on an SM (register-bound;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor through mm2_exts2_plan).
// The exact instantiations add the shared ints of H's edge and the warps'
// maxima (2 W/16 + 128); REG_GP keeps the edge words only, SLAB the
// scalars and 10 W + 16 W/16 bytes a job in device memory.
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF32 = -0x40000000;
constexpr int EZ_N = 16;
constexpr int GL = 16;          // lanes a thread: four packed words
constexpr int MAX_T = 1024;     // threads a block
constexpr int QM = 16;          // zero bytes before the query in shared memory
constexpr int QTAIL = 48;       // and after it
constexpr int NX = 8;           // exported scalars a diagonal: 7 used, 8
                                // keep the planes after them 16-byte aligned
constexpr int NWARP = MAX_T / 32;
constexpr int NRED = 2 * NWARP * 2;   // [2][warp] (max, key) of the H row
constexpr int NROW = 6;         // the slab route's packed rows: U V X Y X2 S

// the routes: a job's lanes in registers with its planes staged in shared
// memory, the same with the planes read from device memory, or the rows
// in device memory, walked a group at a time (the slab route)
enum Route { REG = 0, REG_GP = 1, SLAB = 2 };

struct Exts2Args {
  const uint8_t* qr;
  const uint8_t* sf;
  const int8_t* dn;
  const int8_t* ac;
  const int* lens;
  const int* order;
  uint8_t* p;
  int* ez;
  uint32_t* rows;     // the slab route's rows and edges, one slice a job
  int QP, TP, W, RT, q, e, q2, long_thres, long_diff, sc_mch, sc_mis, sc_N,
      with_cigar, zdrop;
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
  const int NG = W / GL, T = (NG + 31) / 32 * 32;
  const size_t xs = 2 * NX * 4 + (exact ? NRED * 4 : 0);
  const size_t rows = (size_t)2 * NG * 4 * (exact ? 2 : 1) + xs;
  const size_t planes = 3 * (size_t)((TP + 15) & ~15) + QP + QM + QTAIL;
  if (T <= tmax[REG] && rows + planes <= smax)
    return {REG, T, rows + planes, 0};
  if (T <= tmax[REG_GP] && rows <= smax) return {REG_GP, T, rows, 0};
  // packed rows (W bytes each), H (4 W), edges and H edges (2 NG each)
  return {SLAB, T < tmax[SLAB] ? T : tmax[SLAB], xs,
          (size_t)NROW * W + (size_t)4 * W + (size_t)16 * NG};
}

__device__ __forceinline__ uint32_t bc(int v) {     // v's low byte, 4 times
  return (uint32_t)(v & 255) * 0x01010101u;
}

__device__ __forceinline__ int sext8(uint32_t v) {
  return (int)(signed char)(v & 255u);
}

__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// byte i (0..15) of a thread's four words
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[4], int i) {
  uint32_t v = w[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if ((i >> 2) == k) v = w[k];
  return (v >> (8 * (i & 3))) & 255u;
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

__device__ __forceinline__ int wstart_q(int r, int QP) {
  const int a = r - QP + 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

// greedy H0 walk of one live diagonal pr (exts_pallas.py:350-370) from the
// bytes its owners exported: hv = v[t0] (v at lane 0 on diagonal 0) and
// hu = u[t0 + 1]
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

// the physical slot of logical lane l (0 <= l < W) at window origin off
__device__ __forceinline__ int slot_of(int l, int off, int W) {
  const int ph = l + off;
  return ph >= W ? ph - W : ph;
}

__device__ __forceinline__ uint32_t edge_word(uint32_t x, uint32_t v,
                                              uint32_t x2) {
  return (x >> 24) | ((v >> 24) << 8) | ((x2 >> 24) << 16);
}

// ksw_apply_zdrop with e = 0 (exts_pallas.py:335-345) on diagonal r's
// maximum H at t: true when the job z-drops
__device__ __forceinline__ bool apply_zdrop(int H, int t, int r, int zdrop,
                                            int& mx, int& mxt, int& mxq) {
  if (H > mx) {
    mx = H;
    mxt = t;
    mxq = r - t;
    return false;
  }
  return zdrop >= 0 && t >= mxt && r - t >= mxq && mx - H > zdrop;
}

// a group's four words of one row from / to the slab route's rows
__device__ __forceinline__ void ld4(uint32_t (&a)[4], const uint32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void st4(uint32_t* p, const uint32_t (&a)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ uint4* dyn_smem() {
  extern __shared__ uint4 smem[];
  return smem;
}

template <bool EXACT, bool RIGHT, bool ADROP, int ROUTE>
__device__ __forceinline__ void exts2_body(const Exts2Args& A) {
  constexpr bool SL = ROUTE == SLAB;
  const int QP = A.QP, TP = A.TP, W = A.W, RT = A.RT, q = A.q, e = A.e;
  const int q2 = A.q2, long_thres = A.long_thres, long_diff = A.long_diff;
  const int with_cigar = A.with_cigar, zdrop = A.zdrop;
  uint4* smem = dyn_smem();
  const int NG = W / GL, TPP = (TP + 15) & ~15;
  uint32_t* edge = reinterpret_cast<uint32_t*>(smem);   // [2][NG]
  int* xs = reinterpret_cast<int*>(edge + (SL ? 0 : 2 * NG));   // [2][NX]
  int* edgeH = xs + 2 * NX;                             // [2][NG], EXACT
  int* red = edgeH + (EXACT && !SL ? 2 * NG : 0);       // [2][NWARP][2]
  uint8_t* ts = reinterpret_cast<uint8_t*>(red + (EXACT ? NRED : 0));
  uint8_t* ds = ts + TPP;                               // donor (i8 bits)
  uint8_t* as = ds + TPP;                               // acceptor
  uint8_t* qs = as + TPP;                               // QM + QP + QTAIL

  const int tid = threadIdx.x, T = blockDim.x, NW = T / 32;
  const int n = A.order[blockIdx.x];
  const int qlen = A.lens[2 * n], tlen = A.lens[2 * n + 1];
  const int rstar = qlen + tlen - 1;
  const uint8_t* sfn = A.sf + (size_t)n * TP;
  const uint8_t* dnn = reinterpret_cast<const uint8_t*>(A.dn) + (size_t)n * TP;
  const uint8_t* acn = reinterpret_cast<const uint8_t*>(A.ac) + (size_t)n * TP;
  const uint8_t* qrn = A.qr + (size_t)n * QP;
  if constexpr (ROUTE == REG) {
    for (int i = tid; i < TPP; i += T) {
      const bool in = i < TP;
      ts[i] = in ? sfn[i] : 0;
      ds[i] = in ? dnn[i] : 0;
      as[i] = in ? acn[i] : 0;
    }
    for (int i = tid; i < QP + QM + QTAIL; i += T) {
      const int j = i - QM;
      qs[i] = (j >= 0 && j < qlen) ? qrn[j] : 0;
    }
  }
  uint8_t* prow = A.p + (size_t)n * RT * W;
  // the slab route's packed rows [NROW][W / 4], H [W], edges [2][NG] and H
  // edges [2][NG] (physical slots)
  uint32_t* rw = A.rows + (SL ? (size_t)n * ((NROW + 4) * (size_t)W / 4
                                             + 4 * (size_t)NG)
                              : 0);
  int* rH = reinterpret_cast<int*>(rw + NROW * (size_t)W / 4);
  uint32_t* gedge = reinterpret_cast<uint32_t*>(rH + W);
  int* gedgeH = reinterpret_cast<int*>(gedge + 2 * NG);
  const int WQ = W / 4;       // words a packed row

  const int qe = q + e;
  const uint32_t QEf = bc(-qe), Q2f = bc(-q2), Qb = bc(q), Q2b = bc(q2);
  const uint32_t Mb = bc(A.sc_mch), Xb = bc(A.sc_mis), Nb = bc(A.sc_N);
  const uint32_t POS = 0x03020100u, FOUR = 0x04040404u;
  const int g = tid;
  const bool owner = g < NG;
  uint32_t U[4], V[4], X[4], Y[4], X2[4], S[4];
  int H[GL];
  auto fill = [&](uint32_t (&U)[4], uint32_t (&V)[4], uint32_t (&X)[4],
                  uint32_t (&Y)[4], uint32_t (&X2)[4], uint32_t (&S)[4],
                  int (&H)[GL]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      U[k] = V[k] = X[k] = Y[k] = QEf;
      X2[k] = Q2f;
      S[k] = 0;
    }
#pragma unroll
    for (int j = 0; j < GL; ++j) H[j] = NEG_INF32;
  };
  fill(U, V, X, Y, X2, S, H);
  if constexpr (SL) {
    for (int i = tid; i < NG; i += T) {
      const uint32_t f[NROW] = {QEf, QEf, QEf, QEf, Q2f, 0u};
#pragma unroll
      for (int k = 0; k < NROW; ++k)
        reinterpret_cast<uint4*>(rw + (size_t)k * WQ)[i] =
            make_uint4(f[k], f[k], f[k], f[k]);
      for (int j = 0; j < GL; ++j) rH[i * GL + j] = NEG_INF32;
    }
  } else if (owner) {                                   // "before" r = 0
    edge[NG + g] = edge_word(QEf, QEf, Q2f);
    if constexpr (EXACT) edgeH[NG + g] = NEG_INF32;
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
      if (apply_zdrop(mH, mt, pw_r, zdrop, mx, mxt, mxq)) {
        zdr = zflag = 1;
        return true;
      }
    }
    return false;
  };
  int ws = 0, off = 0;        // window start and its physical slot
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
    // the whole valid diagonal (the same in every thread: uniform break)
    const int st0 = max(0, r - qlen + 1);
    const int en0 = min(tlen - 1, r);
    if (r >= rstar || st0 > en0) {
      if (r < rstar) zdr = 1;      // the band died before the last cell
      break;
    }
    const int ws_prev = ws;
    ws = wstart_q(r, QP);
    const bool adv = ws != ws_prev;
    if (adv) {
      off += GL;
      if (off >= W) off -= W;
    }
    const int st = (st0 >> 4) << 4;
    const int en = (((en0 + 16) >> 4) << 4) - 1;
    // boundary values at st - 1, in the previous diagonal's window
    const bool use_prev = st - last_st == 16 && st > 0;
    const int pre = st - 1 - ws_prev;
    const bool pre_ok = pre >= 0 && pre < W;
    const int x1 = use_prev ? (pre_ok ? xp[0] : 0) : -qe;
    const int x21 = use_prev ? (pre_ok ? xp[2] : 0) : -q2;
    const int v1_edge = r == 0 ? -qe
                        : r < long_thres ? -e
                        : r == long_thres ? long_diff : 0;
    const int v1 = use_prev ? (pre_ok ? xp[1] : 0)
                            : (st > 0 ? -qe : v1_edge);
    const int s_hi = st0 + (((en0 - st0) >> 4) << 4) + 15;
    const int stl = st - ws;
    const bool at_r_on = en >= r;
    int hb = INT_MIN, hk = INT_MIN;  // EXACT: best H of [st0, en0], its key
    int* xc = xs + NX * cur;

    // one group's diagonal: its 16 lanes at logical lane l0, position t0;
    // fetch_e(E, hprev): the left group's last bytes (x, v, x2) and H as
    // diagonal r - 1 left them, fetched where the group needs them.  A
    // wrapped group takes the fill values first.  Stores the band rows'
    // direction bytes.
    auto group = [&](uint32_t (&U)[4], uint32_t (&V)[4], uint32_t (&X)[4],
                     uint32_t (&Y)[4], uint32_t (&X2)[4], uint32_t (&S)[4],
                     int (&H)[GL], int l0, int t0, bool wrapped,
                     auto fetch_e) {
      const bool upd = t0 >= st && t0 <= en;
      const bool sco = t0 + GL - 1 >= st0 && t0 <= s_hi;
      if (!(wrapped || upd || sco)) return;
      if (wrapped) fill(U, V, X, Y, X2, S, H);   // the shift's fill values
      // y, x2 and u reset at lane r, before the neighbour reads
      const int ir = r - t0;
      const bool rin = at_r_on && ir >= 0 && ir < GL;
      const uint32_t rbyte = 0xFFu << (8 * (ir & 3));
      uint32_t Yp[4], Up[4], X2p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t m = (rin && (ir >> 2) == k) ? rbyte : 0u;
        Yp[k] = sel(m, QEf, Y[k]);
        X2p[k] = sel(m, Q2f, X2[k]);
        Up[k] = sel(m, bc(v1_edge), U[k]);
      }
      if (sco) {                // score row: only [st0, s_hi] is rewritten
        const int lo = min(max(st0 - t0, 0), GL);
        const int hi = min(max(s_hi - t0 + 1, 0), GL);
        uint32_t Tw[4] = {0u, 0u, 0u, 0u}, Qw[4];
        if constexpr (ROUTE == REG) {
          if (t0 < TPP) {
            const uint4 tv = *reinterpret_cast<const uint4*>(ts + t0);
            Tw[0] = tv.x; Tw[1] = tv.y; Tw[2] = tv.z; Tw[3] = tv.w;
          }
          // query bytes qi0 .. qi0 + 15, qi0 = t0 - r + qlen - 1 >= -15
          const int o = QM + t0 - r + qlen - 1;
          const uint32_t* q32 =
              reinterpret_cast<const uint32_t*>(qs + (o & ~3));
          const int sh = (o & 3) * 8;
          uint32_t qw[5];
#pragma unroll
          for (int j = 0; j < 5; ++j) qw[j] = q32[j];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            Qw[k] = __funnelshift_r(qw[k], qw[k + 1], sh);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            Tw[k] = gbytes4(sfn, t0 + 4 * k, TP);
            Qw[k] = gbytes4(qrn, t0 - r + qlen - 1 + 4 * k, qlen);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t pos = POS + k * FOUR;
          const uint32_t rng =
              __vcmpgeu4(pos, bc(lo)) & __vcmpltu4(pos, bc(hi));
          const uint32_t isn = __vcmpeq4(Tw[k], FOUR) | __vcmpeq4(Qw[k], FOUR);
          const uint32_t sv =
              sel(isn, Nb, sel(__vcmpeq4(Tw[k], Qw[k]), Mb, Xb));
          S[k] = sel(rng, sv, S[k]);
        }
      }
      if (upd) {
        uint32_t Dw[4] = {0u, 0u, 0u, 0u}, Aw[4] = {0u, 0u, 0u, 0u};
        if constexpr (ROUTE == REG) {
          if (t0 < TPP) {
            const uint4 dv = *reinterpret_cast<const uint4*>(ds + t0);
            const uint4 av = *reinterpret_cast<const uint4*>(as + t0);
            Dw[0] = dv.x; Dw[1] = dv.y; Dw[2] = dv.z; Dw[3] = dv.w;
            Aw[0] = av.x; Aw[1] = av.y; Aw[2] = av.z; Aw[3] = av.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            Dw[k] = gbytes4(dnn, t0 + 4 * k, TP);
            Aw[k] = gbytes4(acn, t0 + 4 * k, TP);
          }
        }
        // the left neighbour of lane l0: the boundary values at st, else
        // the previous group's last bytes.  It is never a wrapped slot
        // (lane 0 in the band is lane stl) nor lane r (a group that
        // starts at r + 1 lies past en)
        uint32_t ex, ev, ex2;
        uint32_t E = 0u;
        int hprev = 0;
        const bool need_h =
            EXACT && t0 + GL - 1 >= st0 && t0 <= en0 && en0 - 1 - ws >= 0;
        if (l0 != stl || need_h) fetch_e(l0 != stl, need_h, E, hprev);
        if (l0 == stl) {
          ex = (uint32_t)x1; ev = (uint32_t)v1; ex2 = (uint32_t)x21;
        } else {
          ex = E; ev = E >> 8; ex2 = E >> 16;
        }
        uint32_t XN[4], VN[4], X2N[4];
        XN[0] = __byte_perm(X[0], ex, 0x2104);
        VN[0] = __byte_perm(V[0], ev, 0x2104);
        X2N[0] = __byte_perm(X2p[0], ex2, 0x2104);
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          XN[k] = __funnelshift_l(X[k - 1], X[k], 8);
          VN[k] = __funnelshift_l(V[k - 1], V[k], 8);
          X2N[k] = __funnelshift_l(X2p[k - 1], X2p[k], 8);
        }
        uint32_t P[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t a = __vadd4(XN[k], VN[k]);
          uint32_t b = __vadd4(Yp[k], Up[k]);
          uint32_t a2 = __vadd4(X2N[k], VN[k]);
          const uint32_t a2a = __vadd4(a2, Aw[k]);
          uint32_t z = S[k];
          uint32_t c1, c2, c3;
          if constexpr (RIGHT) {      // d = z > a ? 0 : 1, and so on
            c1 = ~__vcmpgts4(z, a);
            z = __vmaxs4(z, a);
            c2 = ~__vcmpgts4(z, b);
            z = __vmaxs4(z, b);
            c3 = ~__vcmpgts4(z, a2a);
          } else {
            c1 = __vcmpgts4(a, z);
            z = __vmaxs4(z, a);
            c2 = __vcmpgts4(b, z);
            z = __vmaxs4(z, b);
            c3 = __vcmpgts4(a2a, z);
          }
          z = __vmaxs4(z, a2a);
          const uint32_t d = sel(c3, 0x03030303u,
                                 sel(c2, 0x02020202u, c1 & 0x01010101u));
          U[k] = __vsub4(z, VN[k]);
          V[k] = __vsub4(z, Up[k]);
          const uint32_t t1 = __vsub4(z, Qb);
          a = __vsub4(a, t1);
          b = __vsub4(b, t1);
          a2 = __vsub4(a2, __vsub4(z, Q2b));
          uint32_t ga, gb, g2;
          if constexpr (RIGHT) {      // a >= 0, b >= 0, a2 >= dn
            ga = ~__vcmpgts4(0u, a);
            gb = ~__vcmpgts4(0u, b);
            g2 = ~__vcmpgts4(Dw[k], a2);
          } else {
            ga = __vcmpgts4(a, 0u);
            gb = __vcmpgts4(b, 0u);
            g2 = __vcmpgts4(a2, Dw[k]);
          }
          X[k] = __vsub4(a & ga, bc(qe));
          Y[k] = __vsub4(b & gb, bc(qe));
          X2[k] = __vsub4(sel(g2, a2, Dw[k]), Q2b);
          P[k] = d | (ga & 0x08080808u) | (gb & 0x10101010u)
                 | (g2 & 0x20202020u);
        }
        if (with_cigar)
          *reinterpret_cast<uint4*>(prow + (size_t)r * W + l0) =
              make_uint4(P[0], P[1], P[2], P[3]);
        if constexpr (EXACT) {
          // H row (:297-320): the body [st0, en0) adds v, en0 takes h_en0
          if (t0 + GL - 1 >= st0 && t0 <= en0) {
            int Hp[GL];
#pragma unroll
            for (int j = 0; j < GL; ++j) Hp[j] = H[j];
#pragma unroll
            for (int j = 0; j < GL; ++j) {
              const int t = t0 + j;
              const int vj = sext8(V[j >> 2] >> (8 * (j & 3)));
              if (t == en0) {
                int h;
                if (r == 0) {
                  h = vj - qe;
                } else if (en0 > 0) {
                  h = (j ? Hp[j ? j - 1 : 0] : hprev)
                      + sext8(U[j >> 2] >> (8 * (j & 3)));
                } else {
                  h = Hp[j] + vj;
                }
                H[j] = h;
                xc[5] = h;
              } else if (t >= st0 && t < en0) {
                H[j] = Hp[j] + vj;
              }
              if (t == st0) xc[6] = H[j];
              if (t >= st0 && t <= en0) {
                const int k = t == en0 ? INT_MAX : -t;
                if (H[j] > hb || (H[j] == hb && k > hk)) {
                  hb = H[j];
                  hk = k;
                }
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          U[k] = Up[k];
          Y[k] = Yp[k];
          X2[k] = X2p[k];
        }
      }
    };
    // exports for the next diagonal: x, v, x2 at st(r + 1) - 1 and the H0
    // walk's v[t0], u[t0 + 1] of this one, from the registers of the
    // physical group gp that holds them
    const int lb = ((max(0, r + 2 - qlen) >> 4) << 4) - 1 - ws;
    int lv = -1, lu = -1;
    if constexpr (!EXACT) {
      if (r == 0) {
        lv = 0;
      } else {
        const int lx = h0t + 1 - ws;
        if (lx >= 0 && lx < W) {
          lv = lx == 0 ? W - 1 : lx - 1;
          lu = lx;
        }
      }
    }
    auto exports = [&](const uint32_t (&U)[4], const uint32_t (&V)[4],
                       const uint32_t (&X)[4], const uint32_t (&X2)[4],
                       int gp) {
      if (lb >= 0 && lb < W) {
        const int ph = slot_of(lb, off, W);
        if ((ph >> 4) == gp) {
          xc[0] = sext8(byte_of(X, ph & 15));
          xc[1] = sext8(byte_of(V, ph & 15));
          xc[2] = sext8(byte_of(X2, ph & 15));
        }
      }
      if constexpr (!EXACT) {
        if (lv >= 0) {
          const int ph = slot_of(lv, off, W);
          if ((ph >> 4) == gp) xc[3] = sext8(byte_of(V, ph & 15));
        }
        if (lu >= 0) {
          const int ph = slot_of(lu, off, W);
          if ((ph >> 4) == gp) xc[4] = sext8(byte_of(U, ph & 15));
        }
      }
    };

    if constexpr (!SL) {
      if (owner) {
        int l0 = g * GL - off;
        if (l0 < 0) l0 += W;
        const int gp = g == 0 ? NG - 1 : g - 1;
        group(U, V, X, Y, X2, S, H, l0, ws + l0, adv && l0 == W - GL,
              [&](bool want_e, bool want_h, uint32_t& E, int& h) {
                if (want_e) E = edge[NG * prv + gp];
                if (want_h) h = edgeH[NG * prv + gp];
              });
        edge[NG * cur + g] = edge_word(X[3], V[3], X2[3]);
        if constexpr (EXACT) edgeH[NG * cur + g] = H[GL - 1];
        exports(U, V, X, X2, g);
      }
    } else {
      // the groups this diagonal changes, in logical groups: those that
      // meet [st, en] or [st0, s_hi] (one run), and the one that wrapped
      const int jlo = max(st - ws, 0) / GL;
      const int jhi = min(max(en, s_hi) - ws, W - 1) / GL;
      const int jwr = adv && NG - 1 > jhi ? NG - 1 : NG;
      const int nA = jhi - jlo + 1, nall = nA + NG - jwr;
      const int goff = off / GL;
      for (int k = tid; k < nall; k += T) {
        const int j = k < nA ? jlo + k : jwr + k - nA;
        const int G = j + goff < NG ? j + goff : j + goff - NG;
        const int l0 = j * GL, t0 = ws + l0;
        uint32_t* base = rw + 4 * G;
        ld4(U, base); ld4(V, base + WQ); ld4(X, base + 2 * WQ);
        ld4(Y, base + 3 * WQ); ld4(X2, base + 4 * WQ); ld4(S, base + 5 * WQ);
        if constexpr (EXACT)
          for (int i = 0; i < GL; ++i) H[i] = rH[G * GL + i];
        // the left group's last lane as diagonal r - 1 left it: its edge
        // if r - 1 updated it, the fill values if it lies past r - 1's
        // band (never updated since it last wrapped), else its rows, which
        // nothing writes on this diagonal (it lies left of the band)
        const int Gm = G == 0 ? NG - 1 : G - 1;
        group(U, V, X, Y, X2, S, H, l0, t0, adv && l0 == W - GL,
              [&](bool, bool, uint32_t& E, int& h) {
                const int tl = t0 - 1;
                if (tl >= pst && tl <= pen) {
                  E = gedge[NG * prv + Gm];
                  h = gedgeH[NG * prv + Gm];
                } else if (tl > pen) {
                  E = edge_word(QEf, QEf, Q2f);
                  h = NEG_INF32;
                } else {
                  const uint32_t* bm = rw + 4 * Gm + 3;
                  E = edge_word(bm[2 * WQ], bm[WQ], bm[4 * WQ]);
                  h = rH[Gm * GL + GL - 1];
                }
              });
        st4(base, U); st4(base + WQ, V); st4(base + 2 * WQ, X);
        st4(base + 3 * WQ, Y); st4(base + 4 * WQ, X2); st4(base + 5 * WQ, S);
        if constexpr (EXACT)
          for (int i = 0; i < GL; ++i) rH[G * GL + i] = H[i];
        if (t0 >= st && t0 <= en) {
          gedge[NG * cur + G] = edge_word(X[3], V[3], X2[3]);
          gedgeH[NG * cur + G] = H[GL - 1];
        }
        exports(U, V, X, X2, G);
      }
      if constexpr (!EXACT) {
        // the H0 walk's lanes in groups this diagonal leaves alone: their
        // rows, which nothing writes on this diagonal
        if (tid == 0) {
          auto kept = [&](int l) {
            const int j = l / GL;
            return !(j >= jlo && j <= jhi) && j < jwr;
          };
          auto byte_at = [&](int row, int l) {
            const int ph = slot_of(l, off, W);
            return sext8(rw[row * WQ + (ph >> 2)] >> (8 * (ph & 3)));
          };
          if (lv >= 0 && kept(lv)) xc[3] = byte_at(1, lv);
          if (lu >= 0 && kept(lu)) xc[4] = byte_at(0, lu);
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
    pw_r = r; pw_ws = ws; pw_st0 = st0; pw_en0 = en0;
    pw_fin = r == rstar - 1 && en0 == tlen - 1;
    last_st = st;
    pst = st;
    pen = en;
    nr = r + 1;
    __syncthreads();
  }
  if (pw_r >= 0)             // every diagonal was live: the last one's step
    step(xs + NX * ((r - 1) & 1), red + 2 * NWARP * ((r - 1) & 1));
  if (tid == 0) {
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
    exts2_approx(Exts2Args a) {
  exts2_body<false, RIGHT, ADROP, ROUTE>(a);
}

template <bool RIGHT, int ROUTE>
__global__ void exts2_exact(Exts2Args a) {
  exts2_body<true, RIGHT, false, ROUTE>(a);
}

using Exts2Fn = void (*)(Exts2Args);

template <int ROUTE>
inline Exts2Fn exts2_route_variant(int exact, int right, int adrop) {
  if (exact)
    return right ? exts2_exact<true, ROUTE> : exts2_exact<false, ROUTE>;
  if (adrop)
    return right ? exts2_approx<true, true, ROUTE>
                 : exts2_approx<false, true, ROUTE>;
  return right ? exts2_approx<true, false, ROUTE>
               : exts2_approx<false, false, ROUTE>;
}

// the instantiation of a mode on a route (approx_drop counts only in the
// approx mode)
inline Exts2Fn exts2_variant(int exact, int right, int adrop, int route) {
  return route == REG ? exts2_route_variant<REG>(exact, right, adrop)
         : route == REG_GP ? exts2_route_variant<REG_GP>(exact, right, adrop)
                           : exts2_route_variant<SLAB>(exact, right, adrop);
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
        &at, (const void*)exts2_variant(exact, right, adrop, rt));
    tmax[rt] = at.maxThreadsPerBlock / 32 * 32;
  }
  if (err) return (int)err;
  *pl = plan_of(exact, W, QP, TP, tmax, (size_t)smax);
  if (pl->smem > (size_t)smax) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      (const void*)exts2_variant(exact, right, adrop, pl->route),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl->smem);
}

}  // namespace

// route, threads, dynamic shared memory and scratch bytes a job of a mode
// (exact | right << 1 | adrop << 2) at these widths, and its blocks an SM
// holds at once
extern "C" int mm2_exts2_plan(int W, int QP, int TP, int mode, long long* out) {
  Plan pl;
  const int exact = mode & 1, right = mode >> 1 & 1, adrop = mode >> 2 & 1;
  int err = launch_plan(exact, right, adrop, W, QP, TP, &pl);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, exts2_variant(exact, right, adrop, pl.route), pl.threads,
      pl.smem);
  out[0] = pl.route;
  out[1] = pl.threads;
  out[2] = (long long)pl.smem;
  out[3] = (long long)pl.scratch;
  out[4] = blocks;
  return err;
}

extern "C" int mm2_exts2(const void* qr, const void* sf, const void* dn,
                         const void* ac, const void* lens, const void* order,
                         void* p, void* ez, void* rows, int N, int QP, int TP,
                         int W, int RT, int q, int e, int q2, int long_thres,
                         int long_diff, int sc_mch, int sc_mis, int sc_N,
                         int with_cigar, int exact, int right, int adrop,
                         int zdrop, void* stream) {
  if (N == 0) return 0;
  Plan pl;
  const int err = launch_plan(exact, right, adrop, W, QP, TP, &pl);
  if (err) return err;
  if (pl.route == SLAB && rows == nullptr) return (int)cudaErrorInvalidValue;
  const Exts2Args a = {(const uint8_t*)qr, (const uint8_t*)sf,
                       (const int8_t*)dn, (const int8_t*)ac, (const int*)lens,
                       (const int*)order, (uint8_t*)p, (int*)ez,
                       (uint32_t*)rows, QP, TP, W, RT, q, e, q2, long_thres,
                       long_diff, sc_mch, sc_mis, sc_N, with_cigar, zdrop};
  exts2_variant(exact, right, adrop, pl.route)<<<N, pl.threads, pl.smem,
                                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// blocks of a mode's kernel one SM holds at once at these widths, on the
// route the widths take (mode = exact | right << 1 | adrop << 2)
extern "C" int mm2_exts2_occupancy(int W, int QP, int TP, int mode,
                                   int* blocks) {
  long long out[5];
  const int err = mm2_exts2_plan(W, QP, TP, mode, out);
  *blocks = (int)out[4];
  return err;
}
