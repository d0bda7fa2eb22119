// Splice-aware extension with direction bytes (ksw_exts2, approx-max mode)
// on Hopper.
//
// Replaces minimap2_tpu/ops/exts_pallas.py: exts2_batch -> _exts2_call ->
// _exts2_kernel (the Pallas kernel at exts_pallas.py:111-425, called at
// :525) in the mode of the --batch -x splice path: approx_max, no zdrop,
// left-align, with the direction matrix.  Per anti-diagonal r the
// Suzuki-Kasahara difference rows u, v, x, y, the intron row x2 and the
// score row s advance over W lanes with int8 wrap arithmetic; the intron
// opens at q2 plus the target's acceptor value and closes against its donor
// value.  The DP is unbanded and lane l is target position wstart_q(r) + l:
// the window follows the query edge and steps by 16 lanes (the carried rows
// shift left with the fills -q-e, -q2, 0), so r - ws(r) is a sawtooth.  The
// score comes from the greedy H0 walk.  Outputs p (N, RT, W) u8 and ez (N,
// 16) i32; EZ_DEAD is set by the wrapper (ops/extend.py), which also zeroes
// p and passes the block -> job order.
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
// Resources (`nvcc -Xptxas -v` for sm_90a, printed by chip_smoke.py's
// build phase): 64 registers a thread, no spills (a 64-byte stack frame);
// 27,840 bytes of dynamic shared memory a block at QP=2048, TP=8192,
// W=2176 (8 W/16 + 64 + 3 TP + QP + 64), so 6 blocks of 160 threads fit
// on an SM (register-bound; cudaOccupancyMaxActiveBlocksPerMultiprocessor
// through mm2_exts2_occupancy).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF32 = -0x40000000;
constexpr int EZ_N = 16;
constexpr int GL = 16;          // lanes a thread: four packed words
constexpr int MAX_T = 256;      // threads a block: W <= 4096
constexpr int QM = 16;          // zero bytes before the query in shared memory
constexpr int QTAIL = 48;       // and after it
constexpr int NX = 8;           // exported scalars a diagonal: 5 used, 8
                                // keep the planes after them 16-byte aligned

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

__global__ void __launch_bounds__(MAX_T) exts2_kernel(
    const uint8_t* __restrict__ qr, const uint8_t* __restrict__ sf,
    const int8_t* __restrict__ dn, const int8_t* __restrict__ ac,
    const int* __restrict__ lens, const int* __restrict__ order,
    uint8_t* __restrict__ p, int* __restrict__ ez, int QP, int TP, int W,
    int RT, int q, int e, int q2, int long_thres, int long_diff, int sc_mch,
    int sc_mis, int sc_N) {
  extern __shared__ uint4 smem[];
  const int NG = W / GL, TPP = (TP + 15) & ~15;
  uint32_t* edge = reinterpret_cast<uint32_t*>(smem);   // [2][NG]
  int* xs = reinterpret_cast<int*>(edge + 2 * NG);      // [2][NX]
  uint8_t* ts = reinterpret_cast<uint8_t*>(xs + 2 * NX);  // target, TPP
  uint8_t* ds = ts + TPP;                               // donor (i8 bits)
  uint8_t* as = ds + TPP;                               // acceptor
  uint8_t* qs = as + TPP;                               // QM + QP + QTAIL

  const int tid = threadIdx.x, T = blockDim.x;
  const int n = order[blockIdx.x];
  const int qlen = lens[2 * n], tlen = lens[2 * n + 1];
  const int rstar = qlen + tlen - 1;
  for (int i = tid; i < TPP; i += T) {
    const bool in = i < TP;
    const size_t gi = (size_t)n * TP + i;
    ts[i] = in ? sf[gi] : 0;
    ds[i] = in ? (uint8_t)dn[gi] : 0;
    as[i] = in ? (uint8_t)ac[gi] : 0;
  }
  for (int i = tid; i < QP + QM + QTAIL; i += T) {
    const int j = i - QM;
    qs[i] = (j >= 0 && j < qlen) ? qr[(size_t)n * QP + j] : 0;
  }
  uint8_t* prow = p + (size_t)n * RT * W;

  const int qe = q + e;
  const uint32_t QEf = bc(-qe), Q2f = bc(-q2), Qb = bc(q), Q2b = bc(q2);
  const uint32_t Mb = bc(sc_mch), Xb = bc(sc_mis), Nb = bc(sc_N);
  const uint32_t POS = 0x03020100u, FOUR = 0x04040404u;
  const int g = tid;
  const bool owner = g < NG;
  uint32_t U[4], V[4], X[4], Y[4], X2[4], S[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    U[k] = V[k] = X[k] = Y[k] = QEf;
    X2[k] = Q2f;
    S[k] = 0;
  }
  if (owner) edge[NG + g] = edge_word(QEf, QEf, Q2f);   // "before" r = 0
  int zdr = 0, last_st = 0, nr = 0, H0 = 0, h0t = 0, score = NEG_INF32;
  // the H0 walk of the previous diagonal, run after the next barrier
  int pw_r = -1, pw_ws = 0, pw_st0 = 0, pw_en0 = 0;
  bool pw_fin = false;
  int ws = 0, off = 0;        // window start and its physical slot
  __syncthreads();

  int r = 0;
  for (; r < RT; ++r) {
    const int cur = r & 1, prv = cur ^ 1;
    const int* xp = xs + NX * prv;
    if (pw_r >= 0) {
      h0_walk(xp[3], xp[4], W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe, H0,
              h0t, score);
      pw_r = -1;
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

    if (owner) {
      int l0 = g * GL - off;
      if (l0 < 0) l0 += W;
      const int t0 = ws + l0;
      const bool wrapped = adv && l0 == W - GL;
      const bool upd = t0 >= st && t0 <= en;
      const bool sco = t0 + GL - 1 >= st0 && t0 <= s_hi;
      if (wrapped || upd || sco) {
        if (wrapped) {            // the shift's fill values
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            U[k] = V[k] = X[k] = Y[k] = QEf;
            X2[k] = Q2f;
            S[k] = 0;
          }
        }
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
          uint32_t Tw[4] = {0u, 0u, 0u, 0u};
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
          for (int k = 0; k < 4; ++k) {
            const uint32_t Qw = __funnelshift_r(qw[k], qw[k + 1], sh);
            const uint32_t pos = POS + k * FOUR;
            const uint32_t rng =
                __vcmpgeu4(pos, bc(lo)) & __vcmpltu4(pos, bc(hi));
            const uint32_t isn = __vcmpeq4(Tw[k], FOUR) | __vcmpeq4(Qw, FOUR);
            const uint32_t sv =
                sel(isn, Nb, sel(__vcmpeq4(Tw[k], Qw), Mb, Xb));
            S[k] = sel(rng, sv, S[k]);
          }
        }
        if (upd) {
          uint32_t Dw[4] = {0u, 0u, 0u, 0u}, Aw[4] = {0u, 0u, 0u, 0u};
          if (t0 < TPP) {
            const uint4 dv = *reinterpret_cast<const uint4*>(ds + t0);
            const uint4 av = *reinterpret_cast<const uint4*>(as + t0);
            Dw[0] = dv.x; Dw[1] = dv.y; Dw[2] = dv.z; Dw[3] = dv.w;
            Aw[0] = av.x; Aw[1] = av.y; Aw[2] = av.z; Aw[3] = av.w;
          }
          // the left neighbour of lane l0: the boundary values at st, else
          // the previous group's last bytes.  It is never a wrapped slot
          // (lane 0 in the band is lane stl) nor lane r (a group that
          // starts at r + 1 lies past en)
          uint32_t ex, ev, ex2;
          if (l0 == stl) {
            ex = (uint32_t)x1; ev = (uint32_t)v1; ex2 = (uint32_t)x21;
          } else {
            const uint32_t E = edge[NG * prv + (g == 0 ? NG - 1 : g - 1)];
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
            const uint32_t c1 = __vcmpgts4(a, z);
            z = __vmaxs4(z, a);
            const uint32_t c2 = __vcmpgts4(b, z);
            z = __vmaxs4(z, b);
            const uint32_t c3 = __vcmpgts4(a2a, z);
            z = __vmaxs4(z, a2a);
            const uint32_t d = sel(c3, 0x03030303u,
                                   sel(c2, 0x02020202u, c1 & 0x01010101u));
            U[k] = __vsub4(z, VN[k]);
            V[k] = __vsub4(z, Up[k]);
            const uint32_t t1 = __vsub4(z, Qb);
            a = __vsub4(a, t1);
            b = __vsub4(b, t1);
            a2 = __vsub4(a2, __vsub4(z, Q2b));
            const uint32_t ga = __vcmpgts4(a, 0u), gb = __vcmpgts4(b, 0u);
            const uint32_t g2 = __vcmpgts4(a2, Dw[k]);
            X[k] = __vsub4(a & ga, bc(qe));
            Y[k] = __vsub4(b & gb, bc(qe));
            X2[k] = __vsub4(sel(g2, a2, Dw[k]), Q2b);
            P[k] = d | (ga & 0x08080808u) | (gb & 0x10101010u)
                   | (g2 & 0x20202020u);
          }
          *reinterpret_cast<uint4*>(prow + (size_t)r * W + l0) =
              make_uint4(P[0], P[1], P[2], P[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            U[k] = Up[k];
            Y[k] = Yp[k];
            X2[k] = X2p[k];
          }
        }
      }
      edge[NG * cur + g] = edge_word(X[3], V[3], X2[3]);
      // exports for the next diagonal: x, v, x2 at st(r + 1) - 1 and the H0
      // walk's v[t0], u[t0 + 1] of this one
      int* xc = xs + NX * cur;
      const int lb = ((max(0, r + 2 - qlen) >> 4) << 4) - 1 - ws;
      if (lb >= 0 && lb < W) {
        const int ph = slot_of(lb, off, W);
        if ((ph >> 4) == g) {
          xc[0] = sext8(byte_of(X, ph & 15));
          xc[1] = sext8(byte_of(V, ph & 15));
          xc[2] = sext8(byte_of(X2, ph & 15));
        }
      }
      int lv = -1, lu = -1;
      if (r == 0) {
        lv = 0;
      } else {
        const int lx = h0t + 1 - ws;
        if (lx >= 0 && lx < W) {
          lv = lx == 0 ? W - 1 : lx - 1;
          lu = lx;
        }
      }
      if (lv >= 0) {
        const int ph = slot_of(lv, off, W);
        if ((ph >> 4) == g) xc[3] = sext8(byte_of(V, ph & 15));
      }
      if (lu >= 0) {
        const int ph = slot_of(lu, off, W);
        if ((ph >> 4) == g) xc[4] = sext8(byte_of(U, ph & 15));
      }
    }
    pw_r = r; pw_ws = ws; pw_st0 = st0; pw_en0 = en0;
    pw_fin = r == rstar - 1 && en0 == tlen - 1;
    last_st = st;
    nr = r + 1;
    __syncthreads();
  }
  if (pw_r >= 0) {           // every diagonal was live: walk the last one
    const int* xp = xs + NX * ((r - 1) & 1);
    h0_walk(xp[3], xp[4], W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe, H0,
            h0t, score);
  }
  if (tid == 0) {
    int* o = ez + (size_t)n * EZ_N;
    const int vals[EZ_N] = {0, zdr, -1, -1, NEG_INF32, -1, NEG_INF32, -1,
                            score, last_st, 0, nr, H0, h0t, 0, 0};
    for (int i = 0; i < EZ_N; ++i) o[i] = vals[i];
  }
}

}  // namespace

// threads and dynamic shared memory of a launch at these widths (W % 128
// == 0 keeps the shared planes 16-byte aligned)
static int launch_shape(int W, int QP, int TP, int* threads, size_t* smem) {
  if (W % 128 || W / GL > MAX_T) return (int)cudaErrorInvalidValue;
  *threads = (W / GL + 31) / 32 * 32;
  *smem = (size_t)2 * (W / GL) * 4 + 2 * NX * 4
          + 3 * (size_t)((TP + 15) & ~15) + QP + QM + QTAIL;
  return (int)cudaFuncSetAttribute(
      exts2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

extern "C" int mm2_exts2(const void* qr, const void* sf, const void* dn,
                         const void* ac, const void* lens, const void* order,
                         void* p, void* ez, int N, int QP, int TP, int W,
                         int RT, int q, int e, int q2, int long_thres,
                         int long_diff, int sc_mch, int sc_mis, int sc_N,
                         void* stream) {
  if (N == 0) return 0;
  int threads;
  size_t smem;
  const int err = launch_shape(W, QP, TP, &threads, &smem);
  if (err) return err;
  exts2_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)qr, (const uint8_t*)sf, (const int8_t*)dn,
      (const int8_t*)ac, (const int*)lens, (const int*)order, (uint8_t*)p,
      (int*)ez, QP, TP, W, RT, q, e, q2, long_thres, long_diff, sc_mch,
      sc_mis, sc_N);
  return (int)cudaGetLastError();
}

// blocks of the kernel one SM holds at once at these widths
extern "C" int mm2_exts2_occupancy(int W, int QP, int TP, int* blocks) {
  int threads;
  size_t smem;
  const int err = launch_shape(W, QP, TP, &threads, &smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, exts2_kernel, threads, smem);
}
