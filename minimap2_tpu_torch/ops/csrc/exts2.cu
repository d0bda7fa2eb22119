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
// 16) i32; EZ_DEAD is set by the wrapper (ops/extend.py).
//
// What bounds it: the N*RT*W bytes of p it writes (713 MB for a 32-job
// sub-batch at QP=2048, TP=8192, W=2176) against ~45 integer operations per
// DP cell; with 32 jobs a launch, one block per job, latency (one barrier
// per anti-diagonal, ~9k diagonals a job) is the limit in practice.
// Design: W = 2176 lanes exceed a block's 1024 threads, so each thread owns
// LPT = 4 lanes, strided (slot k*T + tid) so that neighbouring threads touch
// neighbouring words.  The rows are circular in the lanes: a physical slot
// holds target position t with t = slot (mod W), so the 16-lane window step
// moves no data -- the 16 slots that wrap around take the fill values, and
// a lane's left neighbour is always the previous slot.  Each thread keeps
// its slots' u, v, x, y, x2, s in registers; the rows other lanes read (the
// left neighbour's x, v, x2; the boundary values at st - 1; the H0 walk's
// v[t0] and u[t0 + 1]) go to a double-buffered shared row, so one
// __syncthreads per diagonal serves them all, and every thread computes the
// per-job scalars itself (the H0 walk of diagonal r at the start of r + 1).
// The job's reversed query, target and donor/acceptor planes sit in shared
// memory.  A job stops at its first dead diagonal and zero-fills the rest
// of its p rows with 16-byte stores.  Integer arithmetic only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF32 = -0x40000000;
constexpr int EZ_N = 16;
constexpr int LPT = 4;        // lanes a thread: W <= 4 * 1024

__device__ __forceinline__ int sext8(int v) {
  return (((v & 255) + 128) & 255) - 128;
}

__device__ __forceinline__ int wrap8(int v) { return ((v + 128) & 255) - 128; }

__device__ __forceinline__ int wstart_q(int r, int QP) {
  const int a = r - QP + 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

// greedy H0 walk of one live diagonal pr (exts_pallas.py:350-370); V and U
// hold that diagonal's v and u rows, circular, window origin pws
__device__ __forceinline__ void h0_walk(const int* V, const int* U, int W,
                                        int pr, int pws, int pst0, int pen0,
                                        bool pfin, int qe, int& H0, int& h0t,
                                        int& score) {
  if (pr == 0) {
    H0 = V[pws % W] - qe;
    h0t = 0;
  } else {
    const int lx = h0t + 1 - pws;
    int d0 = 0, d1 = 0;
    if (lx >= 0 && lx < W) {
      const int l0 = lx == 0 ? W - 1 : lx - 1;
      d0 = sext8(V[(pws + l0) % W]);
      d1 = sext8(U[(pws + lx) % W]);
    }
    const bool in0 = pst0 <= h0t && h0t <= pen0;
    const bool in1 = pst0 <= h0t + 1 && h0t + 1 <= pen0;
    const bool case12 = in0 && in1;
    const bool step_t = case12 && d1 >= d0;
    H0 += case12 ? (step_t ? d1 : d0) : (in0 ? d0 : d1);
    h0t += (step_t || !in0) ? 1 : 0;
  }
  if (pfin) score = H0;
}

__global__ void __launch_bounds__(1024) exts2_kernel(
    const uint8_t* __restrict__ qr, const uint8_t* __restrict__ sf,
    const int8_t* __restrict__ dn, const int8_t* __restrict__ ac,
    const int* __restrict__ lens, uint8_t* __restrict__ p,
    int* __restrict__ ez, int QP, int TP, int W, int RT, int q, int e,
    int q2, int long_thres, int long_diff, int sc_mch, int sc_mis,
    int sc_N) {
  extern __shared__ int smem[];
  int* bx = smem;             // [2][W] carried rows, double-buffered
  int* bv = bx + 2 * W;
  int* bx2 = bv + 2 * W;
  int* bu = bx2 + 2 * W;
  uint8_t* qs = reinterpret_cast<uint8_t*>(bu + 2 * W);   // reversed query
  uint8_t* ts = qs + QP;                                   // target
  int8_t* ds = reinterpret_cast<int8_t*>(ts + TP);         // donor
  int8_t* as = ds + TP;                                    // acceptor

  const int n = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int qlen = lens[2 * n], tlen = lens[2 * n + 1];
  const int rstar = qlen + tlen - 1;
  for (int i = tid; i < QP; i += T) qs[i] = qr[(size_t)n * QP + i];
  for (int i = tid; i < TP; i += T) {
    ts[i] = sf[(size_t)n * TP + i];
    ds[i] = dn[(size_t)n * TP + i];
    as[i] = ac[(size_t)n * TP + i];
  }
  uint8_t* prow = p + (size_t)n * RT * W;

  const int qe = q + e;
  int u[LPT], v[LPT], x[LPT], y[LPT], x2[LPT], s[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    u[k] = v[k] = x[k] = y[k] = -qe;
    x2[k] = -q2;
    s[k] = 0;
    const int ph = k * T + tid;
    if (ph < W) {             // the rows "before" diagonal 0 (buffer 1)
      bx[W + ph] = -qe; bv[W + ph] = -qe; bx2[W + ph] = -q2; bu[W + ph] = -qe;
    }
  }
  int zdr = 0, last_st = 0, nr = 0, H0 = 0, h0t = 0, score = NEG_INF32;
  // the H0 walk of the previous diagonal, run after the next barrier
  int pw_r = -1, pw_ws = 0, pw_st0 = 0, pw_en0 = 0;
  bool pw_fin = false;
  __syncthreads();

  int r = 0;
  for (; r < RT; ++r) {
    const int cur = (r & 1) * W, prv = W - cur;
    if (pw_r >= 0) {
      h0_walk(bv + prv, bu + prv, W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin,
              qe, H0, h0t, score);
      pw_r = -1;
    }
    // the whole valid diagonal (the same in every thread: uniform break)
    const int st0 = max(0, r - qlen + 1);
    const int en0 = min(tlen - 1, r);
    if (r >= rstar || st0 > en0) {
      if (r < rstar) zdr = 1;      // the band died before the last cell
      break;
    }
    const int ws_prev = wstart_q(r - 1, QP), ws = wstart_q(r, QP);
    const bool adv = ws != ws_prev;
    const int off = ws % W;
    const int st = (st0 >> 4) << 4;
    const int en = (((en0 + 16) >> 4) << 4) - 1;
    // boundary values at st - 1, in the previous diagonal's window
    const bool use_prev = st - last_st == 16 && st > 0;
    const int pre = st - 1 - ws_prev;
    int x_b = 0, x2_b = 0, v_b = 0;
    if (pre >= 0 && pre < W) {
      const int ph = (st - 1) % W;
      x_b = sext8(bx[prv + ph]);
      x2_b = sext8(bx2[prv + ph]);
      v_b = sext8(bv[prv + ph]);
    }
    const int x1 = use_prev ? x_b : -qe;
    const int x21 = use_prev ? x2_b : -q2;
    const int v1_edge = r == 0 ? -qe
                        : r < long_thres ? -e
                        : r == long_thres ? long_diff : 0;
    const int v1 = use_prev ? v_b : (st > 0 ? -qe : v1_edge);
    const int s_hi = st0 + (((en0 - st0) >> 4) << 4) + 15;
    const int stl = st - ws;
    const bool at_r_on = en >= r;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int ph = k * T + tid;
      if (ph >= W) continue;
      int l = ph - off;
      if (l < 0) l += W;
      const int t = ws + l;
      if (adv && l >= W - 16) {    // wrapped slot: the shift's fill values
        u[k] = v[k] = x[k] = y[k] = -qe;
        x2[k] = -q2;
        s[k] = 0;
      }
      const bool at_r = t == r && at_r_on;
      const int y_p = at_r ? -qe : y[k];
      const int x2_p = at_r ? -q2 : x2[k];
      const int u_p = at_r ? v1_edge : u[k];
      // left neighbour (lane l - 1; lane 0 reads lane W - 1)
      int xt1, vt1, x2t1;
      if (l == stl) {
        xt1 = x1; vt1 = v1; x2t1 = x21;
      } else {
        const int nl = l == 0 ? W - 1 : l - 1;
        if (adv && nl >= W - 16) {
          xt1 = -qe; vt1 = -qe; x2t1 = -q2;
        } else {
          const int pn = ph == 0 ? W - 1 : ph - 1;
          xt1 = bx[prv + pn];
          vt1 = bv[prv + pn];
          x2t1 = (ws + nl == r && at_r_on) ? -q2 : bx2[prv + pn];
        }
      }
      // score row: only [st0, s_hi] is rewritten; other lanes keep stale s
      if (t >= st0 && t <= s_hi) {
        const int tq = t < TP ? ts[t] : 0;
        const int qi = t - r + qlen - 1;
        const int qq = (qi >= 0 && qi < qlen) ? qs[qi] : 0;
        s[k] = (tq == 4 || qq == 4) ? sc_N : (tq == qq ? sc_mch : sc_mis);
      }
      const int dnv = t < TP ? ds[t] : 0, acv = t < TP ? as[t] : 0;
      int a = wrap8(xt1 + vt1), b = wrap8(y_p + u_p), a2 = wrap8(x2t1 + vt1);
      const int a2a = wrap8(a2 + acv);
      int z = s[k], d = 0;
      if (a > z) d = 1;
      z = max(z, a);
      if (b > z) d = 2;
      z = max(z, b);
      if (a2a > z) d = 3;
      z = max(z, a2a);
      const int u_new = wrap8(z - vt1), v_new = wrap8(z - u_p);
      const int t1 = wrap8(z - q);
      a = wrap8(a - t1);
      b = wrap8(b - t1);
      a2 = wrap8(a2 - wrap8(z - q2));
      const bool ga = a > 0, gb = b > 0, g2 = a2 > dnv;
      const bool m_upd = t >= st && t <= en;
      if (m_upd) {
        u[k] = u_new;
        v[k] = v_new;
        x[k] = wrap8((ga ? a : 0) - qe);
        y[k] = wrap8((gb ? b : 0) - qe);
        x2[k] = wrap8((g2 ? a2 : dnv) - q2);
      } else {
        u[k] = u_p;
        y[k] = y_p;
        x2[k] = x2_p;
      }
      bx[cur + ph] = x[k];
      bv[cur + ph] = v[k];
      bx2[cur + ph] = x2[k];
      bu[cur + ph] = u[k];
      d |= (ga ? 0x08 : 0) | (gb ? 0x10 : 0) | (g2 ? 0x20 : 0);
      prow[(size_t)r * W + l] = m_upd ? (uint8_t)d : 0;
    }
    pw_r = r; pw_ws = ws; pw_st0 = st0; pw_en0 = en0;
    pw_fin = r == rstar - 1 && en0 == tlen - 1;
    last_st = st;
    nr = r + 1;
    __syncthreads();
  }
  if (pw_r >= 0) {           // every diagonal was live: walk the last one
    const int b = ((r - 1) & 1) * W;
    h0_walk(bv + b, bu + b, W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe, H0,
            h0t, score);
  }
  // rows past the job's end are 0
  uint4* z4 = reinterpret_cast<uint4*>(prow + (size_t)r * W);
  const size_t n16 = (size_t)(RT - r) * W / 16;
  for (size_t i = tid; i < n16; i += T) z4[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    int* o = ez + (size_t)n * EZ_N;
    const int vals[EZ_N] = {0, zdr, -1, -1, NEG_INF32, -1, NEG_INF32, -1,
                            score, last_st, 0, nr, H0, h0t, 0, 0};
    for (int i = 0; i < EZ_N; ++i) o[i] = vals[i];
  }
}

}  // namespace

extern "C" int mm2_exts2(const void* qr, const void* sf, const void* dn,
                         const void* ac, const void* lens, void* p, void* ez,
                         int N, int QP, int TP, int W, int RT, int q, int e,
                         int q2, int long_thres, int long_diff, int sc_mch,
                         int sc_mis, int sc_N, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)8 * W * sizeof(int) + QP + 3 * (size_t)TP;
  cudaError_t err = cudaFuncSetAttribute(
      exts2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((W + LPT - 1) / LPT + 31) / 32 * 32;
  exts2_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)qr, (const uint8_t*)sf, (const int8_t*)dn,
      (const int8_t*)ac, (const int*)lens, (uint8_t*)p, (int*)ez, QP, TP, W,
      RT, q, e, q2, long_thres, long_diff, sc_mch, sc_mis, sc_N);
  return (int)cudaGetLastError();
}
