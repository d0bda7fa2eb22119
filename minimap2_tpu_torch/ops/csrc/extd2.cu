// Banded dual-affine extension with direction bytes (ksw_extd2, approx-max
// mode) on Hopper.
//
// Replaces minimap2_tpu/ops/extend_pallas2.py: extd2_batch2 ->
// _extd2_kernel_v2 (the Pallas kernel at extend_pallas2.py:102-541, called
// at :658) in the mode of the -c/-a path: approx_max, no zdrop, left-align,
// with or without the direction matrix.  Per anti-diagonal r the
// Suzuki-Kasahara difference rows u, v, x, y, x2, y2 and the score row s
// advance over W lanes; lane l is target position wstart_chunk(r) + l, the
// window origin shared by the RB diagonals of a chunk, and the rows shift
// left by dsh lanes (fill -q-e, -q2-e2 or 0) at each chunk boundary, as in
// the Pallas kernel, because stale lanes of s and the boundary values at
// st-1 depend on that layout.  The score comes from the greedy H0 walk
// along the main diagonal.  Outputs p (N, RT, W) u8 direction bytes and
// ez (N, 16) i32; EZ_DEAD is set by the wrapper (ops/extend.py).
//
// What bounds it: the N*RT*W bytes of p it writes (1.03 GB for a 64-job
// sub-batch at QP=12288, TP=12800, W=640), against ~40 integer operations
// per band cell -- about equal on this card.  Design: one block per job,
// one thread per lane, the query and target codes of the job in shared
// memory.  A diagonal needs each lane's left neighbour from the previous
// diagonal and three scalars (the boundary values at st-1, the H0 walk's
// v[t0] and u[t0+1]); the carried x, v, x2, u rows go to a double-buffered
// shared row, so one __syncthreads per diagonal serves both, and every
// thread computes the per-job scalars itself from shared memory after the
// barrier (the H0 walk of diagonal r runs at the start of r+1).  Each
// diagonal's W direction bytes are written by W consecutive threads.  A
// job stops at its first dead diagonal and zero-fills the rest of its p
// rows with 16-byte stores.  Integer arithmetic only.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF32 = -0x40000000;
constexpr int EZ_N = 16;

__device__ __forceinline__ int sext8(int v) {
  return (((v & 255) + 128) & 255) - 128;
}

// uniform window start of diagonal r (>> on int is arithmetic: floor)
__device__ __forceinline__ int wstart(int r, int w) {
  const int a = (r - w + 1) >> 1;
  return ((a > 0 ? a : 0) >> 4) << 4;
}

// greedy H0 walk of one live diagonal pr (extend_pallas2.py:450-491); V
// and U hold that diagonal's v and u rows in its own window (origin pws)
__device__ __forceinline__ void h0_walk(const int* V, const int* U, int W,
                                        int pr, int pws, int pst0, int pen0,
                                        bool pfin, int qe, int& H0, int& h0t,
                                        int& score) {
  if (pr == 0) {
    H0 = V[0] - qe;
    h0t = 0;
  } else {
    const int lx = h0t + 1 - pws;
    int d0 = 0, d1 = 0;
    if (lx >= 0 && lx < W) {
      d0 = sext8(V[lx == 0 ? W - 1 : lx - 1]);
      d1 = sext8(U[lx]);
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

__global__ void __launch_bounds__(1024) extd2_kernel(
    const uint8_t* __restrict__ qr, const uint8_t* __restrict__ sf,
    const int* __restrict__ lens, uint8_t* __restrict__ p,
    int* __restrict__ ez, int QP, int TP, int W, int RB, int RT, int w,
    int q, int e, int q2, int e2, int long_thres, int long_diff, int sc_mch,
    int sc_mis, int sc_N, int with_cigar) {
  extern __shared__ int smem[];
  int* bx = smem;             // [2][W] carried rows, double-buffered
  int* bv = bx + 2 * W;
  int* bx2 = bv + 2 * W;
  int* bu = bx2 + 2 * W;
  int* sh = bu + 2 * W;       // [7][W] every row at a chunk boundary
  uint8_t* qs = reinterpret_cast<uint8_t*>(sh + 7 * W);  // forward query
  uint8_t* ts = qs + QP;                                   // target

  const int n = blockIdx.x, l = threadIdx.x;
  const int qlen = lens[2 * n], tlen = lens[2 * n + 1];
  const int rstar = qlen + tlen - 1;
  const uint8_t* qrow = qr + (size_t)n * QP;
  const uint8_t* trow = sf + (size_t)n * TP;
  for (int i = l; i < QP; i += W)
    qs[i] = (i < qlen && qlen - 1 - i < QP) ? qrow[qlen - 1 - i] : 0;
  for (int i = l; i < TP; i += W) ts[i] = trow[i];
  uint8_t* prow = p + (size_t)n * RT * W;

  const int qe = q + e, qe2 = q2 + e2;
  int u = -qe, v = -qe, x = -qe, y = -qe, x2 = -qe2, y2 = -qe2, s = 0;
  int zdr = 0, last_st = 0, nr = 0, H0 = 0, h0t = 0, score = NEG_INF32;
  int ws = 0;
  // the H0 walk of the previous diagonal, run after the next barrier
  bool pw = false, pw_fin = false;
  int pw_r = 0, pw_ws = 0, pw_st0 = 0, pw_en0 = 0;
  __syncthreads();

  int r = 0;
  for (; r < RT; ++r) {
    if (r > 0 && r % RB == 0) {
      // chunk boundary: walk the last diagonal in the old window, then
      // shift every row left by dsh lanes (chunk_shift, :186-200)
      sh[l] = u; sh[W + l] = v; sh[2 * W + l] = x; sh[3 * W + l] = y;
      sh[4 * W + l] = x2; sh[5 * W + l] = y2; sh[6 * W + l] = s;
      __syncthreads();
      if (pw) {
        h0_walk(sh + W, sh, W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe, H0,
                h0t, score);
        pw = false;
      }
      const int ws_new = wstart(r, w);
      const int src = l + ws_new - ws;
      if (src != l) {
        const bool in = src < W;
        u = in ? sh[src] : -qe;
        v = in ? sh[W + src] : -qe;
        x = in ? sh[2 * W + src] : -qe;
        y = in ? sh[3 * W + src] : -qe;
        x2 = in ? sh[4 * W + src] : -qe2;
        y2 = in ? sh[5 * W + src] : -qe2;
        s = in ? sh[6 * W + src] : 0;
      }
      ws = ws_new;
    }
    const int b = (r & 1) * W;
    bx[b + l] = x; bv[b + l] = v; bx2[b + l] = x2; bu[b + l] = u;
    __syncthreads();
    if (pw) {
      h0_walk(bv + b, bu + b, W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe,
              H0, h0t, score);
      pw = false;
    }
    // band of diagonal r (the same in every thread, so breaks are uniform)
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    if (r >= rstar || st0 > en0) {
      if (r < rstar) zdr = 1;      // the band died before the last cell
      break;
    }
    const int st = (st0 >> 4) << 4;
    const int en = (((en0 + 16) >> 4) << 4) - 1;
    const bool use_prev = st - last_st == 16 && st > 0;
    const int pre = st - 1 - ws;
    int x_b = 0, x2_b = 0, v_b = 0;
    if (pre >= 0 && pre < W) {
      x_b = sext8(bx[b + pre]);
      x2_b = sext8(bx2[b + pre]);
      v_b = sext8(bv[b + pre]);
    }
    const int x1 = use_prev ? x_b : -qe;
    const int x21 = use_prev ? x2_b : -qe2;
    const int v1_edge = r == 0 ? -qe
                        : r < long_thres ? -e
                        : r == long_thres ? long_diff : -e2;
    const int v1 = use_prev ? v_b : (st > 0 ? -qe : v1_edge);

    const int t = ws + l;
    const bool at_r = t == r && en >= r;
    const int y_p = at_r ? -qe : y;
    const int y2_p = at_r ? -qe2 : y2;
    const int u_p = at_r ? v1_edge : u;
    // score row: only [st0, s_hi] is rewritten; other lanes keep stale s
    if (t >= st0 && t <= st0 + (((en0 - st0) >> 4) << 4) + 15) {
      const int tq = t < TP ? ts[t] : 0;
      const int qp = r - t;
      const int qq = (qp >= 0 && qp < qlen && qp < QP) ? qs[qp] : 0;
      s = (tq == 4 || qq == 4) ? sc_N : (tq == qq ? sc_mch : sc_mis);
    }
    const int ln = l == 0 ? W - 1 : l - 1;
    const bool at_stl = l == st - ws;
    const int xt1 = at_stl ? x1 : bx[b + ln];
    const int vt1 = at_stl ? v1 : bv[b + ln];
    const int x2t1 = at_stl ? x21 : bx2[b + ln];
    int a = xt1 + vt1, bb = y_p + u_p, a2 = x2t1 + vt1, b2 = y2_p + u_p;
    int z = s, d = 0;
    if (a > z) d = 1;
    z = max(z, a);
    if (bb > z) d = 2;
    z = max(z, bb);
    if (a2 > z) d = 3;
    z = max(z, a2);
    if (b2 > z) d = 4;
    z = min(max(z, b2), sc_mch);
    a -= z - q; bb -= z - q; a2 -= z - q2; b2 -= z - q2;
    const bool m_upd = t >= st && t <= en;
    if (m_upd) {
      u = z - vt1;
      v = z - u_p;
      x = max(a, 0) - qe;
      y = max(bb, 0) - qe;
      x2 = max(a2, 0) - qe2;
      y2 = max(b2, 0) - qe2;
    } else {
      u = u_p;
      y = y_p;
      y2 = y2_p;
    }
    if (with_cigar) {
      d |= (a > 0 ? 0x08 : 0) | (bb > 0 ? 0x10 : 0) | (a2 > 0 ? 0x20 : 0)
           | (b2 > 0 ? 0x40 : 0);
      prow[(size_t)r * W + l] = m_upd ? (uint8_t)d : 0;
    }
    pw = true;
    pw_r = r; pw_ws = ws; pw_st0 = st0; pw_en0 = en0;
    pw_fin = r == rstar - 1 && en0 == tlen - 1;
    last_st = st;
    nr = r + 1;
  }
  if (pw) {                  // every diagonal was live: walk the last one
    const int b = (r & 1) * W;
    bv[b + l] = v; bu[b + l] = u;
    __syncthreads();
    h0_walk(bv + b, bu + b, W, pw_r, pw_ws, pw_st0, pw_en0, pw_fin, qe, H0,
            h0t, score);
  }
  if (with_cigar) {          // rows past the job's end are 0
    uint4* z4 = reinterpret_cast<uint4*>(prow + (size_t)r * W);
    const size_t n16 = (size_t)(RT - r) * W / 16;
    for (size_t i = l; i < n16; i += W) z4[i] = make_uint4(0, 0, 0, 0);
  }
  if (l == 0) {
    int* o = ez + (size_t)n * EZ_N;
    const int vals[EZ_N] = {0, zdr, -1, -1, NEG_INF32, -1, NEG_INF32, -1,
                            score, last_st, 0, nr, H0, h0t, 0, 0};
    for (int i = 0; i < EZ_N; ++i) o[i] = vals[i];
  }
}

}  // namespace

extern "C" int mm2_extd2(const void* qr, const void* sf, const void* lens,
                         void* p, void* ez, int N, int QP, int TP, int W,
                         int RB, int RT, int w, int q, int e, int q2, int e2,
                         int long_thres, int long_diff, int sc_mch,
                         int sc_mis, int sc_N, int with_cigar, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)15 * W * sizeof(int) + QP + TP;
  cudaError_t err = cudaFuncSetAttribute(
      extd2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  extd2_kernel<<<N, W, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)qr, (const uint8_t*)sf, (const int*)lens, (uint8_t*)p,
      (int*)ez, QP, TP, W, RB, RT, w, q, e, q2, e2, long_thres, long_diff,
      sc_mch, sc_mis, sc_N, with_cigar);
  return (int)cudaGetLastError();
}
