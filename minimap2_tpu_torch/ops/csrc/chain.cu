// Windowed chaining DP over sorted anchors on Hopper.
//
// Replaces minimap2_tpu/ops/chain_pallas.py: chain_batch -> _chain_kernel
// (the Pallas kernel at chain_pallas.py:39-176).  For anchor i of a read,
// the best of the last WND anchors as predecessor under comput_sc
// (lchain.c:113-138) with the float32 mg_log2 penalty (mmpriv.h:139-147);
// ties go to the largest predecessor index j.  Any WND the JAX kernel takes
// (its ring slot is a % WND); the paths run WND = 64 (BatchParams'
// chain_window), which keeps a kernel of its own (chain64_kernel, the
// design below at two slots a lane with the slot a mask of the anchor
// index).  Outputs f, pred, qs and rs as (B, A) int32.
//
// What bounds it: latency and instruction count, not bytes or operations.
// Each read is one sequential chain of up to A dependent steps (step a reads
// the f that step a - 1 wrote), each a max over WND candidates; device
// memory sees 25 bytes per anchor.  One warp runs a read, alone on its
// scheduler (512 reads fill the card with a warp or so a scheduler), so a
// step costs the latency of its dependent chain or its instruction count,
// whichever is larger.  Design: the window's slots SL a lane in registers
// (slot s on lane s / SL; anchor a's slot is a % WND, kept as a counter, as
// WND need not be a power of two), SL = 1, 2, 4 or 8 by the window (WND up
// to 32, 64, 128, 256; the slots past WND stay empty), one instantiation
// each.  Of anchor a's candidates only the newest, a - 1, waits on f(a -
// 1): the others are reduced during step a - 1, each lane over its slots
// and then the warp with two __reduce_max_sync (the score, then j among
// the ties), and step a is one add and two compares, done alike by every
// lane, so f never crosses lanes; ties go to a - 1, the largest j.  The
// part of a score that does not depend on f (comput_sc's gain, with the
// float penalty) is taken two steps ahead of its use, branch-free, so its
// float chain overlaps the steps between; for that a slot takes its
// anchor's coordinates two steps before its f (no gain reads the old ones
// then; at WND 1 and 2 the slot a + 2 takes is the one a or a + 1 holds,
// so the start places anchor 0, takes the gains for anchor 1, and only
// then places anchor 1).  The winner's chain start comes from its owner
// lane with one __shfl_sync each for qs and rs (j is unique among live
// slots).  Past 256 slots (SL = 0) the window is a ring in shared memory,
// nine ints a slot (f, the coordinates, qs, rs, j: 36 WND bytes, so WND up
// to 6,176 on a block's 227 KB; chain.max_window): lane l scores slots l,
// l + 32, ... with the gain taken at the step that uses it, the same
// two-stage reduction picks the best, lane 0 writes anchor a's coordinates
// and results into slot a % WND after the step, and every lane reads the
// winner's qs and rs from the ring.  The read's anchor planes are staged
// through shared memory in chunks of 128 anchors (16-byte cp.async, three
// buffers: the chunk walked, the next one, and one in flight), and the
// four output planes leave a chunk at a time in coalesced stores.  A warp
// stops its DP after the read's last valid anchor and writes the
// remaining lanes in closed form, so the loop follows the data.
// Resources (`nvcc -Xptxas -v` for sm_90a), no spills:
// chain_kernel<1> 64 registers, <2> 80, <4> 120, <8> 168, the ring <0>
// 64, chain64_kernel 80; 10,112 bytes of dynamic shared memory a block
// (staging and output), the ring 36 WND more.
//
// Float hazard: pen = trunc(lin + 0.5 * logp) with a polynomial mg_log2; a
// fused multiply-add could move the truncation.  Every float op below is
// an explicit round-to-nearest intrinsic, and the file is compiled with
// --fmad=false as a second guard.  The constants are the float32 values of
// the reference's decimal literals, written in hex.
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -0x40000000;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int CH = 128;             // anchors a staged chunk
constexpr int NBUF = 3;             // chunk buffers
constexpr int PLANES = 5;           // rev, rid, rpos, qpos, span
constexpr int MAX_SL = 8;           // window slots a lane in registers
constexpr int RING = 9;             // f rv ri rp qp sp qs rs j: a ring slot

struct Stage {                      // one chunk of a read's anchors
  int pl[PLANES][CH];
  uint8_t av[CH];
};
// staging and output rows; the shared-memory ring's RING ints a slot after
constexpr int SMEM = NBUF * (int)sizeof(Stage) + 4 * CH * 4;
static_assert(sizeof(Stage) % 16 == 0, "16-byte pieces");

// window slots a lane (1, 2, 4 or 8: slots in registers) or 0 (the ring
// in shared memory) for a window of wnd slots
__host__ __device__ inline int slots_a_lane(int wnd) {
  return wnd <= 32 ? 1 : wnd <= 64 ? 2 : wnd <= 128 ? 4 : wnd <= 256 ? 8 : 0;
}

__host__ __device__ inline int smem_of(int wnd) {
  return SMEM + (slots_a_lane(wnd) ? 0 : RING * 4 * wnd);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// pos - span + 1 with int32 wrap-around, as the reference planes compute it
__device__ __forceinline__ int chain_start(int pos, int span) {
  return (int)((unsigned)pos - (unsigned)span + 1u);
}

__device__ __forceinline__ float mg_log2(float x) {
  unsigned zi = __float_as_uint(x);
  const float log2i = __int2float_rn((int)((zi >> 23) & 255u) - 128);
  zi = (zi & 0x007FFFFFu) | (127u << 23);
  const float zf = __uint_as_float(zi);
  float t = __fadd_rn(__fmul_rn(-0x1.611ff2p-2f, zf), 0x1.032840p+1f);
  t = __fsub_rn(__fmul_rn(t, zf), 0x1.59898ep-1f);
  return __fadd_rn(log2i, t);
}

struct Anchor {
  int rv, ri, rp, qp, sp;
  bool ok;
};

struct Slot {
  int f, rv, ri, rp, qp, sp, qs, rs, j;
};

struct Params {
  int max_dq, bw;       // max_dq: min(max_dist_x, max_dist_y), at least 0
  float gap, skip;
};

constexpr int BARRED = INT_MIN;     // gain of a join comput_sc bars

// comput_sc without the predecessor's f (the candidate is f + gain), or
// BARRED.  Branch-free, so that a warp's slots and the scores of the next
// steps interleave; a barred join's float path runs on zeros.
__device__ __forceinline__ int gain(const Slot& s, const Anchor& x,
                                    const Params& c) {
  const int dq = wrap_sub(x.qp, s.qp);
  const int dr = wrap_sub(x.rp, s.rp);
  const int diff = wrap_sub(dr, dq);
  const int dd = diff < 0 ? (int)(0u - (unsigned)diff) : diff;
  // dq <= 0 || dq > max_dist_x || dq > max_dist_y, other strand / contig
  const bool bad = (unsigned)dq - 1u >= (unsigned)c.max_dq || dr == 0 ||
                   dd > c.bw || ((s.rv ^ x.rv) | (s.ri ^ x.ri)) != 0;
  const int dg = dr < dq ? dr : dq;
  const int sc = s.sp < dg ? s.sp : dg;
  const int ddf = bad ? 0 : dd, dgf = bad ? 0 : dg;
  const float lin = __fadd_rn(__fmul_rn(c.gap, __int2float_rn(ddf)),
                              __fmul_rn(c.skip, __int2float_rn(dgf)));
  const float lg = mg_log2(__int2float_rn(ddf + 1));
  const float logp = ddf >= 1 ? lg : 0.0f;
  const int pen = __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, logp)));
  return bad ? BARRED : (dd != 0 || dg > s.sp) ? sc - pen : sc;
}

// slot s takes anchor x's coordinates where `on` (selects, no branch)
__device__ __forceinline__ void place(Slot& s, bool on, const Anchor& x) {
  s.rv = on ? x.rv : s.rv;
  s.ri = on ? x.ri : s.ri;
  s.rp = on ? x.rp : s.rp;
  s.qp = on ? x.qp : s.qp;
  s.sp = on ? x.sp : s.sp;
}

// slot s takes a step's results where `on`
__device__ __forceinline__ void result(Slot& s, bool on, int f, int qs,
                                       int rs, int j) {
  s.f = on ? f : s.f;
  s.qs = on ? qs : s.qs;
  s.rs = on ? rs : s.rs;
  s.j = on ? j : s.j;
}

__device__ __forceinline__ int cand(int f, int g) {
  return g != BARRED && f > NEG_INF / 2 ? f + g : NEG_INF;
}

__device__ __forceinline__ Anchor load_anchor(const Stage& s, int t) {
  return {s.pl[0][t], s.pl[1][t], s.pl[2][t], s.pl[3][t], s.pl[4][t],
          s.av[t] != 0};
}

// anchors [k CH, (k + 1) CH) of the read (those below A) into st
__device__ __forceinline__ void stage_chunk(Stage& st,
                                            const int32_t* const* pl,
                                            const uint8_t* avr, int k, int A,
                                            int lane) {
  const int a = k * CH + 4 * lane;
  if (a < A)
    for (int q = 0; q < PLANES; ++q)
      __pipeline_memcpy_async(&st.pl[q][4 * lane], pl[q] + a, 16);
  const int b = k * CH + 16 * lane;
  if (lane < CH / 16 && b < A)
    __pipeline_memcpy_async(&st.av[16 * lane], avr + b, 16);
}

__device__ __forceinline__ uint4* dyn_smem() {
  extern __shared__ uint4 smem[];
  return smem;
}

// The paths' window, WND = 64, two slots a lane, as its own kernel:
// chain_kernel<2> below computes the same at WND 64 but took 1.8x its
// time a step on the H100 (1.20-1.29 ms against 0.66-0.70 at 512 x 4096,
// scripts/torch_chain_check.py), with the same 80 registers and no stack
// frame, and neither a compile-time window nor this kernel's statement
// order closed the gap
constexpr int W64 = 64;

__global__ void __launch_bounds__(32)
chain64_kernel(const int32_t* __restrict__ rev, const int32_t* __restrict__ rid,
             const int32_t* __restrict__ rpos,
             const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ span, const uint8_t* __restrict__ av,
             int32_t* __restrict__ f_out, int32_t* __restrict__ pred_out,
             int32_t* __restrict__ qs_out, int32_t* __restrict__ rs_out,
             int A, int, Params prm) {
  uint4* smem = dyn_smem();
  Stage* st = (Stage*)smem;
  int(*out)[CH] = (int(*)[CH])(st + NBUF);      // f, pred, qs, rs
  const int lane = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * A;
  const int32_t* pl[PLANES] = {rev + row, rid + row, rpos + row, qpos + row,
                               span + row};
  const uint8_t* avr = av + row;

  // 1 + the last valid anchor of this read, 16 av bytes a lane a round
  int last = -1;
  for (int base = 16 * lane; base < A; base += 16 * 32) {
    const uint4 v = *(const uint4*)(avr + base);
    const unsigned wd[4] = {v.x, v.y, v.z, v.w};
    for (int t = 3; t >= 0; --t)
      if (wd[t]) {
        last = base + 4 * t + (31 - __clz((int)wd[t])) / 8;
        break;
      }
  }
  const int n = __reduce_max_sync(FULL, last) + 1;
  const int nch = (n + CH - 1) / CH;
  for (int k = 0; k < 2; ++k) {
    if (k < nch) stage_chunk(st[k], pl, avr, k, A, lane);
    __pipeline_commit();
  }

  Slot s0 = {NEG_INF, 0, 0, 0, 0, 0, 0, 0, -1};
  Slot s1 = s0;
  // uniform across the warp: anchors a .. a + 2 (cur, nx, nx2), f / qs /
  // rs of a - 1, the best of a's window without a - 1 (bo_c, bo_j) and the
  // gain a - 1 -> a (gn).  A slot takes its anchor's coordinates two steps
  // before its f, qs, rs and j (no gain reads the old ones then), so the
  // gains of a lane's two slots can be taken two steps ahead: for a + 1
  // (gA0, gA1) and for a + 2 (gB0, gB1).  Slot a % 64 in gA is anchor a,
  // and its gain there is the next step's gn.
  Anchor cur, nx, nx2;
  int f_prev = NEG_INF, qs_prev = 0, rs_prev = 0;
  int bo_c = NEG_INF, bo_j = -1, gn = BARRED;
  int gA0 = BARRED, gA1 = BARRED, gB0 = BARRED, gB1 = BARRED;
  for (int k = 0; k < nch; ++k) {
    if (k + 2 < nch) stage_chunk(st[(k + 2) % NBUF], pl, avr, k + 2, A, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);               // chunks k and k + 1 are in
    __syncwarp();
    const Stage& sc = st[k % NBUF];
    const Stage& sn = st[(k + 1) % NBUF];
    const int a0 = k * CH, a1 = min(n, a0 + CH);
    if (k == 0) {       // slots 0 and 1 take anchors 0 and 1
      cur = load_anchor(sc, 0);
      nx = load_anchor(sc, 1);
      nx2 = load_anchor(sc, 2);
      place(s0, lane == 0, cur);
      place(s1, lane == 0, nx);
      gA0 = gain(s0, nx, prm);
      gA1 = gain(s1, nx, prm);
      gB0 = gain(s0, nx2, prm);
      gB1 = gain(s1, nx2, prm);
    }
#pragma unroll 2
    for (int a = a0; a < a1; ++a) {
      // step a: the newer of (a - 1, its join) and the best older slot
      const int cn = cand(f_prev, gn);
      const bool take = cn >= bo_c;
      const int bc = take ? cn : bo_c;
      const bool use = cur.ok && bc >= cur.sp;
      const int f_a = cur.ok ? max(bc, cur.sp) : NEG_INF;
      const bool odd = bo_j & 1;
      const int owner = (bo_j & (W64 - 1)) >> 1;
      const int wq = __shfl_sync(FULL, odd ? s1.qs : s0.qs, owner);
      const int wr = __shfl_sync(FULL, odd ? s1.rs : s0.rs, owner);
      const int qs_a = use ? (take ? qs_prev : wq)
                           : chain_start(cur.qp, cur.sp);
      const int rs_a = use ? (take ? rs_prev : wr)
                           : chain_start(cur.rp, cur.sp);
      if (lane == 0) {
        out[0][a - a0] = f_a;
        out[1][a - a0] = use ? (take ? a - 1 : bo_j) : -1;
        out[2][a - a0] = qs_a;
        out[3][a - a0] = rs_a;
      }
      // a + 1's best without a, off step a's path (f(a - 1) is in its
      // slot); its gain from a from the owner of slot a % 64
      const int sl = a & (W64 - 1);
      const int c0 = 2 * lane == sl ? INT_MIN : cand(s0.f, gA0);
      const int c1 = 2 * lane + 1 == sl ? INT_MIN : cand(s1.f, gA1);
      int c = c0, j = s0.j;
      if (c1 > c || (c1 == c && s1.j > j)) { c = c1; j = s1.j; }
      bo_c = __reduce_max_sync(FULL, c);
      bo_j = __reduce_max_sync(FULL, c == bo_c ? j : INT_MIN);
      gn = __shfl_sync(FULL, sl & 1 ? gA1 : gA0, sl >> 1);
      // the ring: step a's results into slot a % 64, anchor a + 2's
      // coordinates into slot (a + 2) % 64
      result(s0, 2 * lane == sl, f_a, qs_a, rs_a, a);
      result(s1, 2 * lane + 1 == sl, f_a, qs_a, rs_a, a);
      const int s2 = (a + 2) & (W64 - 1);
      place(s0, 2 * lane == s2, nx2);
      place(s1, 2 * lane + 1 == s2, nx2);
      // the gains for a + 3, used two steps on (past n the staged bytes
      // are read but no step uses them)
      const Anchor nx3 = load_anchor(a + 3 < a0 + CH ? sc : sn,
                                     (a + 3 - a0) % CH);
      gA0 = gB0;
      gA1 = gB1;
      gB0 = gain(s0, nx3, prm);
      gB1 = gain(s1, nx3, prm);
      f_prev = f_a;
      qs_prev = qs_a;
      rs_prev = rs_a;
      cur = nx;
      nx = nx2;
      nx2 = nx3;
    }
    __syncwarp();
    for (int t = lane; t < a1 - a0; t += 32) {
      f_out[row + a0 + t] = out[0][t];
      pred_out[row + a0 + t] = out[1][t];
      qs_out[row + a0 + t] = out[2][t];
      rs_out[row + a0 + t] = out[3][t];
    }
    __syncwarp();
  }
  for (int a = n + lane; a < A; a += 32) {
    const int sp = span[row + a];
    f_out[row + a] = NEG_INF;
    pred_out[row + a] = -1;
    qs_out[row + a] = chain_start(qpos[row + a], sp);
    rs_out[row + a] = chain_start(rpos[row + a], sp);
  }
}


// v[i] of a lane's SL values for a warp-uniform i, by masks: nvcc turns
// a select chain on i into an indexed load, which puts v in local memory
// (at WND 64 that took twice the time a step)
template <int SL>
__device__ __forceinline__ int pick(const int (&v)[SL], unsigned i) {
  int x = 0;
#pragma unroll
  for (int k = 0; k < SL; ++k) x |= v[k] & -(int)(i == (unsigned)k);
  return x;
}

// SL slots a lane in registers (slot s on lane s / SL), or SL = 0: the
// window's slots in a shared-memory ring (slot s's fields at ring[f][s])
template <int SL>
__global__ void __launch_bounds__(32)
chain_kernel(const int32_t* __restrict__ rev, const int32_t* __restrict__ rid,
             const int32_t* __restrict__ rpos,
             const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ span, const uint8_t* __restrict__ av,
             int32_t* __restrict__ f_out, int32_t* __restrict__ pred_out,
             int32_t* __restrict__ qs_out, int32_t* __restrict__ rs_out,
             int A, int WND, Params prm) {
  constexpr int NS = SL ? SL : 1;   // register slots a lane
  uint4* smem = dyn_smem();
  Stage* st = (Stage*)smem;
  int(*out)[CH] = (int(*)[CH])(st + NBUF);      // f, pred, qs, rs
  int* ring = (int*)(out + 4);                  // [RING][WND], SL == 0
  const int lane = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * A;
  const int32_t* pl[PLANES] = {rev + row, rid + row, rpos + row, qpos + row,
                               span + row};
  const uint8_t* avr = av + row;

  // 1 + the last valid anchor of this read, 16 av bytes a lane a round
  int last = -1;
  for (int base = 16 * lane; base < A; base += 16 * 32) {
    const uint4 v = *(const uint4*)(avr + base);
    const unsigned wd[4] = {v.x, v.y, v.z, v.w};
    for (int t = 3; t >= 0; --t)
      if (wd[t]) {
        last = base + 4 * t + (31 - __clz((int)wd[t])) / 8;
        break;
      }
  }
  const int n = __reduce_max_sync(FULL, last) + 1;
  const int nch = (n + CH - 1) / CH;
  for (int k = 0; k < 2; ++k) {
    if (k < nch) stage_chunk(st[k], pl, avr, k, A, lane);
    __pipeline_commit();
  }
  if constexpr (SL == 0) {          // empty slots: f NEG_INF, j -1
    for (int i = lane; i < RING * WND; i += 32)
      ring[i] = i < WND ? NEG_INF : i >= 8 * WND ? -1 : 0;
    __syncwarp();
  }

  Slot s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) s[k] = {NEG_INF, 0, 0, 0, 0, 0, 0, 0, -1};
  // uniform across the warp: anchors a .. a + 2 (cur, nx, nx2), f / qs /
  // rs of a - 1, the best of a's window without a - 1 (bo_c, bo_j) and the
  // gain a - 1 -> a (gn).  In registers a slot takes its anchor's
  // coordinates two steps before its f, qs, rs and j (no gain reads the
  // old ones then), so the gains of a lane's slots can be taken two steps
  // ahead: for a + 1 (gA) and for a + 2 (gB).  Slot a % WND in gA is
  // anchor a, and its gain there is the next step's gn.  The ring takes
  // an anchor's coordinates and results together, and its gains are taken
  // at the step that uses them.
  Anchor cur, nx, nx2;
  int f_prev = NEG_INF, qs_prev = 0, rs_prev = 0;
  int bo_c = NEG_INF, bo_j = -1, gn = BARRED;
  int gA[NS], gB[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) gA[k] = gB[k] = BARRED;
  int sl = 0;                       // a % WND
  int s2 = 2 % WND;                 // (a + 2) % WND
  for (int k = 0; k < nch; ++k) {
    if (k + 2 < nch) stage_chunk(st[(k + 2) % NBUF], pl, avr, k + 2, A, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);               // chunks k and k + 1 are in
    __syncwarp();
    const Stage& sc = st[k % NBUF];
    const Stage& sn = st[(k + 1) % NBUF];
    const int a0 = k * CH, a1 = min(n, a0 + CH);
    if (k == 0) {
      cur = load_anchor(sc, 0);
      nx = load_anchor(sc, 1);
      nx2 = load_anchor(sc, 2);
      if constexpr (SL) {
        // anchor 0 into slot 0, the gains for anchor 1; anchor 1 into
        // slot 1 % WND, the gains for anchor 2
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          place(s[i], lane * SL + i == 0, cur);
          gA[i] = gain(s[i], nx, prm);
        }
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          place(s[i], lane * SL + i == 1 % WND, nx);
          gB[i] = gain(s[i], nx2, prm);
        }
      }
    }
#pragma unroll 2
    for (int a = a0; a < a1; ++a) {
      // step a: the newer of (a - 1, its join) and the best older slot
      const int cn = cand(f_prev, gn);
      const bool take = cn >= bo_c;
      const int bc = take ? cn : bo_c;
      const bool use = cur.ok && bc >= cur.sp;
      const int f_a = cur.ok ? max(bc, cur.sp) : NEG_INF;
      // the slot of bo_j (a - WND <= bo_j <= a - 2 when there is one)
      const int d = sl - (a - bo_j);
      const unsigned bs = bo_j < 0 ? 0 : d < 0 ? d + WND : d;
      int wq, wr;
      if constexpr (SL) {
        int q[SL], r[SL];
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          q[i] = s[i].qs;
          r[i] = s[i].rs;
        }
        wq = __shfl_sync(FULL, pick(q, bs % SL), bs / SL);
        wr = __shfl_sync(FULL, pick(r, bs % SL), bs / SL);
      } else {
        wq = ring[6 * WND + bs];
        wr = ring[7 * WND + bs];
      }
      const int qs_a = use ? (take ? qs_prev : wq)
                           : chain_start(cur.qp, cur.sp);
      const int rs_a = use ? (take ? rs_prev : wr)
                           : chain_start(cur.rp, cur.sp);
      if (lane == 0) {
        out[0][a - a0] = f_a;
        out[1][a - a0] = use ? (take ? a - 1 : bo_j) : -1;
        out[2][a - a0] = qs_a;
        out[3][a - a0] = rs_a;
      }
      // (past n the staged bytes of a + 3 are read but no step uses them)
      Anchor nx3;
      const unsigned sa = sl;
      if constexpr (SL) {
        // a + 1's best without a, off step a's path (f(a - 1) is in its
        // slot): each lane's best of its slots, then the warp's; its gain
        // from a from the owner of slot a % WND
        int c = lane * SL == sa ? INT_MIN : cand(s[0].f, gA[0]), j = s[0].j;
#pragma unroll
        for (int i = 1; i < SL; ++i) {
          const int ci = lane * SL + i == sa ? INT_MIN : cand(s[i].f, gA[i]);
          if (ci > c || (ci == c && s[i].j > j)) {
            c = ci;
            j = s[i].j;
          }
        }
        bo_c = __reduce_max_sync(FULL, c);
        bo_j = __reduce_max_sync(FULL, c == bo_c ? j : INT_MIN);
        gn = __shfl_sync(FULL, pick(gA, sa % SL), sa / SL);
        // the ring: step a's results into slot a % WND, anchor a + 2's
        // coordinates into slot (a + 2) % WND
#pragma unroll
        for (int i = 0; i < SL; ++i)
          result(s[i], lane * SL + i == sa, f_a, qs_a, rs_a, a);
        const unsigned sb = s2;
#pragma unroll
        for (int i = 0; i < SL; ++i) place(s[i], lane * SL + i == sb, nx2);
        // the gains for a + 3, used two steps on
        nx3 = load_anchor(a + 3 < a0 + CH ? sc : sn, (a + 3 - a0) % CH);
#pragma unroll
        for (int i = 0; i < SL; ++i) {
          gA[i] = gB[i];
          gB[i] = gain(s[i], nx3, prm);
        }
      } else {
        nx3 = load_anchor(a + 3 < a0 + CH ? sc : sn, (a + 3 - a0) % CH);
        // a + 1's best without a over the ring (slots lane, lane + 32, ..)
        int c = INT_MIN, j = INT_MIN;
        for (int q = lane; q < WND; q += 32) {
          const Slot v = {ring[q], ring[WND + q], ring[2 * WND + q],
                          ring[3 * WND + q], ring[4 * WND + q],
                          ring[5 * WND + q], 0, 0, ring[8 * WND + q]};
          const int cq = q == sl ? INT_MIN : cand(v.f, gain(v, nx, prm));
          if (cq > c || (cq == c && v.j > j)) {
            c = cq;
            j = v.j;
          }
        }
        bo_c = __reduce_max_sync(FULL, c);
        bo_j = __reduce_max_sync(FULL, c == bo_c ? j : INT_MIN);
        const Slot ca = {0, cur.rv, cur.ri, cur.rp, cur.qp, cur.sp, 0, 0, 0};
        gn = gain(ca, nx, prm);
        __syncwarp();
        if (lane == 0) {            // anchor a and its results, slot a % WND
          const int v[RING] = {f_a, cur.rv, cur.ri, cur.rp, cur.qp, cur.sp,
                               qs_a, rs_a, a};
          for (int i = 0; i < RING; ++i) ring[i * WND + sl] = v[i];
        }
        __syncwarp();
      }
      f_prev = f_a;
      qs_prev = qs_a;
      rs_prev = rs_a;
      cur = nx;
      nx = nx2;
      nx2 = nx3;
      sl = sl + 1 == WND ? 0 : sl + 1;
      s2 = s2 + 1 == WND ? 0 : s2 + 1;
    }
    __syncwarp();
    for (int t = lane; t < a1 - a0; t += 32) {
      f_out[row + a0 + t] = out[0][t];
      pred_out[row + a0 + t] = out[1][t];
      qs_out[row + a0 + t] = out[2][t];
      rs_out[row + a0 + t] = out[3][t];
    }
    __syncwarp();
  }
  for (int a = n + lane; a < A; a += 32) {
    const int sp = span[row + a];
    f_out[row + a] = NEG_INF;
    pred_out[row + a] = -1;
    qs_out[row + a] = chain_start(qpos[row + a], sp);
    rs_out[row + a] = chain_start(rpos[row + a], sp);
  }
}

using ChainFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, const uint8_t*,
                         int32_t*, int32_t*, int32_t*, int32_t*, int, int,
                         Params);

// the instantiation of a window: the paths' WND 64 its own kernel
inline ChainFn chain_variant(int wnd) {
  if (wnd == 64) return chain64_kernel;
  switch (slots_a_lane(wnd)) {
    case 1: return chain_kernel<1>;
    case 2: return chain_kernel<2>;
    case 4: return chain_kernel<4>;
    case 8: return chain_kernel<8>;
    default: return chain_kernel<0>;
  }
}

}  // namespace

// a window's kernel with its dynamic shared memory granted
static int chain_prepare(int wnd, ChainFn* fn) {
  if (wnd < 1) return (int)cudaErrorInvalidValue;
  *fn = chain_variant(wnd);
  return (int)cudaFuncSetAttribute((const void*)*fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_of(wnd));
}

extern "C" int mm2_chain(const void* rev, const void* rid, const void* rpos,
                         const void* qpos, const void* span, const void* av,
                         void* f, void* pred, void* qs, void* rs, int B, int A,
                         int wnd, int max_dist_x, int max_dist_y, int bw,
                         float gap, float skip, void* stream) {
  if (A % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  ChainFn fn;
  const int err = chain_prepare(wnd, &fn);
  if (err) return err;
  const int max_dq = max_dist_x < max_dist_y ? max_dist_x : max_dist_y;
  fn<<<B, 32, smem_of(wnd), (cudaStream_t)stream>>>(
      (const int32_t*)rev, (const int32_t*)rid, (const int32_t*)rpos,
      (const int32_t*)qpos, (const int32_t*)span, (const uint8_t*)av,
      (int32_t*)f, (int32_t*)pred, (int32_t*)qs, (int32_t*)rs, A, wnd,
      Params{max_dq > 0 ? max_dq : 0, bw, gap, skip});
  return (int)cudaGetLastError();
}

// blocks (one read each) of the chain DP one SM holds at once, and the
// route of a window: slots a lane (1, 2, 4, 8) or 0 for the shared ring
extern "C" int mm2_chain_occupancy(int wnd, int* out) {
  ChainFn fn;
  const int err = chain_prepare(wnd, &fn);
  if (err) return err;
  out[1] = slots_a_lane(wnd);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, 32, smem_of(wnd));
}

// the largest window the shared-memory ring takes on this card
extern "C" int mm2_chain_max_window(int* out) {
  int dev, smax;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(
        &smax, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = err ? 0 : (smax - SMEM) / (RING * 4);
  return (int)err;
}
