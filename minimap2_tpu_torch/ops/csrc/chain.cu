// Windowed chaining DP over sorted anchors on Hopper.
//
// Replaces minimap2_tpu/ops/chain_pallas.py: chain_batch -> _chain_kernel
// (the Pallas kernel at chain_pallas.py:39-176).  For anchor i of a read,
// the best of the last WND = 64 anchors as predecessor under comput_sc
// (lchain.c:113-138) with the float32 mg_log2 penalty (mmpriv.h:139-147);
// ties go to the largest predecessor index j.  Outputs f, pred, qs and rs
// as (B, A) int32.
//
// What bounds it: latency and instruction count, not bytes or operations.
// Each read is one sequential chain of up to A dependent steps (step a reads
// the f that step a - 1 wrote), each a max over 64 candidates; device memory
// sees 25 bytes per anchor.  One warp runs a read, alone on its scheduler
// (512 reads fill the card with a warp or so a scheduler), so a step costs
// the latency of its dependent chain or its instruction count, whichever is
// larger.  Design: the 64 window slots two per lane in registers (slot s on
// lane s / 2; anchor a's slot is a % 64).  Of anchor a's candidates only the
// newest, a - 1, waits on f(a - 1): the other 63 are reduced during step
// a - 1 with two __reduce_max_sync (the score, then j among the ties), and
// step a is one add and two compares, done alike by every lane, so f never
// crosses lanes; ties go to a - 1, the largest j.  The part of a score that
// does not depend on f (comput_sc's gain, with the float penalty) is taken
// two steps ahead of its use, branch-free, so its float chain overlaps the
// steps between; for that a slot takes its anchor's coordinates two steps
// before its f (no gain reads the old ones then).  The winner's chain start
// comes from its owner lane with one __shfl_sync each for qs and rs (j is
// unique among live slots).  The read's anchor planes are staged through
// shared memory in chunks of 128 anchors (16-byte cp.async, three buffers:
// the chunk walked, the next one, and one in flight), and the four output
// planes leave a chunk at a time in coalesced stores.  A warp stops its DP
// after the read's last valid anchor and writes the remaining lanes in
// closed form, so the loop follows the data.
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

constexpr int WND = 64;
constexpr int NEG_INF = -0x40000000;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int CH = 128;             // anchors a staged chunk
constexpr int NBUF = 3;             // chunk buffers
constexpr int PLANES = 5;           // rev, rid, rpos, qpos, span

struct Stage {                      // one chunk of a read's anchors
  int pl[PLANES][CH];
  uint8_t av[CH];
};
constexpr int SMEM = NBUF * (int)sizeof(Stage) + 4 * CH * 4;
static_assert(sizeof(Stage) % 16 == 0, "16-byte pieces");

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
// BARRED.  Branch-free, so that a warp's two slots and the scores of the
// next steps interleave; a barred join's float path runs on zeros.
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

__global__ void __launch_bounds__(32)
chain_kernel(const int32_t* __restrict__ rev, const int32_t* __restrict__ rid,
             const int32_t* __restrict__ rpos,
             const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ span, const uint8_t* __restrict__ av,
             int32_t* __restrict__ f_out, int32_t* __restrict__ pred_out,
             int32_t* __restrict__ qs_out, int32_t* __restrict__ rs_out,
             int A, Params prm) {
  extern __shared__ uint4 smem[];
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
      const int owner = (bo_j & (WND - 1)) >> 1;
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
      const int sl = a & (WND - 1);
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
      const int s2 = (a + 2) & (WND - 1);
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

}  // namespace

extern "C" int mm2_chain(const void* rev, const void* rid, const void* rpos,
                         const void* qpos, const void* span, const void* av,
                         void* f, void* pred, void* qs, void* rs, int B, int A,
                         int wnd, int max_dist_x, int max_dist_y, int bw,
                         float gap, float skip, void* stream) {
  if (wnd != WND || A % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  const int max_dq = max_dist_x < max_dist_y ? max_dist_x : max_dist_y;
  chain_kernel<<<B, 32, SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)rev, (const int32_t*)rid, (const int32_t*)rpos,
      (const int32_t*)qpos, (const int32_t*)span, (const uint8_t*)av,
      (int32_t*)f, (int32_t*)pred, (int32_t*)qs, (int32_t*)rs, A,
      Params{max_dq > 0 ? max_dq : 0, bw, gap, skip});
  return (int)cudaGetLastError();
}

// blocks (one read each) of the chain DP one SM holds at once
extern "C" int mm2_chain_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chain_kernel, 32, SMEM);
}
