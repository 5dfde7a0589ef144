// Mamba selective scan K7 for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package runs the Mamba head's
// recurrence with lax.scan, repro/models/ssm.py::mamba_apply (ssm.py:176-
// 207, the scan :193-206), outside any kernel.  It is a scan on the hybrid
// family's hot path, once a layer a model call (Hymba-1.5B: 32 a call), and
// as eager ops it would be several launches a step a layer, so it is a
// kernel.  Per (b, d, n), over t = 0 .. S-1, in float32:
//   da_t = exp(delta_t a_n)        dbx_t = (delta_t B_t,n) x_t
//   h_t  = da_t h_{t-1} + dbx_t    y_t   = sum_n h_t C_t,n + x_t d_skip
// x [B, S, DI] (bf16 or float32), delta [B, S, DI], B and C [B, S, N]
// (float32, as JAX makes them), a [DI, N] (-exp(a_log)), d_skip [DI], h0
// [B, DI, N] (zeros when null), all contiguous; y [B, S, DI] in x's type
// (rounded once, as JAX's .astype), the final state [B, DI, N] float32.
// N <= 16.  The forms (the bits differ from the plain version within an
// error envelope, chip_smoke.py check_mamba / check_mamba_bwd;
// tests/test_torch_mamba_forms.py emulates them on the CPU):
//   forward  da = ex2.approx(delta * a2), a2 = a_n log2(e) rounded once a
//            lane: one instruction of the multi-function unit;
//   backward da = exp_of(delta a_n): one ex2 of z = p log2(e) times 1 + (p -
//            z ln 2), so its error does not grow with |delta a_n| (the
//            forward's form drifts by |delta a_n| units in the last place,
//            which a short walk's dh0 = da G does not hide);
//   dbx = (delta B_n) x, each product rounded, as JAX's;
//   h = fma(da, h, dbx): one rounding where JAX's ops round twice;
//   y = fma(x, d_skip, sum_n h C_n), the sum over a lane's states a chain
//       of fmas, then over the channel's lanes by a transposed butterfly.
//
// Bound on an H100: B S DI N exponentials (the multi-function unit: 16 a
// clock an SM, ~4.2 T/s at 1.98 GHz) and ~5 float32 operations an entry,
// against x, delta, B and C read and y written once (3.35 TB/s).  At
// Hymba-1.5B's B 4, S 2,048, DI 1,600, N 16: 210 M exponentials, ~50 us,
// against ~105 MB, ~31 us: the exponentials bound it.
//
// Design of the forward.  A block owns kDPB = 32 channels d of one batch
// row b (grid [DI / kDPB, B]: 200 blocks of 128 threads at Hymba's shape,
// all resident, 1 or 2 an SM), kLPC = 4 lanes a channel, kSPL = 4 states
// a lane in registers for the whole walk (states n >= N hold zeros and
// stay zero).  A chunk's inputs pass through a shared-memory ring of
// kStages stages filled kAhead chunks ahead by cp.async, each byte read
// from global memory once a block (16-byte copies where DI and N allow,
// loads and stores at ragged ones; rows past S and channels past DI land
// as zeros, whose steps leave h as it is): delta [kChunk][kDPB] and x
// [kChunk][kDPB] (in x's type) a channel, B and C [kChunk][16] a batch
// row, read by the lanes with LDS (B and C four states at once).  A lane
// adds its four h C products by fmas; one transposed butterfly over the
// channel's four lanes (two shuffle rounds) leaves lane q the sums of
// steps q kChunk / 4 .. (q + 1) kChunk / 4 - 1, which it finishes (x from
// the ring) and writes.  With checkpoints (a gradient is wanted) the
// forward also writes h before every kCk-th step; they change no bit of y
// or of the final state.  ~32 instructions a lane-step (4 states); what
// paces it is not the multi-function unit, the ring's reads (~10%) or the
// butterfly (~10%) alone (kernel_variants.py k7; PERF.md): 8 or 16 lanes
// a channel, chunks of 16 or 64, the ring 2 ahead and the exponentials
// taken ahead of the recurrence were no faster.
//
// The backward (mamba_scan_bwd_kernel) walks the checkpoint chunks of kCk
// = 16 steps in reverse, their inputs (and dy) through the same ring.  It
// recomputes a chunk's states from its checkpoint, keeping h_{t-1} and
// da_t of all 16 steps in registers (255 a thread, no spill), so the walk
// down takes no second exponential.  Then, with G = dL/dh_t:
//   G_t  = fma(dy_t, C_t,n, G_t)     (G_{S-1} starts at dh_fin)
//   u_t  = (G_t h_{t-1}) da_t         (the gradient at delta_t a_n)
//   s1 = sum_n G_t B_t,n              s2 = sum_n u_t a_n
//   ddelta_t = fma(x_t, s1, s2)      dx_t = fma(delta_t, s1, dy_t d_skip)
//   dB_t,n = sum_d G_t (delta_t x_t)  dC_t,n = sum_d dy_t h_t
//   da_d,n = sum_{b,t} u_t delta_t    dd_skip_d = sum_{b,t} dy_t x_t
//   G_{t-1} = G_t da_t                (dh0 = G_{-1})
// s1 and s2 by the forward's butterfly (eight steps a round); dB and dC
// over the block's 32 channels through shared memory, in channel order,
// then over a cluster of kc blocks of neighbouring channels of one batch
// row (kc the largest divisor of DI / kDPB up to 8; 5 at Hymba's 50
// blocks a row): each block reads its share of the partial sums from every
// block's shared memory (distributed shared memory), adds them in rank
// order and writes one partial a cluster, so a batch row has DI / (kDPB
// kc) partials (10 at Hymba's shape, 10.5 MB in all, where 200 a row were
// 210 MB).  A cluster barrier a chunk (one warp's arrival releases the
// block's sums, the others' are relaxed), its wait after the next chunk's
// recompute.  A second pass (mamba_scan_bwd_sum) adds the clusters'
// partials, and da and dd_skip over the batch rows, each in order.  No
// atomics: two calls give the same bits.  ~45 instructions a state-step;
// the sums over d take ~11%, the barrier's release ~8%.
// Bound: the same exponentials once, and x, delta, B, C and dy read and
// dx, ddelta, dB and dC written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxN = 16;                  // the widest state
constexpr int kThreads = 128;              // threads a block
constexpr int kChunk = 32;                 // forward steps a ring stage
constexpr int kAhead = 1;                  // stages filled ahead
constexpr int kStages = kAhead + 1;
constexpr int kCk = 16;                    // steps between checkpoints
constexpr int kGroups = 2 * kCk * kMaxN / 4;  // a chunk's float4 sums
constexpr int kMaxCluster = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2Hi = 0.693145751953125f;     // ln 2 = kLn2Hi + kLn2Lo
constexpr float kLn2Lo = 1.42860682030941723e-6f;
static_assert(kChunk % kCk == 0, "checkpoints fall on stage rows");

// A lane mapping: kLPC lanes a channel, kSPL states a lane, kDPB channels
// a block of kThreads.
template <int LPC>
struct Map {
  static constexpr int kLPC = LPC;
  static constexpr int kSPL = kMaxN / LPC;
  static constexpr int kDPB = kThreads / LPC;
  static_assert(kSPL % 4 == 0 || kSPL < 4, "states a lane");
};
using FwdMap = Map<4>;                     // the forward's
using BwdMap = Map<4>;                     // the backward's

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 2^v on the multi-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// exp(p) of the plain version's own argument p = delta a_n (rounded once)
// by one ex2: z = p log2(e) rounded, then 2^z (1 + r) with r = p - z ln 2
// (two fmas, ln 2 in two parts), so the error is ex2's and a rounding
// whatever |p|.  (The forward's 2^(delta a2) rounds its argument twice
// more, an error of |p| times a few units in the last place, and dh0 = da
// G of a short walk has no other term to hide it in.)
__device__ __forceinline__ float exp_of(float p) {
  const float z = __fmul_rn(p, kLog2e);
  const float r = __fmaf_rn(-z, kLn2Lo, __fmaf_rn(-z, kLn2Hi, p));
  const float e = ex2(z);
  return __fmaf_rn(e, r, e);
}

// The backward's step of a state: da = exp_of(delta a_n), h = fma(da, h,
// (delta B_n) x).  A step with delta = 0 and B_n = 0 (past S, or a state
// past N) leaves h as it is.
__device__ __forceinline__ float bwd_step(float h, float dl, float an,
                                          float bn, float xv, float& da) {
  da = exp_of(__fmul_rn(dl, an));
  return __fmaf_rn(da, h, __fmul_rn(__fmul_rn(dl, bn), xv));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's kSPL states of a [.][16] row of shared memory.
template <int kSPL>
__device__ __forceinline__ void load_states(const float* p,
                                            float (&v)[kSPL]) {
  if constexpr (kSPL % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kSPL / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSPL; ++s) v[s] = p[s];
  }
}

template <int kSPL>
__device__ __forceinline__ void store_states(float* p,
                                             const float (&v)[kSPL]) {
  if constexpr (kSPL % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kSPL / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < kSPL; ++s) p[s] = v[s];
  }
}

// The transposed butterfly over a channel's kLPC lanes on the first W
// entries of v: in the round of bit C a lane whose bit C is set keeps
// entries W/2 .. W-1 (else 0 .. W/2-1) at 0 .. W/2-1, adding its
// partner's.  After the rounds C = kLPC/2 .. 1, entry j of lane q is the
// sum over the lanes of entry q W/kLPC + j, added in a fixed order
// (kLPC 4: lane q's (P_q + P_q^2) + (P_q^1 + P_q^3)).
template <int C, int W, int L>
__device__ __forceinline__ void fold(float (&v)[L], int q) {
  const bool up = (q & C) != 0;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float send = up ? v[i] : v[i + W / 2];
    const float keep = up ? v[i + W / 2] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, C));
  }
  if constexpr (C > 1) fold<C / 2, W / 2>(v, q);
}

// A ring stage of kT steps: delta [kT][kDPB] float32, B and C [kT][16]
// float32, x (and with kDy dy) [kT][kDPB] in x's type; byte offsets.
template <typename M, typename T, int kT, bool kDy>
struct Stage {
  static constexpr int kDPB = M::kDPB;
  static constexpr int kB = kT * kDPB * 4;
  static constexpr int kC = kB + kT * kMaxN * 4;
  static constexpr int kX = kC + kT * kMaxN * 4;
  static constexpr int kDY = kX + kT * kDPB * static_cast<int>(sizeof(T));
  static constexpr int kBytes =
      kDY + (kDy ? kT * kDPB * static_cast<int>(sizeof(T)) : 0);
  static_assert(kB % 16 == 0 && kX % 16 == 0 && kDY % 16 == 0 &&
                    kBytes % 16 == 0, "16-byte rows");
};

// Where a block's lanes sit: channel d = d0 + c of batch row b, states n0
// .. n0 + kSPL - 1.
template <typename M>
struct Lane {
  int q, c, b, d0, d, n0;
  bool chan;
  size_t hrow;
  __device__ Lane(int DI, int N) {
    q = threadIdx.x % M::kLPC;
    c = threadIdx.x / M::kLPC;
    b = blockIdx.y;
    d0 = blockIdx.x * M::kDPB;
    d = d0 + c;
    n0 = q * M::kSPL;
    chan = d < DI;
    hrow = (static_cast<size_t>(b) * DI + d) * N + n0;
  }
  __device__ bool live(int s, int N) const { return chan && n0 + s < N; }
};

// A block's inputs: channels d0 .. d0 + kDPB - 1 of batch row b.
template <typename T>
struct Src {
  const T* x;
  const float* delta;
  const float* bm;
  const float* cm;
  const T* dy;
  int b, d0, S, DI, N;
  bool vec;  // 16-byte copies: DI a multiple of 16 bytes of x, N of 4
};

// Fills a ring stage with steps t0 .. t0 + kT - 1 of the block's inputs
// (cp.async where vec, else loads and stores); what lies past S, DI or N
// lands as zeros.
template <typename M, typename T, int kT, bool kDy>
__device__ __forceinline__ void fill(char* st, const Src<T>& s, int t0) {
  using L = Stage<M, T, kT, kDy>;
  constexpr int kDPB = M::kDPB;
  const int tid = threadIdx.x;
  float* sdl = reinterpret_cast<float*>(st);
  float* sb = reinterpret_cast<float*>(st + L::kB);
  float* sc = reinterpret_cast<float*>(st + L::kC);
  T* sx = reinterpret_cast<T*>(st + L::kX);
  T* sdy = reinterpret_cast<T*>(st + L::kDY);
  const size_t row0 = static_cast<size_t>(s.b) * s.S + t0;
  if (s.vec) {
    constexpr int kPD = kDPB / 4;
    for (int p = tid; p < kT * kPD; p += kThreads) {
      const int t = p / kPD, j = p % kPD * 4;
      const bool in = t0 + t < s.S && s.d0 + j < s.DI;
      cp_async16(sdl + t * kDPB + j,
                 in ? s.delta + (row0 + t) * s.DI + s.d0 + j : s.delta,
                 in ? 16 : 0);
    }
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    constexpr int kPX = kDPB / kE;
    for (int p = tid; p < kT * kPX; p += kThreads) {
      const int t = p / kPX, j = p % kPX * kE;
      const bool in = t0 + t < s.S && s.d0 + j < s.DI;
      const size_t at = (row0 + t) * s.DI + s.d0 + j;
      cp_async16(sx + t * kDPB + j, in ? s.x + at : s.x, in ? 16 : 0);
      if constexpr (kDy)
        cp_async16(sdy + t * kDPB + j, in ? s.dy + at : s.dy, in ? 16 : 0);
    }
    constexpr int kPN = kMaxN / 4;
    for (int p = tid; p < kT * kPN; p += kThreads) {
      const int t = p / kPN, j = p % kPN * 4;
      const bool in = t0 + t < s.S && j < s.N;
      const size_t at = (row0 + t) * s.N + j;
      cp_async16(sb + t * kMaxN + j, in ? s.bm + at : s.bm, in ? 16 : 0);
      cp_async16(sc + t * kMaxN + j, in ? s.cm + at : s.cm, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kT * kDPB; e += kThreads) {
      const int t = e / kDPB, j = e % kDPB;
      const bool in = t0 + t < s.S && s.d0 + j < s.DI;
      const size_t at = (row0 + t) * s.DI + s.d0 + j;
      sdl[e] = in ? s.delta[at] : 0.0f;
      put(sx + e, in ? widen(s.x[at]) : 0.0f);
      if constexpr (kDy) put(sdy + e, in ? widen(s.dy[at]) : 0.0f);
    }
    for (int e = tid; e < kT * kMaxN; e += kThreads) {
      const int t = e / kMaxN, n = e % kMaxN;
      const bool in = t0 + t < s.S && n < s.N;
      const size_t at = (row0 + t) * s.N + n;
      sb[e] = in ? s.bm[at] : 0.0f;
      sc[e] = in ? s.cm[at] : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ dskip,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hfin, float* __restrict__ ck, int S,
                  int DI, int N, int vec) {
  using M = FwdMap;
  using L = Stage<M, T, kChunk, false>;
  constexpr int kSPL = M::kSPL, kDPB = M::kDPB;
  extern __shared__ __align__(16) char smem[];
  const Lane<M> w(DI, N);
  const Src<T> src{x, delta, bm, cm, nullptr, w.b, w.d0, S, DI, N, vec != 0};
  float a2[kSPL], h[kSPL];
#pragma unroll
  for (int s = 0; s < kSPL; ++s) {
    const bool live = w.live(s, N);
    a2[s] = live ? __fmul_rn(a[w.d * N + w.n0 + s], kLog2e) : 0.0f;
    h[s] = live && h0 != nullptr ? h0[w.hrow + s] : 0.0f;
  }
  const float ds = w.chan ? dskip[w.d] : 0.0f;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int n_ck = (S + kCk - 1) / kCk;
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k < n_chunks)
      fill<M, T, kChunk, false>(smem + k * L::kBytes, src, k * kChunk);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kAhead - 1>();             // chunk ch landed
    __syncthreads();                         // and chunk ch - 1 is read
    if (ch + kAhead < n_chunks)
      fill<M, T, kChunk, false>(smem + (ch + kAhead) % kStages * L::kBytes,
                                src, (ch + kAhead) * kChunk);
    cp_async_commit();
    const char* st = smem + ch % kStages * L::kBytes;
    const float* sdl = reinterpret_cast<const float*>(st);
    const float* sb = reinterpret_cast<const float*>(st + L::kB);
    const float* sc = reinterpret_cast<const float*>(st + L::kC);
    const T* sx = reinterpret_cast<const T*>(st + L::kX);
    const int t0 = ch * kChunk;
    const int steps = min(kChunk, S - t0);
    float yp[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i % kCk == 0 && ck != nullptr && i < steps) {
        float* at = ck + ((static_cast<size_t>(w.b) * n_ck + (t0 + i) / kCk) *
                              DI + w.d) * N + w.n0;
#pragma unroll
        for (int s = 0; s < kSPL; ++s)
          if (w.live(s, N)) at[s] = h[s];
      }
      // A step past S (delta and B zero) leaves h as it is: ex2(+-0) = 1.
      const float dl = sdl[i * kDPB + w.c];
      const float xv = widen(sx[i * kDPB + w.c]);
      float bv[kSPL], cv[kSPL];
      load_states(sb + i * kMaxN + w.n0, bv);
      load_states(sc + i * kMaxN + w.n0, cv);
#pragma unroll
      for (int s = 0; s < kSPL; ++s)
        h[s] = __fmaf_rn(ex2(__fmul_rn(dl, a2[s])), h[s],
                         __fmul_rn(__fmul_rn(dl, bv[s]), xv));
      yp[i] = __fmul_rn(h[0], cv[0]);
#pragma unroll
      for (int s = 1; s < kSPL; ++s) yp[i] = __fmaf_rn(h[s], cv[s], yp[i]);
    }
    fold<M::kLPC / 2, kChunk>(yp, w.q);
    constexpr int kOwn = kChunk / M::kLPC;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int i = w.q * kOwn + j;
      if (w.chan && i < steps)
        put(y + (static_cast<size_t>(w.b) * S + t0 + i) * DI + w.d,
            __fmaf_rn(widen(sx[i * kDPB + w.c]), ds, yp[j]));
    }
  }
#pragma unroll
  for (int s = 0; s < kSPL; ++s)
    if (w.live(s, N)) hfin[w.hrow + s] = h[s];
}

// The float4 at shared::cluster address `addr` (any block of the cluster).
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The cluster's dB and dC of chunk [tc, tc + kCk) from every block's
// in-block sums `part` (kGroups float4s: dB's steps, then dC's, 16 states
// a step), added in rank order; block `rank` takes every kc-th group from
// group `rank` and writes it to its cluster's partial [.][S][N].
__device__ __forceinline__ void cluster_sum(const float* part, int rank,
                                            int kc, float* pb, float* pc,
                                            size_t prow, int tc, int S,
                                            int N) {
  const int gi = rank + static_cast<int>(threadIdx.x) * kc;
  if (gi >= kGroups) return;
  float4 acc = ld_cluster4(sm90::cluster_map(part + 4 * gi, 0));
  for (int r = 1; r < kc; ++r) {
    const float4 v = ld_cluster4(sm90::cluster_map(part + 4 * gi, r));
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  const int row = gi / (kMaxN / 4), n = gi % (kMaxN / 4) * 4;
  const int t = tc + row % kCk;
  if (t >= S) return;
  float* p = (row < kCk ? pb : pc) + (prow + t) * N + n;
  const float e[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (n + k < N) p[k] = e[k];
}

// The backward's shared memory: its ring, red [2][kCk][kRedRow] (each
// step's dB terms, then its dC terms, [c][n]) and part [2][kGroups
// float4s] (the block's sums of a chunk, by parity).
template <typename T>
struct BwdSmem {
  using L = Stage<BwdMap, T, kCk, true>;
  static constexpr int kRedRow = BwdMap::kDPB * kMaxN + 16;
  static constexpr int kRed = kStages * L::kBytes;
  static constexpr int kPart = kRed + 4 * 2 * kCk * kRedRow;
  static constexpr size_t kBytes = kPart + 4 * 2 * 4 * kGroups;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* __restrict__ ck, const T* __restrict__ dy,
    const float* __restrict__ dhfin, T* __restrict__ dx,
    float* __restrict__ ddelta, float* __restrict__ pb,
    float* __restrict__ pc, float* __restrict__ pa, float* __restrict__ ps,
    float* __restrict__ dh0, int S, int DI, int N, int vec) {
  using M = BwdMap;
  using SM = BwdSmem<T>;
  using L = typename SM::L;
  constexpr int kSPL = M::kSPL, kDPB = M::kDPB, kLPC = M::kLPC;
  constexpr int kHalf = kLPC > 8 ? kLPC : 8;  // steps a butterfly
  constexpr int kRedRow = SM::kRedRow;
  static_assert(kCk % kHalf == 0, "butterfly widths");
  extern __shared__ __align__(16) char smem[];
  float* red = reinterpret_cast<float*>(smem + SM::kRed);
  float* part = reinterpret_cast<float*>(smem + SM::kPart);
  const Lane<M> w(DI, N);
  const int tid = threadIdx.x;
  const int kc = static_cast<int>(cluster_blocks());
  const int rank = static_cast<int>(sm90::cluster_rank());
  const size_t prow = (static_cast<size_t>(w.b) * (gridDim.x / kc) +
                       blockIdx.x / kc) * S;
  const Src<T> src{x, delta, bm, cm, dy, w.b, w.d0, S, DI, N, vec != 0};
  float an[kSPL], g[kSPL], acc_a[kSPL];
#pragma unroll
  for (int s = 0; s < kSPL; ++s) {
    const bool live = w.live(s, N);
    an[s] = live ? a[w.d * N + w.n0 + s] : 0.0f;
    g[s] = live && dhfin != nullptr ? dhfin[w.hrow + s] : 0.0f;
    acc_a[s] = 0.0f;
  }
  const float ds = w.chan ? dskip[w.d] : 0.0f;
  float acc_s = 0.0f;
  const int n_ck = (S + kCk - 1) / kCk;
  // Chunks are walked last first: walk step k is chunk n_ck - 1 - k.
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k < n_ck)
      fill<M, T, kCk, true>(smem + k * L::kBytes, src, (n_ck - 1 - k) * kCk);
    cp_async_commit();
  }
  for (int k = 0; k < n_ck; ++k) {
    const int tc = (n_ck - 1 - k) * kCk;
    const int steps = min(kCk, S - tc);
    cp_async_wait<kAhead - 1>();
    __syncthreads();                         // also: red is summed
    if (k + kAhead < n_ck)
      fill<M, T, kCk, true>(smem + (k + kAhead) % kStages * L::kBytes, src,
                            tc - kAhead * kCk);
    cp_async_commit();
    const char* st = smem + k % kStages * L::kBytes;
    const float* sdl = reinterpret_cast<const float*>(st);
    const float* sb = reinterpret_cast<const float*>(st + L::kB);
    const float* sc = reinterpret_cast<const float*>(st + L::kC);
    const T* sx = reinterpret_cast<const T*>(st + L::kX);
    const T* sdy = reinterpret_cast<const T*>(st + L::kDY);
    // The chunk's states from its checkpoint (a step past S keeps h, and
    // multiplies G by 1 on the way down).
    float h[kSPL], hp[kCk][kSPL], da[kCk][kSPL];
    const float* at = ck + ((static_cast<size_t>(w.b) * n_ck + tc / kCk) *
                                DI + w.d) * N + w.n0;
#pragma unroll
    for (int s = 0; s < kSPL; ++s) h[s] = w.live(s, N) ? at[s] : 0.0f;
#pragma unroll
    for (int i = 0; i < kCk; ++i) {
      const float dl = sdl[i * kDPB + w.c];
      const float xv = widen(sx[i * kDPB + w.c]);
      float bv[kSPL];
      load_states(sb + i * kMaxN + w.n0, bv);
#pragma unroll
      for (int s = 0; s < kSPL; ++s) {
        hp[i][s] = h[s];
        h[s] = bwd_step(h[s], dl, an[s], bv[s], xv, da[i][s]);
      }
    }
    // The cluster's sums of the chunk before, once every block made its own.
    if (k > 0) {
      sm90::cluster_wait();
      cluster_sum(part + (k - 1) % 2 * 4 * kGroups, rank, kc, pb, pc, prow,
                  tc + kCk, S, N);
    }
    // The chunk's steps backwards, kHalf to a butterfly.
#pragma unroll
    for (int hf = kCk / kHalf - 1; hf >= 0; --hf) {
      float s1[kHalf], s2[kHalf];
#pragma unroll
      for (int j = kHalf - 1; j >= 0; --j) {
        const int i = hf * kHalf + j;
        const float dl = sdl[i * kDPB + w.c];
        const float xv = widen(sx[i * kDPB + w.c]);
        const float gy = widen(sdy[i * kDPB + w.c]);
        const float dlx = __fmul_rn(dl, xv);
        float bv[kSPL], cv[kSPL], rb[kSPL], rc[kSPL];
        load_states(sb + i * kMaxN + w.n0, bv);
        load_states(sc + i * kMaxN + w.n0, cv);
#pragma unroll
        for (int s = 0; s < kSPL; ++s) {
          const float ht = i + 1 < kCk ? hp[(i + 1) % kCk][s] : h[s];
          g[s] = __fmaf_rn(gy, cv[s], g[s]);
          rc[s] = __fmul_rn(gy, ht);
          rb[s] = __fmul_rn(g[s], dlx);
          const float u = __fmul_rn(__fmul_rn(g[s], hp[i][s]), da[i][s]);
          acc_a[s] = __fmaf_rn(u, dl, acc_a[s]);
          s1[j] = s == 0 ? __fmul_rn(g[s], bv[s])
                         : __fmaf_rn(g[s], bv[s], s1[j]);
          s2[j] = s == 0 ? __fmul_rn(u, an[s]) : __fmaf_rn(u, an[s], s2[j]);
          g[s] = __fmul_rn(g[s], da[i][s]);
        }
        store_states(red + i * kRedRow + w.c * kMaxN + w.n0, rb);
        store_states(red + (kCk + i) * kRedRow + w.c * kMaxN + w.n0, rc);
      }
      fold<kLPC / 2, kHalf>(s1, w.q);
      fold<kLPC / 2, kHalf>(s2, w.q);
      constexpr int kOwn = kHalf / kLPC;
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int i = hf * kHalf + w.q * kOwn + j;
        if (w.chan && i < steps) {
          const size_t o = (static_cast<size_t>(w.b) * S + tc + i) * DI + w.d;
          const float xv = widen(sx[i * kDPB + w.c]);
          const float gy = widen(sdy[i * kDPB + w.c]);
          ddelta[o] = __fmaf_rn(xv, s1[j], s2[j]);
          put(dx + o, __fmaf_rn(sdl[i * kDPB + w.c], s1[j],
                                __fmul_rn(gy, ds)));
          acc_s = __fmaf_rn(gy, xv, acc_s);
        }
      }
    }
    __syncthreads();
    // dB and dC of the chunk over the block's channels, in order.
    for (int gi = tid; gi < kGroups; gi += kThreads) {
      const float* r = red + gi / (kMaxN / 4) * kRedRow + gi % (kMaxN / 4) * 4;
      float4 acc = *reinterpret_cast<const float4*>(r);
#pragma unroll 8
      for (int c = 1; c < kDPB; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(r + c * kMaxN);
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      reinterpret_cast<float4*>(part + k % 2 * 4 * kGroups)[gi] = acc;
    }
    // One warp's release makes the block's sums (seen through the block's
    // barrier) visible to the cluster; the others arrive relaxed, without
    // waiting for their own stores.
    __syncthreads();
    if (tid < 32)
      sm90::cluster_arrive();
    else
      sm90::cluster_arrive_relaxed();
  }
  sm90::cluster_wait();
  cluster_sum(part + (n_ck - 1) % 2 * 4 * kGroups, rank, kc, pb, pc, prow, 0,
              S, N);
  // No block leaves while another may read its shared memory.
  sm90::cluster_arrive();
  sm90::cluster_wait();
#pragma unroll
  for (int s = 0; s < kSPL; ++s)
    if (w.live(s, N)) {
      dh0[w.hrow + s] = g[s];
      pa[w.hrow + s] = acc_a[s];
    }
#pragma unroll
  for (int o = kLPC / 2; o >= 1; o >>= 1)
    acc_s = __fadd_rn(acc_s, __shfl_xor_sync(0xffffffffu, acc_s, o));
  if (w.chan && w.q == 0) ps[static_cast<size_t>(w.b) * DI + w.d] = acc_s;
}

// The backward's second pass: dB and dC over the clusters of each batch
// row, then da and dd_skip over the batch rows, each in order.
__global__ void __launch_bounds__(256)
mamba_scan_bwd_sum(const float* __restrict__ pb, const float* __restrict__ pc,
                   const float* __restrict__ pa, const float* __restrict__ ps,
                   float* __restrict__ db, float* __restrict__ dc,
                   float* __restrict__ da, float* __restrict__ dsk, int B,
                   int nclu, long long SN, int DIN, int DI) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long n_bc = B * SN;
  if (i < n_bc) {
    const long long b = i / SN, r = i % SN;
    const float* qb = pb + b * nclu * SN + r;
    const float* qc = pc + b * nclu * SN + r;
    float sb = 0.0f, sc = 0.0f;
    for (int j = 0; j < nclu; ++j) {
      sb = __fadd_rn(sb, qb[j * SN]);
      sc = __fadd_rn(sc, qc[j * SN]);
    }
    db[i] = sb;
    dc[i] = sc;
  } else if (i < n_bc + DIN) {
    const long long j = i - n_bc;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s = __fadd_rn(s, pa[b * static_cast<long long>(DIN) + j]);
    da[j] = s;
  } else if (i < n_bc + DIN + DI) {
    const long long j = i - n_bc - DIN;
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s = __fadd_rn(s, ps[b * static_cast<long long>(DI) + j]);
    dsk[j] = s;
  }
}

template <typename M>
int blocks_a_row(int DI) { return (DI + M::kDPB - 1) / M::kDPB; }

// Blocks a cluster: the largest divisor of a row's blocks up to 8.
int cluster_of(int nblk) {
  for (int k = kMaxCluster; k > 1; --k)
    if (nblk % k == 0) return k;
  return 1;
}

bool ok_shape(int B, int S, int DI, int N, int dtype) {
  return B >= 1 && B <= 65535 && S >= 1 && DI >= 1 && N >= 1 &&
         N <= kMaxN && (dtype == 0 || dtype == 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte copies into the ring: DI a whole number of 16-byte pieces of x
// (and of delta), N of B's and C's, every row start aligned.
int vec_of(const void* x, const float* delta, const float* bm,
           const float* cm, const void* dy, int DI, int N, int dtype) {
  return DI % (dtype == 1 ? 8 : 4) == 0 && N % 4 == 0 && aligned16(x) &&
         aligned16(delta) && aligned16(bm) && aligned16(cm) &&
         (dy == nullptr || aligned16(dy));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* delta, const float* bm,
                       const float* cm, const float* a, const float* dskip,
                       const float* h0, void* y, float* hfin, float* ck,
                       int B, int S, int DI, int N, int vec,
                       cudaStream_t s) {
  const size_t smem = kStages * Stage<FwdMap, T, kChunk, false>::kBytes;
  cudaError_t err = allow_smem(mamba_scan_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  mamba_scan_kernel<T><<<dim3(blocks_a_row<FwdMap>(DI), B), kThreads, smem,
                         s>>>(
      static_cast<const T*>(x), delta, bm, cm, a, dskip, h0,
      static_cast<T*>(y), hfin, ck, S, DI, N, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* delta, const float* bm,
                       const float* cm, const float* a, const float* dskip,
                       const float* ck, const void* dy, const float* dhfin,
                       void* dx, float* ddelta, float* pb, float* pc,
                       float* pa, float* ps, float* dh0, int B, int S,
                       int DI, int N, int vec, cudaStream_t s) {
  const size_t smem = BwdSmem<T>::kBytes;
  cudaError_t err = allow_smem(mamba_scan_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int nblk = blocks_a_row<BwdMap>(DI);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_of(nblk);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster the card refuses comes back here (or from cudaGetLastError).
  err = cudaLaunchKernelEx(
      &cfg, mamba_scan_bwd_kernel<T>, static_cast<const T*>(x), delta, bm,
      cm, a, dskip, ck, static_cast<const T*>(dy), dhfin, static_cast<T*>(dx),
      ddelta, pb, pc, pa, ps, dh0, S, DI, N, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Steps between the forward's checkpoints (the backward's chunk).
int repro_mamba_checkpoint_every(void) { return kCk; }

// The backward's workspace in floats: the per-cluster partials of dB and
// dC, then those of da and dd_skip by batch row.
long long repro_mamba_bwd_workspace(int B, int S, int DI, int N) {
  const int nblk = blocks_a_row<BwdMap>(DI);
  const long long nclu = nblk / cluster_of(nblk);
  return 2 * B * nclu * S * N + static_cast<long long>(B) * DI * N +
         static_cast<long long>(B) * DI;
}

// x [B, S, DI] (dtype 0 float32, 1 bf16), delta [B, S, DI], bm and cm
// [B, S, N], a [DI, N], dskip [DI], h0 [B, DI, N] (null: zeros) float32, y
// [B, S, DI] in x's type, hfin [B, DI, N] float32, ck null or float32
// [B, ceil(S / kCk), DI, N] (the state before every kCk-th step); all
// contiguous; 1 <= N <= 16, S >= 1.  One launch on `stream`; returns a
// cudaError_t (0 on success).
int repro_mamba_scan(const void* x, const float* delta, const float* bm,
                     const float* cm, const float* a, const float* dskip,
                     const float* h0, void* y, float* hfin, float* ck, int B,
                     int S, int DI, int N, int dtype, int device,
                     void* stream) {
  if (!ok_shape(B, S, DI, N, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = vec_of(x, delta, bm, cm, nullptr, DI, N, dtype);
  return dtype == 1
             ? launch_fwd<bf16>(x, delta, bm, cm, a, dskip, h0, y, hfin, ck,
                                B, S, DI, N, vec, s)
             : launch_fwd<float>(x, delta, bm, cm, a, dskip, h0, y, hfin, ck,
                                 B, S, DI, N, vec, s);
}

// The backward of repro_mamba_scan: its inputs and checkpoints, dy [B, S,
// DI] in x's type, dhfin [B, DI, N] float32 (null: zeros); writes dx in
// x's type, ddelta [B, S, DI], db and dc [B, S, N], da [DI, N], dskip_g
// [DI] and dh0 [B, DI, N], float32, all contiguous; ws a float32
// workspace of repro_mamba_bwd_workspace floats.  Two launches on
// `stream` (the walk on clusters, the sums); returns a cudaError_t.
int repro_mamba_scan_bwd(const void* x, const float* delta, const float* bm,
                         const float* cm, const float* a, const float* dskip,
                         const float* ck, const void* dy, const float* dhfin,
                         void* dx, float* ddelta, float* db, float* dc,
                         float* da, float* dskip_g, float* dh0, float* ws,
                         int B, int S, int DI, int N, int dtype, int device,
                         void* stream) {
  if (!ok_shape(B, S, DI, N, dtype) || ck == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = blocks_a_row<BwdMap>(DI);
  const int nclu = nblk / cluster_of(nblk);
  const long long SN = static_cast<long long>(S) * N;
  float* pb = ws;
  float* pc = pb + static_cast<long long>(B) * nclu * SN;
  float* pa = pc + static_cast<long long>(B) * nclu * SN;
  float* ps = pa + static_cast<long long>(B) * DI * N;
  const int vec = vec_of(x, delta, bm, cm, dy, DI, N, dtype);
  err = dtype == 1
            ? launch_bwd<bf16>(x, delta, bm, cm, a, dskip, ck, dy, dhfin, dx,
                               ddelta, pb, pc, pa, ps, dh0, B, S, DI, N, vec,
                               s)
            : launch_bwd<float>(x, delta, bm, cm, a, dskip, ck, dy, dhfin,
                                dx, ddelta, pb, pc, pa, ps, dh0, B, S, DI, N,
                                vec, s);
  if (err != cudaSuccess) return err;
  const long long total = B * SN + static_cast<long long>(DI) * N + DI;
  mamba_scan_bwd_sum<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       s>>>(pb, pc, pa, ps, db, dc, da, dskip_g, B, nclu, SN,
                            DI * N, DI);
  return cudaGetLastError();
}

}  // extern "C"
