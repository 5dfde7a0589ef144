// K7 as it was first built, kept to compare the redesign with: `python3
// kernel_variants.py k7` builds it beside csrc/mamba_scan.cu and times the
// two in turns, each within chip_smoke.py's check_mamba / check_mamba_bwd.
// Plain C interface, the same entries as the source's (`repro_mamba_scan`,
// `repro_mamba_scan_bwd`, `repro_mamba_bwd_workspace`,
// `repro_mamba_checkpoint_every`; its checkpoints every 64 steps).
//
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
// N <= 16.  Each product and sum is rounded as JAX's ops round them (no
// contraction into FMAs); exp is expf (2 units in the last place, where
// XLA's exp is its own approximation) and sum_n is added in the fixed
// order below, not einsum's, so the bits differ from the plain version
// within an error envelope (chip_smoke.py check_mamba).
//
// Bound on an H100: B S DI N exponentials (the multi-function unit: 16 a
// clock an SM, ~4.2 T/s at 1.98 GHz) and ~5 float32 operations an entry,
// against x, delta, B and C read and y written once (3.35 TB/s).  At
// Hymba-1.5B's B 4, S 2,048, DI 1,600, N 16: 210 M exponentials, ~50 us,
// against ~105 MB, ~31 us: the exponentials bound it.
//
// Design (simple first).  A block owns kDPB = 8 channels d of one batch row
// b, 16 lanes a channel, lane n the state h[b, d, n] in a register for the
// whole walk over t (lanes n >= N hold zeros and stay zero).  The walk goes
// in chunks of kChunk = 16 steps: every load of a chunk (delta and x a
// channel, B and C a lane) is issued before its arithmetic, each lane keeps
// its 16 products h_t C_t,n, and one transposed butterfly of four shuffle
// rounds (15 shuffles, not 16 x 4) leaves lane l the sum over n of step
// t0 + l, which it finishes (+ x d_skip) and writes.  With checkpoints (a
// gradient is wanted) the forward also writes h before every kCk-th step.
//
// The backward (mamba_scan_bwd_kernel) walks the checkpoint chunks in
// reverse: it recomputes the chunk's states from its checkpoint with the
// forward's own step (the same bits) into shared memory, then walks the
// chunk's steps down in sub-chunks of 16 with G = dL/dh_t in a register:
//   G_t  += dy_t C_t,n              (G_{S-1} starts at dh_fin)
//   u_t   = G_t h_{t-1} da_t        (the gradient at delta_t a_n)
//   ddelta_t = sum_n (u_t a_n + G_t x_t B_t,n)
//   dx_t  = sum_n G_t (delta_t B_t,n) + dy_t d_skip
//   dB_t,n = sum_d G_t x_t delta_t  dC_t,n = sum_d dy_t h_t
//   da_d,n = sum_{b,t} u_t delta_t  dd_skip_d = sum_{b,t} dy_t x_t
//   G_{t-1} = da_t G_t               (dh0 = G_{-1})
// Sums over n by the forward's transposed butterfly; sums over d first
// over the block's 8 channels through shared memory, in order, into a
// per-block partial, then over the blocks by a second pass
// (mamba_scan_bwd_sum), in order; sums over (b, t) per lane, then over b
// in that pass.  No atomics: two calls give the same bits.
// Bound: the same exponentials once, and x, delta, B, C and dy read and
// dx, ddelta, dB and dC written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 16;                 // lanes a channel: one a state n
constexpr int kDPB = 8;                    // channels a block
constexpr int kThreads = kLanes * kDPB;    // 128
constexpr int kChunk = 16;                 // steps a register chunk
constexpr int kCk = 64;                    // steps between checkpoints
static_assert(kCk % kChunk == 0, "checkpoints fall on chunk starts");
constexpr size_t kBwdSmem = sizeof(float) * (kCk + 2 * kChunk) * kThreads;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One step of state n of a channel: da = exp(delta a_n), h = da h +
// (delta B_n) x, each op rounded on its own (JAX's ops).  A step with
// delta = 0 and B_n = 0 (past S, or a lane past N) leaves h as it is.
__device__ __forceinline__ float step(float h, float dl, float an, float bn,
                                      float xv, float& da) {
  da = expf(__fmul_rn(dl, an));
  const float dbx = __fmul_rn(__fmul_rn(dl, bn), xv);
  return __fadd_rn(__fmul_rn(da, h), dbx);
}

// One round of the transposed butterfly over a channel's 16 lanes: a lane
// whose bit C is set keeps entries C .. 2C - 1 (else 0 .. C - 1), adding
// its partner's; after rounds 8, 4, 2 and 1 entry 0 of lane l is the sum
// over the 16 lanes of entry l, added in a fixed order.
template <int C>
__device__ __forceinline__ void fold(float (&v)[kChunk], int lane) {
  const bool up = (lane & C) != 0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float send = up ? v[i] : v[i + C];
    const float keep = up ? v[i + C] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, C));
  }
}

__device__ __forceinline__ float transpose_sum(float (&v)[kChunk], int lane) {
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

// Where a block's lanes sit: channel d of batch row b, state n = lane.
struct Lane {
  int lane, g, b, blk, d;
  bool chan, live;
  size_t xb, nb, hrow;
  __device__ Lane(int S, int DI, int N) {
    lane = threadIdx.x % kLanes;
    g = threadIdx.x / kLanes;
    const int nblk = (DI + kDPB - 1) / kDPB;
    b = blockIdx.x / nblk;
    blk = blockIdx.x % nblk;
    d = blk * kDPB + g;
    chan = d < DI;
    live = chan && lane < N;
    xb = static_cast<size_t>(b) * S * DI + (chan ? d : 0);
    nb = static_cast<size_t>(b) * S * N + (live ? lane : 0);
    hrow = (static_cast<size_t>(b) * DI + d) * N + lane;
  }
};

// Loads steps t0 .. t0 + kChunk - 1 (those before `end`) of a lane's
// inputs; the others read as zeros.
template <typename T>
__device__ __forceinline__ void load_chunk(
    const Lane& w, const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ bm, const float* __restrict__ cm, int t0,
    int end, int DI, int N, float (&dl)[kChunk], float (&xv)[kChunk],
    float (&bv)[kChunk], float (&cv)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int t = t0 + i;
    const bool in = t < end;
    const size_t at = w.xb + static_cast<size_t>(t) * DI;
    const size_t an = w.nb + static_cast<size_t>(t) * N;
    dl[i] = in && w.chan ? delta[at] : 0.0f;
    xv[i] = in && w.chan ? widen(x[at]) : 0.0f;
    bv[i] = in && w.live ? bm[an] : 0.0f;
    cv[i] = in && w.live ? cm[an] : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ dskip,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hfin, float* __restrict__ ck, int S,
                  int DI, int N) {
  const Lane w(S, DI, N);
  const float an = w.live ? a[w.d * N + w.lane] : 0.0f;
  const float ds = w.chan ? dskip[w.d] : 0.0f;
  float h = w.live && h0 != nullptr ? h0[w.hrow] : 0.0f;
  const int n_ck = (S + kCk - 1) / kCk;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    float dl[kChunk], xv[kChunk], bv[kChunk], cv[kChunk];
    load_chunk(w, x, delta, bm, cm, t0, S, DI, N, dl, xv, bv, cv);
    if (ck != nullptr && t0 % kCk == 0 && w.live)
      ck[((static_cast<size_t>(w.b) * n_ck + t0 / kCk) * DI + w.d) * N +
         w.lane] = h;
    float yp[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      float da;
      h = step(h, dl[i], an, bv[i], xv[i], da);
      yp[i] = __fmul_rn(h, cv[i]);
    }
    const float sum = transpose_sum(yp, w.lane);
    const int t = t0 + w.lane;
    if (w.chan && t < S) {
      const size_t at = w.xb + static_cast<size_t>(t) * DI;
      put(y + at, __fadd_rn(sum, __fmul_rn(widen(x[at]), ds)));
    }
  }
  if (w.live) hfin[w.hrow] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dskip,
    const float* __restrict__ ck, const T* __restrict__ dy,
    const float* __restrict__ dhfin, T* __restrict__ dx,
    float* __restrict__ ddelta, float* __restrict__ pb,
    float* __restrict__ pc, float* __restrict__ pa, float* __restrict__ ps,
    float* __restrict__ dh0, int S, int DI, int N) {
  extern __shared__ float smem[];
  float* hs = smem;                        // [kCk][kThreads]: h_{t-1}
  float* rb = hs + kCk * kThreads;         // [kChunk][kDPB][kLanes]
  float* rc = rb + kChunk * kThreads;      // [kChunk][kDPB][kLanes]
  const Lane w(S, DI, N);
  const int tid = threadIdx.x;
  const int nblk = (DI + kDPB - 1) / kDPB;
  const float an = w.live ? a[w.d * N + w.lane] : 0.0f;
  const float ds = w.chan ? dskip[w.d] : 0.0f;
  float g = w.live && dhfin != nullptr ? dhfin[w.hrow] : 0.0f;
  float acc_a = 0.0f, acc_s = 0.0f;
  const int n_ck = (S + kCk - 1) / kCk;
  for (int c = n_ck - 1; c >= 0; --c) {
    const int tc = c * kCk;
    const int end = min(S, tc + kCk);
    // The chunk's states from its checkpoint, by the forward's step.
    float h = w.live ? ck[((static_cast<size_t>(w.b) * n_ck + c) * DI +
                           w.d) * N + w.lane]
                     : 0.0f;
    for (int s0 = tc; s0 < end; s0 += kChunk) {
      float dl[kChunk], xv[kChunk], bv[kChunk], cv[kChunk];
      load_chunk(w, x, delta, bm, cm, s0, end, DI, N, dl, xv, bv, cv);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        hs[(s0 - tc + i) * kThreads + tid] = h;
        float da;
        h = step(h, dl[i], an, bv[i], xv[i], da);
      }
    }
    // Its steps backwards, kChunk at a time.
    for (int s0 = tc + (end - 1 - tc) / kChunk * kChunk; s0 >= tc;
         s0 -= kChunk) {
      float dl[kChunk], xv[kChunk], bv[kChunk], cv[kChunk], gy[kChunk];
      load_chunk(w, x, delta, bm, cm, s0, end, DI, N, dl, xv, bv, cv);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int t = s0 + i;
        gy[i] = t < end && w.chan
                    ? widen(dy[w.xb + static_cast<size_t>(t) * DI])
                    : 0.0f;
      }
      float pdd[kChunk], pdx[kChunk];
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        const float hp = hs[(s0 - tc + i) * kThreads + tid];
        float da;
        const float ht = step(hp, dl[i], an, bv[i], xv[i], da);
        g = __fadd_rn(g, __fmul_rn(gy[i], cv[i]));
        const float gx = __fmul_rn(g, xv[i]);
        rc[i * kThreads + tid] = __fmul_rn(gy[i], ht);
        rb[i * kThreads + tid] = __fmul_rn(gx, dl[i]);
        const float u = __fmul_rn(__fmul_rn(g, hp), da);
        acc_a = __fadd_rn(acc_a, __fmul_rn(u, dl[i]));
        pdd[i] = __fadd_rn(__fmul_rn(u, an), __fmul_rn(gx, bv[i]));
        pdx[i] = __fmul_rn(g, __fmul_rn(dl[i], bv[i]));
        g = __fmul_rn(g, da);
      }
      const float sdd = transpose_sum(pdd, w.lane);
      const float sdx = transpose_sum(pdx, w.lane);
      const int t = s0 + w.lane;
      if (w.chan && t < end) {
        const size_t at = w.xb + static_cast<size_t>(t) * DI;
        const float gyv = widen(dy[at]);
        ddelta[at] = sdd;
        put(dx + at, __fadd_rn(sdx, __fmul_rn(gyv, ds)));
        acc_s = __fadd_rn(acc_s, __fmul_rn(gyv, widen(x[at])));
      }
      __syncthreads();
      // dB and dC of these steps over the block's channels, in order.
      for (int e = tid; e < kChunk * kLanes; e += kThreads) {
        const int i = e / kLanes, n = e % kLanes;
        if (s0 + i < end && n < N) {
          float sb = 0.0f, sc = 0.0f;
#pragma unroll
          for (int j = 0; j < kDPB; ++j) {
            sb = __fadd_rn(sb, rb[i * kThreads + j * kLanes + n]);
            sc = __fadd_rn(sc, rc[i * kThreads + j * kLanes + n]);
          }
          const size_t at =
              ((static_cast<size_t>(w.b) * nblk + w.blk) * S + s0 + i) * N + n;
          pb[at] = sb;
          pc[at] = sc;
        }
      }
      __syncthreads();
    }
  }
  if (w.live) {
    dh0[w.hrow] = g;
    pa[w.hrow] = acc_a;
  }
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1)
    acc_s = __fadd_rn(acc_s, __shfl_xor_sync(0xffffffffu, acc_s, o));
  if (w.chan && w.lane == 0) ps[static_cast<size_t>(w.b) * DI + w.d] = acc_s;
}

// The backward's second pass: dB and dC over the blocks of each batch row,
// then da and dd_skip over the batch rows, each in order.
__global__ void __launch_bounds__(256)
mamba_scan_bwd_sum(const float* __restrict__ pb, const float* __restrict__ pc,
                   const float* __restrict__ pa, const float* __restrict__ ps,
                   float* __restrict__ db, float* __restrict__ dc,
                   float* __restrict__ da, float* __restrict__ dsk, int B,
                   int nblk, long long SN, int DIN, int DI) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long n_bc = B * SN;
  if (i < n_bc) {
    const long long b = i / SN, r = i % SN;
    const float* qb = pb + b * nblk * SN + r;
    const float* qc = pc + b * nblk * SN + r;
    float sb = 0.0f, sc = 0.0f;
    for (int j = 0; j < nblk; ++j) {
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

bool ok_shape(int B, int S, int DI, int N, int dtype) {
  return B >= 1 && S >= 1 && DI >= 1 && N >= 1 && N <= kLanes &&
         (dtype == 0 || dtype == 1) &&
         static_cast<long long>(B) * ((DI + kDPB - 1) / kDPB) < 0x7fffffffLL;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Steps between the forward's checkpoints (the backward's chunk).
int repro_mamba_checkpoint_every(void) { return kCk; }

// The backward's workspace in floats: the per-block partials of dB and dC,
// then those of da and dd_skip by batch row.
long long repro_mamba_bwd_workspace(int B, int S, int DI, int N) {
  const long long nblk = (DI + kDPB - 1) / kDPB;
  return 2 * B * nblk * S * N + static_cast<long long>(B) * DI * N +
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
  const unsigned grid = static_cast<unsigned>(B) * ((DI + kDPB - 1) / kDPB);
  if (dtype == 1)
    mamba_scan_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), delta, bm, cm, a, dskip, h0,
        static_cast<bf16*>(y), hfin, ck, S, DI, N);
  else
    mamba_scan_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), delta, bm, cm, a, dskip, h0,
        static_cast<float*>(y), hfin, ck, S, DI, N);
  return cudaGetLastError();
}

// The backward of repro_mamba_scan: its inputs and checkpoints, dy [B, S,
// DI] in x's type, dhfin [B, DI, N] float32 (null: zeros); writes dx in
// x's type, ddelta [B, S, DI], db and dc [B, S, N], da [DI, N], dskip_g
// [DI] and dh0 [B, DI, N], float32, all contiguous; ws a float32
// workspace of repro_mamba_bwd_workspace floats.  Two launches on
// `stream`; returns a cudaError_t.
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
  const int nblk = (DI + kDPB - 1) / kDPB;
  const long long SN = static_cast<long long>(S) * N;
  float* pb = ws;
  float* pc = pb + static_cast<long long>(B) * nblk * SN;
  float* pa = pc + static_cast<long long>(B) * nblk * SN;
  float* ps = pa + static_cast<long long>(B) * DI * N;
  const unsigned grid = static_cast<unsigned>(B) * nblk;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(mamba_scan_bwd_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBwdSmem));
    if (err != cudaSuccess) return err;
    mamba_scan_bwd_kernel<bf16><<<grid, kThreads, kBwdSmem, s>>>(
        static_cast<const bf16*>(x), delta, bm, cm, a, dskip, ck,
        static_cast<const bf16*>(dy), dhfin, static_cast<bf16*>(dx), ddelta,
        pb, pc, pa, ps, dh0, S, DI, N);
  } else {
    err = cudaFuncSetAttribute(mamba_scan_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBwdSmem));
    if (err != cudaSuccess) return err;
    mamba_scan_bwd_kernel<float><<<grid, kThreads, kBwdSmem, s>>>(
        static_cast<const float*>(x), delta, bm, cm, a, dskip, ck,
        static_cast<const float*>(dy), dhfin, static_cast<float*>(dx), ddelta,
        pb, pc, pa, ps, dh0, S, DI, N);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = B * SN + static_cast<long long>(DI) * N + DI;
  mamba_scan_bwd_sum<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       s>>>(pb, pc, pa, ps, db, dc, da, dskip_g, B, nblk, SN,
                            DI * N, DI);
  return cudaGetLastError();
}

}  // extern "C"
