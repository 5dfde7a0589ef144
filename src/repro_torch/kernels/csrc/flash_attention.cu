// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (wrapper flash_attention :72, kernel _flash_kernel :26), the computation
// of repro/models/attention.py::flash_attention_ref on the prefill path
// (attention.py:174 and :180):
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/rep, j])
//                  * v[b, h/rep, j]
// for q [B, H, S, hd], k and v [B, H/rep, T, hd] (bf16 or float32, all
// alike; any element strides over batch, head and row, the last dimension
// contiguous), out [B, H, S, hd] float32 and contiguous; causal masks
// j > i (S == T: the wrapper refuses a causal call with S != T).  The
// arithmetic is the TPU kernel's, in float32: masked scores take the value
// -2^30 (not -inf), the running max m, sum l and accumulator acc are
// carried across KV tiles with the online-softmax correction
// exp(m_prev - m_new), l sums the float32 p, and the output is
// acc / max(l, 1e-20).  KV tiles wholly above the diagonal are skipped and
// the heaviest query tiles launch first.  GQA: query head h reads KV head
// h / rep; the KV heads are never repeated in memory.
//
// Two kernels:
//   "wgmma" (bf16, hd 128; the model's prefill): Q K^T and P V on the
//            tensor cores.  P stays float32, as in the reference: it is
//            split into hi = bf16(p) and lo = bf16(p - hi) (p - hi is exact
//            in float32), and P V is the two products hi V + lo V into one
//            float32 accumulator.  p - hi - lo is within 2^-17 |p|, so the
//            split keeps the float32 reference's accuracy where one bf16
//            rounding of P (2^-9 |p|) does not (tests/test_torch_model_
//            kernels.py shows both).  scale multiplies the float32 score
//            after the product (the model passes 1: its q is scaled in bf16
//            beforehand).  The exponentials are __expf (ex2.approx of
//            x log2 e: within 2 + 1.2 |x| units in the last place, a few
//            1e-6 relative at the scores that weigh), inside the tolerance
//            the kernel is held to (chip_smoke.py::check_flash) and faster
//            than expf (kernel_variants.py k5; PERF.md).
//   "fma"    (float32, and bf16 at hd 16, 32, 64): float32 on the CUDA
//            cores, the first, simple design (below).
//
// Bound on an H100 (NVIDIA H100 SXM data sheet), per visible (query, key)
// pair (S T pairs, S (S + 1) / 2 when causal and S == T): wgmma, 2 hd
// operations for Q K^T and 4 hd for P V (hi and lo) at the bf16
// tensor-core rate (989 TFLOP/s dense); fma, 2 hd for Q K^T (at the bf16
// tensor-core rate for bf16 inputs, whose products are exact in float32,
// else at the 67 TFLOP/s of float32) and 2 hd for P V at the float32 rate.
// The bytes are q, k and v read once and the float32 output written once,
// against 3.35 TB/s.  The serve's prefills (S = 202 and 445) are bound by
// the bytes on the wgmma route; OLMoE's 4096-token context by operations.
//
// Design of "wgmma".  The TPU kernel keeps the q tile and (acc, m, l) in
// VMEM while the innermost grid axis walks the KV tiles in order.  Here a
// block owns 128 query rows of one (b, h) (grid B H x S/128, the heaviest
// causal tiles first) and walks the KV tiles in a loop: one producer warp
// loads the q tile once by TMA and streams 128-key K and V tiles through a
// 2-stage ring on mbarriers (K and V on barriers of their own, so Q K^T
// starts before V lands); two consumer warpgroups own 64 rows each.  A
// 128-wide bf16 row is 256 bytes, past the 128-byte swizzle, so every tile
// arrives as two 64-column boxes one box apart.  The tensor maps are 4-D
// over (hd, rows, heads, batch) with the tensors' own strides, so the
// model's [B, S, H, hd] activations are read in place through a transposed
// view, and GQA picks KV head h / rep by the map's coordinate.  Per tile:
// S = Q K^T by 8 wgmma m64n128k16 (q and K both K-major from shared
// memory), the online softmax in registers on the accumulator layout (a
// row lies in the 4 lanes of a quad: two shuffles), the mask only on the
// diagonal and ragged tiles, then P V by 16 wgmma m64n128k16 with P's hi
// and lo fragments in registers (the float32 accumulator of S packs into
// the A fragment of the next product without a shuffle) and V N-major
// (transpose bit set).  The output is written from registers, rows past S
// not at all.  A wait that never ends traps (sm90.cuh).
//
// Design of "fma".  One block of 256 threads owns one 64-query tile of one
// (b, h) and walks the KV tiles in a loop (grid: S/64 x B H).  The q tile
// (scaled) and each 64-key K and V tile are staged in shared memory as
// float32, rows padded by one word against bank conflicts.  Four
// consecutive threads own one query row: each computes 16 of the tile's 64
// scores, the row max and sum go round the four by shuffles, the
// probabilities go through shared memory (read back by the same warp), and
// each thread keeps hd / 4 accumulator columns (every fourth) in
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Route { kFma = 0, kWgmma = 1 };

constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's mask

// Element strides of q, k and v over (batch, head, row); each row is
// contiguous.
struct Strides {
  long long q[3], k[3], v[3];
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// ---- bf16, hd 128: wgmma on a TMA ring -------------------------------------
constexpr int kHD = 128;
constexpr int kBM = 128;                  // query rows a block
constexpr int kBN = 128;                  // keys a tile
constexpr int kStages = 2;
constexpr int kWThreads = 288;            // 2 warpgroups + 1 producer warp
constexpr uint32_t kBox = 128 * 128;      // 128 rows x 64 bf16, 16 KB
constexpr uint32_t kTile = 2 * kBox;      // 128 rows x hd 128, 32 KB
constexpr uint32_t kStage = 2 * kTile;    // a K and a V tile
constexpr size_t kWSmem =
    kTile + kStages * kStage + (1 + 3 * kStages) * 8 + 1024;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma(__grid_constant__ const CUtensorMap tq,
            __grid_constant__ const CUtensorMap tk,
            __grid_constant__ const CUtensorMap tv, float* __restrict__ out,
            int S, int T_len, int H, int rep, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem + kTile;           // the q tile first
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // Causal: only the tiles that start at or before the block's last row.
  const int kv_end = causal ? min(T_len, q0 + kBM) : T_len;
  const int n_kv = (kv_end + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&kfull[s], 1);
      sm90::mbar_init(&vfull[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                        // the producer
    if (threadIdx.x % 32 == 0) {
      const int kvh = h / rep;
      sm90::mbar_arrive_expect_tx(qbar, kTile);
      sm90::tma_load_4d(smem, &tq, qbar, 0, q0, h, b);
      sm90::tma_load_4d(smem + kBox, &tq, qbar, 64, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) sm90::mbar_wait(&empty[s], (j / kStages - 1) & 1);
        uint8_t* st = ring + s * kStage;
        const int k0 = j * kBN;
        sm90::mbar_arrive_expect_tx(&kfull[s], kTile);
        sm90::tma_load_4d(st, &tk, &kfull[s], 0, k0, kvh, b);
        sm90::tma_load_4d(st + kBox, &tk, &kfull[s], 64, k0, kvh, b);
        sm90::mbar_arrive_expect_tx(&vfull[s], kTile);
        sm90::tma_load_4d(st + kTile, &tv, &vfull[s], 0, k0, kvh, b);
        sm90::tma_load_4d(st + kTile + kBox, &tv, &vfull[s], 64, k0, kvh, b);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // this thread rows r0 and r0 + 8 (index i / 2 of the accumulator layout)
  // and columns 8 g + 2 quad + (0, 1).
  const int wg = warp / 4, lane = threadIdx.x % 32, quad = lane % 4;
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  const uint32_t qa = sm90::smem_u32(smem) + wg * 64 * 128;
  sm90::mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t kb = sm90::smem_u32(ring + s * kStage);
    const uint32_t vb = kb + kTile;
    const int k0 = j * kBN;

    // S = Q K^T: hd in 8 steps of 16, the second 64 columns one box on.
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    sm90::fence_regs(sc);
    sm90::mbar_wait(&kfull[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      sm90::wgmma_m64n128k16<0, 0>(sc, sm90::desc_sw128(qa + off, 16, 1024),
                                   sm90::desc_sw128(kb + off, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // The online softmax.  Only a tile that crosses the diagonal or T has
    // masked scores (one branch a tile, not one a score); keys past T (the
    // ragged last tile) are not keys at all: p = 0.
    const bool ragged = k0 + kBN > T_len;
    const bool edge = ragged || (causal && k0 + kBN - 1 > row_lo);
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= scale;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
        if (kj >= T_len || (causal && kj > r0 + 8 * ((i >> 1) & 1)))
          sc[i] = kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = __expf(sc[i] - mx[(i >> 1) & 1]);
    if (ragged) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i / 4) + 2 * quad + (i & 1) >= T_len) sc[i] = 0.0f;
    }
    float psum[2] = {0.0f, 0.0f}, corr[2];
#pragma unroll
    for (int i = 0; i < 64; ++i) psum[(i >> 1) & 1] += sc[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      corr[r] = __expf(m[r] - mx[r]);
      l[r] = l[r] * corr[r] + psum[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[(i >> 1) & 1];

    // P = hi + lo, packed into the A fragments of the 16-key steps.
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = sc[8 * kk + 2 * r], c = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 ph = __floats2bfloat162_rn(a, c);
        const float2 back = __bfloat1622float2(ph);
        hi[kk][r] = bits(ph);
        lo[kk][r] = bits(__floats2bfloat162_rn(a - back.x, c - back.y));
      }
    }

    // acc += hi V + lo V: keys in 8 steps of 16 (2048 bytes each), V
    // N-major with its second 64 columns one box on.
    sm90::mbar_wait(&vfull[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = sm90::desc_sw128(vb + 2048 * kk, kBox, 1024);
      sm90::wgmma_m64n128k16_rs<1>(acc, hi[kk], dv);
      sm90::wgmma_m64n128k16_rs<1>(acc, lo[kk], dv);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      sm90::fence_regs(hi[kk]);
      sm90::fence_regs(lo[kk]);
    }
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
  }

  float* ob = out + static_cast<size_t>(bh) * S * kHD + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    float* orow = ob + static_cast<size_t>(row) * kHD;
#pragma unroll
    for (int g = 0; g < 16; ++g)
      *reinterpret_cast<float2*>(orow + 8 * g) =
          make_float2(acc[4 * g + 2 * r] / denom,
                      acc[4 * g + 2 * r + 1] / denom);
  }
}

// ---- float32, and bf16 at hd 16, 32, 64: CUDA cores ------------------------
constexpr int kFBQ = 64;
constexpr int kFBK = 64;
constexpr int kFThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <int HD>
constexpr size_t fma_smem() {
  return sizeof(float) * (3 * 64 * (HD + 1) + 64 * (kFBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFThreads)
flash_fma(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, float* __restrict__ out, Strides st,
          int S, int T_len, int H, int rep, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int LP = kFBK + 1;
  constexpr int DPT = HD / 4;        // accumulator columns a thread owns
  constexpr int SPT = kFBK / 4;      // scores a thread computes a tile
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kFBQ][LD]
  float* Ks = Qs + kFBQ * LD;        // [kFBK][LD]
  float* Vs = Ks + kFBK * LD;        // [kFBK][LD]
  float* Ps = Vs + kFBK * LD;        // [kFBQ][LP]

  const int tid = threadIdx.x;
  const int r = tid >> 2;            // query row within the tile
  const int t = tid & 3;             // quarter of the row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / rep;
  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + kvh * st.k[1];
  const T* vp = v + b * st.v[0] + kvh * st.v[1];

  for (int i = tid; i < kFBQ * HD; i += kFThreads) {
    const int rr = i / HD, c = i % HD;
    const int qi = q0 + rr;
    Qs[rr * LD + c] = qi < S ? to_float(qp[qi * st.q[2] + c]) * scale : 0.0f;
  }

  const int qrow = q0 + r;
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;

  // Causal: only the tiles that start at or before the last query row.
  const int kv_end = causal ? min(T_len, q0 + kFBQ) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kFBK) {
    __syncthreads();   // the q tile is in; the last tile's readers are done
    for (int i = tid; i < kFBK * HD; i += kFThreads) {
      const int rr = i / HD, c = i % HD;
      const int kj = k0 + rr;
      const bool in = kj < T_len;
      Ks[rr * LD + c] = in ? to_float(kp[kj * st.k[2] + c]) : 0.0f;
      Vs[rr * LD + c] = in ? to_float(vp[kj * st.v[2] + c]) : 0.0f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        s[j] = fmaf(qd, Ks[(t + 4 * j) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const bool ok = kj < T_len && (!causal || kj <= qrow);
      s[j] = ok ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // Keys past T (the ragged last tile) are not keys at all: p = 0.
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const float p = kj < T_len ? expf(s[j] - mx) : 0.0f;
      psum += p;
      Ps[r * LP + t + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - mx);
    l = l * corr + psum;
    m = mx;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
    __syncwarp();      // the row's four threads share one warp
    for (int j = 0; j < kFBK; ++j) {
      const float p = Ps[r * LP + j];
#pragma unroll
      for (int d = 0; d < DPT; ++d)
        acc[d] = fmaf(p, Vs[j * LD + t + 4 * d], acc[d]);
    }
  }

  if (qrow < S) {
    const float denom = fmaxf(l, 1e-20f);
    float* op = out + (static_cast<size_t>(bh) * S + qrow) * HD;
#pragma unroll
    for (int d = 0; d < DPT; ++d) op[t + 4 * d] = acc[d] / denom;
  }
}

// ---- the backward: float32 on the CUDA cores ------------------------------
// dQ, dK and dV of out = softmax(scale q k^T) v (masked as the forward),
// given out (the forward's float32 output) and dO = dL/d out (float32):
//   P = exp(s - lse) with s = (scale q) . k and lse = m + log(l) of the row,
//   D_i = sum_d dO[i, d] out[i, d],  dS = P (dO v^T - D),
//   dQ = scale dS k,  dK = dS^T (scale q),  dV = P^T dO,
// dK and dV summed over the rep query heads of a KV head.  Two kernels, no
// atomics, so a run's bits do not depend on the schedule:
//   flash_bwd_dq   a block a (b, h, 64 query rows): the forward's first pass
//                  again for m and l, D_i from dO and out, then a pass over
//                  the visible key tiles that recomputes P and dS and sums
//                  dQ in registers; it writes dQ and the rows' lse and D to
//                  a float32 workspace [2][B H S];
//   flash_bwd_dkv  a block a (b, KV head, 64 key rows): for each query head
//                  of the group, each visible query tile (causal: from the
//                  diagonal down), P^T and dS^T from the workspace's lse
//                  and D, dV and dK summed in registers, written once.
// Four threads own a row (dq: a query, dkv: a key), each 16 of the tile's
// 64 scores and every fourth of hd's columns, as in flash_fma; the tiles
// sit in shared memory as float32 rows padded by one word.  Per visible
// (query, key) pair this design does 16 hd operations, all float32 on the
// CUDA cores (67 TFLOP/s): 8 hd in the dq kernel (two score passes, dO v,
// dS k) and 8 hd in the dkv kernel (the score, dO v, P dO, dS q).  Its
// bound is the least work instead: the scores once (2 hd, at the bf16
// tensor-core rate for bf16 inputs, whose products are exact in float32)
// and dO v, dS k, dS^T q, P^T dO (8 hd at the float32 rate); or q, k, v,
// out and dO read once and dq, dk, dv written once (3.35 TB/s).  At the
// training shape (B 4, H 16, S 512, hd 128) the operations bound it.
constexpr int kBB = 64;               // rows a tile, both kernels
constexpr int kBThreads = 256;

template <int HD>
constexpr size_t bwd_dq_smem() {
  return sizeof(float) * (4 * kBB * (HD + 1) + kBB * (kBB + 1));
}

template <int HD>
constexpr size_t bwd_dkv_smem() {
  return sizeof(float) * (4 * kBB * (HD + 1) + 2 * kBB * (kBB + 1) + 2 * kBB);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ ws, Strides st, int S, int T_len, int H,
             int rep, float scale, int causal, int BHS) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBB + 1;
  constexpr int DPT = HD / 4;
  constexpr int SPT = kBB / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBB][LD], scale q
  float* dOs = Qs + kBB * LD;        // [kBB][LD]
  float* Ks = dOs + kBB * LD;        // [kBB][LD]
  float* Vs = Ks + kBB * LD;         // [kBB][LD]
  float* Ps = Vs + kBB * LD;         // [kBB][LP], dS

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int t = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBB;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / rep;
  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + kvh * st.k[1];
  const T* vp = v + b * st.v[0] + kvh * st.v[1];
  const size_t row0 = static_cast<size_t>(bh) * S;   // rows of out, dO, dq

  for (int i = tid; i < kBB * HD; i += kBThreads) {
    const int rr = i / HD, c = i % HD;
    const int qi = q0 + rr;
    const bool in = qi < S;
    Qs[rr * LD + c] = in ? to_float(qp[qi * st.q[2] + c]) * scale : 0.0f;
    dOs[rr * LD + c] = in ? dout[(row0 + qi) * HD + c] : 0.0f;
  }
  const int qrow = q0 + r;
  const int kv_end = causal ? min(T_len, q0 + kBB) : T_len;

  // Pass 1: the row's max and sum, as the forward takes them.
  float m = kNegInf, l = 0.0f;
  for (int k0 = 0; k0 < kv_end; k0 += kBB) {
    __syncthreads();
    for (int i = tid; i < kBB * HD; i += kBThreads) {
      const int rr = i / HD, c = i % HD;
      const int kj = k0 + rr;
      Ks[rr * LD + c] = kj < T_len ? to_float(kp[kj * st.k[2] + c]) : 0.0f;
    }
    __syncthreads();
    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        s[j] = fmaf(qd, Ks[(t + 4 * j) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const bool ok = kj < T_len && (!causal || kj <= qrow);
      s[j] = ok ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      psum += kj < T_len ? expf(s[j] - mx) : 0.0f;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * expf(m - mx) + psum;
    m = mx;
  }
  const float lse = m + logf(fmaxf(l, 1e-20f));
  float dd = 0.0f;
  if (qrow < S) {
    const float* orow = o + (row0 + qrow) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      dd = fmaf(dOs[r * LD + t + 4 * c], orow[t + 4 * c], dd);
  }
  dd += __shfl_xor_sync(0xffffffffu, dd, 1);
  dd += __shfl_xor_sync(0xffffffffu, dd, 2);
  if (qrow < S && t == 0) {
    ws[row0 + qrow] = lse;
    ws[BHS + row0 + qrow] = dd;
  }

  // Pass 2: dS row by row, dQ += dS k.
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.0f;
  for (int k0 = 0; k0 < kv_end; k0 += kBB) {
    __syncthreads();
    for (int i = tid; i < kBB * HD; i += kBThreads) {
      const int rr = i / HD, c = i % HD;
      const int kj = k0 + rr;
      const bool in = kj < T_len;
      Ks[rr * LD + c] = in ? to_float(kp[kj * st.k[2] + c]) : 0.0f;
      Vs[rr * LD + c] = in ? to_float(vp[kj * st.v[2] + c]) : 0.0f;
    }
    __syncthreads();
    float s[SPT], dp[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
      const float gd = dOs[r * LD + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        s[j] = fmaf(qd, Ks[(t + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(gd, Vs[(t + 4 * j) * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const bool ok = qrow < S && kj < T_len && (!causal || kj <= qrow);
      const float p = ok ? expf(s[j] - lse) : 0.0f;
      Ps[r * LP + t + 4 * j] = p * (dp[j] - dd);
    }
    __syncwarp();      // the row's four threads share one warp
    for (int j = 0; j < kBB; ++j) {
      const float ds = Ps[r * LP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        acc[c] = fmaf(ds, Ks[j * LD + t + 4 * c], acc[c]);
    }
  }
  if (qrow < S) {
    T* drow = dq + (row0 + qrow) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) store(drow + t + 4 * c, acc[c] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ ws, T* __restrict__ dk,
              T* __restrict__ dv, Strides st, int S, int T_len, int H,
              int KV, int rep, float scale, int causal, int BHS) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBB + 1;
  constexpr int DPT = HD / 4;
  constexpr int SPT = kBB / 4;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [kBB][LD]
  float* Vs = Ks + kBB * LD;         // [kBB][LD]
  float* Qs = Vs + kBB * LD;         // [kBB][LD], scale q
  float* dOs = Qs + kBB * LD;        // [kBB][LD]
  float* Ps = dOs + kBB * LD;        // [kBB keys][LP]: P^T
  float* Ds = Ps + kBB * LP;         // [kBB keys][LP]: dS^T
  float* lses = Ds + kBB * LP;       // [kBB]
  float* dds = lses + kBB;           // [kBB]

  const int tid = threadIdx.x;
  const int c = tid >> 2;            // key row within the tile
  const int t = tid & 3;
  const int k0 = blockIdx.x * kBB;
  const int bk = blockIdx.y;
  const int b = bk / KV, kvh = bk % KV;
  const T* kp = k + b * st.k[0] + kvh * st.k[1];
  const T* vp = v + b * st.v[0] + kvh * st.v[1];

  for (int i = tid; i < kBB * HD; i += kBThreads) {
    const int rr = i / HD, cc = i % HD;
    const int kj = k0 + rr;
    const bool in = kj < T_len;
    Ks[rr * LD + cc] = in ? to_float(kp[kj * st.k[2] + cc]) : 0.0f;
    Vs[rr * LD + cc] = in ? to_float(vp[kj * st.v[2] + cc]) : 0.0f;
  }
  const int krow = k0 + c;
  float adk[DPT], adv[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) adk[d] = adv[d] = 0.0f;

  // Causal: query tiles from the one holding the diagonal (tiles align).
  const int q_start = causal ? k0 : 0;
  for (int g = 0; g < rep; ++g) {
    const int h = kvh * rep + g;
    const T* qp = q + b * st.q[0] + h * st.q[1];
    const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = q_start; q0 < S; q0 += kBB) {
      __syncthreads();   // the last tile's readers are done
      for (int i = tid; i < kBB * HD; i += kBThreads) {
        const int rr = i / HD, cc = i % HD;
        const int qi = q0 + rr;
        const bool in = qi < S;
        Qs[rr * LD + cc] = in ? to_float(qp[qi * st.q[2] + cc]) * scale
                              : 0.0f;
        dOs[rr * LD + cc] = in ? dout[(row0 + qi) * HD + cc] : 0.0f;
      }
      if (tid < kBB) {
        const int qi = q0 + tid;
        lses[tid] = qi < S ? ws[row0 + qi] : 0.0f;
        dds[tid] = qi < S ? ws[BHS + row0 + qi] : 0.0f;
      }
      __syncthreads();
      float s[SPT], dp[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[j] = dp[j] = 0.0f;
      for (int d = 0; d < HD; ++d) {
        const float kd = Ks[c * LD + d];
        const float vd = Vs[c * LD + d];
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          s[j] = fmaf(Qs[(t + 4 * j) * LD + d], kd, s[j]);
          dp[j] = fmaf(dOs[(t + 4 * j) * LD + d], vd, dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = t + 4 * j;
        const int qi = q0 + i;
        const bool ok = qi < S && krow < T_len && (!causal || krow <= qi);
        const float p = ok ? expf(s[j] - lses[i]) : 0.0f;
        Ps[c * LP + i] = p;
        Ds[c * LP + i] = p * (dp[j] - dds[i]);
      }
      __syncwarp();    // the key row's four threads share one warp
      for (int i = 0; i < kBB; ++i) {
        const float p = Ps[c * LP + i];
        const float ds = Ds[c * LP + i];
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          adv[d] = fmaf(p, dOs[i * LD + t + 4 * d], adv[d]);
          adk[d] = fmaf(ds, Qs[i * LD + t + 4 * d], adk[d]);
        }
      }
    }
  }
  if (krow < T_len) {
    const size_t off = ((static_cast<size_t>(b) * KV + kvh) * T_len + krow)
                       * HD;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      store(dk + off + t + 4 * d, adk[d]);
      store(dv + off + t + 4 * d, adv[d]);
    }
  }
}

// ---- host ------------------------------------------------------------------
constexpr int kMaxDevices = 64;

// Lets `kernel` use `bytes` of dynamic shared memory on `device`, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       bool (&done)[kMaxDevices]) {
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

// A map of q, k or v as (hd, rows, heads, batch) with its own strides, read
// in 64-column boxes of 128 rows.
bool head_map(CUtensorMap* map, const void* base, const long long (&st)[3],
              int rows, int heads, int B) {
  const uint64_t dims[4] = {kHD, static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t bytes[3] = {static_cast<uint64_t>(st[2]) * 2,
                             static_cast<uint64_t>(st[1]) * 2,
                             static_cast<uint64_t>(st[0]) * 2};
  return sm90::tensor_map_bf16_4d(map, base, dims, bytes, 64, 128);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         float* out, int B, int H, int KV, int S, int T_len,
                         float scale, int causal, const Strides& st,
                         int device, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, st.q, S, H, B) ||
      !head_map(&tk, k, st.k, T_len, KV, B) ||
      !head_map(&tv, v, st.v, T_len, KV, B))
    return cudaErrorNotSupported;
  cudaError_t err = allow_smem(flash_wgmma, kWSmem, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_wgmma<<<grid, kWThreads, kWSmem, s>>>(tq, tk, tv, out, S, T_len, H,
                                              H / KV, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       float* out, int B, int H, int rep, int S, int T_len,
                       float scale, int causal, const Strides& st,
                       int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  auto kernel = flash_fma<T, HD>;
  cudaError_t err = allow_smem(kernel, fma_smem<HD>(), device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kFBQ - 1) / kFBQ, B * H);
  kernel<<<grid, kFThreads, fma_smem<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, st, S, T_len, H, rep, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* q, const void* k, const void* v,
                         float* out, int B, int H, int rep, int S, int T_len,
                         int hd, float scale, int causal, const Strides& st,
                         int device, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_fma<T, 16>(q, k, v, out, B, H, rep, S, T_len, scale,
                               causal, st, device, s);
    case 32:
      return launch_fma<T, 32>(q, k, v, out, B, H, rep, S, T_len, scale,
                               causal, st, device, s);
    case 64:
      return launch_fma<T, 64>(q, k, v, out, B, H, rep, S, T_len, scale,
                               causal, st, device, s);
    case 128:
      return launch_fma<T, 128>(q, k, v, out, B, H, rep, S, T_len, scale,
                                causal, st, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* o, const float* dout, void* dq, void* dk,
                       void* dv, float* ws, int B, int H, int KV, int S,
                       int T_len, float scale, int causal, const Strides& st,
                       int device, cudaStream_t stream) {
  static bool done_dq[kMaxDevices] = {}, done_dkv[kMaxDevices] = {};
  auto kdq = flash_bwd_dq<T, HD>;
  auto kdkv = flash_bwd_dkv<T, HD>;
  cudaError_t err = allow_smem(kdq, bwd_dq_smem<HD>(), device, done_dq);
  if (err == cudaSuccess)
    err = allow_smem(kdkv, bwd_dkv_smem<HD>(), device, done_dkv);
  if (err != cudaSuccess) return err;
  const int rep = H / KV;
  const int bhs = B * H * S;
  kdq<<<dim3((S + kBB - 1) / kBB, B * H), kBThreads, bwd_dq_smem<HD>(),
        stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), o, dout, static_cast<T*>(dq), ws,
                  st, S, T_len, H, rep, scale, causal, bhs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3((T_len + kBB - 1) / kBB, B * KV), kBThreads,
         bwd_dkv_smem<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, ws, static_cast<T*>(dk),
      static_cast<T*>(dv), st, S, T_len, H, KV, rep, scale, causal, bhs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const float* o, const float* dout, void* dq,
                         void* dk, void* dv, float* ws, int B, int H, int KV,
                         int S, int T_len, int hd, float scale, int causal,
                         const Strides& st, int device, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, o, dout, dq, dk, dv, ws, B, H, KV, S,
                               T_len, scale, causal, st, device, s);
    case 32:
      return launch_bwd<T, 32>(q, k, v, o, dout, dq, dk, dv, ws, B, H, KV, S,
                               T_len, scale, causal, st, device, s);
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, dq, dk, dv, ws, B, H, KV, S,
                               T_len, scale, causal, st, device, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, dq, dk, dv, ws, B, H, KV,
                                S, T_len, scale, causal, st, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool tma_ready(const void* p, const long long (&st)[3]) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0 && st[0] > 0 && st[1] > 0 &&
         st[2] > 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, H, S, hd], k and v [B, KV, T, hd] with element strides `strides`
// (q's batch, head and row strides, then k's, then v's; each row
// contiguous), out [B, H, S, hd] float32 contiguous; dtype 0 = float32,
// 1 = bf16 (q, k and v alike); hd in {16, 32, 64, 128}; H a multiple of
// KV; causal needs S == T.  bf16 at hd 128 runs the wgmma kernel (its
// strides multiples of 8 and its bases 16-byte aligned, or an error),
// every other call the fma kernel; *route is set to the kernel (0 fma,
// 1 wgmma).  Returns a cudaError_t (0 on success); launches
// asynchronously on `stream`.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          float* out, int B, int H, int KV, int S, int T_len,
                          int hd, float scale, int causal, int dtype,
                          const long long* strides, int device, void* stream,
                          int* route) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || T_len < 1 ||
      (causal && S != T_len) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == kHD) {
    *route = kWgmma;
    if ((S + kBM - 1) / kBM > 65535 || !tma_ready(q, st.q) ||
        !tma_ready(k, st.k) || !tma_ready(v, st.v))
      return cudaErrorInvalidValue;
    return launch_wgmma(q, k, v, out, B, H, KV, S, T_len, scale, causal, st,
                        device, s);
  }
  *route = kFma;
  if (static_cast<long long>(B) * H > 65535) return cudaErrorInvalidValue;
  const int rep = H / KV;
  if (dtype == 1)
    return dispatch_fma<bf16>(q, k, v, out, B, H, rep, S, T_len, hd, scale,
                              causal, st, device, s);
  return dispatch_fma<float>(q, k, v, out, B, H, rep, S, T_len, hd, scale,
                             causal, st, device, s);
}

// The backward of repro_flash_attention: q, k, v as there (same strides,
// dtype, hd, causal rule), out and dout [B, H, S, hd] float32 contiguous
// (the forward's output and the gradient at it), dq [B, H, S, hd] and dk,
// dv [B, KV, T, hd] contiguous in q's dtype, ws a float32 workspace of
// 2 B H S; two launches on `stream` (dq, then dk and dv), no atomics.
// Returns a cudaError_t.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const float* out, const float* dout, void* dq,
                              void* dk, void* dv, float* ws, int B, int H,
                              int KV, int S, int T_len, int hd, float scale,
                              int causal, int dtype,
                              const long long* strides, int device,
                              void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || T_len < 1 ||
      (causal && S != T_len) || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(B) * H > 65535 ||
      static_cast<long long>(B) * H * S > (1LL << 30))
    return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bwd<bf16>(q, k, v, out, dout, dq, dk, dv, ws, B, H, KV, S,
                              T_len, hd, scale, causal, st, device, s);
  return dispatch_bwd<float>(q, k, v, out, dout, dq, dk, dv, ws, B, H, KV, S,
                             T_len, hd, scale, causal, st, device, s);
}

}  // extern "C"
