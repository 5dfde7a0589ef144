// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/segment_matmul.py
// (wrapper segment_matmul :35, kernel _seg_mm_kernel :19):
//   out[e] = x[e] @ w[e]   for x [E, C, D], w [E, D, F], out [E, C, F],
// accumulated in float32 and rounded once to the inputs' dtype (bf16 or
// float32; x, w and out share it).  This is the expert compute of the MoE
// layer (repro/models/moe.py:161-164), C being the expert capacity.  With
// `rows` (int32 [E] on the device, or null) only the first rows[e] rows of
// expert e are computed and the rest of out[e] is zero, whatever x holds
// there: the MoE layer fills each expert's slot from row 0 and pads it with
// a zero row, so at serving's drop-free capacity (C = the tokens N, top-k
// of E experts) only about k/E of the rows are live.
//
// Bound on an H100 (NVIDIA H100 SXM data sheet): 2 E C D F operations
// against 989 TFLOP/s of bf16 tensor-core rate (67 TFLOP/s float32 on the
// CUDA cores for the float32 path), and (E C D + E D F + E C F) elements
// moved against 3.35 TB/s.  With `rows`, the live bound counts 2 sum(rows)
// D F operations, and the bytes of the live rows of x, of the weights of
// the experts with rows > 0 and of all of out (its zeros too).  At
// serving's decode shape (C = the batch, 4) the weights dominate the bytes
// and the call is bound by memory; at a prefill (C = B S in the thousands)
// it is bound by operations, and with `rows` by the bytes of w and out.
//
// Design.  The TPU kernel walks a grid (E, C/bm, F/bn, D/bk) in order and
// carries the float32 tile across the D steps in VMEM scratch; it asserts
// that 128-wide tiles divide C, D and F.  Here the D loop is a loop inside
// the block, fed by TMA through a ring of shared-memory stages on mbarriers
// (a producer warp issues the copies, the warpgroups run wgmma on the
// stages that have landed and hand each back when its products are done;
// sm90.cuh has the building blocks).  The tensor maps are 3-D over
// [E, rows, columns], so a box never crosses into the next expert: TMA
// reads zeros past C, D and F, and the store clips at C and F.  bf16 with
// D and F multiples of 8 and 16-byte-aligned tensors (what TMA can map):
//   C >= 64 ("tiles"): one block a 128 x 128 output tile of one expert
//            (grid F/128 x C/128 x E), two consumer warpgroups of
//            wgmma m64n128k16 (x K-major as A, w N-major as B), a
//            3-stage ring of 64-deep x and w tiles (32 KB a stage, two
//            blocks an SM); the epilogue rounds to bf16 into the freed
//            ring and stores the tile with TMA.  A tile whose first row is
//            past rows[e] writes its zeros and returns before any load.
//   C < 64  ("stream", decode): the call is bound by the bytes of w, read
//            once.  One block streams a 64-column slice of w[e] (grid F/64
//            x E) through a 6-stage ring of 64 x 64 tiles (8 KB each, with
//            the matching 64-deep slice of x[e]); one warpgroup computes
//            out^T = w^T x^T by wgmma m64nNk16, F on the M side and the
//            C <= N tokens (N = 8, 16, 32 or 64) on the N side, and stores
//            out directly.  An expert with rows[e] == 0 reads nothing.
// Other shapes take the simple kernels:
//   bf16 ("wmma"): one 64 x 64 tile a block by WMMA 16x16x16 (mma.sync),
//            one stage staged by the threads with bounds checks;
//   float32 ("fma"): the same tiling, 256 threads each a 4 x 4 block of
//            outputs by FMA (no TF32: the result is full float32).
// Both honour rows: a tile past rows[e] writes zeros and returns, and rows
// past rows[e] are stored as zeros.
//
// The backward of out = x w (rows as there) runs the tiles kernel in two
// more forms, with no transposed copy and no zeroing pass
// (repro_segment_matmul_bwd; bf16, D and F multiples of 8, any C):
//   "dx" dx [E, C, D] = dout [E, C, F] w[E, D, F]^T: w read as a K-major B
//        operand (its own map, boxes of 64 f by 128 d, transpose bit 0);
//        rows past rows[e] zero, tiles past them load nothing, as forward.
//        C < 64 takes it too: TMA reads zeros past C and the store clips.
//   "dw" dw [E, D, F] = x[E, C, D]^T dout [E, C, F] over r < rows[e]: x an
//        M-major A operand (boxes of 64 d by 64 c, transpose bit 1), dout
//        N-major as w is forward.  The contraction stops at rows[e] rounded
//        up to a stage; in that last stage the rows past rows[e] are zeroed
//        in shared memory in both operands (x may hold NaN there, and
//        0 NaN is NaN), the generic-proxy writes fenced before the wgmma.
//        An expert with rows[e] == 0 writes zeros and loads nothing.
// Bound of the backward: 2 sum(rows) D F operations a product at the bf16
// tensor-core rate, or the live rows of dout and x, the weights of the
// experts with rows > 0 read and all of dx and dw written, once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

enum Route { kFma = 0, kWmma = 1, kTiles = 2, kStream = 3 };
// The tiles kernel's forms: out = a b (the forward), a b^T (dx), a^T b (dw).
enum Form { kNN = 0, kNT = 1, kTN = 2 };

// Live rows of expert e: rows[e] clamped to [0, C], or C without rows.
__device__ __forceinline__ int live_rows(const int* rows, int e, int C) {
  return rows == nullptr ? C : min(max(rows[e], 0), C);
}

// out[e][r][c] = 0 for r in [r0, r1), c in [c0, c1) of out [E, M, N], by
// 16-byte stores (c0, c1 and N multiples of 8, out 16-byte aligned).
__device__ void zero_box(bf16* out, int e, int M, int N, int r0, int r1,
                         int c0, int c1) {
  const int chunks = (c1 - c0) / 8;
  const int n = (r1 - r0) * chunks;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i / chunks, c = c0 + 8 * (i % chunks);
    *reinterpret_cast<uint4*>(out + (static_cast<size_t>(e) * M + r) * N +
                              c) = make_uint4(0, 0, 0, 0);
  }
}

// ---- C >= 64: 128 x 128 tiles, two wgmma warpgroups ------------------------
constexpr int kK = 64;                               // depth of a stage
constexpr int kPM = 128, kPN = 128, kPStages = 3;
constexpr int kPThreads = 288;                       // 2 warpgroups + 1 warp
constexpr uint32_t kPXBytes = kPM * kK * 2;          // x tile, 16 KB
constexpr uint32_t kHalf = kK * 64 * 2;              // 64 x 64 w tile, 8 KB
constexpr uint32_t kPStage = kPXBytes + 2 * kHalf;   // 32 KB
constexpr size_t kPSmem = kPStages * kPStage + 2 * kPStages * 8 + 1024;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// out [E, M, N] of the form kForm over a contraction of K; C and rows as
// the forward's (the rows of a and out for kNN and kNT, the contraction
// for kTN).
template <int kForm>
__global__ void __launch_bounds__(kPThreads, 2)
seg_mm_tiles(__grid_constant__ const CUtensorMap ta,
             __grid_constant__ const CUtensorMap tb,
             __grid_constant__ const CUtensorMap to, bf16* __restrict__ out,
             const int* __restrict__ rows, int C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPStages * kPStage);
  uint64_t* empty = full + kPStages;

  const int n0 = blockIdx.x * kPN, m0 = blockIdx.y * kPM, e = blockIdx.z;
  const int live = live_rows(rows, e, C);
  if (kForm == kTN ? live == 0 : m0 >= live) {
    zero_box(out, e, M, N, m0, min(m0 + kPM, M), n0, min(n0 + kPN, N));
    return;
  }
  const int n_k = ((kForm == kTN ? live : K) + kK - 1) / kK;
  const bool two_halves = n0 + 64 < N;   // else b's second half is past N
  const bool two_m = m0 + 64 < M;        // kTN: else a's second box is past M
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                       // the producer
    if (threadIdx.x % 32 == 0) {
      for (int k = 0; k < n_k; ++k) {
        const int s = k % kPStages;
        if (k >= kPStages) sm90::mbar_wait(&empty[s], (k / kPStages - 1) & 1);
        uint8_t* st = smem + s * kPStage;
        if constexpr (kForm == kNT) {      // b: one 128-row box, K-major
          sm90::mbar_arrive_expect_tx(&full[s], 2 * kPXBytes);
          sm90::tma_load_3d(st, &ta, &full[s], k * kK, m0, e);
          sm90::tma_load_3d(st + kPXBytes, &tb, &full[s], k * kK, n0, e);
          continue;
        }
        sm90::mbar_arrive_expect_tx(
            &full[s], (kForm == kTN ? (two_m ? 2 : 1) * kHalf : kPXBytes) +
                          (two_halves ? 2 : 1) * kHalf);
        if constexpr (kForm == kTN) {      // a: two 64 x 64 boxes, M-major
          sm90::tma_load_3d(st, &ta, &full[s], m0, k * kK, e);
          if (two_m)
            sm90::tma_load_3d(st + kHalf, &ta, &full[s], m0 + 64, k * kK, e);
        } else {
          sm90::tma_load_3d(st, &ta, &full[s], k * kK, m0, e);
        }
        sm90::tma_load_3d(st + kPXBytes, &tb, &full[s], n0, k * kK, e);
        if (two_halves)
          sm90::tma_load_3d(st + kPXBytes + kHalf, &tb, &full[s], n0 + 64,
                            k * kK, e);
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of the
  // tile.  Without two_halves (or, kTN, two_m), columns (rows) 64..127
  // multiply stale shared memory and are never stored.
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  for (int k = 0; k < n_k; ++k) {
    const int s = k % kPStages;
    sm90::mbar_wait(&full[s], (k / kPStages) & 1);
    uint8_t* st = smem + s * kPStage;
    if constexpr (kForm == kTN) {
      // The last stage's rows past rows[e], in all four 64-row boxes.
      const int r0 = live - k * kK;
      if (r0 < kK && live < C) {
        const int per = (kK - r0) * 8;   // 16-byte chunks a box
        for (int i = threadIdx.x; i < 4 * per; i += 256)
          *reinterpret_cast<uint4*>(st + (i / per) * kHalf +
                                    (r0 + (i % per) / 8) * 128 +
                                    (i % 8) * 16) = make_uint4(0, 0, 0, 0);
        sm90::fence_proxy_async();
        sm90::named_barrier(1, 256);
      }
    }
    const uint32_t sa = sm90::smem_u32(st);
    const uint32_t sb = sa + kPXBytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      if constexpr (kForm == kNN)
        sm90::wgmma_m64n128k16<0, 1>(
            acc, sm90::desc_sw128(sa + wg * 64 * 128 + 32 * kk, 16, 1024),
            sm90::desc_sw128(sb + 2048 * kk, kHalf, 1024));
      else if constexpr (kForm == kNT)
        sm90::wgmma_m64n128k16<0, 0>(
            acc, sm90::desc_sw128(sa + wg * 64 * 128 + 32 * kk, 16, 1024),
            sm90::desc_sw128(sb + 32 * kk, 16, 1024));
      else
        sm90::wgmma_m64n128k16<1, 1>(
            acc, sm90::desc_sw128(sa + wg * kHalf + 2048 * kk, kHalf, 1024),
            sm90::desc_sw128(sb + 2048 * kk, kHalf, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();               // stage k - 1's products are done
    if (k > 0 && threadIdx.x % 128 == 0)
      sm90::mbar_arrive(&empty[(k - 1) % kPStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // Epilogue: bf16 into the freed ring as two [128][64] halves in the
  // swizzled layout of the output map (conflict-free: the 8 rows of a
  // warp's store land in 8 different chunks), then two TMA stores.
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int r_lo = wg * 64 + 16 * (warp % 4) + lane / 4;
  sm90::named_barrier(1, 256);           // both warpgroups left the ring
#pragma unroll
  for (int g = 0; g < 16; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      const bool keep = kForm == kTN || m0 + r < live;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          keep ? acc[4 * g + 2 * h] : 0.0f,
          keep ? acc[4 * g + 2 * h + 1] : 0.0f);
      const uint32_t off = (g / 8) * (kPM * 128) + r * 128 +
                           ((g % 8) ^ (r % 8)) * 16 + 4 * q;
      *reinterpret_cast<__nv_bfloat162*>(smem + off) = v;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(1, 256);
  if (threadIdx.x == 0) {
    sm90::tma_store_3d(&to, smem, n0, m0, e);
    if (two_halves) sm90::tma_store_3d(&to, smem + kPM * 128, n0 + 64, m0, e);
    sm90::tma_store_wait();
  }
}

// ---- C < 64: stream w, out^T = w^T x^T -------------------------------------
constexpr int kSM = 64, kSStages = 6;
constexpr int kSThreads = 160;                       // 1 warpgroup + 1 warp

template <int NT>
__host__ __device__ constexpr uint32_t stream_stage() {
  return kHalf + NT * 128;
}

template <int NT>
__host__ __device__ constexpr size_t stream_smem() {
  return kSStages * stream_stage<NT>() + 2 * kSStages * 8 + 1024;
}

template <int NT>
__device__ __forceinline__ void wgmma_stream(float (&acc)[NT / 2],
                                             uint64_t da, uint64_t db) {
  if constexpr (NT == 8) sm90::wgmma_m64n8k16<1, 0>(acc, da, db);
  else if constexpr (NT == 16) sm90::wgmma_m64n16k16<1, 0>(acc, da, db);
  else if constexpr (NT == 32) sm90::wgmma_m64n32k16<1, 0>(acc, da, db);
  else sm90::wgmma_m64n64k16<1, 0>(acc, da, db);
}

template <int NT>
__global__ void __launch_bounds__(kSThreads)
seg_mm_stream(__grid_constant__ const CUtensorMap tw,
              __grid_constant__ const CUtensorMap tx, bf16* __restrict__ out,
              const int* __restrict__ rows, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  constexpr uint32_t kStage = stream_stage<NT>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSStages * kStage);
  uint64_t* empty = full + kSStages;

  const int f0 = blockIdx.x * kSM, e = blockIdx.y;
  const int live = live_rows(rows, e, C);
  if (live == 0) {
    zero_box(out, e, C, F, 0, C, f0, min(f0 + kSM, F));
    return;
  }
  const int n_k = (D + kK - 1) / kK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                       // the producer
    if (threadIdx.x % 32 == 0) {
      for (int k = 0; k < n_k; ++k) {
        const int s = k % kSStages;
        if (k >= kSStages) sm90::mbar_wait(&empty[s], (k / kSStages - 1) & 1);
        uint8_t* st = smem + s * kStage;
        sm90::mbar_arrive_expect_tx(&full[s], kStage);
        sm90::tma_load_3d(st, &tw, &full[s], f0, k * kK, e);
        sm90::tma_load_3d(st + kHalf, &tx, &full[s], k * kK, 0, e);
      }
    }
    return;
  }

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  for (int k = 0; k < n_k; ++k) {
    const int s = k % kSStages;
    sm90::mbar_wait(&full[s], (k / kSStages) & 1);
    const uint32_t wa = sm90::smem_u32(smem + s * kStage);
    const uint32_t xb = wa + kHalf;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)
      wgmma_stream<NT>(acc, sm90::desc_sw128(wa + 2048 * kk, kHalf, 1024),
                       sm90::desc_sw128(xb + 32 * kk, 16, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (k > 0 && threadIdx.x == 0)
      sm90::mbar_arrive(&empty[(k - 1) % kSStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // acc holds out^T: row f (M side), column c (token).
  const int lane = threadIdx.x % 32;
  const int f_lo = f0 + 16 * warp + lane / 4;
#pragma unroll
  for (int g = 0; g < NT / 8; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * g + 2 * (lane % 4) + i % 2;
      const int f = f_lo + 8 * (i / 2);
      if (c < C && f < F)
        out[(static_cast<size_t>(e) * C + c) * F + f] =
            __float2bfloat16_rn(c < live ? acc[4 * g + i] : 0.0f);
    }
  }
}

// ---- other shapes: the simple kernels --------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;

__global__ void __launch_bounds__(128)
segment_matmul_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ out, const int* __restrict__ rows,
                    int C, int D, int F) {
  __shared__ __align__(32) bf16 As[kBM][kBK + 8];
  __shared__ __align__(32) bf16 Bs[kBK][kBN + 8];
  __shared__ __align__(32) float Cs[kBM][kBN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int live = live_rows(rows, e, C);
  bf16* oe = out + static_cast<size_t>(e) * C * F;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  if (m0 >= live) {
    for (int i = threadIdx.x; i < kBM * kBN; i += blockDim.x) {
      const int gr = m0 + i / kBN, gc = n0 + i % kBN;
      if (gr < C && gc < F) oe[static_cast<size_t>(gr) * F + gc] = zero;
    }
    return;
  }
  const bf16* xe = x + static_cast<size_t>(e) * C * D;
  const bf16* we = w + static_cast<size_t>(e) * D * F;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int r = i / kBK, c = i % kBK;
      const int gr = m0 + r, gc = k0 + c;
      As[r][c] = (gr < C && gc < D) ? xe[static_cast<size_t>(gr) * D + gc]
                                    : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < D && gc < F) ? we[static_cast<size_t>(gr) * F + gc]
                                    : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], kBK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn + 16 * j], kBN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              kBN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += blockDim.x) {
    const int r = i / kBN, c = i % kBN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < C && gc < F)
      oe[static_cast<size_t>(gr) * F + gc] =
          gr < live ? __float2bfloat16_rn(Cs[r][c]) : zero;
  }
}

__global__ void __launch_bounds__(256)
segment_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, const int* __restrict__ rows,
                   int C, int D, int F) {
  __shared__ float As[kBK][kBM + 4];   // k-major: As[k][m]
  __shared__ float Bs[kBK][kBN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int live = live_rows(rows, e, C);
  float* oe = out + static_cast<size_t>(e) * C * F;
  if (m0 >= live) {
    for (int i = threadIdx.x; i < kBM * kBN; i += blockDim.x) {
      const int gr = m0 + i / kBN, gc = n0 + i % kBN;
      if (gr < C && gc < F) oe[static_cast<size_t>(gr) * F + gc] = 0.0f;
    }
    return;
  }
  const float* xe = x + static_cast<size_t>(e) * C * D;
  const float* we = w + static_cast<size_t>(e) * D * F;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int r = i / kBK, c = i % kBK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < C && gc < D) ? xe[static_cast<size_t>(gr) * D + gc]
                                    : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < D && gc < F) ? we[static_cast<size_t>(gr) * F + gc]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx + 16 * j;
      if (gr < C && gc < F)
        oe[static_cast<size_t>(gr) * F + gc] = gr < live ? acc[i][j] : 0.0f;
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

template <int NT>
cudaError_t launch_stream(const CUtensorMap& tw, const bf16* x, bf16* out,
                          const int* rows, int E, int C, int D, int F,
                          int device, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  CUtensorMap tx;
  if (!sm90::tensor_map_bf16_3d(&tx, x, D, C, E, kK, NT))
    return cudaErrorNotSupported;
  cudaError_t err = allow_smem(seg_mm_stream<NT>, stream_smem<NT>(), device,
                               done);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kSM - 1) / kSM, E);
  seg_mm_stream<NT><<<grid, kSThreads, stream_smem<NT>(), s>>>(
      tw, tx, out, rows, C, D, F);
  return cudaGetLastError();
}

template <int kForm>
cudaError_t launch_tiles(const CUtensorMap& ta, const CUtensorMap& tb,
                         const CUtensorMap& to, bf16* out, const int* rows,
                         int E, int C, int M, int N, int K, int device,
                         cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  cudaError_t err = allow_smem(seg_mm_tiles<kForm>, kPSmem, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM, E);
  seg_mm_tiles<kForm><<<grid, kPThreads, kPSmem, s>>>(ta, tb, to, out, rows,
                                                       C, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_tma(const bf16* x, const bf16* w, bf16* out,
                       const int* rows, int E, int C, int D, int F,
                       int device, cudaStream_t s, int* route) {
  CUtensorMap tw;
  if (!sm90::tensor_map_bf16_3d(&tw, w, F, D, E, 64, kK))
    return cudaErrorNotSupported;
  if (C < 64) {
    *route = kStream;
    if (C <= 8)
      return launch_stream<8>(tw, x, out, rows, E, C, D, F, device, s);
    if (C <= 16)
      return launch_stream<16>(tw, x, out, rows, E, C, D, F, device, s);
    if (C <= 32)
      return launch_stream<32>(tw, x, out, rows, E, C, D, F, device, s);
    return launch_stream<64>(tw, x, out, rows, E, C, D, F, device, s);
  }
  *route = kTiles;
  CUtensorMap tx, to;
  if (!sm90::tensor_map_bf16_3d(&tx, x, D, C, E, kK, kPM) ||
      !sm90::tensor_map_bf16_3d(&to, out, F, C, E, 64, kPM))
    return cudaErrorNotSupported;
  return launch_tiles<kNN>(tx, tw, to, out, rows, E, C, C, F, D, device, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[e] = x[e] @ w[e]; dtype 0 = float32, 1 = bf16 (x, w and out alike).
// rows: int32 [E] on the device, or null for all C rows.  Sets *route to
// the kernel launched (0 fma, 1 wmma, 2 tiles, 3 stream).  Returns a
// cudaError_t (0 on success); launches asynchronously on `stream`.
int repro_segment_matmul(const void* x, const void* w, void* out,
                         const int* rows, int E, int C, int D, int F,
                         int dtype, int device, void* stream, int* route) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (C + kBM - 1) / kBM > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D % 8 == 0 && F % 8 == 0 && aligned16(x) &&
      aligned16(w) && aligned16(out))
    return launch_tma(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                      static_cast<bf16*>(out), rows, E, C, D, F, device, s,
                      route);
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if (dtype == 1) {
    *route = kWmma;
    segment_matmul_bf16<<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), rows, C, D, F);
  } else {
    *route = kFma;
    segment_matmul_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), rows, C, D, F);
  }
  return cudaGetLastError();
}

// The backward's two products of out = x w (bf16, D and F multiples of 8,
// every tensor 16-byte aligned; rows as repro_segment_matmul's):
// form 1 ("dx"): out [E, C, D] = a [E, C, F] b [E, D, F]^T (a = dout,
// b = w), its rows past rows[e] zero; form 2 ("dw"): out [E, D, F] =
// a [E, C, D]^T b [E, C, F] (a = x, b = dout) over the rows r < rows[e].
// Returns a cudaError_t (0 on success); launches asynchronously on
// `stream`.
int repro_segment_matmul_bwd(int form, const void* a, const void* b,
                             void* out, const int* rows, int E, int C, int D,
                             int F, int device, void* stream) {
  const int M = form == 1 ? C : D;
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 || D % 8 != 0 ||
      F % 8 != 0 || (M + kPM - 1) / kPM > 65535 || (form != 1 && form != 2) ||
      !aligned16(a) || !aligned16(b) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  CUtensorMap ta, tb, to;
  if (form == 1) {
    if (!sm90::tensor_map_bf16_3d(&ta, a, F, C, E, kK, kPM) ||
        !sm90::tensor_map_bf16_3d(&tb, b, F, D, E, kK, kPN) ||
        !sm90::tensor_map_bf16_3d(&to, out, D, C, E, 64, kPM))
      return cudaErrorNotSupported;
    return launch_tiles<kNT>(ta, tb, to, o, rows, E, C, C, D, F, device, s);
  }
  if (!sm90::tensor_map_bf16_3d(&ta, a, D, C, E, 64, kK) ||
      !sm90::tensor_map_bf16_3d(&tb, b, F, C, E, 64, kK) ||
      !sm90::tensor_map_bf16_3d(&to, out, F, D, E, 64, kPM))
    return cudaErrorNotSupported;
  return launch_tiles<kTN>(ta, tb, to, o, rows, E, C, D, F, C, device, s);
}

}  // extern "C"
