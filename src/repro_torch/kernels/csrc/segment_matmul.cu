// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/segment_matmul.py
// (wrapper segment_matmul :35, kernel _seg_mm_kernel :19):
//   out[e] = x[e] @ w[e]   for x [E, C, D], w [E, D, F], out [E, C, F],
// accumulated in float32 and rounded once to the inputs' dtype (bf16 or
// float32; x, w and out share it).  This is the expert compute of the MoE
// layer (repro/models/moe.py:161-164), C being the expert capacity.
//
// Bound on an H100 (NVIDIA H100 SXM data sheet): 2 E C D F operations
// against 989 TFLOP/s of bf16 tensor-core rate (67 TFLOP/s float32 on the
// CUDA cores for the float32 path), and (E C D + E D F + E C F) elements
// moved against 3.35 TB/s.  At serving's decode shape (C = the batch, 4)
// the weights dominate the bytes and the call is bound by memory; at a
// long prefill (C = B S in the thousands) it is bound by operations.
//
// Design.  The TPU kernel walks a grid (E, C/bm, F/bn, D/bk) in order and
// carries the float32 tile across the D steps in VMEM scratch; it asserts
// that 128-wide tiles divide C, D and F.  Here the D loop is a loop inside
// the block, so nothing is carried between blocks: one block computes one
// 64 x 64 output tile of one expert (grid F/64 x C/64 x E), staging a
// 64 x 32 tile of x and a 32 x 64 tile of w in shared memory per step.
// Every load past C, D or F reads zero and every store past C or F is
// skipped, so any shape is taken.
//   bf16:    4 warps, each a 32 x 32 quarter of the tile as 2 x 2 WMMA
//            16x16x16 fragments (mma.sync with bf16 inputs and float32
//            accumulators: bf16 x bf16 products are exact in float32).  The
//            accumulators go through shared memory to a masked, rounded
//            store.
//   float32: 256 threads, each a 4 x 4 block of outputs, by FMA from the
//            shared tiles (no TF32: the result is full float32).
// One stage, no asynchronous copies: a simple kernel first; making it fast
// (TMA, wgmma, a ring of stages) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;

__global__ void __launch_bounds__(128)
segment_matmul_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(32) bf16 As[kBM][kBK + 8];
  __shared__ __align__(32) bf16 Bs[kBK][kBN + 8];
  __shared__ __align__(32) float Cs[kBM][kBN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bf16* xe = x + static_cast<size_t>(e) * C * D;
  const bf16* we = w + static_cast<size_t>(e) * D * F;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const bf16 zero = __float2bfloat16_rn(0.0f);

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
  bf16* oe = out + static_cast<size_t>(e) * C * F;
  for (int i = threadIdx.x; i < kBM * kBN; i += blockDim.x) {
    const int r = i / kBN, c = i % kBN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < C && gc < F)
      oe[static_cast<size_t>(gr) * F + gc] = __float2bfloat16_rn(Cs[r][c]);
  }
}

__global__ void __launch_bounds__(256)
segment_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int C, int D, int F) {
  __shared__ float As[kBK][kBM + 4];   // k-major: As[k][m]
  __shared__ float Bs[kBK][kBN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
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

  float* oe = out + static_cast<size_t>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx + 16 * j;
      if (gr < C && gc < F) oe[static_cast<size_t>(gr) * F + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[e] = x[e] @ w[e]; dtype 0 = float32, 1 = bf16 (x, w and out alike).
// Returns a cudaError_t (0 on success); launches asynchronously on
// `stream`.
int repro_segment_matmul(const void* x, const void* w, void* out, int E,
                         int C, int D, int F, int dtype, int device,
                         void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (C + kBM - 1) / kBM > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    segment_matmul_bf16<<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), C, D, F);
  else
    segment_matmul_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, D, F);
  return cudaGetLastError();
}

}  // extern "C"
