// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (wrapper flash_attention :72, kernel _flash_kernel :26), the computation
// of repro/models/attention.py::flash_attention_ref on the prefill path
// (attention.py:174 and :180):
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/rep, j])
//                  * v[b, h/rep, j]
// for q [B, H, S, hd], k and v [B, H/rep, T, hd] (bf16 or float32, all
// alike), out [B, H, S, hd] float32; causal masks j > i (S == T: the
// wrapper refuses a causal call with S != T).  The arithmetic is the TPU
// kernel's, in float32: q is cast and then scaled, masked scores take the
// value -2^30 (not -inf), the running max m, sum l and accumulator acc are
// carried across KV tiles with the online-softmax correction, and the
// output is acc / max(l, 1e-20).  KV tiles wholly above the diagonal are
// skipped.  GQA: query head h reads KV head h / rep; the KV heads are never
// repeated in memory.
//
// Bound on an H100 (NVIDIA H100 SXM data sheet): each product takes 2 hd
// operations per visible (query, key) pair (S T pairs, S (S + 1) / 2 when
// causal and S == T).  With bf16 inputs Q K^T could run on the bf16 tensor
// cores (989 TFLOP/s dense): bf16 x bf16 products are exact in float32, and
// the model calls K5 with scale 1.  P is float32, so P V needs the 67 TFLOP/s
// of float32 on the CUDA cores, as both products do for float32 inputs.  The
// bytes are q, k and v read once and the float32 output written once,
// against 3.35 TB/s.  Prefill at the serving lengths is bound by operations,
// almost all of them P V's.
//
// Design.  The TPU kernel keeps the q tile and (acc, m, l) in VMEM while
// the innermost grid axis walks the KV tiles in order.  Here one block of
// 256 threads owns one 64-query tile of one (b, h) and walks the KV tiles
// in a loop (grid: S/64 x B H, the heaviest causal tiles launched first).
// The q tile (scaled) and each 64-key K and V tile are staged in shared
// memory as float32, rows padded by one word against bank conflicts.  Four
// consecutive threads own one query row: each computes 16 of the tile's 64
// scores, the row max and sum go round the four by shuffles, the
// probabilities go through shared memory (read back by the same warp), and
// each thread keeps hd / 4 accumulator columns (every fourth) in
// registers.  Float32 on CUDA cores, no tensor cores: a simple kernel
// first; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's mask

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * 64 * (HD + 1) + 64 * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ out,
                       int S, int T_len, int H, int rep, float scale,
                       int causal) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int DPT = HD / 4;        // accumulator columns a thread owns
  constexpr int SPT = kBK / 4;       // scores a thread computes a tile
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;         // [kBK][LD]
  float* Vs = Ks + kBK * LD;         // [kBK][LD]
  float* Ps = Vs + kBK * LD;         // [kBQ][LP]

  const int tid = threadIdx.x;
  const int r = tid >> 2;            // query row within the tile
  const int t = tid & 3;             // quarter of the row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / rep;
  const int n_kv = H / rep;
  const T* qp = q + static_cast<size_t>(bh) * S * HD;
  const T* kp = k + (static_cast<size_t>(b) * n_kv + kvh) * T_len * HD;
  const T* vp = v + (static_cast<size_t>(b) * n_kv + kvh) * T_len * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, c = i % HD;
    const int qi = q0 + rr;
    Qs[rr * LD + c] =
        qi < S ? to_float(qp[static_cast<size_t>(qi) * HD + c]) * scale
               : 0.0f;
  }

  const int qrow = q0 + r;
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;

  // Causal: only the tiles that start at or before the last query row.
  const int kv_end = causal ? min(T_len, q0 + kBQ) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the q tile is in; the last tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int rr = i / HD, c = i % HD;
      const int kj = k0 + rr;
      const bool in = kj < T_len;
      const size_t g = static_cast<size_t>(kj) * HD + c;
      Ks[rr * LD + c] = in ? to_float(kp[g]) : 0.0f;
      Vs[rr * LD + c] = in ? to_float(vp[g]) : 0.0f;
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
    for (int j = 0; j < kBK; ++j) {
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, float* out,
                   int B, int H, int rep, int S, int T_len, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, S, T_len, H, rep, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        float* out, int B, int H, int rep, int S, int T_len,
                        int hd, float scale, int causal,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, rep, S, T_len, scale, causal,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, rep, S, T_len, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, rep, S, T_len, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, rep, S, T_len, scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, H, S, hd], k and v [B, KV, T, hd], out [B, H, S, hd] float32;
// dtype 0 = float32, 1 = bf16 (q, k and v alike); hd in {16, 32, 64, 128};
// H a multiple of KV; causal needs S == T.  Returns a cudaError_t (0 on
// success); launches asynchronously on `stream`.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          float* out, int B, int H, int KV, int S, int T_len,
                          int hd, float scale, int causal, int dtype,
                          int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || T_len < 1 ||
      static_cast<long long>(B) * H > 65535 || (causal && S != T_len) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = H / KV;
  if (dtype == 1)
    return dispatch_hd<bf16>(q, k, v, out, B, H, rep, S, T_len, hd, scale,
                             causal, s);
  return dispatch_hd<float>(q, k, v, out, B, H, rep, S, T_len, hd, scale,
                            causal, s);
}

}  // extern "C"
