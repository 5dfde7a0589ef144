// RWKV6 recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv_scan.py
// (wrapper rwkv_scan :40, kernel _rwkv_kernel :22), the recurrence that
// repro/models/ssm.py::rwkv6_apply runs with lax.scan (ssm.py:99-110).
// Per (b, h), over t = 0 .. T-1, with S the [hd, hd] state:
//   out_t = r_t (S + diag(u) k_t v_t^T)
//   S     = diag(w_t) S + k_t v_t^T
// for float32 r, k, v, w [B, H, T, hd] (any strides, hd's 1; the four
// alike), u [H, hd], state0 [B, H, hd, hd] (zeros when null), out
// [B, H, T, hd] (any strides, hd's 1) and the final state [B, H, hd, hd].
// The model passes r, k, v, w as views of its [B, T, H hd] activations
// and gets out in that layout, so no copy goes in or out.  The arithmetic
// is the reference's, in float32; only the order of out_t's sum over k
// differs (sixteen partial sums of hd/16 terms, added in a fixed order).
//
// Bound on an H100 (NVIDIA H100 SXM data sheet): the function needs about
// 4 hd^2 float32 operations per step of each (b, h): r_t S, a multiply-add
// per state entry, and the decayed update, which a chunked form does as
// one multiply-add per entry on a state rescaled by the chunk's decay; the
// bonus r_t diag(u) k_t v_t^T is (sum_k r_k u_k k_k) v_t, O(hd).  Those at
// 67 TFLOP/s on the CUDA cores, against r, k, v, w and out moved once and
// the two states at 3.35 TB/s.  At the serve's prefill (B 4, H 32,
// T ~ 445, hd 64) the bytes set it, ~0.023 ms; a decode step (T = 1) is
// the 4 MB of state in and out, ~1.3 us.  This kernel does 7 hd^2 (it adds
// the bonus to every entry, one multiply-add each, and updates S with a
// product and a multiply-add), and the recurrence is sequential in t, so a
// kernel that walks t one step at a time is bound by its per-step latency
// instead, far above either.
//
// Design.  The TPU kernel keeps the state in VMEM for the whole sequence,
// one grid step per (b, h).  Here one block of 4 HDP threads owns one
// (b, h) (grid B H) and keeps the state in registers for the whole T loop:
// thread (quarter q, column c) holds S[k][c] for the HDP/4 rows k of its
// quarter, where HDP is hd rounded up to 16, 32 or 64 (the padding rows and
// columns hold zeros and stay zero).  The inputs are staged in shared
// memory, kTC = 16 steps of r, k, v and w a chunk, in two buffers: the
// next chunk's loads start into registers before the current chunk is
// computed and stored to the other buffer after it, so they are in flight
// during the compute.  Each step a thread adds its quarter's terms of
// out_t[c] in four interleaved accumulators (four short dependency chains
// in place of one long one) and writes their sum to shared memory; after
// the chunk's one __syncthreads the four quarters' partials of each (t, c)
// are summed in a fixed order and written out.  The step loop is unrolled
// by two, so one step's shared loads overlap the other's chains (0.104
// against 0.134 ms with neither, at the serve's prefill shape on an H100;
// the four accumulators alone gained nothing).  Float32 on the CUDA
// cores, no tensor cores: a simple kernel first.  The chunked form, which
// puts the intra-chunk products on the tensor cores, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTC = 16;        // steps staged a chunk

template <int HDP>
constexpr size_t smem_bytes() {
  // Two staging buffers [4][kTC][HDP] (r, k, v, w) and two partial-sum
  // buffers [kTC][4][HDP].
  return sizeof(float) * 2 * (4 * kTC * HDP + kTC * 4 * HDP);
}

// Thread (q, c) stages, of each of r, k, v and w, column c of the chunk's
// steps q, q + 4, q + 8 and q + 12: reg[4 a + m] is array a at step
// t0 + q + 4 m.  Out of range (t >= T or c >= hd) it stages 0.  `src[a]`
// points at column c of array a's (b, h) sequence, `ts` is t's stride.
__device__ __forceinline__ void fetch(const float* const (&src)[4],
                                      int64_t ts, int t0, int T_len,
                                      bool col, int q, float (&reg)[kTC]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int t = t0 + q + 4 * m;
    const bool in = col && t < T_len;
    const int64_t off = t * ts;
#pragma unroll
    for (int a = 0; a < 4; ++a) reg[4 * a + m] = in ? src[a][off] : 0.0f;
  }
}

template <int HDP>
__device__ __forceinline__ void stage(float* buf, int q, int c,
                                      const float (&reg)[kTC]) {
#pragma unroll
  for (int j = 0; j < kTC; ++j)
    buf[((j / 4) * kTC + q + 4 * (j % 4)) * HDP + c] = reg[j];
}

// Strides in elements: `in` of r, k, v and w (b, h, t), `os` of out.
struct Strides {
  int64_t in[3], os[3];
};

template <int HDP>
__global__ void __launch_bounds__(4 * HDP)
rwkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ sT, int H,
                 int T_len, int hd, Strides sd) {
  constexpr int KPT = HDP / 4;               // state rows a thread holds
  constexpr int STAGE = 4 * kTC * HDP;       // floats of a staging buffer
  constexpr int PART = kTC * 4 * HDP;        // floats of a partial buffer
  extern __shared__ float smem[];
  float* stg = smem;                         // [2][STAGE]
  float* part = smem + 2 * STAGE;            // [2][PART]

  const int tid = threadIdx.x;
  const int c = tid % HDP;                   // the state column (v index)
  const int q = tid / HDP;                   // the quarter of the rows
  const int k0 = q * KPT;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int64_t seq = b * sd.in[0] + h * sd.in[1] + c;
  const int64_t oseq = b * sd.os[0] + h * sd.os[1];
  const float* const src[4] = {r + seq, k + seq, v + seq, w + seq};
  const size_t st = static_cast<size_t>(bh) * hd * hd;

  float S[KPT], uk[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kk = k0 + j;
    const bool in = kk < hd && c < hd;
    S[j] = (s0 != nullptr && in) ? s0[st + static_cast<size_t>(kk) * hd + c]
                                 : 0.0f;
    uk[j] = kk < hd ? u[h * hd + kk] : 0.0f;
  }

  float reg[kTC];
  const int n_chunks = (T_len + kTC - 1) / kTC;
  if (n_chunks > 0) {
    fetch(src, sd.in[2], 0, T_len, c < hd, q, reg);
    stage<HDP>(stg, q, c, reg);
  }
  __syncthreads();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kTC;
    const bool more = ch + 1 < n_chunks;
    // The next chunk's loads go out now and land during the compute.
    if (more) fetch(src, sd.in[2], t0 + kTC, T_len, c < hd, q, reg);

    const float* R = stg + (ch & 1) * STAGE;
    const float* K = R + kTC * HDP;
    const float* V = K + kTC * HDP;
    const float* W = V + kTC * HDP;
    float* P = part + (ch & 1) * PART;
    const int steps = min(kTC, T_len - t0);
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      const float vc = V[tt * HDP + c];
      const float* Rt = R + tt * HDP + k0;
      const float* Kt = K + tt * HDP + k0;
      const float* Wt = W + tt * HDP + k0;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float kv = Kt[j] * vc;
        acc[j % 4] = fmaf(Rt[j], fmaf(uk[j], kv, S[j]), acc[j % 4]);
        S[j] = fmaf(Wt[j], S[j], kv);
      }
      P[(tt * 4 + q) * HDP + c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }

    if (more) stage<HDP>(stg + ((ch + 1) & 1) * STAGE, q, c, reg);
    __syncthreads();

    // out[t0 + tt][c] for tt = q, q + 4, q + 8, q + 12.
#pragma unroll
    for (int m = 0; m < kTC / 4; ++m) {
      const int tt = q + 4 * m;
      if (tt < steps && c < hd) {
        const float* p = P + tt * 4 * HDP + c;
        const float o = ((p[0] + p[HDP]) + p[2 * HDP]) + p[3 * HDP];
        out[oseq + (t0 + tt) * sd.os[2] + c] = o;
      }
    }
  }

  if (c < hd) {
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = k0 + j;
      if (kk < hd) sT[st + static_cast<size_t>(kk) * hd + c] = S[j];
    }
  }
}

template <int HDP>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0,
                   float* out, float* sT, int B, int H, int T_len, int hd,
                   const Strides& sd, cudaStream_t stream) {
  auto kernel = rwkv_scan_kernel<HDP>;
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, 4 * HDP, smem, stream>>>(r, k, v, w, u, s0, out, sT, H,
                                           T_len, hd, sd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, w and out [B, H, T, hd] float32, at element strides (b, h, t)
// `sb, sh, st` for r, k, v and w and `ob, oh, ot` for out, hd's stride 1;
// u [H, hd], state0 [B, H, hd, hd] (or null: zeros) and state
// [B, H, hd, hd] float32, contiguous.  1 <= hd <= 64, T >= 0.  Returns a
// cudaError_t (0 on success); launches asynchronously on `stream`.
int repro_rwkv_scan(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* state0,
                    float* out, float* state, int B, int H, int T_len,
                    int hd, long long sb, long long sh, long long st,
                    long long ob, long long oh, long long ot, int device,
                    void* stream) {
  if (B < 1 || H < 1 || T_len < 0 || hd < 1 || hd > 64 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides sd{{sb, sh, st}, {ob, oh, ot}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 16)
    return launch<16>(r, k, v, w, u, state0, out, state, B, H, T_len, hd, sd,
                      s);
  if (hd <= 32)
    return launch<32>(r, k, v, w, u, state0, out, state, B, H, T_len, hd, sd,
                      s);
  return launch<64>(r, k, v, w, u, state0, out, state, B, H, T_len, hd, sd,
                    s);
}

}  // extern "C"
