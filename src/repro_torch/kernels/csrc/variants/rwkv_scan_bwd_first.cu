// K6's backward as first designed, kept to compare the redesign with:
// `python3 kernel_variants.py k6bwd` builds it beside csrc/rwkv_scan.cu
// and holds the two bit for bit.  Plain C interface, the
// same entry as the source's (`repro_rwkv_scan_bwd`), reading the same
// checkpoints (the forward's state before every kCk-th step).
//
// Per (b, h), for t = T-1 down to 0, with G_t the gradient of the state
// after step t (dstate_T first), beta_t = sum_k r_t,k u_k k_t,k and
// vd_t = v_t . dout_t:
//   dr_t = S_{t-1} dout_t + u * k_t vd_t       dk_t = G_t v_t + u * r_t vd_t
//   dv_t = G_t^T k_t + dout_t beta_t           dw_t[k] = sum_c G_t S_{t-1}
//   du  += r_t * k_t vd_t                      G_{t-1} = diag(w_t) G_t +
//                                                        r_t dout_t^T
// and dstate0 = G_{-1}.
//
// Design.  One block per (b, h) (grid B H, one block an SM: 160 KB of
// shared memory at hd 64) walks t down with G in registers, a thread
// holding a kRows x NC tile (4 x 4 at hd 64, 256 threads; no helper warps:
// each phase of a chunk ends at __syncthreads).  Per chunk of kCk = 8
// steps, last chunk first, the block:
//   1. stages the chunk's rows of r, k, v, w and dout (widened to float32,
//      zeros past hd and past T) in shared memory from registers, where
//      each thread fetched its share a chunk ahead, and takes beta_t and
//      vd_t, a warp a step;
//   2. recomputes the chunk's states from its checkpoint with the
//      forward's arithmetic, each thread its own tile, into shared memory;
//   3. walks the chunk's steps down: a thread's row sums of G v, G . S and
//      S dout go across its row group's CG lanes by a reduce-scatter of
//      shuffles, its column sums G^T k across the warp's row groups by
//      shuffles, one partial a warp; then G = diag(w) G + r dout^T;
//   4. adds the bonus terms and the warps' partials and writes dr, dk, dv
//      and dw in the inputs' layout.
// du goes out as each (b, h)'s partial sum [B, H, hd]: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 4;       // state rows a thread holds (a float4)
// Steps between the forward's checkpoints, and the backward's chunk.
constexpr int kCk = 8;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A thread's NC floats of a row (8-byte aligned), as float2s.
template <int NC>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[NC]) {
#pragma unroll
  for (int n = 0; n < NC; n += 2) {
    const float2 x = *reinterpret_cast<const float2*>(p + n);
    v[n] = x.x;
    v[n + 1] = x.y;
  }
}

template <int NC>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[NC]) {
#pragma unroll
  for (int n = 0; n < NC; n += 2)
    *reinterpret_cast<float2*>(p + n) = make_float2(v[n], v[n + 1]);
}

// ---------------------------------------------------------------------------
// The backward (see the note at the top of the file).
// ---------------------------------------------------------------------------
constexpr int kBwdCols = 4;    // gradient columns a thread holds above hd 16

// Columns a backward thread holds, and its threads a block (one a kRows x
// cols tile of G and of the states): 256 at hd 64, 64 at 32, 32 at 16.
template <int HDP>
__host__ __device__ constexpr int bwd_cols() {
  return HDP == 16 ? 2 : kBwdCols;
}
template <int HDP>
__host__ __device__ constexpr int bwd_threads() {
  return (HDP / kRows) * (HDP / bwd_cols<HDP>());
}

// Shared memory, in order: the chunk's states [kCk][NC][NT] float4s (each
// thread's tile as NC float4s, so a warp's accesses are consecutive), the
// chunk's rows [5][kCk][HDP] (r, k, v, w, dout in float32), the row sums
// [3][kCk][HDP] (G v, G . S, S dout), the column partial sums
// [kCk][NW][HDP] (G^T k, a warp's row groups each), beta and v . dout
// [2][kCk] and u [HDP]: 160 KB at hd 64.
template <int HDP>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) *
         (kCk * HDP * HDP + 5 * kCk * HDP + 3 * kCk * HDP +
          kCk * (bwd_threads<HDP>() / 32) * HDP + 2 * kCk + HDP);
}

struct BwdArgs {
  const void* in[4];           // r, k, v, w
  const void* dout;            // r's type
  const float* u;              // [H, hd]
  const float* ck;             // [B, H, ceil(T / kCk), hd, hd]
  const float* dsT;            // [B, H, hd, hd] or null
  void* grad[4];               // dr, dk, dv (r's type), dw (w's type)
  float* du;                   // [B, H, hd], a partial sum per (b, h)
  float* ds0;                  // [B, H, hd, hd]
  int H, T, hd;
  long long is[3], ds[3], gs[3];  // (b, h, t) strides: inputs, dout, grads
};

template <typename T>
__device__ __forceinline__ float load_wide(const void* base, long long off) {
  return widen(static_cast<const T*>(base)[off]);
}

// Sums x over the CG lanes of a row group (lanes cg = lane % CG) and
// scatters the sums: afterwards x[p] (p < 16 / CG) holds the sum of value
// p + (16 / CG) cg.  log2(CG) rounds, 15 shuffles at CG = 16; each sum is
// taken in the same order every call.
template <int CG>
__device__ __forceinline__ void reduce_scatter16(float (&x)[16], int cg) {
  static_assert(CG >= 2 && CG <= 16 && (CG & (CG - 1)) == 0,
                "a row group spans 2 .. 16 lanes");
#pragma unroll
  for (int s = 0; (1 << s) < CG; ++s) {
    const int o = CG >> (s + 1), m = 8 >> s;
    const bool up = (cg & o) != 0;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = up ? x[i] : x[i + m];
      const float keep = up ? x[i + m] : x[i];
      x[i] = keep + __shfl_xor_sync(~0u, send, o);
    }
  }
}

template <int HDP, bool kBI, bool kBW>
__global__ void __launch_bounds__(bwd_threads<HDP>(), 1)
rwkv_scan_bwd_kernel(const BwdArgs a) {
  using TI = typename std::conditional<kBI, bf16, float>::type;
  using TW = typename std::conditional<kBW, bf16, float>::type;
  constexpr int NC = bwd_cols<HDP>(), CG = HDP / NC, RG = HDP / kRows;
  constexpr int NT = RG * CG, NW = NT / 32;
  constexpr int PER = 16 / CG;               // row sums a lane keeps
  static_assert(NT % 32 == 0 && 32 % CG == 0 && NC % 2 == 0,
                "a warp holds whole row groups");
  extern __shared__ __align__(16) float smem[];
  float4* states = reinterpret_cast<float4*>(smem);
  float* xs = smem + kCk * HDP * HDP;        // [5][kCk][HDP]
  float* rows = xs + 5 * kCk * HDP;          // [3][kCk][HDP]
  float* cols = rows + 3 * kCk * HDP;        // [kCk][NW][HDP]
  float* sc = cols + kCk * NW * HDP;         // beta [kCk], v . dout [kCk]
  float* us = sc + 2 * kCk;                  // [HDP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % CG, rg = tid / CG;
  const int r0 = rg * kRows, c0 = cg * NC;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hd = a.hd, T = a.T;
  const int n_ck = (T + kCk - 1) / kCk;
  const size_t sq = static_cast<size_t>(bh) * hd * hd;

  // r, k, v, w and dout at (b, h, t = 0, 0), and the gradients.
  const void* src[5];
  void* dst[4];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const bool w16 = i == 3 ? kBW : kBI;
    const long long off = i == 4 ? b * a.ds[0] + h * a.ds[1]
                                 : b * a.is[0] + h * a.is[1];
    const void* base = i == 4 ? a.dout : a.in[i];
    src[i] = static_cast<const char*>(base) + off * (w16 ? 2 : 4);
    if (i < 4)
      dst[i] = static_cast<char*>(a.grad[i]) +
               (b * a.gs[0] + h * a.gs[1]) * (w16 ? 2 : 4);
  }
  for (int i = tid; i < HDP; i += NT) us[i] = i < hd ? a.u[h * hd + i] : 0.0f;

  // G, the gradient of the state after the step at hand: dstate_T first.
  float G[kRows][NC];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int row = r0 + j, col = c0 + n;
      G[j][n] = (a.dsT != nullptr && row < hd && col < hd)
                    ? a.dsT[sq + static_cast<size_t>(row) * hd + col]
                    : 0.0f;
    }
  float du = 0.0f;                           // du[tid], for tid < hd

  // A chunk's rows of the five arrays, widened to float32 (zeros past hd
  // and past T), LOADS values a thread: value m of thread tid is xs[m NT +
  // tid].  They are fetched into registers one chunk ahead, so a chunk's
  // loads are in flight while the chunk before it is computed.
  constexpr int PER_ARR = kCk * HDP;
  constexpr int LOADS = 5 * PER_ARR / NT;
  static_assert(PER_ARR % NT == 0, "a thread's values of a chunk lie in "
                                   "known arrays");
  float pre[LOADS];
  auto fetch = [&](int ch) {
    const int t0 = ch * kCk, n = min(kCk, T - t0);
#pragma unroll
    for (int m = 0; m < LOADS; ++m) {
      const int arr = m * NT / PER_ARR;
      const int e = (m * NT) % PER_ARR + tid;
      const int tt = e / HDP, col = e % HDP;
      float x = 0.0f;
      if (tt < n && col < hd) {
        const long long off =
            static_cast<long long>(t0 + tt) * (arr == 4 ? a.ds[2] : a.is[2]) +
            col;
        x = arr == 3 ? load_wide<TW>(src[3], off)
                     : load_wide<TI>(src[arr], off);
      }
      pre[m] = x;
    }
  };
  if (n_ck > 0) fetch(n_ck - 1);

  for (int ch = n_ck - 1; ch >= 0; --ch) {
    const int t0 = ch * kCk, n = min(kCk, T - t0);
    __syncthreads();                         // the last chunk's reads done
#pragma unroll
    for (int m = 0; m < LOADS; ++m) xs[m * NT + tid] = pre[m];
    __syncthreads();
    if (ch > 0) fetch(ch - 1);
    const float* R = xs;
    const float* K = xs + kCk * HDP;
    const float* V = K + kCk * HDP;
    const float* W = V + kCk * HDP;
    const float* D = W + kCk * HDP;
    // beta_t = sum_k r_k u_k k_k and v_t . dout_t, a warp a step.
    for (int tt = warp; tt < n; tt += NW) {
      float bs = 0.0f, vd = 0.0f;
      for (int i = lane; i < HDP; i += 32) {
        bs = fmaf(R[tt * HDP + i] * us[i], K[tt * HDP + i], bs);
        vd = fmaf(V[tt * HDP + i], D[tt * HDP + i], vd);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        bs += __shfl_xor_sync(~0u, bs, o);
        vd += __shfl_xor_sync(~0u, vd, o);
      }
      if (lane == 0) {
        sc[tt] = bs;
        sc[kCk + tt] = vd;
      }
    }
    // The chunk's states S_{t-1}, the thread's tile of each, recomputed
    // from the checkpoint as the forward computed them (the same bits).
    {
      float S[kRows][NC];
      const float* ck = a.ck + (static_cast<size_t>(bh) * n_ck + ch) * hd * hd;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int row = r0 + j, col = c0 + m;
          S[j][m] = (row < hd && col < hd)
                        ? ck[static_cast<size_t>(row) * hd + col]
                        : 0.0f;
        }
      for (int tt = 0; tt < n; ++tt) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int f = 4 * q;               // flat index f .. f + 3
          states[(tt * NC + q) * NT + tid] = make_float4(
              S[f / NC][f % NC], S[(f + 1) / NC][(f + 1) % NC],
              S[(f + 2) / NC][(f + 2) % NC], S[(f + 3) / NC][(f + 3) % NC]);
        }
        if (tt + 1 < n) {
          const float4 k4 = reinterpret_cast<const float4*>(K + tt * HDP)[rg];
          const float4 w4 = reinterpret_cast<const float4*>(W + tt * HDP)[rg];
          const float kk[kRows] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[kRows] = {w4.x, w4.y, w4.z, w4.w};
          float vv[NC];
          load_cols<NC>(V + tt * HDP + c0, vv);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
#pragma unroll
            for (int m = 0; m < NC; ++m) {
              const float kv = kk[j] * vv[m];
              S[j][m] = fmaf(ww[j], S[j][m], kv);
            }
        }
      }
    }
    __syncthreads();                         // beta and v . dout visible
    for (int tt = n - 1; tt >= 0; --tt) {
      const float4 r4 = reinterpret_cast<const float4*>(R + tt * HDP)[rg];
      const float4 k4 = reinterpret_cast<const float4*>(K + tt * HDP)[rg];
      const float4 w4 = reinterpret_cast<const float4*>(W + tt * HDP)[rg];
      const float rr[kRows] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[kRows] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[kRows] = {w4.x, w4.y, w4.z, w4.w};
      float vv[NC], dd[NC], S[kRows][NC];
      load_cols<NC>(V + tt * HDP + c0, vv);
      load_cols<NC>(D + tt * HDP + c0, dd);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float4 x = states[(tt * NC + q) * NT + tid];
        const int f = 4 * q;
        S[f / NC][f % NC] = x.x;
        S[(f + 1) / NC][(f + 1) % NC] = x.y;
        S[(f + 2) / NC][(f + 2) % NC] = x.z;
        S[(f + 3) / NC][(f + 3) % NC] = x.w;
      }
      // Row sums over the thread's columns: x[4 q + j] for row j of G v
      // (q 0), G . S_{t-1} (q 1) and S_{t-1} dout (q 2); q 3 is padding.
      float x[16], dv[NC];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float gv = 0.0f, gs = 0.0f, sd = 0.0f;
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          gv = fmaf(G[j][m], vv[m], gv);
          gs = fmaf(G[j][m], S[j][m], gs);
          sd = fmaf(S[j][m], dd[m], sd);
        }
        x[j] = gv;
        x[4 + j] = gs;
        x[8 + j] = sd;
        x[12 + j] = 0.0f;
      }
      // Column sums over the thread's rows: G^T k.
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc = fmaf(G[j][m], kk[j], acc);
        dv[m] = acc;
      }
      // G_{t-1} = diag(w_t) G_t + r_t dout_t^T.
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int m = 0; m < NC; ++m) G[j][m] = fmaf(ww[j], G[j][m], rr[j] * dd[m]);
      reduce_scatter16<CG>(x, cg);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = p + PER * cg, q = idx >> 2;
        if (q < 3) rows[(q * kCk + tt) * HDP + r0 + (idx & 3)] = x[p];
      }
      // The warp's row groups' column sums, then one lane a column group
      // writes them.
#pragma unroll
      for (int m = 0; m < NC; ++m)
#pragma unroll
        for (int o = CG; o < 32; o <<= 1)
          dv[m] += __shfl_xor_sync(~0u, dv[m], o);
      if (lane < CG) store_cols<NC>(cols + (tt * NW + warp) * HDP + c0, dv);
    }
    __syncthreads();
    // The chunk's gradients: the row and column sums and the bonus terms.
    for (int i = tid; i < n * HDP; i += NT) {
      const int tt = i / HDP, c = i % HDP;
      if (c >= hd) continue;
      const float beta = sc[tt], vd = sc[kCk + tt];
      float dv = 0.0f;
#pragma unroll
      for (int g = 0; g < NW; ++g) dv += cols[(tt * NW + g) * HDP + c];
      const float grads[4] = {
          fmaf(us[c] * K[i], vd, rows[(2 * kCk + tt) * HDP + c]),   // dr
          fmaf(us[c] * R[i], vd, rows[tt * HDP + c]),               // dk
          fmaf(D[i], beta, dv),                                     // dv
          rows[(kCk + tt) * HDP + c]};                              // dw
      const long long off = static_cast<long long>(t0 + tt) * a.gs[2] + c;
#pragma unroll
      for (int g = 0; g < 3; ++g) narrow(static_cast<TI*>(dst[g]) + off, grads[g]);
      narrow(static_cast<TW*>(dst[3]) + off, grads[3]);
    }
    // du[k] += r_t,k k_t,k (v_t . dout_t), steps in descending order.
    if (tid < hd)
      for (int tt = n - 1; tt >= 0; --tt)
        du = fmaf(R[tt * HDP + tid] * K[tt * HDP + tid], sc[kCk + tt], du);
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int row = r0 + j, col = c0 + m;
      if (row < hd && col < hd)
        a.ds0[sq + static_cast<size_t>(row) * hd + col] = G[j][m];
    }
  if (tid < hd) a.du[static_cast<size_t>(bh) * hd + tid] = du;
}

// Makes `device` current if it is not (the stream belongs to it).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// Sets a kernel's shared-memory opt-in (once a device and kernel: each
// instantiation of a caller has its own `allowed`).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool (&allowed)[64],
                       int device) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

template <int HDP, bool kBI, bool kBW>
cudaError_t launch_bwd(const BwdArgs& a, int B, int device,
                       cudaStream_t stream) {
  auto kernel = rwkv_scan_bwd_kernel<HDP, kBI, kBW>;
  constexpr size_t smem = bwd_smem_bytes<HDP>();
  static bool allowed[64];
  cudaError_t err = allow_smem(kernel, smem, allowed, device);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.H, bwd_threads<HDP>(), smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBI, bool kBW>
cudaError_t dispatch_bwd(const BwdArgs& a, int B, int device,
                         cudaStream_t s) {
  if (a.hd <= 16) return launch_bwd<16, kBI, kBW>(a, B, device, s);
  if (a.hd <= 32) return launch_bwd<32, kBI, kBW>(a, B, device, s);
  return launch_bwd<64, kBI, kBW>(a, B, device, s);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Steps between the forward's checkpoints (the backward's chunk).
int repro_rwkv_checkpoint_every(void) { return kCk; }

// The backward: from r, k, v, w (as the forward takes them, strides `sb,
// sh, st`), u, the forward's checkpoints `ckpt`, dout (r's type, strides
// `db, dh, dt`, hd's 1) and dstate (the final state's gradient, float32
// [B, H, hd, hd] contiguous, or null: zeros), writes dr, dk, dv (r's type)
// and dw (w's type) at strides `gb, gh, gt` (hd's 1), du_part float32
// [B, H, hd] (each (b, h)'s share of du; the caller sums over B) and
// dstate0 float32 [B, H, hd, hd].  Same `kinds` and limits as the forward.
// Returns a cudaError_t (0 on success); one launch, asynchronous on
// `stream`.
int repro_rwkv_scan_bwd(const void* r, const void* k, const void* v,
                        const void* w, const float* u, const float* ckpt,
                        const void* dout, const float* dstate, void* dr,
                        void* dk, void* dv, void* dw, float* du_part,
                        float* dstate0, int B, int H, int T_len, int hd,
                        int kinds, long long sb, long long sh, long long st,
                        long long db, long long dh, long long dt,
                        long long gb, long long gh, long long gt, int device,
                        void* stream) {
  if (B < 1 || H < 1 || T_len < 0 || hd < 1 || hd > 64 || kinds < 0 ||
      kinds > 2 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  BwdArgs a{};
  a.in[0] = r;
  a.in[1] = k;
  a.in[2] = v;
  a.in[3] = w;
  a.dout = dout;
  a.u = u;
  a.ck = ckpt;
  a.dsT = dstate;
  a.grad[0] = dr;
  a.grad[1] = dk;
  a.grad[2] = dv;
  a.grad[3] = dw;
  a.du = du_part;
  a.ds0 = dstate0;
  a.H = H;
  a.T = T_len;
  a.hd = hd;
  a.is[0] = sb;
  a.is[1] = sh;
  a.is[2] = st;
  a.ds[0] = db;
  a.ds[1] = dh;
  a.ds[2] = dt;
  a.gs[0] = gb;
  a.gs[1] = gh;
  a.gs[2] = gt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kinds == 0) return dispatch_bwd<false, false>(a, B, device, s);
  if (kinds == 1) return dispatch_bwd<true, false>(a, B, device, s);
  return dispatch_bwd<true, true>(a, B, device, s);
}

}  // extern "C"
