// RWKV6 recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rwkv_scan.py
// (wrapper rwkv_scan :40, kernel _rwkv_kernel :22, pallas_call :61), the
// recurrence that repro/models/ssm.py::rwkv6_apply runs with lax.scan
// (ssm.py:99-110).  Per (b, h), over t = 0 .. T-1, with S the [hd, hd]
// float32 state:
//   out_t = r_t (S + diag(u) k_t v_t^T)
//   S     = diag(w_t) S + k_t v_t^T
// r, k, v, w [B, H, T, hd] (any strides, hd's 1; the four alike in
// elements), u [H, hd], state0 [B, H, hd, hd] (zeros when null), out
// [B, H, T, hd] (any strides, hd's 1) and the final state [B, H, hd, hd].
// Types, as the Pallas kernel takes them: r, k and v float32 or bf16, all
// three alike; w float32 or r's type; u, state0 and the final state
// float32; out in r's type.  Each value is widened to float32 as it is
// read (exact for bf16), the arithmetic is float32, and a bf16 out is
// rounded once to nearest even, as .to(torch.bfloat16) rounds.  The model
// passes its bf16 r, k and v and float32 w as views of its [B, T, H hd]
// activations and gets out in that layout and type, so no cast and no copy
// goes in or out.
//
// Bound on an H100 (NVIDIA H100 SXM data sheet): the function needs about
// 4 hd^2 float32 operations per step of each (b, h): r_t S, a multiply-add
// per state entry, and the decayed update, which a chunked form does as one
// multiply-add per entry on a state rescaled by the chunk's decay; the
// bonus r_t diag(u) k_t v_t^T is (sum_k r_k u_k k_k) v_t, O(hd).  Those at
// 67 TFLOP/s on the CUDA cores, against r, k, v, w and out moved once (2
// bytes a value for bf16) and the two states at 3.35 TB/s.  At the serve's
// prefill (B 4, H 32, T ~ 445, hd 64) the bytes set it, ~0.023 ms in
// float32 (~0.015 ms with the model's bf16 r, k, v and out); a decode step
// (T = 1) is the 4 MB of state in and out, ~1.3 us.  The recurrence is
// sequential in t, so a kernel that walks t one step at a time is bound
// by what one step costs an SM.
//
// Design.  The TPU kernel keeps the state in VMEM for the whole sequence,
// one grid step per (b, h).  Here one block owns one (b, h) (grid B H) and
// keeps the state in registers for the whole T loop, where HDP is hd
// rounded up to 16, 32 or 64 (the padding rows and columns hold zeros and
// stay zero).  A step costs each state entry one multiply (k_k v_c), one
// multiply-add into out (r_k S[k][c]) and one for the update (w_k S[k][c]
// + k_k v_c).  The first design (one column and 16 rows a thread, kept as
// csrc/variants/rwkv_scan_scalar.cu) took the bonus as a multiply-add on
// every entry, read 196 bytes of shared memory a thread a step as 49
// scalar broadcasts (~400 cycles a step for the SM's 256 threads at the
// 128 bytes a cycle that shared memory hands to registers; a float4
// broadcast costs what four scalar ones do), and stopped every warp at
// each chunk's staging and partial sums.  This one:
//   * A compute thread holds a 4 x NC tile of the state (rows r0 .. r0 +
//     3, NC = 4 columns; 2 at hd 16): a step reads one float4 each of r_t,
//     k_t and w_t for its rows and NC floats of v_t, 64 bytes for 16
//     entries, and writes its NC partial sums of out_t (256 compute
//     threads at hd 64).  A step's loads go out before the previous
//     step's arithmetic.
//   * The bonus is one dot product a step, not a multiply-add per entry:
//     beta_t = sum_k r_t,k u_k k_t,k, taken for a chunk of kTC steps at
//     once, sixteen threads a step; the threads of row group 0 start
//     out_t[c]'s sum at beta_t v_t[c].
//   * kHelpers helper threads (four warps) do everything else while the
//     compute threads run the recurrence, ordered by named barriers (the
//     compute threads wait at kFull for a chunk, the helpers at kDone for
//     its partial sums): they copy chunk ch + kStages's rows into a ring
//     of kStages chunk buffers by cp.async once chunk ch is computed (no
//     register round trip; 16-byte copies, element copies where a row is
//     not 16-byte aligned), ready chunk ch + kAhead (bf16 rows land as
//     bf16, half the bytes, and are widened once into the float32
//     buffers; its bonus dot products), and add chunk ch's HDP / 4
//     row-group partial sums of out_t as a tree (two buffers) and write
//     out.
// kCols, kHelpers, kStages, kTC and the unroll were chosen by measurement
// (kernel_variants.py k6; PERF.md).  What is left: a step takes ~0.15 us
// at hd 64, about twice its issue time (what stalls it is not measured).
// No tensor cores: the chunked form that would put the intra-chunk
// products on them is later work.
//
// The backward (rwkv_scan_bwd_kernel) replaces no TPU kernel: the JAX
// package differentiates the lax.scan of ssm.py:99-110 (its Pallas kernel
// has no vjp).  With G_t the gradient of the state after step t (G_{T-1}
// = dstate_T, zeros when null), beta_t = sum_k r_t,k u_k k_t,k and
// vd_t = v_t . dout_t, per (b, h), for t = T-1 down to 0:
//   dr_t = S_{t-1} dout_t + u * k_t vd_t       dk_t = G_t v_t + u * r_t vd_t
//   dv_t = G_t^T k_t + dout_t beta_t           dw_t[k] = sum_c G_t S_{t-1}
//   du  += r_t * k_t vd_t                      G_{t-1} = diag(w_t) G_t +
//                                                        r_t dout_t^T
// and dstate0 = G_{-1}.  Types: dr, dk and dv in r's type, dw in w's, each
// rounded once from float32; du and dstate0 float32.
//
// Bound on an H100: about 12 hd^2 float32 operations a step of each (b, h)
// (a multiply-add per state entry for each of G's update, dk, dv, dw, dr
// and the recomputed state) at 67 TFLOP/s, against r, k, v, w and dout
// read once, dr, dk, dv and dw written once and the checkpoints read once
// at 3.35 TB/s.  At the RWKV6-1.6B training shape (B 4, H 32, T 512, hd
// 64, bf16 r, k, v and dout, float32 w) the bytes set it, ~0.068 ms, of
// which the checkpoints (134 MB) are 0.040 ms; the operations ~0.048 ms.
//
// Design of the backward (the second; the first, one block a (b, h), is
// csrc/variants/rwkv_scan_bwd_first.cu, and this one gives its bits).
// dr_t and dw_t need S_{t-1} while G runs backwards, and S_{t-1} is never
// had by dividing by w_t (w = exp(-exp(.)) may come near 0 once trained):
// the forward, asked with a checkpoint buffer, writes its state before
// every kCk-th step (float32 [B, H, ceil(T / kCk), hd, hd]; 134 MB a layer
// at the training shape, and under remat one layer holds it at a time; a
// null buffer runs the forward's kernel as it was, the same bits).  Every
// entry of G evolves on its own (G_{t-1}[k][c] = w_t[k] G_t[k][c] +
// r_t[k] dout_t[c]), as does every entry of S, so the state splits by
// rows: a cluster of HDP / KB blocks shares a (b, h), each block owning a
// band of KB = 32 rows of G and of the states (hd 16: one band of 16), and
// two blocks share an SM (B 4 x 32 heads at hd 64: 256 blocks, one wave;
// B 1: 64 blocks, where one block a (b, h) took 32 of the 132 SMs; bands
// of 16 rows, four blocks a (b, h), measured slower at B 1 and B 4).
// A block: compute warps holding the first design's tiles (kRows x NC a
// thread, 128 threads at hd 64) and two helper warps.  Per chunk of kCk =
// 8 steps, last chunk first:
//   * the first helper warp stages the chunk's rows (r, k, v and dout
//     whole, w's band) as they are in memory by bulk copies a row into a
//     ring of NS slots, NS chunks ahead, completed on the slot's mbarrier
//     (element copies where a row is not 16-byte aligned); both take
//     beta_t and v_t . dout_t, a butterfly of shuffles a step, the steps'
//     butterflies sharing their rounds;
//   * the compute threads recompute the chunk's states from its checkpoint
//     with the forward's arithmetic (the same bits) into shared memory, a
//     thread its own tile, the tile fetched NCK chunks ahead by
//     asynchronous copies; then walk the chunk down.  A step's row sums of
//     G v, G . S and S dout (over the thread's columns) cross the row
//     group's lanes through a per-warp exchange in shared memory, each
//     lane adding one sum's 16 terms in the butterfly order of the first
//     design's reduce-scatter of shuffles (15 shuffles a step there, most
//     of its step: kernel_variants.py k6bwd, PERF.md) -- complete in the
//     band, so dr, dk, dw and du need no other block; the column sums G^T
//     k go across the warp's row groups by shuffles, one partial a warp,
//     which the lane stores with st.async into the shared memory of the
//     block that owns those columns, as the row sums go to its own; then
//     G = diag(w) G + r dout^T;
//   * the helper warps of each block wait on that block's pushed barrier,
//     whose transactions count the chunk's row sums and the cluster's
//     partials of the band's columns, add the NWG warps' partials in warp
//     order (the first design's order), add the bonus terms, release the
//     buffers to every block of the cluster by remote arrivals on their
//     freed barriers (so a compute warp runs up to NP chunks ahead) and
//     write dr, dk, dv and dw in the inputs' layout, and walk du.
// Every sum is taken in the first design's order, so the outputs are its
// bits.  No cluster barrier in the loop: the release of a cluster barrier
// fences all of a thread's memory traffic, and its wait invalidates L1.
// du goes out as each (b, h)'s partial sum [B, H, hd], summed over t in
// one order in the band and over B by the caller: no atomics, so two runs
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTC = 16;        // steps a chunk
constexpr int kStages = 4;     // chunk buffers in the ring
constexpr int kAhead = 2;      // a chunk is readied this many chunks ahead
constexpr int kRows = 4;       // state rows a thread holds (a float4)
constexpr int kCols = 4;       // state columns a thread holds above hd 16
static_assert(kStages > kAhead, "the ring must hold the readied chunks");
// Named barriers (0 is __syncthreads'): the helper threads arrive at
// kFull when a chunk is ready to compute, the compute threads at kDone when
// they have computed one; kHelp orders the helpers among themselves.
enum : int { kFull = 1, kDone = 2, kHelp = 3 };
constexpr int kHelpers = 128;  // helper threads a block (four warps)
// Steps between the checkpoints of the state the forward writes for the
// backward (its state before steps 0, kCk, 2 kCk, ..), and the backward's
// chunk: it holds a chunk's kCk states in shared memory.
constexpr int kCk = 8;
static_assert(kTC % kCk == 0, "a chunk holds whole checkpoint intervals");

// Columns a thread holds, and compute threads a block (one a kRows x cols
// tile of the state): 256 at hd 64, 64 at 32, 32 at 16; kHelpers more.
template <int HDP>
constexpr int cols() {
  return HDP == 16 ? 2 : kCols;
}
template <int HDP>
constexpr int threads() {
  return (HDP / kRows) * (HDP / cols<HDP>());
}

// Element types: r, k, v and out are TI, w is TW.
template <bool kBI, bool kBW>
struct Types {
  static_assert(kBI || !kBW, "w is float32 or r's type");
  static constexpr int kLanded = (kBI ? 3 : 0) + (kBW ? 1 : 0);
};

// Shared memory, in order: the float32 ring [kStages][4][kTC][HDP] (r, k,
// v, w), the bonus ring [kStages][kTC], the partial sums [2][kTC][RG][HDP]
// (RG = HDP / kRows row groups) and the bf16 landing ring
// [kStages][kLanded][kTC][HDP]: 216 KB at hd 64 with the model's types.
template <int HDP, bool kBI, bool kBW>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kStages * 4 * kTC * HDP + kStages * kTC +
                          2 * kTC * (HDP / kRows) * HDP) +
         sizeof(bf16) * kStages * Types<kBI, kBW>::kLanded * kTC * HDP;
}

struct Args {
  const void* in[4];           // r, k, v, w
  const float* u;              // [H, hd]
  const float* s0;             // [B, H, hd, hd] or null
  void* out;
  float* sT;
  float* ck;                   // [B, H, ceil(T / kCk), hd, hd] or null
  int H, T, hd;
  bool vec;                    // rows 16-byte aligned: cp.async 16 bytes
  long long is[3], os[3];      // (b, h, t) strides of the inputs and out
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

template <int HDP, bool kBI, bool kBW>
struct Kernel {
  static constexpr int RG = HDP / kRows;     // row groups
  static constexpr int NC = cols<HDP>();     // columns a thread holds
  static constexpr int CG = HDP / NC;        // column groups
  static constexpr int NT = RG * CG;         // threads a block
  static constexpr int SLOT = 4 * kTC * HDP; // floats of a ring buffer
  static constexpr int PART = kTC * RG * HDP;
  static constexpr int LANDED = Types<kBI, kBW>::kLanded;
  static_assert(kRows == 4 && NT % 32 == 0 && NC % 2 == 0,
                "rows are read as a float4, columns as float2s, and the "
                "bonus takes whole warps");

  float* ring;                 // [kStages][4][kTC][HDP]
  float* beta;                 // [kStages][kTC]
  float* part;                 // [2][kTC][RG][HDP]
  bf16* land;                  // [kStages][LANDED][kTC][HDP]
  const char* seq[4];          // r, k, v, w at (b, h, t = 0, 0)
  int hid;                     // the helper thread's index, 0 ..

  // Where array a of chunk slot s lands: its bf16 buffer or, for a float32
  // array, the float32 ring itself.
  __device__ __forceinline__ void* landing(int a, int s) const {
    const bool lands = a < 3 ? kBI : kBW;
    if (!lands) return ring + s * SLOT + a * kTC * HDP;
    const int la = a < 3 ? a : LANDED - 1;
    return land + (s * LANDED + la) * kTC * HDP;
  }

  // Starts the copies of chunk ch into its slot and commits them as one
  // group (an empty group past the end, so the count of groups stays one a
  // chunk).  Rows past T and columns past hd are zero-filled.
  __device__ void issue(const Args& a, int ch) const {
    const int t0 = ch * kTC;
    if (t0 < a.T) {
      const int steps = min(kTC, a.T - t0);
      const int s = ch % kStages;
#pragma unroll
      for (int arr = 0; arr < 4; ++arr) {
        const bool b16 = arr < 3 ? kBI : kBW;
        const int es = b16 ? 2 : 4;
        char* dst = static_cast<char*>(landing(arr, s));
        const char* src = seq[arr] + t0 * a.is[2] * es;
        if (a.vec) {
          const int per = 16 / es;           // elements a copy
          const int row = HDP / per;         // copies a row
          for (int i = hid; i < kTC * row; i += kHelpers) {
            const int tt = i / row, col = (i % row) * per;
            const bool in = tt < steps && col < a.hd;
            cp_async16(dst + (tt * HDP + col) * es,
                       in ? src + (tt * a.is[2] + col) * es : seq[arr],
                       in ? 16 : 0);
          }
        } else {
          for (int i = hid; i < kTC * HDP; i += kHelpers) {
            const int tt = i / HDP, col = i % HDP;
            const bool in = tt < steps && col < a.hd;
            const long long off = tt * a.is[2] + col;
            if (b16)
              reinterpret_cast<bf16*>(dst)[i] =
                  in ? reinterpret_cast<const bf16*>(src)[off]
                     : __float2bfloat16_rn(0.0f);
            else
              reinterpret_cast<float*>(dst)[i] =
                  in ? reinterpret_cast<const float*>(src)[off] : 0.0f;
          }
        }
      }
    }
    cp_async_commit();
  }

  // Readies chunk ch (landed, and visible to the block): widens its bf16
  // rows into the float32 ring and takes its bonus dot products
  // beta_t = sum_k r_k u_k k_k, sixteen threads a step (thread part p
  // takes rows p HDP / 16 ..), from the rows as they landed.
  __device__ void ready(const Args& a, int ch,
                        const float (&uu)[HDP / 16]) const {
    if (ch * kTC >= a.T) return;
    const int s = ch % kStages;
    float* slot = ring + s * SLOT;
    if constexpr (LANDED > 0) {
      constexpr int V8 = kTC * HDP / 8;      // 8 values a 16-byte load
      for (int i = hid; i < LANDED * V8; i += kHelpers) {
        const int la = i / V8, j = (i % V8) * 8;
        const int arr = la < (kBI ? 3 : 0) ? la : 3;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            land + (s * LANDED + la) * kTC * HDP + j);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        float4* d = reinterpret_cast<float4*>(slot + arr * kTC * HDP + j);
        const float2 f0 = __bfloat1622float2(h2[0]);
        const float2 f1 = __bfloat1622float2(h2[1]);
        const float2 f2 = __bfloat1622float2(h2[2]);
        const float2 f3 = __bfloat1622float2(h2[3]);
        d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
    using TI = typename std::conditional<kBI, bf16, float>::type;
    const TI* R = static_cast<const TI*>(landing(0, s));
    const TI* K = static_cast<const TI*>(landing(1, s));
    constexpr int PER = HDP / 16;
    // Whole warps take (step, part) pairs, so the shuffles see 32 lanes.
    for (int w0 = hid & ~31; w0 < kTC * 16; w0 += kHelpers) {
      const int tt = (w0 + (hid & 31)) >> 4, p = hid & 15;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int kk = p * PER + m;
        acc = fmaf(widen(R[tt * HDP + kk]) * uu[m], widen(K[tt * HDP + kk]),
                   acc);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
      if (p == 0) beta[s * kTC + tt] = acc;
    }
  }

  // out[t0 + tt][col .. col + 3] of chunk ch (its partial sums written):
  // the row groups' partial sums, added as a tree (log2 RG roundings).
  template <typename TO>
  __device__ void reduce(const Args& a, int ch, TO* out) const {
    const float* P = part + (ch & 1) * PART;
    const int t0 = ch * kTC, steps = min(kTC, a.T - t0);
    for (int i = hid; i < kTC * HDP / 4; i += kHelpers) {
      const int tt = i / (HDP / 4), col = (i % (HDP / 4)) * 4;
      if (tt < steps && col < a.hd) {
        float4 p[RG];
#pragma unroll
        for (int g = 0; g < RG; ++g)
          p[g] = reinterpret_cast<const float4*>(P + (tt * RG + g) * HDP +
                                                 col)[0];
#pragma unroll
        for (int span = 1; span < RG; span *= 2)
#pragma unroll
          for (int g = 0; g + span < RG; g += 2 * span) {
            p[g].x += p[g + span].x;
            p[g].y += p[g + span].y;
            p[g].z += p[g + span].z;
            p[g].w += p[g + span].w;
          }
        const float o[4] = {p[0].x, p[0].y, p[0].z, p[0].w};
        TO* row = out + (t0 + tt) * a.os[2] + col;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (col + m < a.hd) narrow(row + m, o[m]);
      }
    }
  }
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A thread's NC floats of v_t or of its partial sums of out_t, as float2s
// (8-byte aligned; as float4s, or folded over a warp's row groups by
// shuffles, the loop ran slower: kernel_variants.py k6, PERF.md).
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

// A thread's kRows x NC tile of a state, rows r0 .., columns c0 .., into
// the [hd, hd] state at dst (the padding rows and columns stay out).
template <int NC>
__device__ __forceinline__ void store_tile(float* dst,
                                           const float (&S)[kRows][NC],
                                           int r0, int c0, int hd) {
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (r0 + j < hd && c0 + n < hd)
        dst[static_cast<size_t>(r0 + j) * hd + c0 + n] = S[j][n];
}

template <int HDP, bool kBI, bool kBW, bool kCkpt>
__global__ void __launch_bounds__(threads<HDP>() + kHelpers, 1)
rwkv_scan_kernel(const Args a) {
  using KS = Kernel<HDP, kBI, kBW>;
  using TO = typename std::conditional<kBI, bf16, float>::type;
  constexpr int RG = KS::RG, NC = KS::NC, CG = KS::CG, NT = KS::NT;
  constexpr int ALL = NT + kHelpers;         // compute and helper threads
  extern __shared__ __align__(16) float smem[];
  KS ks;
  ks.ring = smem;
  ks.beta = ks.ring + kStages * KS::SLOT;
  ks.part = ks.beta + kStages * kTC;
  ks.land = reinterpret_cast<bf16*>(ks.part + 2 * KS::PART);
  ks.hid = threadIdx.x - NT;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int hd = a.hd;
  const int n_chunks = (a.T + kTC - 1) / kTC;

  if (threadIdx.x >= NT) {
    // The helper threads: copy, ready and reduce while the compute
    // threads run the recurrence.  Chunk ch is readied kAhead chunks
    // ahead; the copies of chunk ch + kStages go into its slot once it
    // is computed.
#pragma unroll
    for (int arr = 0; arr < 4; ++arr) {
      const int es = (arr < 3 ? kBI : kBW) ? 2 : 4;
      ks.seq[arr] = static_cast<const char*>(a.in[arr]) +
                    (b * a.is[0] + h * a.is[1]) * es;
    }
    // u for this thread's part of the bonus dot products.
    float uu[HDP / 16];
#pragma unroll
    for (int m = 0; m < HDP / 16; ++m) {
      const int kk = (ks.hid & 15) * (HDP / 16) + m;
      uu[m] = kk < hd ? a.u[h * hd + kk] : 0.0f;
    }
    TO* out = static_cast<TO*>(a.out) + b * a.os[0] + h * a.os[1];
    for (int ch = 0; ch < kStages; ++ch) ks.issue(a, ch);
    cp_async_wait<kStages - kAhead>();       // chunks 0 .. kAhead-1 landed
    bar_sync(kHelp, kHelpers);
    for (int ch = 0; ch < kAhead; ++ch) ks.ready(a, ch, uu);
    if (n_chunks > 0) bar_arrive(kFull, ALL);
    for (int ch = 0; ch < n_chunks; ++ch) {
      bar_sync(kDone, ALL);                  // chunk ch computed
      // Chunk ch + 1 was readied, and its partial-sum buffer reduced, in
      // the turn before.
      if (ch + 1 < n_chunks) bar_arrive(kFull, ALL);
      ks.reduce(a, ch, out);
      ks.issue(a, ch + kStages);
      cp_async_wait<kStages - kAhead>();     // chunks .. ch + kAhead landed
      bar_sync(kHelp, kHelpers);
      ks.ready(a, ch + kAhead, uu);
    }
    return;
  }

  // Compute thread (row group rg, column group cg) holds S[r0 .. r0 +
  // 3][c0 .. c0 + NC - 1]; a warp spans 32 / CG row groups and all
  // columns.
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int r0 = rg * kRows, c0 = cg * NC;
  const size_t st = static_cast<size_t>(bh) * hd * hd;
  float* const ck =
      kCkpt ? a.ck + st * ((a.T + kCk - 1) / kCk) : nullptr;
  float S[kRows][NC];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int row = r0 + j, col = c0 + n;
      S[j][n] = (a.s0 != nullptr && row < hd && col < hd)
                    ? a.s0[st + static_cast<size_t>(row) * hd + col]
                    : 0.0f;
    }

  for (int ch = 0; ch < n_chunks; ++ch) {
    bar_sync(kFull, ALL);                    // chunk ch ready, its buffer
                                             // of partial sums free
    const int s = ch % kStages;
    const float* R = ks.ring + s * KS::SLOT;
    const float* K = R + kTC * HDP;
    const float* V = K + kTC * HDP;
    const float* W = V + kTC * HDP;
    const float* beta = ks.beta + s * kTC;
    float* P = ks.part + (ch & 1) * KS::PART;
    const int steps = min(kTC, a.T - ch * kTC);
    // Step tt's rows are in registers when it starts; step tt + 1's loads
    // go out before step tt's arithmetic, so the shared-memory pipe and
    // the multiply-adds overlap within a warp and not only across warps.
    float4 r4, k4, w4;
    float vv[NC], bt;
    auto load = [&](int tt) {
      r4 = reinterpret_cast<const float4*>(R + tt * HDP)[rg];
      k4 = reinterpret_cast<const float4*>(K + tt * HDP)[rg];
      w4 = reinterpret_cast<const float4*>(W + tt * HDP)[rg];
      load_cols<NC>(V + tt * HDP + c0, vv);
      // Row group 0 starts out_t[c] at the bonus beta_t v_t[c].
      bt = rg == 0 ? beta[tt] : 0.0f;
    };
    load(0);
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      if constexpr (kCkpt) {
        // The state before step t0 + tt, every kCk steps, for the backward.
        if (tt % kCk == 0)
          store_tile<NC>(ck + static_cast<size_t>((ch * kTC + tt) / kCk) *
                                  hd * hd,
                         S, r0, c0, hd);
      }
      const float rr[kRows] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[kRows] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[kRows] = {w4.x, w4.y, w4.z, w4.w};
      float vn[NC], acc[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        vn[n] = vv[n];
        acc[n] = bt * vv[n];
      }
      load(tt + 1 < steps ? tt + 1 : tt);
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float kv = kk[j] * vn[n];
          acc[n] = fmaf(rr[j], S[j][n], acc[n]);
          S[j][n] = fmaf(ww[j], S[j][n], kv);
        }
      store_cols<NC>(P + (tt * RG + rg) * HDP + c0, acc);
    }
    bar_arrive(kDone, ALL);
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int row = r0 + j, col = c0 + n;
      if (row < hd && col < hd)
        a.sT[st + static_cast<size_t>(row) * hd + col] = S[j][n];
    }
}

// ---------------------------------------------------------------------------
// The backward (see the note at the top of the file).
// ---------------------------------------------------------------------------
constexpr int kBwdCols = 4;    // gradient columns a thread holds above hd 16
constexpr int kBwdHelperWarps = 2;  // helper warps a block
// Buffers of column partials and row sums: a compute warp runs up to this
// many chunks ahead of the helper warps that read them (4 pass two blocks
// an SM and measured slower: kernel_variants.py k6bwd, PERF.md).
constexpr int kBwdParts = 2;
constexpr int kBwdSlots = 2;   // the ring's chunk slots
constexpr int kBwdCks = 1;     // checkpoint tiles fetched ahead
constexpr int kSums = 12;      // row sums a thread takes a step (3 x kRows)

// A band of KB = 32 rows a block (hd 16: one band of 16): its compute
// threads hold kRows x cols tiles of G and of the states (the first
// design's tiles; 128 threads at hd 64), then the helper warps; a cluster
// of HDP / KB blocks shares a (b, h).
template <int HDP>
__host__ __device__ constexpr int bwd_band() {
  return HDP < 32 ? HDP : 32;
}
template <int HDP>
__host__ __device__ constexpr int bwd_cols() {
  return HDP == 16 ? 2 : kBwdCols;
}
template <int HDP>
__host__ __device__ constexpr int bwd_compute() {
  return (bwd_band<HDP>() / kRows) * (HDP / bwd_cols<HDP>());
}
template <int HDP>
__host__ __device__ constexpr int bwd_threads() {
  return bwd_compute<HDP>() + 32 * kBwdHelperWarps;
}

// A block's shared memory, in order (byte offsets):
//   the chunk's states [kCk][NC][NTC] float4s (each compute thread's tile
//     as NC float4s, so a warp's accesses are consecutive), then the
//     checkpoint tiles fetched ahead [NCK][NC][NTC];
//   the ring [NS] of the chunk's rows as they are in memory: r, k, v and
//     dout [kCk][HDP] in r's type and the band's w [kCk][KB] in w's;
//   the column partial sums G^T k [NP][kCk][NWG][KB] that the cluster's
//     NWG compute warps leave for the band's columns;
//   the band's row sums [NP][3][kCk][KB] (G v, G . S, S dout);
//   each compute warp's row-sum exchange [RGW][XS] (its row groups' lanes'
//     kSums partial sums, XS = CG kSums + 12 floats a row group, so the
//     two row groups of a read fall in other banks);
//   beta and v . dout [NS][2][kCk], u [HDP] and the mbarriers: the ring's
//     [NS] and, by partial buffer, pushed [NP] (the band's row sums and
//     the cluster's partials of its columns landed) and freed [NP] (every
//     owner has read this block's partials).
// At hd 64 with the model's types: 111 KB (two blocks an SM).
template <int HDP, bool kBI, bool kBW>
struct BwdSmem {
  static constexpr int KB = bwd_band<HDP>();
  using TI = typename std::conditional<kBI, bf16, float>::type;
  using TW = typename std::conditional<kBW, bf16, float>::type;
  static constexpr int NC = bwd_cols<HDP>();
  static constexpr int NTC = bwd_compute<HDP>();
  static constexpr int CG = HDP / NC;        // column groups
  static constexpr int RGW = 32 / CG;        // row groups a warp
  static constexpr int XS = CG * kSums + 12;
  static constexpr int NWG = HDP * HDP / (kRows * NC) / 32;  // warps a (b, h)
  static constexpr int NS = kBwdSlots, NP = kBwdParts;
  static constexpr int NCK = kBwdCks;
  static constexpr size_t kRow = kCk * HDP * sizeof(TI);     // an array
  static constexpr size_t kSlot = 4 * kRow + kCk * KB * sizeof(TW);
  static constexpr size_t kStates = 0;
  static constexpr size_t kCkTiles = kStates + sizeof(float4) * kCk * NC * NTC;
  static constexpr size_t kRing = kCkTiles + sizeof(float4) * NCK * NC * NTC;
  static constexpr size_t kCols = kRing + NS * kSlot;
  static constexpr size_t kRowSums = kCols + sizeof(float) * NP * kCk * NWG * KB;
  static constexpr size_t kXs = kRowSums + sizeof(float) * NP * 3 * kCk * KB;
  static constexpr size_t kScal = kXs + sizeof(float) * (NTC / 32) * RGW * XS;
  static constexpr size_t kU = kScal + sizeof(float) * NS * 2 * kCk;
  static constexpr size_t kBars = kU + sizeof(float) * HDP;
  static constexpr size_t kBytes = kBars + sizeof(uint64_t) * (NS + 2 * NP);
  static_assert(kSlot % 16 == 0 && kRing % 16 == 0 && kCols % 16 == 0 &&
                    kXs % 16 == 0 && XS % 4 == 0 && kBars % 8 == 0,
                "bulk copies and vector accesses land 16-byte aligned");
};

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
  bool vec;                    // rows 16-byte aligned: bulk copies
  long long is[3], ds[3], gs[3];  // (b, h, t) strides: inputs, dout, grads
};

// Four values of a row, widened to float32 (16-byte aligned for float32,
// 8 for bf16).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A thread's NC (2 or 4) values of a row, widened to float32.
template <int NC, typename T>
__device__ __forceinline__ void ld_cols(const T* p, float (&v)[NC]) {
  if constexpr (NC == 4) {
    const float4 x = ld4(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (std::is_same<T, float>::value) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
}

// The sum of v[0 .. CG-1] (v[L] from the lane of column group L) in the
// order of a butterfly over the lanes, xor CG / 2 first and xor 1 last:
// the first design's reduce-scatter of shuffles, whose sums (a + b = b + a
// exactly) this gives bit for bit.
template <int CG>
__device__ __forceinline__ float tree_sum(const float (&v)[CG]) {
  if constexpr (CG == 1) {
    return v[0];
  } else {
    float h[CG / 2];
#pragma unroll
    for (int L = 0; L < CG / 2; ++L) h[L] = v[L] + v[L + CG / 2];
    return tree_sum<CG / 2>(h);
  }
}

template <int HDP, bool kBI, bool kBW>
__global__ void __launch_bounds__(bwd_threads<HDP>(), 2)
rwkv_scan_bwd_kernel(const BwdArgs a) {
  using L = BwdSmem<HDP, kBI, kBW>;
  using TI = typename L::TI;
  using TW = typename L::TW;
  constexpr int NC = L::NC, NTC = L::NTC, NWG = L::NWG, CG = L::CG;
  constexpr int NS = L::NS, NP = L::NP, NCK = L::NCK, KB = L::KB;
  constexpr int PER = 16 / CG;               // row sums a lane adds up
  constexpr int NB = HDP / KB;               // blocks a cluster
  constexpr int ALL = bwd_threads<HDP>();
  static_assert(NTC % 32 == 0 && 32 % CG == 0 && NC % 2 == 0 &&
                    NWG == NB * (NTC / 32) && PER * CG == 16,
                "a warp holds whole row groups of one band");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* states = reinterpret_cast<float4*>(smem_raw + L::kStates);
  float4* ck_tiles = reinterpret_cast<float4*>(smem_raw + L::kCkTiles);
  unsigned char* ring = smem_raw + L::kRing;
  float* cols = reinterpret_cast<float*>(smem_raw + L::kCols);
  float* rsum = reinterpret_cast<float*>(smem_raw + L::kRowSums);
  float* xs = reinterpret_cast<float*>(smem_raw + L::kXs);
  float* scal = reinterpret_cast<float*>(smem_raw + L::kScal);
  float* us = reinterpret_cast<float*>(smem_raw + L::kU);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + L::kBars);
  uint64_t* pushed = full + NS;              // [NP], chunk i's is i % NP
  uint64_t* freed = pushed + NP;             // [NP]

  const int tid = threadIdx.x, lane = tid & 31;
  const int band = static_cast<int>(sm90::cluster_rank());
  const int bh = blockIdx.x / NB, b = bh / a.H, h = bh % a.H;
  const int hd = a.hd, T = a.T;
  const int n_ck = (T + kCk - 1) / kCk;
  const int lo = band * KB;                  // the band's first row
  const size_t sq = static_cast<size_t>(bh) * hd * hd;

  // The ring's slot s: r, k, v, dout, then the band's w.
  auto slot_in = [&](int s, int arr) {
    return reinterpret_cast<const TI*>(ring + s * L::kSlot + arr * L::kRow);
  };
  auto slot_w = [&](int s) {
    return reinterpret_cast<const TW*>(ring + s * L::kSlot + 4 * L::kRow);
  };

  // Zero the ring once: the columns past hd stay zero (the copies write
  // hd of them), as the walk reads padding columns.
  for (int i = tid; i < static_cast<int>(NS * L::kSlot / 16); i += ALL)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < HDP; i += ALL) us[i] = i < hd ? a.u[h * hd + i] : 0.0f;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) sm90::mbar_init(&full[s], 32);
    for (int p = 0; p < NP; ++p) {
      sm90::mbar_init(&pushed[p], 1);
      sm90::mbar_init(&freed[p], NB);
    }
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();                 // the zeros before the copies
  // Every block of the cluster running and initialised before any writes
  // another's shared memory or arrives on its barriers.
  sm90::cluster_arrive();
  sm90::cluster_wait();

  if (tid >= NTC) {
    // The helper warps: the first stages the chunks; together they take
    // beta and v . dout, add the cluster's column partials of the band's
    // columns and write the band's gradients and du.
    constexpr int NH = 32 * kBwdHelperWarps;
    const int hid = tid - NTC, hw = hid / 32;
    auto helpers_sync = [&] { sm90::named_barrier(1, NH); };
    const long long in_off = b * a.is[0] + h * a.is[1];
    const long long d_off = b * a.ds[0] + h * a.ds[1];
    const long long g_off = b * a.gs[0] + h * a.gs[1];
    const int wrows = max(0, min(KB, hd - lo));  // the band's real rows
    // Row t of array arr (r, k, v, dout, then w at the band's rows),
    // picked by branches: an index into the launch's parameters would put
    // them in local memory.
    auto row = [&](int arr, long long t) -> const char* {
      if (arr == 3)
        return static_cast<const char*>(a.dout) +
               (d_off + t * a.ds[2]) * sizeof(TI);
      if (arr == 4)
        return static_cast<const char*>(a.in[3]) +
               (in_off + t * a.is[2] + lo) * sizeof(TW);
      const void* base = arr == 0 ? a.in[0] : arr == 1 ? a.in[1] : a.in[2];
      return static_cast<const char*>(base) +
             (in_off + t * a.is[2]) * sizeof(TI);
    };

    // Chunk j (in walking order: chunk n_ck - 1 - j) into slot j % NS.
    auto issue = [&](int j) {
      const int ch = n_ck - 1 - j;
      if (ch < 0) return;
      const int s = j % NS, t0 = ch * kCk, n = min(kCk, T - t0);
      unsigned char* slot = ring + s * L::kSlot;
      if (a.vec) {
        const uint32_t row_b = hd * sizeof(TI), w_b = wrows * sizeof(TW);
        if (lane == 0)
          sm90::mbar_arrive_expect_tx(&full[s], n * (4 * row_b + w_b));
        __syncwarp();
        for (int c = lane; c < 5 * n; c += 32) {
          const int arr = c / n, tt = c % n;
          if (arr < 4)
            sm90::bulk_load(slot + arr * L::kRow + tt * HDP * sizeof(TI),
                            row(arr, t0 + tt), row_b, &full[s]);
          else if (w_b > 0)
            sm90::bulk_load(slot + 4 * L::kRow + tt * KB * sizeof(TW),
                            row(4, t0 + tt), w_b, &full[s]);
        }
        if (lane != 0) sm90::mbar_arrive(&full[s]);
      } else {
        for (int e = lane; e < n * (4 * hd + wrows); e += 32) {
          const int tt = e / (4 * hd + wrows), f = e % (4 * hd + wrows);
          if (f < 4 * hd) {
            const int arr = f / hd, col = f % hd;
            reinterpret_cast<TI*>(slot + arr * L::kRow)[tt * HDP + col] =
                reinterpret_cast<const TI*>(row(arr, t0 + tt))[col];
          } else {
            const int k = f - 4 * hd;
            reinterpret_cast<TW*>(slot + 4 * L::kRow)[tt * KB + k] =
                reinterpret_cast<const TW*>(row(4, t0 + tt))[k];
          }
        }
        sm90::mbar_arrive(&full[s]);
      }
    };

    if (hw == 0)
      for (int j = 0; j < NS; ++j) issue(j);
    float du = 0.0f;                         // du[lo + lane] in warp 0
    for (int i = 0; i < n_ck; ++i) {
      const int s = i % NS, p = i % NP, ch = n_ck - 1 - i;
      const int t0 = ch * kCk, n = min(kCk, T - t0);
      const TI* R = slot_in(s, 0);
      const TI* K = slot_in(s, 1);
      const TI* V = slot_in(s, 2);
      const TI* D = slot_in(s, 3);
      float* beta = scal + s * 2 * kCk;
      float* vd = beta + kCk;
      sm90::mbar_wait(&full[s], (i / NS) & 1);
      // beta_t = sum_k r_k u_k k_k and v_t . dout_t, a warp's lanes over k
      // and a butterfly of shuffles, the warps taking every other step; the
      // steps' butterflies share their rounds.
      constexpr int SPW = kCk / kBwdHelperWarps;  // steps a helper warp
      float bs[SPW], vs[SPW];
#pragma unroll
      for (int c = 0; c < SPW; ++c) {
        const int tt = hw + kBwdHelperWarps * c;
        bs[c] = 0.0f;
        vs[c] = 0.0f;
#pragma unroll
        for (int q = 0; q < (HDP + 31) / 32; ++q) {
          const int e = lane + 32 * q;
          if (e < HDP) {
            bs[c] = fmaf(widen(R[tt * HDP + e]) * us[e],
                         widen(K[tt * HDP + e]), bs[c]);
            vs[c] = fmaf(widen(V[tt * HDP + e]), widen(D[tt * HDP + e]),
                         vs[c]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int c = 0; c < SPW; ++c) {
          bs[c] += __shfl_xor_sync(~0u, bs[c], o);
          vs[c] += __shfl_xor_sync(~0u, vs[c], o);
        }
      if (lane == 0)
#pragma unroll
        for (int c = 0; c < SPW; ++c) {
          beta[hw + kBwdHelperWarps * c] = bs[c];
          vd[hw + kBwdHelperWarps * c] = vs[c];
        }
      helpers_sync();
      // Chunk i walked: the band's row sums and every warp's column
      // partials of the band's columns landed (n steps of 3 KB and NWG x KB
      // floats; a step's stores follow its reads of the ring, so slot s is
      // read too).
      if (hid == 0)
        sm90::mbar_arrive_expect_tx(&pushed[p],
                                    n * (3 + NWG) * KB * sizeof(float));
      sm90::mbar_wait_cluster(&pushed[p], (i / NP) & 1);
      const float* P = cols + p * kCk * NWG * KB;
      const float* RS = rsum + p * 3 * kCk * KB;
      // The chunk's gradients of the band's rows and columns, into
      // registers first: the buffers are released before the stores.
      constexpr int IPL = kCk * KB / NH;     // items a helper thread
      float go[IPL][4];
#pragma unroll
      for (int c = 0; c < IPL; ++c) {
        const int e = hid + NH * c, tt = e / KB, j = e % KB, x = lo + j;
        if (tt >= n || x >= hd) continue;
        float dv = 0.0f;                     // the warps' partials, in order
#pragma unroll
        for (int g = 0; g < NWG; ++g) dv += P[(tt * NWG + g) * KB + j];
        go[c][0] = fmaf(us[x] * widen(K[tt * HDP + x]), vd[tt],
                        RS[(2 * kCk + tt) * KB + j]);             // dr
        go[c][1] = fmaf(us[x] * widen(R[tt * HDP + x]), vd[tt],
                        RS[tt * KB + j]);                         // dk
        go[c][2] = fmaf(widen(D[tt * HDP + x]), beta[tt], dv);    // dv
        go[c][3] = RS[(kCk + tt) * KB + j];                       // dw
      }
      // du[k] += r_t,k k_t,k (v_t . dout_t), steps in descending order.
      if (hw == 0 && lane < KB && lo + lane < hd)
        for (int tt = n - 1; tt >= 0; --tt)
          du = fmaf(widen(R[tt * HDP + lo + lane]) *
                        widen(K[tt * HDP + lo + lane]),
                    vd[tt], du);
      helpers_sync();
      // The band's partials and row sums of chunk i read: each block of the
      // cluster may write chunk i + NP's (if it has one); slot s is free.
      if (hw == 0) {
        if (i + NP < n_ck && lane < NB)
          sm90::mbar_arrive_cluster(sm90::cluster_map(&freed[p], lane));
        issue(i + NS);
      }
#pragma unroll
      for (int c = 0; c < IPL; ++c) {
        const int e = hid + NH * c, tt = e / KB, x = lo + e % KB;
        if (tt >= n || x >= hd) continue;
        const long long off = g_off + (t0 + tt) * a.gs[2] + x;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          narrow(static_cast<TI*>(a.grad[g]) + off, go[c][g]);
        narrow(static_cast<TW*>(a.grad[3]) + off, go[c][3]);
      }
    }
    if (hw == 0 && lane < KB && lo + lane < hd)
      a.du[static_cast<size_t>(bh) * hd + lo + lane] = du;
    sm90::cluster_arrive_relaxed();          // no block leaves while another
    sm90::cluster_wait();                    // may still reach its memory
    return;
  }

  // A compute thread (row group of the band, column group cg) holds rows
  // r0 .. r0 + 3 and columns c0 .. c0 + NC - 1 of G and of the states; a
  // warp spans RGW row groups and all columns.  Its warp is warp `gw` of
  // the (b, h)'s NWG, the order the column partials are added in.
  const int cg = tid % CG, rl = (tid / CG) * kRows;
  const int r0 = lo + rl, c0 = cg * NC;
  const int gw = band * (NTC / 32) + tid / 32;
  // The warp's row-sum exchange: this lane's kSums sums, and the row
  // group's.
  float* const xrg = xs + (tid / 32) * L::RGW * L::XS + (lane / CG) * L::XS;
  float* const xme = xrg + cg * kSums;
  // Where this lane leaves its warp's column partials: the block that owns
  // columns c0 .., at (buffer 0, step 0, warp gw), and that block's pushed
  // barriers.
  const uint32_t push = sm90::cluster_map(cols + gw * KB + c0 % KB, c0 / KB);
  const uint32_t push_bar = sm90::cluster_map(pushed, c0 / KB);
  // The row sums go to this block's buffers the same way, on its own
  // pushed barriers (so the compute warps signal nothing else a chunk).
  const uint32_t rs_at = sm90::cluster_map(rsum + rl, band);
  const uint32_t rs_bar = sm90::cluster_map(pushed, band);
  constexpr uint32_t kPushStep = NWG * KB * sizeof(float);
  constexpr uint32_t kPushBuf = kCk * kPushStep;

  float G[kRows][NC];                        // dstate_T first
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int row = r0 + j, col = c0 + m;
      G[j][m] = (a.dsT != nullptr && row < hd && col < hd)
                    ? a.dsT[sq + static_cast<size_t>(row) * hd + col]
                    : 0.0f;
    }

  // The thread's tile of chunk j's checkpoint (in walking order: chunk
  // n_ck - 1 - j) into checkpoint tile j % NCK (zeros past hd), by
  // asynchronous copies, one commit group a chunk (empty past the last):
  // fetched NCK chunks ahead.
  auto fetch_ck = [&](int j) {
    const int ch = n_ck - 1 - j;
    if (ch >= 0) {
      const float* ck =
          a.ck + (static_cast<size_t>(bh) * n_ck + ch) * hd * hd;
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 4 * q + e, row = r0 + f / NC, col = c0 + f % NC;
          const bool in = row < hd && col < hd;
          const uint32_t d = sm90::smem_u32(
              reinterpret_cast<float*>(
                  &ck_tiles[((j % NCK) * NC + q) * NTC + tid]) + e);
          asm volatile(
              "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
              "l"(in ? ck + static_cast<size_t>(row) * hd + col : a.ck),
              "r"(in ? 4 : 0)
              : "memory");
        }
    }
    cp_async_commit();
  };
  for (int j = 0; j < NCK; ++j) fetch_ck(j);

  for (int i = 0; i < n_ck; ++i) {
    const int s = i % NS, b = i % NP, ch = n_ck - 1 - i;
    const int n = min(kCk, T - ch * kCk);
    const TI* R = slot_in(s, 0);
    const TI* K = slot_in(s, 1);
    const TI* V = slot_in(s, 2);
    const TI* D = slot_in(s, 3);
    const TW* W = slot_w(s);
    sm90::mbar_wait(&full[s], (i / NS) & 1);   // chunk i staged
    // The chunk's states S_{t-1}, the thread's tile of each, recomputed
    // from the checkpoint as the forward computed them (the same bits).
    {
      cp_async_wait<NCK - 1>();              // chunk i's tile landed
      float S[kRows][NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float4 x = ck_tiles[((i % NCK) * NC + q) * NTC + tid];
        const int f = 4 * q;
        S[f / NC][f % NC] = x.x;
        S[(f + 1) / NC][(f + 1) % NC] = x.y;
        S[(f + 2) / NC][(f + 2) % NC] = x.z;
        S[(f + 3) / NC][(f + 3) % NC] = x.w;
      }
      auto rstep = [&](int tt) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int f = 4 * q;               // flat index f .. f + 3
          states[(tt * NC + q) * NTC + tid] = make_float4(
              S[f / NC][f % NC], S[(f + 1) / NC][(f + 1) % NC],
              S[(f + 2) / NC][(f + 2) % NC], S[(f + 3) / NC][(f + 3) % NC]);
        }
        if (tt + 1 < n) {
          const float4 k4 = ld4(K + tt * HDP + r0);
          const float4 w4 = ld4(W + tt * KB + rl);
          const float kk[kRows] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[kRows] = {w4.x, w4.y, w4.z, w4.w};
          float vv[NC];
          ld_cols<NC>(V + tt * HDP + c0, vv);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
#pragma unroll
            for (int m = 0; m < NC; ++m) {
              const float kv = kk[j] * vv[m];
              S[j][m] = fmaf(ww[j], S[j][m], kv);
            }
        }
      };
      // Once the first state is stored (the tile read), the tile takes
      // chunk i + NCK's checkpoint.
      rstep(0);
      fetch_ck(i + NCK);
      if (n == kCk) {
#pragma unroll
        for (int tt = 1; tt < kCk; ++tt) rstep(tt);
      } else {
        for (int tt = 1; tt < n; ++tt) rstep(tt);
      }
    }
    // The owners have read chunk i - NP's partials and row sums from the
    // buffers this chunk writes.
    if (i >= NP) sm90::mbar_wait_cluster(&freed[b], (i / NP - 1) & 1);
    const uint32_t rs_i = rs_at + b * 3 * kCk * KB * sizeof(float);
    const uint32_t rs_bar_i = rs_bar + b * sizeof(uint64_t);
    const uint32_t push_i = push + b * kPushBuf;
    const uint32_t bar_i = push_bar + b * sizeof(uint64_t);
    auto step = [&](int tt) {
      const float4 r4 = ld4(R + tt * HDP + r0);
      const float4 k4 = ld4(K + tt * HDP + r0);
      const float4 w4 = ld4(W + tt * KB + rl);
      const float rr[kRows] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[kRows] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[kRows] = {w4.x, w4.y, w4.z, w4.w};
      float vv[NC], dd[NC], S[kRows][NC];
      ld_cols<NC>(V + tt * HDP + c0, vv);
      ld_cols<NC>(D + tt * HDP + c0, dd);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float4 x = states[(tt * NC + q) * NTC + tid];
        const int f = 4 * q;
        S[f / NC][f % NC] = x.x;
        S[(f + 1) / NC][(f + 1) % NC] = x.y;
        S[(f + 2) / NC][(f + 2) % NC] = x.z;
        S[(f + 3) / NC][(f + 3) % NC] = x.w;
      }
      // Row sums over the thread's columns: x[4 q + j] for row j of G v
      // (q 0), G . S_{t-1} (q 1) and S_{t-1} dout (q 2).
      float x[kSums], dv[NC];
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
        for (int m = 0; m < NC; ++m)
          G[j][m] = fmaf(ww[j], G[j][m], rr[j] * dd[m]);
      // The row sums across the row group's CG lanes: each lane leaves its
      // kSums in the warp's exchange and adds one sum's CG terms (sum idx
      // = 4 q + j of the group; lanes past kSums / PER add none).
#pragma unroll
      for (int e = 0; e < kSums; e += 4)
        *reinterpret_cast<float4*>(xme + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      __syncwarp();
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = p + PER * cg;
        if (idx < kSums) {
          float v[CG];
#pragma unroll
          for (int Lg = 0; Lg < CG; ++Lg) v[Lg] = xrg[Lg * kSums + idx];
          sm90::st_async(
              rs_i + (((idx >> 2) * kCk + tt) * KB + (idx & 3)) * 4u,
              tree_sum<CG>(v), rs_bar_i);
        }
      }
      __syncwarp();
      // The warp's row groups' column sums, then one lane a column group
      // leaves them with the block that owns the columns.
#pragma unroll
      for (int m = 0; m < NC; ++m)
#pragma unroll
        for (int o = CG; o < 32; o <<= 1)
          dv[m] += __shfl_xor_sync(~0u, dv[m], o);
      if (lane < CG) {
        const uint32_t at = push_i + tt * kPushStep;
        if constexpr (NC == 4)
          sm90::st_async(at, dv[0], dv[1], dv[2], dv[3], bar_i);
        else
          sm90::st_async(at, dv[0], dv[1], bar_i);
      }
    };
    // The walk, t down.
    if (n == kCk) {
#pragma unroll 2
      for (int tt = kCk - 1; tt >= 0; --tt) step(tt);
    } else {
      for (int tt = n - 1; tt >= 0; --tt) step(tt);
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int row = r0 + j, col = c0 + m;
      if (row < hd && col < hd)
        a.ds0[sq + static_cast<size_t>(row) * hd + col] = G[j][m];
    }
  sm90::cluster_arrive_relaxed();
  sm90::cluster_wait();
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

template <int HDP, bool kBI, bool kBW, bool kCkpt>
cudaError_t launch(const Args& a, int B, int device, cudaStream_t stream) {
  auto kernel = rwkv_scan_kernel<HDP, kBI, kBW, kCkpt>;
  constexpr size_t smem = smem_bytes<HDP, kBI, kBW>();
  static bool allowed[64];
  cudaError_t err = allow_smem(kernel, smem, allowed, device);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.H, threads<HDP>() + kHelpers, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kBI, bool kBW, bool kCkpt>
cudaError_t dispatch(const Args& a, int B, int device, cudaStream_t s) {
  if (a.hd <= 16) return launch<16, kBI, kBW, kCkpt>(a, B, device, s);
  if (a.hd <= 32) return launch<32, kBI, kBW, kCkpt>(a, B, device, s);
  return launch<64, kBI, kBW, kCkpt>(a, B, device, s);
}

template <bool kBI, bool kBW>
cudaError_t dispatch(const Args& a, int B, int device, cudaStream_t s) {
  if (a.ck != nullptr) return dispatch<kBI, kBW, true>(a, B, device, s);
  return dispatch<kBI, kBW, false>(a, B, device, s);
}

// One cluster of HDP / KB blocks a (b, h): two at hd 64, one below.
template <int HDP, bool kBI, bool kBW>
cudaError_t launch_bwd(const BwdArgs& a, int B, int device,
                       cudaStream_t stream) {
  auto kernel = rwkv_scan_bwd_kernel<HDP, kBI, kBW>;
  using L = BwdSmem<HDP, kBI, kBW>;
  static bool allowed[64];
  cudaError_t err = allow_smem(kernel, L::kBytes, allowed, device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H * (HDP / L::KB));
  cfg.blockDim = dim3(bwd_threads<HDP>());
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = HDP / L::KB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
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

// r, k, v, w and out [B, H, T, hd], at element strides (b, h, t)
// `sb, sh, st` for r, k, v and w and `ob, oh, ot` for out, hd's stride 1;
// `kinds` 0: all float32; 1: r, k, v and out bf16, w float32; 2: r, k, v,
// w and out bf16.  u [H, hd], state0 [B, H, hd, hd] (or null: zeros) and
// state [B, H, hd, hd] float32, contiguous.  `ckpt` null, or float32
// [B, H, ceil(T / kCk), hd, hd] contiguous: the state before every kCk-th
// step, for the backward (out and state are the same bits either way).
// 1 <= hd <= 64, T >= 0.  Returns a cudaError_t (0 on success); one
// launch, asynchronous on `stream`.
int repro_rwkv_scan(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* state0,
                    void* out, float* state, float* ckpt, int B, int H,
                    int T_len, int hd, int kinds, long long sb, long long sh,
                    long long st, long long ob, long long oh, long long ot,
                    int device, void* stream) {
  if (B < 1 || H < 1 || T_len < 0 || hd < 1 || hd > 64 || kinds < 0 ||
      kinds > 2 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  Args a{};
  a.in[0] = r;
  a.in[1] = k;
  a.in[2] = v;
  a.in[3] = w;
  a.u = u;
  a.s0 = state0;
  a.out = out;
  a.sT = state;
  a.ck = ckpt;
  a.H = H;
  a.T = T_len;
  a.hd = hd;
  a.is[0] = sb;
  a.is[1] = sh;
  a.is[2] = st;
  a.os[0] = ob;
  a.os[1] = oh;
  a.os[2] = ot;
  // 16-byte copies need every row start and hd's extent 16-byte aligned:
  // 8 elements for a bf16 array, 4 for a float32 one (strides in
  // elements, shared by the four).
  const long long per = kinds == 0 ? 4 : 8;
  bool vec = hd % per == 0 && sb % per == 0 && sh % per == 0 &&
             st % per == 0;
  for (const void* p : a.in)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kinds == 0) return dispatch<false, false>(a, B, device, s);
  if (kinds == 1) return dispatch<true, false>(a, B, device, s);
  return dispatch<true, true>(a, B, device, s);
}

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
      kinds > 2 || static_cast<long long>(B) * H * 4 > 0x7fffffffLL)
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
  // Bulk copies need every row start and a row's hd values a multiple of
  // 16 bytes: 8 elements for bf16 r, k, v and dout, 4 for float32 (w's
  // rows are then aligned too).
  const long long per = kinds == 0 ? 4 : 8;
  bool vec = hd % per == 0;
  for (long long x : {sb, sh, st, db, dh, dt}) vec = vec && x % per == 0;
  for (const void* p : {r, k, v, w, dout})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kinds == 0) return dispatch_bwd<false, false>(a, B, device, s);
  if (kinds == 1) return dispatch_bwd<true, false>(a, B, device, s);
  return dispatch_bwd<true, true>(a, B, device, s);
}

}  // extern "C"
