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
// Design of the backward (a first design: right and simple).  One block
// per (b, h), as the forward, walks t down from T-1 with G in registers,
// a thread holding a kRows x NC tile (the forward's 4 x 4 at hd 64, 256
// threads; no helper warps: each phase of a chunk ends at __syncthreads).
// dr_t and dw_t need S_{t-1} while G runs backwards, and S_{t-1} is never
// had by dividing by w_t (w = exp(-exp(.)) may come near 0 once trained):
// the forward, asked with a checkpoint buffer, writes its state before
// every kCk-th step (float32 [B, H, ceil(T / kCk), hd, hd]; 134 MB a layer
// at the training shape, and under remat one layer holds it at a time; a
// null buffer runs the forward's kernel as it was, the same bits).  Per
// chunk of kCk = 8 steps, last chunk first, the block:
//   1. stages the chunk's rows of r, k, v, w and dout (widened to float32,
//      zeros past hd and past T) in shared memory from registers, where
//      each thread fetched its share a chunk ahead (the loads of the next
//      chunk go out here and land while this one is computed: staged by a
//      loop of dependent loads instead, a call at the training shape took
//      1.01 ms on an H100 against 0.655, PERF.md), and takes beta_t and
//      vd_t, a warp a step;
//   2. recomputes the chunk's states from its checkpoint with the
//      forward's arithmetic (the same bits as the forward's states), each
//      thread its own tile, and keeps them in shared memory: a thread only
//      ever reads its own tile back, so no barrier guards them.  The
//      chunk's kCk states take 128 KB at hd 64: registers would need 128 a
//      thread, a workspace in device memory would be 2 GB of L2 traffic a
//      call, and shared memory holds them with room for the rest (160 KB
//      in all), which is why kCk is 8 and not 16;
//   3. walks the chunk's steps down: a thread's row sums of G v, G . S and
//      S dout (over its NC columns) go across its row group's CG lanes by a
//      reduce-scatter of shuffles (15 at hd 64), each lane writing its one
//      sum; its column sums G^T k across the warp's row groups by
//      shuffles, one partial a warp; then G = diag(w) G + r dout^T;
//   4. adds the bonus terms and the warps' partials and writes dr, dk, dv
//      and dw in the inputs' layout (the model's [B, T, H hd] read as [B,
//      H, T, hd], so its views' gradients need no copy).
// du goes out as each (b, h)'s partial sum [B, H, hd], summed over t in
// one order in the block and over B by the caller: no atomics, so two
// runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
