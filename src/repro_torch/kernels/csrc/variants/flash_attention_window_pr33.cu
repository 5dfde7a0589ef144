// K5 as it stood when the hybrid family's sliding window was first built,
// kept to compare the window's redesign with: `python3 kernel_variants.py
// k5 window` builds it beside csrc/flash_attention.cu (and with edits that
// deepen its ring, drop its second masking pass, skip no tile or give dq's
// warpgroups one walk), times the two in turns and says whether calls
// without a window give the same bits (they must).  Plain C interface, the
// same entries as the source's (`repro_flash_attention`,
// `repro_flash_attention_bwd`).  Its window walks: the forward's and dq's
// blocks own 192 consecutive query rows of one head (their warpgroups
// start on tiles one and two apart) on a 4- and a 2-stage ring, every
// edge tile masked score by score (the forward twice), and dkv a block a
// 128-key item.
//
// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (wrapper flash_attention :72, kernel _flash_kernel :26), the computation
// of repro/models/attention.py::flash_attention_ref on the prefill path
// (attention.py:174 and :180, and MLA's expanded path, :296):
//   out[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/rep, j])
//                  * v[b, h/rep, j]
// for q [B, H, S, dk], k [B, H/rep, T, dk] and v [B, H/rep, T, dv] (bf16 or
// float32, all alike; any element strides over batch, head and row, the
// last dimension contiguous), out [B, H, S, dv] float32 and contiguous;
// (dk, dv) one of REPRO_K5_WIDTHS: equal widths 16, 32, 64, 128, or MLA's
// pairs, qk_nope + qk_rope and v_head (the smoke configurations' (24, 16),
// MiniCPM3-4B's (96, 64), DeepSeek-V2-Lite's (192, 128)); causal masks
// j > i (S == T: the wrapper refuses a causal call with S != T), and a
// causal call's sliding window (window > 0, the hybrid family's layers,
// repro/models/attention.py:95-96) also j <= i - window, on the fma
// kernels and the (64, 64) wgmma ones (the other wgmma widths refuse it);
// tiles wholly below every row's window are neither loaded nor multiplied,
// so a window costs ~S window pairs, not S^2 / 2.  The
// arithmetic is the TPU kernel's, in float32: masked scores take the value
// -2^30 (not -inf), the running max m, sum l and accumulator acc are
// carried across KV tiles with the online-softmax correction
// exp(m_prev - m_new), l sums the float32 p, and the output is
// acc / max(l, 1e-20).  KV tiles wholly above the diagonal are skipped and
// the heaviest query tiles launch first.  GQA: query head h reads KV head
// h / rep; the KV heads are never repeated in memory.
//
// Two kernels:
//   "wgmma" (bf16 at (dk, dv) = (128, 128), (64, 64), (96, 64), (192,
//            128); the models' prefills, training forwards and Whisper's
//            full and cross attention): Q K^T and P V on the
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
//   "fma"    (float32, and bf16 at the other widths): float32 on the CUDA
//            cores, the first, simple design (below), templated on
//            (dk, dv): q and k rows dk wide, v, out and dO rows dv.
// The wgmma kernel also writes each row's log-sum-exp of the scaled scores,
// m + log(max(l, 1e-20)), when given a buffer for it (the training
// forward; the serve passes none and its output's bits do not change).
// The backward has two routes of its own, each described where it is
// defined: "fma" (flash_bwd_dq, flash_bwd_dkv: CUDA cores, any call) and
// "wgmma" (bf16 at the same widths as the forward's: flash_bwd_prep,
// flash_bwd_dkv_wgmma, flash_bwd_dq_wgmma, which read that log-sum-exp).
//
// Bound on an H100 (NVIDIA H100 SXM data sheet), per visible (query, key)
// pair (S T pairs, S (S + 1) / 2 when causal and S == T): wgmma, 2 dk
// operations for Q K^T and 4 dv for P V (hi and lo) at the bf16
// tensor-core rate (989 TFLOP/s dense); fma, 2 dk for Q K^T (at the bf16
// tensor-core rate for bf16 inputs, whose products are exact in float32,
// else at the 67 TFLOP/s of float32) and 2 dv for P V at the float32 rate.
// The bytes are q, k and v read once and the float32 output written once,
// each at its width, against 3.35 TB/s.  The serve's prefills (S = 202 and 445) are bound by
// the bytes on the wgmma route; OLMoE's 4096-token context by operations.
//
// Design of "wgmma".  The TPU kernel keeps the q tile and (acc, m, l) in
// VMEM while the innermost grid axis walks the KV tiles in order.  Here a
// block owns 128 query rows of one (b, h) (grid B H x S/128, the heaviest
// causal tiles first) and walks the KV tiles in a loop: one producer warp
// loads the q tile once by TMA and streams 128-key K and V tiles through a
// 2-stage ring on mbarriers (K and V on barriers of their own, so Q K^T
// starts before V lands); two consumer warpgroups own 64 rows each.  A
// bf16 row wider than 64 is past the 128-byte swizzle, so every tile
// arrives as 64-column boxes one box apart: dk / 64 rounded up for q and
// K (at dk 96 the second box's last 32 columns lie past the tensor, TMA
// writes zeros there and no product reads them: the K steps stop at dk),
// dv / 64 for V.  At (192, 128) the q tile and a 2-stage ring of K and V
// take 48 + 2 (48 + 32) = 208 KB of the 227.  The tensor maps are 4-D
// over (hd, rows, heads, batch) with the tensors' own strides, so the
// model's [B, S, H, hd] activations are read in place through a transposed
// view, and GQA picks KV head h / rep by the map's coordinate.  Per tile:
// S = Q K^T by dk / 16 wgmma m64n128k16 (q and K both K-major from shared
// memory), the online softmax in registers on the accumulator layout (a
// row lies in the 4 lanes of a quad: two shuffles), the mask only on the
// diagonal and ragged tiles, then P V by 16 wgmma m64n{dv}k16 with P's hi
// and lo fragments in registers (the float32 accumulator of S packs into
// the A fragment of the next product without a shuffle) and V N-major
// (transpose bit set).  The output is written from registers, rows past S
// not at all.  A wait that never ends traps (sm90.cuh).
// At MLA's widths the two consumer warpgroups take turns on the tensor
// cores, a turn a product (named barriers, FwdForm), so that one's
// softmax runs while the other's product does, at no register's cost.
// Each tile's products and softmax are the same operations in the same
// order at every width but (64, 64), so the output and lse keep their
// bits there.  At (64, 64) (Whisper; FwdForm kOverlap, flash_overlap) the
// softmax weighs twice what it does at hd 128 against the products, and
// a 128-key tile's S, P and accumulator (160 registers) leave no room to
// overlap anything: a block owns 64 query rows a consumer warpgroup
// (three, 416 threads; two where that leaves the card fewer waves of
// blocks: block_wgs), K and V come in 64-key tiles on a 4-stage
// ring, and each warpgroup issues Q K^T of tile j and P V of tile j - 1
// before it takes tile j's softmax, so one of its products is always in
// flight beside its softmax (S, P's fragments and the accumulator: 96
// registers; ptxas 123).  The scale is folded into the exponent: the row
// keeps the extreme of its raw scores and p = 2^(s c - m c) with c = scale
// log2(e), one FFMA and one ex2 a score; S is not zeroed before its
// product (its first step overwrites it), and P's hi part is p truncated
// to bf16 (split_trunc: one conversion a pair).  Other bits than the turns
// form (other tiles, ex2, hi), within check_flash
// (tests/test_torch_fwd_overlap.py emulates the arithmetic).
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
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of q, k and v over (batch, head, row); each row is
// contiguous.
struct Strides {
  long long q[3], k[3], v[3];
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// ---- bf16 at (dk, dv) = (128, 128), (64, 64), (96, 64), (192, 128): wgmma on
// a TMA ring.  S != T (the cross attention: 1 to 512 queries against 1,500
// keys) needs nothing of its own: a q tile past S reads zeros by TMA and
// its rows are never written, keys past T are masked on the ragged tile.
constexpr int kBM = 128;                  // query rows a block
constexpr int kBN = 128;                  // keys a tile
constexpr int kStages = 2;
constexpr int kWThreads = 288;            // 2 warpgroups + 1 producer warp
constexpr uint32_t kBox = 128 * 128;      // 128 rows x 64 bf16, 16 KB

// How the two consumer warpgroups of the forward use the tensor cores:
//   kPlain  each issues Q K^T, waits, takes the softmax, issues P V and
//           waits, the two unordered (hd 128);
//   kTurns  the same, but the two take turns to issue a product (named
//           barriers), so that one's softmax runs while the other's product
//           holds the tensor cores, at no register's cost (MLA's widths and
//           hd 64).
// Overlapping a warpgroup's own softmax of tile j with its P V of tile
// j - 1 as well took longer at (96, 64), in both forms tried: P's
// fragments held in registers while the next scores arrive need ~180
// registers a thread, and ptxas caps a thread of these blocks at 168, with
// setmaxnreg or without, so it serialized the wgmma and spilled; P through
// shared memory fit, but its stores cost more than the overlap won.
//   kOverlap at (64, 64) (below): 64-key tiles, three consumer
//           warpgroups, and each warpgroup's softmax of tile j runs while
//           its own P V of tile j - 1 holds the tensor cores (S 32, P's
//           fragments 32 and the accumulator 32 registers a thread).
enum FwdForm { kPlain = 0, kTurns = 1, kOverlap = 2 };

// The overlap form's block: at most kOWGs consumer warpgroups of 64 query
// rows (block_wgs) and one producer warp, K and V tiles of 64 keys on a
// kOStages ring.
constexpr int kOWGs = 3;
constexpr int kOStages = 4;
constexpr uint32_t kOBox = 64 * 128;      // 64 rows x 64 bf16, 8 KB

// The forward's tiles at (DK, DV): q and k in kQB 64-column boxes (the
// last one past DK read as zeros by TMA and never multiplied: DK 96 is one
// and a half boxes), v in kVB.
template <int DK, int DV>
struct FwdShape {
  static_assert(DK % 16 == 0 && (DV == 64 || DV == 128), "wgmma widths");
  static constexpr int kForm =
      DK == 128 ? kPlain : DK == 64 && DV == 64 ? kOverlap : kTurns;
  static constexpr int kQB = (DK + 63) / 64;
  static constexpr int kVB = DV / 64;
  static constexpr uint32_t kQTile = kQB * kBox;   // q, and a K tile
  static constexpr uint32_t kVTile = kVB * kBox;   // a V tile
  static constexpr uint32_t kStage = kQTile + kVTile;
  // Query rows a block, threads, rows of a TMA box, shared memory.
  static constexpr bool kOv = kForm == kOverlap;
  static constexpr int kRowsB = kOv ? 64 * kOWGs : kBM;
  static constexpr int kThreads = kOv ? 128 * kOWGs + 32 : kWThreads;
  static constexpr int kBoxRows = kOv ? 64 : 128;
  static constexpr size_t kSmem =
      kOv ? kOWGs * kOBox + kOStages * 2 * kOBox + (1 + 3 * kOStages) * 8 +
                1024
          : kQTile + kStages * kStage + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Arrives on named barrier `id` (1..15) of `threads` threads without
// waiting; a bar.sync of the same id by the other threads completes it.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The consumer warpgroups' turns on the tensor cores (named barriers 1
// and 2 over their 256 threads): warpgroup wg waits for its turn before it
// issues a product and hands the turn to the other after.  Warpgroup 1
// opens with a pass, so warpgroup 0 goes first, and skips its last pass,
// so every arrival is waited for.
__device__ __forceinline__ void turn_wait(int wg) {
  sm90::named_barrier(1 + wg, 256);
}
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(2 - wg, 256); }

// The thread's warp; kUniform makes it warp-uniform for the compiler by a
// shuffle, without which ptxas serializes the wgmma of a kernel whose
// warpgroups branch on it (the MLA kernels take this form).
template <bool kUniform>
__device__ __forceinline__ int warp_index() {
  if constexpr (kUniform)
    return __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  else
    return threadIdx.x / 32;
}

// Splits the float32 accumulator of an m64n64 product into the bf16 hi and
// lo A fragments of its four 16-column steps (the RS layout of sm90.cuh:
// d[8 j .. 8 j + 7] packs in order into step j's fragment).
__device__ __forceinline__ void split_frags(const float (&a)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = a[8 * kk + 2 * r], y = a[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      const float2 back = __bfloat1622float2(h);
      hi[kk][r] = bits(h);
      lo[kk][r] = bits(__floats2bfloat162_rn(x - back.x, y - back.y));
    }
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(f[kk]);
}

// split_frags with hi = p truncated to bf16 (p's top 16 bits: one byte
// permute packs a pair) and lo = bf16(p - hi) (p - hi exact): one
// conversion a pair instead of two; |p - hi| < 2^-7 |p|, so |p - hi - lo|
// <= 2^-16 |p| (2^-17 with hi rounded).
__device__ __forceinline__ void split_trunc(const float (&a)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = a[8 * kk + 2 * r], y = a[8 * kk + 2 * r + 1];
      const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
      hi[kk][r] = __byte_perm(xb, yb, 0x7632);
      lo[kk][r] = bits(__floats2bfloat162_rn(
          x - __uint_as_float(xb & 0xffff0000u),
          y - __uint_as_float(yb & 0xffff0000u)));
    }
  }
}

// 2^x (ex2.approx: 2 units in the last place; 0 for x = -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The running extreme of a row's raw scores that scales to its largest
// scaled score: the max for scale >= 0, the min for scale < 0.
template <bool kMin>
__device__ __forceinline__ float extreme(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

// One 64-key tile of the overlap form's online softmax, in place: sc holds
// the warpgroup's raw scores q . k (accumulator layout: this thread rows
// r0 and r0 + 8, keys k0 + 8 g + 2 quad + (0, 1)) and becomes p; m is the
// rows' running extreme of the raw scores (extreme<kMin>), c = scale
// log2(e).  The scale is folded into the exponent: p = 2^(s c - m c), one
// FFMA and one ex2 a score.  Masked keys (past T, or past the row when
// causal, or with kWin at or below the row less its sliding window) never
// move the extreme and get p = 0.  Sets corr = 2^(m_old c - m_new c) and
// psum, the rows' sums of p.
template <bool kMin, bool kWin>
__device__ __forceinline__ void overlap_softmax(float (&sc)[32],
                                                float (&m)[2], float c,
                                                float m_init, int k0,
                                                int T_len, int row_lo,
                                                int r0, int quad, int causal,
                                                int window, float (&corr)[2],
                                                float (&psum)[2]) {
  bool edge = k0 + 64 > T_len || (causal && k0 + 63 > row_lo);
  if constexpr (kWin) edge = edge || k0 <= row_lo + 63 - window;
  auto masked = [&](int i) {
    const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
    bool out = kj >= T_len || (causal && kj > r0 + 8 * ((i >> 1) & 1));
    if constexpr (kWin) out = out || kj <= r0 + 8 * ((i >> 1) & 1) - window;
    return out;
  };
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (masked(i)) sc[i] = m_init;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = extreme<kMin>(mx[(i >> 1) & 1], sc[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = extreme<kMin>(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = extreme<kMin>(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mc[r] = mx[r] * c;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sc[i] = ex2(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (masked(i)) sc[i] = 0.0f;
  }
  psum[0] = psum[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) psum[(i >> 1) & 1] += sc[i];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    corr[r] = ex2(m[r] * c - mc[r]);
    m[r] = mx[r];
  }
}

// The forward at (64, 64) (FwdForm kOverlap).  A block owns 64 query rows
// a consumer warpgroup (blockDim.x = 128 warpgroups + 32) of one (b, h);
// the producer warp loads the q tile once and streams 64-key K and V
// tiles through a kOStages ring (K and V on barriers of their own); each
// consumer warpgroup owns 64 rows and walks the tiles with one product
// always in flight beside its softmax:
//   S_0 = Q K_0^T, wait, softmax -> P_0;
//   for j >= 1: issue S_j = Q K_j^T, issue acc += P_{j-1} V_{j-1} (hi and
//     lo), wait for S_j, softmax of S_j (P_{j-1} V_{j-1} still running),
//     wait for P V, free tile j - 1, acc *= corr_j, P_j = hi + lo;
//   acc += P_last V_last.
// acc is rescaled after P_{j-1} V_{j-1} lands and before P_j V_j is
// issued, the order of the other forms.  Causal: a warpgroup stops at its
// last row's diagonal tile; one with no row before S multiplies nothing.
// With kWin (a call's sliding window, window > 0: row r sees keys r -
// window < j <= r; its own instantiation, so calls without one run the
// code they ran before it) the block's walk starts at the tile holding its
// first row's first key, and each warpgroup's at the tile holding its own
// first row's (the block's rows span 192 queries, so its warpgroups start
// on different tiles); keys below a row's window are masked on the tiles
// that hold its lower edge, and a tile wholly below a warpgroup's windows
// is not multiplied.  Each warpgroup frees every tile of the block's walk
// it does not multiply once the tile has landed, so the ring's phases stay
// in step.
template <int DK, int DV, bool kWin>
__device__ __forceinline__ void flash_overlap(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    float* __restrict__ out, float* __restrict__ lse, int S, int T_len,
    int H, int rep, float scale, int causal, int window) {
  static_assert(DK == 64 && DV == 64, "the overlap form is (64, 64)'s");
  const int wgs = (blockDim.x - 32) / 128;   // consumer warpgroups, <= kOWGs
  const int BM = 64 * wgs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem + kOWGs * kOBox;    // the q tile first
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kOStages * 2 * kOBox);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kOStages;
  uint64_t* empty = vfull + kOStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kv_end = causal ? min(T_len, q0 + BM) : T_len;
  const int n_kv = (kv_end + 63) / 64;
  // The block's walk: tiles [j_lo, n_kv), the u-th (u = j - j_lo) on ring
  // stage u % kOStages.
  const int j_lo = kWin ? max(0, q0 - window + 1) / 64 : 0;
  const int warp = warp_index<true>();
  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < kOStages; ++s) {
      sm90::mbar_init(&kfull[s], 1);
      sm90::mbar_init(&vfull[s], 1);
      sm90::mbar_init(&empty[s], wgs);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * wgs) {                  // the producer
    if (threadIdx.x % 32 == 0) {
      const int kvh = h / rep;
      sm90::mbar_arrive_expect_tx(qbar, wgs * kOBox);
      for (int x = 0; x < wgs; ++x)
        sm90::tma_load_4d(smem + x * kOBox, &tq, qbar, 0, q0 + 64 * x, h, b);
      for (int j = j_lo; j < n_kv; ++j) {
        const int u = j - j_lo, s = u % kOStages;
        if (u >= kOStages)
          sm90::mbar_wait(&empty[s], (u / kOStages - 1) & 1);
        uint8_t* st = ring + s * 2 * kOBox;
        sm90::mbar_arrive_expect_tx(&kfull[s], kOBox);
        sm90::tma_load_4d(st, &tk, &kfull[s], 0, 64 * j, kvh, b);
        sm90::mbar_arrive_expect_tx(&vfull[s], kOBox);
        sm90::tma_load_4d(st + kOBox, &tv, &vfull[s], 0, 64 * j, kvh, b);
      }
    }
    return;
  }

  // Warpgroup wg owns rows [row_lo, row_lo + 64); this thread rows r0 and
  // r0 + 8 (index i / 2 of the accumulator layout) and columns 8 g + 2
  // quad + (0, 1).  It multiplies tiles [j_own, n_own).
  const int wg = warp / 4, lane = threadIdx.x % 32, quad = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  const int n_own = row_lo >= S ? j_lo
                    : causal    ? min(n_kv, row_lo / 64 + 1)
                                : n_kv;
  const int j_own = kWin && row_lo < S
                        ? max(j_lo, max(0, row_lo - window + 1) / 64)
                        : j_lo;
  const float c = scale * kLog2e;
  const bool neg = c < 0.0f;
  const float m_init = neg ? -kNegInf : kNegInf;
  float m[2] = {m_init, m_init}, l[2] = {0.0f, 0.0f};
  float acc[32], sc[32], corr[2], psum[2];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  const uint32_t qa = sm90::smem_u32(smem) + wg * kOBox;
  const uint32_t ra = sm90::smem_u32(ring);
  auto issue_s = [&](int j) {             // sc = Q K_j^T
    const int s = (j - j_lo) % kOStages;
    sm90::mbar_wait(&kfull[s], ((j - j_lo) / kOStages) & 1);
    sm90::wgmma_fence();
    const uint32_t kb = ra + s * 2 * kOBox;
    // The first step overwrites sc, so sc needs no zeroing.
    sm90::wgmma_m64n64k16_set<0, 0>(sc, sm90::desc_sw128(qa, 16, 1024),
                                    sm90::desc_sw128(kb, 16, 1024));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      sm90::wgmma_m64n64k16<0, 0>(sc, sm90::desc_sw128(qa + 32 * kk, 16, 1024),
                                  sm90::desc_sw128(kb + 32 * kk, 16, 1024));
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int j) {            // acc += P_hi V_j + P_lo V_j
    const int s = (j - j_lo) % kOStages;
    sm90::mbar_wait(&vfull[s], ((j - j_lo) / kOStages) & 1);
    sm90::wgmma_fence();
    const uint32_t vb = ra + s * 2 * kOBox + kOBox;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sm90::desc_sw128(vb + 2048 * kk, kOBox, 1024);
      sm90::wgmma_rs<64, 1>(acc, hi[kk], dv);
      sm90::wgmma_rs<64, 1>(acc, lo[kk], dv);
    }
    sm90::wgmma_commit();
  };
  auto softmax = [&](int j) {
    if (neg)
      overlap_softmax<true, kWin>(sc, m, c, m_init, 64 * j, T_len, row_lo,
                                  r0, quad, causal, window, corr, psum);
    else
      overlap_softmax<false, kWin>(sc, m, c, m_init, 64 * j, T_len, row_lo,
                                   r0, quad, causal, window, corr, psum);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
  };

  // Frees tile j unread once it has landed.
  auto release = [&](int j) {
    const int s = (j - j_lo) % kOStages;
    sm90::mbar_wait(&kfull[s], ((j - j_lo) / kOStages) & 1);
    sm90::mbar_wait(&vfull[s], ((j - j_lo) / kOStages) & 1);
    if (leader) sm90::mbar_arrive(&empty[s]);
  };

  for (int j = j_lo; j < j_own; ++j) release(j);   // below its windows
  if (n_own > j_own) {
    sm90::mbar_wait(qbar, 0);
    issue_s(j_own);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    softmax(j_own);
    split_trunc(sc, hi, lo);
    for (int j = j_own + 1; j < n_own; ++j) {
      issue_s(j);
      issue_pv(j - 1);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      softmax(j);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      fence_frags(hi);
      fence_frags(lo);
      if (leader) sm90::mbar_arrive(&empty[(j - 1 - j_lo) % kOStages]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
      split_trunc(sc, hi, lo);
    }
    issue_pv(n_own - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    fence_frags(hi);
    fence_frags(lo);
    if (leader) sm90::mbar_arrive(&empty[(n_own - 1 - j_lo) % kOStages]);
  }
  for (int j = n_own; j < n_kv; ++j) release(j);   // past its rows

  float* ob = out + static_cast<size_t>(bh) * S * DV + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    float* orow = ob + static_cast<size_t>(row) * DV;
#pragma unroll
    for (int g = 0; g < DV / 8; ++g)
      *reinterpret_cast<float2*>(orow + 8 * g) =
          make_float2(acc[4 * g + 2 * r] / denom,
                      acc[4 * g + 2 * r + 1] / denom);
    // The row's log-sum-exp of the scaled scores: its largest is m scale.
    if (lse != nullptr && quad == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[r] * scale + logf(denom);
  }
}

// The forward's plain and turns forms (hd 128 and MLA's widths).
template <int DK, int DV>
__device__ __forceinline__ void flash_tiles(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    float* __restrict__ out, float* __restrict__ lse, int S, int T_len,
    int H, int rep, float scale, int causal) {
  using Sh = FwdShape<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem + Sh::kQTile;      // the q tile first
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * Sh::kStage);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // Causal: only the tiles that start at or before the block's last row.
  const int kv_end = causal ? min(T_len, q0 + kBM) : T_len;
  const int n_kv = (kv_end + kBN - 1) / kBN;
  const int warp = warp_index<Sh::kForm == kTurns>();
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
      sm90::mbar_arrive_expect_tx(qbar, Sh::kQTile);
      for (int x = 0; x < Sh::kQB; ++x)
        sm90::tma_load_4d(smem + x * kBox, &tq, qbar, 64 * x, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) sm90::mbar_wait(&empty[s], (j / kStages - 1) & 1);
        uint8_t* st = ring + s * Sh::kStage;
        const int k0 = j * kBN;
        sm90::mbar_arrive_expect_tx(&kfull[s], Sh::kQTile);
        for (int x = 0; x < Sh::kQB; ++x)
          sm90::tma_load_4d(st + x * kBox, &tk, &kfull[s], 64 * x, k0, kvh, b);
        sm90::mbar_arrive_expect_tx(&vfull[s], Sh::kVTile);
        for (int x = 0; x < Sh::kVB; ++x)
          sm90::tma_load_4d(st + Sh::kQTile + x * kBox, &tv, &vfull[s],
                            64 * x, k0, kvh, b);
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
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  const uint32_t qa = sm90::smem_u32(smem) + wg * 64 * 128;
  sm90::mbar_wait(qbar, 0);
  if constexpr (Sh::kForm == kTurns) {
    if (wg == 1) turn_pass(wg);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t kb = sm90::smem_u32(ring + s * Sh::kStage);
    const uint32_t vb = kb + Sh::kQTile;
    const int k0 = j * kBN;

    // S = Q K^T: dk in steps of 16, each next 64 columns one box on.
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    sm90::fence_regs(sc);
    sm90::mbar_wait(&kfull[s], phase);
    if constexpr (Sh::kForm == kTurns) turn_wait(wg);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      sm90::wgmma_m64n128k16<0, 0>(sc, sm90::desc_sw128(qa + off, 16, 1024),
                                   sm90::desc_sw128(kb + off, 16, 1024));
    }
    sm90::wgmma_commit();
    if constexpr (Sh::kForm == kTurns) turn_pass(wg);
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
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

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

    // acc += hi V + lo V: keys in 8 steps of 16 (2048 bytes each), n = dv,
    // V N-major with each next 64 columns one box on.
    sm90::mbar_wait(&vfull[s], phase);
    if constexpr (Sh::kForm == kTurns) turn_wait(wg);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = sm90::desc_sw128(vb + 2048 * kk, kBox, 1024);
      sm90::wgmma_rs<DV, 1>(acc, hi[kk], dv);
      sm90::wgmma_rs<DV, 1>(acc, lo[kk], dv);
    }
    sm90::wgmma_commit();
    if constexpr (Sh::kForm == kTurns) {
      if (wg == 0 || j + 1 < n_kv) turn_pass(wg);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      sm90::fence_regs(hi[kk]);
      sm90::fence_regs(lo[kk]);
    }
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
  }

  float* ob = out + static_cast<size_t>(bh) * S * DV + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    float* orow = ob + static_cast<size_t>(row) * DV;
#pragma unroll
    for (int g = 0; g < DV / 8; ++g)
      *reinterpret_cast<float2*>(orow + 8 * g) =
          make_float2(acc[4 * g + 2 * r] / denom,
                      acc[4 * g + 2 * r + 1] / denom);
    // The row's log-sum-exp of the scaled scores, for the backward (m and
    // l are the same on the four lanes of the row's quad).
    if (lse != nullptr && quad == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[r] + logf(denom);
  }
}

template <int DK, int DV, bool kWin>
__global__ void __launch_bounds__(FwdShape<DK, DV>::kThreads, 1)
flash_wgmma(__grid_constant__ const CUtensorMap tq,
            __grid_constant__ const CUtensorMap tk,
            __grid_constant__ const CUtensorMap tv, float* __restrict__ out,
            float* __restrict__ lse, int S, int T_len, int H, int rep,
            float scale, int causal, int window) {
  if constexpr (FwdShape<DK, DV>::kForm == kOverlap)
    flash_overlap<DK, DV, kWin>(tq, tk, tv, out, lse, S, T_len, H, rep,
                                scale, causal, window);
  else
    flash_tiles<DK, DV>(tq, tk, tv, out, lse, S, T_len, H, rep, scale,
                        causal);
}

// ---- float32 at every width, and bf16 at those without wgmma: CUDA cores --
constexpr int kFBQ = 64;
constexpr int kFBK = 64;
constexpr int kFThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <int DK, int DV>
constexpr size_t fma_smem() {
  return sizeof(float) *
         (2 * 64 * (DK + 1) + 64 * (DV + 1) + 64 * (kFBK + 1));
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kFThreads)
flash_fma(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, float* __restrict__ out, Strides st,
          int S, int T_len, int H, int rep, float scale, int causal,
          int window) {
  constexpr int LDK = DK + 1;
  constexpr int LDV = DV + 1;
  constexpr int LP = kFBK + 1;
  constexpr int DPT = DV / 4;        // accumulator columns a thread owns
  constexpr int SPT = kFBK / 4;      // scores a thread computes a tile
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kFBQ][LDK]
  float* Ks = Qs + kFBQ * LDK;       // [kFBK][LDK]
  float* Vs = Ks + kFBK * LDK;       // [kFBK][LDV]
  float* Ps = Vs + kFBK * LDV;       // [kFBQ][LP]

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

  for (int i = tid; i < kFBQ * DK; i += kFThreads) {
    const int rr = i / DK, c = i % DK;
    const int qi = q0 + rr;
    Qs[rr * LDK + c] = qi < S ? to_float(qp[qi * st.q[2] + c]) * scale : 0.0f;
  }

  const int qrow = q0 + r;
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;

  // Causal: only the tiles that start at or before the last query row;
  // with a window, from the tile holding the first row's first key.
  const int kv_end = causal ? min(T_len, q0 + kFBQ) : T_len;
  const int kv_start = window > 0 ? max(0, q0 - window + 1) / kFBK * kFBK : 0;
  for (int k0 = kv_start; k0 < kv_end; k0 += kFBK) {
    __syncthreads();   // the q tile is in; the last tile's readers are done
    for (int i = tid; i < kFBK * DK; i += kFThreads) {
      const int rr = i / DK, c = i % DK;
      const int kj = k0 + rr;
      Ks[rr * LDK + c] = kj < T_len ? to_float(kp[kj * st.k[2] + c]) : 0.0f;
    }
    for (int i = tid; i < kFBK * DV; i += kFThreads) {
      const int rr = i / DV, c = i % DV;
      const int kj = k0 + rr;
      Vs[rr * LDV + c] = kj < T_len ? to_float(vp[kj * st.v[2] + c]) : 0.0f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < DK; ++d) {
      const float qd = Qs[r * LDK + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        s[j] = fmaf(qd, Ks[(t + 4 * j) * LDK + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const bool ok = kj < T_len && (!causal || kj <= qrow) &&
                      (window == 0 || kj > qrow - window);
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
        acc[d] = fmaf(p, Vs[j * LDV + t + 4 * d], acc[d]);
    }
  }

  if (qrow < S) {
    const float denom = fmaxf(l, 1e-20f);
    float* op = out + (static_cast<size_t>(bh) * S + qrow) * DV;
#pragma unroll
    for (int d = 0; d < DPT; ++d) op[t + 4 * d] = acc[d] / denom;
  }
}

// ---- the backward, "fma" route: float32 on the CUDA cores ----------------
// (float32, bf16 at the widths without the wgmma backward, and bf16 that
// TMA cannot map.)  Templated on
// (dk, dv) as flash_fma; the comments below say hd where dk = dv.
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
// training shape (B 4, H 16, S 512, hd 128) the operations bound it; that
// call now takes the wgmma route (below).
constexpr int kBB = 64;               // rows a tile, both kernels
constexpr int kBThreads = 256;

// q and k rows are DK wide (padded by one word), v, out and dO rows DV.
template <int DK, int DV>
constexpr size_t bwd_dq_smem() {
  return sizeof(float) *
         (2 * kBB * (DK + 1) + 2 * kBB * (DV + 1) + kBB * (kBB + 1));
}

template <int DK, int DV>
constexpr size_t bwd_dkv_smem() {
  return sizeof(float) * (2 * kBB * (DK + 1) + 2 * kBB * (DV + 1) +
                          2 * kBB * (kBB + 1) + 2 * kBB);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ ws, Strides st, int S, int T_len, int H,
             int rep, float scale, int causal, int window, int BHS) {
  constexpr int LDK = DK + 1;
  constexpr int LDV = DV + 1;
  constexpr int LP = kBB + 1;
  constexpr int DPK = DK / 4;        // dQ columns a thread owns
  constexpr int DPV = DV / 4;
  constexpr int SPT = kBB / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBB][LDK], scale q
  float* dOs = Qs + kBB * LDK;       // [kBB][LDV]
  float* Ks = dOs + kBB * LDV;       // [kBB][LDK]
  float* Vs = Ks + kBB * LDK;        // [kBB][LDV]
  float* Ps = Vs + kBB * LDV;        // [kBB][LP], dS

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

  for (int i = tid; i < kBB * DK; i += kBThreads) {
    const int rr = i / DK, c = i % DK;
    const int qi = q0 + rr;
    Qs[rr * LDK + c] = qi < S ? to_float(qp[qi * st.q[2] + c]) * scale : 0.0f;
  }
  for (int i = tid; i < kBB * DV; i += kBThreads) {
    const int rr = i / DV, c = i % DV;
    const int qi = q0 + rr;
    dOs[rr * LDV + c] = qi < S ? dout[(row0 + qi) * DV + c] : 0.0f;
  }
  const int qrow = q0 + r;
  const int kv_end = causal ? min(T_len, q0 + kBB) : T_len;
  const int kv_start = window > 0 ? max(0, q0 - window + 1) / kBB * kBB : 0;

  // Pass 1: the row's max and sum, as the forward takes them.
  float m = kNegInf, l = 0.0f;
  for (int k0 = kv_start; k0 < kv_end; k0 += kBB) {
    __syncthreads();
    for (int i = tid; i < kBB * DK; i += kBThreads) {
      const int rr = i / DK, c = i % DK;
      const int kj = k0 + rr;
      Ks[rr * LDK + c] = kj < T_len ? to_float(kp[kj * st.k[2] + c]) : 0.0f;
    }
    __syncthreads();
    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < DK; ++d) {
      const float qd = Qs[r * LDK + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        s[j] = fmaf(qd, Ks[(t + 4 * j) * LDK + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const bool ok = kj < T_len && (!causal || kj <= qrow) &&
                      (window == 0 || kj > qrow - window);
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
    const float* orow = o + (row0 + qrow) * DV;
#pragma unroll
    for (int c = 0; c < DPV; ++c)
      dd = fmaf(dOs[r * LDV + t + 4 * c], orow[t + 4 * c], dd);
  }
  dd += __shfl_xor_sync(0xffffffffu, dd, 1);
  dd += __shfl_xor_sync(0xffffffffu, dd, 2);
  if (qrow < S && t == 0) {
    ws[row0 + qrow] = lse;
    ws[BHS + row0 + qrow] = dd;
  }

  // Pass 2: dS row by row, dQ += dS k.
  float acc[DPK];
#pragma unroll
  for (int c = 0; c < DPK; ++c) acc[c] = 0.0f;
  for (int k0 = kv_start; k0 < kv_end; k0 += kBB) {
    __syncthreads();
    for (int i = tid; i < kBB * DK; i += kBThreads) {
      const int rr = i / DK, c = i % DK;
      const int kj = k0 + rr;
      Ks[rr * LDK + c] = kj < T_len ? to_float(kp[kj * st.k[2] + c]) : 0.0f;
    }
    for (int i = tid; i < kBB * DV; i += kBThreads) {
      const int rr = i / DV, c = i % DV;
      const int kj = k0 + rr;
      Vs[rr * LDV + c] = kj < T_len ? to_float(vp[kj * st.v[2] + c]) : 0.0f;
    }
    __syncthreads();
    float s[SPT], dp[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < DK; ++d) {
      const float qd = Qs[r * LDK + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        s[j] = fmaf(qd, Ks[(t + 4 * j) * LDK + d], s[j]);
    }
    for (int d = 0; d < DV; ++d) {
      const float gd = dOs[r * LDV + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        dp[j] = fmaf(gd, Vs[(t + 4 * j) * LDV + d], dp[j]);
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kj = k0 + t + 4 * j;
      const bool ok = qrow < S && kj < T_len && (!causal || kj <= qrow) &&
                      (window == 0 || kj > qrow - window);
      const float p = ok ? expf(s[j] - lse) : 0.0f;
      Ps[r * LP + t + 4 * j] = p * (dp[j] - dd);
    }
    __syncwarp();      // the row's four threads share one warp
    for (int j = 0; j < kBB; ++j) {
      const float ds = Ps[r * LP + j];
#pragma unroll
      for (int c = 0; c < DPK; ++c)
        acc[c] = fmaf(ds, Ks[j * LDK + t + 4 * c], acc[c]);
    }
  }
  if (qrow < S) {
    T* drow = dq + (row0 + qrow) * DK;
#pragma unroll
    for (int c = 0; c < DPK; ++c) store(drow + t + 4 * c, acc[c] * scale);
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kBThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ ws, T* __restrict__ dk,
              T* __restrict__ dv, Strides st, int S, int T_len, int H,
              int KV, int rep, float scale, int causal, int window,
              int BHS) {
  constexpr int LDK = DK + 1;
  constexpr int LDV = DV + 1;
  constexpr int LP = kBB + 1;
  constexpr int DPK = DK / 4;
  constexpr int DPV = DV / 4;
  constexpr int SPT = kBB / 4;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [kBB][LDK]
  float* Vs = Ks + kBB * LDK;        // [kBB][LDV]
  float* Qs = Vs + kBB * LDV;        // [kBB][LDK], scale q
  float* dOs = Qs + kBB * LDK;       // [kBB][LDV]
  float* Ps = dOs + kBB * LDV;       // [kBB keys][LP]: P^T
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

  for (int i = tid; i < kBB * DK; i += kBThreads) {
    const int rr = i / DK, cc = i % DK;
    const int kj = k0 + rr;
    Ks[rr * LDK + cc] = kj < T_len ? to_float(kp[kj * st.k[2] + cc]) : 0.0f;
  }
  for (int i = tid; i < kBB * DV; i += kBThreads) {
    const int rr = i / DV, cc = i % DV;
    const int kj = k0 + rr;
    Vs[rr * LDV + cc] = kj < T_len ? to_float(vp[kj * st.v[2] + cc]) : 0.0f;
  }
  const int krow = k0 + c;
  float adk[DPK], adv[DPV];
#pragma unroll
  for (int d = 0; d < DPK; ++d) adk[d] = 0.0f;
#pragma unroll
  for (int d = 0; d < DPV; ++d) adv[d] = 0.0f;

  // Causal: query tiles from the one holding the diagonal (tiles align);
  // with a window, up to the last query that sees the tile's last key.
  const int q_start = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kBB - 1 + window) : S;
  for (int g = 0; g < rep; ++g) {
    const int h = kvh * rep + g;
    const T* qp = q + b * st.q[0] + h * st.q[1];
    const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = q_start; q0 < q_end; q0 += kBB) {
      __syncthreads();   // the last tile's readers are done
      for (int i = tid; i < kBB * DK; i += kBThreads) {
        const int rr = i / DK, cc = i % DK;
        const int qi = q0 + rr;
        Qs[rr * LDK + cc] = qi < S ? to_float(qp[qi * st.q[2] + cc]) * scale
                                   : 0.0f;
      }
      for (int i = tid; i < kBB * DV; i += kBThreads) {
        const int rr = i / DV, cc = i % DV;
        const int qi = q0 + rr;
        dOs[rr * LDV + cc] = qi < S ? dout[(row0 + qi) * DV + cc] : 0.0f;
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
      for (int d = 0; d < DK; ++d) {
        const float kd = Ks[c * LDK + d];
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          s[j] = fmaf(Qs[(t + 4 * j) * LDK + d], kd, s[j]);
      }
      for (int d = 0; d < DV; ++d) {
        const float vd = Vs[c * LDV + d];
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          dp[j] = fmaf(dOs[(t + 4 * j) * LDV + d], vd, dp[j]);
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = t + 4 * j;
        const int qi = q0 + i;
        const bool ok = qi < S && krow < T_len && (!causal || krow <= qi) &&
                        (window == 0 || krow > qi - window);
        const float p = ok ? expf(s[j] - lses[i]) : 0.0f;
        Ps[c * LP + i] = p;
        Ds[c * LP + i] = p * (dp[j] - dds[i]);
      }
      __syncwarp();    // the key row's four threads share one warp
      for (int i = 0; i < kBB; ++i) {
        const float p = Ps[c * LP + i];
        const float ds = Ds[c * LP + i];
#pragma unroll
        for (int d = 0; d < DPV; ++d)
          adv[d] = fmaf(p, dOs[i * LDV + t + 4 * d], adv[d]);
#pragma unroll
        for (int d = 0; d < DPK; ++d)
          adk[d] = fmaf(ds, Qs[i * LDK + t + 4 * d], adk[d]);
      }
    }
  }
  if (krow < T_len) {
    const size_t row = (static_cast<size_t>(b) * KV + kvh) * T_len + krow;
#pragma unroll
    for (int d = 0; d < DPK; ++d) store(dk + row * DK + t + 4 * d, adk[d]);
#pragma unroll
    for (int d = 0; d < DPV; ++d) store(dv + row * DV + t + 4 * d, adv[d]);
  }
}

// ---- the backward, bf16 at the forward's wgmma widths: wgmma on TMA rings -
// The same function as the fma pair above, for bf16 q, k, v at those widths
// whose strides TMA can map (the models' training calls), templated on
// (dk, dv) as the forward: q and K rows in 64-column boxes, the last past
// dk read as zeros; dK and dQ are m64n96 products at dk 96 (their N-major
// operand spans a box and half the next: no column multiplies the
// zeros).  At
// (192, 128) the dK and dQ accumulators (m64n192: 96 registers a thread)
// beside S, dP and the fragments do not fit the 168 registers a thread of
// a 288-thread block may hold: those blocks take a whole producer
// warpgroup (384 threads) that gives its registers to the consumers by
// setmaxnreg (24 / 240; BwdShape::kRegs).  Three launches (the comments
// say hd where dk = dv = 128):
//   flash_bwd_prep  a warp a row: D_i = sum_d dO out (float32, as the fma
//                   pair), dO split into bf16 hi = bf16(dO) and lo =
//                   bf16(dO - hi) ([B, H, S, hd] each; dO - hi is exact in
//                   float32, as P's split in flash_wgmma), and the forward's
//                   lse and D copied to rows padded to Sp (a multiple of
//                   128): lse = +inf and D = 0 past S, so a query past S
//                   gets P = 0 with no mask.  Once a call, not once a tile;
//   flash_bwd_dkv_wgmma  a block a (b, KV head, 64 keys; 128 at (96, 64),
//                   below; at (192, 128) a block an SM walking such items,
//                   below), the heaviest
//                   causal key tiles first: K and V loaded once by TMA
//                   through 4-D maps of the tensors' own strides, then for
//                   each of the rep query heads the 64-query tiles from the
//                   diagonal on, Q, dO hi and dO lo streamed through a
//                   2-stage ring on mbarriers by a producer warp.  Two
//                   consumer warpgroups share the block's 64 keys, per tile:
//                     wg 0: S^T = K Q^T (both K-major, scaled after the
//                     product), P^T = exp(S^T - lse) (the mask, -2^30, only
//                     on the tile that holds the diagonal), P^T to shared
//                     memory for wg 1, dV += P_hi^T dO_hi + P_lo^T dO_hi +
//                     P_hi^T dO_lo;
//                     wg 1: dP^T = V dO_hi^T + V dO_lo^T, dS^T = P^T (dP^T
//                     - D) with wg 0's P^T, dK += dS_hi^T Q + dS_lo^T Q;
//                   P^T and dS^T split into bf16 hi + lo and packed straight
//                   from the accumulators into register A fragments (RS
//                   form), dO and Q N-major (transpose bit set).  P^T passes
//                   through two float32 buffers (a thread's entries as
//                   float4s), ordered by named barriers (bar.arrive /
//                   bar.sync 1-4: full and free, a buffer each).  dV and
//                   dK (times scale) stay in registers for the whole walk
//                   and are written once in k's dtype.  At hd 128 ptxas
//                   serializes this kernel's wgmma (its two warpgroups
//                   issue different products in the two arms of one branch
//                   on a warp index it cannot prove uniform); at (192,
//                   128) the index is made warp-uniform (a shuffle) and it
//                   does not.  At (192, 128) (BwdShape::kPersist) the grid
//                   is one block an SM, each walking its share of the
//                   items (dealt round by round, heaviest first, in
//                   alternating order) with K and V in two buffers, so the
//                   next item's K, V and first ring tiles load while this
//                   item's last tiles run: short causal items (4.5 tiles
//                   on average at S 512) no longer start from an empty
//                   ring.  At (96, 64) and (64, 64) (BwdShape::kOwnKeys)
//                   a block owns 128 keys instead, on a 3-stage ring
//                   (384 threads at (96, 64), 288 at (64, 64)): each
//                   consumer warpgroup does all five products for its own
//                   64 keys (no branch between them, no P^T through shared
//                   memory, equal work), so Q, dO hi and dO lo stream
//                   through the ring once for 128 keys.  At (64, 64) each
//                   ring tile also brings its 64 rows of lse and D (a bulk
//                   copy each: kStageLD), read from shared memory instead
//                   of from L2 after S^T lands;
//   flash_bwd_dq_wgmma  a block a (b, h, 128 queries; 192 at (64, 64)), the
//                   heaviest causal query tiles first: Q, dO hi and dO lo
//                   loaded once, the 64-key K and V tiles up to the
//                   diagonal streamed through a 2-stage ring by a producer
//                   warp; two consumer warpgroups (three at (64, 64):
//                   BwdShape::kQWGs) of 64 queries compute S = Q K^T, dP =
//                   dO_hi V^T + dO_lo V^T, P, dS (the mask on diagonal and
//                   ragged tiles) and dQ += dS_hi K + dS_lo K (K N-major),
//                   written once (times scale) in q's dtype.  At (192, 128)
//                   (BwdShape::kPSmem) S is taken alone and P parked in the
//                   thread's own float32 slots of shared memory before dP
//                   is issued, so dQ (96 registers) never sits beside two
//                   64 x 64 tiles.
// No atomics: each gradient is summed in one block, dK and dV over the
// query heads of their KV head, so two calls give the same bits.  A tile
// whose queries all precede a warpgroup's keys (dkv) or whose keys all
// follow its queries (dq) is skipped by that warpgroup.  The exponentials
// are expf (2 units in the last place, inside check_flash_bwd's 2^-21); at
// (64, 64) ex2 of one FFMA (kEx2).
// Register budget: ptxas gives a thread of these 288- and 384-thread
// blocks at most 168 registers (it counts warpgroups: 3 x 128 threads), and
// setmaxnreg's 240 does not lift that for the consumers.  One warpgroup
// holding both dK and dV (two 64 x 128 float32 accumulators, 128 registers)
// beside S^T and dP^T needed 255 and still spilled, with or without
// setmaxnreg; so each dkv warpgroup holds one accumulator (64; 96 for dK
// at dk 192) beside one 64 x 64 tile (32) and its fragments (32), and the
// two split the tile's work evenly (8 hd a pair each).  The price: a block
// owns 64 keys, not 128, so Q and dO stream through the ring twice as
// often (from L2); sharing each tile between two such blocks of a cluster
// by TMA multicast took longer at (192, 128) (kernel_variants.py k5bwd;
// PERF.md).  At (96, 64) both accumulators of a warpgroup's 64 keys are
// small (dV 32, dK 48 registers), so a warpgroup holds both, at the price
// of ~300 bytes of spills.  The dq warpgroup holds dQ (64), S and dP (32
// each); at (192, 128) dQ is 96, and S and dP beside it serialized the
// wgmma for want of registers until P went through shared memory (kPSmem:
// dQ and one tile, ~140).  At (64, 64) a warpgroup holds dV and dK (32
// each) beside S^T, dP^T and their fragments in 168 registers unspilled in
// a 288-thread block; walking 128-key items persistently, as (192, 128)
// does, saved 2% and spilled 4 bytes, and taking turns on the tensor
// cores (named barriers, as the forward's MLA form) or committing S^T
// apart from dP^T to take P^T while dP^T runs saved nothing.  In dq,
// issuing the next tile's S and dP before this tile's dQ (168 registers)
// took longer; with kEx2 dq needs 122 registers, so a block holds three
// consumer warpgroups.  Per
// visible (query, key) pair the kernels do 26 hd bf16 tensor-core
// operations: dkv 2 hd for
// S^T, 4 for dP^T, 6 for dV and 4 for dK; dq S and dP again (6) and 4 for
// dQ.  The bound counts the products
// once: 20 hd a pair at the bf16 tensor-core rate (chip_smoke.py
// k5_bwd_bound), against q, k, v, out, dout and lse read and dq, dk, dv
// written once.
constexpr int kRows = 64;                     // a warpgroup's rows, a ring tile
constexpr int kBlockRows = 128;               // lse and D rows pad to it
constexpr uint32_t kBox64 = 64 * 128;         // 64 rows x 64 bf16, 8 KB
constexpr int kBStages = 2;
constexpr int kPBuf = 32 * 128;               // P^T of a tile, float32

// The backward's tiles at (DK, DV): q and k rows in kQB 64-column boxes
// (past DK read as zeros), v and dO rows in kVB.  dK and dQ are products
// with N = NQ: whole boxes at DK 64 kQB, and N = 96 at DK 96 (the N-major
// operand spans a box and the first half of the next, the descriptor's
// stride between boxes carrying the step), so no column multiplies the
// zeros.  At (64, 64) every tile is one box; dkv owns 128 keys (kOwnKeys)
// in a 288-thread block, dq has three consumer warpgroups (or two:
// block_wgs).
template <int DK, int DV>
struct BwdShape {
  static_assert(DK % 16 == 0 && (DV == 64 || DV == 128), "wgmma widths");
  static constexpr int kQB = (DK + 63) / 64;
  static constexpr int kVB = DV / 64;
  static constexpr int NQ = DK == 96 ? 96 : 64 * kQB;
  static_assert(NQ == 64 || NQ == 96 || NQ == 128 || NQ == 192,
                "dK and dQ are m64n64, m64n96, m64n128 or m64n192");
  // At NQ 192 the dK and dQ accumulators (96 registers a thread) do not fit
  // beside S, dP and the fragments in the 168 registers a thread of a
  // 288-thread block may hold: the block takes a whole producer warpgroup
  // (384 threads) that gives its registers to the two consumer warpgroups
  // (setmaxnreg: 24 for the producer, 240 for each consumer).
  static constexpr bool kRegs = NQ > 128;
  // dq's consumer warpgroups of 64 queries: three at (64, 64) (its 122
  // registers leave room for a 416-thread block; two where that leaves
  // fewer waves: block_wgs), else two.
  static constexpr int kQWGs = DK == 64 && DV == 64 ? 3 : 2;
  static constexpr int kQRows = 64 * kQWGs;   // dq: a block's own queries
  static constexpr int kQBoxRows = kQWGs == 2 ? kQRows : 64;
  static constexpr int kThreads = kRegs ? 384 : 128 * kQWGs + 32;
  // dkv at (96, 64) and (64, 64) (kOwnKeys): a block of 128 keys, each
  // consumer warpgroup all five products for its own 64 (dV 32 and dK 48
  // or 32 accumulator registers beside S^T, dP^T and their fragments); at
  // (96, 64) in a 384-thread block under setmaxnreg (ptxas still caps a
  // thread at 168 registers and spills ~300 bytes; the 288-thread block
  // took longer: kernel_variants.py k5bwd), at (64, 64) in a 288-thread
  // block (unspilled; 384 threads spilled 4 bytes for no gain); elsewhere
  // a block of 64 keys whose two warpgroups split a tile's products.
  static constexpr bool kOwnKeys = DV == 64 && (DK == 96 || DK == 64);
  static constexpr int kKeys = kOwnKeys ? 128 : 64;
  // dkv at (192, 128) (kPersist): one block an SM walks its share of the
  // (b, KV head, 64 keys) items (below), K and V double-buffered so that
  // the next item's load and its first ring tiles overlap this item's
  // last tiles.  (At (64, 64) the walk of 128-key items saved 2% and
  // spilled 4 bytes: kernel_variants.py k5bwd; PERF.md.)
  static constexpr bool kPersist = DK == 192;
  static constexpr int kKVBufs = kPersist ? 2 : 1;
  static constexpr bool kKVRegs = kRegs || (kOwnKeys && DK == 96);
  // At (64, 64) dkv's ring tiles bring their lse and D into shared memory
  // (kStageLD: read there, not from L2 after S^T lands).
  static constexpr bool kStageLD = DK == 64 && DV == 64;
  // At (64, 64) P (P^T) = 2^(s scale log2(e) - lse log2(e)), one FFMA and
  // one ex2 (2 units in the last place) instead of expf's ~10
  // instructions: other bits, within check_flash_bwd's wgmma bound
  // (kEx2; tests/test_torch_fwd_overlap.py emulates it).
  static constexpr bool kEx2 = DK == 64 && DV == 64;
  static constexpr int kKVThreads = kKVRegs ? 384 : 288;
  static constexpr int kKVStages = kOwnKeys ? 3 : kBStages;
  static constexpr int kPBufs = 2;        // P^T's buffers (not kOwnKeys)
  // dkv: kKVBufs buffers of K and V of an item's keys (boxes of kKeys
  // rows), a ring of Q, dO hi, dO lo tiles of 64 queries, P^T's buffers
  // (not kOwnKeys); barriers: a full one a K / V buffer (and a free one
  // with kPersist), a full and an empty one a stage.
  static constexpr uint32_t kKBox = kKeys * 128;
  static constexpr uint32_t kKTile = kQB * kKBox;
  static constexpr uint32_t kVTile = kVB * kKBox;
  static constexpr uint32_t kKTile64 = kQB * kBox64;
  static constexpr uint32_t kVTile64 = kVB * kBox64;
  static constexpr uint32_t kKVStage = kKTile64 + 2 * kVTile64;
  static constexpr uint32_t kPBytes = kOwnKeys ? 0 : kPBufs * kPBuf * 4;
  static constexpr uint32_t kLDBytes = kStageLD ? 2 * kRows * 4 : 0;
  static constexpr uint32_t kKV = kKTile + kVTile;
  static constexpr int kKVBars = (kPersist ? 2 : 1) * kKVBufs + 2 * kKVStages;
  static constexpr size_t kKVSmem = kKVBufs * kKV + kKVStages * kKVStage +
                                    kKVStages * kLDBytes + kPBytes +
                                    kKVBars * 8 + 1024;
  // dq: Q, dO hi, dO lo of the block's kQRows queries, a ring of K, V tiles
  // of 64 keys; at (192, 128) (kPSmem) also a float32 buffer of P a consumer
  // warpgroup, each thread's 32 entries in slots of its own (below).
  static constexpr bool kPSmem = NQ > 128;
  static constexpr uint32_t kQStage = kKTile64 + kVTile64;
  static constexpr uint32_t kQPBytes = kPSmem ? 2 * kPBuf * 4 : 0;
  static constexpr uint32_t kQBox = kQRows * 128;   // kQRows x 64 bf16
  static constexpr size_t kQSmem = kQB * kQBox + 2 * kVB * kQBox +
                                   kBStages * kQStage + kQPBytes +
                                   (1 + 2 * kBStages) * 8 + 1024;
  static constexpr int kAcc = (NQ > DV ? NQ : DV) / 2;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// A warp a row of DV columns, DV / 32 a lane (DV 64 or 128).
template <int DV>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const float* __restrict__ out, const float* __restrict__ dout,
               const float* __restrict__ lse, bf16* __restrict__ dhi,
               bf16* __restrict__ dlo, float* __restrict__ lse_p,
               float* __restrict__ d_p, int S, int Sp, long long rows) {
  constexpr int E = DV / 32;
  sm90::griddep_launch();
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / Sp;
  const int i = static_cast<int>(row % Sp);
  if (i >= S) {
    if (lane == 0) {
      lse_p[row] = pos_inf();
      d_p[row] = 0.0f;
    }
    return;
  }
  const size_t at = (static_cast<size_t>(bh) * S + i) * DV + E * lane;
  float o[E], g[E];
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const float2 ov = *reinterpret_cast<const float2*>(out + at + e);
    const float2 gv = *reinterpret_cast<const float2*>(dout + at + e);
    o[e] = ov.x, o[e + 1] = ov.y, g[e] = gv.x, g[e + 1] = gv.y;
  }
  float dd = g[0] * o[0];
#pragma unroll
  for (int e = 1; e < E; ++e) dd = fmaf(g[e], o[e], dd);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dd += __shfl_xor_sync(0xffffffffu, dd, off);
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(g[e], g[e + 1]);
    const float2 bk = __bfloat1622float2(h);
    *reinterpret_cast<__nv_bfloat162*>(dhi + at + e) = h;
    *reinterpret_cast<__nv_bfloat162*>(dlo + at + e) =
        __floats2bfloat162_rn(g[e] - bk.x, g[e + 1] - bk.y);
  }
  if (lane == 0) {
    lse_p[row] = lse[static_cast<size_t>(bh) * S + i];
    d_p[row] = dd;
  }
}

template <int DK, int DV, bool kWin>
__global__ void __launch_bounds__(BwdShape<DK, DV>::kKVThreads, 1)
flash_bwd_dkv_wgmma(__grid_constant__ const CUtensorMap tq,
                    __grid_constant__ const CUtensorMap tk,
                    __grid_constant__ const CUtensorMap tv,
                    __grid_constant__ const CUtensorMap tdh,
                    __grid_constant__ const CUtensorMap tdl,
                    const float* __restrict__ lse_p,
                    const float* __restrict__ d_p, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int Sp, int T_len, int H,
                    int KV, int BKV, float scale, int causal, int window) {
  using Sh = BwdShape<DK, DV>;
  // kWin: a call's sliding window (window > 0), its own instantiation at
  // (64, 64) only (the wrapper refuses it elsewhere), so calls without one
  // run the code they ran before it.
  constexpr int St = Sh::kKVStages;
  constexpr int KB = Sh::kKVBufs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  // K / V buffer x: K [kKeys][dk] (kQB boxes) at smem + x kKV, then V
  // [kKeys][dv] (kVB boxes).
  uint8_t* ring = smem + KB * Sh::kKV;    // stages of Q, dO hi, dO lo
  // kStageLD: stage s's lse and D (64 floats each) at ldb + 128 s.
  float* ldb = reinterpret_cast<float*>(ring + St * Sh::kKVStage);
  float* pbuf = ldb + St * Sh::kLDBytes / 4;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(pbuf) + Sh::kPBytes / 8;
  uint64_t* kvfree = kvbar + KB;          // kPersist
  uint64_t* full = kvfree + (Sh::kPersist ? KB : 0);
  uint64_t* empty = full + St;

  const int rep = H / KV;
  // The block's items, each the kKeys keys k0 of one (b, KV head) and, for
  // each of its rep query heads, the n_q 64-query tiles from q_start on
  // (causal: from the one holding the diagonal; with a window, up to the
  // last query that sees the item's last key).  Block (x, y) owns key
  // block y of (b, KV head) x; with kPersist the grid is one-dimensional and
  // block g takes items n G + g (n even) and n G + G - 1 - g (n odd) of
  // all n_kb BKV, key block major (the heaviest causal items first).
  struct Item {
    int b, kvh, k0, q_start, n_q;
  };
  const int n_kb = (T_len + Sh::kKeys - 1) / Sh::kKeys;
  auto item = [&](int n, Item& it) {
    int i;
    if constexpr (Sh::kPersist) {
      const int G = gridDim.x, g = blockIdx.x;
      i = n * G + (n & 1 ? G - 1 - g : g);
      if (i >= n_kb * BKV) return false;
    } else {
      if (n > 0) return false;
      i = blockIdx.y * BKV + blockIdx.x;
    }
    it.b = i % BKV / KV;
    it.kvh = i % BKV % KV;
    it.k0 = i / BKV * Sh::kKeys;
    it.q_start = causal ? it.k0 : 0;
    it.n_q = (S - it.q_start + kRows - 1) / kRows;
    if constexpr (kWin)
      it.n_q = (min(S, it.k0 + Sh::kKeys - 1 + window) - it.q_start +
                kRows - 1) / kRows;
    return true;
  };
  const int warp = warp_index<DK != 128>();
  if (threadIdx.x == 0) {
    for (int x = 0; x < KB; ++x) {
      sm90::mbar_init(&kvbar[x], 1);
      if constexpr (Sh::kPersist) sm90::mbar_init(&kvfree[x], 2);
    }
    for (int s = 0; s < St; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::griddep_launch();

  if (warp >= 8) {                        // the producer
    if constexpr (Sh::kKVRegs) sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      Item it;
      for (int n = 0, j = 0; item(n, it); ++n) {
        const int x = n % KB;
        if (n >= KB) sm90::mbar_wait(&kvfree[x], (n / KB - 1) & 1);
        uint8_t* ks = smem + x * Sh::kKV;
        sm90::mbar_arrive_expect_tx(&kvbar[x], Sh::kKV);
        for (int c = 0; c < Sh::kQB; ++c)
          sm90::tma_load_4d(ks + c * Sh::kKBox, &tk, &kvbar[x], 64 * c, it.k0,
                            it.kvh, it.b);
        for (int c = 0; c < Sh::kVB; ++c)
          sm90::tma_load_4d(ks + Sh::kKTile + c * Sh::kKBox, &tv, &kvbar[x],
                            64 * c, it.k0, it.kvh, it.b);
        if (n == 0) sm90::griddep_wait();  // dO hi and lo from the prep pass
        for (int u = 0; u < rep * it.n_q; ++u, ++j) {
          const int s = j % St;
          if (j >= St) sm90::mbar_wait(&empty[s], (j / St - 1) & 1);
          uint8_t* st = ring + s * Sh::kKVStage;
          const int h = it.kvh * rep + u / it.n_q;
          const int q0 = it.q_start + (u % it.n_q) * kRows;
          sm90::mbar_arrive_expect_tx(&full[s],
                                      Sh::kKVStage + Sh::kLDBytes);
          for (int c = 0; c < Sh::kQB; ++c)
            sm90::tma_load_4d(st + c * kBox64, &tq, &full[s], 64 * c, q0, h,
                              it.b);
          if constexpr (Sh::kStageLD) {
            const size_t row = (static_cast<size_t>(it.b) * H + h) * Sp + q0;
            sm90::bulk_load(ldb + 128 * s, lse_p + row, 4 * kRows, &full[s]);
            sm90::bulk_load(ldb + 128 * s + 64, d_p + row, 4 * kRows,
                            &full[s]);
          }
          for (int c = 0; c < Sh::kVB; ++c) {
            uint8_t* hb = st + Sh::kKTile64 + c * kBox64;
            sm90::tma_load_4d(hb, &tdh, &full[s], 64 * c, q0, h, it.b);
            sm90::tma_load_4d(hb + Sh::kVTile64, &tdl, &full[s], 64 * c, q0, h,
                              it.b);
          }
        }
      }
    }
    return;
  }

  if constexpr (Sh::kKVRegs) sm90::setmaxnreg_inc<240>();
  sm90::griddep_wait();                   // lse and D from the prep pass
  const int wg = warp / 4, lane = threadIdx.x % 32, quad = lane % 4;
  const int t = threadIdx.x % 128;
  if constexpr (Sh::kOwnKeys) {
    Item it;
    item(0, it);
    const int b = it.b, kvh = it.kvh, k0 = it.k0, q_start = it.q_start;
    const int n_q = it.n_q, n_tiles = rep * n_q;
    // Warpgroup wg owns keys [kw0, kw0 + 64) and does all five products
    // for them: this thread keys kr and kr + 8 (index i / 2) and, in S^T
    // and dP^T, queries q0 + 8 g + 2 quad + (0, 1).  Per tile: S^T = K
    // Q^T and dP^T = V dO_hi^T + V dO_lo^T in one commit, P^T = exp(scale
    // S^T - lse), dS^T = P^T (dP^T - D), then dV += P_hi^T dO_hi + P_lo^T
    // dO_hi + P_hi^T dO_lo and dK += dS_hi^T Q + dS_lo^T Q in another: the
    // same operations in the same order as the split kernel below, so the
    // same bits (at (64, 64) P^T takes kEx2's exponential: other bits).  A
    // tile whose queries all precede the warpgroup's keys (warpgroup 1 on
    // the block's first tile of each head, causal), whose queries all lie
    // past the warpgroup's keys' windows, or keys all past T add nothing
    // and are skipped.
    const int kw0 = k0 + 64 * wg;
    const int kr = kw0 + 16 * (warp % 4) + lane / 4;
    const float c2 = scale * kLog2e;      // kEx2
    float adv[DV / 2], adk[Sh::NQ / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) adv[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < Sh::NQ / 2; ++i) adk[i] = 0.0f;
    sm90::fence_regs(adv);
    sm90::fence_regs(adk);
    const uint32_t ka = sm90::smem_u32(smem) + wg * 64 * 128;
    const uint32_t va = ka + Sh::kKTile;
    sm90::mbar_wait(kvbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % St;
      const size_t bh = static_cast<size_t>(b) * H + kvh * rep + j / n_q;
      const int q0 = q_start + (j % n_q) * kRows;
      const uint32_t qb = sm90::smem_u32(ring + s * Sh::kKVStage);
      const uint32_t hb = qb + Sh::kKTile64, lb = hb + Sh::kVTile64;
      sm90::mbar_wait(&full[s], (j / St) & 1);
      bool live = kw0 < T_len && !(causal && q0 + kRows - 1 < kw0);
      if constexpr (kWin) live = live && q0 < kw0 + kRows - 1 + window;
      if (live) {
        float st[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
        sm90::fence_regs(st);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t oa = (kk / 4) * Sh::kKBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
          sm90::wgmma_m64n64k16<0, 0>(st,
                                      sm90::desc_sw128(ka + oa, 16, 1024),
                                      sm90::desc_sw128(qb + ob, 16, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const uint32_t oa = (kk / 4) * Sh::kKBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
          const uint64_t dva = sm90::desc_sw128(va + oa, 16, 1024);
          sm90::wgmma_m64n64k16<0, 0>(dp, dva,
                                      sm90::desc_sw128(hb + ob, 16, 1024));
          sm90::wgmma_m64n64k16<0, 0>(dp, dva,
                                      sm90::desc_sw128(lb + ob, 16, 1024));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dp);
        // P^T (the mask, -2^30, only on the tiles that hold the diagonal
        // or a window's edge; queries past S read lse = +inf, so P = 0
        // there), dS^T.
        const float* lrow =
            (Sh::kStageLD ? ldb + 128 * s : lse_p + bh * Sp + q0) + 2 * quad;
        const float* drow =
            (Sh::kStageLD ? ldb + 128 * s + 64 : d_p + bh * Sp + q0) +
            2 * quad;
        bool edge = causal && q0 < kw0 + kRows - 1;
        if constexpr (kWin) edge = edge || q0 + kRows - 1 >= kw0 + window;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          bool masked =
              edge && kr + 8 * ((i >> 1) & 1) > q0 + 8 * (i / 4) + 2 * quad +
                                                     (i & 1);
          if constexpr (kWin)
            masked = masked || (edge && q0 + 8 * (i / 4) + 2 * quad +
                                            (i & 1) - kr - 8 * ((i >> 1) & 1) >=
                                        window);
          const float l = lrow[8 * (i / 4) + (i & 1)];
          if constexpr (Sh::kEx2)
            st[i] = masked ? 0.0f : ex2(fmaf(st[i], c2, -l * kLog2e));
          else
            st[i] = expf((masked ? kNegInf : st[i] * scale) - l);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = st[i] * (dp[i] - drow[8 * (i / 4) + (i & 1)]);
        // dV (n = dv, dO N-major), then dK (times scale at the end; n =
        // NQ, Q N-major, each next 64 columns one box on): queries in 4
        // steps of 16 (2048 bytes each).  dS^T is split after dV's
        // products are issued, so P^T's fragments and dS^T's float32 tile
        // are the only ones live beside the accumulators.
        uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
        split_frags(st, ph, pl);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dh = sm90::desc_sw128(hb + 2048 * kk, kBox64, 1024);
          sm90::wgmma_rs<DV, 1>(adv, ph[kk], dh);
          sm90::wgmma_rs<DV, 1>(adv, pl[kk], dh);
          sm90::wgmma_rs<DV, 1>(
              adv, ph[kk], sm90::desc_sw128(lb + 2048 * kk, kBox64, 1024));
        }
        split_frags(dp, sh, sl);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dq_ = sm90::desc_sw128(qb + 2048 * kk, kBox64, 1024);
          sm90::wgmma_rs<Sh::NQ, 1>(adk, sh[kk], dq_);
          sm90::wgmma_rs<Sh::NQ, 1>(adk, sl[kk], dq_);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(adv);
        sm90::fence_regs(adk);
        fence_frags(ph);
        fence_frags(pl);
        fence_frags(sh);
        fence_frags(sl);
      }
      if (t == 0) sm90::mbar_arrive(&empty[s]);
    }
    // dV and dK = scale dS^T Q, rounded once to bf16, rows past T not
    // written.
    const size_t base = (static_cast<size_t>(b) * KV + kvh) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kr + 8 * r;
      if (key >= T_len) continue;
      bf16* vrow = dv + (base + key) * DV + 2 * quad;
#pragma unroll
      for (int g = 0; g < DV / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * g) =
            __floats2bfloat162_rn(adv[4 * g + 2 * r], adv[4 * g + 2 * r + 1]);
      bf16* krow = dk + (base + key) * DK + 2 * quad;
#pragma unroll
      for (int g = 0; g < DK / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * g) =
            __floats2bfloat162_rn(adk[4 * g + 2 * r] * scale,
                                  adk[4 * g + 2 * r + 1] * scale);
    }
    return;
  }
  // The consumers, both on the item's 64 keys with the same accumulator
  // layout: this thread keys kr and kr + 8 (index i / 2) and, in S^T and
  // dP^T, queries q0 + 8 g + 2 quad + (0, 1).  Warpgroup 0 computes P^T and
  // dV, and hands P^T to warpgroup 1 through pbuf (entries 4 g .. 4 g + 3
  // of thread t as one float4 at 4 (128 g + t): no bank conflicts), which
  // computes dP^T, dS^T and dK.  pbuf's turns count the block's tiles over
  // all its items.
  int n_all = 0;
  {
    Item it;
    for (int n = 0; item(n, it); ++n) n_all += rep * it.n_q;
  }
  Item it;
  for (int n = 0, j = 0; item(n, it); ++n) {
    const int x = n % KB;
    const int kr = it.k0 + 16 * (warp % 4) + lane / 4;
    float acc[Sh::kAcc];                  // dV (wg 0, n = dv) or dK (wg 1)
#pragma unroll
    for (int i = 0; i < Sh::kAcc; ++i) acc[i] = 0.0f;
    sm90::fence_regs(acc);
    const uint32_t ka = sm90::smem_u32(smem + x * Sh::kKV);
    const uint32_t va = ka + Sh::kKTile;
    sm90::mbar_wait(&kvbar[x], (n / KB) & 1);

    for (int u = 0; u < rep * it.n_q; ++u, ++j) {
      const int s = j % St, pb = j % Sh::kPBufs;
      const size_t bh =
          static_cast<size_t>(it.b) * H + it.kvh * rep + u / it.n_q;
      const int q0 = it.q_start + (u % it.n_q) * kRows;
      const uint32_t qb = sm90::smem_u32(ring + s * Sh::kKVStage);
      const uint32_t hb = qb + Sh::kKTile64, lb = hb + Sh::kVTile64;
      float* pt = pbuf + pb * kPBuf + 4 * t;
      sm90::mbar_wait(&full[s], (j / St) & 1);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      if (wg == 0) {
        // S^T = K Q^T.
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBox64 + (kk % 4) * 32;
          sm90::wgmma_m64n64k16<0, 0>(sc,
                                      sm90::desc_sw128(ka + off, 16, 1024),
                                      sm90::desc_sw128(qb + off, 16, 1024));
        }
      } else {
        // dP^T = V dO_hi^T + V dO_lo^T.
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBox64 + (kk % 4) * 32;
          const uint64_t dva = sm90::desc_sw128(va + off, 16, 1024);
          sm90::wgmma_m64n64k16<0, 0>(sc, dva,
                                      sm90::desc_sw128(hb + off, 16, 1024));
          sm90::wgmma_m64n64k16<0, 0>(sc, dva,
                                      sm90::desc_sw128(lb + off, 16, 1024));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      if (wg == 0) {
        // P^T = exp(scale S^T - lse): only the diagonal tile has a key past
        // a query; queries past S read lse = +inf, so P = 0 there.
        const float* lrow = lse_p + bh * Sp + q0 + 2 * quad;
        const bool edge = causal && q0 < it.k0 + kRows - 1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float xs = sc[i] * scale;
          if (edge && kr + 8 * ((i >> 1) & 1) > q0 + 8 * (i / 4) + 2 * quad +
                                                     (i & 1))
            xs = kNegInf;
          sc[i] = expf(xs - lrow[8 * (i / 4) + (i & 1)]);
        }
        if (j >= Sh::kPBufs)              // wg 1 has read the buffer's
          sm90::named_barrier(1 + Sh::kPBufs + pb, 256);   // last tile
#pragma unroll
        for (int g = 0; g < 8; ++g)
          *reinterpret_cast<float4*>(pt + 512 * g) = make_float4(
              sc[4 * g], sc[4 * g + 1], sc[4 * g + 2], sc[4 * g + 3]);
        named_arrive(1 + pb, 256);
        uint32_t hi[4][4], lo[4][4];
        split_frags(sc, hi, lo);
        // dV += P_hi^T dO_hi + P_lo^T dO_hi + P_hi^T dO_lo: queries in 4
        // steps of 16 (2048 bytes each), n = dv, dO N-major, each next 64
        // columns one box on.
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dh = sm90::desc_sw128(hb + 2048 * kk, kBox64, 1024);
          sm90::wgmma_rs<DV, 1>(acc, hi[kk], dh);
          sm90::wgmma_rs<DV, 1>(acc, lo[kk], dh);
          sm90::wgmma_rs<DV, 1>(
              acc, hi[kk], sm90::desc_sw128(lb + 2048 * kk, kBox64, 1024));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        fence_frags(hi);
        fence_frags(lo);
      } else {
        // dS^T = P^T (dP^T - D), P^T from warpgroup 0.
        const float* drow = d_p + bh * Sp + q0 + 2 * quad;
        sm90::named_barrier(1 + pb, 256);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(pt + 512 * g);
          sc[4 * g] = p.x * (sc[4 * g] - drow[8 * g]);
          sc[4 * g + 1] = p.y * (sc[4 * g + 1] - drow[8 * g + 1]);
          sc[4 * g + 2] = p.z * (sc[4 * g + 2] - drow[8 * g]);
          sc[4 * g + 3] = p.w * (sc[4 * g + 3] - drow[8 * g + 1]);
        }
        if (j + Sh::kPBufs < n_all) named_arrive(1 + Sh::kPBufs + pb, 256);
        uint32_t hi[4][4], lo[4][4];
        split_frags(sc, hi, lo);
        // dK += dS_hi^T Q + dS_lo^T Q (times scale at the end), Q N-major,
        // n = NQ.
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dq_ = sm90::desc_sw128(qb + 2048 * kk, kBox64, 1024);
          sm90::wgmma_rs<Sh::NQ, 1>(acc, hi[kk], dq_);
          sm90::wgmma_rs<Sh::NQ, 1>(acc, lo[kk], dq_);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        fence_frags(hi);
        fence_frags(lo);
      }
      if (t == 0) sm90::mbar_arrive(&empty[s]);
    }
    // The item's K and V are read: the producer may load its buffer again.
    if constexpr (Sh::kPersist) {
      if (t == 0) sm90::mbar_arrive(&kvfree[x]);
    }

    // dV (wg 0, dv columns) and dK = scale dS^T Q (wg 1, dk columns),
    // rounded once to bf16, rows past T not written.
    bf16* grad = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.0f : scale;
    const int width = wg == 0 ? DV : DK;
    const size_t base = (static_cast<size_t>(it.b) * KV + it.kvh) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kr + 8 * r;
      if (key >= T_len) continue;
      bf16* row = grad + (base + key) * width + 2 * quad;
#pragma unroll
      for (int g = 0; g < Sh::kAcc / 4; ++g)
        if (8 * g < width)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * g) =
              __floats2bfloat162_rn(acc[4 * g + 2 * r] * mul,
                                    acc[4 * g + 2 * r + 1] * mul);
    }
  }
}

template <int DK, int DV, bool kWin>
__global__ void __launch_bounds__(BwdShape<DK, DV>::kThreads, 1)
flash_bwd_dq_wgmma(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   __grid_constant__ const CUtensorMap tdh,
                   __grid_constant__ const CUtensorMap tdl,
                   const float* __restrict__ lse_p,
                   const float* __restrict__ d_p, bf16* __restrict__ dq,
                   int S, int Sp, int T_len, int H, int KV, float scale,
                   int causal, int window) {
  using Sh = BwdShape<DK, DV>;                  // kWin as in dkv
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                     // Q [kQRows queries][dk]
  uint8_t* hs = qs + Sh::kQB * Sh::kQBox; // dO hi [kQRows][dv]
  uint8_t* ls = hs + Sh::kVB * Sh::kQBox; // dO lo
  uint8_t* ring = ls + Sh::kVB * Sh::kQBox;   // stages of K and V, 64 keys
  float* pbuf = reinterpret_cast<float*>(ring + kBStages * Sh::kQStage);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kBStages * Sh::kQStage +
                                               Sh::kQPBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kBStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  // The block's consumer warpgroups: kQWGs, or at (64, 64) two where that
  // leaves fewer waves of blocks (block_wgs, on the host); Q, dO hi and
  // dO lo then arrive as one TMA box of 64 rows a warpgroup (kQBoxRows).
  const int wgs = Sh::kQWGs == 2 ? 2 : (blockDim.x - 32) / 128;
  constexpr int kRB = Sh::kQBoxRows;
  const int n_box = Sh::kQRows == kRB ? 1 : wgs;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64 * wgs;
  const int kv_end = causal ? min(T_len, q0 + 64 * wgs) : T_len;
  const int n_kv = (kv_end + kRows - 1) / kRows;
  // With a window the walk starts at the tile holding the block's first
  // row's first key: tiles [j_lo, n_kv), the u-th (u = j - j_lo) on ring
  // stage u % kBStages.
  const int j_lo = kWin ? max(0, q0 - window + 1) / kRows : 0;
  const int warp = warp_index<DK != 128>();
  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < kBStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], wgs);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * wgs) {                  // the producer
    if constexpr (Sh::kRegs) sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * wgs) {
      sm90::mbar_arrive_expect_tx(qbar,
                                  (Sh::kQB + 2 * Sh::kVB) * n_box * kRB * 128);
      for (int x = 0; x < Sh::kQB; ++x)
        for (int w = 0; w < n_box; ++w)
          sm90::tma_load_4d(qs + x * Sh::kQBox + w * kRB * 128, &tq, qbar,
                            64 * x, q0 + kRB * w, h, b);
      sm90::griddep_wait();               // dO hi and lo from the prep pass
      for (int x = 0; x < Sh::kVB; ++x) {
        for (int w = 0; w < n_box; ++w) {
          const uint32_t at = x * Sh::kQBox + w * kRB * 128;
          sm90::tma_load_4d(hs + at, &tdh, qbar, 64 * x, q0 + kRB * w, h, b);
          sm90::tma_load_4d(ls + at, &tdl, qbar, 64 * x, q0 + kRB * w, h, b);
        }
      }
      for (int j = j_lo; j < n_kv; ++j) {
        const int u = j - j_lo, s = u % kBStages;
        if (u >= kBStages) sm90::mbar_wait(&empty[s], (u / kBStages - 1) & 1);
        uint8_t* st = ring + s * Sh::kQStage;
        const int k0 = j * kRows;
        sm90::mbar_arrive_expect_tx(&full[s], Sh::kQStage);
        for (int x = 0; x < Sh::kQB; ++x)
          sm90::tma_load_4d(st + x * kBox64, &tk, &full[s], 64 * x, k0, kvh,
                            b);
        for (int x = 0; x < Sh::kVB; ++x)
          sm90::tma_load_4d(st + Sh::kKTile64 + x * kBox64, &tv, &full[s],
                            64 * x, k0, kvh, b);
      }
    }
    return;
  }

  if constexpr (Sh::kRegs) sm90::setmaxnreg_inc<240>();
  sm90::griddep_wait();                   // lse and D from the prep pass
  // The consumers: warpgroup wg owns queries [row_lo, row_lo + 64); this
  // thread rows r0 and r0 + 8 and, in S, keys k0 + 8 g + 2 quad + (0, 1).
  const int wg = warp / 4, lane = threadIdx.x % 32, quad = lane % 4;
  const int row_lo = q0 + kRows * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  const float* lrow = lse_p + static_cast<size_t>(bh) * Sp;
  const float* drow = d_p + static_cast<size_t>(bh) * Sp;
  // Rows past Sp (a multiple of 128, not always of kQRows) are past S:
  // lse = +inf and D = 0, as the prep pass pads, so P = 0 there.
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = Sh::kQRows == kBlockRows || r0 + 8 * r < Sp;
    lse[r] = in ? lrow[r0 + 8 * r] : pos_inf();
    dd[r] = in ? drow[r0 + 8 * r] : 0.0f;
  }
  // kEx2: P = 2^(s c2 - lse log2(e)).
  const float c2 = scale * kLog2e;
  const float lse2[2] = {lse[0] * kLog2e, lse[1] * kLog2e};
  float adq[Sh::NQ / 2];
#pragma unroll
  for (int i = 0; i < Sh::NQ / 2; ++i) adq[i] = 0.0f;
  sm90::fence_regs(adq);
  const uint32_t qa = sm90::smem_u32(qs) + wg * kRows * 128;
  const uint32_t ha = sm90::smem_u32(hs) + wg * kRows * 128;
  const uint32_t la = sm90::smem_u32(ls) + wg * kRows * 128;
  // kPSmem: this thread's P slots, entries 4 g .. 4 g + 3 as one float4 at
  // 4 (128 g + t) of its warpgroup's buffer (no bank conflicts).
  float* pme = pbuf + wg * kPBuf + 4 * (threadIdx.x % 128);
  sm90::mbar_wait(qbar, 0);

  for (int j = j_lo; j < n_kv; ++j) {
    const int u = j - j_lo, s = u % kBStages;
    const int k0 = j * kRows;
    sm90::mbar_wait(&full[s], (u / kBStages) & 1);
    // A tile past the warpgroup's last row, or wholly below its windows,
    // is freed unread.
    bool live = !causal || k0 <= row_lo + kRows - 1;
    if constexpr (kWin) live = live && k0 + kRows - 1 > row_lo - window;
    if (live) {
      const uint32_t kb = sm90::smem_u32(ring + s * Sh::kQStage);
      const uint32_t vb = kb + Sh::kKTile64;
      float dp[32];
      if constexpr (Sh::kPSmem) {
        // S alone first, and P (as below) to this thread's slots before
        // dP is issued, so that only dQ and one 64 x 64 tile are live in
        // registers; dS reads P back exactly.
        {
          float st[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) st[i] = 0.0f;
          sm90::fence_regs(st);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) {
            const uint32_t oa = (kk / 4) * kBox + (kk % 4) * 32;
            const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
            sm90::wgmma_m64n64k16<0, 0>(
                st, sm90::desc_sw128(qa + oa, 16, 1024),
                sm90::desc_sw128(kb + ob, 16, 1024));
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(st);
          const bool edge =
              (causal && k0 + kRows - 1 > row_lo) || k0 + kRows > T_len;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            float sc = st[i] * scale;
            if (edge) {
              const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
              if (kj >= T_len || (causal && kj > r0 + 8 * r)) sc = kNegInf;
            }
            st[i] = expf(sc - lse[r]);
          }
#pragma unroll
          for (int g = 0; g < 8; ++g)
            *reinterpret_cast<float4*>(pme + 512 * g) = make_float4(
                st[4 * g], st[4 * g + 1], st[4 * g + 2], st[4 * g + 3]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = 0.0f;
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const uint32_t oa = (kk / 4) * kBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
          const uint64_t dvb = sm90::desc_sw128(vb + ob, 16, 1024);
          sm90::wgmma_m64n64k16<0, 0>(
              dp, sm90::desc_sw128(ha + oa, 16, 1024), dvb);
          sm90::wgmma_m64n64k16<0, 0>(
              dp, sm90::desc_sw128(la + oa, 16, 1024), dvb);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(pme + 512 * g);
          dp[4 * g] = p.x * (dp[4 * g] - dd[0]);
          dp[4 * g + 1] = p.y * (dp[4 * g + 1] - dd[0]);
          dp[4 * g + 2] = p.z * (dp[4 * g + 2] - dd[1]);
          dp[4 * g + 3] = p.w * (dp[4 * g + 3] - dd[1]);
        }
      } else {
        float st[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.0f;
        sm90::fence_regs(st);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t oa = (kk / 4) * kBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
          sm90::wgmma_m64n64k16<0, 0>(st, sm90::desc_sw128(qa + oa, 16, 1024),
                                      sm90::desc_sw128(kb + ob, 16, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const uint32_t oa = (kk / 4) * kBox + (kk % 4) * 32;
          const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
          const uint64_t dvb = sm90::desc_sw128(vb + ob, 16, 1024);
          sm90::wgmma_m64n64k16<0, 0>(dp, sm90::desc_sw128(ha + oa, 16, 1024),
                                      dvb);
          sm90::wgmma_m64n64k16<0, 0>(dp, sm90::desc_sw128(la + oa, 16, 1024),
                                      dvb);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dp);

        // P and dS in place; keys past T (the ragged last tile), past a
        // query (a tile crossing the diagonal) or below its window are
        // masked.
        bool edge =
            (causal && k0 + kRows - 1 > row_lo) || k0 + kRows > T_len;
        if constexpr (kWin) edge = edge || k0 <= row_lo + kRows - 1 - window;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          bool masked = false;
          if (edge) {
            const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
            masked = kj >= T_len || (causal && kj > r0 + 8 * r);
            if constexpr (kWin) masked = masked || kj <= r0 + 8 * r - window;
          }
          float p;
          if constexpr (Sh::kEx2)
            p = masked ? 0.0f : ex2(fmaf(st[i], c2, -lse2[r]));
          else
            p = expf((masked ? kNegInf : st[i] * scale) - lse[r]);
          dp[i] = p * (dp[i] - dd[r]);
        }
      }
      uint32_t sh[4][4], sl[4][4];
      split_frags(dp, sh, sl);

      // dQ += dS K: keys in 4 steps of 16, K N-major, n = NQ.
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        const uint64_t bk = sm90::desc_sw128(kb + 2048 * kk, kBox64, 1024);
        sm90::wgmma_rs<Sh::NQ, 1>(adq, sh[kk], bk);
        sm90::wgmma_rs<Sh::NQ, 1>(adq, sl[kk], bk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(adq);
      fence_frags(sh);
      fence_frags(sl);
    }
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    bf16* drow_ = dq + (static_cast<size_t>(bh) * S + row) * DK + 2 * quad;
#pragma unroll
    for (int g = 0; g < DK / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(drow_ + 8 * g) =
          __floats2bfloat162_rn(adq[4 * g + 2 * r] * scale,
                                adq[4 * g + 2 * r + 1] * scale);
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

// A map of q, k, v or dO (`width` columns) as (width, rows, heads, batch)
// with its own strides, read in 64-column boxes of `box_rows` rows (128,
// or 64 for the backward's 64-row tiles); a box past `width` reads zeros.
bool head_map(CUtensorMap* map, const void* base, const long long (&st)[3],
              int width, int rows, int heads, int B, int box_rows = 128) {
  const uint64_t dims[4] = {static_cast<uint64_t>(width),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t bytes[3] = {static_cast<uint64_t>(st[2]) * 2,
                             static_cast<uint64_t>(st[1]) * 2,
                             static_cast<uint64_t>(st[0]) * 2};
  return sm90::tensor_map_bf16_4d(map, base, dims, bytes, 64, box_rows);
}

// The card's count of SMs, read once a device.
int sm_count(int device) {
  static int count[kMaxDevices] = {};
  int n = device < kMaxDevices ? count[device] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n < 1)
      n = 1;
    if (device < kMaxDevices) count[device] = n;
  }
  return n;
}

// The consumer warpgroups (of 64 rows) a block of the (64, 64) forward
// and dq, over bh (b, h) pairs of S rows: three, or two where that leaves
// fewer waves of blocks on the card's SMs (a block of three took 1.22x as
// long as one of two at Whisper's encoder shape: kernel_variants.py k5;
// PERF.md).  The rows a warpgroup owns, and so the bits, do not depend on
// it.
int block_wgs(long long bh, int S, int device) {
  const long long sms = sm_count(device);
  const long long w3 = (bh * ((S + 191) / 192) + sms - 1) / sms;
  const long long w2 = (bh * ((S + 127) / 128) + sms - 1) / sms;
  return 100 * w2 < 122 * w3 ? 2 : 3;
}

template <int DK, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         float* out, float* lse, int B, int H, int KV, int S,
                         int T_len, float scale, int causal, int window,
                         const Strides& st, int device, cudaStream_t s) {
  using Sh = FwdShape<DK, DV>;
  static bool done[2][kMaxDevices] = {};
  constexpr size_t smem = Sh::kSmem;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, st.q, DK, S, H, B, Sh::kBoxRows) ||
      !head_map(&tk, k, st.k, DK, T_len, KV, B, Sh::kBoxRows) ||
      !head_map(&tv, v, st.v, DV, T_len, KV, B, Sh::kBoxRows))
    return cudaErrorNotSupported;
  // A window has its own instantiation, at (64, 64) only.
  auto kernel = flash_wgmma<DK, DV, false>;
  if constexpr (Sh::kOv)
    if (window > 0) kernel = flash_wgmma<DK, DV, true>;
  cudaError_t err = allow_smem(kernel, smem, device, done[window > 0]);
  if (err != cudaSuccess) return err;
  int rows = Sh::kRowsB, threads = Sh::kThreads;
  if constexpr (Sh::kOv) {
    const int wgs = block_wgs(static_cast<long long>(B) * H, S, device);
    rows = 64 * wgs;
    threads = 128 * wgs + 32;
  }
  const dim3 grid(B * H, (S + rows - 1) / rows);
  kernel<<<grid, threads, smem, s>>>(tq, tk, tv, out, lse, S, T_len, H,
                                     H / KV, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       float* out, int B, int H, int rep, int S, int T_len,
                       float scale, int causal, int window, const Strides& st,
                       int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  auto kernel = flash_fma<T, DK, DV>;
  cudaError_t err = allow_smem(kernel, fma_smem<DK, DV>(), device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kFBQ - 1) / kFBQ, B * H);
  kernel<<<grid, kFThreads, fma_smem<DK, DV>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, st, S, T_len, H, rep, scale, causal,
      window);
  return cudaGetLastError();
}

// The (dk, dv) pairs the kernels are compiled for: the equal widths, the
// smoke configurations' MLA pair (24, 16) and the published MLA pairs of
// MiniCPM3-4B (96, 64) and DeepSeek-V2-Lite (192, 128).
#define REPRO_K5_WIDTHS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(24, 16) X(96, 64) X(192, 128)

template <typename T>
cudaError_t dispatch_fma(const void* q, const void* k, const void* v,
                         float* out, int B, int H, int rep, int S, int T_len,
                         int dk, int dv, float scale, int causal, int window,
                         const Strides& st, int device, cudaStream_t s) {
#define X(DK, DV)                                                          \
  if (dk == DK && dv == DV)                                                \
    return launch_fma<T, DK, DV>(q, k, v, out, B, H, rep, S, T_len, scale, \
                                 causal, window, st, device, s);
  REPRO_K5_WIDTHS(X)
#undef X
  return cudaErrorInvalidValue;
}

template <typename T, int DK, int DV>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* o, const float* dout, void* dq, void* dk,
                       void* dv, float* ws, int B, int H, int KV, int S,
                       int T_len, float scale, int causal, int window,
                       const Strides& st, int device, cudaStream_t stream) {
  static bool done_dq[kMaxDevices] = {}, done_dkv[kMaxDevices] = {};
  auto kdq = flash_bwd_dq<T, DK, DV>;
  auto kdkv = flash_bwd_dkv<T, DK, DV>;
  cudaError_t err = allow_smem(kdq, bwd_dq_smem<DK, DV>(), device, done_dq);
  if (err == cudaSuccess)
    err = allow_smem(kdkv, bwd_dkv_smem<DK, DV>(), device, done_dkv);
  if (err != cudaSuccess) return err;
  const int rep = H / KV;
  const int bhs = B * H * S;
  kdq<<<dim3((S + kBB - 1) / kBB, B * H), kBThreads, bwd_dq_smem<DK, DV>(),
        stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), o, dout, static_cast<T*>(dq), ws,
                  st, S, T_len, H, rep, scale, causal, window, bhs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3((T_len + kBB - 1) / kBB, B * KV), kBThreads,
         bwd_dkv_smem<DK, DV>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, ws, static_cast<T*>(dk),
      static_cast<T*>(dv), st, S, T_len, H, KV, rep, scale, causal, window,
      bhs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const float* o, const float* dout, void* dq,
                         void* dk, void* dv, float* ws, int B, int H, int KV,
                         int S, int T_len, int dk_, int dv_, float scale,
                         int causal, int window, const Strides& st,
                         int device, cudaStream_t s) {
#define X(DK, DV)                                                           \
  if (dk_ == DK && dv_ == DV)                                               \
    return launch_bwd<T, DK, DV>(q, k, v, o, dout, dq, dk, dv, ws, B, H, KV, \
                                 S, T_len, scale, causal, window, st, device, \
                                 s);
  REPRO_K5_WIDTHS(X)
#undef X
  return cudaErrorInvalidValue;
}

// Launches `kernel` on stream s with programmatic stream serialization: it
// may start before the kernel ahead of it has finished.
template <typename... Params, typename... Args>
cudaError_t launch_early(void (*kernel)(Params...), dim3 grid, int threads,
                         size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The workspace of the wgmma backward, in floats: lse and D padded to Sp
// rows a (b, h), then dO hi and dO lo, bf16 [B, H, S, dv] each.
int padded_rows(int S) { return (S + kBlockRows - 1) / kBlockRows * kBlockRows; }

template <int DK, int DV>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const float* o, const float* dout,
                             const float* lse, void* dq, void* dk, void* dv,
                             float* ws, int B, int H, int KV, int S,
                             int T_len, float scale, int causal, int window,
                             const Strides& st, int device, cudaStream_t s) {
  using Sh = BwdShape<DK, DV>;
  static bool done_kv[2][kMaxDevices] = {}, done_q[2][kMaxDevices] = {};
  const int Sp = padded_rows(S);
  const long long rows = static_cast<long long>(B) * H * Sp;
  float* lse_p = ws;
  float* d_p = ws + rows;
  bf16* dhi = reinterpret_cast<bf16*>(ws + 2 * rows);
  bf16* dlo = dhi + static_cast<size_t>(B) * H * S * DV;
  const long long dst[3] = {static_cast<long long>(H) * S * DV,
                            static_cast<long long>(S) * DV, DV};
  CUtensorMap tq64, tqq, tk64, tv64, tkk, tvk, th64, thq, tl64, tlq;
  const int qbox = Sh::kQBoxRows;
  if (!head_map(&tq64, q, st.q, DK, S, H, B, 64) ||
      !head_map(&tqq, q, st.q, DK, S, H, B, qbox) ||
      !head_map(&tk64, k, st.k, DK, T_len, KV, B, 64) ||
      !head_map(&tv64, v, st.v, DV, T_len, KV, B, 64) ||
      !head_map(&tkk, k, st.k, DK, T_len, KV, B, Sh::kKeys) ||
      !head_map(&tvk, v, st.v, DV, T_len, KV, B, Sh::kKeys) ||
      !head_map(&th64, dhi, dst, DV, S, H, B, 64) ||
      !head_map(&thq, dhi, dst, DV, S, H, B, qbox) ||
      !head_map(&tl64, dlo, dst, DV, S, H, B, 64) ||
      !head_map(&tlq, dlo, dst, DV, S, H, B, qbox))
    return cudaErrorNotSupported;
  // A window has its own instantiations, at (64, 64) only.
  auto kdkv = flash_bwd_dkv_wgmma<DK, DV, false>;
  auto kdq = flash_bwd_dq_wgmma<DK, DV, false>;
  if constexpr (DK == 64 && DV == 64) {
    if (window > 0) {
      kdkv = flash_bwd_dkv_wgmma<DK, DV, true>;
      kdq = flash_bwd_dq_wgmma<DK, DV, true>;
    }
  }
  const bool w = window > 0;
  cudaError_t err = allow_smem(kdkv, Sh::kKVSmem, device, done_kv[w]);
  if (err == cudaSuccess) err = allow_smem(kdq, Sh::kQSmem, device, done_q[w]);
  if (err != cudaSuccess) return err;
  flash_bwd_prep<DV><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      o, dout, lse, dhi, dlo, lse_p, d_p, S, Sp, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // kPersist: one block an SM (at most one an item), else a block an item.
  // dkv and dq may start while the kernel ahead of each finishes (each
  // waits in griddep_wait before it reads the prep pass's output).
  const int BKV = B * KV;
  const int n_kb = (T_len + Sh::kKeys - 1) / Sh::kKeys;
  dim3 grid(BKV, n_kb);
  if constexpr (Sh::kPersist)
    grid = dim3(BKV * n_kb < sm_count(device) ? BKV * n_kb
                                              : sm_count(device));
  // dq's consumer warpgroups.
  int wgs = Sh::kQWGs, threads = Sh::kThreads;
  if constexpr (Sh::kQWGs != 2) {
    wgs = block_wgs(static_cast<long long>(B) * H, Sp, device);
    threads = 128 * wgs + 32;
  }
  err = launch_early(kdkv, grid, Sh::kKVThreads, Sh::kKVSmem, s, tq64, tkk,
                     tvk, th64, tl64, lse_p, d_p, static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), S, Sp, T_len, H, KV, BKV, scale,
                     causal, window);
  if (err != cudaSuccess) return err;
  return launch_early(kdq, dim3(B * H, (Sp + 64 * wgs - 1) / (64 * wgs)),
                      threads, Sh::kQSmem, s, tqq, tk64, tv64, thq, tlq,
                      lse_p, d_p, static_cast<bf16*>(dq), S, Sp, T_len, H, KV,
                      scale, causal, window);
}

bool tma_ready(const void* p, const long long (&st)[3]) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0 && st[0] > 0 && st[1] > 0 &&
         st[2] > 0;
}

// The pairs the wgmma kernels take, forward and backward.
bool wgmma_pair(int dk, int dv) {
  return (dk == 128 && dv == 128) || (dk == 64 && dv == 64) ||
         (dk == 96 && dv == 64) || (dk == 192 && dv == 128);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, H, S, dk], k [B, KV, T, dk] and v [B, KV, T, dv] with element
// strides `strides` (q's batch, head and row strides, then k's, then v's;
// each row contiguous), out [B, H, S, dv] float32 contiguous; dtype 0 =
// float32, 1 = bf16 (q, k and v alike); (dk, dv) one of REPRO_K5_WIDTHS;
// H a multiple of KV; causal needs S == T.  window > 0 (causal only; 0 =
// none): query i sees keys i - window < j <= i.  bf16 at (128, 128), (64,
// 64), (96, 64) and (192, 128) runs the wgmma kernel (its strides multiples
// of 8 and its bases 16-byte aligned, or an error; a window at (64, 64)
// only), which also writes each row's log-sum-exp of the scaled scores to
// lse (float32 [B, H, S]) unless lse is null; every other call runs the fma
// kernel and leaves lse alone.  *route is set to the kernel (0 fma, 1
// wgmma).  Returns a cudaError_t (0 on success); launches asynchronously
// on `stream`.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          float* out, float* lse, int B, int H, int KV, int S,
                          int T_len, int dk, int dv, float scale, int causal,
                          int window, int dtype, const long long* strides,
                          int device, void* stream, int* route) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || T_len < 1 ||
      (causal && S != T_len) || (dtype != 0 && dtype != 1) || window < 0 ||
      (window > 0 && !causal))
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
  if (dtype == 1 && wgmma_pair(dk, dv)) {
    *route = kWgmma;
    if ((S + kBM - 1) / kBM > 65535 || !tma_ready(q, st.q) ||
        !tma_ready(k, st.k) || !tma_ready(v, st.v) ||
        (window > 0 && dk != 64))
      return cudaErrorInvalidValue;
    if (dk == 128)
      return launch_wgmma<128, 128>(q, k, v, out, lse, B, H, KV, S, T_len,
                                    scale, causal, 0, st, device, s);
    if (dk == 64)
      return launch_wgmma<64, 64>(q, k, v, out, lse, B, H, KV, S, T_len,
                                  scale, causal, window, st, device, s);
    if (dk == 96)
      return launch_wgmma<96, 64>(q, k, v, out, lse, B, H, KV, S, T_len,
                                  scale, causal, 0, st, device, s);
    return launch_wgmma<192, 128>(q, k, v, out, lse, B, H, KV, S, T_len,
                                  scale, causal, 0, st, device, s);
  }
  *route = kFma;
  if (static_cast<long long>(B) * H > 65535) return cudaErrorInvalidValue;
  const int rep = H / KV;
  if (dtype == 1)
    return dispatch_fma<bf16>(q, k, v, out, B, H, rep, S, T_len, dk, dv,
                              scale, causal, window, st, device, s);
  return dispatch_fma<float>(q, k, v, out, B, H, rep, S, T_len, dk, dv, scale,
                             causal, window, st, device, s);
}

// The backward of repro_flash_attention: q, k, v as there (same strides,
// dtype, widths, causal and window rules), out and dout [B, H, S, dv] float32
// contiguous (the forward's output and the gradient at it), dq
// [B, H, S, dk], dk [B, KV, T, dk] and dv [B, KV, T, dv] contiguous in q's
// dtype; no atomics.  route 0 (fma, any call): ws a float32 workspace of
// 2 B H S, two launches (dq, then dk and dv), lse unread.  route 1
// (wgmma: bf16 at (128, 128), (64, 64), (96, 64) or (192, 128) with
// strides that are multiples of 8 and 16-byte-aligned bases): lse the
// forward's log-sum-exp, float32
// [B, H, S], ws a float32 workspace of 2 B H Sp + B H S dv floats (Sp = S
// rounded up to 128; 16-byte aligned), three launches (the prep pass, dk
// and dv, dq).  Launches on `stream`; returns a cudaError_t.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const float* out, const float* dout,
                              const float* lse, void* dq, void* dk, void* dv,
                              float* ws, int B, int H, int KV, int S,
                              int T_len, int dk_w, int dv_w, float scale,
                              int causal, int window, int dtype,
                              const long long* strides, int route, int device,
                              void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || T_len < 1 ||
      (causal && S != T_len) || (dtype != 0 && dtype != 1) || window < 0 ||
      (window > 0 && !causal) ||
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
  if (route == kWgmma) {
    if (dtype != 1 || !wgmma_pair(dk_w, dv_w) || lse == nullptr ||
        padded_rows(S) / kBlockRows > 65535 ||
        (T_len + kRows - 1) / kRows > 65535 || !tma_ready(q, st.q) ||
        !tma_ready(k, st.k) || !tma_ready(v, st.v) ||
        (reinterpret_cast<uintptr_t>(ws) & 15) != 0 ||
        (window > 0 && dk_w != 64))
      return cudaErrorInvalidValue;
    if (dk_w == 128)
      return launch_bwd_wgmma<128, 128>(q, k, v, out, dout, lse, dq, dk, dv,
                                        ws, B, H, KV, S, T_len, scale, causal,
                                        0, st, device, s);
    if (dk_w == 64)
      return launch_bwd_wgmma<64, 64>(q, k, v, out, dout, lse, dq, dk, dv,
                                      ws, B, H, KV, S, T_len, scale, causal,
                                      window, st, device, s);
    if (dk_w == 96)
      return launch_bwd_wgmma<96, 64>(q, k, v, out, dout, lse, dq, dk, dv,
                                      ws, B, H, KV, S, T_len, scale, causal,
                                      0, st, device, s);
    return launch_bwd_wgmma<192, 128>(q, k, v, out, dout, lse, dq, dk, dv, ws,
                                      B, H, KV, S, T_len, scale, causal, 0, st,
                                      device, s);
  }
  if (route != kFma) return cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch_bwd<bf16>(q, k, v, out, dout, dq, dk, dv, ws, B, H, KV, S,
                              T_len, dk_w, dv_w, scale, causal, window, st,
                              device, s);
  return dispatch_bwd<float>(q, k, v, out, dout, dq, dk, dv, ws, B, H, KV, S,
                             T_len, dk_w, dv_w, scale, causal, window, st,
                             device, s);
}

}  // extern "C"
