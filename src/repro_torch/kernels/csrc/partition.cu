// Routing-table partition kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/partition.py:
//   K1 partition_scatter (wrapper :226, kernel _partition_scatter_kernel :137)
//      -> repro_partition_scatter: dest [N], within-destination rank [N],
//         histogram [W];
//   K2 partition_scatter_fold (wrapper :286, kernel
//      _partition_scatter_fold_kernel :174)
//      -> repro_partition_scatter_fold: K1 over the live lanes of a 1-byte
//         mask, plus the per-key count [K] int32 and sum [K] float32 of the
//         live lanes whose key lies in [0, K);
//   K3 partition (wrapper :81, kernel _partition_kernel :53)
//      -> repro_partition: dest [N], histogram [W].
//
// The rule, bit-exact with the host partitioner and the plain PyTorch
// versions (repro_torch/kernels/ref.py):
//   u    = (((uint32)counter + 1) * 2654435769 mod 2^32) >> 8, times 2^-24
//   dest = #{w : u >= cdf[key, w]}, clipped to W - 1
// Both steps of u are exact in float32 (a 24-bit integer, then a power of
// two), and u >= cdf is a plain float32 compare, so this file must not be
// built with fast-math.  dest is a count over all W columns, never a
// search: the saturated CDF is not guaranteed monotone when a float32 row
// total rounds above 1 before the last positive column.  Keys outside
// [0, K) are clamped into range (a JAX gather clamps too), so no input can
// read outside the table.
//
// Bound on an H100 (3.35 TB/s, NVIDIA data sheet): memory.  Each input is
// read once and each output written once:
//   K1: 16 N + 4 K W bytes (keys, counters, dest, rank + the cdf table)
//   K2: 21 N + 4 K W + 8 K + 4 W bytes (K1's, plus vals and the 1-byte mask
//       in, the two [K] folds and the histogram out)
//   K3: 12 N + 4 K W bytes
// The compares, N * W of them, are far below the card's operation rate.
//
// Design.  The TPU kernel runs its grid in order and carries running
// per-worker counts from block to block in VMEM scratch.  GPU blocks run
// concurrently, so that carry would give wrong ranks as soon as there are
// two blocks.  K1 is instead three passes:
//   A  one block per tile of kTile records (256 threads x 16).  Each warp
//      owns a contiguous kTile / 8 slice of the tile and walks it in groups
//      of 32 consecutive records.  __match_any_sync on dest gives each
//      lane its peers; the in-group rank is popc(peers & lanes below).  A
//      per-warp [W] running count in shared memory carries ranks from group
//      to group.  An exclusive scan over the tile's warps per worker then
//      gives each record its within-tile rank and the tile its histogram,
//      written worker-major as tile_hist[w][tile].
//   B  one block per worker scans its row of tile_hist in place into
//      exclusive tile offsets and writes hist[w], the total.
//   C  rank[i] += tile_offset[dest[i]][tile(i)]  (only with two or more
//      tiles).
// K3 is pass A without ranks: shared-memory atomics build the tile
// histogram and one global atomicAdd per worker per block folds it into
// hist.  Integer atomics keep the result exact.
//
// K2 is K1 with a lane mask, plus a fold pass.  The TPU kernel carries the
// histogram and the [1, K] folds in VMEM across its ordered grid and builds
// a [block, K] one-hot for the fold; neither carries over.  Here a dead lane
// takes the group -1 in pass A's __match_any_sync (as a lane past the end
// does), so it is in no live lane's peer set, never touches the per-warp
// counters or the tile histogram, and gets rank 0; its destination is still
// computed and written.  Pass C skips dead lanes.  The mask may have holes
// anywhere (a Filter upstream kills lanes in the middle of a chunk).  The
// fold pass F walks the chunk grid-stride with at most kFoldBlocks blocks;
// when K <= kMaxSharedFoldKeys each block folds into a private [K] count and
// sum in shared memory (8 K bytes) and adds its nonzero entries to the
// global folds once, otherwise it adds to the global folds directly.  Counts
// are integer atomics, exact; sums are float32 atomics, whose order (and so
// the last bits of each sum) varies from run to run.  Hot keys contend on
// the same addresses, so F is far from the memory bound on skewed keys.
//
// Shared memory: pass A holds 8 x kMaxWorkers int32 (32 KB), so W is at
// most kMaxWorkers = 1024; the wrapper raises above it, and the entry
// points return cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;         // 4096 records a block
constexpr int kWarpSlice = kTile / kWarps;           // 512 records a warp
constexpr int kMaxWorkers = 1024;
constexpr uint32_t kGolden = 2654435769u;            // frac(phi) * 2^32
constexpr int kFoldBlocks = 264;                     // 2 per SM of an H100
constexpr int kMaxSharedFoldKeys = 24576;            // 8 K = 192 KB shared

__device__ __forceinline__ float ld_threshold(int32_t counter) {
  const uint32_t bits = ((uint32_t)counter + 1u) * kGolden;   // wraps
  return (float)(bits >> 8) * 0x1p-24f;
}

// Destination of one record: a count over every column of its cdf row.
__device__ __forceinline__ int route(int32_t key, int32_t counter,
                                     const float* __restrict__ cdf,
                                     int num_keys, int num_workers,
                                     bool vec4) {
  key = min(max(key, 0), num_keys - 1);
  const float* row = cdf + (size_t)key * num_workers;
  const float u = ld_threshold(counter);
  int d = 0;
  if (vec4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int w = 0; w < num_workers / 4; ++w) {
      const float4 c = __ldg(row4 + w);
      d += (u >= c.x) + (u >= c.y) + (u >= c.z) + (u >= c.w);
    }
  } else {
    for (int w = 0; w < num_workers; ++w) d += (u >= __ldg(row + w));
  }
  return min(d, num_workers - 1);
}

// Pass A of K1 (kMasked false: every lane live, valid unread) and K2.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
scatter_tile_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ counters,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ cdf, int n, int num_keys,
                    int num_workers, int num_tiles, bool vec4,
                    int32_t* __restrict__ dest, int32_t* __restrict__ rank,
                    int32_t* __restrict__ tile_hist) {
  __shared__ int warp_count[kWarps][kMaxWorkers];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int w = threadIdx.x; w < num_workers; w += kThreads)
    for (int j = 0; j < kWarps; ++j) warp_count[j][w] = 0;
  __syncthreads();

  const int64_t warp_start = (int64_t)blockIdx.x * kTile +
                             (int64_t)warp * kWarpSlice;
  const unsigned below = (1u << lane) - 1u;
  int my_dest[kPerThread];
  int my_rank[kPerThread];
#pragma unroll
  for (int g = 0; g < kPerThread; ++g) {
    const int64_t i = warp_start + g * 32 + lane;
    int d = -1;                                  // -1: lane past the end
    if (i < n) d = route(keys[i], counters[i], cdf, num_keys, num_workers,
                         vec4);
    // The counted group: K1 counts every lane it routes; K2 gives a dead
    // lane the group -1 and (in my_rank) the mark -1, for rank 0.  K1's
    // instantiation compiles to the unmasked code, with no extra register.
    int c = d;
    if constexpr (kMasked) c = (i < n && valid[i] != 0) ? d : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    int r = kMasked ? -1 : 0;
    if (c >= 0) r = warp_count[warp][c] + __popc(peers & below);
    __syncwarp();
    if (c >= 0 && (peers & below) == 0)          // lowest lane of the group
      warp_count[warp][c] += __popc(peers);
    __syncwarp();
    my_dest[g] = d;
    my_rank[g] = r;
  }
  __syncthreads();

  // Exclusive scan over the tile's warps, per worker; the total is the
  // tile's histogram.
  for (int w = threadIdx.x; w < num_workers; w += kThreads) {
    int run = 0;
    for (int j = 0; j < kWarps; ++j) {
      const int c = warp_count[j][w];
      warp_count[j][w] = run;
      run += c;
    }
    tile_hist[(size_t)w * num_tiles + blockIdx.x] = run;
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < kPerThread; ++g) {
    const int64_t i = warp_start + g * 32 + lane;
    if (i < n) {
      dest[i] = my_dest[g];
      if constexpr (kMasked)
        rank[i] = my_rank[g] < 0 ? 0
                                 : my_rank[g] + warp_count[warp][my_dest[g]];
      else
        rank[i] = my_rank[g] + warp_count[warp][my_dest[g]];
    }
  }
}

// Exclusive scan of one value per thread over the block; *total gets the
// block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int offset = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();                               // warp_sums is reused
  return offset + x - v;
}

// Pass B of K1: one block per worker.
__global__ void __launch_bounds__(kThreads)
tile_offsets_kernel(int32_t* __restrict__ tile_hist, int num_tiles,
                    int32_t* __restrict__ hist) {
  int32_t* row = tile_hist + (size_t)blockIdx.x * num_tiles;
  int run = 0;
  for (int base = 0; base < num_tiles; base += kThreads) {
    const int t = base + threadIdx.x;
    const int v = t < num_tiles ? row[t] : 0;
    int total;
    const int excl = block_exclusive_scan(v, &total);
    if (t < num_tiles) row[t] = run + excl;
    run += total;
  }
  if (threadIdx.x == 0) hist[blockIdx.x] = run;
}

// Pass C of K1 and K2 (dead lanes keep rank 0).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
add_tile_offsets_kernel(const int32_t* __restrict__ dest,
                        const uint8_t* __restrict__ valid,
                        int32_t* __restrict__ rank,
                        const int32_t* __restrict__ tile_off, int n,
                        int num_tiles) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n && (!kMasked || valid[i] != 0))
    rank[i] += tile_off[(size_t)dest[i] * num_tiles + i / kTile];
}

// Pass F of K2: per-key count and sum of the live lanes with a key in
// [0, K), privatised in shared memory when `priv` (K <= kMaxSharedFoldKeys).
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int32_t* __restrict__ keys, const float* __restrict__ vals,
            const uint8_t* __restrict__ valid, int n, int num_keys,
            bool priv, int32_t* __restrict__ fold_counts,
            float* __restrict__ fold_sums) {
  extern __shared__ int fold_smem[];
  int* s_cnt = fold_smem;
  float* s_sum = reinterpret_cast<float*>(fold_smem + num_keys);
  if (priv) {
    for (int k = threadIdx.x; k < num_keys; k += kThreads) {
      s_cnt[k] = 0;
      s_sum[k] = 0.0f;
    }
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int k = keys[i];
    if (valid[i] == 0 || k < 0 || k >= num_keys) continue;
    const float v = vals[i];
    if (priv) {
      atomicAdd(s_cnt + k, 1);
      atomicAdd(s_sum + k, v);
    } else {
      atomicAdd(fold_counts + k, 1);
      atomicAdd(fold_sums + k, v);
    }
  }
  if (priv) {
    __syncthreads();
    for (int k = threadIdx.x; k < num_keys; k += kThreads) {
      if (s_cnt[k] != 0) {
        atomicAdd(fold_counts + k, s_cnt[k]);
        atomicAdd(fold_sums + k, s_sum[k]);
      }
    }
  }
}

// K3: dest and histogram.
__global__ void __launch_bounds__(kThreads)
partition_tile_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ counters,
                      const float* __restrict__ cdf, int n, int num_keys,
                      int num_workers, bool vec4,
                      int32_t* __restrict__ dest, int32_t* __restrict__ hist) {
  __shared__ int tile_count[kMaxWorkers];
  for (int w = threadIdx.x; w < num_workers; w += kThreads) tile_count[w] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * kTile;
#pragma unroll 4
  for (int g = 0; g < kPerThread; ++g) {
    const int64_t i = start + g * kThreads + threadIdx.x;
    if (i < n) {
      const int d = route(keys[i], counters[i], cdf, num_keys, num_workers,
                          vec4);
      dest[i] = d;
      atomicAdd(&tile_count[d], 1);
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < num_workers; w += kThreads)
    if (tile_count[w]) atomicAdd(&hist[w], tile_count[w]);
}

bool bad_shape(int n, int num_keys, int num_workers) {
  return n < 0 || num_keys < 1 || num_workers < 1 ||
         num_workers > kMaxWorkers;
}

bool vec4_rows(const float* cdf, int num_workers) {
  return num_workers % 4 == 0 && reinterpret_cast<uintptr_t>(cdf) % 16 == 0;
}

// Passes A, B and C of K1 (kMasked false) and K2 on stream s.
template <bool kMasked>
cudaError_t scatter_passes(const int32_t* keys, const int32_t* counters,
                           const uint8_t* valid, const float* cdf,
                           int32_t* dest, int32_t* rank, int32_t* hist,
                           int32_t* tile_scratch, int n, int num_keys,
                           int num_workers, cudaStream_t s) {
  const int num_tiles = (n + kTile - 1) / kTile;
  scatter_tile_kernel<kMasked><<<num_tiles, kThreads, 0, s>>>(
      keys, counters, valid, cdf, n, num_keys, num_workers, num_tiles,
      vec4_rows(cdf, num_workers), dest, rank, tile_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_offsets_kernel<<<num_workers, kThreads, 0, s>>>(tile_scratch,
                                                       num_tiles, hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (num_tiles > 1) {
    add_tile_offsets_kernel<kMasked>
        <<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
            dest, valid, rank, tile_scratch, n, num_tiles);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

int repro_partition_max_workers() { return kMaxWorkers; }

int repro_partition_tile_records() { return kTile; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  tile_scratch holds W * ceil(n / kTile) int32.  Returns a
// cudaError_t (0 on success); launches asynchronously on `stream`.
int repro_partition_scatter(const int32_t* keys, const int32_t* counters,
                            const float* cdf, int32_t* dest, int32_t* rank,
                            int32_t* hist, int32_t* tile_scratch, int n,
                            int num_keys, int num_workers, int device,
                            void* stream) {
  if (bad_shape(n, num_keys, num_workers) || n == 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return scatter_passes<false>(keys, counters, nullptr, cdf, dest, rank,
                               hist, tile_scratch, n, num_keys, num_workers,
                               static_cast<cudaStream_t>(stream));
}

// K2.  valid is one byte a lane (0 = dead); tile_scratch as for K1.
// Returns a cudaError_t (0 on success); launches asynchronously.
int repro_partition_scatter_fold(const int32_t* keys, const int32_t* counters,
                                 const float* vals, const uint8_t* valid,
                                 const float* cdf, int32_t* dest,
                                 int32_t* rank, int32_t* hist,
                                 int32_t* fold_counts, float* fold_sums,
                                 int32_t* tile_scratch, int n, int num_keys,
                                 int num_workers, int device, void* stream) {
  if (bad_shape(n, num_keys, num_workers) || n == 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(fold_counts, 0, sizeof(int32_t) * num_keys,
                             s)) != cudaSuccess)
    return err;
  if ((err = cudaMemsetAsync(fold_sums, 0, sizeof(float) * num_keys, s)) !=
      cudaSuccess)
    return err;
  err = scatter_passes<true>(keys, counters, valid, cdf, dest, rank, hist,
                             tile_scratch, n, num_keys, num_workers, s);
  if (err != cudaSuccess) return err;
  const bool priv = num_keys <= kMaxSharedFoldKeys;
  const size_t smem = priv ? sizeof(int32_t) * 2 * (size_t)num_keys : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fold_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int num_tiles = (n + kTile - 1) / kTile;
  const int blocks = num_tiles < kFoldBlocks ? num_tiles : kFoldBlocks;
  fold_kernel<<<blocks, kThreads, smem, s>>>(keys, vals, valid, n, num_keys,
                                             priv, fold_counts, fold_sums);
  return cudaGetLastError();
}

// K3.  Returns a cudaError_t (0 on success); launches asynchronously.
int repro_partition(const int32_t* keys, const int32_t* counters,
                    const float* cdf, int32_t* dest, int32_t* hist, int n,
                    int num_keys, int num_workers, int device, void* stream) {
  if (bad_shape(n, num_keys, num_workers) || n == 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * num_workers, s);
  if (err != cudaSuccess) return err;
  const int num_tiles = (n + kTile - 1) / kTile;
  partition_tile_kernel<<<num_tiles, kThreads, 0, s>>>(
      keys, counters, cdf, n, num_keys, num_workers,
      vec4_rows(cdf, num_workers), dest, hist);
  return cudaGetLastError();
}

}  // extern "C"
