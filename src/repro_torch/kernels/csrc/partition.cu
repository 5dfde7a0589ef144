// Routing-table partition kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/partition.py:
//   K1 partition_scatter (wrapper :226, kernel _partition_scatter_kernel :137)
//      -> repro_partition_scatter: dest [N], within-destination rank [N],
//         histogram [W], written into one int32 buffer;
//   K2 partition_scatter_fold (wrapper :286, kernel
//      _partition_scatter_fold_kernel :174)
//      -> repro_partition_scatter_fold: K1 over the live lanes of a 1-byte
//         mask, plus the per-key count [K] int32 and sum [K] float32 of the
//         live lanes whose key lies in [0, K), in the same buffer;
//   K3 partition (wrapper :81, kernel _partition_kernel :53)
//      -> repro_partition: dest [N], histogram [W].
//
// The rule, bit-exact with the host partitioner and the plain PyTorch
// versions (repro_torch/kernels/ref.py):
//   u    = (((uint32)counter + 1) * 2654435769 mod 2^32) >> 8, times 2^-24
//   dest = #{w : u >= cdf[key, w]}, clipped to W - 1
// Both steps of u are exact in float32 (a 24-bit integer, then a power of
// two), and u >= cdf is a plain float32 compare, so this file must not be
// built with fast-math.  Keys outside [0, K) are clamped into range (a JAX
// gather clamps too), so no input can read outside the table.
//
// The count by search.  A row of the saturated CDF (routing_cdf32 on the
// host, saturated_cdf32 on the device) is not always non-decreasing: a
// float32 partial sum can round above 1 before the last positive column,
// which is then saturated back to 1.0.  But the count only needs the set
// {w : cdf[w] <= u} to be a prefix of the row, and that holds whenever
//   (a) the weights are non-negative: the unsaturated entries are
//       sequential float32 sums of non-negative terms, and rounding is
//       monotone, so they never decrease;
//   (b) every entry from the row's last positive column on is 1.0;
//   (c) u < 1 (u <= 1 - 2^-24 by construction).
// By (a) the predicate holds on a prefix of the unsaturated entries, and by
// (b) and (c) on none of the saturated ones.  So dest is the length of that
// prefix, found by binary lifting over the row in ceil(log2(W + 1)) loads.
// The wrappers take only such tables (kernels/partition.py); for any other
// table the search and the plain count may differ.  The search beat the
// count of all W compares at every width timed (kernel_variants.py k1k2:
// N = 2^24 at W = 20, 48, 64 and 1024; PERF.md).
//
// Bound on an H100 (3.35 TB/s, NVIDIA data sheet): memory.  Each input is
// read once and each output written once:
//   K1: 16 N + 4 K W + 4 W bytes (keys, counters in; dest, rank, hist out;
//       the cdf table)
//   K2: (key + counter + val bytes + 1 + 8) N + 4 K W + 4 W + 8 K bytes
//       (keys 4 or 8, counters 0, 4 or 8, vals 4 or 8 bytes a lane, the
//       1-byte mask, dest and rank; the table, hist and the two folds)
//   K3: 12 N + 4 K W + 4 W bytes
// The compares, at most N W of them, are far below the operation rate.
//
// Design of K1 and K2 (one kernel, scatter_kernel<kFold, kMulti>).  The TPU
// kernel runs its grid in order and carries running per-worker counts (and
// K2's folds) from block to block in VMEM scratch; GPU blocks run at once
// and in no order.  A tile is kTile = 4096 records on 256 threads, 16 each;
// each warp owns a contiguous slice (512 records in the multi-tile pass;
// a one-tile call is spread evenly over the 8 warps) and walks it in
// groups of 32.  __match_any_sync on dest gives each lane its peers and
// popc(peers & lanes below) its rank in the group; a per-warp [W] count in
// shared memory carries ranks from group to group, and an exclusive scan
// over the tile's warps gives the tile's [W] counts.
//   * One tile (N <= 4096: every K1 call and every K2 ingest of the main
//     paths): one block, one launch, nothing else on the stream.  It
//     writes hist from its counts and, for K2, the [K] folds whole: from
//     shared memory when the fold fits there, else it zeroes them itself
//     before its atomics.  No scratch, no memset.
//   * More tiles: one pass.  Persistent blocks take tiles in order from an
//     atomic ticket, publish each tile's [W] counts as 64-bit status words
//     (call tag | inclusive flag | count) and look back over the earlier
//     tiles' words for the exclusive offsets (decoupled look-back).  A
//     block only waits on tiles with lower tickets, whose blocks are
//     running, so the look-back cannot wait on a block that has not
//     started.  The tag is the workspace's call counter, so stale words of
//     an earlier call never match and nothing is cleared between calls;
//     the last block out resets the ticket and advances the counter.  The
//     tile of ticket 0 zeroes K2's global folds and raises a tagged flag
//     that the other blocks wait for before their first global fold add.
//     The workspace (16 bytes + 8 W tiles) is the wrapper's, allocated
//     zeroed once per device and stream and grown when a call needs more.
// K2's lanes: a dead lane takes the group -1 in __match_any_sync (as a lane
// past the end does), so it is in no live lane's peer set, never touches
// the counts, and gets rank 0; its destination is still written.  The fold
// aggregates within the warp first: peers by key (__match_any_sync), a
// shuffle tree over each peer set, and one count add and one float32 add
// per distinct key per warp, into a private [K] fold in shared memory when
// it fits (K <= kMaxSharedFoldKeys) or into the global folds otherwise.
// Counts are exact; the float32 sums add in an order that varies from run
// to run.  K2 reads int32 or int64 keys and counters (wrapped mod 2^32, as
// .to(torch.int32) does), no counters at all (all zero), and float32 or
// float64 vals (rounded to nearest even, as .to(torch.float32) does).
//
// K3 is one block per tile without ranks: shared-memory atomics build the
// tile histogram and one global atomicAdd per worker per block folds it
// into hist, after a memset.  It routes as K1 does.
//
// Shared memory: (kWarps + 1) W int32 per block (36 KB at W = 1024, so W
// is at most kMaxWorkers = 1024; the wrapper raises above it and the entry
// points return cudaErrorInvalidValue), plus 8 K bytes for a private fold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;         // 4096 records a tile
constexpr int kMaxWorkers = 1024;
constexpr uint32_t kGolden = 2654435769u;            // frac(phi) * 2^32
constexpr int kMaxSharedFoldKeys = 24576;            // 8 K = 192 KB shared
// Calls of at most this many records run the one-tile kernel.
constexpr int kOneTileRecords = kTile;
constexpr unsigned kFull = 0xffffffffu;
// A wait on another block that has not ended after this many reads traps
// (a launch error, not a hung card).
constexpr int kMaxSpins = 1 << 26;

// Entries of the multi-tile workspace (uint32 words), then the status
// words (uint64, [tiles][W]).
enum : int { kTicket = 0, kDone = 1, kCalls = 2, kFoldsZeroed = 3,
             kHeaderWords = 4 };

struct ScatterArgs {
  const void* keys;            // int32 or int64 [n]
  const void* counters;        // int32 or int64 [n], or null: all zero
  const void* vals;            // float32 or float64 [n] (K2)
  const uint8_t* valid;        // [n] (K2)
  const float* cdf;            // [K, W]
  int32_t* dest;               // [n]
  int32_t* rank;               // [n]
  int32_t* hist;               // [W]
  int32_t* fold_counts;        // [K] (K2)
  float* fold_sums;            // [K] (K2)
  uint32_t* ws;                // multi-tile workspace
  int n, num_keys, num_workers, num_tiles;
  int key_bytes, counter_bytes, val_bytes;   // counter_bytes 0: none
  int top;                     // largest power of two <= W
  bool priv;
};

__device__ __forceinline__ float ld_threshold(uint32_t counter) {
  const uint32_t bits = (counter + 1u) * kGolden;   // wraps
  return (float)(bits >> 8) * 0x1p-24f;
}

// Destination of one record (see the count by search above); top is the
// largest power of two <= num_workers.
__device__ __forceinline__ int route(int32_t key, uint32_t counter,
                                     const float* __restrict__ cdf,
                                     int num_keys, int num_workers, int top) {
  key = min(max(key, 0), num_keys - 1);
  const float* row = cdf + (size_t)key * num_workers;
  const float u = ld_threshold(counter);
  int d = 0;
  // Binary lifting: d is the longest prefix known to satisfy cdf <= u.
  for (int step = top; step > 0; step >>= 1) {
    const int probe = d + step;
    if (probe <= num_workers && __ldg(row + probe - 1) <= u) d = probe;
  }
  return min(d, num_workers - 1);
}

// An int32 or int64 column as int32 (wrapped mod 2^32).
__device__ __forceinline__ int32_t load_i32(const void* p, int bytes,
                                            int64_t i) {
  if (bytes == 8)
    return (int32_t)(uint32_t)(uint64_t)__ldg(
        static_cast<const long long*>(p) + i);
  return __ldg(static_cast<const int32_t*>(p) + i);
}

__device__ __forceinline__ float load_f32(const void* p, int bytes,
                                          int64_t i) {
  if (bytes == 8)
    return __double2float_rn(__ldg(static_cast<const double*>(p) + i));
  return __ldg(static_cast<const float*>(p) + i);
}

// The sum of x over each lane's peer set, left at the set's lowest lane (a
// tree over the set: log2 of its size rounds of shuffles).  Every lane of
// the warp must call it.
__device__ __forceinline__ float reduce_peers(unsigned peers, float x) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));     // my place in the set
  unsigned rest = peers & (0xfffffffeu << lane);     // peers above me
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);                    // 0: none left
    const float y = __shfl_sync(kFull, x, (next - 1) & 31);
    if (next) x += y;
    rest &= ~__ballot_sync(kFull, rel & 1);          // absorbed this round
    rel >>= 1;
  }
  return x;
}

__device__ __forceinline__ unsigned long long status_word(uint32_t tag,
                                                          int count) {
  return ((unsigned long long)tag << 32) | (uint32_t)count;
}

// Waits (the whole block) until the tile of ticket 0 has zeroed the global
// folds of this call.
__device__ __forceinline__ void wait_folds_zeroed(const uint32_t* ws,
                                                  uint32_t tag, bool* seen) {
  if (*seen) return;                   // uniform: set under __syncthreads
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int spins = 0;
         *reinterpret_cast<const volatile uint32_t*>(ws + kFoldsZeroed) != tag;
         ++spins)
      if (spins == kMaxSpins) __trap();
    __threadfence();
    *seen = true;
  }
  __syncthreads();
}

// K1 (kFold false) and K2 (kFold true); one block when !kMulti.
template <bool kFold, bool kMulti>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const ScatterArgs a) {
  extern __shared__ int smem[];
  const int W = a.num_workers;
  int* warp_count = smem;                       // [kWarps][W]
  int* tile_off = smem + kWarps * W;            // [W]
  int* s_cnt = tile_off + W;                    // [K] when a.priv
  float* s_sum = reinterpret_cast<float*>(s_cnt + a.num_keys);
  __shared__ int s_ticket;
  __shared__ bool s_zero_seen;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  uint32_t tag = 0;                             // this call's status tag
  unsigned long long* status = nullptr;
  if constexpr (kMulti) {
    const uint32_t calls =
        *reinterpret_cast<const volatile uint32_t*>(a.ws + kCalls);
    tag = ((calls & 0x3fffffffu) + 1u) << 1;    // never 0, low bit free
    status = reinterpret_cast<unsigned long long*>(a.ws + kHeaderWords);
  }
  if (threadIdx.x == 0) s_zero_seen = !kMulti;
  if constexpr (kFold) {
    if (a.priv) {
      for (int k = threadIdx.x; k < a.num_keys; k += kThreads) {
        s_cnt[k] = 0;
        s_sum[k] = 0.0f;
      }
    } else if (!kMulti) {
      for (int k = threadIdx.x; k < a.num_keys; k += kThreads) {
        a.fold_counts[k] = 0;
        a.fold_sums[k] = 0.0f;
      }
    }
  }

  for (;;) {
    int t = 0;
    if constexpr (kMulti) {
      __syncthreads();                          // s_ticket is reused
      if (threadIdx.x == 0) s_ticket = (int)atomicAdd(a.ws + kTicket, 1u);
      __syncthreads();
      t = s_ticket;
      if (t >= a.num_tiles) break;
      if (kFold && t == 0) {
        for (int k = threadIdx.x; k < a.num_keys; k += kThreads) {
          a.fold_counts[k] = 0;
          a.fold_sums[k] = 0.0f;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          __threadfence();
          *reinterpret_cast<volatile uint32_t*>(a.ws + kFoldsZeroed) = tag;
          s_zero_seen = true;
        }
      }
    }
    for (int i = threadIdx.x; i < kWarps * W; i += kThreads)
      warp_count[i] = 0;
    __syncthreads();

    // Groups of 32 records a warp: kPerThread in the multi-tile pass; a
    // one-tile call spreads its records over every warp, so that no warp
    // walks more groups than it must.
    const int64_t tile_start = (int64_t)t * kTile;
    const int groups =
        kMulti ? kPerThread : (a.n + 32 * kWarps - 1) / (32 * kWarps);
    const int64_t warp_start = tile_start + (int64_t)warp * groups * 32;
    int my_dest[kPerThread];
    int my_rank[kPerThread];
    // Route first: the records' loads are independent.
#pragma unroll
    for (int g = 0; g < kPerThread; ++g) {
      const int64_t i = warp_start + g * 32 + lane;
      int d = -1;                               // -1: lane past the end
      if (g < groups && i < a.n) {
        // K1's columns are int32: its instantiation has no other loads.
        const int counter_bytes = kFold ? a.counter_bytes : 4;
        const uint32_t counter =
            counter_bytes ? (uint32_t)load_i32(a.counters, counter_bytes, i)
                          : 0u;
        d = route(load_i32(a.keys, kFold ? a.key_bytes : 4, i), counter,
                  a.cdf, a.num_keys, W, a.top);
      }
      my_dest[g] = d;
    }
    if (kFold && !a.priv) wait_folds_zeroed(a.ws, tag, &s_zero_seen);

#pragma unroll
    for (int g = 0; g < kPerThread; ++g) {
      if (g >= groups) continue;                // uniform over the block
      const int64_t i = warp_start + g * 32 + lane;
      // The counted group: K1 counts every lane it routes; K2 gives a dead
      // lane the group -1 and the mark -1 (rank 0).
      bool live = i < a.n;
      if constexpr (kFold) live = live && a.valid[i] != 0;
      const int c = live ? my_dest[g] : -1;
      const unsigned peers = __match_any_sync(kFull, c);
      int r = -1;
      if (c >= 0) r = warp_count[warp * W + c] + __popc(peers & below);
      __syncwarp();
      if (c >= 0 && (peers & below) == 0)       // lowest lane of the group
        warp_count[warp * W + c] += __popc(peers);
      __syncwarp();
      my_rank[g] = r;
      if constexpr (kFold) {
        // The key and value are read again here (the key from cache):
        // holding them from the first loop costs 32 registers a thread,
        // and the occupancy lost to them costs more than the loads.
        int k = -1;
        float v = 0.0f;
        if (live) {
          k = load_i32(a.keys, a.key_bytes, i);
          if (k >= 0 && k < a.num_keys) v = load_f32(a.vals, a.val_bytes, i);
          else k = -1;
        }
        const unsigned same = __match_any_sync(kFull, k);
        const float sum = reduce_peers(same, v);
        if (k >= 0 && (same & below) == 0) {    // one add per key a warp
          if (a.priv) {
            atomicAdd(s_cnt + k, __popc(same));
            atomicAdd(s_sum + k, sum);
          } else {
            atomicAdd(a.fold_counts + k, __popc(same));
            atomicAdd(a.fold_sums + k, sum);
          }
        }
      }
    }
    __syncthreads();

    // Exclusive scan over the tile's warps, per worker; the total is the
    // tile's count.  One tile: that is hist.  More: it is published at
    // once (inclusive for tile 0, whose offset is 0), and tile_off keeps it
    // for the look-back, which leaves the tiles' offset there.
    for (int w = threadIdx.x; w < W; w += kThreads) {
      int run = 0;
      for (int j = 0; j < kWarps; ++j) {
        const int c = warp_count[j * W + w];
        warp_count[j * W + w] = run;
        run += c;
      }
      if constexpr (kMulti) {
        *reinterpret_cast<volatile unsigned long long*>(
            status + (size_t)t * W + w) = status_word(tag | (t == 0), run);
        tile_off[w] = t == 0 ? 0 : run;
        if (t == 0 && a.num_tiles == 1) a.hist[w] = run;
      } else {
        a.hist[w] = run;
        tile_off[w] = 0;
      }
    }
    if constexpr (kMulti) {
      __syncthreads();
      // The look-back.  A warp takes P workers at a time, D = 32 / P lanes
      // each (P the least power of two with 8 P >= W, at most 32): each
      // lane reads one of the D tiles below the window's top, the window
      // is summed down to its nearest inclusive word (or whole) and slides
      // down by D until one holds an inclusive word.  A word not yet
      // published makes the lanes read their window again.
      int P = 1;
      while (P * kWarps < W && P < 32) P *= 2;
      const int D = 32 / P;
      const int sub = lane / D;
      const int k = lane % D;
      const unsigned ones = D == 32 ? kFull : (1u << D) - 1u;
      for (int base = warp * P; base < W && t > 0; base += kWarps * P) {
        const int w = base + sub;
        const int run = w < W ? tile_off[w] : 0;
        int before = 0;
        bool done = w >= W;                     // uniform over the D lanes
        for (int top = t - 1, spins = 0; __any_sync(kFull, !done); ++spins) {
          if (spins == kMaxSpins) __trap();
          const int j = top - k;
          unsigned long long s = status_word(tag | 1u, 0);  // below tile 0
          if (!done && j >= 0)
            s = *reinterpret_cast<const volatile unsigned long long*>(
                status + (size_t)j * W + w);
          const uint32_t hi = (uint32_t)(s >> 32);
          const unsigned ready =
              (__ballot_sync(kFull, (hi & ~1u) == tag) >> (sub * D)) & ones;
          const unsigned incl =
              (__ballot_sync(kFull, hi == (tag | 1u)) >> (sub * D)) & ones;
          const unsigned need = incl ? incl ^ (incl - 1u) : ones;
          const bool go = (ready & need) == need;
          int v = go && ((need >> k) & 1u) ? (int)(uint32_t)s : 0;
          for (int o = D >> 1; o > 0; o >>= 1)
            v += __shfl_xor_sync(kFull, v, o);
          if (!done && go) {
            before += v;
            if (incl) done = true;
            else top -= D;
          }
        }
        if (w < W && k == 0) {
          *reinterpret_cast<volatile unsigned long long*>(
              status + (size_t)t * W + w) =
              status_word(tag | 1u, before + run);
          tile_off[w] = before;
          if (t == a.num_tiles - 1) a.hist[w] = before + run;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kPerThread; ++g) {
      const int64_t i = warp_start + g * 32 + lane;
      if (g < groups && i < a.n) {
        const int d = my_dest[g];
        a.dest[i] = d;
        a.rank[i] = my_rank[g] < 0
                        ? 0
                        : my_rank[g] + warp_count[warp * W + d] + tile_off[d];
      }
    }
    if constexpr (!kMulti) break;
  }

  if constexpr (kFold) {
    if (a.priv) {
      __syncthreads();
      if constexpr (kMulti) {
        wait_folds_zeroed(a.ws, tag, &s_zero_seen);
        for (int k = threadIdx.x; k < a.num_keys; k += kThreads) {
          if (s_cnt[k] != 0) {
            atomicAdd(a.fold_counts + k, s_cnt[k]);
            atomicAdd(a.fold_sums + k, s_sum[k]);
          }
        }
      } else {
        for (int k = threadIdx.x; k < a.num_keys; k += kThreads) {
          a.fold_counts[k] = s_cnt[k];
          a.fold_sums[k] = s_sum[k];
        }
      }
    }
  }
  if constexpr (kMulti) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(a.ws + kDone, 1u) == gridDim.x - 1) {   // the last out
        a.ws[kTicket] = 0;
        a.ws[kDone] = 0;
        a.ws[kCalls] += 1;
      }
    }
  }
}

// K3: dest and histogram.
__global__ void __launch_bounds__(kThreads)
partition_tile_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ counters,
                      const float* __restrict__ cdf, int n, int num_keys,
                      int num_workers, int top,
                      int32_t* __restrict__ dest, int32_t* __restrict__ hist) {
  __shared__ int tile_count[kMaxWorkers];
  for (int w = threadIdx.x; w < num_workers; w += kThreads) tile_count[w] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * kTile;
#pragma unroll 4
  for (int g = 0; g < kPerThread; ++g) {
    const int64_t i = start + g * kThreads + threadIdx.x;
    if (i < n) {
      const int d = route(keys[i], (uint32_t)counters[i], cdf, num_keys,
                          num_workers, top);
      dest[i] = d;
      atomicAdd(&tile_count[d], 1);
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < num_workers; w += kThreads)
    if (tile_count[w]) atomicAdd(&hist[w], tile_count[w]);
}

__global__ void empty_kernel() {}

bool bad_shape(int n, int num_keys, int num_workers) {
  return n < 1 || num_keys < 1 || num_workers < 1 ||
         num_workers > kMaxWorkers;
}

int top_power(int num_workers) {
  int top = 1;
  while (2 * top <= num_workers) top *= 2;
  return top;
}

// Makes `device` current if it is not (the stream belongs to it).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

cudaError_t device_info(int device, DeviceInfo* out) {
  static DeviceInfo cache[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& d = cache[device];
  if (d.sms == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) {
      d.sms = 0;
      return err;
    }
  }
  *out = d;
  return cudaSuccess;
}

// Lets scatter_kernel<kFold, kMulti> take `smem` bytes of dynamic shared
// memory (needed above 48 KB, before the occupancy query and the launch).
template <bool kFold, bool kMulti>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(scatter_kernel<kFold, kMulti>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// K1 (kFold false) and K2 on stream s: one launch.
template <bool kFold>
cudaError_t scatter(ScatterArgs a, int device, cudaStream_t s) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  DeviceInfo info;
  if ((err = device_info(device, &info)) != cudaSuccess) return err;
  a.num_tiles = (a.n + kTile - 1) / kTile;
  a.top = top_power(a.num_workers);
  const size_t base = sizeof(int) * (size_t)(kWarps + 1) * a.num_workers;
  const size_t fold = 8 * (size_t)a.num_keys;
  // 1 KB of the opt-in limit is left for the static shared memory.
  a.priv = kFold && a.num_keys <= kMaxSharedFoldKeys &&
           base + fold + 1024 <= (size_t)info.smem_optin;
  const size_t smem = base + (a.priv ? fold : 0);
  if (a.n <= kOneTileRecords) {
    if ((err = allow_smem<kFold, false>(smem)) != cudaSuccess) return err;
    scatter_kernel<kFold, false><<<1, kThreads, smem, s>>>(a);
    return cudaGetLastError();
  }
  if (a.ws == nullptr) return cudaErrorInvalidValue;
  if ((err = allow_smem<kFold, true>(smem)) != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scatter_kernel<kFold, true>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * info.sms < a.num_tiles ? per_sm * info.sms
                                                   : a.num_tiles;
  scatter_kernel<kFold, true><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_partition_max_workers() { return kMaxWorkers; }

int repro_partition_tile_records() { return kTile; }

int repro_partition_one_tile_records() { return kOneTileRecords; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  out: dest [n], rank [n], hist [W] (int32).  ws: the zeroed
// workspace (4 + 2 W ceil(n / kTile) uint32), read only when n > kTile.
// Returns a cudaError_t (0 on success); one launch, asynchronous on
// `stream`.
int repro_partition_scatter(const int32_t* keys, const int32_t* counters,
                            const float* cdf, int32_t* out, uint32_t* ws,
                            int n, int num_keys, int num_workers, int device,
                            void* stream) {
  if (bad_shape(n, num_keys, num_workers)) return cudaErrorInvalidValue;
  ScatterArgs a{};
  a.keys = keys;
  a.counters = counters;
  a.cdf = cdf;
  a.dest = out;
  a.rank = out + n;
  a.hist = out + 2 * (size_t)n;
  a.ws = ws;
  a.n = n;
  a.num_keys = num_keys;
  a.num_workers = num_workers;
  a.key_bytes = a.counter_bytes = 4;
  return scatter<false>(a, device, static_cast<cudaStream_t>(stream));
}

// K2.  keys: key_bytes 4 or 8; counters: counter_bytes 4 or 8, or null
// with 0 (all zero); vals: val_bytes 4 (float32) or 8 (float64); valid one
// byte a lane (0 = dead).  out: dest [n], rank [n], hist [W], fold_counts
// [K] (int32), fold_sums [K] (float32 bits); ws as for K1.  Returns a
// cudaError_t (0 on success); one launch, asynchronous on `stream`.
int repro_partition_scatter_fold(const void* keys, int key_bytes,
                                 const void* counters, int counter_bytes,
                                 const void* vals, int val_bytes,
                                 const uint8_t* valid, const float* cdf,
                                 int32_t* out, uint32_t* ws, int n,
                                 int num_keys, int num_workers, int device,
                                 void* stream) {
  if (bad_shape(n, num_keys, num_workers) ||
      (key_bytes != 4 && key_bytes != 8) ||
      (val_bytes != 4 && val_bytes != 8) ||
      (counters ? counter_bytes != 4 && counter_bytes != 8
                : counter_bytes != 0))
    return cudaErrorInvalidValue;
  ScatterArgs a{};
  a.keys = keys;
  a.counters = counters;
  a.vals = vals;
  a.valid = valid;
  a.cdf = cdf;
  a.dest = out;
  a.rank = out + n;
  a.hist = out + 2 * (size_t)n;
  a.fold_counts = a.hist + num_workers;
  a.fold_sums = reinterpret_cast<float*>(a.fold_counts + num_keys);
  a.ws = ws;
  a.n = n;
  a.num_keys = num_keys;
  a.num_workers = num_workers;
  a.key_bytes = key_bytes;
  a.counter_bytes = counter_bytes;
  a.val_bytes = val_bytes;
  return scatter<true>(a, device, static_cast<cudaStream_t>(stream));
}

// K3.  Returns a cudaError_t (0 on success); launches asynchronously.
int repro_partition(const int32_t* keys, const int32_t* counters,
                    const float* cdf, int32_t* dest, int32_t* hist, int n,
                    int num_keys, int num_workers, int device, void* stream) {
  if (bad_shape(n, num_keys, num_workers)) return cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * num_workers, s);
  if (err != cudaSuccess) return err;
  const int num_tiles = (n + kTile - 1) / kTile;
  partition_tile_kernel<<<num_tiles, kThreads, 0, s>>>(
      keys, counters, cdf, n, num_keys, num_workers, top_power(num_workers),
      dest, hist);
  return cudaGetLastError();
}

// An empty kernel on `stream`: the launch floor of this library's ctypes
// path, for timing beside the kernels.
int repro_partition_empty(int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
