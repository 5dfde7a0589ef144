// The in-dispatch skew controller's step: one super-tick window of metric
// rounds against the device-held controller state, on one block, with one
// warp running the rounds.
//
// Replaces the JAX package's jitted ``controller_step``
// (src/repro/dataflow/device.py:829, _make_ctrl_step), with
// repro_torch.kernels.ref.ctrl_step as its plain version.  One launch
// covers the window [t0, t0 + k):
//
//   1. the whole block stages phi, the small state arrays and (when they
//      fit, see kRingSmemMax) the observation rings in shared memory, folds
//      the per-key arrivals into per-owner counts (integer atomics: exact in
//      any order), zeroes them, and ranks the workers by phi;
//   2. warp 0 appends (phi, arrivals) to the observation log, then runs
//      every metric round of the window in the host controller's order:
//      the tracker update, the mitigations in mit_seq order, adaptive tau,
//      detection and the helper pass, with the phase-1 / phase-2 rewrites
//      of the float64 weights;
//   3. if a rewrite moved ``epoch``, the whole block rebuilds the routing
//      consts: the float32 saturated row-CDF (sequential over the W
//      columns of a row), primary (the first arg-max) and is_split.
//
// Bit identity with the host controller: every decision is a chain of
// float64 operations in the host's order, so each is written with the
// round-to-nearest intrinsics (__dadd_rn, __dmul_rn, ...), which nvcc never
// contracts into a fused multiply-add; the CDF adds with __fadd_rn on
// __double2float_rn.  Two-argument max and min follow Python's (the first
// argument unless the second is strictly greater / smaller).  Where the
// reference masks an update by a predicate, this code branches on it: a
// masked-off update is the identity, so skipping it is exact.
//
// What bounds it.  Bit identity keeps every ring mean, every stderr and
// every sum over workers a sequential chain of dependent float64 adds (a
// ring's n samples oldest first, a total's W means in worker order), and
// the mitigations of a round run one after another (each one's reset and
// rewrite feed the next).  So a step takes at least the longest such chain
// times the float64 add latency, plus the launch; the bytes it moves
// (tens of KB) and its operation count are far below either.
//
// Lane layout.  Lane l of warp 0 owns the workers w = l (mod 32): their
// ring means and stderrs, their flags and their entries of the small
// state arrays.  A lane walks a ring in its two contiguous spans (from
// the oldest sample to the row's end, then from the row's start), so no
// modulo sits in the chain, and the W rings of a predicted shares run at
// once, 32 chains abreast.  Keys k = l (mod 32) are lane l's in the
// phase-1 / phase-2 rewrites; ``changed`` is a warp vote.  Values every
// lane needs (tau, the decisions, a total over workers) are computed by
// every lane from the same shared values in the same order, so they agree
// bit for bit with no broadcast; a total over workers is still W adds in
// worker order, never a shuffle tree.  Arg-max / arg-min scans become warp
// reductions over ranks: phi is fixed for the launch, so each worker's
// rank in (phi descending, index) and (phi ascending, index) order is
// taken once, and the serial scans' choice (the first index among equal
// values; -0.0 equals +0.0) is the candidate of least rank.  The helper
// choice (f_hat, phi, index) reduces (f_hat's order key, the ascending
// rank) the same way.  Comparisons only: exact.
//
// Why the memoised means are exact.  A worker's mean and stderr are
// functions of its ring (row, n, pos) alone.  Shared memory keeps each
// with a valid flag.  Every flag starts clear, and the only write to a
// ring, the tracker update, runs in the window's first round before any
// mean is taken; a divergence's reset_samples sets n = 0, whose mean is
// 0.0 and stderr +inf by definition, so those are stored as they are.  A
// later predicted shares, stderr or phase-2 rewrite in the window reuses
// a valid value, which is the value the same chain would compute again;
// the shares themselves are kept until a mean changes.
//
// Shared memory: ~100 bytes a worker plus the rings (8 W window bytes)
// when they fit in kRingSmemMax; wider states read the rings in place in
// global memory (the same code through a generic pointer; the loads of a
// chain do not depend on its adds, so they pipeline).  phi rides in the
// launch's parameter block up to kPhiParam workers (the parameters are
// copied at launch: no staging copy, no event); a wider W passes a device
// pointer the wrapper fills by one pinned host-to-device copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;
constexpr int kPhase1 = 2;   // MitigationPhase.PHASE_ONE.value
constexpr int kPhase2 = 3;   // MitigationPhase.PHASE_TWO.value
// phi in the parameter block up to this many workers (1 KB of the 4 KB a
// launch's parameters may hold); kernels/ctrl_step.py's PHI_PARAM.
constexpr int kPhiParam = 128;
// The rings are staged in shared memory up to this many bytes.
constexpr size_t kRingSmemMax = 160 * 1024;

// Field for field the ctypes structure in repro_torch/kernels/ctrl_step.py.
struct CtrlArgs {
  double* weights;          // [K, W]
  float* cdf;               // [K, W]
  int64_t* primary;         // [K]
  uint8_t* is_split;        // [K]
  const int64_t* owner;     // [K]
  double* obs;              // [W, window]
  int32_t* obs_n;           // [W]
  int32_t* obs_pos;         // [W]
  double* tau;              // [1]
  int32_t* tau_adj;         // [1]
  uint8_t* mit_active;      // [W]
  int32_t* mit_helper;      // [W]
  int32_t* mit_phase;       // [W]
  int32_t* mit_calm;        // [W]
  int32_t* mit_seq;         // [W]
  int32_t* seq_next;        // [1]
  int32_t* epoch;           // [1]
  double* log_phi;          // [R, W]
  double* log_arr;          // [R, W]
  int32_t* log_n;           // [1]
  int64_t* arrived;         // [K], zeroed
  const double* phi;        // [W] on the card when W > kPhiParam, else unused
  int64_t t0;
  int64_t k;
  double tuples_left;
  double eta;
  double eps_lower;
  double eps_upper;
  double tau_increase;
  double catchup_tolerance;
  double horizon;
  int32_t K;
  int32_t W;
  int32_t window;
  int32_t R;
  int32_t metric_period;
  int32_t initial_delay;
  int32_t max_tau_adjustments;
  int32_t retire_window;
  int32_t adaptive_tau;
  int32_t enable_phase1;
  double phi_param[kPhiParam];   // phi itself when W <= kPhiParam
};

__host__ __device__ __forceinline__ bool rings_staged(int W, int window) {
  return static_cast<size_t>(W) * window * 8 <= kRingSmemMax;
}

// Dynamic shared memory: 8-byte arrays, then 4-byte, then bytes.
__host__ __device__ __forceinline__ size_t smem_bytes(int W, int window) {
  const size_t w = static_cast<size_t>(W);
  return w * (6 * 8 + 11 * 4 + 7)
         + (rings_staged(W, window) ? w * window * 8 : 0);
}

struct Shared {
  unsigned long long* arr;  // owner-attributed arrivals
  double* phi;
  double* mean;             // memoised ring means ...
  double* sd;               // ... and stderrs
  double* fhat;             // the predicted shares
  unsigned long long* mkey; // (seq, index) of an active mitigation, or ~0
  double* ring;             // the rings (or the global ones in place)
  int32_t* obs_n;
  int32_t* obs_pos;
  int32_t* helper;
  int32_t* phase;
  int32_t* calm;
  int32_t* seq;
  uint32_t* rank_hi;        // rank by (phi descending, index); kNone: NaN
  uint32_t* rank_lo;        // rank by (phi ascending, index); kNone: NaN
  int32_t* by_hi;           // the worker of each rank
  int32_t* by_lo;
  int32_t* order;           // this round's mitigations in mit_seq order
  uint8_t* active;
  uint8_t* mean_ok;
  uint8_t* sd_ok;
  uint8_t* taken;
  uint8_t* free_;
  uint8_t* skewed;
  uint8_t* processed;
};

__device__ __forceinline__ Shared carve(unsigned long long* base,
                                        const CtrlArgs& a) {
  const int W = a.W;
  Shared s;
  double* d = reinterpret_cast<double*>(base);
  s.arr = base;
  s.phi = d + W;
  s.mean = d + 2 * W;
  s.sd = d + 3 * W;
  s.fhat = d + 4 * W;
  s.mkey = base + 5 * W;
  const bool staged = rings_staged(W, a.window);
  s.ring = staged ? d + 6 * W : a.obs;
  int32_t* i = reinterpret_cast<int32_t*>(
      d + 6 * W + (staged ? static_cast<size_t>(W) * a.window : 0));
  s.obs_n = i;
  s.obs_pos = i + W;
  s.helper = i + 2 * W;
  s.phase = i + 3 * W;
  s.calm = i + 4 * W;
  s.seq = i + 5 * W;
  s.rank_hi = reinterpret_cast<uint32_t*>(i + 6 * W);
  s.rank_lo = reinterpret_cast<uint32_t*>(i + 7 * W);
  s.by_hi = i + 8 * W;
  s.by_lo = i + 9 * W;
  s.order = i + 10 * W;
  uint8_t* b = reinterpret_cast<uint8_t*>(i + 11 * W);
  s.active = b;
  s.mean_ok = b + W;
  s.sd_ok = b + 2 * W;
  s.taken = b + 3 * W;
  s.free_ = b + 4 * W;
  s.skewed = b + 5 * W;
  s.processed = b + 6 * W;
  return s;
}

__device__ __forceinline__ double pymax(double a, double b) {
  return b > a ? b : a;
}

__device__ __forceinline__ double pymin(double a, double b) {
  return b < a ? b : a;
}

// An unsigned key in the order of the doubles (not NaN); -0.0 and +0.0,
// equal as doubles, get one key.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(__dadd_rn(x, 0.0)));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// f(x) for the n valid entries of a ring row ending just before slot pos,
// oldest first, span by span: the order of the host's chain.
template <class F>
__device__ __forceinline__ void ring_walk(const double* row, int n, int pos,
                                          int win, F f) {
  int i = ((pos - n) % win + win) % win;
  while (n > 0) {
    const int len = min(n, win - i);
    const double* p = row + i;
#pragma unroll 8
    for (int j = 0; j < len; ++j) f(p[j]);
    n -= len;
    i = 0;
  }
}

__device__ __forceinline__ double ring_mean(const double* row, int n, int pos,
                                            int win) {
  if (n <= 0) return 0.0;
  double acc = 0.0;
  ring_walk(row, n, pos, win, [&](double x) { acc = __dadd_rn(acc, x); });
  return __ddiv_rn(acc, static_cast<double>(n));
}

__device__ __forceinline__ double ring_stderr(const double* row, int n,
                                              int pos, int win, double mean) {
  if (n < 2) return INFINITY;
  double ssq = 0.0;
  ring_walk(row, n, pos, win, [&](double x) {
    const double d = __dsub_rn(x, mean);
    ssq = __dadd_rn(ssq, __dmul_rn(d, d));
  });
  const double nf = static_cast<double>(n);
  const double d = __dsqrt_rn(__ddiv_rn(ssq, __dsub_rn(nf, 1.0)));
  return __dmul_rn(d, __dsqrt_rn(__dadd_rn(1.0, __ddiv_rn(1.0, nf))));
}

// x / 2.0 is x * 0.5 to the bit (one exact value, rounded once), without
// a divide's latency.
__device__ __forceinline__ double phase2_fraction(double f_s, double f_h) {
  const double avg = __dmul_rn(__dadd_rn(f_s, f_h), 0.5);
  double give = pymax(__dsub_rn(avg, f_h), 0.0);
  const double max_total = pymax(__dsub_rn(f_s, avg), 0.0);
  if (give > max_total && max_total > 0.0) {
    give = __dmul_rn(give, __ddiv_rn(max_total, give));
  }
  return f_s > 0.0 ? __ddiv_rn(give, f_s) : 0.0;
}

// Every metric round of the window, on warp 0 (all 32 lanes, in uniform
// control flow: every warp-wide intrinsic below is reached by all).
// Returns the epoch.
__device__ __forceinline__ int32_t rounds(const CtrlArgs& a, const Shared& s,
                                          const int lane, const bool staged) {
  const int W = a.W;
  const int K = a.K;
  const int win = a.window;
  double tau = *a.tau;
  int32_t tau_adj = *a.tau_adj;
  int32_t seq_next = *a.seq_next;
  int32_t epoch = *a.epoch;
  bool shares_ok = false;
  const double even = __ddiv_rn(1.0, static_cast<double>(W));

  auto own = [&](int w) { return w % kLanes == lane; };
  auto row_of = [&](int w) { return s.ring + static_cast<size_t>(w) * win; };
  auto ensure_mean = [&](int w) {   // the owner lane only
    if (!s.mean_ok[w]) {
      s.mean[w] = ring_mean(row_of(w), s.obs_n[w], s.obs_pos[w], win);
      s.mean_ok[w] = 1;
    }
  };
  auto ensure_sd = [&](int w) {     // the owner lane only
    if (!s.sd_ok[w]) {
      ensure_mean(w);
      s.sd[w] = ring_stderr(row_of(w), s.obs_n[w], s.obs_pos[w], win,
                            s.mean[w]);
      s.sd_ok[w] = 1;
    }
  };
  // max(stderr(x), stderr(y)): each on its owner's lane.
  auto stderr_pair = [&](int x, int y) {
    __syncwarp();
    if (own(x)) ensure_sd(x);
    if (own(y)) ensure_sd(y);
    __syncwarp();
    const double e = pymax(s.sd[x], s.sd[y]);
    __syncwarp();
    return e;
  };
  auto reset = [&](int w) {         // reset_samples, on the owner lane
    if (own(w)) {
      s.obs_n[w] = 0;
      s.mean[w] = 0.0;
      s.sd[w] = INFINITY;
      s.mean_ok[w] = 1;
      s.sd_ok[w] = 1;
    }
  };
  // The predicted shares into s.fhat: the stale means on their lanes,
  // then the total in worker order on every lane.
  auto shares = [&]() {
    if (shares_ok) return;
    __syncwarp();
    for (int w = lane; w < W; w += kLanes) ensure_mean(w);
    __syncwarp();
    double total = 0.0;
    for (int w = 0; w < W; ++w) total = __dadd_rn(total, s.mean[w]);
    for (int w = lane; w < W; w += kLanes) {
      s.fhat[w] = total <= 0.0 ? even : __ddiv_rn(s.mean[w], total);
    }
    __syncwarp();
    shares_ok = true;
  };
  // plan_phase1 (full partition): every key owned by sw with sw-mass hands
  // that mass to h.  Returns whether any row changed.
  auto phase1 = [&](int sw, int h) {
    int changed = 0;
    for (int key = lane; key < K; key += kLanes) {
      double* row = a.weights + static_cast<size_t>(key) * W;
      if (a.owner[key] == sw && row[sw] > 0.0) {
        row[h] = __dadd_rn(row[h], row[sw]);
        row[sw] = 0.0;
        changed = 1;
      }
    }
    return __any_sync(kFull, changed) ? 1 : 0;
  };
  // plan_phase2 (SBR, one helper): every key owned by sw gets the row
  // [sw: 1 - r, h: 0 + r] from the predicted shares.
  auto phase2 = [&](int sw, int h) {
    shares();
    const double r = phase2_fraction(s.fhat[sw], s.fhat[h]);
    const double keep = __dsub_rn(1.0, r);
    const double give = __dadd_rn(0.0, r);   // -0.0 -> +0.0, as the host
    int changed = 0;
    for (int key = lane; key < K; key += kLanes) {
      if (a.owner[key] != sw) continue;
      double* row = a.weights + static_cast<size_t>(key) * W;
      for (int j = 0; j < W; ++j) row[j] = 0.0;
      row[sw] = keep;
      row[h] = give;
      changed = 1;
    }
    return __any_sync(kFull, changed) ? 1 : 0;
  };

  bool arrivals = true;   // the first round drains the window's arrivals
  for (int64_t i = 0; i < a.k; ++i) {
    const int64_t t = a.t0 + i;
    if (t < a.initial_delay || (t - a.initial_delay) % a.metric_period != 0) {
      continue;
    }
    // ---- tracker.update ------------------------------------------------
    if (arrivals) {
      arrivals = false;
      double total = 0.0;
      for (int w = 0; w < W; ++w) {
        total = __dadd_rn(total, static_cast<double>(s.arr[w]));
      }
      if (total > 0.0) {
        const double scale = __ddiv_rn(a.horizon, total);
        for (int w = lane; w < W; w += kLanes) {
          const double x = __dmul_rn(static_cast<double>(s.arr[w]), scale);
          const size_t at = static_cast<size_t>(w) * win + s.obs_pos[w];
          s.ring[at] = x;
          if (staged) a.obs[at] = x;
          s.obs_n[w] = min(s.obs_n[w] + 1, win);
          s.obs_pos[w] = (s.obs_pos[w] + 1) % win;
        }
      }
    }
    // ---- _advance_mitigations, in mit_seq order ------------------------
    // The order is fixed at the round's start: a mitigation changes no
    // other's seq or activity.  An active worker's place is the count of
    // active (seq, index) keys below its own.
    __syncwarp();
    for (int w = lane; w < W; w += kLanes) {
      s.mkey[w] = s.active[w]
          ? (static_cast<unsigned long long>(
                 static_cast<uint32_t>(s.seq[w]) ^ 0x80000000u) << 32)
                | static_cast<uint32_t>(w)
          : ~0ull;
    }
    __syncwarp();
    int nact = 0;
    for (int w = lane; w < W; w += kLanes) {
      const unsigned long long key = s.mkey[w];
      if (key == ~0ull) continue;
      int pos = 0;
#pragma unroll 8
      for (int v = 0; v < W; ++v) pos += s.mkey[v] < key;
      s.order[pos] = w;
      ++nact;
    }
    nact = __reduce_add_sync(kFull, nact);
    __syncwarp();
    for (int j = 0; j < nact; ++j) {
      const int sw = s.order[j];
      const int h = s.helper[sw];
      const int phase = s.phase[sw];
      const double q_s = s.phi[sw];
      const double q_h = s.phi[h];
      const double top = pymax(pymax(q_s, q_h), 1.0);
      const bool p1_to_p2 =
          phase == kPhase1
          && q_h >= __dsub_rn(q_s, __dmul_rn(a.catchup_tolerance, top));
      const bool in_p2 = phase == kPhase2;
      const bool s_ahead = q_s >= a.eta && __dsub_rn(q_s, q_h) >= tau;
      const bool h_ahead = q_h >= a.eta && __dsub_rn(q_h, q_s) >= tau;
      const bool calm = in_p2 && !(s_ahead || h_ahead);
      const bool div = in_p2 && (s_ahead || h_ahead);
      const int new_calm = s.calm[sw] + 1;
      const bool retire =
          calm && a.retire_window > 0 && new_calm >= a.retire_window;
      if (div) {
        // adaptive tau on divergence (eps before the resets)
        const double eps = stderr_pair(sw, h);
        if (a.adaptive_tau && isfinite(eps) && eps > a.eps_upper
            && tau_adj < a.max_tau_adjustments) {
          tau = __dadd_rn(tau, a.tau_increase);
          tau_adj += 1;
        }
        // reset_samples([sw, h]): n = 0, whose mean is 0 and stderr inf
        reset(sw);
        reset(h);
        shares_ok = false;
      }
      bool start_p1 = div && s_ahead;
      bool start_p2 = (div && !s_ahead) || p1_to_p2;
      if (!a.enable_phase1) {
        start_p2 = start_p2 || start_p1;
        start_p1 = false;
      }
      if (start_p1) {
        epoch += phase1(sw, h);
      } else if (start_p2) {
        epoch += phase2(sw, h);   // post-reset shares
      }
      __syncwarp();
      if (lane == 0) {
        if (start_p1) {
          s.phase[sw] = kPhase1;
        } else if (start_p2) {
          s.phase[sw] = kPhase2;
        }
        if (calm) {
          s.calm[sw] = new_calm;
        } else if (div) {
          s.calm[sw] = 0;
        }
        if (retire) s.active[sw] = 0;
      }
      __syncwarp();
    }
    // ---- _detect -------------------------------------------------------
    for (int w = lane; w < W; w += kLanes) s.taken[w] = s.active[w];
    __syncwarp();
    for (int w = lane; w < W; w += kLanes) {
      if (s.active[w]) s.taken[s.helper[w]] = 1;   // busy (the same 1)
    }
    __syncwarp();
    int nfree = 0;
    uint32_t r_hi = kNone, r_lo = kNone;
    for (int w = lane; w < W; w += kLanes) {
      const bool f = !s.taken[w];
      s.free_[w] = f;
      if (!f) continue;
      ++nfree;
      if (s.phi[w] > -INFINITY) r_hi = min(r_hi, s.rank_hi[w]);
      if (s.phi[w] < INFINITY) r_lo = min(r_lo, s.rank_lo[w]);
    }
    nfree = __reduce_add_sync(kFull, nfree);
    r_hi = __reduce_min_sync(kFull, r_hi);
    r_lo = __reduce_min_sync(kFull, r_lo);
    const int s0 = r_hi == kNone ? 0 : s.by_hi[r_hi];
    const int h0 = r_lo == kNone ? 0 : s.by_lo[r_lo];
    // eps is read only where nfree >= 2 (``app`` below)
    const double eps0 = nfree >= 2 ? stderr_pair(s0, h0) : INFINITY;
    // adjust_tau
    const double phi_s = s.phi[s0];
    const double gap = __dsub_rn(phi_s, s.phi[h0]);
    const bool enabled = a.adaptive_tau && tau_adj < a.max_tau_adjustments;
    const bool finite = isfinite(eps0);
    const bool passes = gap >= tau && phi_s >= a.eta;
    const bool inc = enabled && finite && passes && eps0 > a.eps_upper;
    const bool dec = enabled && finite && !passes && eps0 < a.eps_lower
                     && gap > 0.0 && phi_s >= a.eta;
    const double t_new = inc ? __dadd_rn(tau, a.tau_increase)
                             : dec ? pymax(gap, 1e-9) : tau;
    const bool app = nfree >= 2 && finite;
    const double detect_tau = app && dec ? t_new : tau;
    if (app && (inc || dec)) {
      tau = t_new;
      tau_adj += 1;
    }
    // the skewed set: free workers >= eta whose gap to the free minimum
    // (excluding themselves) reaches detect_tau; the free minimum is h0's
    const int i1 = h0;
    const double m1 = r_lo == kNone ? INFINITY : s.phi[h0];
    uint32_t r2 = kNone;
    for (int w = lane; w < W; w += kLanes) {
      if (s.free_[w] && w != i1 && s.phi[w] < INFINITY) {
        r2 = min(r2, s.rank_lo[w]);
      }
    }
    r2 = __reduce_min_sync(kFull, r2);
    const double m2 = r2 == kNone ? INFINITY : s.phi[s.by_lo[r2]];
    for (int w = lane; w < W; w += kLanes) {
      const bool sk = s.free_[w] && s.phi[w] >= a.eta
                      && __dsub_rn(s.phi[w], w == i1 ? m2 : m1) >= detect_tau;
      s.skewed[w] = sk;
      if (sk) s.taken[w] = 1;   // skewed workers cannot help
      s.processed[w] = 0;
    }
    shares();
    const double L = a.tuples_left;
    for (;;) {
      // the next skewed worker: the largest phi, the first index
      uint32_t r = kNone;
      for (int w = lane; w < W; w += kLanes) {
        if (s.skewed[w] && !s.processed[w]) r = min(r, s.rank_hi[w]);
      }
      r = __reduce_min_sync(kFull, r);
      if (r == kNone) break;   // no skewed worker left
      const int sw = s.by_hi[r];
      if (own(sw)) s.processed[sw] = 1;
      // choose_helpers, max_helpers=1: the lexicographic minimum by
      // (f_hat, phi, index) over the candidates, which all become taken
      const double phs = s.phi[sw];
      unsigned long long fk = ~0ull;
      uint32_t rk = kNone;
      for (int w = lane; w < W; w += kLanes) {
        if (!s.free_[w] || s.taken[w] || w == sw
            || !(__dsub_rn(phs, s.phi[w]) >= detect_tau)) {
          continue;
        }
        s.taken[w] = 1;
        const unsigned long long key = order_key(s.fhat[w]);
        if (key < fk || (key == fk && s.rank_lo[w] < rk)) {
          fk = key;
          rk = s.rank_lo[w];
        }
      }
      for (int off = kLanes / 2; off > 0; off /= 2) {
        const unsigned long long ok = __shfl_xor_sync(kFull, fk, off);
        const uint32_t orank = __shfl_xor_sync(kFull, rk, off);
        if (ok < fk || (ok == fk && orank < rk)) {
          fk = ok;
          rk = orank;
        }
      }
      if (rk == kNone) continue;   // no candidate
      const int h = s.by_lo[rk];
      const double f_s = s.fhat[sw], f_h = s.fhat[h];
      const double lr_max =
          __dmul_rn(__dsub_rn(f_s, __dmul_rn(__dadd_rn(f_s, f_h), 0.5)), L);
      const double future = __dmul_rn(pymax(L, 0.0), f_s);   // infinite rate
      if (!(pymin(lr_max, future) >= -1e-12)) continue;
      // phase2 reuses the shares above: nothing changed them since
      epoch += a.enable_phase1 ? phase1(sw, h) : phase2(sw, h);
      __syncwarp();
      if (lane == 0) {
        s.phase[sw] = a.enable_phase1 ? kPhase1 : kPhase2;
        s.active[sw] = 1;
        s.helper[sw] = h;
        s.calm[sw] = 0;
        s.seq[sw] = seq_next;
      }
      seq_next += 1;
      __syncwarp();
    }
  }
  __syncwarp();
  for (int w = lane; w < W; w += kLanes) {
    a.obs_n[w] = s.obs_n[w];
    a.obs_pos[w] = s.obs_pos[w];
    a.mit_active[w] = s.active[w];
    a.mit_helper[w] = s.helper[w];
    a.mit_phase[w] = s.phase[w];
    a.mit_calm[w] = s.calm[w];
    a.mit_seq[w] = s.seq[w];
  }
  if (lane == 0) {
    *a.tau = tau;
    *a.tau_adj = tau_adj;
    *a.seq_next = seq_next;
  }
  return epoch;
}

__global__ void __launch_bounds__(kThreads)
ctrl_step_kernel(const CtrlArgs a) {
  extern __shared__ unsigned long long smem[];
  __shared__ int32_t s_epoch[2];
  const int W = a.W;
  const int tid = threadIdx.x;
  const bool staged = rings_staged(W, a.window);
  const Shared s = carve(smem, a);
  // 1. stage phi, the small state and the rings; fold the arrivals
  for (int w = tid; w < W; w += blockDim.x) {
    s.arr[w] = 0ull;
    s.phi[w] = W <= kPhiParam ? a.phi_param[w] : a.phi[w];
    s.obs_n[w] = a.obs_n[w];
    s.obs_pos[w] = a.obs_pos[w];
    s.active[w] = a.mit_active[w] != 0;
    s.helper[w] = a.mit_helper[w];
    s.phase[w] = a.mit_phase[w];
    s.calm[w] = a.mit_calm[w];
    s.seq[w] = a.mit_seq[w];
    s.mean_ok[w] = 0;
    s.sd_ok[w] = 0;
  }
  if (staged) {
    const int n = W * a.window;
    for (int i = tid; i < n; i += blockDim.x) s.ring[i] = a.obs[i];
  }
  __syncthreads();
  for (int key = tid; key < a.K; key += blockDim.x) {
    const int64_t n = a.arrived[key];
    if (n != 0) {
      atomicAdd(&s.arr[a.owner[key]], static_cast<unsigned long long>(n));
      a.arrived[key] = 0;
    }
  }
  for (int w = tid; w < W; w += blockDim.x) {
    const double p = s.phi[w];
    uint32_t hi = 0, lo = 0;
    if (isnan(p)) {
      hi = lo = kNone;   // never a candidate: every comparison fails
    } else {
      for (int v = 0; v < W; ++v) {
        const double q = s.phi[v];
        hi += q > p || (q == p && v < w);
        lo += q < p || (q == p && v < w);
      }
    }
    s.rank_hi[w] = hi;
    s.rank_lo[w] = lo;
  }
  __syncthreads();
  // 2. the log entry and the rounds, on warp 0
  if (tid < kLanes) {
    const int lane = tid;
    const int n_log = *a.log_n;
    if (n_log >= a.R) __trap();   // the caller drains a full log first
    for (int w = lane; w < W; w += kLanes) {
      a.log_phi[static_cast<size_t>(n_log) * W + w] = s.phi[w];
      a.log_arr[static_cast<size_t>(n_log) * W + w] =
          static_cast<double>(s.arr[w]);
      if (s.rank_hi[w] != kNone) s.by_hi[s.rank_hi[w]] = w;
      if (s.rank_lo[w] != kNone) s.by_lo[s.rank_lo[w]] = w;
    }
    __syncwarp();
    const int32_t before = *a.epoch;
    const int32_t after = rounds(a, s, lane, staged);
    if (lane == 0) {
      *a.log_n = n_log + 1;
      *a.epoch = after;
      s_epoch[0] = before;
      s_epoch[1] = after;
    }
  }
  __syncthreads();
  if (s_epoch[0] == s_epoch[1]) return;
  // 3. the routing consts of the rewritten weights, one row a thread
  for (int key = tid; key < a.K; key += blockDim.x) {
    const double* row = a.weights + static_cast<size_t>(key) * W;
    float* crow = a.cdf + static_cast<size_t>(key) * W;
    int last = -1, best = 0, live = 0;
    float acc = 0.0f;
    for (int j = 0; j < W; ++j) {
      acc = __fadd_rn(acc, __double2float_rn(row[j]));
      crow[j] = acc;
      if (row[j] > 0.0) { last = j; ++live; }
      if (row[j] > row[best]) best = j;
    }
    if (last < 0) last = W - 1;
    for (int j = last; j < W; ++j) crow[j] = 1.0f;
    a.primary[key] = best;
    a.is_split[key] = live > 1;
  }
}

// One thread, n dependent float64 adds: the add latency, by two lengths.
__global__ void dadd_chain_kernel(double* out, double x, double step,
                                  long long n) {
  double acc = x;
#pragma unroll 16
  for (long long i = 0; i < n; ++i) acc = __dadd_rn(acc, step);
  *out = acc;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_ctrl_step_args_size() { return static_cast<int>(sizeof(CtrlArgs)); }

int repro_ctrl_step_phi_param() { return kPhiParam; }

// args: a CtrlArgs (declared void here: the struct has internal linkage,
// and an exported function must not name it).
int repro_ctrl_step(const void* args_ptr, int device, void* stream) {
  const CtrlArgs* args = static_cast<const CtrlArgs*>(args_ptr);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(args->W, args->window);
  if (smem > 48 * 1024) {
    // Raised once a device to the largest size asked so far.
    static size_t granted[64] = {};
    size_t* g = device >= 0 && device < 64 ? &granted[device] : nullptr;
    if (g == nullptr || smem > *g) {
      err = cudaFuncSetAttribute(ctrl_step_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (g != nullptr) *g = smem;
    }
  }
  ctrl_step_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return cudaGetLastError();
}

// n dependent float64 adds on one thread into *out (a device double).
int repro_dadd_chain(double* out, long long n, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      out, 1.0, 1.0 / 1024.0, n);
  return cudaGetLastError();
}

}  // extern "C"
