// The in-dispatch skew controller's step: one super-tick window of metric
// rounds against the device-held controller state, on one block.
//
// Counterpart of the JAX package's jitted ``controller_step``
// (repro/dataflow/device.py, _make_ctrl_step), with
// repro_torch.kernels.ref.ctrl_step as its plain version.  One launch
// covers the window [t0, t0 + k):
//
//   1. the whole block folds the per-key arrivals into per-owner counts
//      (integer atomics: exact in any order) and zeroes them;
//   2. thread 0 appends (phi, arrivals) to the observation log, then runs
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
// The decisions run on one thread: a latency-bound chain of a few thousand
// dependent float64 operations a round.  Speed is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPhase1 = 2;   // MitigationPhase.PHASE_ONE.value
constexpr int kPhase2 = 3;   // MitigationPhase.PHASE_TWO.value

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
  const double* phi;        // [W]
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
};

__device__ __forceinline__ double pymax(double a, double b) {
  return b > a ? b : a;
}

__device__ __forceinline__ double pymin(double a, double b) {
  return b < a ? b : a;
}

// The ring of worker w: n valid entries ending just before slot pos,
// oldest first.
__device__ double ring_mean(const CtrlArgs& a, int w) {
  const int n = a.obs_n[w];
  if (n <= 0) return 0.0;
  const int win = a.window;
  const int start = ((a.obs_pos[w] - n) % win + win) % win;
  const double* row = a.obs + static_cast<size_t>(w) * win;
  double acc = 0.0;
  for (int i = 0; i < n; ++i) acc = __dadd_rn(acc, row[(start + i) % win]);
  return __ddiv_rn(acc, static_cast<double>(n));
}

__device__ double ring_stderr(const CtrlArgs& a, int w) {
  const int n = a.obs_n[w];
  if (n < 2) return INFINITY;
  const int win = a.window;
  const int start = ((a.obs_pos[w] - n) % win + win) % win;
  const double* row = a.obs + static_cast<size_t>(w) * win;
  const double mean = ring_mean(a, w);
  double ssq = 0.0;
  for (int i = 0; i < n; ++i) {
    const double d = __dsub_rn(row[(start + i) % win], mean);
    ssq = __dadd_rn(ssq, __dmul_rn(d, d));
  }
  const double nf = static_cast<double>(n);
  const double d = __dsqrt_rn(__ddiv_rn(ssq, __dsub_rn(nf, 1.0)));
  return __dmul_rn(d, __dsqrt_rn(__dadd_rn(1.0, __ddiv_rn(1.0, nf))));
}

// The predicted shares f_hat into out[W].
__device__ void predicted_shares(const CtrlArgs& a, double* out) {
  const int W = a.W;
  double total = 0.0;
  for (int w = 0; w < W; ++w) {
    out[w] = ring_mean(a, w);
    total = __dadd_rn(total, out[w]);
  }
  if (total <= 0.0) {
    const double even = __ddiv_rn(1.0, static_cast<double>(W));
    for (int w = 0; w < W; ++w) out[w] = even;
  } else {
    for (int w = 0; w < W; ++w) out[w] = __ddiv_rn(out[w], total);
  }
}

__device__ double phase2_fraction(double f_s, double f_h) {
  const double avg = __ddiv_rn(__dadd_rn(f_s, f_h), 2.0);
  double give = pymax(__dsub_rn(avg, f_h), 0.0);
  const double max_total = pymax(__dsub_rn(f_s, avg), 0.0);
  if (give > max_total && max_total > 0.0) {
    give = __dmul_rn(give, __ddiv_rn(max_total, give));
  }
  return f_s > 0.0 ? __ddiv_rn(give, f_s) : 0.0;
}

// plan_phase1 (full partition): every key owned by s with s-mass hands that
// mass to h.  Returns whether any row changed.
__device__ int phase1(const CtrlArgs& a, int s, int h) {
  const int W = a.W;
  int changed = 0;
  for (int key = 0; key < a.K; ++key) {
    double* row = a.weights + static_cast<size_t>(key) * W;
    if (a.owner[key] == s && row[s] > 0.0) {
      row[h] = __dadd_rn(row[h], row[s]);
      row[s] = 0.0;
      changed = 1;
    }
  }
  return changed;
}

// plan_phase2 (SBR, one helper): every key owned by s gets the row
// [s: 1 - r, h: 0 + r] from the predicted shares.
__device__ int phase2(const CtrlArgs& a, int s, int h, double* scratch) {
  const int W = a.W;
  predicted_shares(a, scratch);
  const double r = phase2_fraction(scratch[s], scratch[h]);
  const double keep = __dsub_rn(1.0, r);
  const double give = __dadd_rn(0.0, r);
  int changed = 0;
  for (int key = 0; key < a.K; ++key) {
    if (a.owner[key] != s) continue;
    double* row = a.weights + static_cast<size_t>(key) * W;
    for (int j = 0; j < W; ++j) row[j] = 0.0;
    row[s] = keep;
    row[h] = give;
    changed = 1;
  }
  return changed;
}

// Every metric round of the window, on one thread.  Returns the epoch.
__device__ int32_t rounds(const CtrlArgs& a, const unsigned long long* arr,
                          double* scratch, uint8_t* processed, uint8_t* free_,
                          uint8_t* taken, uint8_t* skewed) {
  const int W = a.W;
  const int win = a.window;
  double tau = *a.tau;
  int32_t tau_adj = *a.tau_adj;
  int32_t seq_next = *a.seq_next;
  int32_t epoch = *a.epoch;
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
        total = __dadd_rn(total, static_cast<double>(arr[w]));
      }
      if (total > 0.0) {
        const double scale = __ddiv_rn(a.horizon, total);
        for (int w = 0; w < W; ++w) {
          a.obs[static_cast<size_t>(w) * win + a.obs_pos[w]] =
              __dmul_rn(static_cast<double>(arr[w]), scale);
          a.obs_n[w] = min(a.obs_n[w] + 1, win);
          a.obs_pos[w] = (a.obs_pos[w] + 1) % win;
        }
      }
    }
    // ---- _advance_mitigations, in mit_seq order ------------------------
    for (int w = 0; w < W; ++w) processed[w] = 0;
    for (;;) {
      int s = -1;
      for (int w = 0; w < W; ++w) {
        if (a.mit_active[w] && !processed[w]
            && (s < 0 || a.mit_seq[w] < a.mit_seq[s])) {
          s = w;
        }
      }
      if (s < 0) break;
      processed[s] = 1;
      const int h = a.mit_helper[s];
      const int phase = a.mit_phase[s];
      const double q_s = a.phi[s];
      const double q_h = a.phi[h];
      const double top = pymax(pymax(q_s, q_h), 1.0);
      const bool p1_to_p2 =
          phase == kPhase1
          && q_h >= __dsub_rn(q_s, __dmul_rn(a.catchup_tolerance, top));
      const bool in_p2 = phase == kPhase2;
      const bool s_ahead = q_s >= a.eta && __dsub_rn(q_s, q_h) >= tau;
      const bool h_ahead = q_h >= a.eta && __dsub_rn(q_h, q_s) >= tau;
      const bool calm = in_p2 && !(s_ahead || h_ahead);
      const bool div = in_p2 && (s_ahead || h_ahead);
      const int new_calm = a.mit_calm[s] + 1;
      const bool retire =
          calm && a.retire_window > 0 && new_calm >= a.retire_window;
      if (div) {
        // adaptive tau on divergence (eps before the resets)
        const double eps = pymax(ring_stderr(a, s), ring_stderr(a, h));
        if (a.adaptive_tau && isfinite(eps) && eps > a.eps_upper
            && tau_adj < a.max_tau_adjustments) {
          tau = __dadd_rn(tau, a.tau_increase);
          tau_adj += 1;
        }
        a.obs_n[s] = 0;   // reset_samples([s, h])
        a.obs_n[h] = 0;
      }
      bool start_p1 = div && s_ahead;
      bool start_p2 = (div && !s_ahead) || p1_to_p2;
      if (!a.enable_phase1) {
        start_p2 = start_p2 || start_p1;
        start_p1 = false;
      }
      if (start_p1) {
        epoch += phase1(a, s, h);
        a.mit_phase[s] = kPhase1;
      } else if (start_p2) {
        epoch += phase2(a, s, h, scratch);   // post-reset shares
        a.mit_phase[s] = kPhase2;
      }
      if (calm) {
        a.mit_calm[s] = new_calm;
      } else if (div) {
        a.mit_calm[s] = 0;
      }
      if (retire) a.mit_active[s] = 0;
    }
    // ---- _detect -------------------------------------------------------
    for (int w = 0; w < W; ++w) taken[w] = a.mit_active[w];
    for (int s = 0; s < W; ++s) {
      if (a.mit_active[s]) taken[a.mit_helper[s]] = 1;   // busy
    }
    int nfree = 0;
    int s0 = 0, h0 = 0;
    double hi = -INFINITY, lo = INFINITY;
    for (int w = 0; w < W; ++w) {
      free_[w] = !taken[w];
      if (!free_[w]) continue;
      ++nfree;
      if (a.phi[w] > hi) { s0 = w; hi = a.phi[w]; }
      if (a.phi[w] < lo) { h0 = w; lo = a.phi[w]; }
    }
    const double eps0 = pymax(ring_stderr(a, s0), ring_stderr(a, h0));
    // adjust_tau
    const double phi_s = a.phi[s0];
    const double gap = __dsub_rn(phi_s, a.phi[h0]);
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
    // (excluding themselves) reaches detect_tau
    int i1 = 0;
    double m1 = INFINITY, m2 = INFINITY;
    for (int w = 0; w < W; ++w) {
      if (free_[w] && a.phi[w] < m1) { i1 = w; m1 = a.phi[w]; }
    }
    for (int w = 0; w < W; ++w) {
      if (free_[w] && w != i1 && a.phi[w] < m2) m2 = a.phi[w];
    }
    for (int w = 0; w < W; ++w) {
      skewed[w] = free_[w] && a.phi[w] >= a.eta
                  && __dsub_rn(a.phi[w], w == i1 ? m2 : m1) >= detect_tau;
      if (skewed[w]) taken[w] = 1;   // skewed workers cannot help
      processed[w] = 0;
    }
    predicted_shares(a, scratch);
    const double L = a.tuples_left;
    for (;;) {
      int s = -1;
      for (int w = 0; w < W; ++w) {
        if (skewed[w] && !processed[w] && (s < 0 || a.phi[w] > a.phi[s])) {
          s = w;
        }
      }
      if (s < 0) break;   // no skewed worker left
      processed[s] = 1;
      // choose_helpers, max_helpers=1: the lexicographic minimum by
      // (f_hat, phi, index) over the candidates, which all become taken
      int h = -1;
      for (int w = 0; w < W; ++w) {
        const bool cand = free_[w] && !taken[w] && w != s
                          && __dsub_rn(a.phi[s], a.phi[w]) >= detect_tau;
        if (!cand) continue;
        if (h < 0 || scratch[w] < scratch[h]
            || (scratch[w] == scratch[h] && a.phi[w] < a.phi[h])) {
          h = w;
        }
      }
      if (h < 0) continue;
      for (int w = 0; w < W; ++w) {
        if (free_[w] && !taken[w] && w != s
            && __dsub_rn(a.phi[s], a.phi[w]) >= detect_tau) {
          taken[w] = 1;
        }
      }
      const double f_s = scratch[s], f_h = scratch[h];
      const double lr_max =
          __dmul_rn(__dsub_rn(f_s, __ddiv_rn(__dadd_rn(f_s, f_h), 2.0)), L);
      const double future = __dmul_rn(pymax(L, 0.0), f_s);   // infinite rate
      if (!(pymin(lr_max, future) >= -1e-12)) continue;
      if (a.enable_phase1) {
        epoch += phase1(a, s, h);
        a.mit_phase[s] = kPhase1;
      } else {
        // phase2 recomputes the same shares into scratch
        epoch += phase2(a, s, h, scratch);
        a.mit_phase[s] = kPhase2;
      }
      a.mit_active[s] = 1;
      a.mit_helper[s] = h;
      a.mit_calm[s] = 0;
      a.mit_seq[s] = seq_next;
      seq_next += 1;
    }
  }
  *a.tau = tau;
  *a.tau_adj = tau_adj;
  *a.seq_next = seq_next;
  return epoch;
}

__global__ void __launch_bounds__(kThreads)
ctrl_step_kernel(const CtrlArgs a) {
  extern __shared__ unsigned long long smem[];
  const int W = a.W;
  unsigned long long* arr = smem;                                // [W]
  double* scratch = reinterpret_cast<double*>(smem + W);         // [W]
  uint8_t* flags = reinterpret_cast<uint8_t*>(smem + 2 * W);     // [4 W]
  __shared__ int32_t s_epoch[2];
  const int tid = threadIdx.x;
  for (int w = tid; w < W; w += blockDim.x) arr[w] = 0ull;
  __syncthreads();
  // 1. owner-attributed arrivals
  for (int key = tid; key < a.K; key += blockDim.x) {
    const int64_t n = a.arrived[key];
    if (n != 0) {
      atomicAdd(&arr[a.owner[key]], static_cast<unsigned long long>(n));
      a.arrived[key] = 0;
    }
  }
  __syncthreads();
  // 2. the log entry and the rounds
  if (tid == 0) {
    const int n_log = *a.log_n;
    if (n_log >= a.R) __trap();   // the caller drains a full log first
    for (int w = 0; w < W; ++w) {
      a.log_phi[static_cast<size_t>(n_log) * W + w] = a.phi[w];
      a.log_arr[static_cast<size_t>(n_log) * W + w] =
          static_cast<double>(arr[w]);
    }
    *a.log_n = n_log + 1;
    s_epoch[0] = *a.epoch;
    s_epoch[1] = rounds(a, arr, scratch, flags, flags + W, flags + 2 * W,
                        flags + 3 * W);
    *a.epoch = s_epoch[1];
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

// args: a CtrlArgs (declared void here: the struct has internal linkage,
// and an exported function must not name it).
int repro_ctrl_step(const void* args_ptr, int device, void* stream) {
  const CtrlArgs* args = static_cast<const CtrlArgs*>(args_ptr);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(args->W) * (2 * 8 + 4);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ctrl_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ctrl_step_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return cudaGetLastError();
}

}  // extern "C"
