// The batched sweep lane's per-window equilibrium solver for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/memsim/batched/kernel.py:
//   K2  _glam_kernel (the global-lambda bisection, standalone pallas_call in
//       _build_pallas_solver)          -> glam_cell() + global_lambda_kernel
//   K3  _build_fused_solver (one window's whole wait relaxation around K2,
//       reached through fused_window_solve)  -> fused_window_solve_kernel
//
// Design.  One thread owns one cell and runs that cell's whole dependent
// chain: n_outer damped relaxation steps, each with a 48-step bisection per
// station and a 48-step global-lambda bisection, about 115k f32 operations
// per cell and window at W=2, S=3.  The inputs and outputs touch global memory once per
// window; the state (y, Wq, caps, station rates) stays in thread-local
// arrays bounded by FS_MAX_W / FS_MAX_S, which the Python wrapper checks.
// What bounds it is the serial chain, not bytes or FLOPs: every bisection
// step waits on the one before, so a window costs one cell's latency
// (5,880 bisection steps at S=3 of a few dependent instructions each),
// whatever the grid.
//
// Numerics follow the Pallas bodies: f32 throughout, 1e30 standing in for
// +inf on inputs (the wrapper clamps before the cast), every constant a
// float literal.  In the Pallas code (1.0 - 1e-9), (1.0 + 1e-9) and
// tor + 1e-9 are weakly typed Python floats that round to f32, so they are
// 1.0f and tor here too; a double literal would silently promote the
// expression and compute something the TPU kernel does not.  Build without
// fast math and with -fmad=false: approximate division, flush-to-zero and
// contracted multiply-adds each move bisection decisions.

#include <cuda_runtime.h>
#include <math.h>

#define FS_MAX_W 8
#define FS_MAX_S 8
#define FS_BISECT_ITERS 48

namespace fluid {

constexpr float kBig = 1e30f;  // f32-safe stand-in for +inf
constexpr float kEps = 1e-9f;  // _EPS of the reference

// K2's feasibility test: do the ToR holdings at per-core rate lam fit?
// A workload holds min(O, y*R_tor); a queue-forming workload (one its
// station clamps) holds max(O - irq*share, that)
// (kernel.py:_glam_kernel.feasible).
__device__ inline bool glam_feasible(float lam, int W, const float* A, const float* cap,
                                const float* y_sta, const float* o_eff,
                                const float* r_tor, float tor, float irq) {
  float y[FS_MAX_W];
  float unc[FS_MAX_W];
  bool clamped[FS_MAX_W];
  float ysum = 0.0f;
  for (int w = 0; w < W; ++w) {
    float y_free = fminf(lam * A[w], cap[w]);
    y[w] = fminf(y_free, y_sta[w]);
    clamped[w] = y_sta[w] < y_free * (1.0f - 1e-9f);
    unc[w] = fminf(o_eff[w], y[w] * r_tor[w]);
    ysum += y[w];
  }
  const float denom = fmaxf(ysum, 1e-12f);
  float pop = 0.0f;
  for (int w = 0; w < W; ++w) {
    float share = y[w] / denom;
    pop += clamped[w] ? fmaxf(o_eff[w] - irq * share, unc[w]) : unc[w];
  }
  return pop <= tor + kEps;
}

// K2 on one cell: 48 fixed bisection steps from [0, hi0]; +inf where the
// cell is feasible at the cap.
__device__ inline float glam_cell(int W, const float* A, const float* cap,
                             const float* y_sta, const float* o_eff,
                             const float* r_tor, float tor, float irq, float hi0) {
  float lo = 0.0f, hi = hi0;
  for (int i = 0; i < FS_BISECT_ITERS; ++i) {
    float mid = 0.5f * (lo + hi);
    bool ok = glam_feasible(mid, W, A, cap, y_sta, o_eff, r_tor, tor, irq);
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
  }
  return glam_feasible(hi0, W, A, cap, y_sta, o_eff, r_tor, tor, irq) ? INFINITY : lo;
}

// Station demand at per-core rate lam: sum_w min(lam*A, cap) * route_svc.
__device__ inline float station_demand(float lam, int W, int S, int s, const float* A,
                                  const float* cap, const float* route_svc) {
  float d = 0.0f;
  for (int w = 0; w < W; ++w) d += fminf(lam * A[w], cap[w]) * route_svc[w * S + s];
  return d;
}

// The fused solver's station_lams: per-station fair rate, kBig (not +inf)
// where the station serves every user at its cap (kernel.py:281).
__device__ inline void station_lams(int W, int S, const float* A, const float* cap,
                               const float* route_svc, const float* slots, float* lam_s) {
  float hi0 = -INFINITY;
  for (int w = 0; w < W; ++w) hi0 = fmaxf(hi0, cap[w] / fmaxf(A[w], 1e-12f));
  hi0 = hi0 + 1e-6f;
  for (int s = 0; s < S; ++s) {
    const float limit = slots[s] + kEps;
    const bool feasible_at_cap = station_demand(hi0, W, S, s, A, cap, route_svc) <= limit;
    float lo = 0.0f, hi = hi0;
    for (int i = 0; i < FS_BISECT_ITERS; ++i) {
      float mid = 0.5f * (lo + hi);
      bool ok = station_demand(mid, W, S, s, A, cap, route_svc) <= limit;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid;
    }
    lam_s[s] = feasible_at_cap ? kBig : lo;
  }
}

// K3 on one cell: the damped wait relaxation of kernel.py:_build_fused_solver
// (the numpy loop of fluid.py:222-297 in f32).  Arrays are this cell's rows:
// A, y_rate, o_eff [W]; route, route_svc, svc_pipe [W*S]; slots, Wq [S].
// Writes y [W], Wq [S] (in place) and returns the last iteration's lambda.
__device__ inline float window_solve_cell(int W, int S, int n_outer, float damp,
                                     const float* A, const float* y_rate,
                                     const float* o_eff, const float* route,
                                     const float* route_svc, const float* svc_pipe,
                                     const float* slots, float tor, float irq,
                                     float* y, float* Wq) {
  float R_base[FS_MAX_W], R_tor[FS_MAX_W], cap[FS_MAX_W], y_sta[FS_MAX_W];
  float pop_w[FS_MAX_W], q_w[FS_MAX_W], w_norm[FS_MAX_W];
  bool qb[FS_MAX_W];
  float lam_s[FS_MAX_S], d_s[FS_MAX_S], inflow_s[FS_MAX_S];
  bool sat[FS_MAX_S];
  for (int w = 0; w < W; ++w) {
    float r = 0.0f;
    for (int s = 0; s < S; ++s) r += route[w * S + s] * svc_pipe[w * S + s];
    R_base[w] = r;
    y[w] = 0.0f;
  }
  float lam = INFINITY;
  for (int it = 0; it < n_outer; ++it) {
    // Issue-side caps: token rate and the MLP population over the residency
    // (waits included).
    for (int w = 0; w < W; ++w) {
      float r = 0.0f;
      for (int s = 0; s < S; ++s) r += route[w * S + s] * (Wq[s] + svc_pipe[w * S + s]);
      R_tor[w] = r;
      float c = fminf(y_rate[w], o_eff[w] / fmaxf(r, 1e-9f));
      cap[w] = A[w] > 0.0f ? c : 0.0f;
    }
    station_lams(W, S, A, cap, route_svc, slots, lam_s);
    float hi0 = -INFINITY;
    for (int w = 0; w < W; ++w) {
      float lam_min = INFINITY;
      for (int s = 0; s < S; ++s)
        lam_min = fminf(lam_min, route_svc[w * S + s] > 1e-12f ? lam_s[s] : kBig);
      y_sta[w] = fminf(lam_min, kBig) * fmaxf(A[w], 0.0f);
      hi0 = fmaxf(hi0, fminf(cap[w], kBig) / fmaxf(A[w], 1e-12f));
    }
    lam = glam_cell(W, A, cap, y_sta, o_eff, R_tor, tor, irq, hi0 + 1e-6f);
    const float lam_b = fminf(lam, kBig);
    float ysum = 0.0f;
    for (int w = 0; w < W; ++w) {
      float y_free = fminf(lam_b * A[w], cap[w]);
      y[w] = fminf(y_free, y_sta[w]);
      qb[w] = (y_sta[w] <= lam_b * A[w] * (1.0f + 1e-9f)) &&
              (y_sta[w] < cap[w] * (1.0f - 1e-9f));
      ysum += y[w];
    }
    const float denom = fmaxf(ysum, 1e-12f);
    float pop_sum = 0.0f, base_pop = 0.0f;
    for (int w = 0; w < W; ++w) {
      float unc = fminf(o_eff[w], y[w] * R_tor[w]);
      float share = y[w] / denom;
      pop_w[w] = qb[w] ? fmaxf(o_eff[w] - irq * share, unc) : unc;
      pop_sum += pop_w[w];
      base_pop += y[w] * R_base[w];
    }
    // Wait relaxation: the queued population sits at the saturated stations
    // of the queue-forming workloads; Little's law turns depth into wait.
    for (int s = 0; s < S; ++s) {
      float d = 0.0f, f = 0.0f;
      for (int w = 0; w < W; ++w) {
        d += y[w] * route_svc[w * S + s];
        f += y[w] * route[w * S + s];
      }
      d_s[s] = d;
      inflow_s[s] = f;
      sat[s] = (d / fmaxf(slots[s], 1e-9f) >= 0.98f) && (slots[s] > 0.0f);
    }
    const float q_total = fmaxf(fminf(pop_sum, tor) - base_pop, 0.0f);
    float q_sum = 0.0f;
    for (int w = 0; w < W; ++w) {
      q_w[w] = qb[w] ? fmaxf(pop_w[w] - y[w] * R_base[w], 0.0f) : 0.0f;
      q_sum += q_w[w];
      float n = 0.0f;
      for (int s = 0; s < S; ++s) n += sat[s] ? route_svc[w * S + s] : 0.0f;
      w_norm[w] = n;
    }
    const float scale =
        q_sum > 1e-12f ? fminf(1.0f, q_total / fmaxf(q_sum, 1e-12f)) : 0.0f;
    for (int w = 0; w < W; ++w) q_w[w] = q_w[w] * scale;
    for (int s = 0; s < S; ++s) {
      float q_s = 0.0f;
      for (int w = 0; w < W; ++w) {
        float w_st = sat[s] ? route_svc[w * S + s] : 0.0f;
        w_st = w_norm[w] > 1e-12f ? w_st / fmaxf(w_norm[w], 1e-12f) : 0.0f;
        q_s += q_w[w] * w_st;
      }
      float mean_svc = d_s[s] / fmaxf(inflow_s[s], 1e-12f);
      float w_new = q_s * mean_svc / fmaxf(slots[s], 1e-9f);
      w_new = sat[s] ? w_new : 0.0f;
      Wq[s] = damp * Wq[s] + (1.0f - damp) * w_new;
    }
  }
  return lam;
}

}  // namespace fluid

namespace {

constexpr int kThreads = 128;  // one cell per thread, four warps per block

__global__ void global_lambda_kernel(const float* __restrict__ A,
                                     const float* __restrict__ cap,
                                     const float* __restrict__ y_sta,
                                     const float* __restrict__ o_eff,
                                     const float* __restrict__ r_tor,
                                     const float* __restrict__ tor,
                                     const float* __restrict__ irq,
                                     const float* __restrict__ hi0,
                                     float* __restrict__ out, int C, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a[FS_MAX_W], cp[FS_MAX_W], ys[FS_MAX_W], o[FS_MAX_W], r[FS_MAX_W];
  for (int w = 0; w < W; ++w) {
    const int i = c * W + w;
    a[w] = A[i];
    cp[w] = cap[i];
    ys[w] = y_sta[i];
    o[w] = o_eff[i];
    r[w] = r_tor[i];
  }
  out[c] = fluid::glam_cell(W, a, cp, ys, o, r, tor[c], irq[c], hi0[c]);
}

__global__ void fused_window_solve_kernel(
    const float* __restrict__ A, const float* __restrict__ y_rate,
    const float* __restrict__ o_eff, const float* __restrict__ route,
    const float* __restrict__ route_svc, const float* __restrict__ svc_pipe,
    const float* __restrict__ slots, const float* __restrict__ tor,
    const float* __restrict__ irq, const float* __restrict__ Wq0,
    float* __restrict__ y_out, float* __restrict__ Wq_out, float* __restrict__ lam_out,
    int C, int W, int S, int n_outer, float damp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a[FS_MAX_W], yr[FS_MAX_W], o[FS_MAX_W], y[FS_MAX_W];
  float rt[FS_MAX_W * FS_MAX_S], rs[FS_MAX_W * FS_MAX_S], sp[FS_MAX_W * FS_MAX_S];
  float sl[FS_MAX_S], wq[FS_MAX_S];
  for (int w = 0; w < W; ++w) {
    a[w] = A[c * W + w];
    yr[w] = y_rate[c * W + w];
    o[w] = o_eff[c * W + w];
  }
  for (int i = 0; i < W * S; ++i) {
    rt[i] = route[c * W * S + i];
    rs[i] = route_svc[c * W * S + i];
    sp[i] = svc_pipe[c * W * S + i];
  }
  for (int s = 0; s < S; ++s) {
    sl[s] = slots[c * S + s];
    wq[s] = Wq0[c * S + s];
  }
  const float lam = fluid::window_solve_cell(W, S, n_outer, damp, a, yr, o, rt, rs, sp,
                                             sl, tor[c], irq[c], y, wq);
  for (int w = 0; w < W; ++w) y_out[c * W + w] = y[w];
  for (int s = 0; s < S; ++s) Wq_out[c * S + s] = wq[s];
  lam_out[c] = lam;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success); the wrapper raises on anything else.
int fluid_global_lambda_launch(const float* A, const float* cap, const float* y_sta,
                               const float* o_eff, const float* r_tor, const float* tor,
                               const float* irq, const float* hi0, float* out, int C,
                               int W, void* stream) {
  if (C <= 0) return 0;
  const int blocks = (C + kThreads - 1) / kThreads;
  global_lambda_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, cap, y_sta, o_eff, r_tor, tor, irq, hi0, out, C, W);
  return static_cast<int>(cudaGetLastError());
}

int fluid_window_solve_launch(const float* A, const float* y_rate, const float* o_eff,
                              const float* route, const float* route_svc,
                              const float* svc_pipe, const float* slots, const float* tor,
                              const float* irq, const float* Wq0, float* y_out,
                              float* Wq_out, float* lam_out, int C, int W, int S,
                              int n_outer, float damp, void* stream) {
  if (C <= 0) return 0;
  const int blocks = (C + kThreads - 1) / kThreads;
  fused_window_solve_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor, irq, Wq0, y_out, Wq_out,
      lam_out, C, W, S, n_outer, damp);
  return static_cast<int>(cudaGetLastError());
}

const char* fluid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
