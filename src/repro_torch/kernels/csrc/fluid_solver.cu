// The batched sweep lane's per-window equilibrium solver for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/memsim/batched/kernel.py:
//   K2  _glam_kernel (the global-lambda bisection, standalone pallas_call in
//       _build_pallas_solver)          -> glam_cell() + global_lambda_kernel
//   K3  _build_fused_solver (one window's whole wait relaxation around K2,
//       reached through fused_window_solve)  -> fused_window_solve_kernel
//
// What bounds it is latency, not bytes or FLOPs.  A cell's window is one
// dependent chain: n_outer damped relaxation steps, each with a 48-step
// bisection per station and a 48-step global-lambda bisection (5,880
// dependent bisection steps at n_outer = 30, S = 3), and a window costs one
// cell's chain, whatever the grid.
//
// Design: one warp per cell, four warps (cells) per block, so C = 1024
// cells are 256 blocks over all SMs.  The cell's state is warp-uniform:
// every lane computes it with the same instructions on the same values, and
// lane 0 writes it out.  Its per-workload rows (A, y_rate, o_eff, caps,
// rates) live in registers, indexed only by loops unrolled to the most
// workloads and stations of the instantiation (2 x 3 for the sweep's
// cells, else FS_MAX_W x FS_MAX_S: unrolled to 8 x 8, a 2 x 3 cell would
// run mostly guards); its W x S rows (route, route_svc, svc_pipe) are
// copied to the warp's slice of shared memory once per launch.
//
// The lanes shorten the chain by speculative bisection: a round of k levels
// evaluates the predicate at the 2^k - 1 midpoints of the next k levels of
// the bisection tree, one per lane, and __ballot_sync picks the path.  Each
// lane derives its node's (lo, hi) from the round's (lo, hi) and its path
// bits with the same 0.5f * (lo + hi) the sequential loop computes, so the
// result equals the sequential bisection bit for bit.  A round ends without
// a serial walk of the path: each lane knows (once per launch) which
// ancestor bits put its node on the path, a second ballot names the path's
// last node, and that lane's bracket is shuffled to the others.  The
// global-lambda bisection takes k = 5 (31 lanes, 10 rounds for 48 steps;
// lane 31 runs the test at the cap meanwhile); the S station bisections run
// at once on floor(32 / S) lanes each (k = 3 at S = 3: 16 rounds instead of
// 3 x 48 steps), each lane holding its own station's bracket, and their
// tests at the cap take one step on all lanes.  The predicates still sum
// over workloads serially, in the reference's order, inside one lane.
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
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGlamLevels = 5;  // 31 of 32 lanes per global-lambda round

// Levels per round of the station bisections: floor(32 / S) lanes a
// station, the deepest complete tree that fits them (at most 5 levels).
__host__ __device__ constexpr int station_levels(int S) {
  return 32 / S >= 31 ? 5 : 32 / S >= 15 ? 4 : 32 / S >= 7 ? 3 : 32 / S >= 3 ? 2 : 1;
}

// The bracket that the sequential bisection holds at tree node `node`
// (breadth-first, 0 = the round's root) below the round's (lo, hi), in
// place: node + 1 in binary is a leading 1 and then the path, 1 = predicate
// true (lo = mid).  The node's midpoint is then 0.5f * (lo + hi).
__device__ __forceinline__ void node_bracket(float& lo, float& hi, int node) {
  const unsigned v = static_cast<unsigned>(node) + 1u;
  const int depth = 31 - __clz(v);
#pragma unroll
  for (int i = kGlamLevels - 2; i >= 0; --i) {
    const float mid = 0.5f * (lo + hi);
    const bool act = i < depth, up = (v >> i) & 1u;
    lo = act && up ? mid : lo;
    hi = act && !up ? mid : hi;
  }
}

// A lane's place in a round's bisection tree, fixed for the launch: its
// node, the node's depth, the ballot bits of its ancestors that must be set
// (one) and clear (zero) for the node to lie on the path the predicate
// values pick, and the ballot bits of its tree (group).  The tree's node j
// sits on lane base + j; lanes past the tree's 2^k - 1 nodes have depth >= k.
struct TreeLane {
  int node, depth;
  unsigned one, zero, group;
};

__device__ __forceinline__ TreeLane tree_lane(int node, int base, int width) {
  TreeLane t;
  t.node = node;
  const unsigned v = static_cast<unsigned>(node) + 1u;
  t.depth = 31 - __clz(v);
  t.one = t.zero = 0u;
  int a = 0;
  for (int i = t.depth - 1; i >= 0; --i) {
    const unsigned up = (v >> i) & 1u;
    if (up) {
      t.one |= 1u << (base + a);
    } else {
      t.zero |= 1u << (base + a);
    }
    a = 2 * a + 1 + static_cast<int>(up);
  }
  t.group = (width >= 32 ? kFullMask : (1u << width) - 1u) << base;
  return t;
}

// End a round of `levels` levels whose predicate values are the ballot
// `oks`: the lane whose node is the path's last one gives its bracket, and
// its step is applied, so (lo, hi) are the sequential loop's after the
// round's `levels` steps.  n_lo, n_hi: this lane's node bracket.
__device__ __forceinline__ void take_round(float& lo, float& hi, float n_lo, float n_hi,
                                           unsigned oks, const TreeLane& t, int levels) {
  const bool last = t.depth == levels - 1 && (oks & t.one) == t.one && (oks & t.zero) == 0u;
  const int src = __ffs(__ballot_sync(kFullMask, last) & t.group) - 1;
  const float l_lo = __shfl_sync(kFullMask, n_lo, src);
  const float l_hi = __shfl_sync(kFullMask, n_hi, src);
  const float mid = 0.5f * (l_lo + l_hi);
  const bool ok = (oks >> src) & 1u;
  lo = ok ? mid : l_lo;
  hi = ok ? l_hi : mid;
}

// The lanes' trees of one launch: the global-lambda bisection's (one tree
// of 31 nodes on lanes 0-30; lane 31 runs the test at the cap) and the
// station bisections' (station s on lanes [s*per, s*per + per), k levels a
// round; the spare lanes past S*per follow the last station).
struct Lanes {
  TreeLane glam, station;
  int my_s, per, k;
};

__device__ __forceinline__ Lanes make_lanes(int lane, int S) {
  Lanes l;
  l.per = 32 / S;
  l.k = station_levels(S);
  l.my_s = min(lane / l.per, S - 1);
  l.glam = tree_lane(lane, 0, 32);
  l.station = tree_lane(lane - l.my_s * l.per, l.my_s * l.per, l.per);
  return l;
}

// K2's feasibility test: do the ToR holdings at per-core rate lam fit?
// A workload holds min(O, y*R_tor); a queue-forming workload (one its
// station clamps) holds max(O - irq*share, that)
// (kernel.py:_glam_kernel.feasible).
template <int MW>
__device__ __forceinline__ bool glam_feasible(float lam, int W, const float* A,
                                              const float* cap, const float* y_sta,
                                              const float* o_eff, const float* r_tor,
                                              float tor, float irq) {
  float y[MW];
  float unc[MW];
  bool clamped[MW];
  float ysum = 0.0f;
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    if (w < W) {
      float y_free = fminf(lam * A[w], cap[w]);
      y[w] = fminf(y_free, y_sta[w]);
      clamped[w] = y_sta[w] < y_free * (1.0f - 1e-9f);
      unc[w] = fminf(o_eff[w], y[w] * r_tor[w]);
      ysum += y[w];
    }
  }
  const float denom = fmaxf(ysum, 1e-12f);
  float pop = 0.0f;
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    if (w < W) {
      float share = y[w] / denom;
      pop += clamped[w] ? fmaxf(o_eff[w] - irq * share, unc[w]) : unc[w];
    }
  }
  return pop <= tor + kEps;
}

// K2 on one cell, run by its whole warp: the 48-step bisection from
// [0, hi0] in rounds of kGlamLevels levels; +inf where the cell is
// feasible at the cap.  Every lane returns the same value.
template <int MW>
__device__ __forceinline__ float glam_cell(const TreeLane& t, int W, const float* A,
                                           const float* cap, const float* y_sta,
                                           const float* o_eff, const float* r_tor, float tor,
                                           float irq, float hi0) {
  float lo = 0.0f, hi = hi0;
  bool at_cap = false;
  for (int done = 0; done < FS_BISECT_ITERS; done += kGlamLevels) {
    const int levels = min(kGlamLevels, FS_BISECT_ITERS - done);
    float n_lo = lo, n_hi = hi;
    node_bracket(n_lo, n_hi, t.node);
    // Lane 31 holds no node: it runs the test at the cap (read once).
    const float x = t.node == 31 ? hi0 : 0.5f * (n_lo + n_hi);
    const unsigned oks = __ballot_sync(
        kFullMask, glam_feasible<MW>(x, W, A, cap, y_sta, o_eff, r_tor, tor, irq));
    if (done == 0) at_cap = oks >> 31;
    take_round(lo, hi, n_lo, n_hi, oks, t, levels);
  }
  return at_cap ? INFINITY : lo;
}

// Station demand at per-core rate lam: sum_w min(lam*A, cap) * route_svc,
// route_svc the station's column.
template <int MW>
__device__ __forceinline__ float station_demand(float lam, int W, const float* A,
                                                const float* cap, const float* rs) {
  float d = 0.0f;
#pragma unroll
  for (int w = 0; w < MW; ++w)
    if (w < W) d += fminf(lam * A[w], cap[w]) * rs[w];
  return d;
}

// The fused solver's station_lams: per-station fair rate, kBig (not +inf)
// where the station serves every user at its cap (kernel.py:281).  The S
// bisections run at once, each lane on its own station's tree and bracket;
// route_svc is the warp's shared-memory copy; lam_s comes out warp-uniform.
template <int MW, int MS>
__device__ __forceinline__ void station_lams(const Lanes& ln, int W, int S, const float* A,
                                             const float* cap, const float* route_svc,
                                             const float* slots, float* lam_s) {
  float hi0 = -INFINITY;
#pragma unroll
  for (int w = 0; w < MW; ++w)
    if (w < W) hi0 = fmaxf(hi0, cap[w] / fmaxf(A[w], 1e-12f));
  hi0 = hi0 + 1e-6f;
  float rs[MW];
#pragma unroll
  for (int w = 0; w < MW; ++w)
    if (w < W) rs[w] = route_svc[w * S + ln.my_s];
  float limit = 0.0f;
#pragma unroll
  for (int s = 0; s < MS; ++s)
    if (s == ln.my_s) limit = slots[s] + kEps;
  const unsigned at_cap =
      __ballot_sync(kFullMask, station_demand<MW>(hi0, W, A, cap, rs) <= limit);
  float lo = 0.0f, hi = hi0;
  for (int done = 0; done < FS_BISECT_ITERS; done += ln.k) {
    const int levels = min(ln.k, FS_BISECT_ITERS - done);
    float n_lo = lo, n_hi = hi;
    node_bracket(n_lo, n_hi, ln.station.node);
    const unsigned oks = __ballot_sync(
        kFullMask, station_demand<MW>(0.5f * (n_lo + n_hi), W, A, cap, rs) <= limit);
    take_round(lo, hi, n_lo, n_hi, oks, ln.station, levels);
  }
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    const float lo_s = __shfl_sync(kFullMask, lo, min(s, S - 1) * ln.per);
    if (s < S) lam_s[s] = (at_cap >> (s * ln.per)) & 1u ? kBig : lo_s;
  }
}

// K3 on one cell, run by its whole warp: the damped wait relaxation of
// kernel.py:_build_fused_solver (the numpy loop of fluid.py:222-297 in f32).
// A, y_rate, o_eff [W] and slots [S] are warp-uniform registers; route,
// route_svc, svc_pipe [W*S] the warp's shared-memory rows.  Writes y [W],
// Wq [S] (in place) and returns the last iteration's lambda.
template <int MW, int MS>
__device__ __forceinline__ float window_solve_cell(
    const Lanes& ln, int W, int S, int n_outer, float damp, const float* A, const float* y_rate,
    const float* o_eff, const float* route, const float* route_svc, const float* svc_pipe,
    const float* slots, float tor, float irq, float* y, float* Wq) {
  float R_base[MW], R_tor[MW], cap[MW], y_sta[MW];
  float pop_w[MW], q_w[MW], w_norm[MW];
  bool qb[MW];
  float lam_s[MS], d_s[MS], inflow_s[MS];
  bool sat[MS];
#pragma unroll
  for (int w = 0; w < MW; ++w) {
    if (w < W) {
      float r = 0.0f;
#pragma unroll
      for (int s = 0; s < MS; ++s)
        if (s < S) r += route[w * S + s] * svc_pipe[w * S + s];
      R_base[w] = r;
      y[w] = 0.0f;
    }
  }
  float lam = INFINITY;
  for (int it = 0; it < n_outer; ++it) {
    // Issue-side caps: token rate and the MLP population over the residency
    // (waits included).
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (w < W) {
        float r = 0.0f;
#pragma unroll
        for (int s = 0; s < MS; ++s)
          if (s < S) r += route[w * S + s] * (Wq[s] + svc_pipe[w * S + s]);
        R_tor[w] = r;
        float c = fminf(y_rate[w], o_eff[w] / fmaxf(r, 1e-9f));
        cap[w] = A[w] > 0.0f ? c : 0.0f;
      }
    }
    station_lams<MW, MS>(ln, W, S, A, cap, route_svc, slots, lam_s);
    float hi0 = -INFINITY;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (w < W) {
        float lam_min = INFINITY;
#pragma unroll
        for (int s = 0; s < MS; ++s)
          if (s < S) lam_min = fminf(lam_min, route_svc[w * S + s] > 1e-12f ? lam_s[s] : kBig);
        y_sta[w] = fminf(lam_min, kBig) * fmaxf(A[w], 0.0f);
        hi0 = fmaxf(hi0, fminf(cap[w], kBig) / fmaxf(A[w], 1e-12f));
      }
    }
    lam = glam_cell<MW>(ln.glam, W, A, cap, y_sta, o_eff, R_tor, tor, irq, hi0 + 1e-6f);
    const float lam_b = fminf(lam, kBig);
    float ysum = 0.0f;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (w < W) {
        float y_free = fminf(lam_b * A[w], cap[w]);
        y[w] = fminf(y_free, y_sta[w]);
        qb[w] = (y_sta[w] <= lam_b * A[w] * (1.0f + 1e-9f)) &&
                (y_sta[w] < cap[w] * (1.0f - 1e-9f));
        ysum += y[w];
      }
    }
    const float denom = fmaxf(ysum, 1e-12f);
    float pop_sum = 0.0f, base_pop = 0.0f;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (w < W) {
        float unc = fminf(o_eff[w], y[w] * R_tor[w]);
        float share = y[w] / denom;
        pop_w[w] = qb[w] ? fmaxf(o_eff[w] - irq * share, unc) : unc;
        pop_sum += pop_w[w];
        base_pop += y[w] * R_base[w];
      }
    }
    // Wait relaxation: the queued population sits at the saturated stations
    // of the queue-forming workloads; Little's law turns depth into wait.
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S) {
        float d = 0.0f, f = 0.0f;
#pragma unroll
        for (int w = 0; w < MW; ++w) {
          if (w < W) {
            d += y[w] * route_svc[w * S + s];
            f += y[w] * route[w * S + s];
          }
        }
        d_s[s] = d;
        inflow_s[s] = f;
        sat[s] = (d / fmaxf(slots[s], 1e-9f) >= 0.98f) && (slots[s] > 0.0f);
      }
    }
    const float q_total = fmaxf(fminf(pop_sum, tor) - base_pop, 0.0f);
    float q_sum = 0.0f;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      if (w < W) {
        q_w[w] = qb[w] ? fmaxf(pop_w[w] - y[w] * R_base[w], 0.0f) : 0.0f;
        q_sum += q_w[w];
        float n = 0.0f;
#pragma unroll
        for (int s = 0; s < MS; ++s)
          if (s < S) n += sat[s] ? route_svc[w * S + s] : 0.0f;
        w_norm[w] = n;
      }
    }
    const float scale =
        q_sum > 1e-12f ? fminf(1.0f, q_total / fmaxf(q_sum, 1e-12f)) : 0.0f;
#pragma unroll
    for (int w = 0; w < MW; ++w)
      if (w < W) q_w[w] = q_w[w] * scale;
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S) {
        float q_s = 0.0f;
#pragma unroll
        for (int w = 0; w < MW; ++w) {
          if (w < W) {
            float w_st = sat[s] ? route_svc[w * S + s] : 0.0f;
            w_st = w_norm[w] > 1e-12f ? w_st / fmaxf(w_norm[w], 1e-12f) : 0.0f;
            q_s += q_w[w] * w_st;
          }
        }
        float mean_svc = d_s[s] / fmaxf(inflow_s[s], 1e-12f);
        float w_new = q_s * mean_svc / fmaxf(slots[s], 1e-9f);
        w_new = sat[s] ? w_new : 0.0f;
        Wq[s] = damp * Wq[s] + (1.0f - damp) * w_new;
      }
    }
  }
  return lam;
}

}  // namespace fluid

namespace {

constexpr int kWarpsPerBlock = 4;  // one cell per warp
constexpr int kThreads = 32 * kWarpsPerBlock;

// Load a cell's W values of a [C, W] input into warp-uniform registers.
template <int MW>
__device__ __forceinline__ void load_w(float* dst, const float* __restrict__ src, int c,
                                       int W) {
#pragma unroll
  for (int w = 0; w < MW; ++w)
    if (w < W) dst[w] = src[c * W + w];
}

// MW, MS: the most workloads and stations this instantiation takes; the
// launcher picks the smallest that fits, so that the unrolled loops stay
// short (a kernel unrolled to 8 x 8 for a 2 x 3 cell runs mostly guards).
template <int MW>
__global__ void __launch_bounds__(kThreads) global_lambda_kernel(
    const float* __restrict__ A, const float* __restrict__ cap,
    const float* __restrict__ y_sta, const float* __restrict__ o_eff,
    const float* __restrict__ r_tor, const float* __restrict__ tor,
    const float* __restrict__ irq, const float* __restrict__ hi0,
    float* __restrict__ out, int C, int W) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (c >= C) return;  // the whole warp: one cell per warp
  float a[MW], cp[MW], ys[MW], o[MW], r[MW];
  load_w<MW>(a, A, c, W);
  load_w<MW>(cp, cap, c, W);
  load_w<MW>(ys, y_sta, c, W);
  load_w<MW>(o, o_eff, c, W);
  load_w<MW>(r, r_tor, c, W);
  const float lam = fluid::glam_cell<MW>(fluid::tree_lane(lane, 0, 32), W, a, cp, ys, o, r,
                                         tor[c], irq[c], hi0[c]);
  if (lane == 0) out[c] = lam;
}

template <int MW, int MS>
__global__ void __launch_bounds__(kThreads) fused_window_solve_kernel(
    const float* __restrict__ A, const float* __restrict__ y_rate,
    const float* __restrict__ o_eff, const float* __restrict__ route,
    const float* __restrict__ route_svc, const float* __restrict__ svc_pipe,
    const float* __restrict__ slots, const float* __restrict__ tor,
    const float* __restrict__ irq, const float* __restrict__ Wq0,
    float* __restrict__ y_out, float* __restrict__ Wq_out, float* __restrict__ lam_out,
    int C, int W, int S, int n_outer, float damp) {
  __shared__ float rows[kWarpsPerBlock][3][MW * MS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= C) return;  // the whole warp: one cell per warp
  float* rt = rows[warp][0];
  float* rs = rows[warp][1];
  float* sp = rows[warp][2];
  const int ws = W * S;
  for (int i = lane; i < ws; i += 32) {
    rt[i] = route[c * ws + i];
    rs[i] = route_svc[c * ws + i];
    sp[i] = svc_pipe[c * ws + i];
  }
  __syncwarp();
  float a[MW], yr[MW], o[MW], y[MW];
  float sl[MS], wq[MS];
  load_w<MW>(a, A, c, W);
  load_w<MW>(yr, y_rate, c, W);
  load_w<MW>(o, o_eff, c, W);
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    if (s < S) {
      sl[s] = slots[c * S + s];
      wq[s] = Wq0[c * S + s];
    }
  }
  const float lam =
      fluid::window_solve_cell<MW, MS>(fluid::make_lanes(lane, S), W, S, n_outer, damp, a, yr,
                                       o, rt, rs, sp, sl, tor[c], irq[c], y, wq);
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < MW; ++w)
      if (w < W) y_out[c * W + w] = y[w];
#pragma unroll
    for (int s = 0; s < MS; ++s)
      if (s < S) Wq_out[c * S + s] = wq[s];
    lam_out[c] = lam;
  }
}

template <int MW>
void launch_glam(int blocks, cudaStream_t stream, const float* A, const float* cap,
                 const float* y_sta, const float* o_eff, const float* r_tor,
                 const float* tor, const float* irq, const float* hi0, float* out, int C,
                 int W) {
  global_lambda_kernel<MW><<<blocks, kThreads, 0, stream>>>(A, cap, y_sta, o_eff, r_tor,
                                                            tor, irq, hi0, out, C, W);
}

template <int MW, int MS>
void launch_fused(int blocks, cudaStream_t stream, const float* A, const float* y_rate,
                  const float* o_eff, const float* route, const float* route_svc,
                  const float* svc_pipe, const float* slots, const float* tor,
                  const float* irq, const float* Wq0, float* y_out, float* Wq_out,
                  float* lam_out, int C, int W, int S, int n_outer, float damp) {
  fused_window_solve_kernel<MW, MS><<<blocks, kThreads, 0, stream>>>(
      A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor, irq, Wq0, y_out, Wq_out,
      lam_out, C, W, S, n_outer, damp);
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
  if (W < 1 || W > FS_MAX_W) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 2)
    launch_glam<2>(blocks, st, A, cap, y_sta, o_eff, r_tor, tor, irq, hi0, out, C, W);
  else
    launch_glam<FS_MAX_W>(blocks, st, A, cap, y_sta, o_eff, r_tor, tor, irq, hi0, out, C,
                          W);
  return static_cast<int>(cudaGetLastError());
}

// The sweep's cells are W = 2, S = 3 (DDR, CXL, LLC): they and smaller
// groups take the <2, 3> instance, the rest <FS_MAX_W, FS_MAX_S>.
static bool small_instance(int W, int S) { return W <= 2 && S <= 3; }

// The <W_MAX, S_MAX> instance fluid_window_solve_launch runs for W
// workloads and S stations.
void fluid_window_instance(int W, int S, int* w_max, int* s_max) {
  *w_max = small_instance(W, S) ? 2 : FS_MAX_W;
  *s_max = small_instance(W, S) ? 3 : FS_MAX_S;
}

int fluid_window_solve_launch(const float* A, const float* y_rate, const float* o_eff,
                              const float* route, const float* route_svc,
                              const float* svc_pipe, const float* slots, const float* tor,
                              const float* irq, const float* Wq0, float* y_out,
                              float* Wq_out, float* lam_out, int C, int W, int S,
                              int n_outer, float damp, void* stream) {
  if (C <= 0) return 0;
  if (W < 1 || W > FS_MAX_W || S < 1 || S > FS_MAX_S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small_instance(W, S))
    launch_fused<2, 3>(blocks, st, A, y_rate, o_eff, route, route_svc, svc_pipe, slots, tor,
                       irq, Wq0, y_out, Wq_out, lam_out, C, W, S, n_outer, damp);
  else
    launch_fused<FS_MAX_W, FS_MAX_S>(blocks, st, A, y_rate, o_eff, route, route_svc,
                                     svc_pipe, slots, tor, irq, Wq0, y_out, Wq_out,
                                     lam_out, C, W, S, n_outer, damp);
  return static_cast<int>(cudaGetLastError());
}

// The round scheme, so that the wrapper reports what this source runs:
// warps per cell, steps per bisection, levels per round of the global
// lambda and of the station bisections at S stations.
int fluid_warps_per_cell() { return kThreads / 32 / kWarpsPerBlock; }
int fluid_bisect_iters() { return FS_BISECT_ITERS; }
int fluid_glam_levels() { return fluid::kGlamLevels; }
int fluid_station_levels(int S) { return fluid::station_levels(S); }

const char* fluid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
