// One decode step of the Mamba-2 recurrence for Hopper (sm_90a): the f32
// state updated in place and the read-out, in one pass over the state.
//
// Replaces no TPU kernel.  The JAX package's decode step
// (src/repro/models/ssm.py, ssm_step) is plain jnp that XLA fuses on the
// TPU; PyTorch's eager ops ran it as separate passes over the [B, H, P, N]
// f32 state (the decay product, the outer product, their sum, the copy
// back into the decode state and the read-out), each reading or writing
// all of it.  For each batch row b and head h, with g = h / (H / G):
//   dt = softplus(dt_raw[b, h] + dt_bias[h])       (threshold 20, as torch's)
//   da = exp(dt * -exp(A_log[h]))
//   h[b, h, p, n] <- h[b, h, p, n] * da + (dt * x[b, h, p]) * B[b, g, n]
//   y[b, h, p]     = sum_n h[b, h, p, n] * C[b, g, n] + D[h] * x[b, h, p]
// all in f32; y is written in x's dtype.  Every product and sum of the
// update is rounded once, in the plain version's order (no contraction into
// fma), so the new state is the plain version's bit for bit; only the
// read-out's sum over n runs in another order than the einsum's.
//
// Bound: the state's bytes, read once and written once (B 128, H 80,
// P 64, N 128: 335.5 MB each way a layer, 0.20 ms at 3.35 TB/s); x, B, C
// and y are under 0.5% of that, and the work is 5 operations a state
// element.
//
// Design.  One block of 64 or 128 threads takes one (b, h) tile of P x N
// (32 KB at P 64, N 128).  N is 16, 32, 64 or 128, the kernel built for
// each.  A row of N f32 is N / 4 16-byte columns, spread over L lanes (4
// at N 16, else 8), V = N / (4 L) columns a lane (1, 1, 2 or 4), lane l
// holding columns l, l + L, ...: neighbouring lanes
// load neighbouring 16 bytes.  The mapping depends on N alone, so N = 16
// keeps every lane busy (4 lanes a row, 8 rows a warp) as N = 128 does (8
// lanes a row, each 4 columns).  A thread holds up to 4 rows: it issues
// all its loads of the tile first (up to 16 x 16 bytes in flight), updates
// in registers, stores the new state, and sums its share of the read-out
// from the same registers; the L lanes of a row finish the sum with a
// shuffle reduction.  Nothing but the state itself and y touches device
// memory.  The state is read and written with the streaming cache hint
// (evict first): each element is touched once a step, and the weights that
// the step's products read stay in L2.  While the state's loads are in
// flight the block stages its head's x and its group's B and C, widened to
// f32, in shared memory (2 N + P values), read by strides from the conv
// output's views, whatever their layout (the decode step's conv output is
// channel-major: its einsum runs over the channels as a batch); dt_raw is
// read from the input projection's.  Built without fast math: expf and
// log1pf are IEEE f32, as torch's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 4;  // rows of a tile one thread holds (P 64, 8 lanes, 128 threads)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

// Lanes that share one row of n state elements.
__host__ __device__ constexpr int lanes_per_row(int n) { return (n / 4) % 8 == 0 ? 8 : 4; }

struct Args {
  float* state;  // [B, H, P, N] f32, contiguous, updated in place
  const void* x;  // [B, H, P]
  const void* dt;  // [B, H] (before the bias and softplus)
  const void* b;  // [B, G, N]
  const void* c;  // [B, G, N]
  const float* dt_bias;  // [H]
  const float* a_log;  // [H]
  const float* d;  // [H]
  void* y;  // [B, H, P], contiguous
  int heads, head_dim, heads_per_group;
  int64_t x_sb, x_sh, x_sp, dt_sb, dt_sh, b_sb, b_sg, b_sn, c_sb, c_sg, c_sn;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// h * da + u * b, each product and the sum rounded once.
__device__ __forceinline__ float update(float h, float da, float u, float b) {
  return __fadd_rn(__fmul_rn(h, da), __fmul_rn(u, b));
}

template <typename T, int N>
__global__ void __launch_bounds__(128) ssm_step_kernel(const Args a) {
  constexpr int kCols = N / 4;  // 16-byte columns of a row
  constexpr int L = lanes_per_row(N);
  constexpr int V = kCols / L;  // columns a lane holds
  const int tile = blockIdx.x;  // b * H + h
  const int bi = tile / a.heads;
  const int hi = tile - bi * a.heads;
  const int g = hi / a.heads_per_group;
  const int lane = threadIdx.x % L;
  const int row_step = blockDim.x / L;
  const int rows = a.head_dim / row_step;  // 1-4, the same for every thread
  const int p0 = threadIdx.x / L;

  float dt = __fadd_rn(to_float(static_cast<const T*>(a.dt)[bi * a.dt_sb + hi * a.dt_sh]),
                       a.dt_bias[hi]);
  dt = dt > 20.f ? dt : log1pf(expf(dt));
  const float da = expf(__fmul_rn(dt, -expf(a.a_log[hi])));
  const float skip = a.d[hi];
  float4* s = reinterpret_cast<float4*>(a.state) + static_cast<int64_t>(tile) * a.head_dim * kCols;

  float4 h[kMaxRows][V];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
      const int p = p0 + r * row_step;
#pragma unroll
      for (int v = 0; v < V; ++v) h[r][v] = __ldcs(s + p * kCols + lane + v * L);
    }
  }
  __shared__ float4 sb[kMaxN / 4], sc[kMaxN / 4];
  __shared__ float sx[kMaxP];
  {
    const T* x = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh;
    const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + g * a.b_sg;
    const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + g * a.c_sg;
    float* sbf = reinterpret_cast<float*>(sb);
    float* scf = reinterpret_cast<float*>(sc);
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      sbf[i] = to_float(bp[i * a.b_sn]);
      scf[i] = to_float(cp[i * a.c_sn]);
    }
    for (int i = threadIdx.x; i < a.head_dim; i += blockDim.x) sx[i] = to_float(x[i * a.x_sp]);
  }
  __syncthreads();
  float4 bv[V], cv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    bv[v] = sb[lane + v * L];
    cv[v] = sc[lane + v * L];
  }

  T* y = static_cast<T*>(a.y) + static_cast<int64_t>(tile) * a.head_dim;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
      const int p = p0 + r * row_step;
      const float xp = sx[p];
      const float u = __fmul_rn(dt, xp);
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float4 o = h[r][v];
        o.x = update(o.x, da, u, bv[v].x);
        o.y = update(o.y, da, u, bv[v].y);
        o.z = update(o.z, da, u, bv[v].z);
        o.w = update(o.w, da, u, bv[v].w);
        __stcs(s + p * kCols + lane + v * L, o);
        acc = fmaf(o.x, cv[v].x, acc);
        acc = fmaf(o.y, cv[v].y, acc);
        acc = fmaf(o.z, cv[v].z, acc);
        acc = fmaf(o.w, cv[v].w, acc);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) y[p] = from_float<T>(__fadd_rn(acc, __fmul_rn(skip, xp)));
    }
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int n, int blocks, int threads, cudaStream_t stream) {
  switch (n) {
#define SSM_STEP_CASE(NN)                                                \
  case NN:                                                               \
    ssm_step_kernel<T, NN><<<blocks, threads, 0, stream>>>(a);           \
    break;
    SSM_STEP_CASE(16)
    SSM_STEP_CASE(32)
    SSM_STEP_CASE(64)
    SSM_STEP_CASE(128)
#undef SSM_STEP_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt_raw, B, C and y); the state
// (16-byte aligned), dt_bias, A_log and D are float32, and they and y are
// contiguous.  The other strides are in elements, any layout: x (batch,
// head, p), dt_raw (batch, head), B and C (batch, group, n).  P is a
// multiple of 16 up to 64, N is 16, 32, 64 or 128, G divides H.  Launches
// one kernel of B x H blocks on stream; returns its cudaError_t
// (cudaErrorInvalidValue for shapes it does not take).
int ssm_step_launch(void* state, const void* x, const void* dt, const void* bmat,
                    const void* cmat, const void* dt_bias, const void* a_log, const void* d,
                    void* y, int batch, int heads, int head_dim, int d_state, int groups,
                    int dtype, int64_t x_sb, int64_t x_sh, int64_t x_sp, int64_t dt_sb,
                    int64_t dt_sh, int64_t b_sb, int64_t b_sg, int64_t b_sn, int64_t c_sb,
                    int64_t c_sg, int64_t c_sn, void* stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || heads % groups != 0 || head_dim <= 0 ||
      head_dim > kMaxP || head_dim % 16 != 0 ||
      (d_state != 16 && d_state != 32 && d_state != 64 && d_state != 128) ||
      static_cast<int64_t>(batch) * heads > 0x7fffffff)
    return cudaErrorInvalidValue;
  const Args a{static_cast<float*>(state), x, dt, bmat, cmat,
               static_cast<const float*>(dt_bias), static_cast<const float*>(a_log),
               static_cast<const float*>(d), y, heads, head_dim, heads / groups,
               x_sb, x_sh, x_sp, dt_sb, dt_sh, b_sb, b_sg, b_sn, c_sb, c_sg, c_sn};
  // P x L is a multiple of 64; a thread holds (P x L) / threads <= 4 rows.
  const int lanes = head_dim * lanes_per_row(d_state);
  const int threads = lanes % 128 == 0 ? 128 : 64;
  const int blocks = batch * heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<float>(a, d_state, blocks, threads, s);
    case 1:
      return launch_typed<__nv_bfloat16>(a, d_state, blocks, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ssm_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
