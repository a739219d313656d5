// Mamba2 SSD chunked scan for Hopper (sm_90a), one group (G = 1).
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_kernel (body
// _ssd_kernel), the Pallas TPU kernel.  It computes what that kernel
// computes, in f32 inside: per chunk of Q steps of one (batch, head),
//   cum   = cumsum(dt * a)
//   y     = (C B^T * [k <= q] exp(cum_q - cum_k)) @ (dt x)  +  exp(cum) * C h^T
//   h    <- exp(sum dt a) * h + sum_q exp(cum_last - cum_q) (dt x)_q B_q^T
// with the [P, N] state h carried from chunk to chunk.  It also writes the
// final state [B, H, P, N] f32, which the model's decode needs (the TPU
// kernel keeps it only in VMEM scratch).  y is written in x's dtype.
//
// Bound: operations in f32 at the mamba2 shape, bytes in bf16.  Per (head,
// chunk) at Q = 128, P = 64, N = 128 the three products need about 6 MFLOP
// against 16 KB of x, so the ridge is far; C B^T is shared by all heads at
// G = 1 and is the same for every head of a batch row.
//
// Design (simple and right first).  The TPU grid (B, H, S / Q) runs its
// chunk axis in order with h in VMEM scratch; blocks on Hopper run in no
// order, so one block of 256 threads owns one (head, batch row) and walks
// the chunks in a loop, with h in shared memory for the whole walk.  Per
// chunk it stages B, C, dt x (all f32) and the cumulative decays in shared
// memory, then builds y 32 query rows at a time: the masked, decayed score
// tile [32, Q] goes to shared memory, then each thread accumulates a 4 x 2
// tile of y over the chunk's keys and over the state.  Last, each thread
// updates 8 x 4 elements of h.  Shared memory at Q = 128, P = 64, N = 128 is
// 215 KB of the 227 KB a block may take, so the block owns an SM; B and h
// rows are padded to N + 1 floats so that threads walking rows hit distinct
// banks.  Rows past S (a ragged last chunk) load as dt = 0, x = B = C = 0:
// the zero padding of the reference, exact no-op steps, with no padded copy
// of the inputs.  x, B, C and dt are read by strides, so the model's
// [B, S, conv_dim] projection is read in place.  The causal mask selects
// before the exponential is used: exp(cum_q - cum_k) for k > q may be inf,
// and inf * 0 would be NaN.  Built without fast math: expf, not __expf, and
// IEEE f32 throughout, as the reference's f32 arithmetic.  The next steps
// (a perf_opt PR): tensor-core products (wgmma), several heads per block so
// that B and C are read once for all 80 heads, and TMA staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxQ = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kRows = 32;  // query rows per score tile (8 warps x 4 rows)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ inline int round32(int v) { return (v + 31) / 32 * 32; }

// Shared-memory floats for chunk length q, head dim p and state size n
// (215 KB at 128, 64, 128: within the 227 KB a block may take).
__host__ __device__ inline int smem_floats(int q, int p, int n) {
  const int qp = round32(q);
  return p * (n + 1)      // h
         + qp * (n + 1)   // B
         + qp * n         // C
         + qp * p         // dt x
         + kRows * qp     // score tile
         + 3 * qp         // cum, dt, tail
         + kMaxQ / 32;    // warp sums of the scan
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N, int Q,
                int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                int64_t dt_sh, int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  const int QP = round32(Q);
  float* hs = smem;              // [P][N + 1]
  float* Bs = hs + P * NP;       // [QP][N + 1]
  float* Cs = Bs + QP * NP;      // [QP][N]
  float* dxs = Cs + QP * N;      // [QP][P]   dt * x
  float* St = dxs + QP * P;      // [kRows][QP]
  float* cum = St + kRows * QP;  // [QP]
  float* dts = cum + QP;         // [QP]
  float* tails = dts + QP;       // [QP]
  float* wsum = tails + QP;      // [kMaxQ / 32]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 0..7
  const float ah = a[h];

  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  T* yb = y + ((int64_t)b * S * H + h) * P;  // y is [B, S, H, P], contiguous
  const int64_t y_ss = (int64_t)H * P;

  for (int i = tid; i < P * NP; i += kThreads) hs[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int qv = min(Q, S - t0);  // valid rows of this chunk
    __syncthreads();                // the last chunk's readers are done

    // 1. Stage the chunk; rows past qv are zero (dt = 0 padding).
    for (int i = tid; i < QP * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      float bv = 0.0f, cv = 0.0f;
      if (t < qv) {
        bv = to_f(bb[(t0 + t) * b_ss + n]);
        cv = to_f(cb[(t0 + t) * c_ss + n]);
      }
      Bs[t * NP + n] = bv;
      Cs[t * N + n] = cv;
    }
    for (int i = tid; i < QP * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      dxs[i] = t < qv ? to_f(xb[(t0 + t) * x_ss + p]) : 0.0f;
    }
    if (warp < kMaxQ / 32) {  // inclusive scan of dt * a, 32 steps a warp
      const int t = warp * 32 + lane;
      const float d = t < qv ? dtb[(t0 + t) * dt_ss] : 0.0f;
      float v = d * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (t < QP) {
        cum[t] = v;
        dts[t] = d;
      }
      if (lane == 31) wsum[warp] = v;
    }
    __syncthreads();

    // 2. Finish the scan, scale x by dt.
    for (int t = tid; t < QP; t += kThreads) {
      float prefix = 0.0f;
      for (int w = 0; w < t / 32; ++w) prefix += wsum[w];
      cum[t] += prefix;
    }
    for (int i = tid; i < QP * P; i += kThreads) dxs[i] *= dts[i / P];
    __syncthreads();
    const float cum_last = cum[qv - 1];
    for (int t = tid; t < QP; t += kThreads) tails[t] = expf(cum_last - cum[t]);

    // 3. y, 32 query rows at a time.
    for (int r0 = 0; r0 < qv; r0 += kRows) {
      const int kend = min(r0 + kRows, qv);  // keys k <= the tile's last row
      // 3a. score tile St[r][k] = C_r . B_k * exp(cum_r - cum_k), k <= r.
      {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        const int rbase = r0 + warp * 4;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(rbase + i) * N + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = 32 * j < kend ? Bs[(lane + 32 * j) * NP + n] : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rbase + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = lane + 32 * j;
            if (k < QP) St[(warp * 4 + i) * QP + k] = k <= r ? acc[i][j] * expf(cum[r] - cum[k]) : 0.0f;
          }
        }
      }
      __syncthreads();
      // 3b. y[r][p] = St[r] @ dx[:, p] + exp(cum_r) * C_r . h[p].
      {
        float acc[4][2], inter[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[i][c] = inter[i][c] = 0.0f;
        for (int k = 0; k < kend; ++k) {
          float sv[4], dv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = St[(warp * 4 + i) * QP + k];
#pragma unroll
          for (int c = 0; c < 2; ++c) dv[c] = dxs[k * P + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) acc[i][c] += sv[i] * dv[c];
        }
        const int rbase = r0 + warp * 4;
        if (t0 > 0) {  // the state is zero before the first chunk
          for (int n = 0; n < N; ++n) {
            float cv[4], hv[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[(rbase + i) * N + n];
#pragma unroll
            for (int c = 0; c < 2; ++c) hv[c] = hs[(lane + 32 * c) * NP + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 2; ++c) inter[i][c] += cv[i] * hv[c];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rbase + i;
          if (r >= qv) continue;
          const float e = expf(cum[r]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int p = lane + 32 * c;
            if (p < P) store(yb + (t0 + r) * y_ss + p, acc[i][c] + e * inter[i][c]);
          }
        }
      }
      __syncthreads();  // St is rewritten by the next tile
    }

    // 4. h <- exp(cum_last) h + sum_k tail_k dx_k B_k^T; this thread owns
    //    rows p = warp + 8 i and columns n = lane + 32 j.
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < qv; ++k) {
        const float tk = tails[k];
        float wv[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) wv[i] = warp + 8 * i < P ? tk * dxs[k * P + warp + 8 * i] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k * NP + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * bv[j];
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = warp + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          if (p < P && n < N) hs[p * NP + n] = decay * hs[p * NP + n] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* sb = state_out + ((int64_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sb[i] = hs[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* bm, const void* cm,
                   const void* a, void* y, void* state, int batch, int S, int H, int P,
                   int N, int Q, const int64_t* xs, const int64_t* dts, const int64_t* bs,
                   const int64_t* cs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, Q, xs[0], xs[1], xs[2], dts[0], dts[1],
      dts[2], bs[0], bs[1], cs[0], cs[1]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and a are float32.
// Strides are in elements: x (batch, step, head) with P contiguous, dt
// (batch, step, head), B and C (batch, step) with N contiguous.  y is a
// contiguous [B, S, H, P] tensor, state a contiguous [B, H, P, N] f32 one.
// Returns the cudaError_t of the launch.
int ssd_scan_launch(const void* x, const void* dt, const void* bm, const void* cm,
                    const void* a, void* y, void* state, int batch, int S, int H, int P,
                    int N, int Q, int dtype, const int64_t* x_strides,
                    const int64_t* dt_strides, const int64_t* b_strides,
                    const int64_t* c_strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN || S < 1)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, dt, bm, cm, a, y, state, batch, S, H, P, N, Q, x_strides,
                         dt_strides, b_strides, c_strides, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, a, y, state, batch, S, H, P, N, Q,
                                 x_strides, dt_strides, b_strides, c_strides, st);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
