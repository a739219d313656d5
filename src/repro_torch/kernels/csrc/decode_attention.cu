// Flash-decode GQA for Hopper (sm_90a): one new query token per sequence
// against its KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_kernel
// (body _decode_attn_kernel), the Pallas TPU kernel.  It computes what that
// kernel computes: scores q.k * scale in f32, optional tanh softcap, the
// mask pos < lengths[b] && lengths[b]-1-pos < window (masked scores are
// NEG_INF, not -inf, so a row with nothing valid averages V uniformly, as
// the reference softmax does), an online softmax with f32 accumulation,
// and out = acc / max(l, 1e-20).
//
// Bound: bytes.  Each (b, kv-head) reads its valid K and V rows once, about
// 4*Dh bytes (bf16) per position against 4*G*Dh flops, far below the
// card's ~295 flops/byte ridge; the least time is K/V bytes over HBM rate.
//
// Design.  The TPU grid (B, Hkv, S/block_s) walks S in order and carries
// (m, l, acc) in VMEM between grid steps.  Blocks on Hopper run in no
// order, so the S walk becomes a loop inside one block per (kv-head, b,
// chunk of up to 8 query rows); the block holds those G query rows (q in
// shared memory, f32, pre-scaled).  Per tile of 64 positions:
//   1. scores: groups of 8 lanes share one cache row, each lane loads Dh/8
//      contiguous elements with 16-byte loads and the group reduces the
//      partial dots with three xor-shuffles; 16 rows per pass.
//   2. softmax: one warp per query row updates (m, l) and turns the tile's
//      scores into probabilities in shared memory.
//   3. values: each thread owns one d (and every 128/Dh-th query row) and
//      accumulates p * v in registers, after rescaling by exp(m_old-m_new).
// Only positions in the valid range [max(0, len-window), min(len, S)) are
// visited: a skipped masked score contributes exp(NEG_INF - m) = 0 exactly.
// K/V rows are addressed by strides, so the model-layout cache
// [B, S, Hkv, Dh] is read in place (no transpose copy).  Simple first: one
// block per (b, kv-head) leaves SMs idle at decode batch sizes; splitting S
// across blocks with a combine pass, cp.async/TMA staging and tensor-core
// products are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                         // 4 warps
constexpr int kGroupLanes = 8;                        // lanes per cache row (score pass)
constexpr int kRowsPerPass = kThreads / kGroupLanes;  // 16 rows per pass
constexpr int kTile = 64;                             // positions per softmax step
constexpr int kGChunk = 8;                            // query rows per block
constexpr float kNegInf = -2.3819763e38f;             // the reference's NEG_INF

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kElems = 4;  // per 16-byte load
  __device__ static void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void to_float(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,            // [B, Hkv, G, DH] contiguous
    const T* __restrict__ k,            // rows of DH contiguous elements, strided
    const T* __restrict__ v,
    const int* __restrict__ lengths,    // [B]
    T* __restrict__ out,                // [B, Hkv, G, DH] contiguous
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int hkv, int g_total, int s_len, float scale, int window, float softcap) {
  constexpr int kEpl = DH / kGroupLanes;         // elements per lane per row
  constexpr int kVecs = kEpl / Vec<T>::kElems;   // 16-byte loads per lane per row
  constexpr int kGStride = kThreads / DH;        // query rows sharing one d (PV pass)
  constexpr int kGSlots = kGChunk / kGStride;    // query rows per thread (PV pass)

  __shared__ float q_s[kGChunk][DH];
  __shared__ float p_s[kGChunk][kTile];
  __shared__ float m_s[kGChunk], l_s[kGChunk], alpha_s[kGChunk];

  const int h = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * kGChunk;
  const int gn = min(kGChunk, g_total - g0);
  const int tid = threadIdx.x;
  const int64_t bh = (int64_t)b * hkv + h;
  const T* qb = q + (bh * g_total + g0) * DH;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kGChunk * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    q_s[g][d] = g < gn ? to_f(qb[g * DH + d]) * scale : 0.f;
  }
  if (tid < kGChunk) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int length = lengths[b];
  const int lo = max(0, length - window);
  const int hi = min(length, s_len);
  // Nothing valid: every score is NEG_INF and the softmax is uniform over
  // all S positions, as in the reference.
  const int begin = lo < hi ? lo : 0;
  const int end = lo < hi ? hi : s_len;

  const int grp = tid / kGroupLanes, lane8 = tid % kGroupLanes;
  const int warp = tid / 32, lane = tid % 32;
  const int d = tid % DH, g_first = tid / DH;
  float acc[kGSlots];
#pragma unroll
  for (int j = 0; j < kGSlots; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = begin; t0 < end; t0 += kTile) {
    // 1. scores for the tile
    for (int r = grp; r < kTile; r += kRowsPerPass) {
      const int pos = t0 + r;
      float part[kGChunk];
#pragma unroll
      for (int g = 0; g < kGChunk; ++g) part[g] = 0.f;
      if (pos < end) {
        const uint4* row =
            reinterpret_cast<const uint4*>(kb + pos * k_ss + lane8 * kEpl);
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          float f[Vec<T>::kElems];
          Vec<T>::to_float(__ldg(row + j), f);
#pragma unroll
          for (int e = 0; e < Vec<T>::kElems; ++e) {
            const int dd = lane8 * kEpl + j * Vec<T>::kElems + e;
#pragma unroll
            for (int g = 0; g < kGChunk; ++g) part[g] += q_s[g][dd] * f[e];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGChunk; ++g) {
#pragma unroll
        for (int off = kGroupLanes / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      }
      if (lane8 == 0) {
#pragma unroll
        for (int g = 0; g < kGChunk; ++g) {
          float s;
          if (pos >= end) {
            s = -INFINITY;  // past the walked range: no weight at all
          } else if (pos < lo || pos >= hi) {
            s = kNegInf;
          } else {
            s = part[g];
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          }
          p_s[g][r] = s;
        }
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query row
    for (int g = warp; g < kGChunk; g += kThreads / 32) {
      const float s0 = p_s[g][lane], s1 = p_s[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      p_s[g][lane] = e0;
      p_s[g][lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ v
#pragma unroll
    for (int j = 0; j < kGSlots; ++j) acc[j] *= alpha_s[g_first + j * kGStride];
    const int n_rows = min(kTile, end - t0);
    for (int r = 0; r < n_rows; ++r) {
      const float vv = to_f(vb[(t0 + r) * v_ss + d]);
#pragma unroll
      for (int j = 0; j < kGSlots; ++j) acc[j] += p_s[g_first + j * kGStride][r] * vv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kGSlots; ++j) {
    const int g = g_first + j * kGStride;
    if (g < gn) store(out + (bh * g_total + g0 + g) * DH + d, acc[j] / fmaxf(l_s[g], 1e-20f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, int b, int hkv, int g, int s,
                   const int64_t* k_strides, const int64_t* v_strides, float scale,
                   int window, float softcap, cudaStream_t stream) {
  dim3 grid(hkv, b, (g + kGChunk - 1) / kGChunk);
  decode_attention_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      k_strides[0], k_strides[1], k_strides[2], v_strides[0], v_strides[1], v_strides[2],
      hkv, g, s, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: (batch,
// kv-head, position); the last dimension must be contiguous.  softcap <= 0
// means none.  Returns the cudaError_t of the launch.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int b, int hkv, int g,
                            int s, int dh, int dtype, const int64_t* k_strides,
                            const int64_t* v_strides, float scale, int window,
                            float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, lengths, out, b, hkv, g, s, k_strides, v_strides,
                             scale, window, softcap, st);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, lengths, out, b, hkv, g, s, k_strides, v_strides,
                              scale, window, softcap, st);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lengths, out, b, hkv, g, s, k_strides,
                                     v_strides, scale, window, softcap, st);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lengths, out, b, hkv, g, s, k_strides,
                                      v_strides, scale, window, softcap, st);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
