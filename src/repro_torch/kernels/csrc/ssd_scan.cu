// Mamba2 SSD chunked scan for Hopper (sm_90a), with G groups of B and C.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_kernel (body
// _ssd_kernel), the Pallas TPU kernel.  It computes what that kernel
// computes, in f32 inside: per chunk of Q steps of one (batch, head),
//   cum   = cumsum(dt * a)
//   y     = (C B^T * [k <= q] exp(cum_q - cum_k)) @ (dt x)  +  exp(cum) * C h^T
//   h    <- exp(sum dt a) * h + sum_q exp(cum_last - cum_q) (dt x)_q B_q^T
// with the [P, N] state h carried from chunk to chunk, B and C those of the
// head's group (heads h of group h / (H / G)).  It also writes the
// final state [B, H, P, N] f32, which the model's decode needs (the TPU
// kernel keeps it only in VMEM scratch).  y is written in x's dtype.
//
// Bound: bytes in bf16 at the mamba2 shape (Q = 128, P = 64, N = 128,
// H = 80): about 6 MFLOP of products per (head, chunk) against 16 KB of x
// in and 16 KB of y out, and the bf16 tensor cores do 295 flops a byte of
// HBM; in f32 (CUDA cores, 67 TFLOP/s) the products bound it.
//
// Design.  The TPU grid (B, H, S / Q) runs its chunk axis in order with h
// in VMEM scratch.  Here the standard SSD decomposition exposes the chunk
// axis, so the heavy work is parallel over (chunk, head, batch row) and
// only the cheap [P, N] affine recurrence is serial:
//   * Stage A (ssd_state_kernel), grid (chunk, head group, batch row): per
//     head, the chunk's own state s_c = sum_k x_k (tail_k dt_k) B_k^T and
//     its decay exp(sum dt a), into f32 scratch [B, H, n_chunks, P, N] and
//     [B, H, n_chunks].  B is staged once for the group's heads.
//   * Stage B (ssd_pass_kernel), grid (P N / 1024, head, batch row): each
//     thread walks the chunks of 4 state elements in order, h_in[c] = h,
//     h = decay_c h + s_c, loading 8 chunks ahead; h_in goes to the
//     operand type (over s_c in place in f32, to a bf16 buffer in bf16), the
//     last h to the final state.
//   * Stage C (ssd_chunk_kernel), grid (chunk, head group, batch row): C B^T
//     once per block for all its heads, the causal k16
//     tiles only, kept in registers as f32 accumulators (warp w owns query
//     rows 16w..16w+15); per head, y = C h_in^T scaled by exp(cum_q), plus
//     W' @ x with W'[q, k] = C B^T [k <= q] exp(cum_q - cum_k) dt_k built
//     in registers from the C B^T fragments and fed straight back as the A
//     operand (two n8 accumulator tiles make one k16 A fragment).  The mask
//     selects before the exponential's value is used: exp(cum_q - cum_k)
//     for k > q may be inf, and inf * 0 would be NaN.
//   * One chunk (S <= Q, every serve prefill of up to 128 tokens): one launch
//     of ssd_chunk_kernel<T, true>, which also computes the chunk's state
//     (the final state) per head: no scratch, no Stage A or B.
// Head groups.  A block of Stages A and C takes hpb heads of one B/C group,
// never two: its grid row y is head block y % gb of group y / gb, where gb
// = ceil((H / G) / hpb), so B (and C) is staged once for all its heads.  At
// G = 1 that is head block y, and the kernels compute what they did before
// groups were taken.
// Products: in bf16, mma.sync.m16n8k16 (bf16 in, f32 sums) with operands
// by ldmatrix / ldmatrix.trans from shared memory staged by 16-byte
// cp.async.  Roundings beyond the reference's: W' once to bf16 (x enters
// as stored); in Stage A, x_k tail_k dt_k once to bf16 (B enters as
// stored; the factor is applied in registers to the ldmatrix'd fragment);
// h_in once to bf16.  kernels/ref.py::ssd_scan_staged_ref rounds at the
// same places.  In f32 the same fragments are computed on the CUDA cores in
// full f32 (no TF32): each thread forms its 16 x 8 accumulator tile's
// share from shared memory, W' comes to it by shuffles within the quad.
// Rows past S (a ragged last chunk) load as x = B = C = 0 and dt = 0: the
// zero padding of the reference, exact no-op steps.  x, B, C and dt are read
// by strides, so the model's [B, S, conv_dim] projection is read in place
// (rows must be 16-byte aligned).  Built without fast math: expf, IEEE f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;  // = 16 x kWarps query rows of Stage C
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;  // chunks loaded ahead in Stage B
constexpr int kMaxDevices = 64;

template <typename T>
struct Cfg;

template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kPad = 8;  // elements: 16 bytes a row, distinct banks for ldmatrix
  static constexpr bool kMma = true;
  static constexpr int kBlocksPerSm = 2;
};

template <>
struct Cfg<float> {
  static constexpr int kPad = 4;
  static constexpr bool kMma = false;
  static constexpr int kBlocksPerSm = 1;
};

template <typename T>
struct Params {
  const T* x;
  const float* dt;
  const T* bm;
  const T* cm;
  const float* a;
  T* y;           // [B, S, H, P] contiguous
  float* state;   // [B, H, P, N] f32 contiguous
  float* sc;      // [B, H, n_chunks, P, N] f32 (Stage A out, Stage B in)
  float* decay;   // [B, H, n_chunks] f32
  T* hin;         // [B, H, n_chunks, P, N] in T (Stage B out, Stage C in)
  int64_t x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
  int S, H, P, N, Q, QP, nc, hpb;
  int hpg;  // heads per group, H / G
  int gb;   // head blocks per group, ceil(hpg / hpb)
};

// The heads [h_lo, h_hi) of grid row y and their group g.
template <typename T>
__device__ __forceinline__ int head_block(const Params<T>& p, int y, int& h_hi, int& g) {
  g = y / p.gb;
  const int g_lo = g * p.hpg;
  const int h_lo = g_lo + (y - g * p.gb) * p.hpb;
  h_hi = min(g_lo + p.hpg, h_lo + p.hpb);
  return h_lo;
}

// Shared-memory carve-up (bytes).  Rows of N or P elements are padded by
// Cfg<T>::kPad so that a row is a multiple of 16 bytes and 8 consecutive
// rows start in distinct 16-byte bank groups.  Stage A (chunk = false): the
// dt scan, B, and two x buffers (the next head's x is loaded while this
// head's is used).  Stage C (chunk = true): the dt scan, B, x, C and h_in;
// after C B^T is formed the B region holds the second x and h_in buffer.
template <typename T>
struct Smem {
  int ldn, ldp, f_off, b_off, x_off, x2_off, h2_off, c_off, h_off, bytes;
  __host__ __device__ Smem(int qp, int p, int n, bool chunk) {
    ldn = n + Cfg<T>::kPad;
    ldp = p + Cfg<T>::kPad;
    const int e = int(sizeof(T));
    const int x_bytes = qp * ldp * e, h_bytes = p * ldn * e, b_bytes = qp * ldn * e;
    int off = 0;
    f_off = off;  // cum, dt, tail * dt [kMaxQ] each, the chunk's decay
    off += 4 * (3 * kMaxQ + 4);
    b_off = off;
    x2_off = chunk ? off : 0;
    h2_off = chunk ? off + x_bytes : 0;
    off += chunk && x_bytes + h_bytes > b_bytes ? x_bytes + h_bytes : b_bytes;
    x_off = off;
    off += x_bytes;
    c_off = h_off = 0;
    if (chunk) {
      c_off = off;
      off += b_bytes;
      h_off = off;
      off += h_bytes;
    } else {
      x2_off = off;
      off += x_bytes;
    }
    bytes = off;
  }
};

// -- PTX wrappers --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b for a 16x16 bf16 A (row), 16x8 bf16 B (col), 16x8 f32 D.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- end of PTX wrappers --

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 scaled by (s0, s1) in f32 and rounded once.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s0, float s1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(f.x * s0, f.y * s1);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows x cols elements from src (rows row_stride apart, cols contiguous) to
// dst (rows ld apart) by 16-byte cp.async; rows >= valid are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int64_t row_stride,
                                           int valid, int rows, int cols) {
  constexpr int kPer = 16 / int(sizeof(T));
  const int per_row = cols / kPer;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, e = (i - r * per_row) * kPer;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + e, ok ? src + r * row_stride + e : src, ok ? 16 : 0);
  }
}

// acc[j] (n8 tiles at n0 + 8 j, j < 2 n16) += A[m0 .. m0+16, k0 .. k1) . B[k0 .. k1, n0 ..)
// for one warp, A and B in shared memory.  kATrans: A[m][k] = a[k * lda + m]
// (else a[m * lda + k]); kBTrans: B[k][n] = b[n * ldb + k] (else
// b[k * ldb + n]).  a_kscale, if given, scales A's column k by a_kscale[k]
// (in bf16: in f32 on the loaded fragment, rounded once).  Accumulator
// layout of mma.m16n8: acc[j][0..1] = rows gid, cols 2 tig + 0..1;
// acc[j][2..3] = rows gid + 8.
template <typename T, bool kATrans, bool kBTrans, int kMaxN16>
__device__ __forceinline__ void gemm_ss(float (*acc)[4], const T* a, int lda, int m0,
                                        const float* a_kscale, const T* b, int ldb, int n0,
                                        int n16, int k0, int k1) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  if constexpr (Cfg<T>::kMma) {
    const int q = lane >> 3, r8 = lane & 7;
    for (int k = k0; k < k1; k += 16) {
      uint32_t af[4];
      if constexpr (kATrans)
        ldmatrix_x4_trans(af, a + (k + (q >> 1) * 8 + r8) * lda + m0 + (q & 1) * 8);
      else
        ldmatrix_x4(af, a + (m0 + (lane & 15)) * lda + k + (lane >> 4) * 8);
      if (a_kscale != nullptr) {
        const float2 s0 = *reinterpret_cast<const float2*>(a_kscale + k + 2 * tig);
        const float2 s1 = *reinterpret_cast<const float2*>(a_kscale + k + 8 + 2 * tig);
        af[0] = scale_bf16x2(af[0], s0.x, s0.y);
        af[1] = scale_bf16x2(af[1], s0.x, s0.y);
        af[2] = scale_bf16x2(af[2], s1.x, s1.y);
        af[3] = scale_bf16x2(af[3], s1.x, s1.y);
      }
#pragma unroll
      for (int t = 0; t < kMaxN16; ++t) {
        if (t < n16) {
          uint32_t bf[4];
          const int n = n0 + 16 * t;
          if constexpr (kBTrans)
            ldmatrix_x4(bf, b + (n + (q >> 1) * 8 + r8) * ldb + k + (q & 1) * 8);
          else
            ldmatrix_x4_trans(bf, b + (k + (q & 1) * 8 + r8) * ldb + n + (q >> 1) * 8);
          mma_bf16(acc[2 * t], af, bf[0], bf[1]);
          mma_bf16(acc[2 * t + 1], af, bf[2], bf[3]);
        }
      }
    }
  } else {
    for (int k = k0; k < k1; k += 16) {
      float av[2][16];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + gid + 8 * r;
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          float v = to_f(kATrans ? a[(k + kk) * lda + m] : a[m * lda + k + kk]);
          if (a_kscale != nullptr) v *= a_kscale[k + kk];
          av[r][kk] = v;
        }
      }
#pragma unroll
      for (int t = 0; t < 2 * kMaxN16; ++t) {
        if (t < 2 * n16) {
          const int n = n0 + 8 * t + 2 * tig;
#pragma unroll
          for (int kk = 0; kk < 16; ++kk) {
            const float b0 = to_f(kBTrans ? b[n * ldb + k + kk] : b[(k + kk) * ldb + n]);
            const float b1 =
                to_f(kBTrans ? b[(n + 1) * ldb + k + kk] : b[(k + kk) * ldb + n + 1]);
            acc[t][0] = fmaf(av[0][kk], b0, acc[t][0]);
            acc[t][1] = fmaf(av[0][kk], b1, acc[t][1]);
            acc[t][2] = fmaf(av[1][kk], b0, acc[t][2]);
            acc[t][3] = fmaf(av[1][kk], b1, acc[t][3]);
          }
        }
      }
    }
  }
}

// dt of the chunk's rows 4 lane .. 4 lane + 3 for one head (a warp's
// lanes; rows >= qv are 0: the padding), loaded ahead of its scan.
__device__ __forceinline__ void load_dt(float (&d)[4], const float* dtp, int64_t dt_ss,
                                        int qv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    d[i] = t < qv ? dtp[t * dt_ss] : 0.0f;
  }
}

// One warp's scan of the chunk's dt * a (lane l holds rows 4l..4l+3):
// cum (inclusive), dt, tail * dt = exp(cum_last - cum) dt and the chunk's
// decay exp(cum_last) into shared memory.
__device__ __forceinline__ void scan_dt(const float (&d)[4], float a, int qp, float* f) {
  float* cum = f;
  float* dts = f + kMaxQ;
  float* fs = f + 2 * kMaxQ;
  const int lane = threadIdx.x & 31;
  float c[4], run = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += d[i] * a;
    c[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    if (t < qp) {
      const float ct = excl + c[i];
      cum[t] = ct;
      dts[t] = d[i];
      fs[t] = expf(total - ct) * d[i];
    }
  }
  if (lane == 0) f[3 * kMaxQ] = expf(total);
}

// The chunk's own state s[p][n] = sum_k x[k][p] (tail_k dt_k) B[k][n] for the
// staged head, into dst ([P][N] f32, row stride N): warp w takes rows
// 16 (w % (P/16)) and a run of n16 column tiles.
template <typename T>
__device__ __forceinline__ void chunk_state(const T* xs, int ldp, const T* bs, int ldn,
                                            const float* fs, int qp, int P, int N,
                                            float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int warps_m = P / 16, warps_n = kWarps / warps_m, n16 = N / 16;
  const int per = (n16 + warps_n - 1) / warps_n;
  const int wm = warp % warps_m, wn = warp / warps_m;
  const int cnt = min(per, n16 - wn * per);
  if (wn >= warps_n || cnt <= 0) return;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int p0 = 16 * wm, n0 = 16 * wn * per;
  gemm_ss<T, true, false, 4>(acc, xs, ldp, p0, fs, bs, ldn, n0, cnt, 0, qp);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < 2 * cnt) {
      const int n = n0 + 8 * j + 2 * tig;
      store2(dst + (p0 + gid) * N + n, acc[j][0], acc[j][1]);
      store2(dst + (p0 + gid + 8) * N + n, acc[j][2], acc[j][3]);
    }
  }
}

// Stage A: the chunk states and decays of the group's heads.  The next
// head's x and dt are loaded while this head's state is formed.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_state_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> L(p.QP, p.P, p.N, false);
  float* f = reinterpret_cast<float*>(smem + L.f_off);
  T* bs = reinterpret_cast<T*>(smem + L.b_off);
  T* xbuf[2] = {reinterpret_cast<T*>(smem + L.x_off), reinterpret_cast<T*>(smem + L.x2_off)};
  const int c = blockIdx.x, b = blockIdx.z;
  const int t0 = c * p.Q, qv = min(p.Q, p.S - t0);
  int h_hi, g;
  const int h_lo = head_block(p, blockIdx.y, h_hi, g);
  const T* xc = p.x + b * p.x_sb + t0 * p.x_ss;
  const float* dtc = p.dt + b * p.dt_sb + t0 * p.dt_ss;
  float d[4];
  stage_rows(bs, L.ldn, p.bm + b * p.b_sb + t0 * p.b_ss + g * p.b_sg, p.b_ss, qv, p.QP, p.N);
  stage_rows(xbuf[0], L.ldp, xc + h_lo * p.x_sh, p.x_ss, qv, p.QP, p.P);
  cp_async_commit();
  if (threadIdx.x < 32) load_dt(d, dtc + h_lo * p.dt_sh, p.dt_ss, qv);
  for (int h = h_lo; h < h_hi; ++h) {
    const int i = h - h_lo;
    const bool next = h + 1 < h_hi;
    if (next) {
      stage_rows(xbuf[(i + 1) & 1], L.ldp, xc + (h + 1) * p.x_sh, p.x_ss, qv, p.QP, p.P);
      cp_async_commit();
    }
    if (threadIdx.x < 32) {
      scan_dt(d, p.a[h], p.QP, f);
      if (next) load_dt(d, dtc + (h + 1) * p.dt_sh, p.dt_ss, qv);
    }
    if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int64_t bhc = ((int64_t)b * p.H + h) * p.nc + c;
    chunk_state(xbuf[i & 1], L.ldp, bs, L.ldn, f + 2 * kMaxQ, p.QP, p.P, p.N,
                p.sc + bhc * p.P * p.N);
    if (threadIdx.x == 0) p.decay[bhc] = f[3 * kMaxQ];
    __syncthreads();  // this head's x and scan are read; both are rewritten next
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = pack_bf16(v.x, v.y);
  u.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage B: h_in[c] = h; h = decay_c h + s_c over the chunks in order, four
// state elements a thread.  In f32 hin is sc (each element is read before
// the same thread overwrites it).
template <typename T>
__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(Params<T> p) {
  const int pn = p.P * p.N;
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= pn) return;
  const int64_t bh = (int64_t)blockIdx.z * p.H + blockIdx.y;
  const float* sc = p.sc + bh * p.nc * pn + e;
  T* hin = p.hin + bh * p.nc * pn + e;
  const float* dec = p.decay + bh * p.nc;
  float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < p.nc; c0 += kPassAhead) {
    float4 s[kPassAhead];
    float d[kPassAhead];
#pragma unroll
    for (int i = 0; i < kPassAhead; ++i) {
      if (c0 + i < p.nc) {
        s[i] = *reinterpret_cast<const float4*>(sc + (int64_t)(c0 + i) * pn);
        d[i] = dec[c0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassAhead; ++i) {
      if (c0 + i < p.nc) {
        store4(hin + (int64_t)(c0 + i) * pn, h);
        h.x = fmaf(d[i], h.x, s[i].x);
        h.y = fmaf(d[i], h.y, s[i].y);
        h.z = fmaf(d[i], h.z, s[i].z);
        h.w = fmaf(d[i], h.w, s[i].w);
      }
    }
  }
  store4(p.state + bh * pn + e, h);
}

// Stage C (and, with kSingle, the whole scan of a one-chunk sequence).
// Past the first head the next head's x, h_in and dt are loaded while this
// head's y is formed (not with kSingle, whose chunk states read B).
template <typename T, bool kSingle>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kBlocksPerSm) ssd_chunk_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> L(p.QP, p.P, p.N, true);
  float* f = reinterpret_cast<float*>(smem + L.f_off);
  const float* cum = f;
  const float* dts = f + kMaxQ;
  T* bs = reinterpret_cast<T*>(smem + L.b_off);
  T* cs = reinterpret_cast<T*>(smem + L.c_off);
  T* xbuf[2] = {reinterpret_cast<T*>(smem + L.x_off), reinterpret_cast<T*>(smem + L.x2_off)};
  T* hbuf[2] = {reinterpret_cast<T*>(smem + L.h_off), reinterpret_cast<T*>(smem + L.h2_off)};
  const int c = blockIdx.x, b = blockIdx.z;
  const int t0 = c * p.Q, qv = min(p.Q, p.S - t0);
  int h_hi, g;
  const int h_lo = head_block(p, blockIdx.y, h_hi, g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool rows = 16 * warp < p.QP;  // this warp owns query rows 16 warp .. +16
  const int r0 = 16 * warp + gid, r1 = r0 + 8;
  const bool inter = !kSingle && c > 0;  // h_in is zero before the first chunk
  const T* xc = p.x + b * p.x_sb + t0 * p.x_ss;
  const float* dtc = p.dt + b * p.dt_sb + t0 * p.dt_ss;
  const int64_t pn = (int64_t)p.P * p.N;
  const T* hinc = p.hin + (((int64_t)b * p.H) * p.nc + c) * pn;  // + h * nc * pn
  float d[4];

  stage_rows(bs, L.ldn, p.bm + b * p.b_sb + t0 * p.b_ss + g * p.b_sg, p.b_ss, qv, p.QP, p.N);
  stage_rows(cs, L.ldn, p.cm + b * p.c_sb + t0 * p.c_ss + g * p.c_sg, p.c_ss, qv, p.QP, p.N);
  stage_rows(xbuf[0], L.ldp, xc + h_lo * p.x_sh, p.x_ss, qv, p.QP, p.P);
  if (inter) stage_rows(hbuf[0], L.ldn, hinc + h_lo * p.nc * pn, p.N, p.P, p.P, p.N);
  cp_async_commit();
  if (threadIdx.x < 32) load_dt(d, dtc + h_lo * p.dt_sh, p.dt_ss, qv);
  cp_async_wait<0>();
  __syncthreads();

  // C B^T for this warp's rows, key tiles 0 .. warp (the causal half).
  float cb[2 * kWarps][4];
#pragma unroll
  for (int j = 0; j < 2 * kWarps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[j][e] = 0.0f;
  if (rows) gemm_ss<T, false, true, kWarps>(cb, cs, L.ldn, 16 * warp, nullptr, bs, L.ldn, 0,
                                           warp + 1, 0, p.N);

  if (!kSingle) __syncthreads();  // B is read: its region takes the second buffers

  for (int h = h_lo; h < h_hi; ++h) {
    const int i = h - h_lo;
    const bool next = !kSingle && h + 1 < h_hi;
    const T* xs = xbuf[kSingle ? 0 : i & 1];
    const T* hs = hbuf[i & 1];
    if (next) {
      stage_rows(xbuf[(i + 1) & 1], L.ldp, xc + (h + 1) * p.x_sh, p.x_ss, qv, p.QP, p.P);
      if (inter)
        stage_rows(hbuf[(i + 1) & 1], L.ldn, hinc + (h + 1) * p.nc * pn, p.N, p.P, p.P, p.N);
      cp_async_commit();
    } else if (kSingle && i > 0) {
      stage_rows(xbuf[0], L.ldp, xc + h * p.x_sh, p.x_ss, qv, p.QP, p.P);
      cp_async_commit();
      if (threadIdx.x < 32) load_dt(d, dtc + h * p.dt_sh, p.dt_ss, qv);
    }
    if (threadIdx.x < 32) {
      scan_dt(d, p.a[h], p.QP, f);
      if (next) load_dt(d, dtc + (h + 1) * p.dt_sh, p.dt_ss, qv);
    }
    if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    if (rows) {
      float acc[kMaxP / 8][4];
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      const float c0 = cum[r0], c1 = cum[r1];
      if (inter) {  // exp(cum_q) * C_q . h_in
        gemm_ss<T, false, true, kMaxP / 16>(acc, cs, L.ldn, 16 * warp, nullptr, hs, L.ldn, 0,
                                            p.P / 16, 0, p.N);
        const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
        for (int j = 0; j < kMaxP / 8; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
      // + W' @ x over key tiles 0 .. warp.
#pragma unroll
      for (int kt = 0; kt < kWarps; ++kt) {
        if (kt <= warp) {
          float wv[2][4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int k = 16 * kt + 8 * jj + 2 * tig;
            const float ck0 = cum[k], ck1 = cum[k + 1], d0 = dts[k], d1 = dts[k + 1];
            const float* s = cb[2 * kt + jj];
            wv[jj][0] = k <= r0 ? s[0] * expf(c0 - ck0) * d0 : 0.0f;
            wv[jj][1] = k + 1 <= r0 ? s[1] * expf(c0 - ck1) * d1 : 0.0f;
            wv[jj][2] = k <= r1 ? s[2] * expf(c1 - ck0) * d0 : 0.0f;
            wv[jj][3] = k + 1 <= r1 ? s[3] * expf(c1 - ck1) * d1 : 0.0f;
          }
          if constexpr (Cfg<T>::kMma) {
            uint32_t af[4] = {pack_bf16(wv[0][0], wv[0][1]), pack_bf16(wv[0][2], wv[0][3]),
                              pack_bf16(wv[1][0], wv[1][1]), pack_bf16(wv[1][2], wv[1][3])};
            const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
            for (int t = 0; t < kMaxP / 16; ++t) {
              if (t < p.P / 16) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, xs + (16 * kt + (q & 1) * 8 + r8) * L.ldp + 16 * t +
                                          (q >> 1) * 8);
                mma_bf16(acc[2 * t], af, bf[0], bf[1]);
                mma_bf16(acc[2 * t + 1], af, bf[2], bf[3]);
              }
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < 16; ++kk) {
              const int src = (lane & ~3) | ((kk & 7) >> 1);
              const float w0 = __shfl_sync(0xffffffffu, wv[kk >> 3][kk & 1], src);
              const float w1 = __shfl_sync(0xffffffffu, wv[kk >> 3][2 + (kk & 1)], src);
              const T* xr = xs + (16 * kt + kk) * L.ldp + 2 * tig;
#pragma unroll
              for (int j = 0; j < kMaxP / 8; ++j) {
                if (j < p.P / 8) {
                  const float x0 = to_f(xr[8 * j]), x1 = to_f(xr[8 * j + 1]);
                  acc[j][0] = fmaf(w0, x0, acc[j][0]);
                  acc[j][1] = fmaf(w0, x1, acc[j][1]);
                  acc[j][2] = fmaf(w1, x0, acc[j][2]);
                  acc[j][3] = fmaf(w1, x1, acc[j][3]);
                }
              }
            }
          }
        }
      }
      T* yb = p.y + (((int64_t)b * p.S + t0) * p.H + h) * p.P + 2 * tig;
      const int64_t y_ss = (int64_t)p.H * p.P;
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j) {
        if (j < p.P / 8) {
          if (r0 < qv) store2(yb + r0 * y_ss + 8 * j, acc[j][0], acc[j][1]);
          if (r1 < qv) store2(yb + r1 * y_ss + 8 * j, acc[j][2], acc[j][3]);
        }
      }
    }
    if constexpr (kSingle)  // one chunk: its state is the final state
      chunk_state(xs, L.ldp, bs, L.ldn, f + 2 * kMaxQ, p.QP, p.P, p.N,
                  p.state + ((int64_t)b * p.H + h) * pn);
    __syncthreads();  // this head's buffers and scan are read; they are rewritten next
  }
}

template <typename T>
int smem_bytes(bool chunk_kernel, int qp, int pd, int n) {
  return Smem<T>(qp, pd, n, chunk_kernel).bytes;
}

// Once per device and instantiation: allow the largest shared-memory use
// (at Q = 128, P = 64, N = 128) and prefer shared memory over L1.
template <typename T>
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const int a_bytes = smem_bytes<T>(false, kMaxQ, kMaxP, kMaxN);
  const int c_bytes = smem_bytes<T>(true, kMaxQ, kMaxP, kMaxN);
  const void* fns[3] = {reinterpret_cast<const void*>(ssd_state_kernel<T>),
                        reinterpret_cast<const void*>(ssd_chunk_kernel<T, false>),
                        reinterpret_cast<const void*>(ssd_chunk_kernel<T, true>)};
  for (int i = 0; i < 3; ++i) {
    err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               i == 0 ? a_bytes : c_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fns[i], cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

// Scratch bytes of a multi-chunk call: s_c and the decays in f32, then (bf16
// only) h_in in bf16; the launch refuses less.
template <typename T>
int64_t scratch_bytes(int batch, int H, int P, int N, int nc) {
  if (nc <= 1) return 0;
  const int64_t states = (int64_t)batch * H * nc * P * N;
  const int64_t decays = ((int64_t)batch * H * nc + 3) / 4 * 4;
  return 4 * (states + decays) + (sizeof(T) == 4 ? 0 : 2 * states);
}

template <typename T>
cudaError_t launch(Params<T> p, int batch, void* scratch, int64_t scratch_size,
                   cudaStream_t stream) {
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  const int groups = (p.H / p.hpg) * p.gb;  // grid rows: head blocks of every group
  const int c_bytes = smem_bytes<T>(true, p.QP, p.P, p.N);
  if (p.nc == 1) {
    ssd_chunk_kernel<T, true><<<dim3(1, groups, batch), kThreads, c_bytes, stream>>>(p);
    return cudaGetLastError();
  }
  if (scratch == nullptr || scratch_size < scratch_bytes<T>(batch, p.H, p.P, p.N, p.nc))
    return cudaErrorInvalidValue;
  const int64_t states = (int64_t)batch * p.H * p.nc * p.P * p.N;
  p.sc = static_cast<float*>(scratch);
  p.decay = p.sc + states;
  p.hin = sizeof(T) == 4 ? reinterpret_cast<T*>(p.sc)
                         : reinterpret_cast<T*>(p.decay + ((int64_t)batch * p.H * p.nc + 3) / 4 * 4);
  ssd_state_kernel<T><<<dim3(p.nc, groups, batch), kThreads,
                        smem_bytes<T>(false, p.QP, p.P, p.N), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pass_blocks = (p.P * p.N / 4 + kPassThreads - 1) / kPassThreads;
  ssd_pass_kernel<T><<<dim3(pass_blocks, p.H, batch), kPassThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T, false><<<dim3(p.nc, groups, batch), kThreads, c_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_typed(const void* x, const void* dt, const void* bm, const void* cm, const void* a,
                 void* y, void* state, void* scratch, int64_t scratch_size, int batch, int S,
                 int H, int P, int N, int Q, int hpb, int G, int64_t x_sb, int64_t x_ss,
                 int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb,
                 int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg,
                 cudaStream_t stream) {
  const int hpg = H / G;
  Params<T> p{static_cast<const T*>(x), static_cast<const float*>(dt),
              static_cast<const T*>(bm), static_cast<const T*>(cm),
              static_cast<const float*>(a), static_cast<T*>(y),
              static_cast<float*>(state), nullptr, nullptr, nullptr,
              x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
              S, H, P, N, Q, (Q + 15) / 16 * 16, (S + Q - 1) / Q, hpb, hpg,
              (hpg + hpb - 1) / hpb};
  return static_cast<int>(launch<T>(p, batch, scratch, scratch_size, stream));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and a are float32.
// Strides are in elements: x (batch, step, head) with P contiguous, dt
// (batch, step, head), B and C (batch, step, group) with N contiguous.  y
// is a contiguous [B, S, H, P] tensor, state a contiguous [B, H, P, N] f32
// one.  G divides H; heads h of group h / (H / G) read that group's B and
// C.  hpb is the number of heads (of one group) a block of Stages A and C
// takes.  scratch
// holds at least scratch_bytes() when S > Q (else it may be null):
// kernels/ssd_scan.py::launch_plan sizes it.
// Launches 1 kernel when S <= Q, else 3, on stream; returns the
// cudaError_t of the launches.
int ssd_scan_launch(const void* x, const void* dt, const void* bm, const void* cm,
                    const void* a, void* y, void* state, void* scratch,
                    int64_t scratch_size, int batch, int S, int H, int P, int N, int Q,
                    int dtype, int hpb, int G, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                    int64_t dt_sb, int64_t dt_ss, int64_t dt_sh, int64_t b_sb, int64_t b_ss,
                    int64_t b_sg, int64_t c_sb, int64_t c_ss, int64_t c_sg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > kMaxQ || P < 16 || P > kMaxP || P % 16 || N < 16 || N > kMaxN ||
      N % 16 || S < 1 || batch < 1 || H < 1 || G < 1 || H % G || hpb < 1 || hpb > H / G)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_typed<float>(x, dt, bm, cm, a, y, state, scratch, scratch_size, batch, S, H,
                               P, N, Q, hpb, G, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb,
                               b_ss, b_sg, c_sb, c_ss, c_sg, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, dt, bm, cm, a, y, state, scratch, scratch_size,
                                       batch, S, H, P, N, Q, hpb, G, x_sb, x_ss, x_sh, dt_sb,
                                       dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, st);
  return cudaErrorInvalidValue;
}

// Resident blocks a SM of Stage A (which = 0) or Stage C (which = 1) at the
// mamba2 shape (Q = 128, P = 64, N = 128); negative: -cudaError_t.
int ssd_scan_blocks_per_sm(int dtype, int which) {
  int n = 0;
  cudaError_t err = dtype == 0 ? configure<float>() : configure<__nv_bfloat16>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const bool c = which != 0;
  const void* fn;
  int bytes;
  if (dtype == 0) {
    fn = c ? reinterpret_cast<const void*>(ssd_chunk_kernel<float, false>)
           : reinterpret_cast<const void*>(ssd_state_kernel<float>);
    bytes = smem_bytes<float>(c, kMaxQ, kMaxP, kMaxN);
  } else {
    fn = c ? reinterpret_cast<const void*>(ssd_chunk_kernel<__nv_bfloat16, false>)
           : reinterpret_cast<const void*>(ssd_state_kernel<__nv_bfloat16>);
    bytes = smem_bytes<__nv_bfloat16>(c, kMaxQ, kMaxP, kMaxN);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
