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
// So the design is about keeping enough loads in flight on every SM.
//
// Design.  The TPU grid (B, Hkv, S/block_s) walks S in order and carries
// (m, l, acc) in VMEM between grid steps.  Here:
//   * Split-KV.  The grid is (Hkv x G-chunks of 8, B, n_split).  Block z
//     takes the z-th of n_split equal parts (rounded up to whole 64-position
//     tiles) of its row's walked range [begin, end): the valid range
//     [max(0, len-window), min(len, S)), or all of [0, S) when nothing is
//     valid.  n_split is chosen on the host from S, B*Hkv*G-chunks, the SM
//     count and this kernel's blocks per SM (decode_attention_blocks_per_sm),
//     never from the device-side lengths: as many splits as fill one wave
//     of resident blocks (two a SM in bf16), but none shorter than 2048
//     positions, since each split pays its ring fill, its warps' merge and
//     a share of the combine; so the serve shape (S <= 96) runs n_split = 1,
//     and B = 1 at S = 32768 runs 16 splits.  A short row's splits end at
//     once.
//   * Partials and combine.  At n_split = 1 the block writes the output.
//     Otherwise it writes its (m, l, acc[G, Dh]) in f32 to scratch that the
//     wrapper allocates, and a second small kernel (decode_combine_kernel)
//     merges the splits with the usual rescaling.  An empty split writes
//     m = -inf, l = 0 and is skipped by the combine (merging it would give
//     exp(-inf - -inf) = NaN); a split of a nothing-valid row has
//     m = NEG_INF, finite, l > 0, and is kept.
//   * Staging.  K and V tiles of 64 positions go through a ring of
//     shared-memory stages (3 for bf16, 2 for f32) filled by 16-byte
//     cp.async copies (zero-filled past the block's range), so the next
//     tiles' loads are in flight while the current one is computed; rows
//     are padded by 16 bytes so that the fragment loads hit distinct banks.
//   * Products.  Each of the 4 warps takes 16 positions of a tile and keeps
//     its own online softmax (m, l) and accumulator; the warps are merged
//     once, at the end.  In bf16 both products run on tensor cores with
//     mma.sync.m16n8k16 (bf16 in, f32 out): scores S^T = K . Q^T with the
//     16 positions as M, the G query rows (padded to 8) as N and Dh as the
//     depth (K by ldmatrix, Q held in registers, unscaled; the f32 scores
//     are scaled after), then out^T = V^T . P^T with Dh as M (V by
//     ldmatrix.trans) and the 16 positions as the depth.  P is rounded to
//     bf16 as the operand of that product (l sums the f32 P); that rounding
//     is the only one beyond the reference's.  In f32 the same fragments are
//     computed on the CUDA cores in full f32 (no TF32), with q pre-scaled
//     as the reference does.
// Only positions in the walked range are visited: a skipped masked score
// contributes exp(NEG_INF - m) = 0 exactly.  K/V rows are addressed by
// strides, so the model-layout cache [B, S, Hkv, Dh] is read in place.
// Instantiated for Dh = 32, 64, 80, 128 and 160 (the smoke configs' 32; the
// full widths' 64, 128, h2o-danube's 80 and stablelm's 160); Smem's
// static_asserts hold each one to the tiling.  Every loop over Dh steps by
// one 16-wide tile (kMt = 5 at Dh 80, 10 at 160) or by 4 f32 lanes, so an
// odd tile count needs nothing more.  Shared memory a block (ring + q + P):
// Dh 80 bf16 69,120 B, f32 91,264 B; Dh 160 bf16 130,560 B, f32 175,744 B,
// so Dh 160 runs one block an SM in both types (as f32 Dh 128 does), and
// the host's split plan reads that through decode_attention_blocks_per_sm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 16;              // positions per warp per tile (the mma M)
constexpr int kTile = kWarps * kWarpRows;  // 64 positions per stage
constexpr int kGChunk = 8;                 // query rows per block (the mma N)
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -2.3819763e38f;  // the reference's NEG_INF

template <typename T>
struct Cfg;

template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kStages = 3;
  static constexpr int kPad = 8;     // elements: 16 bytes a row
  static constexpr int kPPad = 8;    // P rows of 16 + 8 bf16
  static constexpr bool kMma = true;
};

template <>
struct Cfg<float> {
  static constexpr int kStages = 2;
  static constexpr int kPad = 4;
  static constexpr int kPPad = 4;
  static constexpr bool kMma = false;
};

template <typename T, int DH>
struct Smem {
  static constexpr int kLd = DH + Cfg<T>::kPad;          // K/V row stride (elements)
  static constexpr int kLdQ = DH + 4;                     // f32 q rows
  static constexpr int kLdP = kWarpRows + Cfg<T>::kPPad;  // P rows
  static constexpr int kLdAcc = DH + 4;                   // merge rows (f32)
  static constexpr size_t kStageBytes = size_t(2) * kTile * kLd * sizeof(T);
  static constexpr size_t kRingBytes = Cfg<T>::kStages * kStageBytes;
  static constexpr size_t kQBytes = Cfg<T>::kMma ? 0 : size_t(kGChunk) * kLdQ * 4;
  static constexpr size_t kPBytes = size_t(kWarps) * kGChunk * kLdP * sizeof(T);
  static constexpr size_t kMergeBytes = size_t(kWarps) * kGChunk * (kLdAcc + 2) * 4;
  static_assert(DH % 16 == 0, "whole 16-wide Dh tiles of the mma");
  static_assert(kMergeBytes <= kRingBytes, "the merge area reuses the ring");
  static_assert(kTile * (DH * sizeof(T) / 16) % kThreads == 0, "whole copies a thread");
  static constexpr size_t kBytes = kRingBytes + kQBytes + kPBytes;
};

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The walked range of a row: the valid positions, or all S when none is.
__device__ __forceinline__ void walked_range(int length, int window, int s_len, int& lo,
                                             int& hi, int& begin, int& end) {
  lo = max(0, length - window);
  hi = min(length, s_len);
  begin = lo < hi ? lo : 0;
  end = lo < hi ? hi : s_len;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,            // [B, Hkv, G, DH] contiguous
    const T* __restrict__ k,            // rows of DH contiguous elements, strided
    const T* __restrict__ v,
    const int* __restrict__ lengths,    // [B]
    T* __restrict__ out,                // [B, Hkv, G, DH] contiguous (n_split == 1)
    float* __restrict__ part,           // partials (n_split > 1), see below
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int hkv, int g_total, int s_len, int n_split, float scale, int window,
    float softcap) {
  using Sm = Smem<T, DH>;
  constexpr int kStages = Cfg<T>::kStages;
  constexpr int kLd = Sm::kLd;
  constexpr int kChunksPerRow = DH * int(sizeof(T)) / 16;
  constexpr int kElemsPerChunk = 16 / int(sizeof(T));
  constexpr int kMt = DH / 16;  // 16-wide Dh tiles

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + Sm::kRingBytes);
  T* p_s = reinterpret_cast<T*>(smem + Sm::kRingBytes + Sm::kQBytes);

  const int gchunks = (g_total + kGChunk - 1) / kGChunk;
  const int h = blockIdx.x / gchunks;
  const int g0 = (blockIdx.x % gchunks) * kGChunk;
  const int b = blockIdx.y, z = blockIdx.z;
  const int gn = min(kGChunk, g_total - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int64_t bh = (int64_t)b * hkv + h;
  const T* qb = q + (bh * g_total + g0) * DH;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  int lo, hi, begin, end;
  walked_range(lengths[b], window, s_len, lo, hi, begin, end);
  int chunk = (end - begin + n_split - 1) / n_split;
  chunk = (chunk + kTile - 1) / kTile * kTile;
  const int blk_begin = min(end, begin + z * chunk);
  const int blk_end = min(end, blk_begin + chunk);
  // Partials: m, l [B, Hkv, n_split, G] then acc [B, Hkv, n_split, G, DH].
  const int64_t part_row = (bh * n_split + z) * g_total + g0;
  const int64_t n_rows = (int64_t)gridDim.y * hkv * n_split * g_total;
  float* part_m = part + part_row;
  float* part_l = part + n_rows + part_row;
  float* part_acc = part + 2 * n_rows + part_row * DH;

  if (blk_begin >= blk_end) {  // an empty split (n_split > 1 only)
    if (tid < gn) {
      part_m[tid] = -INFINITY;
      part_l[tid] = 0.f;
    }
    return;
  }

  // Query fragments.  bf16: the B operand of the score mma, unscaled,
  // b0 = Q[gid][16kk + 2tig, +1], b1 = Q[gid][16kk + 2tig + 8, +9].
  // f32: q * scale rows in shared memory.
  uint32_t qf[Cfg<T>::kMma ? kMt : 1][2];
  if constexpr (Cfg<T>::kMma) {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(qb + gid * DH);
#pragma unroll
    for (int kk = 0; kk < kMt; ++kk) {
      qf[kk][0] = gid < gn ? qrow[(16 * kk + 2 * tig) / 2] : 0u;
      qf[kk][1] = gid < gn ? qrow[(16 * kk + 2 * tig + 8) / 2] : 0u;
    }
  } else {
    for (int i = tid; i < kGChunk * DH; i += kThreads) {
      const int g = i / DH, d = i % DH;
      q_s[g * Sm::kLdQ + d] = g < gn ? to_f(qb[g * DH + d]) * scale : 0.f;
    }
  }

  auto load_tile = [&](int t, int stage) {
    T* ks = ring + (size_t)stage * 2 * kTile * kLd;
    T* vs = ks + kTile * kLd;
    const int t0 = blk_begin + t * kTile;
#pragma unroll
    for (int it = 0; it < kTile * kChunksPerRow / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunksPerRow, c = i % kChunksPerRow;
      const int pos = t0 + r;
      const bool in = pos < blk_end;
      const int64_t row = in ? pos : blk_begin;
      cp_async16(ks + r * kLd + c * kElemsPerChunk, kb + row * k_ss + c * kElemsPerChunk,
                 in ? 16 : 0);
      cp_async16(vs + r * kLd + c * kElemsPerChunk, vb + row * v_ss + c * kElemsPerChunk,
                 in ? 16 : 0);
    }
  };

  const int n_tiles = (blk_end - blk_begin + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // Per-thread state in the mma C layout: scores c[0..3] are positions
  // (gid, gid, gid+8, gid+8) x query rows (2tig, 2tig+1, 2tig, 2tig+1);
  // acc[mt][0..3] are Dh rows (16mt+gid, 16mt+gid, 16mt+gid+8, ...) x the
  // same query rows.  m, l are this warp's, per query row 2tig + j.
  float acc[kMt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  T* pw = p_s + warp * kGChunk * Sm::kLdP;  // this warp's P [G=8][16]

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const T* ks = ring + (size_t)(t % kStages) * 2 * kTile * kLd + warp * kWarpRows * kLd;
    const T* vs = ks + kTile * kLd;
    const int p0 = blk_begin + t * kTile + warp * kWarpRows;  // this warp's first position

    // 1. scores
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (Cfg<T>::kMma) {
#pragma unroll
      for (int kk = 0; kk < kMt; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, ks + (lane % 16) * kLd + 16 * kk + (lane / 16) * 8);
        mma_bf16(c, a, qf[kk][0], qf[kk][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] *= scale;
    } else {
      const float* k0 = reinterpret_cast<const float*>(ks) + gid * kLd;
      const float* k1 = k0 + 8 * kLd;
      const float* qa = q_s + (2 * tig) * Sm::kLdQ;
      const float* qc = qa + Sm::kLdQ;
#pragma unroll 8
      for (int d = 0; d < DH; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(k0 + d);
        const float4 x1 = *reinterpret_cast<const float4*>(k1 + d);
        const float4 ya = *reinterpret_cast<const float4*>(qa + d);
        const float4 yc = *reinterpret_cast<const float4*>(qc + d);
        c[0] += ya.x * x0.x + ya.y * x0.y + ya.z * x0.z + ya.w * x0.w;
        c[1] += yc.x * x0.x + yc.y * x0.y + yc.z * x0.z + yc.w * x0.w;
        c[2] += ya.x * x1.x + ya.y * x1.y + ya.z * x1.z + ya.w * x1.w;
        c[3] += yc.x * x1.x + yc.y * x1.y + yc.z * x1.z + yc.w * x1.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = p0 + gid + (i / 2) * 8;
      float s = c[i];
      if (pos >= blk_end) {
        s = -INFINITY;  // past the block's range: no weight at all
      } else if (pos < lo || pos >= hi) {
        s = kNegInf;
      } else if (softcap > 0.f) {
        s = softcap * tanhf(s / softcap);
      }
      c[i] = s;
    }

    // 2. this warp's online softmax: query row 2tig + j, positions gid and
    //    gid + 8 in this thread, the rest across the lanes of equal tig.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = fmaxf(c[j], c[j + 2]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[j], mx);
      const float e0 = expf(c[j] - m_new), e1 = expf(c[j + 2] - m_new);
      float sum = e0 + e1;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * alpha + sum;
      m_run[j] = m_new;
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        acc[mt][j] *= alpha;
        acc[mt][j + 2] *= alpha;
      }
      T* prow = pw + (2 * tig + j) * Sm::kLdP;
      if constexpr (Cfg<T>::kMma) {
        prow[gid] = __float2bfloat16(e0);
        prow[gid + 8] = __float2bfloat16(e1);
      } else {
        prow[gid] = e0;
        prow[gid + 8] = e1;
      }
    }
    __syncwarp();

    // 3. acc += V^T . P^T over this warp's 16 positions
    if constexpr (Cfg<T>::kMma) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pw + gid * Sm::kLdP + 2 * tig);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(pw + gid * Sm::kLdP + 2 * tig + 8);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vs + ((lane / 16) * 8 + lane % 8) * kLd + 16 * mt +
                                 ((lane / 8) % 2) * 8);
        mma_bf16(acc[mt], a, b0, b1);
      }
    } else {
      const float* pa = reinterpret_cast<const float*>(pw) + (2 * tig) * Sm::kLdP;
      const float* pc = pa + Sm::kLdP;
      const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll 4
      for (int r = 0; r < kWarpRows; ++r) {
        const float wa = pa[r], wc = pc[r];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          const float v0 = vf[r * kLd + 16 * mt + gid];
          const float v1 = vf[r * kLd + 16 * mt + gid + 8];
          acc[mt][0] += wa * v0;
          acc[mt][1] += wc * v0;
          acc[mt][2] += wa * v1;
          acc[mt][3] += wc * v1;
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it to merge

  // 4. merge the four warps: m, l [warp][g], acc [warp][g][DH] in f32.
  float* mrg = reinterpret_cast<float*>(smem);
  float* mrg_m = mrg;
  float* mrg_l = mrg + kWarps * kGChunk;
  float* mrg_acc = mrg + 2 * kWarps * kGChunk;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = 2 * tig + j;
    if (gid == 0) {
      mrg_m[warp * kGChunk + g] = m_run[j];
      mrg_l[warp * kGChunk + g] = l_run[j];
    }
    float* arow = mrg_acc + (warp * kGChunk + g) * Sm::kLdAcc;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      arow[16 * mt + gid] = acc[mt][j];
      arow[16 * mt + gid + 8] = acc[mt][j + 2];
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float m_all = mrg_m[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, mrg_m[w * kGChunk + g]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // A warp that saw no position has m = NEG_INF, l = 0, acc = 0.
      const float wt = expf(mrg_m[w * kGChunk + g] - m_all);
      l_all += wt * mrg_l[w * kGChunk + g];
      a_all += wt * mrg_acc[(w * kGChunk + g) * Sm::kLdAcc + d];
    }
    if (n_split == 1) {
      store(out + (bh * g_total + g0 + g) * DH + d, a_all / fmaxf(l_all, 1e-20f));
    } else {
      part_acc[g * DH + d] = a_all;
      if (d == 0) {
        part_m[g] = m_all;
        part_l[g] = l_all;
      }
    }
  }
}

// Merge the n_split partials of each (b, kv-head, query row): one block a
// row, one thread per d.  Empty splits (l = 0, m = -inf) are skipped.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int n_rows_bh, int g_total,
    int n_split, int dh) {
  const int64_t row = blockIdx.x;  // (b * Hkv + h) * G + g
  const int64_t bh = row / g_total, g = row % g_total;
  const int64_t n_rows = (int64_t)n_rows_bh * n_split * g_total;
  const float* pm = part + bh * n_split * g_total + g;
  const float* pl = pm + n_rows;
  const float* pa = part + 2 * n_rows + (bh * n_split * g_total + g) * dh;
  float m_all = -INFINITY;
  for (int z = 0; z < n_split; ++z)
    if (pl[z * g_total] > 0.f) m_all = fmaxf(m_all, pm[z * g_total]);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float l_all = 0.f, a_all = 0.f;
    for (int z = 0; z < n_split; ++z) {
      const float l = pl[z * g_total];
      if (l > 0.f) {
        const float wt = expf(pm[z * g_total] - m_all);
        l_all += wt * l;
        a_all += wt * pa[(int64_t)z * g_total * dh + d];
      }
    }
    store(out + row * dh + d, a_all / fmaxf(l_all, 1e-20f));
  }
}

// Raise the kernel's dynamic shared-memory limit, once per device.
template <typename T, int DH>
cudaError_t set_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_attention_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<T, DH>::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_attention_kernel<T, DH>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int DH>
int blocks_per_sm() {
  cudaError_t err = set_smem<T, DH>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel<T, DH>, kThreads, Smem<T, DH>::kBytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, void* part, int b, int hkv, int g, int s, int n_split,
                   const int64_t* k_strides, const int64_t* v_strides, float scale,
                   int window, float softcap, cudaStream_t stream) {
  cudaError_t err = set_smem<T, DH>();
  if (err != cudaSuccess) return err;
  const int gchunks = (g + kGChunk - 1) / kGChunk;
  dim3 grid(hkv * gchunks, b, n_split);
  decode_attention_kernel<T, DH><<<grid, kThreads, Smem<T, DH>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(part),
      k_strides[0], k_strides[1], k_strides[2], v_strides[0], v_strides[1], v_strides[2],
      hkv, g, s, n_split, scale, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_combine_kernel<T><<<b * hkv * g, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), b * hkv, g, n_split, DH);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: (batch,
// kv-head, position); the last dimension must be contiguous.  softcap <= 0
// means none.  part: f32 scratch of n_split * B * Hkv * G * (Dh + 2)
// values when n_split > 1 (unused at 1).  Returns the cudaError_t of the
// launches: the split kernel, then the combine kernel when n_split > 1.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* part, int b, int hkv,
                            int g, int s, int dh, int dtype, int n_split,
                            const int64_t* k_strides, const int64_t* v_strides,
                            float scale, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1) return cudaErrorInvalidValue;
#define K1_LAUNCH(T, DH)                                                                \
  return launch<T, DH>(q, k, v, lengths, out, part, b, hkv, g, s, n_split, k_strides,  \
                       v_strides, scale, window, softcap, st)
  if (dtype == 0 && dh == 32) K1_LAUNCH(float, 32);
  if (dtype == 0 && dh == 64) K1_LAUNCH(float, 64);
  if (dtype == 0 && dh == 80) K1_LAUNCH(float, 80);
  if (dtype == 0 && dh == 128) K1_LAUNCH(float, 128);
  if (dtype == 0 && dh == 160) K1_LAUNCH(float, 160);
  if (dtype == 1 && dh == 32) K1_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 1 && dh == 64) K1_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && dh == 80) K1_LAUNCH(__nv_bfloat16, 80);
  if (dtype == 1 && dh == 128) K1_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && dh == 160) K1_LAUNCH(__nv_bfloat16, 160);
#undef K1_LAUNCH
  return cudaErrorInvalidValue;
}

// Resident blocks per SM of the split kernel for (dtype, dh) on the current
// device, or minus a cudaError_t.
int decode_attention_blocks_per_sm(int dh, int dtype) {
  if (dtype == 0 && dh == 32) return blocks_per_sm<float, 32>();
  if (dtype == 0 && dh == 64) return blocks_per_sm<float, 64>();
  if (dtype == 0 && dh == 80) return blocks_per_sm<float, 80>();
  if (dtype == 0 && dh == 128) return blocks_per_sm<float, 128>();
  if (dtype == 0 && dh == 160) return blocks_per_sm<float, 160>();
  if (dtype == 1 && dh == 32) return blocks_per_sm<__nv_bfloat16, 32>();
  if (dtype == 1 && dh == 64) return blocks_per_sm<__nv_bfloat16, 64>();
  if (dtype == 1 && dh == 80) return blocks_per_sm<__nv_bfloat16, 80>();
  if (dtype == 1 && dh == 128) return blocks_per_sm<__nv_bfloat16, 128>();
  if (dtype == 1 && dh == 160) return blocks_per_sm<__nv_bfloat16, 160>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Query rows a block takes: its grid is (Hkv x ceil(G / this), B, n_split).
int decode_attention_g_chunk() { return kGChunk; }

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
