// Flash attention forward (causal / sliding-window GQA) for Hopper (sm_90a).
//
// K3 replaces the TPU kernel src/repro/kernels/flash_attention.py:_fa_kernel
// (launched by _fa_impl).  Same function: the mask keeps key t for query row
// s when t <= s + q_offset (causal) and s + q_offset - t < window
// (window > 0); masked scores are the finite -1e30, not -inf; the running
// max, sum and accumulator are fp32 and the last step divides by l (1 where
// l == 0); query head h reads KV head h / (H / K).  A fully masked row
// averages v over all T keys, exactly as the reference softmax over -1e30
// scores does.
//
// Two kernels behind one entry point:
//
//   fa_tc_kernel (bf16, D in {32, 64, 80, 128}, 16-byte aligned operands):
//     FA2 on the tensor cores.  One CTA of 4 warps takes one (b, h, 64-row
//     query tile); each warp owns 16 query rows.  Q is staged once by
//     cp.async and read as mma A fragments (ldmatrix) tile by tile.  K/V
//     tiles of 64 keys are staged by cp.async.cg 16-byte copies into a
//     two-stage ring, so tile j+1 loads while tile j computes; keys past T
//     are zero-filled (src-size 0) and score -inf.  S = Q K^T and O += P V
//     are mma.sync.m16n8k16 bf16 -> fp32 with operands from ldmatrix (V
//     through .trans) over rows padded by 16 bytes, so the 8 rows of each
//     ldmatrix hit 8 distinct bank groups.  1/sqrt(D) (times log2 e, for
//     exp2) scales the fp32 S accumulator, never bf16 q.  The online softmax
//     (m, l) lives in the accumulator's fragment layout: a row is spread over
//     a quad of lanes, so its max takes two xor-shuffles and its sum is
//     reduced once, at the end.  P is rounded to bf16 in registers and fed
//     as the A operand of P V (the one rounding the fp32 reference does not
//     make; the port's plain attention makes it too).  The epilogue divides
//     by l, rounds once to bf16, stages the warp's rows in its own Q rows
//     and stores 16 bytes a lane.
//   fa_simple_kernel (fp32, and bf16 at any other D <= 256): the first
//     design, all math fp32 on the CUDA cores (TF32 would break the 2e-5
//     fp32 parity): 8 warps x 4 query rows, 32-key tiles staged as fp32,
//     q scaled by 1/sqrt(D) before the product.
//
// Both visit only the key tiles of key_tiles(): a tile is skipped when it
// is masked for every row of the CTA's query tile, and nothing is skipped
// when some row of the tile is masked on all T keys (that row needs every
// key).  Skipping is exact: a visited, fully masked tile contributes
// exp(-1e30 - m) = 0 once a row has a real score.  The Python mirror is
// repro_torch/kernels/flash_attention.py:key_tiles.
//
// What bounds it: at the LM path's shape (B=8, S=T=128, H=32, K=8, D=64)
// one call reads ~6 MB (0.0031 ms at 3.35 TB/s) and does ~0.6 GFLOP of
// causal work, so it is a short kernel set by latency: its 512 CTAs of 128
// threads, each loading its Q and 1-2 K/V tiles, must fill the card in one
// wave, which at 4 CTAs an SM caps a thread at 128 registers (kMinBlocks).
// At long S it is bound by operations.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The entry point returns cudaGetLastError() of its launch.  No atomics:
// two launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;           // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

enum DType : int { kF32 = 0, kBF16 = 1 };

// Key tiles [lo, hi) that the CTA of query rows [q0, q0 + bq) visits.
struct TileRange {
  int64_t lo, hi;
};

__device__ __forceinline__ TileRange key_tiles(int64_t q0, int64_t bq, int64_t S, int64_t T,
                                               int causal, int64_t window, int64_t q_offset,
                                               int64_t bk) {
  const int64_t ntiles = (T + bk - 1) / bk;
  const int64_t p0 = q0 + q_offset;                               // first row's position
  const int64_t p1 = (q0 + bq < S ? q0 + bq : S) - 1 + q_offset;  // last real row's
  // a row with no key: causal before key 0, or its window past key T-1
  if ((causal && p0 < 0) || (window > 0 && p1 - window + 1 > T - 1)) return {0, ntiles};
  const int64_t t_lo = window > 0 && p0 - window + 1 > 0 ? p0 - window + 1 : 0;
  const int64_t t_hi = causal && p1 < T - 1 ? p1 : T - 1;
  return {t_lo / bk, t_hi / bk + 1};
}

__device__ __forceinline__ bool masked(int64_t t, int64_t p, int causal, int64_t window) {
  return (causal && t > p) || (window > 0 && p - t >= window);
}

// ------------------------------------------------------------------ //
// fa_simple_kernel: fp32 math on the CUDA cores
// ------------------------------------------------------------------ //
namespace simple {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

inline size_t smem_bytes(int64_t D) {
  // K tile (kBK x (D+1)), V tile (kBK x D), the CTA's scaled q rows (kBQ x D)
  return sizeof(float) * static_cast<size_t>(kBK * (D + 1) + kBK * D + kBQ * D);
}

// DPL = ceil(D / 32): accumulator columns per lane.  K rows are padded to
// D+1 floats, so the 32 lanes, one key each, hit 32 banks; lane l scores
// key l against the warp's 4 rows, the row max and sum are warp shuffles,
// and P V broadcasts each key's weight by shuffle while lane l accumulates
// columns l, l+32, ...
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
fa_simple_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int64_t S, int64_t H, int64_t Tk, int64_t K, int64_t D,
                 int causal, int64_t window, int64_t q_offset, float scale) {
  extern __shared__ float smem[];
  const int64_t Dp = D + 1;
  float* ks = smem;              // [kBK][D+1]
  float* vs = ks + kBK * Dp;     // [kBK][D]
  float* qs = vs + kBK * D;      // [kBQ][D]

  const int64_t bh = blockIdx.x;  // b * H + h
  const int64_t b = bh / H, h = bh % H;
  const int64_t kvh = h / (H / K);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q_stride = H * D;   // elements between consecutive positions
  const int64_t kv_stride = K * D;
  const T* qb = q + (b * S * H + h) * D;
  const T* kb = k + (b * Tk * K + kvh) * D;
  const T* vb = v + (b * Tk * K + kvh) * D;
  T* ob = o + (b * S * H + h) * D;

  // the CTA's query rows, scaled in fp32 before the product (rows past S: 0)
  for (int64_t i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int64_t r = i / D, d = i - r * D, s = q0 + r;
    qs[i] = s < S ? to_f32(qb[s * q_stride + d]) * scale : 0.0f;
  }

  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[rr][j] = 0.0f;
  }
  const float* qw = qs + static_cast<int64_t>(warp) * kRowsPerWarp * D;

  const TileRange tiles = key_tiles(q0, kBQ, S, Tk, causal, window, q_offset, kBK);
  for (int64_t k0 = tiles.lo * kBK; k0 < tiles.hi * kBK; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (first pass: q staged)
    for (int64_t i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int64_t r = i / D, d = i - r * D, t = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (t < Tk) {
        kx = to_f32(kb[t * kv_stride + d]);
        vx = to_f32(vb[t * kv_stride + d]);
      }
      ks[r * Dp + d] = kx;
      vs[r * D + d] = vx;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    const int64_t t = k0 + lane;
    const float* kr = ks + lane * Dp;
    float sc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] = 0.0f;
    for (int64_t d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) sc[rr] = fmaf(qw[rr * D + d], kd, sc[rr]);
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int64_t qpos = q0 + warp * kRowsPerWarp + rr + q_offset;
      float s = masked(t, qpos, causal, window) ? kNegInf : sc[rr];
      if (t >= Tk) s = -INFINITY;  // past the ragged edge: no key at all
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float alpha = expf(m[rr] - m_new);
      p[rr] = expf(s - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[rr][j] *= alpha;
    }

    // P @ V: key kk's weight comes from lane kk
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float* vr = vs + kk * D;
      float vd[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int64_t d = lane + 32 * j;
        vd[j] = d < D ? vr[d] : 0.0f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pk = __shfl_sync(kFull, p[rr], kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[rr][j] = fmaf(pk, vd[j], acc[rr][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int64_t s = q0 + warp * kRowsPerWarp + rr;
    if (s >= S) continue;
    const float inv = l[rr] == 0.0f ? 1.0f : l[rr];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int64_t d = lane + 32 * j;
      if (d < D) ob[s * q_stride + d] = from_f32<T>(acc[rr][j] / inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
                   int64_t H, int64_t Tk, int64_t K, int64_t D, int causal, int64_t window,
                   int64_t q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = fa_simple_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Tk, K, D, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int64_t B,
                       int64_t S, int64_t H, int64_t Tk, int64_t K, int64_t D, int causal,
                       int64_t window, int64_t q_offset, float scale, cudaStream_t st) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 2: return launch<T, 2>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 3: return launch<T, 3>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 4: return launch<T, 4>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 5: return launch<T, 5>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 6: return launch<T, 6>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 7: return launch<T, 7>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    case 8: return launch<T, 8>(q, k, v, o, B, S, H, Tk, K, D, causal, window, q_offset, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simple

// ------------------------------------------------------------------ //
// fa_tc_kernel: bf16 on the tensor cores
// ------------------------------------------------------------------ //
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;  // query rows per CTA: 16 per warp
constexpr int kBK = 64;           // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: q (kBQ rows) and two stages of (k, v) (kBK rows each), every
// row D bf16 plus 8 of padding (16 bytes), so a row starts 16 bytes further
// along the 128-byte bank cycle than the row before it.
template <int D>
struct Layout {
  static constexpr int kLd = D + 8;
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kTile = kBK * kLd;
  static constexpr size_t kBytes = sizeof(bf16) * static_cast<size_t>(kQ + 4 * kTile);
  // CTAs an SM should hold: at D <= 64, 4 fill Granite's 512-CTA grid in
  // one wave (it caps the registers at 128 a thread)
  static constexpr int kMinBlocks = D <= 64 ? 4 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src-size 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage kRows rows of D bf16 (row stride `stride` elements), from row0 on,
// into shared memory at dst (row stride kLd); rows at or past n are zeros.
template <int D, int kRows>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* __restrict__ src,
                                           int64_t stride, int row0, int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < n;
    cp_async16(dst + sizeof(bf16) * (r * Layout<D>::kLd + c),
               in ? src + static_cast<int64_t>(row0 + r) * stride + c : src, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, int64_t S, int64_t H, int64_t T, int64_t K, int causal,
             int64_t window, int64_t q_offset, float scale_log2) {
  using L = Layout<D>;
  constexpr int kLd = L::kLd;
  constexpr int kKS = D / 16;  // 16-deep steps of Q K^T; 16-wide column pairs of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t qs_u = smem_u32(qs);
  const uint32_t kv_u = qs_u + sizeof(bf16) * L::kQ;  // stage st: k at +2*st, v at +2*st+1 tiles
  constexpr uint32_t kTileB = sizeof(bf16) * L::kTile;

  // positions and counts fit 32 bits (tc_path checks), which keeps the
  // loop's registers low enough for 4 CTAs an SM at D = 64
  const int Si = static_cast<int>(S), Ti = static_cast<int>(T);
  const int win = static_cast<int>(window), qoff = static_cast<int>(q_offset);
  const int64_t bh = blockIdx.x;  // b * H + h
  const int64_t b = bh / H, h = bh % H;
  const int64_t kvh = h / (H / K);
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, lane in quad
  const int64_t q_stride = H * D, kv_stride = K * D;
  const bf16* qb = q + (b * S * H + h) * D;
  const bf16* kb = k + (b * T * K + kvh) * D;
  const bf16* vb = v + (b * T * K + kvh) * D;

  const TileRange tiles = key_tiles(q0, kBQ, S, T, causal, window, q_offset, kBK);
  const int jlo = static_cast<int>(tiles.lo), jhi = static_cast<int>(tiles.hi);
  stage_rows<D, kBQ>(qs_u, qb, q_stride, q0, Si);
  cp_async_commit();
  stage_rows<D, kBK>(kv_u, kb, kv_stride, jlo * kBK, Ti);
  stage_rows<D, kBK>(kv_u + kTileB, vb, kv_stride, jlo * kBK, Ti);
  cp_async_commit();

  // this lane's ldmatrix row and column of the warp's Q rows (A operand)
  const int qr = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, qc = (lane >> 4) * 8;
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 units
  float l[2] = {0.0f, 0.0f};        // this lane's part of the row sums
  const int prow = q0 + warp * 16 + g + qoff;         // position of row g
  const int pmin = q0 + qoff, pmax = pmin + kBQ - 1;  // the CTA's rows

  for (int j = jlo; j < jhi; ++j) {
    const int st = (j - jlo) & 1;
    if (j + 1 < jhi) {  // the next tile into the other stage
      const uint32_t nxt = kv_u + 2 * (st ^ 1) * kTileB;
      stage_rows<D, kBK>(nxt, kb, kv_stride, (j + 1) * kBK, Ti);
      stage_rows<D, kBK>(nxt + kTileB, vb, kv_stride, (j + 1) * kBK, Ti);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and, the first time, Q) has landed
    __syncthreads();
    const uint32_t ks_u = kv_u + 2 * st * kTileB, vs_u = ks_u + kTileB;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    {
      const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t qf[4];  // Q's A fragment, reloaded every tile: fewer live registers
        ldsm_x4(qf, qs_u + sizeof(bf16) * (qr * kLd + kk * 16 + qc));
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t bfr[4];
          ldsm_x4(bfr, ks_u + sizeof(bf16) * ((np * 16 + kr) * kLd + kk * 16 + kc));
          mma16816(s[2 * np], qf, bfr[0], bfr[1]);
          mma16816(s[2 * np + 1], qf, bfr[2], bfr[3]);
        }
      }
    }

    // scale (log2 units) and mask; interior tiles need no mask
    const int key0 = j * kBK;
    const bool edge = key0 + kBK > Ti || (causal && key0 + kBK - 1 > pmin) ||
                      (win > 0 && pmax - key0 >= win);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int t = key0 + n * 8 + 2 * tq + (e & 1);
          const int p = prow + (e >> 1) * 8;
          if (t >= Ti) {
            x = -INFINITY;  // past the ragged edge: no key at all
          } else if ((causal && t > p) || (win > 0 && p - t >= win)) {
            x = kNegInf;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // P V: P from the S fragments, rounded to bf16 in registers
    const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[2 * kk][e] - m[e >> 1]);
        p[4 + e] = exp2f(s[2 * kk + 1][e] - m[e >> 1]);
      }
      l[0] += p[0] + p[1] + p[4] + p[5];
      l[1] += p[2] + p[3] + p[6] + p[7];
      const uint32_t a[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                             pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
#pragma unroll
      for (int dp = 0; dp < kKS; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, vs_u + sizeof(bf16) * ((kk * 16 + vr) * kLd + dp * 16 + vc));
        mma16816(oacc[2 * dp], a, bfr[0], bfr[1]);
        mma16816(oacc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  // divide by l (1 where l == 0), round once, stage in this warp's Q rows,
  // store 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    inv[i] = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
  }
  bf16* stage = qs + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(stage + g * kLd + c) =
        pack_bf16(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + c) =
        pack_bf16(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + (b * S * H + h) * D;
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int srow = q0 + warp * 16 + r;
    if (srow < Si) {
      *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(srow) * q_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t S,
                   int64_t H, int64_t T, int64_t K, int causal, int64_t window, int64_t q_offset,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  auto kernel = fa_tc_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H, T, K, causal, window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The tensor-core kernel takes bf16 at these head dims (multiples of 16, so
// 16-deep mma steps and 16-byte row chunks) when every operand is 16-byte
// aligned; flash_attention_route reports the choice.
// Its positions are 32-bit: S, T, the window and the offset stay below 2^30.
bool tc_path(int dtype, int64_t D, const void* q, const void* k, const void* v,
             const void* o, int64_t S, int64_t T, int64_t window, int64_t q_offset) {
  constexpr int64_t kLim = int64_t{1} << 30;
  return dtype == kBF16 && (D == 32 || D == 64 || D == 80 || D == 128) && aligned16(q) &&
         aligned16(k) && aligned16(v) && aligned16(o) && S < kLim && T < kLim &&
         window < kLim && q_offset < kLim && q_offset > -kLim;
}

// The CUDA-core kernel that dispatch_d<T> launches at head dim D.
template <typename T>
const void* simple_kernel(int64_t D) {
  const void* fns[8] = {
      (const void*)simple::fa_simple_kernel<T, 1>, (const void*)simple::fa_simple_kernel<T, 2>,
      (const void*)simple::fa_simple_kernel<T, 3>, (const void*)simple::fa_simple_kernel<T, 4>,
      (const void*)simple::fa_simple_kernel<T, 5>, (const void*)simple::fa_simple_kernel<T, 6>,
      (const void*)simple::fa_simple_kernel<T, 7>, (const void*)simple::fa_simple_kernel<T, 8>};
  return fns[(D + 31) / 32 - 1];
}

}  // namespace

extern "C" {

// q (B,S,H,D), k/v (B,T,K,D), o (B,S,H,D): contiguous, one dtype.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t S, int64_t H, int64_t T, int64_t K, int64_t D,
                        int causal, int64_t window, int64_t q_offset, float scale,
                        void* stream) {
  if (D < 1 || D > kMaxD || K < 1 || H % K != 0 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * H == 0 || S == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tc_path(dtype, D, q, k, v, o, S, T, window, q_offset)) {
    switch (D) {
      case 32: err = tc::launch<32>(q, k, v, o, B, S, H, T, K, causal, window, q_offset, scale, st); break;
      case 64: err = tc::launch<64>(q, k, v, o, B, S, H, T, K, causal, window, q_offset, scale, st); break;
      case 80: err = tc::launch<80>(q, k, v, o, B, S, H, T, K, causal, window, q_offset, scale, st); break;
      default: err = tc::launch<128>(q, k, v, o, B, S, H, T, K, causal, window, q_offset, scale, st); break;
    }
  } else if (dtype == kF32) {
    err = simple::dispatch_d<float>(q, k, v, o, B, S, H, T, K, D, causal, window, q_offset,
                                    scale, st);
  } else if (dtype == kBF16) {
    err = simple::dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, T, K, D, causal, window,
                                            q_offset, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// 1 when flash_attention_fwd takes the tensor-core kernel for these operands,
// 0 when it takes the CUDA-core kernel.
int flash_attention_route(int dtype, const void* q, const void* k, const void* v, const void* o,
                          int64_t S, int64_t T, int64_t D, int64_t window, int64_t q_offset) {
  return tc_path(dtype, D, q, k, v, o, S, T, window, q_offset) ? 1 : 0;
}

// Registers, static / dynamic shared memory and local (spill) bytes of the
// kernel that flash_attention_fwd launches for this dtype and D (operands
// taken as aligned, sizes as small): out[0..3].
int flash_attention_kernel_info(int dtype, int64_t D, int* out) {
  if (D < 1 || D > kMaxD || (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn;
  size_t dyn;
  if (dtype == kBF16 && (D == 32 || D == 64 || D == 80 || D == 128)) {
    fn = D == 32 ? (const void*)tc::fa_tc_kernel<32>
       : D == 64 ? (const void*)tc::fa_tc_kernel<64>
       : D == 80 ? (const void*)tc::fa_tc_kernel<80>
                 : (const void*)tc::fa_tc_kernel<128>;
    dyn = D == 32 ? tc::Layout<32>::kBytes
        : D == 64 ? tc::Layout<64>::kBytes
        : D == 80 ? tc::Layout<80>::kBytes
                  : tc::Layout<128>::kBytes;
  } else {
    fn = dtype == kF32 ? simple_kernel<float>(D) : simple_kernel<__nv_bfloat16>(D);
    dyn = simple::smem_bytes(D);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(dyn);
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
