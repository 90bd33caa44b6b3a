// Flash attention forward (causal / sliding-window GQA) for Hopper (sm_90a).
//
// K3 replaces the TPU kernel src/repro/kernels/flash_attention.py:_fa_kernel
// (launched by _fa_impl).  Same arithmetic: q is scaled by 1/sqrt(D) in fp32
// before the dot product; the mask keeps key t for query row s when
// t <= s + q_offset (causal) and s + q_offset - t < window (window > 0);
// masked scores are the finite -1e30, not -inf; the running max, sum and
// accumulator are fp32 and the last step divides by l (1 where l == 0);
// query head h reads KV head h / (H / K).  Like the Pallas grid, the kernel
// visits every key tile, so a fully masked row averages v over all T keys,
// exactly as the reference softmax over -1e30 scores does.
//
// What bounds it: at the LM path's shape (B=8, S=T=128, H=32, K=8, D=64) one
// call reads ~6 MB and does ~1 GFLOP, so it is a small, short kernel whose
// time is set by how well it keeps the SMs busy, not by HBM; at long S it is
// bound by operations.  This first version is the simple design: one CTA of
// 8 warps per (b*H + h, 32-row query tile); each warp owns 4 query rows and
// keeps their online-softmax state in registers; the CTA stages one
// 32-key K/V tile at a time in shared memory as fp32 (K rows padded to D+1
// floats, so the 32 lanes, one key each, hit 32 banks); lane l scores key l
// against the warp's 4 rows, the row max and sum are warp shuffles, and P·V
// broadcasts each key's weight by shuffle while lane l accumulates columns
// l, l+32, ...  All math is fp32 on the CUDA cores (no tensor cores yet:
// wgmma/TMA are later work).  Ragged S and T need no padding: query rows
// past S are computed on zeros and never stored, and key slots past T get
// score -inf, which no max selects and exp sends to 0.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;           // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

enum DType : int { kF32 = 0, kBF16 = 1 };

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

// DPL = ceil(D / 32): accumulator columns per lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

  for (int64_t k0 = 0; k0 < Tk; k0 += kBK) {
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
      bool keep = true;
      if (causal) keep = keep && (t <= qpos);
      if (window > 0) keep = keep && (qpos - t < window);
      float s = keep ? sc[rr] : kNegInf;
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
  auto kernel = fa_fwd_kernel<T, DPL>;
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
  if (dtype == kF32) {
    err = dispatch_d<float>(q, k, v, o, B, S, H, T, K, D, causal, window, q_offset, scale, st);
  } else if (dtype == kBF16) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, T, K, D, causal, window, q_offset,
                                    scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
