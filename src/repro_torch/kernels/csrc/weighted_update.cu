// Fused Generalized-AsyncSGD server updates for Hopper (sm_90a).
//
// K1  weighted_update (plain and momentum) replaces the TPU kernel
//     repro/kernels/weighted_update.py:weighted_update (bodies _kernel_plain
//     and _kernel):  w' = w - s * (momentum * m + g),  m' = momentum * m + g.
// K2  block_prefix_update replaces repro/kernels/weighted_update.py:
//     block_prefix_update (body _block_kernel):  W_i = w - sum_{j<=i} D_j,
//     snaps[slot_i] = W_i in place, w' = W_{E-1}.
// K6  block_scatter_rows replaces repro/kernels/weighted_update.py:
//     block_scatter_rows (body _scatter_kernel): the lane-sharded engine's
//     scatter of precomputed iterates, snaps[slot_i] = W_i in place,
//     w' = W_{E-1}.
//
// What bounds them: all three are elementwise passes with O(1) flops per
// byte, so device-memory bandwidth is their ceiling.  At the MLP's width
// (P = 26,122 parameters, 26,624 once padded) one launch moves a few hundred
// KB (K1, per leaf) to ~2 MB (K2 at E = 16), which takes well under a
// microsecond at 3.35 TB/s: launch latency, not bandwidth, sets their time.
// K6 on a Mamba2-130M ring (E = 4 rows of 129 M fp32 columns) moves 4.6 GB
// and is bandwidth-bound.  The design is therefore the simplest one that is
// coalesced: one thread per element (K1) or per column (K2, K6), neighbouring
// threads on neighbouring addresses, and a grid-stride loop so any size
// works without padding.
//
// The scale is read from device memory (as the TPU kernel read it from SMEM)
// so the host never waits for it.  All math is fp32 with explicit _rn
// intrinsics, so no multiply-add is contracted and the results round exactly
// like the plain PyTorch versions in repro_torch/kernels/ref.py.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Every entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

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

inline int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// K1a: w' = w - s * g
template <typename T>
__global__ void weighted_update_plain_kernel(const T* __restrict__ w, const T* __restrict__ g,
                                             const float* __restrict__ scale,
                                             T* __restrict__ out, int64_t n) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = from_f32<T>(__fsub_rn(to_f32(w[i]), __fmul_rn(s, to_f32(g[i]))));
  }
}

// K1b: m' = momentum * m + g;  w' = w - s * m'   (m is fp32)
template <typename T>
__global__ void weighted_update_momentum_kernel(const T* __restrict__ w,
                                                const T* __restrict__ g,
                                                const float* __restrict__ m,
                                                const float* __restrict__ scale,
                                                float momentum, T* __restrict__ out_w,
                                                float* __restrict__ out_m, int64_t n) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float mf = __fadd_rn(__fmul_rn(momentum, m[i]), to_f32(g[i]));
    out_m[i] = mf;
    out_w[i] = from_f32<T>(__fsub_rn(to_f32(w[i]), __fmul_rn(s, mf)));
  }
}

// K2: each thread owns column p and walks the E events in order, so
// duplicate (trash-row) slots resolve last-writer-wins.  A slot outside
// [0, R) is dropped, as the JAX scatter drops out-of-range rows.
template <typename S, typename W>
__global__ void block_prefix_update_kernel(S* __restrict__ snaps, const W* __restrict__ w,
                                           const float* __restrict__ D,
                                           const int64_t* __restrict__ slots,
                                           W* __restrict__ w_out, int64_t R, int64_t P,
                                           int64_t E) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += stride) {
    const float w0 = to_f32(w[p]);
    float acc = 0.0f;
    for (int64_t i = 0; i < E; ++i) {
      acc = __fadd_rn(acc, D[i * P + p]);
      const int64_t row = slots[i];
      if (row >= 0 && row < R) snaps[row * P + p] = from_f32<S>(__fsub_rn(w0, acc));
    }
    w_out[p] = from_f32<W>(__fsub_rn(w0, acc));
  }
}

// K6: each thread owns column p and stores the E precomputed rows in event
// order (last writer wins on duplicate trash-row slots), then w' = W[E-1].
template <typename S, typename W>
__global__ void block_scatter_rows_kernel(S* __restrict__ snaps, const float* __restrict__ Wr,
                                          const int64_t* __restrict__ slots,
                                          W* __restrict__ w_out, int64_t R, int64_t P,
                                          int64_t E) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += stride) {
    for (int64_t i = 0; i < E; ++i) {
      const int64_t row = slots[i];
      if (row >= 0 && row < R) snaps[row * P + p] = from_f32<S>(Wr[i * P + p]);
    }
    w_out[p] = from_f32<W>(Wr[(E - 1) * P + p]);
  }
}

template <typename S, typename W>
void launch_scatter(void* snaps, const void* Wr, const void* slots, void* w_out, int64_t R,
                    int64_t P, int64_t E, cudaStream_t stream) {
  block_scatter_rows_kernel<S, W><<<grid_for(P), kThreads, 0, stream>>>(
      static_cast<S*>(snaps), static_cast<const float*>(Wr),
      static_cast<const int64_t*>(slots), static_cast<W*>(w_out), R, P, E);
}

template <typename S, typename W>
void launch_block(void* snaps, const void* w, const void* D, const void* slots, void* w_out,
                  int64_t R, int64_t P, int64_t E, cudaStream_t stream) {
  block_prefix_update_kernel<S, W><<<grid_for(P), kThreads, 0, stream>>>(
      static_cast<S*>(snaps), static_cast<const W*>(w), static_cast<const float*>(D),
      static_cast<const int64_t*>(slots), static_cast<W*>(w_out), R, P, E);
}

}  // namespace

extern "C" {

int wu_plain(int dtype, const void* w, const void* g, const void* scale, void* out, int64_t n,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (dtype == kF32) {
    weighted_update_plain_kernel<float><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(g), s, static_cast<float*>(out),
        n);
  } else if (dtype == kBF16) {
    weighted_update_plain_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(g), s,
        static_cast<__nv_bfloat16*>(out), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int wu_momentum(int dtype, const void* w, const void* g, const void* m, const void* scale,
                float momentum, void* out_w, void* out_m, int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* mm = static_cast<const float*>(m);
  float* om = static_cast<float*>(out_m);
  if (dtype == kF32) {
    weighted_update_momentum_kernel<float><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(g), mm, s, momentum,
        static_cast<float*>(out_w), om, n);
  } else if (dtype == kBF16) {
    weighted_update_momentum_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(g), mm, s,
        momentum, static_cast<__nv_bfloat16*>(out_w), om, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int block_prefix_update(int snap_dtype, int w_dtype, void* snaps, const void* w, const void* D,
                        const void* slots, void* w_out, int64_t R, int64_t P, int64_t E,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (snap_dtype == kF32 && w_dtype == kF32) {
    launch_block<float, float>(snaps, w, D, slots, w_out, R, P, E, st);
  } else if (snap_dtype == kBF16 && w_dtype == kF32) {
    launch_block<__nv_bfloat16, float>(snaps, w, D, slots, w_out, R, P, E, st);
  } else if (snap_dtype == kF32 && w_dtype == kBF16) {
    launch_block<float, __nv_bfloat16>(snaps, w, D, slots, w_out, R, P, E, st);
  } else if (snap_dtype == kBF16 && w_dtype == kBF16) {
    launch_block<__nv_bfloat16, __nv_bfloat16>(snaps, w, D, slots, w_out, R, P, E, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int block_scatter_rows(int snap_dtype, int w_dtype, void* snaps, const void* W,
                       const void* slots, void* w_out, int64_t R, int64_t P, int64_t E,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (snap_dtype == kF32 && w_dtype == kF32) {
    launch_scatter<float, float>(snaps, W, slots, w_out, R, P, E, st);
  } else if (snap_dtype == kBF16 && w_dtype == kF32) {
    launch_scatter<__nv_bfloat16, float>(snaps, W, slots, w_out, R, P, E, st);
  } else if (snap_dtype == kF32 && w_dtype == kBF16) {
    launch_scatter<float, __nv_bfloat16>(snaps, W, slots, w_out, R, P, E, st);
  } else if (snap_dtype == kBF16 && w_dtype == kBF16) {
    launch_scatter<__nv_bfloat16, __nv_bfloat16>(snaps, W, slots, w_out, R, P, E, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
