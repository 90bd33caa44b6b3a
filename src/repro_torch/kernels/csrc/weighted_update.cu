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
// K1 and K2 are the simplest design that is coalesced: one thread per
// element (K1) or per column (K2), neighbouring threads on neighbouring
// addresses, and a grid-stride loop so any size works without padding.
//
// K6 is a copy and a cast.  On a Mamba2-130M ring (E = 4 rows of 129 M fp32
// columns) one call moves 4.6 GB and is bound by bytes; at the MLP's ring
// and block (E = 8 of 26,624 columns, 3 lanes padded onto the trash row)
// it moves ~1.4 MB and is bound by latency: a launch and one round trip to
// memory.  So it does no more than the bytes need, in one pass:
//   - A CTA takes one lane i (blockIdx.y) and a span of its columns.  It
//     loads the slots of lanes i..E-1 into shared memory once; lane i is
//     live when its slot is in [0, R) and no later lane has the same slot
//     (O(E) a thread; E is the block size, at most 4096 here).  A live lane writes its row, a
//     dead one nothing, so each distinct ring row is written once, and
//     last-writer-wins holds by construction, with no order between
//     threads; the trash row ends with the last padded lane's value, as in
//     the plain version.  The Python mirror of the rule, for the CPU tests,
//     is repro_torch/kernels/weighted_update.py:live_lanes.
//   - The loads of W are issued before the slots arrive, so the two round
//     trips overlap; a dead lane's CTAs read their row of W and store
//     nothing.
//   - 16-byte accesses: VEC = 4 fp32 or 8 bf16 ring values a thread, read
//     from W as float4s, stored with one 16-byte store.  A P that is not a
//     multiple of VEC, or an operand not 16-byte aligned, takes one value
//     an access: the rows of W and of the ring then start off the 16-byte
//     grid at offsets that differ from row to row, so a 16-byte body with a
//     scalar tail could not be aligned on both sides.  Every caller in the
//     engine pads P to a multiple of 1024, so the path always takes VEC.
//   - w' = W[E-1], cast to w's dtype, is written by lane E-1's threads from
//     the values they already hold.
//   - The grid is sized to the work, never capped: ceil(P / (VEC * 128 *
//     2)) CTAs a lane, each thread holding two vectors in flight (the MLP
//     ring: 26 CTAs a lane, 208 over its 8 lanes, more than the 132 SMs;
//     Mamba2-130M's fp32 ring: 125,961 a lane).
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) this took 1.5-1.6 us of
// device time at the MLP ring and block, below index_copy_'s 2.6 us, and
// 1.54 ms at Mamba2-130M's fp32 ring, 90% of its 1.39 ms byte bound.
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
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per SM (K1, K2)
constexpr int64_t kMaxScatterLanes = 4096;  // K6's slots fill E * 8 bytes of shared memory

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

// K6 (see the note above): CTA (x, i) takes lane i's vectors
// [x * 128 * U, (x + 1) * 128 * U), U = kScatterUnroll, 128 apart in each
// thread.
constexpr int kScatterThreads = 128;
constexpr int kScatterUnroll = 2;

// VEC values of type T, as wide as one access may be (16 bytes at most)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

template <typename S, typename W, int VEC>
__global__ void __launch_bounds__(kScatterThreads)
block_scatter_rows_kernel(S* __restrict__ snaps, const float* __restrict__ Wr,
                          const int64_t* __restrict__ slots, W* __restrict__ w_out, int64_t R,
                          int64_t P, int64_t E) {
  extern __shared__ int64_t later[];  // slots of lanes i..E-1
  const int64_t i = blockIdx.y;
  const int64_t nvec = P / VEC;
  const int64_t v0 =
      static_cast<int64_t>(blockIdx.x) * kScatterThreads * kScatterUnroll + threadIdx.x;
  const Pack<float, VEC>* src = reinterpret_cast<const Pack<float, VEC>*>(Wr + i * P);
  Pack<float, VEC> val[kScatterUnroll];
#pragma unroll
  for (int u = 0; u < kScatterUnroll; ++u) {
    const int64_t v = v0 + static_cast<int64_t>(u) * kScatterThreads;
    if (v < nvec) val[u] = src[v];
  }
  for (int64_t j = i + threadIdx.x; j < E; j += kScatterThreads) later[j - i] = slots[j];
  __syncthreads();
  const int64_t row = later[0];
  bool live = row >= 0 && row < R;
  for (int64_t j = 1; live && j < E - i; ++j) live = later[j] != row;
  const bool last = i == E - 1;
  if (!live && !last) return;
  Pack<S, VEC>* dst = reinterpret_cast<Pack<S, VEC>*>(snaps + (live ? row : 0) * P);
  Pack<W, VEC>* wdst = reinterpret_cast<Pack<W, VEC>*>(w_out);
#pragma unroll
  for (int u = 0; u < kScatterUnroll; ++u) {
    const int64_t v = v0 + static_cast<int64_t>(u) * kScatterThreads;
    if (v < nvec) {
      if (live) {
        Pack<S, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<S>(val[u].v[e]);
        dst[v] = o;
      }
      if (last) {
        Pack<W, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<W>(val[u].v[e]);
        wdst[v] = o;
      }
    }
  }
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// The ring values a thread of K6 moves per access: 16 bytes of them when P
// is a multiple of that and snaps and W are 16-byte aligned, else one (w'
// is 16-byte aligned, block_scatter_rows checks it).
int scatter_vec(int snap_dtype, const void* snaps, const void* Wr, int64_t P) {
  const int vec = snap_dtype == kF32 ? 4 : 8;
  return P % vec == 0 && aligned_to(snaps, 16) && aligned_to(Wr, 16) ? vec : 1;
}

template <typename S, typename W, int VEC>
cudaError_t launch_scatter_vec(void* snaps, const void* Wr, const void* slots, void* w_out,
                               int64_t R, int64_t P, int64_t E, cudaStream_t stream) {
  const int64_t span = int64_t{kScatterThreads} * kScatterUnroll;
  const dim3 grid(static_cast<unsigned>((P / VEC + span - 1) / span), static_cast<unsigned>(E));
  block_scatter_rows_kernel<S, W, VEC><<<grid, kScatterThreads, E * sizeof(int64_t), stream>>>(
      static_cast<S*>(snaps), static_cast<const float*>(Wr), static_cast<const int64_t*>(slots),
      static_cast<W*>(w_out), R, P, E);
  return cudaGetLastError();
}

// 16 bytes of ring values a thread access
template <typename S>
constexpr int kWide = 16 / sizeof(S);

template <typename S, typename W>
cudaError_t launch_scatter(void* snaps, const void* Wr, const void* slots, void* w_out, int64_t R,
                           int64_t P, int64_t E, int vec, cudaStream_t stream) {
  return vec == 1 ? launch_scatter_vec<S, W, 1>(snaps, Wr, slots, w_out, R, P, E, stream)
                  : launch_scatter_vec<S, W, kWide<S>>(snaps, Wr, slots, w_out, R, P, E, stream);
}

// The K6 kernel of this dtype pair and VEC (1 or 16 bytes), for kernel_info.
template <typename S, typename W>
const void* scatter_kernel(int vec) {
  return vec == 1 ? (const void*)block_scatter_rows_kernel<S, W, 1>
                  : (const void*)block_scatter_rows_kernel<S, W, kWide<S>>;
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
  if (E < 1 || E > kMaxScatterLanes || (snap_dtype != kF32 && snap_dtype != kBF16) ||
      (w_dtype != kF32 && w_dtype != kBF16) || !aligned_to(w_out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = scatter_vec(snap_dtype, snaps, W, P);
  cudaError_t err;
  if (snap_dtype == kF32 && w_dtype == kF32) {
    err = launch_scatter<float, float>(snaps, W, slots, w_out, R, P, E, vec, st);
  } else if (snap_dtype == kBF16 && w_dtype == kF32) {
    err = launch_scatter<__nv_bfloat16, float>(snaps, W, slots, w_out, R, P, E, vec, st);
  } else if (snap_dtype == kF32 && w_dtype == kBF16) {
    err = launch_scatter<float, __nv_bfloat16>(snaps, W, slots, w_out, R, P, E, vec, st);
  } else {
    err = launch_scatter<__nv_bfloat16, __nv_bfloat16>(snaps, W, slots, w_out, R, P, E, vec, st);
  }
  return static_cast<int>(err);
}

// The ring values a thread of K6 moves per access for these operands.
int block_scatter_rows_vec(int snap_dtype, const void* snaps, const void* W, int64_t P) {
  return scatter_vec(snap_dtype, snaps, W, P);
}

// Registers, static / dynamic shared memory, local (spill) bytes and the
// CTAs an SM holds of the K6 kernel for this dtype pair and VEC (1, or 16
// bytes of ring values), at E lanes: out[0..4].
int block_scatter_rows_kernel_info(int snap_dtype, int w_dtype, int vec, int64_t E, int* out) {
  if ((snap_dtype != kF32 && snap_dtype != kBF16) || (w_dtype != kF32 && w_dtype != kBF16) ||
      (vec != 1 && vec != (snap_dtype == kF32 ? 4 : 8)) || E < 1 || E > kMaxScatterLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = snap_dtype == kF32
      ? (w_dtype == kF32 ? scatter_kernel<float, float>(vec)
                         : scatter_kernel<float, __nv_bfloat16>(vec))
      : (w_dtype == kF32 ? scatter_kernel<__nv_bfloat16, float>(vec)
                         : scatter_kernel<__nv_bfloat16, __nv_bfloat16>(vec));
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = E * sizeof(int64_t);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kScatterThreads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(dyn);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return 0;
}

}  // extern "C"
