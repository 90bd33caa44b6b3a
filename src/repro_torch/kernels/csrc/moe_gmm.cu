// Grouped (per-expert) matmul on dispatch-form MoE tensors for Hopper (sm_90a).
//
// K5 replaces the TPU kernel src/repro/kernels/moe_gmm.py:_gmm_kernel
// (launched by _gmm_impl):
//
//   y[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> y (E, C, F) in x's dtype,
//
// summed in fp32 and rounded once, at the end, to x's dtype.  The Pallas
// grid's sequential contraction axis (D, "arbitrary", with an fp32 VMEM
// accumulator) becomes a loop inside the CTA over D in steps of kBD, with the
// accumulators in registers; the (e, C tile, F tile) axes become the grid.
// Unlike the TPU kernel, it takes any C, D and F: the staged tiles are
// zero-filled past the ragged edges and the epilogue stores only real rows
// and columns (the MoE path's capacity is 88 for Qwen1.5-MoE, 12 for Arctic).
//
//   bf16: nvcuda::wmma 16x16x16 bf16 fragments with fp32 accumulators on the
//         tensor cores.  A product of two bf16 values is exact in fp32, so
//         this is the TPU's fp32 dot up to the order of summation.  Each of
//         the 8 warps owns 16 rows of the 128-row slab and all 64 columns
//         (four accumulator fragments); a warp whose rows all lie past C
//         skips the products.  The fp32 tile goes through shared memory
//         (aliasing the staging buffers) for the masked, rounding store.
//   fp32: a register-tiled FMA loop on the CUDA cores (TF32 keeps about
//         three digits and would break the 1e-5 fp32 parity).  Thread
//         (ty, tx) of a 16 x 16 layout owns rows ty + 16 i (i < 8) and
//         columns tx + 16 j (j < 4) and adds the products in order of d.
//
// What bounds it: at the MoE path's shape, one gate or up call of
// Qwen1.5-MoE-A2.7B is x (60, 88, 2048) @ w (60, 2048, 1408) in bf16: it
// moves 382.5 MB (x 21.6, w 346.0, y 14.9) and does 30.45 GFLOP, so it is
// bound by bytes (0.114 ms at 3.35 TB/s against 0.031 ms of tensor-core
// work), and almost all of them are w's.  Hence the C slab of 128 rows: it
// covers the path's whole capacity (88 <= 128), so each element of w is read
// from device memory exactly once (grid.y == 1) and x, which every F tile
// re-reads, stays in L2 (21.6 MB < 50 MB).  Loads are 16 bytes a thread
// where D and F allow it.  This first version does not pipeline its loads
// (no cp.async, TMA or wgmma, no persistent schedule): that is later work.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kBC = 128;     // rows of C per CTA: the whole capacity of the path
constexpr int kBF = 64;      // columns of F per CTA
constexpr int kBD = 32;      // depth of one staged step of the contraction
constexpr int kThreads = 256;  // 8 warps

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// Stage the (ROWS, COLS) tile at src (row stride ld) into shared memory at
// dst (row stride lds), zero past nrows rows and ncols columns.  V elements
// move as one 16-byte load; with V > 1 the host guarantees that ld, the
// tile's column offset and ncols are multiples of V and src is 16-byte
// aligned, and lds * sizeof(T) is a multiple of 16.
template <typename T, int V, int ROWS, int COLS>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t ld, int64_t nrows,
                                      int64_t ncols, T* dst, int lds) {
  constexpr int kPerRow = COLS / V;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * V;
    T* d = dst + r * lds + c;
    const bool in = r < nrows && c < ncols;
    if constexpr (V == 1) {
      *d = in ? src[r * ld + c] : zero<T>();
    } else {
      *reinterpret_cast<uint4*>(d) =
          in ? __ldg(reinterpret_cast<const uint4*>(src + r * ld + c)) : make_uint4(0, 0, 0, 0);
    }
  }
}

// bf16 on the tensor cores.  Shared memory: x tile (kBC, kBD) and w tile
// (kBD, kBF) as bf16 while the loop runs, then the fp32 (kBC, kBF) result.
constexpr int kLdxH = kBD + 8;   // 40 bf16: 80-byte rows, wmma ldm % 8 == 0
constexpr int kLdwH = kBF + 8;   // 72 bf16
constexpr int kLdo = kBF + 4;    // 68 floats
constexpr int kXsBytes = kBC * kLdxH * 2;
constexpr int kSmemBf16 = kBC * kLdo * 4 > kXsBytes + kBD * kLdwH * 2
                              ? kBC * kLdo * 4 : kXsBytes + kBD * kLdwH * 2;

template <int V>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, int64_t C, int64_t D, int64_t F) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kSmemBf16];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kXsBytes);
  float* out = reinterpret_cast<float*>(smem);

  const int64_t e = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kBC;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kBF;
  const int warp = threadIdx.x / 32;
  const int r0 = 16 * warp;             // this warp's first row of the slab
  const bool active = c0 + r0 < C;      // warp-uniform

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBF / 16];
#pragma unroll
  for (int j = 0; j < kBF / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const __nv_bfloat16* xe = x + (e * C + c0) * D;
  const __nv_bfloat16* we = w + e * D * F + f0;
  for (int64_t d0 = 0; d0 < D; d0 += kBD) {
    stage<__nv_bfloat16, V, kBC, kBD>(xe + d0, D, C - c0, D - d0, xs, kLdxH);
    stage<__nv_bfloat16, V, kBD, kBF>(we + d0 * F, F, D - d0, F - f0, ws, kLdwH);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + r0 * kLdxH + kk, kLdxH);
#pragma unroll
        for (int j = 0; j < kBF / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + kk * kLdwH + 16 * j, kLdwH);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();  // the next step (or the epilogue) overwrites the tiles
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < kBF / 16; ++j) {
      wmma::store_matrix_sync(out + r0 * kLdo + 16 * j, acc[j], kLdo, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBC * kBF; i += kThreads) {
    const int r = i / kBF, j = i % kBF;
    const int64_t c = c0 + r, f = f0 + j;
    if (c < C && f < F) y[(e * C + c) * F + f] = __float2bfloat16_rn(out[r * kLdo + j]);
  }
}

// fp32 on the CUDA cores.
constexpr int kLdxF = kBD + 4;   // 36 floats: 144-byte rows (16-byte stores), and the
                                 // two rows a warp reads at once fall in distinct banks
constexpr int kRows = kBC / 16;  // 8 rows a thread
constexpr int kCols = kBF / 16;  // 4 columns a thread

template <int V>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
               int64_t C, int64_t D, int64_t F) {
  __shared__ __align__(16) float xs[kBC * kLdxF];
  __shared__ __align__(16) float ws[kBD * kBF];

  const int64_t e = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kBC;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kBF;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const float* xe = x + (e * C + c0) * D;
  const float* we = w + e * D * F + f0;
  for (int64_t d0 = 0; d0 < D; d0 += kBD) {
    stage<float, V, kBC, kBD>(xe + d0, D, C - c0, D - d0, xs, kLdxF);
    stage<float, V, kBD, kBF>(we + d0 * F, F, D - d0, F - f0, ws, kBF);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBD; ++k) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = xs[(ty + 16 * i) * kLdxF + k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ws[k * kBF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t f = f0 + tx + 16 * j;
      if (f < F) y[(e * C + c) * F + f] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename Kernel1, typename KernelV>
cudaError_t launch(Kernel1 scalar, KernelV vector, const void* x, const void* w, void* y,
                   int64_t E, int64_t C, int64_t D, int64_t F, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>((F + kBF - 1) / kBF),
                  static_cast<unsigned>((C + kBC - 1) / kBC), static_cast<unsigned>(E));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (D % V == 0 && F % V == 0 && aligned16(x) && aligned16(w)) {
    vector<<<grid, kThreads, 0, stream>>>(xt, wt, yt, C, D, F);
  } else {
    scalar<<<grid, kThreads, 0, stream>>>(xt, wt, yt, C, D, F);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (E,C,D), w (E,D,F) and y (E,C,F) in one dtype, all contiguous.
// E <= 65535 (the grid's z dimension).
int moe_gmm_fwd(int dtype, const void* x, const void* w, void* y, int64_t E, int64_t C,
                int64_t D, int64_t F, void* stream) {
  if (E < 0 || C < 0 || D < 0 || F < 0 || E > 65535 || (C + kBC - 1) / kBC > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E == 0 || C == 0 || F == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = launch<float>(gmm_f32_kernel<1>, gmm_f32_kernel<4>, x, w, y, E, C, D, F, st);
  } else if (dtype == kBF16) {
    err = launch<__nv_bfloat16>(gmm_bf16_kernel<1>, gmm_bf16_kernel<8>, x, w, y, E, C, D, F, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
