// Grouped (per-expert) matmul on dispatch-form MoE tensors for Hopper (sm_90a).
//
// K5 replaces the TPU kernel src/repro/kernels/moe_gmm.py:_gmm_kernel
// (launched by _gmm_impl):
//
//   y[e] = x[e] @ w[e],   x (E, C, D), w (E, D, F) -> y (E, C, F) in x's dtype,
//
// summed in fp32 and rounded once, at the end, to x's dtype.  The Pallas
// grid's sequential contraction axis (D, "arbitrary", with an fp32 VMEM
// accumulator) becomes a loop inside the CTA over D, with the accumulators
// in registers; the (e, C tile, F tile) axes become the grid.  Unlike the
// TPU kernel, it takes any C, D and F: the staged tiles are zero-filled past
// the ragged edges and the epilogue stores only real rows and columns (the
// MoE path's capacity is 88 for Qwen1.5-MoE, 12 for Arctic).
//
// What bounds it: at the MoE path's shape, one gate or up call of
// Qwen1.5-MoE-A2.7B is x (60, 88, 2048) @ w (60, 2048, 1408) in bf16: it
// moves 382.5 MB (x 21.6, w 346.0, y 14.9) and does 30.45 GFLOP, so it is
// bound by bytes (0.114 ms at 3.35 TB/s against 0.031 ms of tensor-core
// work), and almost all of them are w's.  So each element of w is read from
// device memory exactly once (a CTA's 128-row C slab covers the path's whole
// capacity, grid.y == 1), and the kernel's job is to keep enough of w in
// flight to stream it at HBM rate while the products keep up.
//
//   gmm_wgmma_kernel (bf16, D and F multiples of 8, 16-byte aligned x and w):
//     one CTA of three warpgroups per (e, 128-row C slab, 128-column F
//     tile).  x and w are 3-d TMA tensor maps, (E, C, D) and (E, D, F),
//     with 128-byte swizzle: a step of the contraction is one 128 x 64 box
//     of x and two 64 x 64 boxes of w (32 KB), landing in a 6-slot ring in
//     dynamic shared memory, zero-filled by the copy engine past C, D and F
//     of its own expert.  One thread of the producer warpgroup keeps five
//     steps (160 KB) in flight; each slot has a `full` mbarrier (bytes
//     landed) and an `empty` one (both consumers done).  Consumer warpgroup
//     g multiplies rows 64 g.. by four wgmma m64n128k16 a step, A (x,
//     K-major) and B (w, MN-major) read by the tensor cores straight from
//     the swizzled slots through shared-memory descriptors, fp32 in 64
//     registers a thread; a warpgroup whose rows all lie past C skips its
//     products.  The epilogue rounds once to bf16 from registers and stores
//     masked at the C and F edges.  x, which every F tile re-reads, comes
//     from L2 (21.6 MB < 50 MB), 11 times at the gate/up shape, 16 down.
//   gmm_bf16_scalar_kernel (bf16 otherwise): the first design, 2-byte
//     loads into 32-deep shared-memory steps, nvcuda::wmma 16x16x16.
//   gmm_f32_kernel: a register-tiled FMA loop on the CUDA cores (TF32
//     keeps about three digits and would break the 1e-5 fp32 parity).
//     Thread (ty, tx) of a 16 x 16 layout owns rows ty + 16 i (i < 8) and
//     columns tx + 16 j (j < 4) and adds the products in order of d.
//
// A product of two bf16 values is exact in fp32, so the bf16 paths are the
// TPU's fp32 dot up to the order of summation, which is fixed: no atomics,
// no split of D, and two launches on the same inputs give the same bits.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The entry point returns cudaGetLastError() of its launch.  The tensor
// maps are encoded per call on the host by cuTensorMapEncodeTiled, looked
// up in libcuda.so.1 (which the CUDA runtime has loaded), and passed by
// value as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

enum DType : int { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------------------------ //
// gmm_wgmma_kernel: bf16, TMA ring + wgmma, warp-specialised
// ------------------------------------------------------------------ //
namespace wg {

constexpr int kBC = 128;           // rows of C per CTA: two consumer warpgroups of 64
constexpr int kBF = 128;           // columns of F per CTA
constexpr int kBD = 64;            // depth of one staged step: one 128-byte swizzle row of x
constexpr int kConsumers = 2;      // warpgroups that multiply
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kXBytes = kBC * kBD * 2;             // x tile, 16 KB
constexpr int kWHalf = kBD * 64 * 2;               // w tile, one 64-column half, 8 KB
constexpr int kStageBytes = kXBytes + 2 * kWHalf;  // 32 KB a ring slot

template <int STAGES>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * kStageBytes + 1024;  // + room to align to 1024
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the completion of the barrier's phase of this parity.  A wait of
// 2^34 clocks (~9 s) means an arrival was lost: trap, so that the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// A box of a 3-d tensor map into shared memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (wgmma's layout type 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, fp32, this warpgroup's fragment) += A (64 x 16, K-major) *
// B (16 x 128, MN-major: imm-trans-b = 1)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One CTA per (e, 128-row C slab, 128-column F tile).  The producer
// warpgroup's first thread keeps STAGES - 1 steps of (x, w) in flight by
// TMA (x: one 64 x 128 box; w: two 64 x 64 boxes), each slot guarded by a
// `full` barrier (bytes landed) and an `empty` barrier (both consumer
// warpgroups done with it).  Consumer warpgroup g multiplies rows 64 g..
// with four wgmma m64n128k16 a step, straight from the swizzled tiles.
template <int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 bf16* __restrict__ y, int64_t C, int64_t D, int64_t F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024 bytes

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBC;
  const int f0 = blockIdx.x * kBF;
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  const int steps = static_cast<int>((D + kBD - 1) / kBD);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (g == kConsumers) {  // producer
    if (t == 0) {
      for (int step = 0; step < steps; ++step) {
        const int slot = step % STAGES;
        if (step >= STAGES) mbar_wait(smem_u32(&empty[slot]), ((step / STAGES) - 1) & 1);
        const uint32_t sb = ring + slot * kStageBytes, bar = smem_u32(&full[slot]);
        mbar_expect_tx(bar, kStageBytes);
        tma_load(sb, &tmx, step * kBD, c0, e, bar);
        tma_load(sb + kXBytes, &tmw, f0, step * kBD, e, bar);
        tma_load(sb + kXBytes + kWHalf, &tmw, f0 + 64, step * kBD, e, bar);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const bool active = g * 64 < C - c0;  // warpgroup-uniform: rows past C skip their products
  for (int step = 0; step < steps; ++step) {
    const int slot = step % STAGES;
    mbar_wait(smem_u32(&full[slot]), (step / STAGES) & 1);
    if (active) {
      const uint32_t sb = ring + slot * kStageBytes;
      const uint32_t a = sb + g * 64 * 128;  // this warpgroup's 64 rows of x, 128 bytes each
      const uint32_t b = sb + kXBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBD / 16; ++kk) {
        // A: 16 deep = 32 bytes along the swizzled row; B: 16 rows = two 8-row atoms
        wgmma_m64n128k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                         sw128_desc(b + kk * 2048, kWHalf, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
    }
    mbar_arrive(smem_u32(&empty[slot]));
  }

  // round once to bf16 from registers; store real rows and columns
  if (!active) return;
  const int warp = t / 32, lane = t % 32;
  const int64_t r0 = c0 + g * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t col = f0 + j * 8 + 2 * (lane % 4);  // even, and F % 8 == 0
    if (col >= F) continue;
    if (r0 < C) {
      *reinterpret_cast<uint32_t*>(y + (e * C + r0) * F + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    }
    if (r0 + 8 < C) {
      *reinterpret_cast<uint32_t*>(y + (e * C + r0 + 8) * F + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// bf16 tensor (n2, n1, n0), n0 innermost, as boxes of (1, b1, b0) with
// 128-byte swizzle; out-of-bounds elements read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1, uint64_t n2,
                uint32_t b0, uint32_t b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int STAGES>
cudaError_t launch(const bf16* x, const bf16* w, bf16* y, int64_t E, int64_t C, int64_t D,
                   int64_t F, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, x, D, C, E, kBD, kBC) || !tensor_map(&tmw, w, F, D, E, 64, kBD)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = gmm_wgmma_kernel<STAGES>;
  constexpr size_t smem = smem_bytes<STAGES>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((F + kBF - 1) / kBF),
                  static_cast<unsigned>((C + kBC - 1) / kBC), static_cast<unsigned>(E));
  kernel<<<grid, kThreads, smem, stream>>>(tmx, tmw, y, C, D, F);
  return cudaGetLastError();
}

}  // namespace wg

// ------------------------------------------------------------------ //
// the scalar bf16 path and the fp32 path: 128 x 64 tiles, 32-deep steps
// ------------------------------------------------------------------ //
constexpr int kBC = 128;     // rows of C per CTA
constexpr int kBF = 64;      // columns of F per CTA
constexpr int kBD = 32;      // depth of one staged step of the contraction
constexpr int kThreads = 256;  // 8 warps

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.0f); }

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

// bf16 with 2-byte loads (D or F not a multiple of 8, or unaligned
// operands).  Shared memory: x tile (kBC, kBD) and w tile (kBD, kBF) as bf16
// while the loop runs, then the fp32 (kBC, kBF) result.
constexpr int kLdxH = kBD + 8;   // 40 bf16: 80-byte rows, wmma ldm % 8 == 0
constexpr int kLdwH = kBF + 8;   // 72 bf16
constexpr int kLdo = kBF + 4;    // 68 floats
constexpr int kXsBytes = kBC * kLdxH * 2;
constexpr int kSmemBf16 = kBC * kLdo * 4 > kXsBytes + kBD * kLdwH * 2
                              ? kBC * kLdo * 4 : kXsBytes + kBD * kLdwH * 2;

__global__ void __launch_bounds__(kThreads)
gmm_bf16_scalar_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ y, int64_t C, int64_t D, int64_t F) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kSmemBf16];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + kXsBytes);
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

  const bf16* xe = x + (e * C + c0) * D;
  const bf16* we = w + e * D * F + f0;
  for (int64_t d0 = 0; d0 < D; d0 += kBD) {
    stage<bf16, 1, kBC, kBD>(xe + d0, D, C - c0, D - d0, xs, kLdxH);
    stage<bf16, 1, kBD, kBF>(we + d0 * F, F, D - d0, F - f0, ws, kLdwH);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + r0 * kLdxH + kk, kLdxH);
#pragma unroll
        for (int j = 0; j < kBF / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
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

// 16-byte copies (and TMA) need D and F in whole 16-byte chunks and aligned
// bases; moe_gmm_route reports the choice.
bool vector_ok(int64_t D, int64_t F, int64_t per16, const void* x, const void* w) {
  return D % per16 == 0 && F % per16 == 0 && aligned16(x) && aligned16(w);
}

constexpr int kRing = 6;  // slots of the wgmma kernel's ring: 5 steps of (x, w) in flight

dim3 grid_of(int64_t E, int64_t C, int64_t F, int bc, int bf) {
  return dim3(static_cast<unsigned>((F + bf - 1) / bf), static_cast<unsigned>((C + bc - 1) / bc),
              static_cast<unsigned>(E));
}

cudaError_t launch_bf16(const void* x, const void* w, void* y, int64_t E, int64_t C, int64_t D,
                        int64_t F, cudaStream_t stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* yt = static_cast<bf16*>(y);
  if (vector_ok(D, F, 8, x, w)) {
    return wg::launch<kRing>(xt, wt, yt, E, C, D, F, stream);
  } else {
    gmm_bf16_scalar_kernel<<<grid_of(E, C, F, kBC, kBF), kThreads, 0, stream>>>(xt, wt, yt, C,
                                                                                 D, F);
  }
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w, void* y, int64_t E, int64_t C, int64_t D,
                       int64_t F, cudaStream_t stream) {
  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  float* yt = static_cast<float*>(y);
  const dim3 grid = grid_of(E, C, F, kBC, kBF);
  if (vector_ok(D, F, 4, x, w)) {
    gmm_f32_kernel<4><<<grid, kThreads, 0, stream>>>(xt, wt, yt, C, D, F);
  } else {
    gmm_f32_kernel<1><<<grid, kThreads, 0, stream>>>(xt, wt, yt, C, D, F);
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
  if (dtype == kF32) return static_cast<int>(launch_f32(x, w, y, E, C, D, F, st));
  if (dtype == kBF16) return static_cast<int>(launch_bf16(x, w, y, E, C, D, F, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel that moe_gmm_fwd launches for these operands: 0 fp32 with
// scalar loads, 1 fp32 with 16-byte loads, 2 the bf16 scalar kernel, 3 the
// bf16 wgmma kernel; -1 for another dtype.
int moe_gmm_route(int dtype, const void* x, const void* w, int64_t D, int64_t F) {
  if (dtype == kF32) return vector_ok(D, F, 4, x, w) ? 1 : 0;
  if (dtype == kBF16) return vector_ok(D, F, 8, x, w) ? 3 : 2;
  return -1;
}

// Registers, static / dynamic shared memory and local (spill) bytes of the
// kernel that moe_gmm_fwd launches for this dtype with 16-byte copies
// (vector != 0) or without: out[0..3].
int moe_gmm_kernel_info(int dtype, int vector, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  size_t dyn = 0;
  if (dtype == kBF16 && vector) {
    err = cudaFuncGetAttributes(&attr, wg::gmm_wgmma_kernel<kRing>);
    dyn = wg::smem_bytes<kRing>();
  } else if (dtype == kBF16) {
    err = cudaFuncGetAttributes(&attr, gmm_bf16_scalar_kernel);
  } else if (dtype == kF32) {
    err = vector ? cudaFuncGetAttributes(&attr, gmm_f32_kernel<4>)
                 : cudaFuncGetAttributes(&attr, gmm_f32_kernel<1>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(dyn);
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
