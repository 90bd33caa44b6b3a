// Mamba2 chunked SSD forward (from a zero state) for Hopper (sm_90a).
//
// K4 replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel
// (launched by _ssd_impl).  Per chunk of Q positions of one (b, h) stream
//
//   a     = dt * A,  cs = cumsum(a)                        (Q,)
//   L     = exp(cs_i - cs_j) for i >= j, else 0            (Q, Q)
//   y     = (C B^T o L) (dt x) + exp(cs) (C state)         (Q, P)
//   state = exp(cs_Q) state + B^T diag(dt exp(cs_Q - cs)) x  (N, P)
//
// The Pallas grid's sequential ("arbitrary") chunk axis becomes a loop
// inside the CTA, which carries the fp32 (N, P) state; the (b, h) axis
// becomes the grid, one CTA per row.  A is read per row (A[b * H + h]), as
// _ssd_impl tiles it to (B*H,): the autograd Function passes A as (B, H) so
// that a vmap over snapshots (one A per lane) folds its lanes into B and
// stays one launch.  The masked upper triangle of L is selected, never
// used: there cs_i - cs_j > 0 and exp overflows to inf (A in -[1, 16], dt
// up to 1, Q = 64 reaches ~1000), and inf * 0 would be NaN.  expf, not
// __expf, and no fast-math.  The within-chunk prefix sum is one thread's
// loop in the plain version's order (a = dt * A, then cumsum, each rounded,
// no fused multiply-add), as the plain version's dim-2 cumsum runs on the
// card.
//
// Two kernels behind one entry point (ssd_scan_route reports the choice):
//
//   ssd_tc_kernel (bf16; Q <= 64, N <= 128 and P <= 64 with N and P
//     multiples of 8; x, B and C 16-byte aligned).  The four products of a
//     chunk run on the tensor cores, mma.sync.m16n8k16 with bf16 operands
//     from ldmatrix and fp32 accumulators.  One CTA of 4 warps per (b, h);
//     each warp owns 16 chunk rows of S = C B^T and y, and N/4 rows of the
//     state.  The chunk is zero-padded in shared memory to the kernel's tile
//     (64 positions, NT = 64 or 128 state columns, 64 head columns): a
//     padded position has dt = 0, so it adds nothing to cs, the state or y.
//     Operands: C, B and x are bf16 inputs and enter exactly.  dt is folded
//     into the masked scores, M = (S o L) diag(dt) (fp32, in registers from
//     S's accumulator), so y = M x + exp(cs) (C state) reads x as it came.
//     The three fp32 operands, M, the state of the chunk's start and the
//     decayed x (dt exp(cs_Q - cs) x), each enter as a bf16 pair hi + lo
//     (lo = bf16(v - hi), ~16 significant bits), each product taking two
//     mma: with one bf16 rounding each, an emulation of this kernel
//     (tests/test_torch_ssd_tc.py) came within 0.7-1.3e-2 of the plain
//     version at small grid shapes, against a tolerance of 2e-2, and 2.7e-2
//     at Mamba2-130M's widths with slow decay (A in -[0.1, 1]).  The state is carried in fp32
//     across chunks in registers, as the accumulator of its own product:
//     scaled by exp(cs_Q), then B^T (decayed x) is accumulated onto it.  S is
//     computed only on the 16-column blocks at or left of each warp's
//     diagonal block.  B, C, x (bf16) and dt (fp32) of chunk c+1 are copied
//     by cp.async into the second of two stages while chunk c computes.
//     Tiles are rows of 16-byte chunks XOR-swizzled by row (chunk k of row r
//     at k ^ (r & 7)), so the 8 rows each ldmatrix reads hit 8 distinct bank
//     groups with no padding, and the decayed x's lo half lives in the
//     state's lo half between the two uses of that: 115,456 bytes of shared
//     memory at NT = 128, which leaves room for two CTAs an SM (228 KB, less
//     1 KB reserved a CTA), and Mamba2-130M's 192 CTAs run as one wave.
//     C B^T does not depend on the head and is recomputed by each of the H
//     CTAs of a batch row: a CTA over a group of G heads would compute it
//     once, but would cut the grid below one CTA an SM at the Mamba2-130M
//     path shape (B * H / G CTAs) and need G copies of the state's pair in
//     shared memory; C B^T is under a fifth of the mma, read from L2.
//   ssd_fwd_kernel (fp32, and any bf16 shape or alignment the tensor-core
//     kernel does not take): the first design, all in fp32 on the CUDA
//     cores out of shared memory (the fp32 tolerance, 2e-5, rules out bf16
//     operands and TF32).  512 threads; per chunk B (rows padded to N+1
//     floats), C and dt*x are staged in fp32, then the masked scores, y and
//     the state, each thread owning whole outputs.  At the path shape it
//     needs ~132 KB of shared memory, so one CTA fits on an SM.
//
// What bounds it: at the Mamba2-130M path shape (B, S, H, P, N, Q) =
// (8, 128, 24, 64, 128, 64) in bf16 one call moves ~13 MB (~4 us at
// 3.35 TB/s) and does ~1 GFLOP, so the bound is bytes; the tensor-core
// kernel is set by latency: each CTA walks its S / Q chunks in sequence,
// with a serial prefix sum and five barriers per chunk.  On an H100 80GB
// HBM3 at 700 W (chip_smoke.py) it took ~0.020 ms of device time there
// (5x the byte bound; the CUDA-core kernel 0.30 ms, the plain version
// 0.21 ms).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The entry point returns cudaGetLastError() of its launch, or the error of
// cudaFuncSetAttribute when the shared memory it asks for is refused.  No
// atomics: two launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // what one block may opt in to on sm_90

enum DType : int { kF32 = 0, kBF16 = 1 };

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ------------------------------------------------------------------ //
// ssd_fwd_kernel: fp32 math on the CUDA cores
// ------------------------------------------------------------------ //
namespace simt {

constexpr int kThreads = 512;

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

// must agree with repro_torch/kernels/ssd_scan.py:smem_bytes
inline size_t smem_bytes(int64_t Q, int64_t N, int64_t P) {
  // state (N, P), B (Q, N+1), C (Q, N), dt*x (Q, P), scores (Q, Q),
  // dt, cs and the decay to the chunk's end (Q each)
  return sizeof(float) *
         static_cast<size_t>(N * P + Q * (N + 1) + Q * N + Q * P + Q * Q + 3 * Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state_out,
               int64_t S, int64_t H, int64_t P, int64_t N, int64_t Q) {
  extern __shared__ float smem[];
  const int64_t Np = N + 1;
  float* st = smem;          // [N][P]   carried state
  float* bs = st + N * P;    // [Q][N+1] B
  float* cm = bs + Q * Np;   // [Q][N]   C
  float* xd = cm + Q * N;    // [Q][P]   dt * x
  float* sc = xd + Q * P;    // [Q][Q]   (C B^T) o L
  float* dts = sc + Q * Q;   // [Q]      dt
  float* cs = dts + Q;       // [Q]      cumsum(dt * A)
  float* dec = cs + Q;       // [Q]      exp(cs[Q-1] - cs[j])

  const int64_t row = blockIdx.x;  // b * H + h
  const int64_t b = row / H, h = row - (row / H) * H;
  const float a_h = A[row];
  const int tid = threadIdx.x;

  for (int64_t i = tid; i < N * P; i += kThreads) st[i] = 0.0f;

  for (int64_t c0 = 0; c0 < S; c0 += Q) {
    // stage the chunk: dt, B and C, then dt * x (reads dts)
    for (int64_t j = tid; j < Q; j += kThreads) dts[j] = dt[(b * S + c0 + j) * H + h];
    for (int64_t i = tid; i < Q * N; i += kThreads) {
      const int64_t j = i / N, n = i - j * N;
      const int64_t src = (b * S + c0 + j) * N + n;
      bs[j * Np + n] = to_f32(Bm[src]);
      cm[i] = to_f32(Cm[src]);
    }
    __syncthreads();
    for (int64_t i = tid; i < Q * P; i += kThreads) {
      const int64_t j = i / P, p = i - j * P;
      xd[i] = dts[j] * to_f32(x[((b * S + c0 + j) * H + h) * P + p]);
    }
    if (tid == 0) {  // the within-chunk prefix sum, in order
      float s = 0.0f;
      for (int64_t j = 0; j < Q; ++j) {
        s = __fadd_rn(s, __fmul_rn(dts[j], a_h));
        cs[j] = s;
      }
    }
    __syncthreads();

    // scores (C B^T) o L and the decay of each position to the chunk's end
    for (int64_t j = tid; j < Q; j += kThreads) dec[j] = expf(cs[Q - 1] - cs[j]);
    for (int64_t i = tid; i < Q * Q; i += kThreads) {
      const int64_t qi = i / Q, qj = i - qi * Q;
      float v = 0.0f;
      if (qj <= qi) {  // select: the masked entries never reach expf
        const float* cr = cm + qi * N;
        const float* br = bs + qj * Np;
        float d = 0.0f;
        for (int64_t n = 0; n < N; ++n) d = fmaf(cr[n], br[n], d);
        v = d * expf(cs[qi] - cs[qj]);
      }
      sc[i] = v;
    }
    __syncthreads();

    // y = scores (dt x) + exp(cs) (C state), with the state of the chunk's start
    for (int64_t i = tid; i < Q * P; i += kThreads) {
      const int64_t qi = i / P, p = i - qi * P;
      const float* sr = sc + qi * Q;
      float yd = 0.0f;
      for (int64_t j = 0; j <= qi; ++j) yd = fmaf(sr[j], xd[j * P + p], yd);
      const float* cr = cm + qi * N;
      float yo = 0.0f;
      for (int64_t n = 0; n < N; ++n) yo = fmaf(cr[n], st[n * P + p], yo);
      y[((b * S + c0 + qi) * H + h) * P + p] = from_f32<T>(yd + expf(cs[qi]) * yo);
    }
    __syncthreads();

    // state <- exp(cs_Q) state + B^T diag(exp(cs_Q - cs)) (dt x), in place
    const float chunk_decay = expf(cs[Q - 1]);
    for (int64_t i = tid; i < N * P; i += kThreads) {
      const int64_t n = i / P, p = i - n * P;
      float u = 0.0f;
      for (int64_t j = 0; j < Q; ++j) u = fmaf(bs[j * Np + n] * dec[j], xd[j * P + p], u);
      st[i] = chunk_decay * st[i] + u;
    }
    __syncthreads();  // the next chunk overwrites B, C, dt * x
  }

  float* so = state_out + row * N * P;
  for (int64_t i = tid; i < N * P; i += kThreads) so[i] = st[i];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* state, int64_t B, int64_t S, int64_t H,
                   int64_t P, int64_t N, int64_t Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N, P);
  auto kernel = ssd_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(B * H), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------------------------ //
// ssd_tc_kernel: bf16 on the tensor cores
// ------------------------------------------------------------------ //
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 64;  // chunk positions of the tile (Q zero-padded up to it)
constexpr int kPT = 64;  // head columns of the tile (P zero-padded up to it)

// Shared memory, in bytes (must agree with repro_torch/kernels/ssd_scan.py:
// tc_smem_bytes): two stages of C, B (kQT x NT), x (kQT x kPT) in bf16 and
// dt (kQT fp32); the state of the chunk's start as a bf16 pair hi, lo
// (NT x kPT each; lo also holds the decayed x's lo part while the state is
// updated); cs (kQT fp32).
template <int NT>
struct Layout {
  static constexpr int kCB = kQT * NT;  // elements of C or B
  static constexpr int kX = kQT * kPT;  // elements of x
  static constexpr int kSt = NT * kPT;  // elements of one half of the state
  static constexpr size_t kStage = sizeof(bf16) * (2 * kCB + kX) + sizeof(float) * kQT;
  static constexpr size_t kBytes = 2 * kStage + sizeof(bf16) * 2 * kSt + sizeof(float) * kQT;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row r, column c) in a swizzled tile of kCols columns:
// the 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r & 7)
template <int kCols>
__device__ __forceinline__ int swz(int r, int c) {
  return r * kCols + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

// 16 (or 4) bytes global -> shared, asynchronously; src-size 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

// Two fp32 values as bf16 pairs: hi = bf16(v), lo = bf16(v - hi), each
// packed two to a register (hi + lo keeps ~16 of v's 24 significant bits).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Copy chunk c0..c0+Q-1 of row (b, h) into one stage: C and B rows of N
// (of NT), x rows of P (of kPT), dt; positions at or past Q, and columns
// past N or P, are zeros.
template <int NT>
__device__ __forceinline__ void stage_chunk(uint32_t st_u, const bf16* __restrict__ x,
                                            const float* __restrict__ dt,
                                            const bf16* __restrict__ Bm,
                                            const bf16* __restrict__ Cm, int64_t b, int64_t h,
                                            int64_t c0, int64_t S, int64_t H, int P, int N,
                                            int Q) {
  using L = Layout<NT>;
  const uint32_t c_u = st_u, b_u = c_u + sizeof(bf16) * L::kCB;
  const uint32_t x_u = b_u + sizeof(bf16) * L::kCB, dt_u = x_u + sizeof(bf16) * L::kX;
  constexpr int kNC = NT / 8, kPC = kPT / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kQT * kNC; i += kThreads) {
    const int r = i / kNC, k = i % kNC;
    const bool in = r < Q && 8 * k < N;
    const int64_t src = (b * S + c0 + r) * N + 8 * k;
    const uint32_t off = sizeof(bf16) * swz<NT>(r, 8 * k);
    cp_async16(c_u + off, in ? Cm + src : Cm, in);
    cp_async16(b_u + off, in ? Bm + src : Bm, in);
  }
  for (int i = threadIdx.x; i < kQT * kPC; i += kThreads) {
    const int r = i / kPC, k = i % kPC;
    const bool in = r < Q && 8 * k < P;
    const bf16* src = x + ((b * S + c0 + r) * H + h) * P + 8 * k;
    cp_async16(x_u + sizeof(bf16) * swz<kPT>(r, 8 * k), in ? src : x, in);
  }
  for (int r = threadIdx.x; r < kQT; r += kThreads) {
    const bool in = r < Q;
    cp_async4(dt_u + sizeof(float) * r, in ? dt + (b * S + c0 + r) * H + h : dt, in);
  }
}

// acc (16 x kPT) += A (the warp's 16 rows of a kQT x K operand, here C) x
// a K x kPT tile stored [k][p], both from shared memory; kSteps 16-deep
// steps, not unrolled: M's pair, y and the state are live here, and an
// unrolled loop's early loads took the kernel past 255 registers at NT = 128
template <int kACols, int kSteps>
__device__ __forceinline__ void mma_rows_tile(float (&acc)[kPT / 8][4], uint32_t a_u, int a_row,
                                              int a_col, uint32_t t_u, int v_r, int v_c) {
#pragma unroll 1
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_u + sizeof(bf16) * swz<kACols>(a_row, kk * 16 + a_col));
#pragma unroll
    for (int dp = 0; dp < kPT / 16; ++dp) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, t_u + sizeof(bf16) * swz<kPT>(kk * 16 + v_r, dp * 16 + v_c));
      mma16816(acc[2 * dp], af, bfr[0], bfr[1]);
      mma16816(acc[2 * dp + 1], af, bfr[2], bfr[3]);
    }
  }
}

// stacc (the warp's kMT x 16 state rows x kPT) += B^T x a kQT x kPT tile
// stored [j][p]; B is stored [j][n], so its transpose is read by ldmatrix.trans
template <int NT, int kMT>
__device__ __forceinline__ void mma_state(float (&stacc)[kMT][kPT / 8][4], uint32_t b_u,
                                          uint32_t t_u, int n0, int t_r, int t_c, int v_r,
                                          int v_c) {
#pragma unroll
  for (int kk = 0; kk < kQT / 16; ++kk) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      ldsm_x4_t(af[mt], b_u + sizeof(bf16) * swz<NT>(kk * 16 + t_r, n0 + mt * 16 + t_c));
    }
#pragma unroll
    for (int dp = 0; dp < kPT / 16; ++dp) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, t_u + sizeof(bf16) * swz<kPT>(kk * 16 + v_r, dp * 16 + v_c));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma16816(stacc[mt][2 * dp], af[mt], bfr[0], bfr[1]);
        mma16816(stacc[mt][2 * dp + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, bf16* __restrict__ y, float* __restrict__ state_out,
              int64_t S, int64_t H, int P, int N, int Q) {
  using L = Layout<NT>;
  constexpr int kMT = NT / 64;  // 16-row m-tiles of the state a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base_u = smem_u32(smem_raw);
  bf16* sthi = reinterpret_cast<bf16*>(smem_raw + 2 * L::kStage);  // [NT][kPT] state, hi
  bf16* stlo = sthi + L::kSt;                                        // [NT][kPT] state, lo
  float* cs = reinterpret_cast<float*>(stlo + L::kSt);               // [kQT] cumsum(dt A)
  const uint32_t sthi_u = smem_u32(sthi), stlo_u = smem_u32(stlo);

  const int64_t row = blockIdx.x;  // b * H + h
  const int64_t b = row / H, h = row - b * H;
  const float a_h = A[row];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, lane in quad
  const int r0 = warp * 16;                // the warp's chunk rows of S and y
  const int n0 = warp * (NT / 4);          // the warp's state rows
  const int nc = static_cast<int>(S / Q);

  // this lane's ldmatrix row / column offsets: A operand (non-trans), B
  // operand stored [n][k] (non-trans), B operand stored [k][n] (trans), A
  // operand stored [k][m] (trans)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = (lane >> 4) * 8;
  const int b_r = (lane & 7) + ((lane >> 4) << 3), b_c = ((lane >> 3) & 1) * 8;
  const int v_r = (lane & 7) + ((lane >> 3) & 1) * 8, v_c = (lane >> 4) * 8;
  const int t_r = (lane & 7) + ((lane >> 4) & 1) * 8, t_c = ((lane >> 3) & 1) * 8;

  float stacc[kMT][kPT / 8][4];  // the carried fp32 state
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kPT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) stacc[mt][n][e] = 0.0f;

  stage_chunk<NT>(base_u, x, dt, Bm, Cm, b, h, 0, S, H, P, N, Q);
  cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    const int s = c & 1;
    const uint32_t c_u = base_u + s * L::kStage, b_u = c_u + sizeof(bf16) * L::kCB;
    const uint32_t x_u = b_u + sizeof(bf16) * L::kCB;
    bf16* xs = reinterpret_cast<bf16*>(smem_raw + s * L::kStage) + 2 * L::kCB;
    const float* dts = reinterpret_cast<const float*>(xs + L::kX);
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c-1
    if (c + 1 < nc) {  // the next chunk into the other stage, while this one computes
      stage_chunk<NT>(base_u + (s ^ 1) * L::kStage, x, dt, Bm, Cm, b, h,
                      static_cast<int64_t>(c + 1) * Q, S, H, P, N, Q);
    }
    cp_async_commit();

    if (tid == 0) {  // the within-chunk prefix sum, in order
      float v[kQT];
#pragma unroll
      for (int j = 0; j < kQT; ++j) v[j] = __fmul_rn(dts[j], a_h);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        acc = __fadd_rn(acc, v[j]);
        cs[j] = acc;
      }
    }

    // S = C B^T for the warp's 16 rows, on the 16-column blocks at or left
    // of its diagonal block (the rest of the chunk is masked)
    float sacc[kQT / 8][4];
#pragma unroll
    for (int n = 0; n < kQT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, c_u + sizeof(bf16) * swz<NT>(r0 + a_r, kk * 16 + a_c));
#pragma unroll
      for (int np = 0; np < kQT / 16; ++np) {
        if (np <= warp) {
          uint32_t bfr[4];
          ldsm_x4(bfr, b_u + sizeof(bf16) * swz<NT>(np * 16 + b_r, kk * 16 + b_c));
          mma16816(sacc[2 * np], af, bfr[0], bfr[1]);
          mma16816(sacc[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // cs is in shared memory

    // M = (S o L) diag(dt), selected (never exp of a masked entry), as the
    // A operand of M x: a bf16 pair hi + lo.  The accumulator's n-tiles
    // 2k, 2k+1 are the A fragment of k-step k.
    const int i0 = r0 + g, i1 = i0 + 8;
    const float ci0 = cs[i0], ci1 = cs[i1], cs_last = cs[kQT - 1];
    uint32_t mhi[kQT / 16][4], mlo[kQT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = (2 * kk + hf) * 8 + 2 * tq, n = 2 * kk + hf;
        const float cj0 = cs[j], cj1 = cs[j + 1], d0 = dts[j], d1 = dts[j + 1];
        const float m0 = j <= i0 ? sacc[n][0] * expf(ci0 - cj0) * d0 : 0.0f;
        const float m1 = j + 1 <= i0 ? sacc[n][1] * expf(ci0 - cj1) * d1 : 0.0f;
        const float m2 = j <= i1 ? sacc[n][2] * expf(ci1 - cj0) * d0 : 0.0f;
        const float m3 = j + 1 <= i1 ? sacc[n][3] * expf(ci1 - cj1) * d1 : 0.0f;
        split2(m0, m1, mhi[kk][2 * hf], mlo[kk][2 * hf]);
        split2(m2, m3, mhi[kk][2 * hf + 1], mlo[kk][2 * hf + 1]);
      }
    }

    // y = exp(cs) (C state) + M x, with the state of the chunk's start
    float yacc[kPT / 8][4];
#pragma unroll
    for (int n = 0; n < kPT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[n][e] = 0.0f;
    if (c > 0) {
      mma_rows_tile<NT, NT / 16>(yacc, c_u, r0 + a_r, a_c, sthi_u, v_r, v_c);
      mma_rows_tile<NT, NT / 16>(yacc, c_u, r0 + a_r, a_c, stlo_u, v_r, v_c);
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int n = 0; n < kPT / 8; ++n) {
        yacc[n][0] *= e0;
        yacc[n][1] *= e0;
        yacc[n][2] *= e1;
        yacc[n][3] *= e1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk) {
      if (kk <= warp) {
#pragma unroll
        for (int dp = 0; dp < kPT / 16; ++dp) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, x_u + sizeof(bf16) * swz<kPT>(kk * 16 + v_r, dp * 16 + v_c));
          mma16816(yacc[2 * dp], mhi[kk], bfr[0], bfr[1]);
          mma16816(yacc[2 * dp + 1], mhi[kk], bfr[2], bfr[3]);
          mma16816(yacc[2 * dp], mlo[kk], bfr[0], bfr[1]);
          mma16816(yacc[2 * dp + 1], mlo[kk], bfr[2], bfr[3]);
        }
      }
    }
    {
      const int64_t c0 = static_cast<int64_t>(c) * Q;
      bf16* yb = y + ((b * S + c0) * H + h) * P;
      const int64_t ys = H * P;  // between positions
#pragma unroll
      for (int n = 0; n < kPT / 8; ++n) {
        const int col = n * 8 + 2 * tq;
        if (col < P) {
          if (i0 < Q) {
            *reinterpret_cast<uint32_t*>(yb + i0 * ys + col) = pack_bf16(yacc[n][0], yacc[n][1]);
          }
          if (i1 < Q) {
            *reinterpret_cast<uint32_t*>(yb + i1 * ys + col) = pack_bf16(yacc[n][2], yacc[n][3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with x and the state's pair

    // the decayed x, dt exp(cs_Q - cs) x, as a bf16 pair: hi over x in
    // place, lo in the state's lo half
    for (int i = tid; i < kQT * (kPT / 8); i += kThreads) {
      const int j = i / (kPT / 8), k = i % (kPT / 8);
      const int off = swz<kPT>(j, 8 * k);
      const float wd = dts[j] * expf(cs_last - cs[j]);
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + off);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 ohi, olo;
      uint32_t* ph = reinterpret_cast<uint32_t*>(&ohi);
      uint32_t* pl = reinterpret_cast<uint32_t*>(&olo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xv[e]);
        split2(wd * f.x, wd * f.y, ph[e], pl[e]);
      }
      *reinterpret_cast<uint4*>(xs + off) = ohi;
      *reinterpret_cast<uint4*>(stlo + off) = olo;
    }
    const float chunk_decay = expf(cs_last);
    __syncthreads();  // the decayed x's pair is in shared memory

    // state <- exp(cs_Q) state + B^T (decayed x), fp32 in registers
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kPT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) stacc[mt][n][e] *= chunk_decay;
    mma_state<NT, kMT>(stacc, b_u, x_u, n0, t_r, t_c, v_r, v_c);
    mma_state<NT, kMT>(stacc, b_u, stlo_u, n0, t_r, t_c, v_r, v_c);
    if (c + 1 < nc) {  // the pair the next chunk's C state reads
      __syncthreads();  // every warp is done with the decayed x's lo half
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int n = n0 + mt * 16 + g;
#pragma unroll
        for (int nt = 0; nt < kPT / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          uint32_t hi, lo;
          split2(stacc[mt][nt][0], stacc[mt][nt][1], hi, lo);
          *reinterpret_cast<uint32_t*>(sthi + swz<kPT>(n, col)) = hi;
          *reinterpret_cast<uint32_t*>(stlo + swz<kPT>(n, col)) = lo;
          split2(stacc[mt][nt][2], stacc[mt][nt][3], hi, lo);
          *reinterpret_cast<uint32_t*>(sthi + swz<kPT>(n + 8, col)) = hi;
          *reinterpret_cast<uint32_t*>(stlo + swz<kPT>(n + 8, col)) = lo;
        }
      }
    }
  }

  // the final state, fp32
  float* so = state_out + row * static_cast<int64_t>(N) * P;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int n = n0 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kPT / 8; ++nt) {
      const int col = nt * 8 + 2 * tq;
      if (col < P) {
        if (n < N) {
          *reinterpret_cast<float2*>(so + n * P + col) =
              make_float2(stacc[mt][nt][0], stacc[mt][nt][1]);
        }
        if (n + 8 < N) {
          *reinterpret_cast<float2*>(so + (n + 8) * P + col) =
              make_float2(stacc[mt][nt][2], stacc[mt][nt][3]);
        }
      }
    }
  }
}

template <int NT>
cudaError_t prepare() {
  return cudaFuncSetAttribute(ssd_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<NT>::kBytes));
}

template <int NT>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* state, int64_t B, int64_t S, int64_t H,
                   int64_t P, int64_t N, int64_t Q, cudaStream_t stream) {
  const cudaError_t err = prepare<NT>();
  if (err != cudaSuccess) return err;
  ssd_tc_kernel<NT><<<static_cast<unsigned>(B * H), kThreads, Layout<NT>::kBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
      static_cast<float*>(state), S, H, static_cast<int>(P), static_cast<int>(N),
      static_cast<int>(Q));
  return cudaGetLastError();
}

}  // namespace tc

// The tensor-core kernel takes bf16 with Q <= 64, N <= 128 and P <= 64,
// N and P multiples of 8 (16-byte rows), and x, B and C 16-byte aligned;
// ssd_scan_route reports the choice (the Python mirror, for the CPU tests,
// is repro_torch/kernels/ssd_scan.py:route).
bool tc_path(int dtype, const void* x, const void* Bm, const void* Cm, int64_t Q, int64_t N,
             int64_t P) {
  return dtype == kBF16 && Q >= 1 && Q <= tc::kQT && N >= 8 && N <= 128 && N % 8 == 0 &&
         P >= 8 && P <= tc::kPT && P % 8 == 0 && aligned16(x) && aligned16(Bm) &&
         aligned16(Cm);
}

}  // namespace

extern "C" {

// x (B,S,H,P), Bm/Cm (B,S,N) and y (B,S,H,P) in one dtype; dt (B,S,H) and
// A (B,H) float32; state (B,H,N,P) float32.  All contiguous.  S % Q == 0.
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int64_t B, int64_t S, int64_t H,
                 int64_t P, int64_t N, int64_t Q, void* stream) {
  if (Q < 1 || S < 1 || S % Q != 0 || P < 1 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tc = tc_path(dtype, x, Bm, Cm, Q, N, P);
  if (!tc && simt::smem_bytes(Q, N, P) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tc) {
    err = N <= 64 ? tc::launch<64>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st)
                  : tc::launch<128>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  } else if (dtype == kF32) {
    err = simt::launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  } else if (dtype == kBF16) {
    err = simt::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// 1 when ssd_scan_fwd takes the tensor-core kernel for these operands, 0
// when it takes the CUDA-core kernel.
int ssd_scan_route(int dtype, const void* x, const void* Bm, const void* Cm, int64_t Q,
                   int64_t N, int64_t P) {
  return tc_path(dtype, x, Bm, Cm, Q, N, P) ? 1 : 0;
}

// Registers, static / dynamic shared memory, local (spill) bytes and the
// CTAs an SM holds of the kernel that ssd_scan_fwd launches for this dtype
// and (Q, N, P), operands taken as aligned: out[0..4]; out[5] is 1 when
// that kernel is the tensor-core one, 0 for the CUDA-core one.
int ssd_scan_kernel_info(int dtype, int64_t Q, int64_t N, int64_t P, int* out) {
  if (dtype != kF32 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  size_t dyn;
  int threads;
  cudaError_t err = cudaSuccess;
  const bool tc = tc_path(dtype, nullptr, nullptr, nullptr, Q, N, P);
  if (tc) {
    fn = N <= 64 ? (const void*)tc::ssd_tc_kernel<64> : (const void*)tc::ssd_tc_kernel<128>;
    dyn = N <= 64 ? tc::Layout<64>::kBytes : tc::Layout<128>::kBytes;
    threads = tc::kThreads;
    err = N <= 64 ? tc::prepare<64>() : tc::prepare<128>();
  } else {
    dyn = simt::smem_bytes(Q, N, P);
    if (dyn > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    fn = dtype == kF32 ? (const void*)simt::ssd_fwd_kernel<float>
                       : (const void*)simt::ssd_fwd_kernel<__nv_bfloat16>;
    threads = simt::kThreads;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(dyn);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  out[5] = tc ? 1 : 0;
  return 0;
}

}  // extern "C"
