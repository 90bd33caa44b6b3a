// Mamba2 chunked SSD forward (from a zero state) for Hopper (sm_90a).
//
// K4 replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel
// (launched by _ssd_impl).  Same arithmetic, all in fp32: per chunk of Q
// positions of one (b, h) stream
//
//   a     = dt * A,  cs = cumsum(a)                        (Q,)
//   L     = exp(cs_i - cs_j) for i >= j, else 0            (Q, Q)
//   y     = (C B^T o L) (dt x) + exp(cs) (C state)         (Q, P)
//   state = exp(cs_Q) state + B^T diag(dt exp(cs_Q - cs)) x  (N, P)
//
// The Pallas grid's sequential ("arbitrary") chunk axis becomes a loop
// inside the CTA, which carries the fp32 (N, P) state in shared memory; the
// (b, h) axis becomes the grid, one CTA per row.  A is read per row
// (A[b * H + h]), as _ssd_impl tiles it to (B*H,): the autograd Function
// passes A as (B, H) so that a vmap over snapshots (one A per lane) folds
// its lanes into B and stays one launch.  The masked upper triangle of L is
// selected, never computed: there cs_i - cs_j > 0 and exp overflows to inf
// (A in -[1, 16], dt up to 1, Q = 64 reaches ~1000), and inf * 0 would be
// NaN.  expf, not __expf, and no fast-math: the fp32 tolerance is 2e-5.
//
// What bounds it: at the Mamba2-130M path shape (B, S, H, P, N, Q) =
// (8, 128, 24, 64, 128, 64) in bf16 one call moves ~13 MB (~4 us at
// 3.35 TB/s) and does ~1 GFLOP, so the bound is bytes; this first version
// is simple instead of fast: all products run on the CUDA cores out of
// shared memory (no tensor cores), and at ~132 KB of shared memory per CTA
// one CTA fits on an SM.  Per chunk the CTA stages B (rows padded to N+1
// floats, so lanes walking j hit distinct banks), C and dt*x in fp32, forms
// the (Q, Q) masked scores, then y, then the new state; each thread owns
// whole outputs, so the state is updated in place.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The entry point returns cudaGetLastError() of its launch, or the error of
// cudaFuncSetAttribute when the shared memory it asks for is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;  // what one block may opt in to on sm_90

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
    if (tid == 0) {  // the within-chunk prefix sum, in order, rounded as
      float s = 0.0f;  // the plain version's a = dt * A, then cumsum, round
      for (int64_t j = 0; j < Q; ++j) {  // (no fused multiply-add)
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

}  // namespace

extern "C" {

// x (B,S,H,P), Bm/Cm (B,S,N) and y (B,S,H,P) in one dtype; dt (B,S,H) and
// A (B,H) float32; state (B,H,N,P) float32.  All contiguous.  S % Q == 0.
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int64_t B, int64_t S, int64_t H,
                 int64_t P, int64_t N, int64_t Q, void* stream) {
  if (Q < 1 || S < 1 || S % Q != 0 || P < 1 || N < 1 || smem_bytes(Q, N, P) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * H == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  } else if (dtype == kBF16) {
    err = launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, Q, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
