// Fused Generalized-AsyncSGD server updates for Hopper (sm_90a).
//
// K1  weighted_update (plain and momentum) replaces the TPU kernel
//     repro/kernels/weighted_update.py:weighted_update (bodies _kernel_plain
//     and _kernel):  w' = w - s * (momentum * m + g),  m' = momentum * m + g,
//     g rounded to w's dtype first.  JAX applies it to a tree one leaf at a
//     time (tree_weighted_update); here one launch covers every leaf of an
//     event.
// K2  block_prefix_update replaces repro/kernels/weighted_update.py:
//     block_prefix_update (body _block_kernel):  W_i = w - sum_{j<=i} D_j,
//     snaps[slot_i] = W_i in place, w' = W_{E-1}.
// K6  block_scatter_rows replaces repro/kernels/weighted_update.py:
//     block_scatter_rows (body _scatter_kernel): the lane-sharded engine's
//     scatter of precomputed iterates, snaps[slot_i] = W_i in place,
//     w' = W_{E-1}.
//
// All three are elementwise passes with O(1) flops per byte, so at large
// widths device-memory bandwidth bounds them, and at the MLP's width
// (P = 26,122 parameters, 26,624 once padded) the latency of one launch.
//
// K1 (weighted_update_leaves_kernel).  At the MLP one event's six fp32
// leaves move 313 KB, well under a microsecond at 3.35 TB/s: one launch's
// latency bounds it, so the whole event is one launch, and the host cost
// of a launch per leaf (the ctypes call, the allocation, the stream lookup)
// is paid once.  At the LM widths it is bound by bytes:
// sum of numel * (2 * esz(w) + esz(g)), plus 8 B a value with momentum
// (Granite-3.0-2B's 11 bf16 leaves: 15.2 GB, 4.54 ms).  So:
//   - The leaves travel in a table passed by value as a __grid_constant__
//     parameter (kMaxLeaves = 64 of them in 3,600 B, inside the 4 KB of
//     parameters): no host-to-device copy, no table in device memory.  A
//     list of more leaves takes further launches.
//   - The work is cut into chunks of kLeafThreads * kLeafUnroll accesses.
//     CTA b finds its leaf by a binary search over the table's first-chunk
//     prefix; the grid is the number of chunks, sized to the work and never
//     capped (the MLP: 10 CTAs; Granite: 309,270).  The Python mirror of the split, for
//     the CPU tests, is repro_torch/kernels/weighted_update.py:leaf_plan.
//   - 16-byte accesses (8 bf16 or 4 fp32 values of the widest operand) for
//     a leaf whose operands are all 16-byte aligned; its last partial vector
//     takes one value an access.  Every leaf starts at its own base, so a
//     vector body and a short tail are right here (unlike K6's rows).  A
//     leaf with an operand off the 16-byte grid (a view with a storage
//     offset) takes one value an access.
//   - Each thread loads kLeafUnroll vectors of every operand before the
//     math, so enough bytes are in flight to stream at the card's rate.
//   - g is rounded to w's dtype in registers (__float2bfloat16_rn, the rule
//     of g.to(w.dtype)), not by a separate device op.
//   - Across cells (the scenario matrix, B runs in lockstep) each cell's
//     view of a (B, ...) leaf is a leaf of the table, and the table's scale
//     pointer holds B float32 scales: a leaf reads scale[cell], its cell
//     index carried in the table beside its dtype codes.  The MLP's 27 x 6
//     leaves take ceil(162 / 64) = 3 launches an event.  A cell view whose
//     operands are off the 16-byte grid (a leaf of 10 fp32 values) takes one
//     value an access.
//
// K2 (block_prefix_update_kernel).  At the MLP's ring and block ((65,
// 26,624), E = 8) one launch moves ~1.2 MB, 0.00054 ms of bytes: latency
// bounds it.  At Mamba2-130M's blocked ring ((9, 128,984,064), E = 4) it
// moves 40 * P bytes for an fp32 ring and w (read w and D, write 4 ring rows
// and w'), 1.540 ms, and 28 * P for bf16, 1.078 ms: bytes bound it.  So:
//   - A CTA loads its block's E slots into shared memory once, and lane i
//     stores W_i only when it is live: its slot lies in [0, R) and no later
//     lane has the same slot (K6's rule, live_lanes in Python).  Each
//     distinct ring row is written once, repeated trash-row lanes write
//     nothing, and last-writer-wins needs no order between threads.  Every
//     lane's D still enters the prefix sum, as the TPU kernel reads it.
//   - A thread owns one vector of columns: 16 bytes of ring values (4 fp32,
//     8 bf16), D read 4 columns a 16-byte load.  A P that is not a multiple
//     of the vector, or an operand off the 16-byte grid, takes one value an
//     access (K6's width rule: the rows then start off the grid at offsets
//     that differ from row to row).  The engine pads P to a multiple of
//     BLOCK_TILE = 1024, so its path always takes the wide form.
//   - The D rows of a group of kPrefixGroup lanes (every lane of the
//     engine's E <= 16 in one or two groups) are loaded before the adds; the
//     first group and w are in flight while the slots arrive.
//   - The sum runs in event order with __fadd_rn, so the rows equal the
//     plain version's bit for bit.  The grid is sized to the work.
//   - The TPU kernel's column tile table (repro/kernels/autotune.py) has no
//     counterpart: this kernel takes any P at one fixed design.
//   - Across cells (the scenario matrix) one launch takes B rings, B w, B
//     blocks of D and B rows of slots, each cell's after the previous
//     cell's: blockIdx.y is the cell, the rest of the design is per cell as
//     above (at B = 1 the grid and the arithmetic are those of one block).
//
// K6 is a copy and a cast.  On a Mamba2-130M ring (E = 4 rows of 129 M fp32
// columns) one call moves 4.6 GB and is bound by bytes; at the MLP's ring
// and block (E = 8 of 26,624 columns, 3 lanes padded onto the trash row)
// it moves ~1.4 MB and is bound by latency: a launch and one round trip to
// memory.  So it does no more than the bytes need, in one pass:
//   - A CTA takes one lane i (blockIdx.z) and a span of its columns.  It
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
//   - Across cells (the lane-sharded scenario matrix) one launch takes B
//     rings, B blocks of W and slots and B rows of w', each cell's after
//     the previous cell's: blockIdx.y is the cell and blockIdx.z the lane,
//     the rest of the design is per cell as above (at B = 1 the grid and
//     the stores are those of one block).
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

#include <type_traits>

namespace {

constexpr int64_t kMaxLanes = 4096;  // K2's and K6's slots live in shared memory
constexpr int64_t kMaxGridY = 65535;  // K2's and K6's cells: one row of the grid each

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

// VEC values of type T, as wide as one access may be (16 bytes at most)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// ------------------------------------------------------------------ K1
constexpr int kLeafThreads = 256;
constexpr int kLeafUnroll = 4;  // vectors of each operand a thread loads before the math
constexpr int kMaxLeaves = 64;
constexpr int kLeafFields = 7;  // int64 fields of a leaf row from the host (see below)
constexpr int kMaxCells = 65536;  // a leaf's cell index is 16 bits

struct LeafArg {
  const void* w;
  const void* g;
  void* out;
  const float* m;  // the momentum buffer (K1b), else null
  float* out_m;
  int64_t n;       // values, > 0
  int32_t first;   // the leaf's first chunk (CTA) in its launch
  uint16_t cell;   // the leaf's cell: its update scale is scale[cell]
  int8_t dtypes;   // w's dtype code | g's << 1
  int8_t vec;      // values an access: 16 bytes of the widest operand, or 1
};

struct LeafTable {
  LeafArg leaf[kMaxLeaves];
  const float* scale;  // one float32 a cell, on the device
  float momentum;
  int32_t count;
};
static_assert(sizeof(LeafTable) <= 4096, "K1's leaf table must fit the 4 KB of kernel parameters");

// g as the update sees it: rounded to w's dtype first (RNE, g.to(w.dtype))
template <typename W, typename G>
__device__ __forceinline__ float g_in_w_dtype(G g) {
  if constexpr (std::is_same<W, __nv_bfloat16>::value && std::is_same<G, float>::value) {
    return __bfloat162float(__float2bfloat16_rn(g));
  } else {
    return to_f32(g);
  }
}

// One chunk of one leaf: thread t takes vectors c * T * U + u * T + t,
// u < U (T = kLeafThreads, U = kLeafUnroll), all loads before the math.
// A vector that runs past n (the leaf's last, partial one) moves one value
// an access.
template <typename W, typename G, int VEC, bool kMomentum>
__device__ __forceinline__ void update_chunk(const LeafArg& L, int64_t chunk, float s,
                                             float beta) {
  using PW = Pack<W, VEC>;
  using PG = Pack<G, VEC>;
  using PM = Pack<float, VEC>;
  const W* w = static_cast<const W*>(L.w);
  const G* g = static_cast<const G*>(L.g);
  const int64_t n = L.n;
  const int64_t v0 = chunk * (kLeafThreads * kLeafUnroll) + threadIdx.x;
  PW wv[kLeafUnroll];
  PG gv[kLeafUnroll];
  PM mv[kLeafUnroll];
#pragma unroll
  for (int u = 0; u < kLeafUnroll; ++u) {
    const int64_t v = v0 + static_cast<int64_t>(u) * kLeafThreads;
    const int64_t e = v * VEC;
    if (e + VEC <= n) {
      wv[u] = reinterpret_cast<const PW*>(w)[v];
      gv[u] = reinterpret_cast<const PG*>(g)[v];
      if constexpr (kMomentum) mv[u] = reinterpret_cast<const PM*>(L.m)[v];
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const bool in = e + k < n;
        wv[u].v[k] = in ? w[e + k] : from_f32<W>(0.0f);
        gv[u].v[k] = in ? g[e + k] : from_f32<G>(0.0f);
        if constexpr (kMomentum) mv[u].v[k] = in ? L.m[e + k] : 0.0f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kLeafUnroll; ++u) {
    const int64_t v = v0 + static_cast<int64_t>(u) * kLeafThreads;
    const int64_t e = v * VEC;
    if (e >= n) break;
    PW o;
    PM om;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float step = g_in_w_dtype<W>(gv[u].v[k]);
      if constexpr (kMomentum) {
        step = __fadd_rn(__fmul_rn(beta, mv[u].v[k]), step);
        om.v[k] = step;
      }
      o.v[k] = from_f32<W>(__fsub_rn(to_f32(wv[u].v[k]), __fmul_rn(s, step)));
    }
    if (e + VEC <= n) {
      reinterpret_cast<PW*>(L.out)[v] = o;
      if constexpr (kMomentum) reinterpret_cast<PM*>(L.out_m)[v] = om;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (e + k < n) {
          static_cast<W*>(L.out)[e + k] = o.v[k];
          if constexpr (kMomentum) L.out_m[e + k] = om.v[k];
        }
      }
    }
  }
}

template <typename W, typename G, int WIDE, bool kMomentum>
__device__ __forceinline__ void update_leaf_chunk(const LeafArg& L, int64_t chunk, float s,
                                                  float beta) {
  if (L.vec == 1) {
    update_chunk<W, G, 1, kMomentum>(L, chunk, s, beta);
  } else {
    update_chunk<W, G, WIDE, kMomentum>(L, chunk, s, beta);
  }
}

// K1 (see the note above): CTA b takes chunk b - first of the leaf whose
// first chunk is the largest that is <= b.
template <bool kMomentum>
__global__ void __launch_bounds__(kLeafThreads)
weighted_update_leaves_kernel(const __grid_constant__ LeafTable t) {
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].first <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const LeafArg L = t.leaf[lo];
  const int64_t chunk = b - L.first;
  const float s = t.scale[L.cell];
  const float beta = t.momentum;
  const int w_dtype = L.dtypes & 1, g_dtype = L.dtypes >> 1;
  if (w_dtype == kF32) {
    if (g_dtype == kF32) {
      update_leaf_chunk<float, float, 4, kMomentum>(L, chunk, s, beta);
    } else {
      update_leaf_chunk<float, __nv_bfloat16, 4, kMomentum>(L, chunk, s, beta);
    }
  } else if (g_dtype == kF32) {
    update_leaf_chunk<__nv_bfloat16, float, 4, kMomentum>(L, chunk, s, beta);
  } else {
    update_leaf_chunk<__nv_bfloat16, __nv_bfloat16, kMomentum ? 4 : 8, kMomentum>(L, chunk, s,
                                                                                  beta);
  }
}

// The values a thread of K1 moves per access on a leaf: 16 bytes of its
// widest operand (fp32 w, g or the momentum buffer: 4; all bf16: 8) when
// every operand is 16-byte aligned, else 1.
int leaf_vec(int w_dtype, int g_dtype, bool momentum, const void* const* ptrs) {
  const int widest = (w_dtype == kF32 || g_dtype == kF32 || momentum) ? 4 : 2;
  for (int k = 0; k < (momentum ? 5 : 3); ++k) {
    if (!aligned_to(ptrs[k], 16)) return 1;
  }
  return 16 / widest;
}

// ------------------------------------------------------------------ K2
// 64 threads a CTA: at the MLP's ring that is 104 CTAs (fp32) or 52 (bf16),
// so a block's D spreads over as many SMs.  With 256 threads (26 / 13 CTAs)
// each SM pulled up to 65 KB of D alone, and the kernel took 4-38% longer
// than one thread per column walking the events (H100 80GB HBM3, 700 W).
constexpr int kPrefixThreads = 64;
constexpr int kPrefixGroup = 8;  // rows of D a thread holds before the adds

// K2 (see the note above): thread v of row x of the grid owns columns
// [v * VEC, (v + 1) * VEC) of cell blockIdx.y, whose ring, w, D, slots and
// w' follow the previous cell's.  Shared memory: the cell's E slots, then
// the ring row each lane stores (-1: none).
template <typename S, typename W, int VEC>
__global__ void __launch_bounds__(kPrefixThreads)
block_prefix_update_kernel(S* __restrict__ snaps, const W* __restrict__ w,
                           const float* __restrict__ D, const int64_t* __restrict__ slots,
                           W* __restrict__ w_out, int64_t R, int64_t P, int64_t E) {
  const int64_t cell = blockIdx.y;
  snaps += cell * R * P;
  w += cell * P;
  D += cell * E * P;
  slots += cell * E;
  w_out += cell * P;
  extern __shared__ int64_t slot_sh[];
  int32_t* row_sh = reinterpret_cast<int32_t*>(slot_sh + E);
  using PF = Pack<float, VEC>;
  const int64_t nvec = P / VEC;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kPrefixThreads + threadIdx.x;
  const bool active = v < nvec;
  const PF* Dv = reinterpret_cast<const PF*>(D);
  Pack<W, VEC> wp;
  PF d[kPrefixGroup];
  if (active) {  // w and the first group of D, in flight while the slots arrive
    wp = reinterpret_cast<const Pack<W, VEC>*>(w)[v];
#pragma unroll
    for (int i = 0; i < kPrefixGroup; ++i) {
      if (i < E) d[i] = Dv[i * nvec + v];
    }
  }
  for (int64_t j = threadIdx.x; j < E; j += kPrefixThreads) slot_sh[j] = slots[j];
  __syncthreads();
  for (int64_t j = threadIdx.x; j < E; j += kPrefixThreads) {
    const int64_t row = slot_sh[j];
    bool live = row >= 0 && row < R;
    for (int64_t k = j + 1; live && k < E; ++k) live = slot_sh[k] != row;
    row_sh[j] = live ? static_cast<int32_t>(row) : -1;
  }
  __syncthreads();
  if (!active) return;
  float w0[VEC], acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    w0[k] = to_f32(wp.v[k]);
    acc[k] = 0.0f;
  }
  Pack<S, VEC>* ring = reinterpret_cast<Pack<S, VEC>*>(snaps);
  for (int64_t g0 = 0;;) {
#pragma unroll
    for (int i = 0; i < kPrefixGroup; ++i) {
      if (g0 + i < E) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], d[i].v[k]);
        const int32_t row = row_sh[g0 + i];
        if (row >= 0) {
          Pack<S, VEC> o;
#pragma unroll
          for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<S>(__fsub_rn(w0[k], acc[k]));
          ring[row * nvec + v] = o;
        }
      }
    }
    g0 += kPrefixGroup;
    if (g0 >= E) break;
#pragma unroll
    for (int i = 0; i < kPrefixGroup; ++i) {
      if (g0 + i < E) d[i] = Dv[(g0 + i) * nvec + v];
    }
  }
  Pack<W, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<W>(__fsub_rn(w0[k], acc[k]));
  reinterpret_cast<Pack<W, VEC>*>(w_out)[v] = o;
}

size_t prefix_smem(int64_t E) { return E * (sizeof(int64_t) + sizeof(int32_t)); }

// The columns a thread of K2 owns: 16 bytes of ring values when P is a
// multiple of that and snaps, w and D are 16-byte aligned, else one (w' is
// 16-byte aligned, block_prefix_update checks it).
int prefix_vec(int snap_dtype, const void* snaps, const void* w, const void* D, int64_t P) {
  const int vec = snap_dtype == kF32 ? 4 : 8;
  return P % vec == 0 && aligned_to(snaps, 16) && aligned_to(w, 16) && aligned_to(D, 16) ? vec
                                                                                          : 1;
}

template <typename S, typename W, int VEC>
cudaError_t launch_prefix_vec(void* snaps, const void* w, const void* D, const void* slots,
                              void* w_out, int64_t B, int64_t R, int64_t P, int64_t E,
                              cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((P / VEC + kPrefixThreads - 1) / kPrefixThreads),
                  static_cast<unsigned>(B));
  block_prefix_update_kernel<S, W, VEC><<<grid, kPrefixThreads, prefix_smem(E), stream>>>(
      static_cast<S*>(snaps), static_cast<const W*>(w), static_cast<const float*>(D),
      static_cast<const int64_t*>(slots), static_cast<W*>(w_out), R, P, E);
  return cudaGetLastError();
}

// 16 bytes of ring values a thread access
template <typename S>
constexpr int kWide = 16 / sizeof(S);

template <typename S, typename W>
cudaError_t launch_prefix(void* snaps, const void* w, const void* D, const void* slots,
                          void* w_out, int64_t B, int64_t R, int64_t P, int64_t E, int vec,
                          cudaStream_t stream) {
  return vec == 1
      ? launch_prefix_vec<S, W, 1>(snaps, w, D, slots, w_out, B, R, P, E, stream)
      : launch_prefix_vec<S, W, kWide<S>>(snaps, w, D, slots, w_out, B, R, P, E, stream);
}

// The K2 kernel of this dtype pair and VEC (1 or 16 bytes), for kernel_info.
template <typename S, typename W>
const void* prefix_kernel(int vec) {
  return vec == 1 ? (const void*)block_prefix_update_kernel<S, W, 1>
                  : (const void*)block_prefix_update_kernel<S, W, kWide<S>>;
}

// ------------------------------------------------------------------ K6
// K6 (see the note above): CTA (x, c, i) takes lane i's vectors
// [x * 128 * U, (x + 1) * 128 * U) of cell c, U = kScatterUnroll, 128
// apart in each thread; cell c's ring, W, slots and w' follow cell c-1's.
constexpr int kScatterThreads = 128;
constexpr int kScatterUnroll = 2;

template <typename S, typename W, int VEC>
__global__ void __launch_bounds__(kScatterThreads)
block_scatter_rows_kernel(S* __restrict__ snaps, const float* __restrict__ Wr,
                          const int64_t* __restrict__ slots, W* __restrict__ w_out, int64_t R,
                          int64_t P, int64_t E) {
  extern __shared__ int64_t later[];  // slots of lanes i..E-1
  const int64_t cell = blockIdx.y;
  const int64_t i = blockIdx.z;
  snaps += cell * R * P;
  Wr += cell * E * P;
  slots += cell * E;
  w_out += cell * P;
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

// The ring values a thread of K6 moves per access: 16 bytes of them when P
// is a multiple of that and snaps and W are 16-byte aligned, else one (w'
// is 16-byte aligned, block_scatter_rows checks it).
int scatter_vec(int snap_dtype, const void* snaps, const void* Wr, int64_t P) {
  const int vec = snap_dtype == kF32 ? 4 : 8;
  return P % vec == 0 && aligned_to(snaps, 16) && aligned_to(Wr, 16) ? vec : 1;
}

template <typename S, typename W, int VEC>
cudaError_t launch_scatter_vec(void* snaps, const void* Wr, const void* slots, void* w_out,
                               int64_t B, int64_t R, int64_t P, int64_t E, cudaStream_t stream) {
  const int64_t span = int64_t{kScatterThreads} * kScatterUnroll;
  const dim3 grid(static_cast<unsigned>((P / VEC + span - 1) / span), static_cast<unsigned>(B),
                  static_cast<unsigned>(E));
  block_scatter_rows_kernel<S, W, VEC><<<grid, kScatterThreads, E * sizeof(int64_t), stream>>>(
      static_cast<S*>(snaps), static_cast<const float*>(Wr), static_cast<const int64_t*>(slots),
      static_cast<W*>(w_out), R, P, E);
  return cudaGetLastError();
}

template <typename S, typename W>
cudaError_t launch_scatter(void* snaps, const void* Wr, const void* slots, void* w_out, int64_t B,
                           int64_t R, int64_t P, int64_t E, int vec, cudaStream_t stream) {
  return vec == 1
      ? launch_scatter_vec<S, W, 1>(snaps, Wr, slots, w_out, B, R, P, E, stream)
      : launch_scatter_vec<S, W, kWide<S>>(snaps, Wr, slots, w_out, B, R, P, E, stream);
}

// The K6 kernel of this dtype pair and VEC (1 or 16 bytes), for kernel_info.
template <typename S, typename W>
const void* scatter_kernel(int vec) {
  return vec == 1 ? (const void*)block_scatter_rows_kernel<S, W, 1>
                  : (const void*)block_scatter_rows_kernel<S, W, kWide<S>>;
}

// Registers, static / dynamic shared memory, local (spill) bytes and the
// CTAs an SM holds of a kernel at this block size and dynamic shared memory.
int kernel_attrs(const void* fn, int threads, size_t dyn, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(dyn);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  return 0;
}

bool valid_pair(int snap_dtype, int w_dtype) {
  return (snap_dtype == kF32 || snap_dtype == kBF16) && (w_dtype == kF32 || w_dtype == kBF16);
}

}  // namespace

extern "C" {

// K1 over `count` leaves, one launch.  rows[i * 7 + k]: the pointers of w,
// g, w' and (with momentum) m and m', the leaf's numel (> 0), and its codes
// w | g << 8 | cell << 16 (dtype codes, the cell whose scale it takes).
// scale: n_scales float32 on the device, one a cell.
int weighted_update_leaves(const int64_t* rows, int count, const void* scale, int n_scales,
                           float momentum, int with_momentum, void* stream) {
  if (count < 1 || count > kMaxLeaves || scale == nullptr || n_scales < 1 ||
      n_scales > kMaxCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool mom = with_momentum != 0;
  LeafTable t = {};
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* r = rows + static_cast<int64_t>(i) * kLeafFields;
    const int w_dtype = static_cast<int>(r[6] & 0xff);
    const int g_dtype = static_cast<int>((r[6] >> 8) & 0xff);
    const int64_t cell = r[6] >> 16;
    const void* ptrs[5] = {reinterpret_cast<const void*>(r[0]), reinterpret_cast<const void*>(r[1]),
                           reinterpret_cast<const void*>(r[2]), reinterpret_cast<const void*>(r[3]),
                           reinterpret_cast<const void*>(r[4])};
    if (!valid_pair(w_dtype, g_dtype) || r[5] <= 0 || cell < 0 || cell >= n_scales ||
        !ptrs[0] || !ptrs[1] || !ptrs[2] || (mom && (!ptrs[3] || !ptrs[4]))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    LeafArg& L = t.leaf[i];
    L.w = ptrs[0];
    L.g = ptrs[1];
    L.out = const_cast<void*>(ptrs[2]);
    L.m = mom ? static_cast<const float*>(ptrs[3]) : nullptr;
    L.out_m = mom ? static_cast<float*>(const_cast<void*>(ptrs[4])) : nullptr;
    L.n = r[5];
    L.cell = static_cast<uint16_t>(cell);
    L.dtypes = static_cast<int8_t>(w_dtype | g_dtype << 1);
    L.vec = static_cast<int8_t>(leaf_vec(w_dtype, g_dtype, mom, ptrs));
    L.first = static_cast<int32_t>(chunks);
    const int64_t per_chunk = int64_t{kLeafThreads} * kLeafUnroll * L.vec;
    chunks += (L.n + per_chunk - 1) / per_chunk;
    if (chunks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.scale = static_cast<const float*>(scale);
  t.momentum = momentum;
  t.count = count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(chunks);
  if (mom) {
    weighted_update_leaves_kernel<true><<<grid, kLeafThreads, 0, st>>>(t);
  } else {
    weighted_update_leaves_kernel<false><<<grid, kLeafThreads, 0, st>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

// The leaves one launch of K1 takes (kMaxLeaves).
int weighted_update_max_leaves() { return kMaxLeaves; }

// Registers, static / dynamic shared memory, local (spill) bytes and CTAs
// an SM of the K1 kernel (momentum or not), then the bytes of its leaf
// table: out[0..5].
int weighted_update_leaves_kernel_info(int with_momentum, int* out) {
  const void* fn = with_momentum ? (const void*)weighted_update_leaves_kernel<true>
                                 : (const void*)weighted_update_leaves_kernel<false>;
  const int err = kernel_attrs(fn, kLeafThreads, 0, out);
  out[5] = static_cast<int>(sizeof(LeafTable));
  return err;
}

// K2 over B cells, one launch: cell c's (R, P) ring, (P,) w, (E, P) D, (E,)
// slots and (P,) w' follow cell c-1's in their buffers.
int block_prefix_update(int snap_dtype, int w_dtype, void* snaps, const void* w, const void* D,
                        const void* slots, void* w_out, int64_t B, int64_t R, int64_t P,
                        int64_t E, void* stream) {
  if (B < 1 || B > kMaxGridY || E < 1 || E > kMaxLanes || R > INT32_MAX ||
      !valid_pair(snap_dtype, w_dtype) || !aligned_to(w_out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = prefix_vec(snap_dtype, snaps, w, D, P);
  cudaError_t err;
  if (snap_dtype == kF32 && w_dtype == kF32) {
    err = launch_prefix<float, float>(snaps, w, D, slots, w_out, B, R, P, E, vec, st);
  } else if (snap_dtype == kBF16 && w_dtype == kF32) {
    err = launch_prefix<__nv_bfloat16, float>(snaps, w, D, slots, w_out, B, R, P, E, vec, st);
  } else if (snap_dtype == kF32 && w_dtype == kBF16) {
    err = launch_prefix<float, __nv_bfloat16>(snaps, w, D, slots, w_out, B, R, P, E, vec, st);
  } else {
    err = launch_prefix<__nv_bfloat16, __nv_bfloat16>(snaps, w, D, slots, w_out, B, R, P, E,
                                                       vec, st);
  }
  return static_cast<int>(err);
}

// The columns a thread of K2 owns for these operands.
int block_prefix_update_vec(int snap_dtype, const void* snaps, const void* w, const void* D,
                            int64_t P) {
  return prefix_vec(snap_dtype, snaps, w, D, P);
}

// kernel_attrs of the K2 kernel for this dtype pair and VEC (1, or 16 bytes
// of ring values), at E lanes: out[0..4].
int block_prefix_update_kernel_info(int snap_dtype, int w_dtype, int vec, int64_t E, int* out) {
  if (!valid_pair(snap_dtype, w_dtype) || (vec != 1 && vec != (snap_dtype == kF32 ? 4 : 8)) ||
      E < 1 || E > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = snap_dtype == kF32
      ? (w_dtype == kF32 ? prefix_kernel<float, float>(vec)
                         : prefix_kernel<float, __nv_bfloat16>(vec))
      : (w_dtype == kF32 ? prefix_kernel<__nv_bfloat16, float>(vec)
                         : prefix_kernel<__nv_bfloat16, __nv_bfloat16>(vec));
  return kernel_attrs(fn, kPrefixThreads, prefix_smem(E), out);
}

// K6 over B cells, one launch: cell c's (R, P) ring, (E, P) W, (E,) slots
// and (P,) w' follow cell c-1's in their buffers.
int block_scatter_rows(int snap_dtype, int w_dtype, void* snaps, const void* W,
                       const void* slots, void* w_out, int64_t B, int64_t R, int64_t P,
                       int64_t E, void* stream) {
  if (B < 1 || B > kMaxGridY || E < 1 || E > kMaxLanes || !valid_pair(snap_dtype, w_dtype) ||
      !aligned_to(w_out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = scatter_vec(snap_dtype, snaps, W, P);
  cudaError_t err;
  if (snap_dtype == kF32 && w_dtype == kF32) {
    err = launch_scatter<float, float>(snaps, W, slots, w_out, B, R, P, E, vec, st);
  } else if (snap_dtype == kBF16 && w_dtype == kF32) {
    err = launch_scatter<__nv_bfloat16, float>(snaps, W, slots, w_out, B, R, P, E, vec, st);
  } else if (snap_dtype == kF32 && w_dtype == kBF16) {
    err = launch_scatter<float, __nv_bfloat16>(snaps, W, slots, w_out, B, R, P, E, vec, st);
  } else {
    err = launch_scatter<__nv_bfloat16, __nv_bfloat16>(snaps, W, slots, w_out, B, R, P, E, vec,
                                                       st);
  }
  return static_cast<int>(err);
}

// The ring values a thread of K6 moves per access for these operands.
int block_scatter_rows_vec(int snap_dtype, const void* snaps, const void* W, int64_t P) {
  return scatter_vec(snap_dtype, snaps, W, P);
}

// kernel_attrs of the K6 kernel for this dtype pair and VEC (1, or 16 bytes
// of ring values), at E lanes: out[0..4].
int block_scatter_rows_kernel_info(int snap_dtype, int w_dtype, int vec, int64_t E, int* out) {
  if (!valid_pair(snap_dtype, w_dtype) || (vec != 1 && vec != (snap_dtype == kF32 ? 4 : 8)) ||
      E < 1 || E > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = snap_dtype == kF32
      ? (w_dtype == kF32 ? scatter_kernel<float, float>(vec)
                         : scatter_kernel<float, __nv_bfloat16>(vec))
      : (w_dtype == kF32 ? scatter_kernel<__nv_bfloat16, float>(vec)
                         : scatter_kernel<__nv_bfloat16, __nv_bfloat16>(vec));
  return kernel_attrs(fn, kScatterThreads, E * sizeof(int64_t), out);
}

}  // extern "C"
