// Hand-written Hopper (sm_90a) kernels for the ColRel relay hot spot.
//
//   relay_mix_2d        out = A · Δ          A (n, n) f32, Δ (n, D) → (n, D)
//     replaces the Pallas kernel `_mix_kernel` / `_relay_mix_core`
//     (src/repro/kernels/relay_mix.py, pallas_call at line 47).
//   fused_aggregate_2d  out = c · Δ          c (n,) f32,   Δ (n, D) → (D,)
//     replaces the Pallas kernel `_fused_kernel` / `fused_aggregate_2d`
//     (src/repro/kernels/relay_mix.py, pallas_call at line 94).
//
// Dtype rules (both kernels, as in the Pallas versions): the weights are
// rounded to Δ's dtype (f32 or bf16) before the product, every sum is taken
// in f32 with fmaf from 0 in ascending origin order, and the result is
// stored in Δ's dtype.  No atomics on data: each output element is summed
// in one fixed order that depends on (n, D) only, so two calls are bitwise
// equal, as is any code that sums in the same order (the plain versions in
// kernels/ref.py do).  relay_mix_2d sums each element in one chain over all
// n origins; so does fused_aggregate_2d with one origin range (S = 1), and
// with S > 1 it sums each range in one chain and then adds the S partials
// (below).  The kernels launch on the caller's stream, never synchronise and
// allocate nothing (the split reduction's scratch comes from the caller).
//
// Vectors.  Both kernels read Δ in vectors of V elements: the widest of 16,
// 8 or 4 bytes that divides Δ's base address, the output's base address and
// the row pitch D·sizeof(T) (else one element).  Then every row starts on a
// vector boundary and V divides D, so the ragged tail is whole vectors,
// masked; nothing is padded or copied.  The main shape's pitch is ≡ 8
// (mod 16): f32 takes 8-byte loads there, bf16 (pitch ≡ 4) 4-byte ones.
//
// relay_mix_2d has two paths, chosen by n in the launcher
// (relay_mix_2d_plan reports which).  Neither uses the tensor cores: TF32
// `wgmma` (or 3×TF32) rounds the products otherwise, which breaks the bits
// above and the 1e-5 parity the ResNet runs depend on, and at n = 10 a
// 64-row `wgmma` tile would be 84% padding.  The yardstick is therefore the
// f32 CUDA-core rate, 67 TFLOP/s on an H100.
//
// * stream (n ≤ 32; every path the port drives: n = 4, 8, 10).  n·D
//   elements in and n·D out with n FMAs an element read: n/4 flop a byte,
//   under the card's 67 TFLOP/s ÷ 3.35 TB/s = 20, so device-memory bytes
//   bound it.  The design keeps loads in flight from the first cycle:
//     - one wave: the grid is min(column tiles, SMs × resident blocks), from
//       the occupancy query (asked once and cached), and each block strides
//       over the tiles; a tile is one vector a thread, 128 threads.  With
//       fewer tiles than SMs (small D) the row passes below spread over
//       blockIdx.y instead (30 blocks at (10, 2,410), not 10);
//     - a thread issues the loads of all n origins of its vector (R ≥ n
//       vector registers, R ∈ {4, 8, 12, 16, 24, 32}) before its first FMA:
//       one wait on memory a tile;
//     - A is rounded and staged in shared memory once a block (R×R floats,
//       ≤ 4 KB) after the first tile's loads are issued, so the two trips to
//       memory overlap;
//     - the outputs are summed in passes of G rows (G·V = 8 accumulators),
//       each element one ascending chain over the registers, an origin's G
//       weights one broadcast read of shared memory;
//     - R origins' vectors fit 32 registers: 16-byte vectors up to R = 8,
//       8-byte up to 16, 4-byte for 24 and 32.  Instances whose Δ takes ≤ 24
//       registers are built for 9 resident blocks (≤ 56 registers a thread),
//       the rest for 8 (≤ 64).  ptxas (sm_90a) gives 32–64 registers and no
//       spills; the main shape's instance (f32, R = 12, 8-byte vectors) takes
//       54, so its 1,064 tiles run in one wave of 132 × 9 blocks.
// * slab (n > 32; the JAX kernel's regime up to n = 128).  At n ≥ 80 the
//   f32 FMAs, not the bytes, bound it, so it tiles registers:
//     - a block of 256 threads owns 128 columns and RT rows (64 for n ≤ 64,
//       else 128); a warp RT / 8 rows × 128 columns, a lane RT / 8 rows × 4
//       columns, so an origin's weights are broadcast reads (one a 4 rows)
//       and its 4 values of Δ one 16-byte read;
//     - it walks the origins in chunks of 32: cp.async copies the chunk's
//       32 × 128 slab of Δ and RT × 32 slab of A (transposed) into shared
//       memory, double-buffered, the next chunk in flight while the current
//       one is summed.  For n ≤ 128 the block holds every row, so each element
//       of Δ is read from device memory once;
//     - n > 128 takes ceil(n / 128) row tiles (blockIdx.y), each reading Δ;
//     - RT = 64 is built for 4 resident blocks (64 registers; f32 with 8-byte
//       and bf16 with 2-byte vectors spill 8–12 bytes), RT = 128 for 2
//       (114–125 registers).
//
// fused_aggregate_2d.  A reduction over the n rows: n·D elements in, D out,
// each read once.  At the main-path shape (10, 272,282) f32 the bytes need
// 3.6 µs at the data sheet's 3.35 TB/s, so what bounds a call there is
// first the launch and the ramp until enough loads are in flight, then the
// bytes; at (8, 10⁷) it is the bytes.  The design therefore
//   * launches one wave: the grid is the number of blocks the card holds at
//     once (SMs × resident blocks an SM, from the occupancy query, cached),
//     capped at the number of column tiles, and each block strides over the
//     tiles; c is rounded and staged in shared memory once a block;
//   * gives each thread V consecutive columns, read and written as one
//     vector (the rule above);
//   * issues a chunk of K origins' loads into registers before the first
//     FMA, then sums the chunk in ascending origin order: one wait on memory
//     per chunk.  K fills 24 registers (6 vectors of 16 bytes, 12 of 8, 24
//     of 4 or 2), so n = 10 takes one wait at the main shape;
//   * is compiled for 9 resident blocks of 128 threads an SM (≤ 56
//     registers; of the 7 instances only bf16 with 8-byte vectors spills,
//     8 bytes), so the main shape's 1,064 tiles of 128 vectors fit in one
//     wave of 132 × 9 blocks, one tile a block.  Left to itself ptxas spends
//     up to 96 registers on the chunk's addresses and weights; then blocks
//     run a second tile, and a call at the main shape takes 1.5× as long
//     (NVIDIA H100 80GB HBM3 at 700 W, tools/time_fused_aggregate.py).
//   That is the whole kernel when the caller passes S = 1 origin range
//   (fused_aggregate_kernel).  Many clients at a small D (the sample
//   sweeps' (10⁴, 698): 3 column tiles, so 3 blocks on 132 SMs, each thread
//   waiting on memory 834 times) take S > 1 (fused_aggregate_split_kernel):
//   the order is then two-level, and S comes from the caller (kernels/ref.py's
//   fused_splits, a function of (n, D) only, so neither the card, the dtype
//   nor Δ's alignment changes the bits):
//   * range s holds origins [s·L, min(n, (s+1)·L)), L = ⌈n/S⌉, each range
//     non-empty; it is summed in one ascending fmaf chain from 0 into an f32
//     partial, and the S partials are added from 0 in ascending s with f32
//     adds; the result is rounded once to Δ's dtype;
//   * a block owns one (column tile of kSplitThreads vectors, range) pair,
//     the tiles of a range consecutive blocks (so the blocks that run
//     together read whole rows), and the grid is tiles × S (1,727 blocks
//     of 8 warps at (10⁴, 698) f32);
//   * the block's kSplitWarps warps copy the range's L rows of the tile into
//     shared memory with cp.async, a row a warp in turn, all in flight
//     before one wait; c's L weights are staged beside them; warp 0 sums;
//   * the partials (S, D) f32 go to the caller's scratch, then one
//     acquire-release atomic add on the tile's counter: the block that
//     brings it to S adds the tile's S partials in ascending s (its warps
//     copy them in 16-byte pieces with cp.async.cg, which reads L2 and never
//     a stale L1), whichever block that is, and sets the counter back to 0.
//     The counter is the only atomic.  The counters come from the caller
//     zeroed and go back zeroed, so no launch needs a memset (a captured
//     cudaMemsetAsync took 2.5 µs a call at (256, 698)); the caller keeps
//     two launches that may run at once from sharing them
//     (kernels/relay_mix.py);
//   * a warp keeps few loads in flight: one warp a block took 6 µs to read
//     157 partials at (10⁴, 698), so every phase's copies are the block's.
//     (Times: NVIDIA H100 80GB HBM3 at 700 W, tools/time_fused_aggregate.py.)
//
// Interface: plain C launchers, loaded with ctypes.  Each returns
// cudaGetLastError() (or the error of a failed query) as an int
// (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxVecBytes = 16;  // widest load of Δ

// relay_mix_2d, stream path (n ≤ 32)
constexpr int kStreamMaxRows = 32;  // the largest n of the path
constexpr int kStreamThreads = 128; // threads a block
constexpr int kStreamXRegs = 32;    // registers for the R origins' vectors of Δ
constexpr int kStreamAccRegs = 8;   // accumulators of one pass over G rows

// relay_mix_2d, slab path (n > 32)
constexpr int kSlabCols = 128;     // columns a block
constexpr int kSlabWarps = 8;      // warps a block, each RT / 8 rows × 128 columns
constexpr int kSlabTileCols = 4;   // columns of a thread's register tile (32 lanes: 128)
constexpr int kSlabChunk = 32;     // origins a shared-memory stage
constexpr int kSlabPad = 4;        // floats after each origin's RT weights
constexpr int kSlabStages = 2;     // shared-memory stages (double buffer)
constexpr int kSlabUnroll = 2;     // origins a step of the inner loop

// fused_aggregate_2d
constexpr int kCoeffChunk = 1024;   // coefficients of c staged per pass
constexpr int kFusedThreads = 128;  // threads per block of the fused kernel
constexpr int kFusedMinBlocks = 9;  // resident blocks an SM: ≤ 56 registers a thread
constexpr int kChunkRegs = 24;      // registers of Δ a thread loads before it sums
// fused_aggregate_2d split over S > 1 origin ranges.  Chosen with
// tools/time_fused_aggregate.py (NVIDIA H100 80GB HBM3, 700 W; f32 µs at
// n = 256 / 1,000 / 1,025 / 10⁴, D = 698): 8 warps and 16 KB chunks
// 4.22 / 5.19 / 5.23 / 17.04; 4 warps and 46 KB 4.32 / 5.44 / 5.46 / 18.39;
// tiles of 64 vectors 4.55 / 5.28 / 5.28 / 17.13, of 128 5.17 / 5.41 /
// 5.51 / 19.26; one warp a block 4.74 / 6.22 / 6.33 / 22.57
constexpr int kSplitThreads = 32;              // column vectors a tile: a lane each
constexpr int kSplitWarps = 8;                 // warps a block
constexpr int kSplitMaxRange = 128;            // origins a range at most
constexpr int kSplitSmemBytes = 46 * 1024;     // dynamic shared memory a block (+ c_s < 48 KB)
constexpr int kSplitPartialBytes = 16 * 1024;  // a chunk of partials the last block adds

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  // round to nearest even, as torch's and XLA's casts
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

// the register type of one vector of B bytes
template <int B>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<2> { using type = unsigned short; };

// G consecutive floats of shared memory (16-byte aligned for G ≥ 4, 8 for 2)
template <int G>
__device__ __forceinline__ void load_floats(const float* p, float (&w)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      w[4 * q] = t.x;
      w[4 * q + 1] = t.y;
      w[4 * q + 2] = t.z;
      w[4 * q + 3] = t.w;
    }
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    static_assert(G == 1, "a pass takes 1, 2 or a multiple of 4 rows");
    w[0] = p[0];
  }
}

// ---------------------------------------------------------------- stream path

// registers that R origins' vectors of VB bytes take (a 2-byte vector takes
// a whole register)
__host__ __device__ constexpr int stream_x_regs(int R, int VB) {
  return R * (VB < 4 ? 4 : VB) / 4;
}

// the widest vector whose R origins fit kStreamXRegs registers
__host__ __device__ constexpr int stream_vec_cap(int R) {
  int b = kMaxVecBytes;
  while (b > 4 && stream_x_regs(R, b) > kStreamXRegs) b /= 2;
  return b;
}

// 9 resident blocks (≤ 56 registers a thread) where Δ's registers leave room,
// else 8 (≤ 64)
__host__ __device__ constexpr int stream_min_blocks(int R, int VB) {
  return stream_x_regs(R, VB) <= 24 ? 9 : 8;
}

// rows a pass: kStreamAccRegs / V, a power of two that divides R
__host__ __device__ constexpr int stream_rows(int R, int V) {
  int g = kStreamAccRegs / V < 1 ? 1 : kStreamAccRegs / V;
  while (R % g != 0) g /= 2;
  return g;
}

// x[o] = vector v of origin o, for o < n; all loads in flight at once
template <int R, typename Vec>
__device__ __forceinline__ void load_origins(Vec (&x)[R], const Vec* __restrict__ src,
                                             long long v, long long dv, int n) {
  if (v >= dv) return;
#pragma unroll
  for (int o = 0; o < R; ++o) {
    if (o < n) x[o] = __ldg(src + static_cast<long long>(o) * dv + v);
  }
}

// Δ viewed as (n, D / V) vectors of V elements; n ≤ R
template <typename T, int R, int V>
__global__ void __launch_bounds__(kStreamThreads,
                                  stream_min_blocks(R, V * static_cast<int>(sizeof(T))))
    relay_mix_stream_kernel(const float* __restrict__ A, const T* __restrict__ delta,
                            T* __restrict__ out, int n, long long D) {
  using Vec = typename Raw<V * static_cast<int>(sizeof(T))>::type;
  constexpr int G = stream_rows(R, V);
  // a_s[o][r] = A[r, o] rounded to T (0 outside n): an origin's weights for
  // G consecutive rows are one broadcast read
  __shared__ __align__(16) float a_s[R][R];
  const long long dv = D / V;
  const long long tiles = (dv + blockDim.x - 1) / blockDim.x;
  const Vec* src = reinterpret_cast<const Vec*>(delta);
  Vec* dst = reinterpret_cast<Vec*>(out);
  long long tile = blockIdx.x;
  long long v = tile * blockDim.x + threadIdx.x;
  Vec x[R];
  // the first tile's loads go out before the block waits on A
  load_origins<R>(x, src, v, dv, n);
  // A's n² entries read in A's order; zeros outside n (a pass may compute
  // rows ≥ n, never stored)
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) a_s[i % n][i / n] = Io<T>::round(A[i]);
  for (int i = threadIdx.x; i < R * R; i += blockDim.x) {
    if (i / R >= n || i % R >= n) a_s[i / R][i % R] = 0.f;
  }
  __syncthreads();
  for (;;) {
    if (v < dv) {
      // the block's passes: all of them, or every gridDim.y-th at small D
      for (int r0 = blockIdx.y * G; r0 < n; r0 += gridDim.y * G) {
        float acc[G][V];
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[g][j] = 0.f;
        }
#pragma unroll
        for (int o = 0; o < R; ++o) {
          if (o < n) {
            float w[G];
            load_floats<G>(&a_s[o][r0], w);
            const T* e = reinterpret_cast<const T*>(&x[o]);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float xj = Io<T>::to_float(e[j]);
#pragma unroll
              for (int g = 0; g < G; ++g) acc[g][j] = fmaf(w[g], xj, acc[g][j]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (r0 + g < n) {
            Vec y;
            T* e = reinterpret_cast<T*>(&y);
#pragma unroll
            for (int j = 0; j < V; ++j) e[j] = Io<T>::from_float(acc[g][j]);
            dst[static_cast<long long>(r0 + g) * dv + v] = y;
          }
        }
      }
    }
    tile += gridDim.x;
    if (tile >= tiles) break;
    v = tile * blockDim.x + threadIdx.x;
    load_origins<R>(x, src, v, dv, n);
  }
}

// ------------------------------------------------------------------ slab path

// B bytes from global to shared memory, asynchronously (cp.async; zeros where
// !valid); 2 bytes, which cp.async does not copy, by a plain load and store
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (B >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int bytes = valid ? B : 0;
    if constexpr (B == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                   "r"(bytes)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(B),
                   "r"(bytes)
                   : "memory");
    }
  } else {
    static_assert(B == 2, "a copy is 2, 4, 8 or 16 bytes");
    *static_cast<unsigned short*>(dst) = valid ? *static_cast<const unsigned short*>(src) : 0;
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest one has landed
__device__ __forceinline__ void copy_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kSlabThreads = kSlabWarps * 32;
// rows of a thread's register tile: 8 for RT = 64, 16 for RT = 128
__host__ __device__ constexpr int slab_tile_rows(int RT) { return RT / kSlabWarps; }
// resident blocks a slab kernel is built for: 8 registers a row of the
// tile, so 64 (4 blocks) for RT = 64 and 128 (2 blocks) for RT = 128
__host__ __device__ constexpr int slab_min_blocks(int RT) {
  return 65536 / (kSlabThreads * 8 * slab_tile_rows(RT));
}

template <typename T, int RT>
__host__ __device__ constexpr int slab_stage_bytes() {
  return kSlabChunk * kSlabCols * static_cast<int>(sizeof(T)) +
         kSlabChunk * (RT + kSlabPad) * static_cast<int>(sizeof(float));
}

// Δ viewed as rows of D / V vectors of V elements; the block's rows are
// [blockIdx.y·RT, +RT), its columns [blockIdx.x·kSlabCols, +kSlabCols)
template <typename T, int RT, int V>
__global__ void __launch_bounds__(kSlabThreads, slab_min_blocks(RT))
    relay_mix_slab_kernel(const float* __restrict__ A, const T* __restrict__ delta,
                          T* __restrict__ out, int n, long long D) {
  constexpr int kThreads = kSlabThreads;
  constexpr int kTileRows = slab_tile_rows(RT);
  constexpr int kVecsRow = kSlabCols / V;
  constexpr int kDeltaStep = kThreads / kVecsRow;  // slab rows a pass of the block's copies
  constexpr int kDeltaCopies = kSlabChunk / kDeltaStep;
  constexpr int kWeightStep = kThreads / kSlabChunk;  // rows of A a pass
  constexpr int kWeightCopies = RT / kWeightStep;
  constexpr int kStride = RT + kSlabPad;  // floats between two origins' weights
  constexpr int kDeltaBytes = kSlabChunk * kSlabCols * static_cast<int>(sizeof(T));
  constexpr int kStageBytes = slab_stage_bytes<T, RT>();
  constexpr int VB = V * static_cast<int>(sizeof(T));
  static_assert(kDeltaStep * kVecsRow == kThreads && kDeltaCopies * kDeltaStep == kSlabChunk,
                "a thread copies whole vectors of one column, kDeltaStep rows apart");
  static_assert(kWeightStep * kSlabChunk == kThreads && kWeightCopies * kWeightStep == RT,
                "a thread copies one origin's weights, kWeightStep rows apart");
  static_assert(kStageBytes % 16 == 0 && kDeltaBytes % 16 == 0, "16-byte aligned stages");
  // stage s: the chunk's Δ slab ds[k][c] (T, kSlabCols a row), then its
  // weights as[k][r] = A[rb + r, o0 + k] (f32, not yet rounded; kStride a row)
  extern __shared__ __align__(16) unsigned char slab[];
  const long long c0 = static_cast<long long>(blockIdx.x) * kSlabCols;
  const int rb = blockIdx.y * RT;
  // a warp owns kTileRows rows × kSlabCols columns of the block's
  // output, a lane kTileRows × kSlabTileCols of it
  const int tr = threadIdx.x / 32 * kTileRows;  // the thread's first row in the block
  const int tc = threadIdx.x % 32 * kSlabTileCols;  // and first column
  const bool rows_live = rb + tr < n;               // warp-uniform
  // what this thread copies: Δ's slab rows dk + j·kDeltaStep at column dc,
  // and origin ak's weights for rows ar + j·kWeightStep (consecutive threads
  // read consecutive addresses of a row of Δ or of A)
  const int dk = threadIdx.x / kVecsRow;
  const int dc = threadIdx.x % kVecsRow * V;
  const bool col_live = c0 + dc < D;
  const int ak = threadIdx.x % kSlabChunk;
  const int ar = threadIdx.x / kSlabChunk;

  auto issue = [&](int chunk) {
    const int o0 = chunk * kSlabChunk;
    unsigned char* stage = slab + (chunk % kSlabStages) * kStageBytes;
    T* ds = reinterpret_cast<T*>(stage) + dk * kSlabCols + dc;
    const T* dg = delta + static_cast<long long>(o0 + dk) * D + c0 + dc;
#pragma unroll
    for (int j = 0; j < kDeltaCopies; ++j) {
      const bool valid = col_live && o0 + dk + j * kDeltaStep < n;
      copy_async<VB>(ds + j * kDeltaStep * kSlabCols,
                     valid ? dg + j * kDeltaStep * D : delta, valid);
    }
    float* as = reinterpret_cast<float*>(stage + kDeltaBytes) + ak * kStride + ar;
    const float* ag = A + static_cast<long long>(rb + ar) * n + o0 + ak;
    const bool origin_live = o0 + ak < n;
#pragma unroll
    for (int j = 0; j < kWeightCopies; ++j) {
      const bool valid = origin_live && rb + ar + j * kWeightStep < n;
      copy_async<4>(as + j * kWeightStep, valid ? ag + j * kWeightStep * n : A, valid);
    }
  };

  float acc[kTileRows][kSlabTileCols];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
#pragma unroll
    for (int j = 0; j < kSlabTileCols; ++j) acc[i][j] = 0.f;
  }
  using XVec = typename Raw<kSlabTileCols * static_cast<int>(sizeof(T))>::type;
  const int chunks = (n + kSlabChunk - 1) / kSlabChunk;
  issue(0);
  copy_commit();
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) issue(chunk + 1);
    copy_commit();  // possibly empty: the wait below always leaves one group
    copy_wait_prior();
    __syncthreads();
    if (rows_live) {
      const unsigned char* stage = slab + (chunk % kSlabStages) * kStageBytes;
      // per origin: the rows' weights, one broadcast read a 4, and 4 values
      // of Δ, 512 distinct bytes a warp
      const T* ds = reinterpret_cast<const T*>(stage) + tc;
      const float* as = reinterpret_cast<const float*>(stage + kDeltaBytes) + tr;
      const int kc = min(kSlabChunk, n - chunk * kSlabChunk);
#pragma unroll (kSlabUnroll)
      for (int k = 0; k < kc; ++k) {
        float w[kTileRows];
        load_floats<kTileRows>(as + k * kStride, w);
        const XVec xv = *reinterpret_cast<const XVec*>(ds + k * kSlabCols);
        const T* e = reinterpret_cast<const T*>(&xv);
        float x[kSlabTileCols];
#pragma unroll
        for (int j = 0; j < kSlabTileCols; ++j) x[j] = Io<T>::to_float(e[j]);
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          const float wi = Io<T>::round(w[i]);
#pragma unroll
          for (int j = 0; j < kSlabTileCols; ++j) acc[i][j] = fmaf(wi, x[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }
  if (!rows_live) return;
  // stores of SV elements: the tile's 4 columns, or the vectors Δ's alignment allows
  constexpr int SV = V < kSlabTileCols ? V : kSlabTileCols;
  using SVec = typename Raw<SV * static_cast<int>(sizeof(T))>::type;
  const long long col = c0 + tc;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    const int row = rb + tr + i;
    if (row >= n) break;
#pragma unroll
    for (int s = 0; s < kSlabTileCols / SV; ++s) {
      const long long cs = col + s * SV;
      if (cs < D) {
        SVec y;
        T* e = reinterpret_cast<T*>(&y);
#pragma unroll
        for (int j = 0; j < SV; ++j) e[j] = Io<T>::from_float(acc[i][s * SV + j]);
        *reinterpret_cast<SVec*>(out + static_cast<long long>(row) * D + cs) = y;
      }
    }
  }
}

// ------------------------------------------------------------- fused kernel

// c_s[i] = c[o0 + i] rounded to T, for i < oc; the block waits for it
template <typename T>
__device__ __forceinline__ void stage_coeffs(const float* __restrict__ c, float* c_s, int o0,
                                             int oc) {
  for (int i = threadIdx.x; i < oc; i += kFusedThreads) c_s[i] = Io<T>::round(c[o0 + i]);
  __syncthreads();
}

// Δ viewed as (n, D / V) vectors of V elements; V divides D and every row
// starts on a vector boundary (the launcher's alignment rule)
template <typename T, int V>
__global__ void __launch_bounds__(kFusedThreads, kFusedMinBlocks)
    fused_aggregate_kernel(const float* __restrict__ c, const T* __restrict__ delta,
                           T* __restrict__ out, int n, long long D) {
  using Vec = typename Raw<V * static_cast<int>(sizeof(T))>::type;
  // origins a chunk: as many vectors as kChunkRegs registers hold (a 2-byte
  // vector takes a whole register)
  constexpr int K = kChunkRegs / (sizeof(Vec) < 4 ? 1 : static_cast<int>(sizeof(Vec)) / 4);
  static_assert(K >= 1, "a chunk holds at least one origin");
  __shared__ float c_s[kCoeffChunk];
  const long long dv = D / V;
  const long long tiles = (dv + kFusedThreads - 1) / kFusedThreads;
  const bool resident = n <= kCoeffChunk;  // all of c fits: stage it once a block
  if (resident) stage_coeffs<T>(c, c_s, 0, n);
  const Vec* src = reinterpret_cast<const Vec*>(delta);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long v = tile * kFusedThreads + threadIdx.x;
    const bool live = v < dv;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int o0 = 0; o0 < n; o0 += kCoeffChunk) {
      const int oc = min(kCoeffChunk, n - o0);
      if (!resident) {
        __syncthreads();  // the previous coefficients are fully consumed
        stage_coeffs<T>(c, c_s, o0, oc);
      }
      if (!live) continue;
      for (int k0 = 0; k0 < oc; k0 += K) {
        // all of the chunk's loads are in flight before the first FMA
        Vec x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k0 + k < oc) x[k] = __ldg(src + static_cast<long long>(o0 + k0 + k) * dv + v);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k0 + k < oc) {
            const float w = c_s[k0 + k];
            const T* e = reinterpret_cast<const T*>(&x[k]);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(w, Io<T>::to_float(e[j]), acc[j]);
          }
        }
      }
    }
    if (live) {
      Vec y;
      T* e = reinterpret_cast<T*>(&y);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = Io<T>::from_float(acc[j]);
      reinterpret_cast<Vec*>(out)[v] = y;
    }
  }
}

// V consecutive floats of device memory (aligned to V floats)
template <int V>
__device__ __forceinline__ void store_floats(float* p, const float (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2],
                                                    a[4 * q + 3]);
    }
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    static_assert(V == 1, "a vector holds 1, 2 or a multiple of 4 elements");
    p[0] = a[0];
  }
}

// floats between two ranges' partials: D rounded up to 16 bytes
__host__ __device__ constexpr long long split_pitch(long long D) { return (D + 3) / 4 * 4; }

// the tile counter's add: acquire-release at device scope, so the block's
// partials (ordered before it by the barrier that precedes it) are visible
// to the block that reads the final count, and that block sees every other
// block's partials (the CUTLASS split-K semaphore's pattern)
__device__ __forceinline__ unsigned count_tile(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Δ viewed as (n, D / V) vectors of V elements.  Block b sums origin range
// s = b / tiles of column tile b mod tiles (kSplitThreads vectors, a lane each) into
// partials[s] (pitch split_pitch(D)); the tile's last block to finish adds
// its S partials.  The block's kSplitWarps warps share the copies; warp 0
// sums.  smem bytes of dynamic shared memory hold the range's vectors, then
// chunk_rows rows of the tile's partials at a time.
template <typename T, int V>
__global__ void __launch_bounds__(kSplitThreads * kSplitWarps)
    fused_aggregate_split_kernel(const float* __restrict__ c, const T* __restrict__ delta,
                                 T* __restrict__ out, int n, long long D, int splits,
                                 int chunk_rows, float* __restrict__ partials,
                                 unsigned* __restrict__ counters) {
  using Vec = typename Raw<V * static_cast<int>(sizeof(T))>::type;
  constexpr int VB = V * static_cast<int>(sizeof(T));
  constexpr int kRowFloats = kSplitThreads * V;  // a tile's row of partials
  constexpr int kThreads = kSplitThreads * kSplitWarps;
  extern __shared__ __align__(16) unsigned char split_smem[];
  __shared__ float c_s[kSplitMaxRange];
  __shared__ bool last;
  const long long dv = D / V;
  const long long pitch = split_pitch(D);
  const int range = (n + splits - 1) / splits;
  const long long tiles = (dv + kSplitThreads - 1) / kSplitThreads;
  const int s = static_cast<int>(blockIdx.x / tiles);
  const long long tile = blockIdx.x % tiles;
  const int o0 = s * range;
  const int oc = min(range, n - o0);
  const int lane = threadIdx.x % kSplitThreads;
  const int warp = threadIdx.x / kSplitThreads;
  const long long v = tile * kSplitThreads + lane;
  const bool live = v < dv;
  // stage[k · kSplitThreads + lane] = vector v of origin o0 + k, copied by
  // warp k mod kSplitWarps: all of the range's copies in flight at once
  Vec* stage = reinterpret_cast<Vec*>(split_smem);
  if (live) {
    const Vec* src = reinterpret_cast<const Vec*>(delta) + o0 * dv + v;
#pragma unroll 4
    for (int k = warp; k < oc; k += kSplitWarps) {
      copy_async<VB>(stage + k * kSplitThreads + lane, src + k * dv, true);
    }
  }
  for (int k = threadIdx.x; k < oc; k += kThreads) c_s[k] = Io<T>::round(c[o0 + k]);
  copy_wait_all();
  __syncthreads();
  if (warp == 0 && live) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < oc; ++k) {
      const Vec x = stage[k * kSplitThreads + lane];
      const T* e = reinterpret_cast<const T*>(&x);
      const float w = c_s[k];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(w, Io<T>::to_float(e[j]), acc[j]);
    }
    store_floats<V>(partials + s * pitch + v * V, acc);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    last = count_tile(counters + tile) == static_cast<unsigned>(splits - 1);
    if (last) counters[tile] = 0;  // every block of the tile has counted
  }
  __syncthreads();
  if (!last) return;
  // the tile's S partials, chunk_rows rows at a time, in 16-byte pieces that
  // start before D (a row of the tile is kRowFloats floats, 16-byte aligned)
  const long long col0 = tile * kRowFloats;
  const int quads = static_cast<int>((min(static_cast<long long>(kRowFloats), D - col0) + 3) / 4);
  float* ps = reinterpret_cast<float*>(split_smem);
  float sum[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sum[j] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += chunk_rows) {
    const int sc = min(chunk_rows, splits - s0);
    for (int i = threadIdx.x; i < sc * quads; i += kThreads) {
      const int r = i / quads;
      const int q = i - r * quads;
      copy_async<16>(ps + r * kRowFloats + 4 * q, partials + (s0 + r) * pitch + col0 + 4 * q,
                     true);
    }
    copy_wait_all();
    __syncthreads();
    if (warp == 0 && live) {
#pragma unroll 8
      for (int r = 0; r < sc; ++r) {
        float p[V];
        load_floats<V>(ps + r * kRowFloats + lane * V, p);
#pragma unroll
        for (int j = 0; j < V; ++j) sum[j] = sum[j] + p[j];
      }
    }
    __syncthreads();  // the chunk is consumed before the next one lands
  }
  if (warp == 0 && live) {
    Vec y;
    T* e = reinterpret_cast<T*>(&y);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = Io<T>::from_float(sum[j]);
    reinterpret_cast<Vec*>(out)[v] = y;
  }
}

// ------------------------------------------------------------------ launchers

// What a launch uses (the *_plan entries hand it out as ints): the path of
// relay_mix_2d (1 stream, 2 slab; 0 for the fused kernel), vector bytes,
// blocks in the grid, resident blocks an SM, threads a block, and the
// fused kernel's column tile (vectors)
struct Plan {
  int path;
  int vec_bytes;
  int grid;
  int blocks_per_sm;
  int threads;
  int tile;
};

// a launch's operands
struct Launch {
  const void* w;  // A (n, n) or c (n,), f32
  const void* delta;
  void* out;
  int n;
  long long D;
  cudaStream_t stream;
  bool launch;          // false: fill the plan only
  int splits;           // fused_aggregate_2d: origin ranges S
  void* partials;       // fused_aggregate_2d with S > 1: split_workspace(D, S) bytes
  void* counters;       // and counters_len zeroed counters, left zeroed
  long long counters_len;
};

// resident blocks an SM of one kernel instance, asked once for the process
struct Occupancy {
  cudaError_t err;
  int blocks;
};

template <typename Kernel>
Occupancy occupancy(Kernel kernel, int threads, int smem) {
  Occupancy o{cudaSuccess, 0};
  if (smem > 48 * 1024) {
    o.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (o.err == cudaSuccess) {
    o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.blocks, kernel, threads, smem);
  }
  return o;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// the widest vector (16, 8 or 4 bytes, else one element) that divides both
// base addresses and the row pitch
int vec_bytes(const void* delta, const void* out, long long pitch, int elem) {
  const auto a = reinterpret_cast<unsigned long long>(delta);
  const auto b = reinterpret_cast<unsigned long long>(out);
  for (int w = kMaxVecBytes; w > elem; w /= 2) {
    if (a % w == 0 && b % w == 0 && pitch % w == 0) return w;
  }
  return elem;
}

template <typename T, int R, int V>
cudaError_t run_stream(const Launch& a, Plan* plan) {
  static const Occupancy occ = occupancy(relay_mix_stream_kernel<T, R, V>, kStreamThreads, 0);
  if (occ.err != cudaSuccess) return occ.err;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.D / V + kStreamThreads - 1) / kStreamThreads;
  const long long wave = static_cast<long long>(sms) * occ.blocks;
  const int cols = static_cast<int>(tiles < wave ? tiles : wave);
  // fewer tiles than SMs (small D): the row passes spread over blockIdx.y
  constexpr int G = stream_rows(R, V);
  const int passes = (a.n + G - 1) / G;
  const int rows = tiles >= sms ? 1 : std::min(passes, std::max(1, sms / cols));
  *plan = {1, V * static_cast<int>(sizeof(T)), cols * rows, occ.blocks, kStreamThreads};
  if (!a.launch) return cudaSuccess;
  relay_mix_stream_kernel<T, R, V><<<dim3(cols, rows), kStreamThreads, 0, a.stream>>>(
      static_cast<const float*>(a.w), static_cast<const T*>(a.delta), static_cast<T*>(a.out),
      a.n, a.D);
  return cudaGetLastError();
}

template <typename T, int RT, int V>
cudaError_t run_slab(const Launch& a, Plan* plan) {
  constexpr int smem = kSlabStages * slab_stage_bytes<T, RT>();
  static const Occupancy occ = occupancy(relay_mix_slab_kernel<T, RT, V>, kSlabThreads, smem);
  if (occ.err != cudaSuccess) return occ.err;
  const long long cols = (a.D + kSlabCols - 1) / kSlabCols;
  const int rows = (a.n + RT - 1) / RT;
  *plan = {2, V * static_cast<int>(sizeof(T)), static_cast<int>(cols * rows), occ.blocks,
           kSlabThreads};
  if (!a.launch) return cudaSuccess;
  relay_mix_slab_kernel<T, RT, V>
      <<<dim3(static_cast<unsigned>(cols), static_cast<unsigned>(rows)), kSlabThreads, smem,
         a.stream>>>(static_cast<const float*>(a.w), static_cast<const T*>(a.delta),
                     static_cast<T*>(a.out), a.n, a.D);
  return cudaGetLastError();
}

// the instance for the widest vector ≤ VB bytes that vb (a power of two
// ≥ sizeof(T)) allows
template <typename T, int R, int VB>
cudaError_t stream_at(int vb, const Launch& a, Plan* plan) {
  if constexpr (VB > static_cast<int>(sizeof(T))) {
    if (vb < VB) return stream_at<T, R, VB / 2>(vb, a, plan);
  }
  return run_stream<T, R, VB / static_cast<int>(sizeof(T))>(a, plan);
}

template <typename T, int RT, int VB>
cudaError_t slab_at(int vb, const Launch& a, Plan* plan) {
  if constexpr (VB > static_cast<int>(sizeof(T))) {
    if (vb < VB) return slab_at<T, RT, VB / 2>(vb, a, plan);
  }
  return run_slab<T, RT, VB / static_cast<int>(sizeof(T))>(a, plan);
}

template <typename T, int R>
cudaError_t stream_rows_of(int vb, const Launch& a, Plan* plan) {
  return stream_at<T, R, stream_vec_cap(R)>(vb, a, plan);
}

template <typename T>
cudaError_t dispatch_mix(const Launch& a, Plan* plan) {
  constexpr int e = sizeof(T);
  const int vb = vec_bytes(a.delta, a.out, a.D * e, e);
  static_assert(kStreamMaxRows <= 32, "the stream path's row counts below end at 32");
  if (a.n <= kStreamMaxRows) {
    if (a.n <= 4) return stream_rows_of<T, 4>(vb, a, plan);
    if (a.n <= 8) return stream_rows_of<T, 8>(vb, a, plan);
    if (a.n <= 12) return stream_rows_of<T, 12>(vb, a, plan);
    if (a.n <= 16) return stream_rows_of<T, 16>(vb, a, plan);
    if (a.n <= 24) return stream_rows_of<T, 24>(vb, a, plan);
    return stream_rows_of<T, 32>(vb, a, plan);
  }
  if (a.n <= 64) return slab_at<T, 64, kMaxVecBytes>(vb, a, plan);
  return slab_at<T, 128, kMaxVecBytes>(vb, a, plan);
}

cudaError_t mix(const Launch& a, int dtype, Plan* plan) {
  if (a.n <= 0 || a.D <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_mix<float>(a, plan);
  if (dtype == 1) return dispatch_mix<__nv_bfloat16>(a, plan);
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t run_fused(const Launch& a, Plan* plan) {
  static const Occupancy occ = occupancy(fused_aggregate_kernel<T, V>, kFusedThreads, 0);
  if (occ.err != cudaSuccess) return occ.err;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.D / V + kFusedThreads - 1) / kFusedThreads;
  const long long wave = static_cast<long long>(sms) * occ.blocks;
  *plan = {0, V * static_cast<int>(sizeof(T)), static_cast<int>(tiles < wave ? tiles : wave),
           occ.blocks, kFusedThreads, kFusedThreads};
  if (!a.launch) return cudaSuccess;
  fused_aggregate_kernel<T, V><<<plan->grid, kFusedThreads, 0, a.stream>>>(
      static_cast<const float*>(a.w), static_cast<const T*>(a.delta), static_cast<T*>(a.out),
      a.n, a.D);
  return cudaGetLastError();
}

// bytes of fused_aggregate_2d's (S, D) f32 partials for S ranges
long long split_workspace(long long D, int splits) {
  return splits <= 1 ? 0 : splits * split_pitch(D) * static_cast<long long>(sizeof(float));
}

// its tile counters: a column tile (as many as one-element vectors make)
long long split_counters(long long D, int splits) {
  return splits <= 1 ? 0 : (D + kSplitThreads - 1) / kSplitThreads;
}

template <typename T, int V>
cudaError_t run_split(const Launch& a, Plan* plan) {
  constexpr int VB = V * static_cast<int>(sizeof(T));
  constexpr int row_bytes = kSplitThreads * V * static_cast<int>(sizeof(float));
  const long long tiles = (a.D / V + kSplitThreads - 1) / kSplitThreads;
  const int range = (a.n + a.splits - 1) / a.splits;
  // the range's vectors, or as many rows of partials as the chunk allows
  const int smem = std::max(range * kSplitThreads * VB,
                            static_cast<int>(std::min<long long>(
                                static_cast<long long>(a.splits) * row_bytes,
                                std::max(kSplitPartialBytes, row_bytes))));
  const long long grid = tiles * a.splits;
  if (range > kSplitMaxRange || smem > kSplitSmemBytes || grid > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  auto kernel = fused_aggregate_split_kernel<T, V>;
  if (!a.launch) {
    Occupancy occ = occupancy(kernel, kSplitThreads * kSplitWarps, smem);
    if (occ.err != cudaSuccess) return occ.err;
    *plan = {0, VB, static_cast<int>(grid), occ.blocks, kSplitThreads * kSplitWarps,
             kSplitThreads};
    return cudaSuccess;
  }
  if (a.partials == nullptr || a.counters == nullptr || a.counters_len < tiles) {
    return cudaErrorInvalidValue;
  }
  kernel<<<static_cast<unsigned>(grid), kSplitThreads * kSplitWarps, smem, a.stream>>>(
      static_cast<const float*>(a.w), static_cast<const T*>(a.delta), static_cast<T*>(a.out),
      a.n, a.D, a.splits, smem / row_bytes, static_cast<float*>(a.partials),
      static_cast<unsigned*>(a.counters));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t fused_at(const Launch& a, Plan* plan) {
  return a.splits > 1 ? run_split<T, V>(a, plan) : run_fused<T, V>(a, plan);
}

template <typename T>
cudaError_t dispatch_fused(const Launch& a, Plan* plan) {
  constexpr int e = sizeof(T);
  switch (vec_bytes(a.delta, a.out, a.D * e, e)) {
    case 16:
      return fused_at<T, 16 / e>(a, plan);
    case 8:
      return fused_at<T, 8 / e>(a, plan);
    case 4:
      return fused_at<T, 4 / e>(a, plan);
    default:
      return fused_at<T, 1>(a, plan);
  }
}

cudaError_t fused(const Launch& a, int dtype, Plan* plan) {
  if (a.n <= 0 || a.D <= 0 || a.splits < 1) return cudaErrorInvalidValue;
  // every range non-empty: (S − 1)·⌈n/S⌉ < n
  if (static_cast<long long>(a.splits - 1) * ((a.n + a.splits - 1) / a.splits) >= a.n) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch_fused<float>(a, plan);
  if (dtype == 1) return dispatch_fused<__nv_bfloat16>(a, plan);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of Δ and of the output)
extern "C" int relay_mix_2d_launch(const void* A, const void* delta, void* out, int n,
                                   long long D, int dtype, void* stream) {
  Plan plan;
  return static_cast<int>(
      mix({A, delta, out, n, D, static_cast<cudaStream_t>(stream), true}, dtype, &plan));
}

// splits: S, the origin ranges (1 for the single chain).  For S > 1:
// partials, fused_aggregate_2d_workspace(D, splits) bytes of scratch on the
// launch's stream, 16-byte aligned; counters, counters_len ≥ the count that
// function reports of 32-bit counters, zero on entry and left zero (no two
// launches that may run at once may share them).  All unused for S = 1.
extern "C" int fused_aggregate_2d_launch(const void* c, const void* delta, void* out, int n,
                                         long long D, int dtype, int splits, void* partials,
                                         void* counters, long long counters_len,
                                         void* stream) {
  Plan plan;
  return static_cast<int>(fused({c, delta, out, n, D, static_cast<cudaStream_t>(stream), true,
                                 splits, partials, counters, counters_len},
                                dtype, &plan));
}

// Bytes of partials that fused_aggregate_2d_launch needs for S = splits;
// *counters = the tile counters it needs.
extern "C" long long fused_aggregate_2d_workspace(long long D, int splits, long long* counters) {
  *counters = split_counters(D, splits);
  return split_workspace(D, splits);
}

// The id of the CUDA graph capture under way on the stream, 0 if none: the
// launches of one capture on one stream run in order at every replay.
extern "C" unsigned long long stream_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess) {
    return 0;
  }
  return status == cudaStreamCaptureStatusActive ? id : 0;
}

// Fills plan[0..4] = {path (1 stream, 2 slab), vector bytes, grid blocks,
// resident blocks an SM, threads a block} of the launch that
// relay_mix_2d_launch would make for these operands; launches nothing.
extern "C" int relay_mix_2d_plan(const void* delta, void* out, int n, long long D, int dtype,
                                 int* plan) {
  Plan p{0, 0, 0, 0, 0, 0};
  const cudaError_t err = mix({nullptr, delta, out, n, D, nullptr, false}, dtype, &p);
  plan[0] = p.path;
  plan[1] = p.vec_bytes;
  plan[2] = p.grid;
  plan[3] = p.blocks_per_sm;
  plan[4] = p.threads;
  return static_cast<int>(err);
}

// Fills plan[0..4] = {vector bytes, grid blocks, resident blocks an SM,
// threads a block, column vectors a tile} of the launch that
// fused_aggregate_2d_launch would make for these operands and S = splits;
// launches nothing.
extern "C" int fused_aggregate_2d_plan(const void* delta, void* out, int n, long long D,
                                       int dtype, int splits, int* plan) {
  Plan p{0, 0, 0, 0, 0, 0};
  const cudaError_t err =
      fused({nullptr, delta, out, n, D, nullptr, false, splits}, dtype, &p);
  plan[0] = p.vec_bytes;
  plan[1] = p.grid;
  plan[2] = p.blocks_per_sm;
  plan[3] = p.threads;
  plan[4] = p.tile;
  return static_cast<int>(err);
}
