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
// in f32 in ascending origin order with fmaf from 0, and the result is
// stored in Δ's dtype.  No atomics and no split of the origins across
// blocks: two calls are bitwise equal.  The kernels launch on the caller's
// stream, never synchronise and allocate nothing.
//
// relay_mix_2d.  A product with very few rows (n ≈ 10 on the main path) over
// a very long D: each Δ element is used n times for one load, and the kernel
// is bound by device-memory bytes (n·D elements in, n·D out).  Each block
// owns a tile of 256 columns, one column a thread, so that a warp reads 32
// neighbouring elements of a row.  It keeps R output rows in registers
// (R = the next power of two ≥ n, at most 32) and loops over the origins in
// chunks of A staged through shared memory (one broadcast read per FMA);
// n > 32 takes ceil(n / 32) passes over its tile.  The ragged tail of D is
// masked; nothing is padded or copied.
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
//     vector of V·sizeof(T) bytes: the widest of 16, 8 or 4 bytes that
//     divides Δ's base address, the output's base address and the row pitch
//     D·sizeof(T) (else one element).  Then every row starts on a vector
//     boundary and V divides D, so the ragged tail is whole vectors, masked;
//     nothing is padded or copied.  The main shape's pitch is ≡ 8 (mod 16):
//     f32 takes 8-byte loads there, bf16 (pitch ≡ 4) 4-byte ones;
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
//
// Interface: plain C launchers, loaded with ctypes.  Each returns
// cudaGetLastError() (or the error of a failed query) as an int
// (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // columns per block of the mix
constexpr int kOriginChunk = 64;   // origins of A staged per shared-memory pass
constexpr int kCoeffChunk = 1024;  // coefficients of c staged per pass

constexpr int kFusedThreads = 128;  // threads per block of the fused kernel
constexpr int kFusedMinBlocks = 9;  // resident blocks an SM: ≤ 56 registers a thread
constexpr int kMaxVecBytes = 16;    // widest load of the fused kernel
constexpr int kChunkRegs = 24;      // registers of Δ a thread loads before it sums

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // round to nearest even, as torch's and XLA's casts
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
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

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    relay_mix_kernel(const float* __restrict__ A, const T* __restrict__ delta,
                     T* __restrict__ out, int n, long long D) {
  // a_s[o][r] = A[r0 + r, o0 + o], rounded to T; row-contiguous in r so the
  // R weights of one origin are one vector load, the same for every thread
  __shared__ __align__(16) float a_s[kOriginChunk][R];
  const long long d = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = d < D;
  for (int r0 = 0; r0 < n; r0 += R) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int o0 = 0; o0 < n; o0 += kOriginChunk) {
      const int oc = min(kOriginChunk, n - o0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int i = threadIdx.x; i < kOriginChunk * R; i += kThreads) {
        const int o = i / R;
        const int r = i % R;
        float v = 0.f;
        if (o < oc && r0 + r < n) {
          v = Io<T>::round(A[static_cast<long long>(r0 + r) * n + o0 + o]);
        }
        a_s[o][r] = v;
      }
      __syncthreads();
      if (live) {
        const T* col = delta + static_cast<long long>(o0) * D + d;
#pragma unroll 8
        for (int o = 0; o < oc; ++o) {
          const float x = Io<T>::load(col + static_cast<long long>(o) * D);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(a_s[o][r], x, acc[r]);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r < n) Io<T>::store(out + static_cast<long long>(r0 + r) * D + d, acc[r]);
      }
    }
  }
}

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

template <typename T, int R>
void launch_mix(const void* A, const void* delta, void* out, int n, long long D,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads));
  relay_mix_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const T*>(delta), static_cast<T*>(out), n, D);
}

template <typename T>
void dispatch_mix(const void* A, const void* delta, void* out, int n, long long D,
                  cudaStream_t stream) {
  if (n <= 1) {
    launch_mix<T, 1>(A, delta, out, n, D, stream);
  } else if (n <= 2) {
    launch_mix<T, 2>(A, delta, out, n, D, stream);
  } else if (n <= 4) {
    launch_mix<T, 4>(A, delta, out, n, D, stream);
  } else if (n <= 8) {
    launch_mix<T, 8>(A, delta, out, n, D, stream);
  } else if (n <= 16) {
    launch_mix<T, 16>(A, delta, out, n, D, stream);
  } else {
    launch_mix<T, 32>(A, delta, out, n, D, stream);
  }
}

// What a fused launch uses: vector bytes, blocks in the grid, resident blocks
// an SM (fused_aggregate_2d_plan hands it out as an int[3])
struct FusedPlan {
  int vec_bytes;
  int grid;
  int blocks_per_sm;
};

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

template <typename T, int V>
cudaError_t run_fused(const void* c, const void* delta, void* out, int n, long long D,
                      cudaStream_t stream, bool launch, FusedPlan* plan) {
  // resident blocks an SM for this instance: asked once, kept for the process
  struct Occupancy {
    cudaError_t err;
    int blocks;
  };
  static const Occupancy occ = [] {
    Occupancy o{cudaSuccess, 0};
    o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o.blocks, fused_aggregate_kernel<T, V>, kFusedThreads, 0);
    return o;
  }();
  if (occ.err != cudaSuccess) return occ.err;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (D / V + kFusedThreads - 1) / kFusedThreads;
  const long long wave = static_cast<long long>(sms) * occ.blocks;
  plan->vec_bytes = V * static_cast<int>(sizeof(T));
  plan->blocks_per_sm = occ.blocks;
  plan->grid = static_cast<int>(tiles < wave ? tiles : wave);
  if (launch) {
    fused_aggregate_kernel<T, V><<<plan->grid, kFusedThreads, 0, stream>>>(
        static_cast<const float*>(c), static_cast<const T*>(delta), static_cast<T*>(out), n, D);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_fused(const void* c, const void* delta, void* out, int n, long long D,
                           cudaStream_t stream, bool launch, FusedPlan* plan) {
  constexpr int e = sizeof(T);
  switch (vec_bytes(delta, out, D * e, e)) {
    case 16:
      return run_fused<T, 16 / e>(c, delta, out, n, D, stream, launch, plan);
    case 8:
      return run_fused<T, 8 / e>(c, delta, out, n, D, stream, launch, plan);
    case 4:
      return run_fused<T, 4 / e>(c, delta, out, n, D, stream, launch, plan);
    default:
      return run_fused<T, 1>(c, delta, out, n, D, stream, launch, plan);
  }
}

cudaError_t fused(const void* c, const void* delta, void* out, int n, long long D, int dtype,
                  cudaStream_t stream, bool launch, FusedPlan* plan) {
  if (n <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_fused<float>(c, delta, out, n, D, stream, launch, plan);
  if (dtype == 1) {
    return dispatch_fused<__nv_bfloat16>(c, delta, out, n, D, stream, launch, plan);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of Δ and of the output)
extern "C" int relay_mix_2d_launch(const void* A, const void* delta, void* out, int n,
                                   long long D, int dtype, void* stream) {
  if (n <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch_mix<float>(A, delta, out, n, D, s);
  } else if (dtype == 1) {
    dispatch_mix<__nv_bfloat16>(A, delta, out, n, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_aggregate_2d_launch(const void* c, const void* delta, void* out, int n,
                                         long long D, int dtype, void* stream) {
  FusedPlan plan;
  return static_cast<int>(
      fused(c, delta, out, n, D, dtype, static_cast<cudaStream_t>(stream), true, &plan));
}

// Fills plan[0..2] = {vector bytes, grid blocks, resident blocks an SM} of the
// launch that fused_aggregate_2d_launch would make for these operands; launches
// nothing.
extern "C" int fused_aggregate_2d_plan(const void* delta, void* out, int n, long long D,
                                       int dtype, int* plan) {
  FusedPlan p{0, 0, 0};
  const cudaError_t err = fused(nullptr, delta, out, n, D, dtype, nullptr, false, &p);
  plan[0] = p.vec_bytes;
  plan[1] = p.grid;
  plan[2] = p.blocks_per_sm;
  return static_cast<int>(err);
}
