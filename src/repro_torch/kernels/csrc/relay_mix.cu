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
// in f32 in ascending origin order, and the result is stored in Δ's dtype.
//
// What bounds them: both are products with very few rows (n ≈ 10 on the main
// path) over a very long D, so each Δ element is used n times (mix) or once
// (fused) for one load.  They are bound by device-memory bytes: the mix moves
// n·D elements in and n·D out, the fused reduction n·D in and D out.  The
// design therefore keeps the weights in shared memory (one broadcast read per
// FMA), gives every thread one column of Δ so that a warp reads 32
// neighbouring elements of a row, and reads each Δ element once per pass.
// The ragged tail of D is masked; nothing is padded or copied.
//
// Each block owns a tile of 256 columns.  The mix keeps R output rows in
// registers (R = the next power of two ≥ n, at most 32) and loops over the
// origins in chunks staged through shared memory; n > 32 takes ceil(n / 32)
// passes over its tile.  No atomics, no cross-block reduction: the result is
// bitwise the same from run to run.  The kernels launch on the caller's
// stream, never synchronise and allocate nothing.
//
// Interface: plain C launchers, loaded with ctypes.  Each returns
// cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // columns per block
constexpr int kOriginChunk = 64;   // origins of A staged per shared-memory pass
constexpr int kCoeffChunk = 1024;  // coefficients of c staged per pass

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
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
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_aggregate_kernel(const float* __restrict__ c, const T* __restrict__ delta,
                           T* __restrict__ out, int n, long long D) {
  __shared__ float c_s[kCoeffChunk];
  const long long d = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = d < D;
  float acc = 0.f;
  for (int o0 = 0; o0 < n; o0 += kCoeffChunk) {
    const int oc = min(kCoeffChunk, n - o0);
    __syncthreads();
    for (int i = threadIdx.x; i < oc; i += kThreads) c_s[i] = Io<T>::round(c[o0 + i]);
    __syncthreads();
    if (live) {
      const T* col = delta + static_cast<long long>(o0) * D + d;
#pragma unroll 8
      for (int o = 0; o < oc; ++o) {
        acc = fmaf(c_s[o], Io<T>::load(col + static_cast<long long>(o) * D), acc);
      }
    }
  }
  if (live) Io<T>::store(out + d, acc);
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

template <typename T>
void launch_fused(const void* c, const void* delta, void* out, int n, long long D,
                  cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads));
  fused_aggregate_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(c), static_cast<const T*>(delta), static_cast<T*>(out), n, D);
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
  if (n <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fused<float>(c, delta, out, n, D, s);
  } else if (dtype == 1) {
    launch_fused<__nv_bfloat16>(c, delta, out, n, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
