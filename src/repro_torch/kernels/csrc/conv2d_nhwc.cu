// Hand-written Hopper (sm_90a) kernels for ResNet-20/GN's client-batched
// convolutions, in the model's own layouts: activations NHWC, weights HWIO,
// clients as an explicit leading dimension.
//
//   conv2d_fprop   y  = conv(x, w)      x (n, B, H, W, Cin), w (n, kh, kw, Cin, Cout)
//                                       → y (n, B, Ho, Wo, Cout)
//   conv2d_dgrad   dx = conv_x^T(dy, w) dy (n, B, Ho, Wo, Cout) → dx (n, B, H, W, Cin)
//   conv2d_wgrad   dw = conv_w^T(x, dy) → dw (n, kh, kw, Cin, Cout)
//
// They replace no TPU kernel: the JAX package left its convolutions to XLA
// (src/repro/models/resnet.py, lax.conv_general_dilated).  They were added
// because the port's local update, vmapped over the clients, handed every
// convolution to cuDNN as one grouped NCHW convolution behind an F.pad and
// permute copies, and at f32 with TF32 off and deterministic algorithms
// cuDNN ran those at about a twentieth of the card's f32 rate, a fifth of
// the time in layout transposes.
//
// Padding is XLA's SAME: before = total / 2, after = total - before, with
// total = max((out - 1)·stride + k - size, 0), so a stride-2 3×3 on an even
// map pads (0, 1).  It lives in the kernels' index bounds: an input pixel
// outside the map is never read, its products are skipped by zero fill.
//
// What bounds them.  Every product is f32 on the CUDA cores (no tensor
// cores: TF32 would change the numbers the f32 configuration states), so the
// least time is the f32 FLOPs over 67 TFLOP/s; the bytes (each tensor read
// once) are 40–200× below that line at ResNet-20's shapes.  So the design is
// a register-tiled implicit GEMM whose inner loop is almost all FMAs:
//   * fprop and dgrad (conv_gemm_kernel): a block of 128 threads owns
//     8192 / N output pixels × all N output channels of one client (N = Cout
//     for fprop, Cin for dgrad: 512 pixels at N = 16, 128 at N = 64), a
//     thread an 8 × 8 register tile (pixels strided over the block, channel
//     pairs of 4), so each shared-memory read of 16 bytes feeds 16 FMAs.
//     The reduction (taps × input channels) runs in stages of 8: a stage's
//     input tile (one tap's shifted pixels × 8 channels, out-of-map pixels
//     zero-filled) and weight tile (8 × N) are copied into shared memory
//     with cp.async, double-buffered, the next stage in flight while the
//     current one is summed.  Each thread works out its pixels' source
//     offsets once a tap, so a stage's copies cost a few integer ops.
//     The block size makes the grid fill the card at every stage of the
//     model: 1,280 blocks at 32×32 / 16 channels, 640 at 16×16 / 32 and 320
//     at 8×8 / 64 for 10 clients of 64 images.
//   * dgrad is the same core over dy, with the weights read transposed by
//     index (w[tap][ci][co] as row co, column ci: no weight copy).  At stride
//     2 a block owns input pixels of one parity class (h mod 2, w mod 2), and
//     only the taps whose parity matches reach them: a 3×3 class sums 1, 2
//     or 4 taps, never nine of which most read nothing.
//   * wgrad (conv_wgrad_kernel): per client a reduction over all B·Ho·Wo
//     pixels into a (kh·kw·Cin) × Cout tile.  A block owns 64 rows (tap,
//     input channel) × all Cout columns of one client over one slab of
//     pixels (a thread a 4 × 4 tile; stages of 16 pixels, cp.async,
//     double-buffered) and writes an f32 partial; the slabs are the caller's
//     (a function of B·Ho·Wo alone, kernels/conv.py), and
//     conv_wgrad_reduce_kernel adds each element's partials in ascending
//     slab order.  No atomics on values.
//   * The stem's 3 input channels (not a multiple of 8) take a path that
//     copies element by element (kVecK = false); dgrad of the stem is never
//     asked for (the images need no gradient).
//
// Order.  Every output element is one fmaf chain from 0 in a fixed order:
// fprop and dgrad over taps (ascending kernel row, then column; only the
// matching taps in dgrad) and within a tap ascending channel; wgrad over
// the pixels of a slab in ascending order, then the slab partials added in
// ascending slab order.  Tile sizes depend only on the channel count and
// the slabs only on B·Ho·Wo, never on the number of clients, so a client's
// result is bitwise the same alone, among 10, or in a sharded rank's block,
// and two runs are bitwise equal.
//
// The kernels launch on the caller's stream, never synchronise and allocate
// nothing (wgrad's partials come from the caller).  Interface: plain C
// launchers loaded with ctypes, each returning cudaGetLastError() as an int
// (0 = launched, -1 = a shape these kernels do not take).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // fprop / dgrad block
constexpr int kTM = 8;          // output pixels a thread (fprop / dgrad)
constexpr int kTN = 8;          // output channels a thread (fprop / dgrad)
constexpr int kBK = 8;          // reduction depth a stage (fprop / dgrad)
constexpr int kWRows = 64;      // (tap, input channel) rows a wgrad block
constexpr int kWBK = 16;        // pixels a wgrad stage
constexpr int kReduceThreads = 256;

// n, B, H, W, Cin, Cout, kh, kw, stride, Ho, Wo, pad_top, pad_left
struct Shape {
  int n, B, H, W, Cin, Cout, kh, kw, stride, Ho, Wo, pt, pl;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; valid = false writes zeros and reads nothing
// (the source is then any valid address: the tensor's base)
__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A pixel's packed coordinates: (b << 16) | ((a + 128) << 8) | (e + 128),
// with (a, e) the row and column the tap offsets start from; -1 for a row
// of the tile beyond the map.  The launcher holds H, W ≤ 120 and B < 2^15.
__device__ __forceinline__ int pack(int b, int a, int e) {
  return (b << 16) | ((a + 128) << 8) | (e + 128);
}

// fprop (kDgrad = false): out = y, src = x, rows = output pixels of the
// client (b, oh, ow), reduction = taps × Cin.  dgrad: out = dx, src = dy,
// rows = input pixels of one stride-parity class (blockIdx.y), reduction =
// the class's taps × Cout.  N = the output channels (Cout / Cin).
template <int N, bool kDgrad, bool kVecK>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const float* __restrict__ src, const float* __restrict__ w,
                 float* __restrict__ out, Shape s) {
  constexpr int TX = N / 8;            // thread columns: channels 4tx.. and 4tx + N/2..
  constexpr int TY = kThreads / TX;    // thread rows: pixels ty + TY·r
  constexpr int BM = TY * kTM;         // pixels a block
  constexpr int BP = N + 4;            // weight tile pitch (conflict-free fills and reads)
  constexpr int FP = kVecK ? BM / 64 : BM / kThreads;  // pixels a thread copies
  __shared__ __align__(16) float As[2][BM * kBK];      // [pixel][k]
  __shared__ __align__(16) float Bs[2][kBK * BP];      // [k][channel]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int st = s.stride;
  const int c = blockIdx.z;

  int ph = 0, pw = 0, Hc = s.Ho, Wc = s.Wo;
  if (kDgrad) {
    ph = blockIdx.y / st;
    pw = blockIdx.y % st;
    Hc = (s.H - ph + st - 1) / st;
    Wc = (s.W - pw + st - 1) / st;
  }
  const int Mc = s.B * Hc * Wc;
  const int m0 = blockIdx.x * BM;
  if (m0 >= Mc) return;  // the whole block: a smaller class's ragged end

  // the taps this block sums: all of them (fprop), or those of its parity
  int ti0 = 0, tj0 = 0, ni = s.kh, nj = s.kw, tstep = 1;
  if (kDgrad) {
    ti0 = (ph + s.pt) % st;
    tj0 = (pw + s.pl) % st;
    ni = ti0 < s.kh ? (s.kh - ti0 + st - 1) / st : 0;
    nj = tj0 < s.kw ? (s.kw - tj0 + st - 1) / st : 0;
    tstep = st;
  }
  const int srcH = kDgrad ? s.Ho : s.H, srcW = kDgrad ? s.Wo : s.W;
  const int srcC = kDgrad ? s.Cout : s.Cin;  // channels summed a tap
  const int outH = kDgrad ? s.H : s.Ho, outW = kDgrad ? s.W : s.Wo;
  const float* srcc = src + (size_t)c * s.B * srcH * srcW * srcC;
  const float* wc = w + (size_t)c * s.kh * s.kw * s.Cin * s.Cout;
  float* outc = out + (size_t)c * s.B * outH * outW * N;

  const int ktotal = s.kh * s.kw * s.Cin;  // scalar path: the flattened reduction
  const int chunks = srcC / kBK;           // vector path: stages a tap
  const int nstages = kVecK ? ni * nj * chunks : (ktotal + kBK - 1) / kBK;

  // the pixels this thread copies, and their packed coordinates
  const int half = tid & 1;  // vector path: which 4 of a stage's 8 channels
  int code[FP];
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    const int p = kVecK ? (tid >> 1) + 64 * f : tid + kThreads * f;
    const int m = m0 + p;
    code[f] = -1;
    if (m < Mc) {
      const int b = m / (Hc * Wc), r = m - b * (Hc * Wc);
      const int yy = r / Wc, xx = r - yy * Wc;
      if (kDgrad) code[f] = pack(b, yy * st + ph + s.pt, xx * st + pw + s.pl);
      else code[f] = pack(b, yy * st - s.pt, xx * st - s.pl);
    }
  }

  // element offset of pixel f's source at tap (i, j), or -1 (zero fill)
  auto source = [&](int f, int i, int j) -> int {
    const int cd = code[f];
    if (cd < 0) return -1;
    const int b = cd >> 16, a = ((cd >> 8) & 255) - 128, e = (cd & 255) - 128;
    int sy, sx;
    if (kDgrad) {
      const int ty2 = a - i, tx2 = e - j;  // ≥ 0 and ≡ 0 (mod stride) at a matching tap
      if (ty2 < 0 || tx2 < 0) return -1;
      sy = ty2 >> (st - 1);  // stride 1 or 2: no integer division
      sx = tx2 >> (st - 1);
    } else {
      sy = a + i;
      sx = e + j;
    }
    if ((unsigned)sy >= (unsigned)srcH || (unsigned)sx >= (unsigned)srcW) return -1;
    return ((b * srcH + sy) * srcW + sx) * srcC;
  };

  int off[kVecK ? FP : 1];
  auto load_stage = [&](int stg, int buf) {
    float* as = As[buf];
    float* bs = Bs[buf];
    if (kVecK) {
      const int tap = stg / chunks;
      const int c0 = (stg - tap * chunks) * kBK;
      const int i = ti0 + tstep * (tap / nj), j = tj0 + tstep * (tap % nj);
      if (c0 == 0) {
#pragma unroll
        for (int f = 0; f < FP; ++f) off[f] = source(f, i, j);
      }
#pragma unroll
      for (int f = 0; f < FP; ++f) {
        const int p = (tid >> 1) + 64 * f;
        const bool ok = off[f] >= 0;
        cp_async16(as + p * kBK + 4 * half, ok ? srcc + off[f] + c0 + 4 * half : srcc, ok);
      }
      const float* wt = wc + (size_t)(i * s.kw + j) * s.Cin * s.Cout;
      if (!kDgrad) {  // rows c0.. of the tap's (Cin, Cout) matrix, 16 bytes a thread
        if (tid < 2 * N) {
          const int row = tid / (N / 4), col = 4 * (tid % (N / 4));
          cp_async16(bs + row * BP + col, wt + (size_t)(c0 + row) * N + col, true);
        }
      } else {  // Bs[k][ci] = w[tap][ci][c0 + k]: the transpose by index
#pragma unroll
        for (int e = tid; e < kBK * N; e += kThreads) {
          const int kk = e & (kBK - 1), ci = e >> 3;
          cp_async4(bs + kk * BP + ci, wt + (size_t)ci * s.Cout + c0 + kk, true);
        }
      }
    } else {  // fprop with Cin % 8 != 0: k = (tap, ci) flattened, element by element
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const int k = stg * kBK + kk;
        const bool kin = k < ktotal;
        const int tap = kin ? k / s.Cin : 0, ci = k - tap * s.Cin;
        const int i = tap / s.kw, j = tap - i * s.kw;
#pragma unroll
        for (int f = 0; f < FP; ++f) {
          const int p = tid + kThreads * f;
          const int o = kin ? source(f, i, j) : -1;
          cp_async4(as + p * kBK + kk, o >= 0 ? srcc + o + ci : srcc, o >= 0);
        }
      }
      if (tid < 2 * N) {
        const int row = tid / (N / 4), col = 4 * (tid % (N / 4));
        const int k = stg * kBK + row;
        cp_async16(bs + row * BP + col, k < ktotal ? wc + (size_t)k * N + col : wc, k < ktotal);
      }
    }
    cp_async_commit();
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int q = 0; q < kTN; ++q) acc[r][q] = 0.0f;

  if (nstages > 0) load_stage(0, 0);
  for (int stg = 0; stg < nstages; ++stg) {
    if (stg + 1 < nstages) {
      load_stage(stg + 1, (stg + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[stg & 1];
    const float* bs = Bs[stg & 1];
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float4 a[kTM];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
        a[r] = *reinterpret_cast<const float4*>(as + (ty + TY * r) * kBK + 4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bs + (4 * kq + kk) * BP;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 4 * tx + N / 2);
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const float av = lane4(a[r], kk);
          acc[r][0] = fmaf(av, b0.x, acc[r][0]);
          acc[r][1] = fmaf(av, b0.y, acc[r][1]);
          acc[r][2] = fmaf(av, b0.z, acc[r][2]);
          acc[r][3] = fmaf(av, b0.w, acc[r][3]);
          acc[r][4] = fmaf(av, b1.x, acc[r][4]);
          acc[r][5] = fmaf(av, b1.y, acc[r][5]);
          acc[r][6] = fmaf(av, b1.z, acc[r][6]);
          acc[r][7] = fmaf(av, b1.w, acc[r][7]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int m = m0 + ty + TY * r;
    if (m >= Mc) continue;
    const int b = m / (Hc * Wc), rr = m - b * (Hc * Wc);
    const int yy = rr / Wc, xx = rr - yy * Wc;
    const int oy = kDgrad ? yy * st + ph : yy, ox = kDgrad ? xx * st + pw : xx;
    float* o = outc + ((size_t)(b * outH + oy) * outW + ox) * N;
    *reinterpret_cast<float4*>(o + 4 * tx) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(o + 4 * tx + N / 2) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// wgrad partial: rows k0.. (k = (tap, ci) flattened, tap = (i, j)) × all N =
// Cout columns of client blockIdx.z, summed over the pixels of slab
// blockIdx.y, into partials (n, splits, kh·kw·Cin, Cout).
template <int N, bool kVecK>
__global__ void __launch_bounds__(4 * N)
conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ partials, Shape s, int slab, int splits) {
  constexpr int T = 4 * N;            // threads: 16 row groups × N / 4 column groups
  constexpr int TXw = N / 4;
  constexpr int AJ = kWBK * kWRows / 4 / T;  // 16-byte input copies a thread a stage
  __shared__ __align__(16) float As[2][kWBK * kWRows];  // [pixel][row]
  __shared__ __align__(16) float Bs[2][kWBK * N];       // [pixel][column]

  const int tid = threadIdx.x;
  const int tx = tid % TXw, ty = tid / TXw;
  const int c = blockIdx.z, split = blockIdx.y;
  const int k0 = blockIdx.x * kWRows;
  const int K = s.kh * s.kw * s.Cin;
  const int HWo = s.Ho * s.Wo;
  const int P = s.B * HWo;
  const int l0 = split * slab;
  const int l1 = min(P, l0 + slab);
  const int nstages = (l1 - l0 + kWBK - 1) / kWBK;
  const int st = s.stride;
  const float* xc = x + (size_t)c * s.B * s.H * s.W * s.Cin;
  const float* dyc = dy + (size_t)c * P * N;

  // vector path: this thread copies row chunk rc (rows 4rc..4rc+3 of the
  // tile, one tap) of pixels pj; their coordinates advance a stage at a time
  const int rc = tid & 15;
  const int rbase = k0 + 4 * rc;
  const bool rin = rbase < K;
  int ci0 = 0, ti = 0, tj = 0;
  if (kVecK && rin) {
    const int tap = rbase / s.Cin;
    ci0 = rbase - tap * s.Cin;
    ti = tap / s.kw;
    tj = tap - ti * s.kw;
  }
  int pb[kVecK ? AJ : 1], poh[kVecK ? AJ : 1], pow_[kVecK ? AJ : 1];
  if (kVecK) {
#pragma unroll
    for (int j = 0; j < AJ; ++j) {
      const int l = l0 + (tid >> 4) + (T / 16) * j;
      pb[j] = l / HWo;
      const int r = l - pb[j] * HWo;
      poh[j] = r / s.Wo;
      pow_[j] = r - poh[j] * s.Wo;
    }
  }
  // scalar path (Cin % 4 != 0): this thread copies row tid of all 16
  // pixels, their coordinates stepped from the stage's first (sb, soh, sow)
  int sci = 0, si = 0, sj = 0, sb = 0, soh = 0, sow = 0;
  const bool srow_in = !kVecK && k0 + tid < K;
  if (srow_in) {
    const int k = k0 + tid, tap = k / s.Cin;
    sci = k - tap * s.Cin;
    si = tap / s.kw;
    sj = tap - si * s.kw;
  }
  if (!kVecK) {
    sb = l0 / HWo;
    const int r = l0 - sb * HWo;
    soh = r / s.Wo;
    sow = r - soh * s.Wo;
  }

  auto load_stage = [&](int stg, int buf) {
    float* as = As[buf];
    float* bs = Bs[buf];
    const int lb = l0 + stg * kWBK;
    if (kVecK) {
#pragma unroll
      for (int j = 0; j < AJ; ++j) {
        const int p = (tid >> 4) + (T / 16) * j;
        const int sy = poh[j] * st - s.pt + ti, sx = pow_[j] * st - s.pl + tj;
        const bool ok = rin && lb + p < l1 && (unsigned)sy < (unsigned)s.H &&
                        (unsigned)sx < (unsigned)s.W;
        cp_async16(as + p * kWRows + 4 * rc,
                   ok ? xc + ((size_t)(pb[j] * s.H + sy) * s.W + sx) * s.Cin + ci0 : xc, ok);
        // the next stage's pixel: kWBK further on
        pow_[j] += kWBK;
        while (pow_[j] >= s.Wo) {
          pow_[j] -= s.Wo;
          if (++poh[j] == s.Ho) {
            poh[j] = 0;
            ++pb[j];
          }
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < kWBK; ++p) {
        const int sy = soh * st - s.pt + si, sx = sow * st - s.pl + sj;
        const bool ok = srow_in && lb + p < l1 && (unsigned)sy < (unsigned)s.H &&
                        (unsigned)sx < (unsigned)s.W;
        if (tid < kWRows)
          cp_async4(as + p * kWRows + tid,
                    ok ? xc + ((size_t)(sb * s.H + sy) * s.W + sx) * s.Cin + sci : xc, ok);
        if (++sow == s.Wo) {  // the next pixel (the next stage's first after the last)
          sow = 0;
          if (++soh == s.Ho) {
            soh = 0;
            ++sb;
          }
        }
      }
    }
    {  // dy: 16 pixels × N channels, 16 bytes a thread
      const int p = tid / TXw, col = 4 * (tid % TXw);
      const bool ok = lb + p < l1;
      cp_async16(bs + p * N + col, ok ? dyc + (size_t)(lb + p) * N + col : dyc, ok);
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;

  if (nstages > 0) load_stage(0, 0);
  for (int stg = 0; stg < nstages; ++stg) {
    if (stg + 1 < nstages) {
      load_stage(stg + 1, (stg + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[stg & 1];
    const float* bs = Bs[stg & 1];
#pragma unroll
    for (int k = 0; k < kWBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(as + k * kWRows + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(bs + k * N + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
        acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
        acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
        acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

  float* pc = partials + ((size_t)c * splits + split) * K * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + 4 * ty + r;
    if (k < K)
      *reinterpret_cast<float4*>(pc + (size_t)k * N + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// dw[c][e] = the partials of client c at element e added in ascending slab
// order, four elements a thread
__global__ void __launch_bounds__(kReduceThreads)
conv_wgrad_reduce_kernel(const float4* __restrict__ partials, float4* __restrict__ out,
                         int per_client4, int splits) {
  const int c = blockIdx.y;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= per_client4) return;
  const float4* p = partials + (size_t)c * splits * per_client4 + e;
  float4 acc = p[0];
#pragma unroll 8  // the loads go ahead; the adds stay in ascending slab order
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = p[(size_t)sp * per_client4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[(size_t)c * per_client4 + e] = acc;
}

Shape read_shape(const int* v) {
  return Shape{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
}

// the shapes the kernels take (kernels/conv.py checks the same before a
// launch): output channels 16, 32 or 64, kernel ≤ 3 × 3, stride 1 or 2,
// maps ≤ 120 a side (packed coordinates), B < 2^15
bool shape_ok(const Shape& s) {
  return s.n >= 1 && s.n <= 65535 && s.B >= 1 && s.B < (1 << 15) && s.H >= 1 && s.H <= 120 &&
         s.W >= 1 && s.W <= 120 && s.kh >= 1 && s.kh <= 3 && s.kw >= 1 && s.kw <= 3 &&
         (s.stride == 1 || s.stride == 2) && s.Cin >= 1 && s.Cout >= 1;
}

bool width_ok(int N) { return N == 16 || N == 32 || N == 64; }

int block_rows(int N) { return kThreads / (N / 8) * kTM; }

// the grid of the fprop (direction 0) or dgrad (1) launch
dim3 gemm_grid(const Shape& s, bool dgrad) {
  const int N = dgrad ? s.Cin : s.Cout;
  const int bm = block_rows(N);
  if (!dgrad) return dim3((s.B * s.Ho * s.Wo + bm - 1) / bm, 1, s.n);
  const int st = s.stride;
  const int hc = (s.H + st - 1) / st, wc = (s.W + st - 1) / st;  // the largest class
  return dim3((s.B * hc * wc + bm - 1) / bm, st * st, s.n);
}

template <bool kDgrad>
int launch_gemm(const float* src, const float* w, float* out, const Shape& s, cudaStream_t st) {
  const int N = kDgrad ? s.Cin : s.Cout;
  const bool vec = kDgrad ? s.Cout % kBK == 0 : s.Cin % kBK == 0;
  const dim3 grid = gemm_grid(s, kDgrad);
  if (!vec && (kDgrad || N != 16)) return -1;
  switch (N) {
    case 16:
      if (vec) conv_gemm_kernel<16, kDgrad, true><<<grid, kThreads, 0, st>>>(src, w, out, s);
      else conv_gemm_kernel<16, false, false><<<grid, kThreads, 0, st>>>(src, w, out, s);
      break;
    case 32: conv_gemm_kernel<32, kDgrad, true><<<grid, kThreads, 0, st>>>(src, w, out, s); break;
    case 64: conv_gemm_kernel<64, kDgrad, true><<<grid, kThreads, 0, st>>>(src, w, out, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv2d_fprop_launch(const void* x, const void* w, void* y, const int* shape, void* stream) {
  const Shape s = read_shape(shape);
  if (!shape_ok(s) || !width_ok(s.Cout)) return -1;
  return launch_gemm<false>(static_cast<const float*>(x), static_cast<const float*>(w),
                            static_cast<float*>(y), s, static_cast<cudaStream_t>(stream));
}

int conv2d_dgrad_launch(const void* dy, const void* w, void* dx, const int* shape, void* stream) {
  const Shape s = read_shape(shape);
  if (!shape_ok(s) || !width_ok(s.Cin)) return -1;
  return launch_gemm<true>(static_cast<const float*>(dy), static_cast<const float*>(w),
                           static_cast<float*>(dx), s, static_cast<cudaStream_t>(stream));
}

// partials: (n, splits, kh·kw·Cin, Cout) f32 from the caller, or dw itself
// when splits == 1 (then no reduce is launched)
int conv2d_wgrad_launch(const void* x, const void* dy, void* dw, void* partials, const int* shape,
                        int slab, int splits, void* stream) {
  const Shape s = read_shape(shape);
  if (!shape_ok(s) || !width_ok(s.Cout) || slab < 1 || splits < 1 ||
      (long long)slab * splits < (long long)s.B * s.Ho * s.Wo)
    return -1;
  const bool vec = s.Cin % 4 == 0;
  if (!vec && s.Cout != 16) return -1;
  const int K = s.kh * s.kw * s.Cin;
  const dim3 grid((K + kWRows - 1) / kWRows, splits, s.n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits == 1 ? static_cast<float*>(dw) : static_cast<float*>(partials);
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  switch (s.Cout) {
    case 16:
      if (vec) conv_wgrad_kernel<16, true><<<grid, 64, 0, st>>>(xf, dyf, part, s, slab, splits);
      else conv_wgrad_kernel<16, false><<<grid, 64, 0, st>>>(xf, dyf, part, s, slab, splits);
      break;
    case 32: conv_wgrad_kernel<32, true><<<grid, 128, 0, st>>>(xf, dyf, part, s, slab, splits); break;
    default: conv_wgrad_kernel<64, true><<<grid, 256, 0, st>>>(xf, dyf, part, s, slab, splits); break;
  }
  if (splits > 1) {
    const int per4 = K * s.Cout / 4;
    const dim3 rgrid((per4 + kReduceThreads - 1) / kReduceThreads, s.n);
    conv_wgrad_reduce_kernel<<<rgrid, kReduceThreads, 0, st>>>(
        static_cast<const float4*>(partials), static_cast<float4*>(dw), per4, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// the launch a direction (0 fprop, 1 dgrad, 2 wgrad) makes for this shape,
// launching nothing: plan = {rows a block, grid x, grid y, grid z, threads}
int conv2d_plan(int direction, const int* shape, int slab_splits, int* plan) {
  const Shape s = read_shape(shape);
  if (direction < 2) {
    const int N = direction == 1 ? s.Cin : s.Cout;
    if (!shape_ok(s) || !width_ok(N)) return -1;
    const dim3 g = gemm_grid(s, direction == 1);
    plan[0] = block_rows(N);
    plan[1] = g.x;
    plan[2] = g.y;
    plan[3] = g.z;
    plan[4] = kThreads;
    return 0;
  }
  if (!shape_ok(s) || !width_ok(s.Cout)) return -1;
  plan[0] = kWRows;
  plan[1] = (s.kh * s.kw * s.Cin + kWRows - 1) / kWRows;
  plan[2] = slab_splits;
  plan[3] = s.n;
  plan[4] = 4 * s.Cout;
  return 0;
}

}  // extern "C"
