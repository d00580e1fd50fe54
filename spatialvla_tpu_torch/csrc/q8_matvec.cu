// Weight-only int8 matvec for few rows, optionally with the Gemma RMSNorm
// fused in front: y[m, n] = scale[n] * sum_k bf16(x'[m, k]) * qt[n, k].
//
// Replaces the Pallas kernels spatialvla_tpu/ops/quant.py:int8_matmul
// (_q8_kernel / _q_dot_scaled, int8 per-channel branch) and
// quant.py:int8_rmsnorm_matmul (_q8_norm_kernel).
//
// What bounds it on the H100: weight bytes at one row (gate|up streams
// 42.5 MB a call), and at 16 rows the fp32 FMAs on the CUDA cores (16 per
// weight byte, 680 M for gate|up). The design:
//  * Rows are a template size MR in {1, 2, 4, 8, 16}, the smallest that
//    holds M; spare rows are zero in shared memory, so the row loop has no
//    guards. Each lane keeps MR x 4 fp32 sums.
//  * x is prepared once per block, not per output channel: the block
//    computes each row's fp32 inverse RMS (MR row groups of threads, 16-byte
//    loads), then writes the normed rows rounded to bf16 (bf16 x without the
//    norm: a cp.async copy) into shared memory, laid out [row][quarter of a
//    16-column unit][unit] so that the lanes of a warp read consecutive
//    8-byte words. The weight loop does no norm or rounding work.
//  * Blocks are persistent: a grid of at most the resident block slots walks
//    over tiles of output channels, and when all of K fits (up to 108 KB of
//    dynamic shared memory; 48 KB until the opt-in, which is never made
//    during a CUDA-graph capture) x is staged once for all of a block's
//    tiles. Otherwise (M = 16, K = 9216) each tile stages K in chunks.
//  * Each warp owns 4 output channels of a tile; each lane streams 16-byte
//    weight loads of all 4, one unit ahead of the one it computes (the first
//    unit of the next tile is loaded before the current tile's reduction),
//    and feeds every bf16 x value it reads from shared memory into 4
//    channels' FMAs. int8 -> fp32 is a byte permute and one subtraction
//    (exact), not an int-to-float conversion.
//  * Small N: the block's 8 warps split K 2-8 ways where that gives the
//    busiest lane fewer unit steps; partial sums meet in shared memory and
//    are added in warp order. Lanes reduce with a butterfly that halves the
//    values each step (62 shuffles for 64 sums, not 320).
//  * The same summation order on every launch (no atomics): two launches
//    give identical bits. The per-channel scale multiplies the fp32 sum,
//    which is rounded once to the output type.
// Tensor cores (mma.sync / wgmma at M >= 8) are left for later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kC = 4;              // output channels per warp
constexpr int kXBytesMax = 110592;  // staged bf16 x per block (108 KB: two blocks an SM)
constexpr int kSmemPerSM = 233472;  // 228 KB of shared memory on an H100 SM

// 16 int8 codes, streamed once: no L1 allocation
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// byte j of a word whose int8 codes were biased by XOR 0x80, as fp32:
// 0x4B0000xx is 2^23 + xx, and xx = code + 128
__device__ __forceinline__ float i8f(unsigned biased, int j) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

__device__ __forceinline__ unsigned word(const int4& w, int q) {
  return static_cast<unsigned>(q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w);
}

// 4 consecutive activations starting at element `off` (a multiple of 4)
__device__ __forceinline__ void load_x4(const void* x, int dtype, long off, float* v) {
  if (dtype == DT_F32) {
    const float4 f =
        __ldg(reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + off));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const bf16*>(x) + off));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// 8 bytes global -> shared without registers (sm_80+)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// acc[m][c] += sum over the 16 columns of unit u of x[m] * w[c]
template <int MR>
__device__ __forceinline__ void fma_unit(float (&acc)[MR][kC], const int4 (&w)[kC],
                                         const uint2* xs, int stride, int u) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float wf[kC][4];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const unsigned b = word(w[c], q) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) wf[c][j] = i8f(b, j);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const uint2 xv = xs[(m * 4 + q) * stride + u];
      const float xf[4] = {__uint_as_float(xv.x << 16), __uint_as_float(xv.x & 0xffff0000u),
                           __uint_as_float(xv.y << 16), __uint_as_float(xv.y & 0xffff0000u)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[m][c] = fmaf(xf[j], wf[c][j], acc[m][c]);
      }
    }
  }
}

// Sums v[0..V) over the warp's lanes. Each step exchanges half of the values
// still held: the lane with bit O set keeps the upper half. Returns the index
// of the first sum this lane ends with; it holds max(1, V / 32) of them in
// v[0..). Every sum is added in the same tree on every launch.
template <int COUNT, int O, int V>
__device__ __forceinline__ int reduce_scatter(float (&v)[V], int lane) {
  if constexpr (O == 0) {
    return 0;
  } else if constexpr (COUNT == 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return reduce_scatter<1, O / 2>(v, lane);
  } else {
    constexpr int H = COUNT / 2;
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return (up ? H : 0) + reduce_scatter<H, O / 2>(v, lane);
  }
}

template <int MR, bool kNorm>
__global__ void __launch_bounds__(kThreads, 2)
q8_matvec_kernel(const void* __restrict__ x, int x_dtype,
                 const void* __restrict__ norm_w, int norm_dtype, float eps,
                 const int8_t* __restrict__ qt, const float* __restrict__ scale,
                 void* __restrict__ out, int out_dtype, int M, int N, int K, int warps_k,
                 int xs_units) {
  extern __shared__ __align__(16) uint2 xs[];  // [m][quarter][unit] of 4 bf16
  __shared__ float red[kWarps][MR * kC];
  __shared__ float s_part[kThreads / 16];
  __shared__ float s_rinv[MR];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp & (warps_k - 1), wn = warp / warps_k, warps_n = kWarps / warps_k;
  const int tiles = (N + kC * warps_n - 1) / (kC * warps_n);
  const int U = K >> 4;
  const int step = 32 * warps_k;  // units between a lane's consecutive units
  // units of K staged at a time: all of K, or a multiple of `step`
  const int cu = U <= xs_units ? U : xs_units / step * step;
  const int u0 = lane + 32 * wk;  // this lane's first unit of a chunk

  const int4* wrow[kC];
  const auto rows_of = [&](int tile) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int n = min((tile * warps_n + wn) * kC + c, N - 1);
      wrow[c] = reinterpret_cast<const int4*>(qt + static_cast<long>(n) * K);
    }
  };
  // the weights of this lane's first unit of a tile, loaded ahead of it
  int4 pre[kC];
  const auto prefetch = [&]() {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      pre[c] = u0 < cu ? ld_stream(wrow[c] + u0) : make_int4(0, 0, 0, 0);
    }
  };
  int tile = blockIdx.x;  // the grid holds at most `tiles` blocks
  rows_of(tile);
  prefetch();

  if (kNorm) {  // fp32 inverse RMS of every row: T threads a row, 4 values a load
    constexpr int T = kThreads / MR, G = T < 32 ? T : 32;
    const int m = threadIdx.x / T, t = threadIdx.x % T;
    float ss = 0.f;
    if (m < M) {
#pragma unroll 4
      for (int k = t * 4; k < K; k += T * 4) {
        float v[4];
        load_x4(x, x_dtype, static_cast<long>(m) * K + k, v);
        ss += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (threadIdx.x % G == 0) s_part[threadIdx.x / G] = ss;
    __syncthreads();
    if (threadIdx.x < M) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < T / G; ++p) s += s_part[threadIdx.x * (T / G) + p];
      s_rinv[threadIdx.x] = rsqrtf(s / static_cast<float>(K) + eps);
    }
    __syncthreads();
  }

  // x[:, c0 * 16 : (c0 + cn) * 16], normed and rounded to bf16, into xs
  const auto stage = [&](int c0, int cn) {
#pragma unroll 4
    for (int g = threadIdx.x; g < MR * 4 * cn; g += kThreads) {
      const int m = g / (4 * cn), r = g - m * 4 * cn, u = r >> 2, q = r & 3;
      const int col = (c0 + u) * 16 + q * 4;
      uint2* dst = xs + (m * 4 + q) * cu + u;
      if (!kNorm && x_dtype == DT_BF16 && m < M) {  // a copy: bf16 holds x exactly
        cp_async8(dst, reinterpret_cast<const bf16*>(x) + static_cast<long>(m) * K + col);
        continue;
      }
      float v[4] = {0.f, 0.f, 0.f, 0.f};  // rows from M to MR stay zero
      if (m < M) load_x4(x, x_dtype, static_cast<long>(m) * K + col, v);
      if (kNorm && m < M) {
        const float ri = s_rinv[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (v[j] * ri) * (1.f + load_any(norm_w, norm_dtype, col + j));
        }
      }
      *dst = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    }
    if (!kNorm) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  };
  if (cu == U) stage(0, U);  // x fits: staged once for every tile of the block

  float acc[MR][kC];
  // this lane's units of the chunk from unit c0; `w` holds the first one's
  // weights, and each unit's loads are issued before the one before is used
  const auto stream_units = [&](int c0, int cn, int4 (&w)[kC]) {
    for (int u = u0; u < cn; u += step) {
      int4 next[kC];
      const bool more = u + step < cn;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        next[c] = more ? ld_stream(wrow[c] + c0 + u + step) : make_int4(0, 0, 0, 0);
      }
      fma_unit<MR>(acc, w, xs, cu, u);
#pragma unroll
      for (int c = 0; c < kC; ++c) w[c] = next[c];
    }
  };

  for (; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[m][c] = 0.f;
    }
    if (cu < U) stage(0, cu);
    stream_units(0, cu, pre);
    for (int c0 = cu; c0 < U; c0 += cu) {
      const int cn = min(cu, U - c0);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        pre[c] = u0 < cn ? ld_stream(wrow[c] + c0 + u0) : make_int4(0, 0, 0, 0);
      }
      __syncthreads();  // every warp is done with the previous chunk
      stage(c0, cn);
      stream_units(c0, cn, pre);
    }
    if (tile + gridDim.x < tiles) {  // the next tile's first weights, in flight meanwhile
      rows_of(tile + gridDim.x);
      prefetch();
    }

    float sums[MR * kC];
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int c = 0; c < kC; ++c) sums[m * kC + c] = acc[m][c];
    }
    constexpr int kHeld = MR * kC >= 32 ? MR * kC / 32 : 1;
    const int base = reduce_scatter<MR * kC, 16>(sums, lane);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) red[warp][base + i] = sums[i];
    __syncthreads();
    // the K-split warps' partials, added in warp order; scaled; rounded once
    for (int t = threadIdx.x; t < warps_n * MR * kC; t += kThreads) {
      const int g = t / (MR * kC), i = t - g * MR * kC, m = i / kC, c = i - m * kC;
      const int n = (tile * warps_n + g) * kC + c;
      if (m < M && n < N) {
        float s = 0.f;
        for (int w = 0; w < warps_k; ++w) s += red[g * warps_k + w][i];
        store_any(out, out_dtype, static_cast<long>(m) * N + n, s * scale[n]);
      }
    }
    __syncthreads();  // red and xs are free for the next tile
  }
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

template <int MR, bool kNorm>
int launch_rows(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
                const int8_t* qt, const float* scale, void* out, int out_dtype, int M, int N,
                int K, cudaStream_t stream) {
  const auto kernel = q8_matvec_kernel<MR, kNorm>;
  static cudaFuncAttributes attr;
  static bool have_attr = false, opted_in = false;
  if (!have_attr) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    have_attr = true;
  }
  // more than 48 KB of dynamic shared memory needs an opt-in, which is not
  // made while the stream is being captured into a CUDA graph; until it is,
  // x is staged in smaller chunks
  if (!opted_in) {
    cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
    if (cudaStreamIsCapturing(stream, &capture) == cudaSuccess &&
        capture == cudaStreamCaptureStatusNone) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXBytesMax);
      opted_in = e == cudaSuccess;
      if (!opted_in) cudaGetLastError();  // a refused opt-in only keeps the chunks small
    }
  }
  const int limit = opted_in ? kXBytesMax : (48 << 10) - static_cast<int>(attr.sharedSizeBytes);
  const int U = K / 16;
  const int xs_units = min(U, limit / (MR * 32));
  const int xs_bytes = xs_units * MR * 32;
  // resident blocks per SM, from registers (256 a warp at a time) and
  // shared memory (1 KB reserved a block)
  const int warp_regs = (attr.numRegs * 32 + 255) / 256 * 256;
  const int by_regs = 65536 / (kWarps * warp_regs);
  const int by_smem = kSmemPerSM / (static_cast<int>(attr.sharedSizeBytes) + xs_bytes + 1024);
  const int slots = max(1, min(min(by_regs, by_smem), 2048 / kThreads)) * sm_count();
  // K split 1-8 ways (every lane keeps a unit of each chunk): the fewest
  // unit steps for the busiest lane, and the fewest blocks on a tie
  int warps_k = 1, best = 0;
  for (int wk = 1; wk <= kWarps && 32 * wk <= xs_units; wk *= 2) {
    const int tiles = (N + kC * (kWarps / wk) - 1) / (kC * (kWarps / wk));
    const int cost = (tiles + slots - 1) / slots * ((U + 32 * wk - 1) / (32 * wk));
    if (wk == 1 || cost < best) {
      best = cost;
      warps_k = wk;
    }
  }
  const int tiles = (N + kC * (kWarps / warps_k) - 1) / (kC * (kWarps / warps_k));
  kernel<<<min(tiles, slots), kThreads, xs_bytes, stream>>>(
      x, x_dtype, norm_w, norm_dtype, eps, qt, scale, out, out_dtype, M, N, K, warps_k, xs_units);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNorm>
int launch(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
           const int8_t* qt, const float* scale, void* out, int out_dtype,
           int M, int N, int K, void* stream) {
  if (M < 1 || M > 16 || N < 1 || K < 16 || K % 16 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q8_ROWS(MR)                                                                          \
  return launch_rows<MR, kNorm>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, out, out_dtype, \
                                M, N, K, s)
  if (M == 1) Q8_ROWS(1);
  if (M == 2) Q8_ROWS(2);
  if (M <= 4) Q8_ROWS(4);
  if (M <= 8) Q8_ROWS(8);
  Q8_ROWS(16);
#undef Q8_ROWS
}

}  // namespace

extern "C" int q8_matvec(const void* x, int x_dtype, const int8_t* qt, const float* scale,
                         void* out, int out_dtype, int M, int N, int K, void* stream) {
  return launch<false>(x, x_dtype, nullptr, DT_F32, 0.f, qt, scale, out, out_dtype, M, N, K,
                       stream);
}

extern "C" int q8_rmsnorm_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype,
                                 float eps, const int8_t* qt, const float* scale, void* out,
                                 int out_dtype, int M, int N, int K, void* stream) {
  return launch<true>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, out, out_dtype, M, N, K,
                      stream);
}
