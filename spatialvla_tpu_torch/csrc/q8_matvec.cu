// Weight-only int8 matvec for few rows, optionally with the Gemma RMSNorm
// fused in front: y[m, n] = scale[n] * sum_k bf16(x'[m, k]) * qt[n, k].
//
// Replaces the Pallas kernels spatialvla_tpu/ops/quant.py:int8_matmul
// (_q8_kernel / _q_dot_scaled, int8 per-channel branch) and
// quant.py:int8_rmsnorm_matmul (_q8_norm_kernel).
//
// What bounds it on the H100: weight bytes. At M <= 16 rows every int8
// weight is used M times, far below the ~295 operations per byte where the
// tensor cores would become the limit; the action head alone streams
// 8194 x 2304 = 18.9 MB per call and a decode step ~2 GB. The design
// therefore reads each weight row exactly once, with 16-byte loads that are
// contiguous across a warp (one warp per output channel, so a row is one
// coalesced sweep), and applies it to all M rows of x from registers; the
// activations (at most 16 x 9216 values) are re-read through L1. The
// fp32 sums are reduced with warp shuffles, scaled by the per-channel scale
// and rounded once. The RMSNorm variant recomputes each row's fp32 inverse
// RMS per block (O(M*K), negligible next to the block's weight bytes) and
// rounds the normed activation to bf16 on the fly, as the TPU kernel does.
// tensor-core (wgmma) and TMA pipelines are left for later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // output channels per block
constexpr int kMaxM = 16;  // rows of x a launch may carry

// 16 int8 codes -> fp32 (exact)
__device__ __forceinline__ void unpack_i8x16(int4 q, float* f) {
  const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = static_cast<float>((w[i] << (24 - 8 * j)) >> 24);
  }
}

template <bool kNorm>
__global__ void __launch_bounds__(kWarps * 32)
q8_matvec_kernel(const void* __restrict__ x, int x_dtype,
                 const void* __restrict__ norm_w, int norm_dtype, float eps,
                 const int8_t* __restrict__ qt, const float* __restrict__ scale,
                 void* __restrict__ out, int out_dtype, int M, int N, int K) {
  __shared__ float s_rinv[kMaxM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kNorm) {  // fp32 inverse RMS of every row: x * rsqrt(mean(x^2) + eps)
    for (int m = warp; m < M; m += kWarps) {
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = load_any(x, x_dtype, (long)m * K + k);
        ss += v * v;
      }
      ss = warp_sum(ss);
      if (lane == 0) s_rinv[m] = rsqrtf(ss / static_cast<float>(K) + eps);
    }
    __syncthreads();
  }
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;

  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  const int4* wrow = reinterpret_cast<const int4*>(qt + (long)n * K);
  const int k16 = K >> 4;
#pragma unroll 2
  for (int c = lane; c < k16; c += 32) {
    float w[16];
    unpack_i8x16(__ldg(wrow + c), w);
    float g[16];  // (1 + norm weight) for the RMSNorm variant
    if (kNorm) {
#pragma unroll
      for (int j = 0; j < 16; ++j) g[j] = 1.f + load_any(norm_w, norm_dtype, c * 16 + j);
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        float v[16];
        load_x16(x, x_dtype, (long)m * K + c * 16, v);
        float s = acc[m];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float xv = kNorm ? bf16r((v[j] * s_rinv[m]) * g[j]) : bf16r(v[j]);
          s = fmaf(xv, w[j], s);
        }
        acc[m] = s;
      }
    }
  }
  const float sc = scale[n];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    if (m < M) {
      const float v = warp_sum(acc[m]);
      if (lane == m) store_any(out, out_dtype, (long)m * N + n, v * sc);
    }
  }
}

template <bool kNorm>
int launch(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
           const int8_t* qt, const float* scale, void* out, int out_dtype,
           int M, int N, int K, void* stream) {
  if (M < 1 || M > kMaxM || N < 1 || K < 16 || K % 16 != 0) return cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  q8_matvec_kernel<kNorm><<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, norm_w, norm_dtype, eps, qt, scale, out, out_dtype, M, N, K);
  return static_cast<int>(cudaGetLastError());
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
