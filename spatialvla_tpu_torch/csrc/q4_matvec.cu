// Weight-only packed-int4 matmul for 1..512 rows, optionally with the Gemma
// RMSNorm fused in front, per-channel or grouped scales.
//
// Replaces the int4 branches of the Pallas kernels
// spatialvla_tpu/ops/quant.py:int8_matmul (_q8_kernel -> _q_dot_scaled, the
// uint8 branch :221-238, and grouped_int4_dot :163) and
// quant.py:int8_rmsnorm_matmul (_q8_norm_kernel :325), which the fused decode
// step's _matvec_block (decode_step.py:140-162) also computes.
//
// Format: qt (N, K/2) uint8, byte k of row n holds column k in its low nibble
// and column K/2 + k in its high nibble, each as code + 8 (offset binary).
// What is computed, with x' = bf16(x) (or bf16 of the normed x) and c the
// biased nibble codes (exact in fp32):
//   per channel: y[m, n] = (sum_k x'[m, k] c[n, k] - 8 sum_k x'[m, k]) * s[n]
//   grouped:     y[m, n] = sum_j s[n, j] sum_{k in j} x' c - 8 sum_j s[n, j] sum_{k in j} x'
// with fp32 sums, as the TPU kernel takes the +8 bias out of its bf16 dots;
// per channel at M <= 16, q8_matvec.cu sums x'[m, k] (c[n, k] - 8) instead
// (the same function in another fp32 order, with less cancellation).
// Groups may have any width that quantize_int4 makes (K/G columns, G even).
// Where they are a multiple of 32 columns, the tiled kernel's K step lies
// in one group and is scaled once; otherwise a template instance closes a
// partial dot at each group's last column.
//
// What bounds it on the H100:
//   * M <= 16 (decode matvecs, the action head): weight bytes, N K / 2 per
//     call (a 26-layer int4 decode step streams about 1 GB). With x and qt
//     16-byte aligned, K a multiple of 32, and per channel or in groups of
//     a multiple of 16 columns (route_of): the int4 instances of
//     q8_matvec.cu's kernel (q4_rows_matvec: x staged once per block in
//     shared memory, 4 channels a warp, signed codes by a byte permute;
//     grouped, one scale per 16-column half of a 16-byte weight unit, so
//     y = sum_j s[n, j] sum_{k in j} x' (c - 8) in another fp32 order).
//     Aligned, in groups of another width: q4_small_kernel, one warp per
//     output channel, each packed byte read once with 16-byte loads
//     coalesced across the warp, applied to all M rows from registers,
//     closing a partial dot at each group's last column.
//   * 16 < M <= 512 (the 277-row prefill, SigLIP's 256 rows): operations,
//     2 M N K, far above the ~295 operations per byte where the tensor cores
//     would become the limit. A 64 x 64 output tile per block walks K in
//     steps of 32 packed bytes: the x tile (64 rows x 64 columns, rounded to
//     bf16 values) and the unpacked weight codes go to shared memory, and
//     each thread accumulates a 4 x 4 micro-tile with fp32 FMAs. The weight
//     tile is read once per 64-row tile of x (from L2 after the first). This
//     runs on the fp32 FMA units, not the tensor cores: mma / wgmma tiles
//     are left for later work.
#include "common.cuh"

// q8_matvec.cu: the packed-int4 instances of its few-row kernel, per
// channel (G = 0) or in groups of a multiple of 16 columns
int q4_rows_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
                   const uint8_t* qt, const float* scale, int G, void* out, int out_dtype, int M,
                   int N, int K, cudaStream_t stream);

namespace {

// ---------------------------------------------------------------- few rows
constexpr int kWarps = 8;      // output channels per block
constexpr int kSmallM = 16;    // rows of x the warp-per-channel kernel carries

// The 16 nibbles of one half (0: low, 1: high) of 16 packed bytes -> fp32
// biased codes (0..15)
__device__ __forceinline__ void unpack_half16(uint4 u, int half, float* c) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[4 * i + j] = static_cast<float>((w[i] >> (8 * j + 4 * half)) & 15u);
    }
  }
}

// Groups of any width (route_of sends those of a multiple of 16 columns to
// q4_rows_matvec)
template <bool kNorm>
__global__ void __launch_bounds__(kWarps * 32)
q4_small_kernel(const void* __restrict__ x, int x_dtype, const void* __restrict__ norm_w,
                int norm_dtype, float eps, const uint8_t* __restrict__ qt,
                const float* __restrict__ scale, int G, void* __restrict__ out, int out_dtype,
                int M, int N, int K) {
  __shared__ float s_rinv[kSmallM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Kh = K >> 1;
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

  float acc[kSmallM], bsum[kSmallM];  // code dots and x sums (scaled per group)
#pragma unroll
  for (int m = 0; m < kSmallM; ++m) acc[m] = bsum[m] = 0.f;

  const uint4* wrow = reinterpret_cast<const uint4*>(qt + (long)n * Kh);
  const int g = K / G;  // columns per group
  for (int c = lane; c < (Kh >> 4); c += 32) {
    const uint4 u = __ldg(wrow + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col0 = half * Kh + c * 16;  // first unpacked column of these 16 codes
      float cw[16];
      unpack_half16(u, half, cw);
      // s scales the 16 columns when they lie in one group; otherwise (groups
      // narrower than 16 columns or not aligned to 16) bit j of `ends` marks
      // the last column of a group in the chunk and sj[j] its scale
      float s = 1.f, sj[16];
      unsigned ends = 0u;
      int gi = col0 / g, left = g - (col0 - gi * g);  // columns of col0's group from col0 on
      if (left >= 16) {
        s = __ldg(scale + (long)n * G + gi);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (--left == 0 || j == 15) {
            ends |= 1u << j;
            sj[j] = __ldg(scale + (long)n * G + gi);
            ++gi;
            left = g;
          }
        }
      }
      float gain[16];  // (1 + norm weight) for the RMSNorm variant
      if (kNorm) {
#pragma unroll
        for (int j = 0; j < 16; ++j) gain[j] = 1.f + load_any(norm_w, norm_dtype, col0 + j);
      }
#pragma unroll
      for (int m = 0; m < kSmallM; ++m) {
        if (m < M) {
          float v[16];
          load_x16(x, x_dtype, (long)m * K + col0, v);
          float d = 0.f, xs = 0.f;
          if (ends == 0u) {  // one scale for the 16 columns
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float xv = kNorm ? bf16r((v[j] * s_rinv[m]) * gain[j]) : bf16r(v[j]);
              d = fmaf(xv, cw[j], d);
              xs += xv;
            }
            acc[m] = fmaf(s, d, acc[m]);
            bsum[m] = fmaf(s, xs, bsum[m]);
          } else {  // one partial dot per group, scaled at the group's last column
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float xv = kNorm ? bf16r((v[j] * s_rinv[m]) * gain[j]) : bf16r(v[j]);
              d = fmaf(xv, cw[j], d);
              xs += xv;
              if (ends & (1u << j)) {
                acc[m] = fmaf(sj[j], d, acc[m]);
                bsum[m] = fmaf(sj[j], xs, bsum[m]);
                d = xs = 0.f;
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kSmallM; ++m) {
    if (m < M) {
      const float a = warp_sum(acc[m]);
      const float b = warp_sum(bsum[m]);
      if (lane == m) store_any(out, out_dtype, (long)m * N + n, a - 8.f * b);
    }
  }
}

// ---------------------------------------------------------------- many rows
constexpr int kTM = 64, kTN = 64;  // output tile: rows of x, output channels
constexpr int kKB = 32;            // packed bytes per K step: 32 low + 32 high columns
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

// Close a group of the low columns (jlo) and one of the high columns (G/2 +
// jlo): add the open partial dots and x sums, scaled by their groups'
// scales, to this thread's 4 x 4 outputs, and reopen them.
__device__ __forceinline__ void close_groups(float (&acc)[4][4], float (&bias)[4][4],
                                             float (&plo)[4][4], float (&phi)[4][4],
                                             const float* xlo, const float* xhi,
                                             const float* __restrict__ scale, int n0, int tx,
                                             int N, int G, int jlo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    const float slo = n < N ? __ldg(scale + (long)n * G + jlo) : 0.f;
    const float shi = n < N ? __ldg(scale + (long)n * G + G / 2 + jlo) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][j] = fmaf(slo, plo[i][j], fmaf(shi, phi[i][j], acc[i][j]));
      bias[i][j] = fmaf(slo, xlo[i], fmaf(shi, xhi[i], bias[i][j]));
      plo[i][j] = phi[i][j] = 0.f;
    }
  }
}

// kGroups: 0 per channel; 1 grouped, groups of a multiple of 32 columns
// (closed at the end of a K step, x sums from shared memory); 2 grouped, any
// width (closed at a group's last column, x sums per thread)
template <bool kNorm, int kGroups>
__global__ void __launch_bounds__(kThreads)
q4_tile_kernel(const void* __restrict__ x, int x_dtype, const void* __restrict__ norm_w,
               int norm_dtype, float eps, const uint8_t* __restrict__ qt,
               const float* __restrict__ scale, int G, void* __restrict__ out, int out_dtype,
               int M, int N, int K) {
  constexpr bool kGrouped = kGroups != 0;
  __shared__ float xs[2 * kKB][kTM + 4];  // [column of the step][row], bf16 values
  __shared__ float ws[2 * kKB][kTN + 4];  // [column of the step][channel], biased codes
  __shared__ float s_rinv[kTM];
  __shared__ float s_xsum[2][kTM];        // x sums of the low / high columns per row

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM;
  const int Kh = K >> 1;
  const int g = kGrouped ? K / G : Kh;  // columns per group (per channel: one per half)

  if (kNorm) {
    for (int r = warp; r < kTM; r += kThreads / 32) {
      const int row = m0 + r;
      float ss = 0.f;
      if (row < M) {
        for (int k = lane; k < K; k += 32) {
          const float v = load_any(x, x_dtype, (long)row * K + k);
          ss += v * v;
        }
      }
      ss = warp_sum(ss);
      if (lane == 0) s_rinv[r] = rsqrtf(ss / static_cast<float>(K) + eps);
    }
  }
  float sc_n[4];  // per channel: the scales of this thread's 4 output channels
  if (!kGrouped) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      sc_n[j] = n < N ? scale[n] : 0.f;
    }
  }

  float acc[4][4], plo[4][4], phi[4][4], bias[4][4];
  float xlo[4], xhi[4];  // kGroups 2: x sums of this thread's rows over the open group
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xlo[i] = xhi[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = plo[i][j] = phi[i][j] = bias[i][j] = 0.f;
  }
  // kGroups 0, 1: threads 0..127 own one (half, row) x sum each, over the
  // current group or over all of K
  float my_xsum = 0.f;
  const int own_half = tid / kTM, own_row = tid % kTM;
  // kGroups 2: columns left in the open group of each half (Kh is a whole
  // number of groups, so the groups of both halves end together)
  int left = g;

  for (int b0 = 0; b0 < Kh; b0 += kKB) {
    __syncthreads();  // the previous step's tiles (and s_rinv) are done with / ready
    // x tile: element (row r, step column cc) -> unpacked column half * Kh + b0 + (cc % 32)
    for (int idx = tid; idx < kTM * 2 * kKB; idx += kThreads) {
      const int r = idx / (2 * kKB), cc = idx % (2 * kKB);
      const int kc = b0 + (cc & (kKB - 1));
      const int col = (cc >= kKB ? Kh : 0) + kc;
      const int row = m0 + r;
      float v = 0.f;
      if (row < M && kc < Kh) {
        v = load_any(x, x_dtype, (long)row * K + col);
        v = kNorm ? bf16r((v * s_rinv[r]) * (1.f + load_any(norm_w, norm_dtype, col))) : bf16r(v);
      }
      xs[cc][r] = v;
    }
    // weight tile: one packed byte -> a low and a high code
    for (int idx = tid; idx < kTN * kKB; idx += kThreads) {
      const int nn = idx / kKB, bb = idx % kKB;
      const int n = n0 + nn, kc = b0 + bb;
      const unsigned byte = (n < N && kc < Kh) ? qt[(long)n * Kh + kc] : 0u;
      ws[bb][nn] = static_cast<float>(byte & 15u);
      ws[kKB + bb][nn] = static_cast<float>(byte >> 4);
    }
    __syncthreads();
    if (kGroups != 2 && tid < 2 * kTM) {
#pragma unroll 8
      for (int cc = 0; cc < kKB; ++cc) my_xsum += xs[own_half * kKB + cc][own_row];
    }
#pragma unroll 4
    for (int kk = 0; kk < kKB; ++kk) {
      float a[4], b[4], a2[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty + 16 * i];
        b[i] = ws[kk][tx + 16 * i];
        a2[i] = xs[kKB + kk][ty + 16 * i];
        b2[i] = ws[kKB + kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kGroups == 2) {
          xlo[i] += a[i];
          xhi[i] += a2[i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[i][j] = fmaf(a[i], b[j], plo[i][j]);
          phi[i][j] = fmaf(a2[i], b2[j], phi[i][j]);
        }
      }
      if (kGroups == 2 && b0 + kk < Kh && --left == 0) {  // a group ends at this column
        left = g;
        close_groups(acc, bias, plo, phi, xlo, xhi, scale, n0, tx, N, G, (b0 + kk) / g);
#pragma unroll
        for (int i = 0; i < 4; ++i) xlo[i] = xhi[i] = 0.f;
      }
    }
    if (kGroups == 1 && ((b0 + kKB) % g == 0 || b0 + kKB >= Kh)) {  // a group ends with the step
      if (tid < 2 * kTM) {
        s_xsum[own_half][own_row] = my_xsum;
        my_xsum = 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xlo[i] = s_xsum[0][ty + 16 * i];
        xhi[i] = s_xsum[1][ty + 16 * i];
      }
      close_groups(acc, bias, plo, phi, xlo, xhi, scale, n0, tx, N, G, b0 / g);
    }
  }
  if (!kGrouped) {
    __syncthreads();
    if (tid < 2 * kTM) s_xsum[own_half][own_row] = my_xsum;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v;
      if (kGrouped) {
        v = acc[i][j] - 8.f * bias[i][j];
      } else {
        const int r = ty + 16 * i;
        v = ((plo[i][j] + phi[i][j]) - 8.f * (s_xsum[0][r] + s_xsum[1][r])) * sc_n[j];
      }
      store_any(out, out_dtype, (long)row * N + n, v);
    }
  }
}

// Which kernel a call takes: the few-row kernel of q8_matvec.cu (M <= 16,
// x and qt 16-byte aligned, K a multiple of 32, per channel or in groups
// of a multiple of 16 columns), q4_small_kernel (the other aligned grouped
// calls of M <= 16), or the tiled kernel (the rest)
enum Route { kRows = 0, kSmall = 1, kTiled = 2 };

Route route_of(const void* x, const void* qt, int M, int K, int G) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(qt) % 16 == 0 && (K / 2) % 16 == 0;
  if (M > kSmallM || !aligned) return kTiled;
  return G == 0 || (K / G) % 16 == 0 ? kRows : kSmall;
}

template <bool kNorm, bool kGrouped>
int launch_kind(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
                const uint8_t* qt, const float* scale, int G, void* out, int out_dtype,
                int M, int N, int K, cudaStream_t stream) {
  const Route route = route_of(x, qt, M, K, G);
  if (route == kRows) {
    return q4_rows_matvec(x, x_dtype, kNorm ? norm_w : nullptr, norm_dtype, eps, qt, scale, G,
                          out, out_dtype, M, N, K, stream);
  }
  if (route == kSmall) {
    const dim3 grid((N + kWarps - 1) / kWarps), block(kWarps * 32);
    q4_small_kernel<kNorm><<<grid, block, 0, stream>>>(
        x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
  } else {
    const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    if (!kGrouped) {
      q4_tile_kernel<kNorm, 0><<<grid, kThreads, 0, stream>>>(
          x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
    } else if ((K / G) % kKB == 0) {
      q4_tile_kernel<kNorm, 1><<<grid, kThreads, 0, stream>>>(
          x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
    } else {
      q4_tile_kernel<kNorm, 2><<<grid, kThreads, 0, stream>>>(
          x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kNorm>
int launch(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
           const uint8_t* qt, const float* scale, int G, void* out, int out_dtype, int M, int N,
           int K, void* stream) {
  // grouped: G groups of K / G columns each, an even number so that both
  // halves of K hold whole groups (as quantize_int4 makes them); any width
  if (M < 1 || M > 512 || N < 1 || K < 2 || K % 2 != 0 ||
      (G != 0 && (G < 2 || G % 2 != 0 || K % G != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return G == 0 ? launch_kind<kNorm, false>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G,
                                            out, out_dtype, M, N, K, s)
                : launch_kind<kNorm, true>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G,
                                           out, out_dtype, M, N, K, s);
}

}  // namespace

// The kernel (Route) that q4_matvec / q4_rmsnorm_matvec launch for these
// operands; launches nothing
extern "C" int q4_route(const void* x, const void* qt, int M, int K, int G) {
  return route_of(x, qt, M, K, G);
}

extern "C" int q4_matvec(const void* x, int x_dtype, const uint8_t* qt, const float* scale, int G,
                         void* out, int out_dtype, int M, int N, int K, void* stream) {
  return launch<false>(x, x_dtype, nullptr, DT_F32, 0.f, qt, scale, G, out, out_dtype, M, N, K,
                       stream);
}

extern "C" int q4_rmsnorm_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype,
                                 float eps, const uint8_t* qt, const float* scale, int G,
                                 void* out, int out_dtype, int M, int N, int K, void* stream) {
  return launch<true>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K,
                      stream);
}
