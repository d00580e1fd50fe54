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
// What is computed, with x' = bf16(x) (or bf16 of the normed x) and c - 8
// the signed codes:
//   per channel: y[m, n] = s[n] * sum_k x'[m, k] (c[n, k] - 8)
//   grouped:     y[m, n] = sum_j s[n, j] * sum_{k in j} x'[m, k] (c[n, k] - 8)
// in fp32. The fp32 FMA kernel (q4_tile_kernel) and q4_small_kernel sum the
// biased codes and take 8 * sum x' off instead, as the TPU kernel does (the
// same function in another fp32 order). Groups may have any width that
// quantize_int4 makes (K/G columns, G even).
//
// Routes (route_of), and what bounds each on the H100:
//   * "rows", M <= 16 with x and qt 16-byte aligned, K a multiple of 32, per
//     channel or in groups of a multiple of 16 columns: weight bytes, N K / 2
//     per call; the int4 instances of q8_matvec.cu's few-row kernel
//     (q4_rows_matvec).
//   * "small", the other aligned grouped calls of M <= 16: q4_small_kernel,
//     one warp per output channel, each packed byte read once with 16-byte
//     loads coalesced across the warp, applied to all M rows from registers,
//     closing a partial dot at each group's last column.
//   * "tiled", every other call per channel or in groups of a multiple of 16
//     columns (16 < M <= 512: the 277-row prefill, SigLIP's 256 rows; and
//     misaligned operands at any M): operations, 2 M N K, far above the ~295
//     operations per byte where the tensor cores become the limit. Two or
//     three launches:
//       - q4_stage_x, one block a row: the row's fp32 inverse RMS once (not
//         once per column tile), then x' rounded to bf16 into xs (M, 2, Khp),
//         the head of a work buffer the caller allocates (q4_work_bytes): the low and the
//         high half of K, each padded with zeros to Khp, a multiple of
//         kStep, and the columns of every 16-column step permuted (kcol) so
//         that one ldmatrix gives the A fragment that meets a 4-byte word
//         of packed codes.
//       - q4_mma_kernel, an output tile of 32 rows x 128 channels a block
//         (kMF, kNF, kWN), 4 warps side by side along the channels (32 x
//         32 each): bf16 mma.sync.m16n8k16 with fp32 sums. A cp.async ring
//         of as many stages as fit in 46 KB of static shared memory (5)
//         brings kStep packed bytes of every channel of the tile (raw: a
//         quarter of bf16's bytes; in 16-, 8- or 1-byte units, as the rows'
//         alignment allows; each row's two 16-byte halves swapped every 4
//         rows, so that the reads need no padding) and the x' columns of
//         both halves of K that they meet. A lane reads one 32-bit word of 4
//         packed bytes a fragment and widens it in registers: each nibble,
//         masked and ORed into 0x4300 (bf16 128 + c), minus 136 in one
//         bf16x2 subtraction, is c - 8 exactly; the low nibbles meet x'
//         columns k, the high ones K/2 + k, so each word feeds both halves.
//         Per channel, the products of both halves go to one fp32 sum that
//         the scale multiplies at the end. Grouped (groups of a multiple of
//         16 columns: group j of the low half and G/2 + j of the high half
//         end at the same step), each half has one open fp32 partial of
//         signed-code products, added times s[n, j] to the output's sum
//         when its group closes. m16 fragments wholly past row M are
//         skipped.
//         Where the output tiles give fewer than 2 blocks an SM (o and down
//         at 277 rows, SigLIP's q/k/v/o, fc2 and projector, few rows), K
//         is split to about 4 blocks an SM (split_of): blocks along z
//         take consecutive runs of whole groups (at least 4 stages each)
//         and write their unscaled fp32 sums into the work buffer after x'.
//       - q4_split_sum then adds the partial sums in split order, times the
//         per-channel scale, into the output.
//     No atomics: two launches give identical bits.
//   * "tiled_fma", the calls of M > 16 (or misaligned) in groups of another
//     width: q4_tile_kernel, 64 x 64 output tiles on the fp32 FMA units,
//     closing a partial dot at each group's last column. q4_tiled_fma
//     launches it for any scales, to time the tensor-core kernel against it.
#include "common.cuh"

// q8_matvec.cu: the packed-int4 instances of its few-row kernel, per
// channel (G = 0) or in groups of a multiple of 16 columns (gelu: the
// gate|up weight's gelu epilogue, without the norm)
int q4_rows_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
                   const uint8_t* qt, const float* scale, int G, void* out, int out_dtype, int M,
                   int N, int K, int gelu, cudaStream_t stream);
// ... and its residual variant (the decode step's residual update fused in
// front of the RMSNorm)
int q4_rows_residual_matvec(const float* h_in, const bf16* upd, const void* post_w, int post_dtype,
                            const void* norm_w, int norm_dtype, float eps, const uint8_t* qt,
                            const float* scale, int G, float* h_out, void* out, int out_dtype,
                            int M, int N, int K, int gelu, cudaStream_t stream);

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

// ------------------------------------------- many rows, fp32 FMA ("tiled_fma")
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

// ------------------------------------------------- many rows, tensor cores
constexpr int kStep = 32;                // packed bytes of a pipeline stage (two 16-column steps)
constexpr int kAStride = 2 * kStep + 8;  // bf16 a staged row: both halves' 32 columns + 16 B pad
constexpr int kSmemBudget = 46 << 10;    // static shared memory of a block (48 KB at most)
constexpr int kStageThreads = 256;
// the tile: 16 kMF rows x 8 kNF kWN channels, kWN warps of 16 kMF x 8 kNF
constexpr int kMF = 2, kNF = 4, kWN = 4;

// Columns a half of K takes in xs: K/2 rounded up to whole stages
__host__ __device__ __forceinline__ int padded_half(int K) {
  return (K / 2 + kStep - 1) / kStep * kStep;
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

// The K split: S blocks along z share an output tile, each taking `stages`
// consecutive stages (a whole number of groups: a stage is kStep columns of
// each half, and a split ends where a group does). Only a grid of fewer
// than 2 blocks an SM is split, to about 4 blocks an SM, each block keeping
// at least 4 stages. On an H100 (scripts/bench_q4_tile.py) that took 34-37%
// off down (K = 9216) and SigLIP's fc2 (4304) and half off 17 rows; above 2
// blocks an SM (qkv at 277 and 512 rows, SigLIP's fc1) the split's extra
// pass cost more than it gave
struct Split {
  int S, stages;
};

Split split_of(int M, int N, int K, int G) {
  constexpr int BM = 16 * kMF, BN = 8 * kNF * kWN;
  const int n_stages = padded_half(K) / kStep;
  int unit = 1;  // stages from one group boundary to the next that is also a stage's
  if (G != 0) {
    const int g = K / G;  // a multiple of 16 columns
    unit = g % kStep == 0 ? g / kStep : g / 16;
  }
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int units = (n_stages + unit - 1) / unit;
  const int want = blocks >= 2 * sm_count() ? 1 : (4 * sm_count() + blocks - 1) / blocks;
  const int S = max(1, min(min(want, 16), min(units, n_stages / 4)));
  const int per = (units + S - 1) / S;  // units a split
  return {(units + per - 1) / per, per * unit};
}

// The tensor-core route's work buffer: x' (M x 2 x padded_half(K) bf16) in
// its first staged_bytes, then with a K split the S partial sums (S x M x N
// fp32)
long staged_bytes(int M, int K) {
  return (2L * M * padded_half(K) * 2 + 255) / 256 * 256;
}

long work_bytes(int M, int N, int K, int G) {
  const Split sp = split_of(M, N, K, G);
  return staged_bytes(M, K) + (sp.S > 1 ? 4L * sp.S * M * N : 0);
}

// The column (0..15) of a 16-column step that position l of the step holds
// in xs and in shared memory: lane (g, t) of an mma reads the packed-byte
// word 4t..4t+3 of its channel and splits its codes as (byte 0, byte 2) ->
// k = 2t, 2t + 1 and (byte 1, byte 3) -> k = 2t + 8, 2t + 9, so the A
// fragment must hold columns 4t, 4t + 2 at positions 2t, 2t + 1 and 4t + 1,
// 4t + 3 at 2t + 8, 2t + 9
__device__ __forceinline__ int kcol(int l) {
  return 4 * ((l & 7) >> 1) + (l >> 3) + 2 * (l & 1);
}

// x' of one row into xs, a 16-column step a thread: the fp32 inverse RMS of
// the row (kNorm), then bf16((x * rinv) * (1 + w)) or bf16(x) for each
// column, in the layout above (two 16-byte stores a step)
template <bool kNorm>
__global__ void __launch_bounds__(kStageThreads)
q4_stage_x(const void* __restrict__ x, int x_dtype, const void* __restrict__ norm_w,
           int norm_dtype, float eps, bf16* __restrict__ xs, int K) {
  __shared__ float scratch[32];
  const int m = blockIdx.x, Kh = K >> 1, Khp = padded_half(K);
  const long row = static_cast<long>(m) * K;
  float rinv = 1.f;
  if (kNorm) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += kStageThreads) {
      const float v = load_any(x, x_dtype, row + k);
      ss += v * v;
    }
    rinv = rsqrtf(block_sum(ss, scratch) / static_cast<float>(K) + eps);
  }
  uint4* dst = reinterpret_cast<uint4*>(xs + 2 * static_cast<long>(m) * Khp);
  for (int u = threadIdx.x; u < 2 * Khp / 16; u += kStageThreads) {
    const int h = u >= Khp / 16, c0 = 16 * u - h * Khp;  // step of half h from column c0
    float v[16];
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      const int cc = c0 + kcol(l), k = h * Kh + cc;
      v[l] = cc < Kh ? load_any(x, x_dtype, row + k) : 0.f;
      if (kNorm && cc < Kh) v[l] = (v[l] * rinv) * (1.f + load_any(norm_w, norm_dtype, k));
    }
    unsigned w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      w[q] = *reinterpret_cast<const unsigned*>(&pair);
    }
    dst[2 * u] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[2 * u + 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The nibbles at bits 0-3 and 16-19 of v -> bf16x2 signed codes c - 8:
// 0x4300 | c is the bf16 value 128 + c, and 136 comes off exactly
__device__ __forceinline__ unsigned codes2(unsigned v) {
  unsigned r = (v & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                             __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const unsigned*>(&h);
}

// Byte offset of byte k (0..31) of staged weight row r: its 16-byte half
// swapped every 4 rows, so that the 8 rows of an mma read their words from
// 32 different banks without padding
__device__ __forceinline__ int wswz(int r, int k) {
  return r * kStep + (k ^ (((r >> 2) & 1) << 4));
}

// One output tile of 16 MF rows x 8 NF WN channels (see the header): WN
// warps side by side, each 16 MF rows x 8 NF channels over both halves of K.
// kAlign: the bytes of a weight load (16, 8 or 1), which divide K/2 and the
// address of qt
template <int MF, int NF, int WN, bool kGrouped, int kAlign>
__global__ void __launch_bounds__(32 * WN)
q4_mma_kernel(const bf16* __restrict__ xs, const uint8_t* __restrict__ qt,
              const float* __restrict__ scale, int G, void* __restrict__ out, int out_dtype,
              float* __restrict__ partial, int M, int N, int K, int split_stages) {
  constexpr int BM = 16 * MF, BN = 8 * NF * WN, kBlockThreads = 32 * WN;
  constexpr int kABytes = BM * kAStride * 2, kWBytes = BN * kStep;
  constexpr int kStages = kSmemBudget / (kABytes + kWBytes);  // 5 for 32 x 128
  static_assert(kStages >= 3, "the ring needs three stages");
  __shared__ __align__(16) unsigned char smem[kStages * (kABytes + kWBytes)];
  auto As = reinterpret_cast<bf16(*)[BM][kAStride]>(smem);  // [stage][row][column]
  auto Ws = reinterpret_cast<uint8_t(*)[kWBytes]>(smem + kStages * kABytes);

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wn = (tid >> 5) * 8 * NF;  // the warp's first channel in the tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Kh = K >> 1, Khp = padded_half(K);
  const int st0 = blockIdx.z * split_stages;  // this block's stages: [st0, st0 + n_stages)
  const int n_stages = min(split_stages, Khp / kStep - st0);
  const int live = min(MF, (M - m0 + 15) / 16);  // m16 fragments with rows below M
  const int gw = kGrouped ? K / G : 0;            // columns a group

  // stage i: packed bytes [b, b + kStep) of the tile's channels and the x'
  // columns they meet in both halves of K
  auto load = [&](int i) {
    const int buf = i % kStages, b = (st0 + i) * kStep;
    constexpr int kXUnits = 2 * kStep * 2 / 16;  // 16-byte units of a staged row
    for (int idx = tid; idx < BM * kXUnits; idx += kBlockThreads) {
      const int r = idx / kXUnits, u = idx % kXUnits, m = m0 + r;
      const int h = u / (kStep / 8), c = (u % (kStep / 8)) * 8;
      const bf16* src = xs + (2 * static_cast<long>(min(m, M - 1)) + h) * Khp + b + c;
      cp_async<16>(&As[buf][r][h * kStep + c], src, m < M);
    }
    constexpr int kWUnits = kStep / kAlign;
    for (int idx = tid; idx < BN * kWUnits; idx += kBlockThreads) {
      const int r = idx / kWUnits, kk = (idx % kWUnits) * kAlign, k = b + kk, n = n0 + r;
      const bool valid = n < N && k < Kh;  // a unit lies wholly in or past the row
      uint8_t* dst = &Ws[buf][wswz(r, kk)];
      if constexpr (kAlign == 1) {
        *dst = valid ? __ldg(qt + static_cast<long>(n) * Kh + k) : 0;
      } else {
        cp_async<kAlign>(dst, valid ? qt + static_cast<long>(n) * Kh + k : qt, valid);
      }
    }
  };

  // per channel the products go straight to acc; grouped, to one open
  // partial a half (groups j and G/2 + j meet each stage together)
  float acc[MF][NF][4], part[kGrouped ? 2 : 1][MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][f][e] = 0.f;
        part[0][i][f][e] = part[kGrouped ? 1 : 0][i][f][e] = 0.f;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_stages) load(i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int i = 0; i < n_stages; ++i) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // stage i has landed, and every warp is done with stage i - 1's buffer
    if (i + kStages - 1 < n_stages) load(i + kStages - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const int buf = i % kStages;
#pragma unroll
    for (int sub = 0; sub < kStep / 16; ++sub) {
      const int s16 = (st0 + i) * (kStep / 16) + sub;  // 16-column step of each half
      if (kGrouped && 16 * s16 >= Kh) break;   // padding (Kh is a multiple of 16 here)
      unsigned w[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        w[f] = *reinterpret_cast<const unsigned*>(&Ws[buf][wswz(wn + 8 * f + g, 16 * sub + 4 * t)]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // 0: the low nibbles, 1: the high ones
        unsigned a[MF][4];
#pragma unroll
        for (int i2 = 0; i2 < MF; ++i2) {
          if (i2 < live) {
            ldmatrix_x4(a[i2],
                        &As[buf][16 * i2 + (lane & 15)][h * kStep + 16 * sub + (lane >> 4) * 8]);
          }
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const unsigned v = w[f] >> (4 * h);
          const unsigned b01 = codes2(v), b23 = codes2(v >> 8);
#pragma unroll
          for (int i2 = 0; i2 < MF; ++i2) {
            if (i2 < live) {
              mma_bf16(kGrouped ? part[kGrouped ? h : 0][i2][f] : acc[i2][f], a[i2], b01, b23);
            }
          }
        }
      }
      if (kGrouped && (16 * (s16 + 1)) % gw == 0) {  // groups j and G/2 + j close
        const int j = 16 * s16 / gw;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const int n = n0 + wn + 8 * f + 2 * t, jj = h * (G / 2) + j;
            const float s0 = n < N ? __ldg(scale + static_cast<long>(n) * G + jj) : 0.f;
            const float s1 = n + 1 < N ? __ldg(scale + static_cast<long>(n + 1) * G + jj) : 0.f;
#pragma unroll
            for (int i2 = 0; i2 < MF; ++i2) {
              if (i2 < live) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  float& p = part[kGrouped ? h : 0][i2][f][e];
                  acc[i2][f][e] = fmaf(e & 1 ? s1 : s0, p, acc[i2][f][e]);
                  p = 0.f;
                }
              }
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // lane (g, t) holds rows g and g + 8 of each fragment, channels 2t and 2t + 1;
  // with a K split, the block's unscaled sums go to its slice of `partial`
  const bool split = gridDim.z > 1;
  float* slice = partial + static_cast<long>(blockIdx.z) * M * N;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n = n0 + wn + 8 * f + 2 * t;
    float sc0 = 1.f, sc1 = 1.f;
    if (!kGrouped && !split) {
      sc0 = n < N ? __ldg(scale + n) : 0.f;
      sc1 = n + 1 < N ? __ldg(scale + n + 1) : 0.f;
    }
#pragma unroll
    for (int i2 = 0; i2 < MF; ++i2) {
      if (i2 >= live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + 16 * i2 + g + (e >> 1) * 8, c = n + (e & 1);
        if (r < M && c < N) {
          const float y = acc[i2][f][e] * (e & 1 ? sc1 : sc0);
          if (split) {
            slice[static_cast<long>(r) * N + c] = y;
          } else {
            store_any(out, out_dtype, static_cast<long>(r) * N + c, y);
          }
        }
      }
    }
  }
}

// The K split's partial sums added in split order, times the per-channel
// scale (scale null: grouped, already scaled), into out
__global__ void __launch_bounds__(256)
q4_split_sum(const float* __restrict__ partial, int S, const float* __restrict__ scale,
             void* __restrict__ out, int out_dtype, int M, int N) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long MN = static_cast<long>(M) * N;
  if (i >= MN) return;
  float v = 0.f;
  for (int z = 0; z < S; ++z) v += partial[z * MN + i];
  if (scale != nullptr) v *= __ldg(scale + i % N);
  store_any(out, out_dtype, i, v);
}

template <int MF, int NF, int WN, bool kGrouped>
void launch_mma_tile(const bf16* xs, const uint8_t* qt, const float* scale, int G, void* out,
                     int out_dtype, float* partial, int M, int N, int K, Split sp,
                     cudaStream_t stream) {
  constexpr int BM = 16 * MF, BN = 8 * NF * WN;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, sp.S);
  const uintptr_t a = reinterpret_cast<uintptr_t>(qt) | static_cast<uintptr_t>(K / 2);
  if (a % 16 == 0) {
    q4_mma_kernel<MF, NF, WN, kGrouped, 16><<<grid, 32 * WN, 0, stream>>>(
        xs, qt, scale, G, out, out_dtype, partial, M, N, K, sp.stages);
  } else if (a % 8 == 0) {
    q4_mma_kernel<MF, NF, WN, kGrouped, 8><<<grid, 32 * WN, 0, stream>>>(
        xs, qt, scale, G, out, out_dtype, partial, M, N, K, sp.stages);
  } else {
    q4_mma_kernel<MF, NF, WN, kGrouped, 1><<<grid, 32 * WN, 0, stream>>>(
        xs, qt, scale, G, out, out_dtype, partial, M, N, K, sp.stages);
  }
}

// work: work_bytes(M, N, K, G) bytes that the caller allocates
template <bool kNorm, bool kGrouped>
int launch_mma(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
               const uint8_t* qt, const float* scale, int G, void* work, void* out, int out_dtype,
               int M, int N, int K, cudaStream_t stream) {
  if (work == nullptr) return cudaErrorInvalidValue;
  bf16* xs = static_cast<bf16*>(work);
  float* partial = reinterpret_cast<float*>(static_cast<char*>(work) + staged_bytes(M, K));
  const Split sp = split_of(M, N, K, G);
  q4_stage_x<kNorm><<<M, kStageThreads, 0, stream>>>(x, x_dtype, norm_w, norm_dtype, eps, xs, K);
  launch_mma_tile<kMF, kNF, kWN, kGrouped>(xs, qt, scale, G, out, out_dtype, partial, M, N, K,
                                           sp, stream);
  if (sp.S > 1) {
    const long MN = static_cast<long>(M) * N;
    q4_split_sum<<<static_cast<int>((MN + 255) / 256), 256, 0, stream>>>(
        partial, sp.S, kGrouped ? nullptr : scale, out, out_dtype, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// Which kernel a call takes (see the header): the few-row kernel of
// q8_matvec.cu, q4_small_kernel, the tensor-core kernel or the FMA tiles
enum Route { kRows = 0, kSmall = 1, kTiled = 2, kTiledFma = 3 };

Route route_of(const void* x, const void* qt, int M, int K, int G) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(qt) % 16 == 0 && (K / 2) % 16 == 0;
  const bool by16 = G == 0 || (K / G) % 16 == 0;  // per channel or groups of 16 k columns
  if (M <= kSmallM && aligned) return by16 ? kRows : kSmall;
  return by16 ? kTiled : kTiledFma;
}

// The FMA tiles for any scales: kGroups 0 per channel, 1 in groups of a
// multiple of 32 columns, 2 any other width
template <bool kNorm>
int launch_fma(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
               const uint8_t* qt, const float* scale, int G, void* out, int out_dtype, int M,
               int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  if (G == 0) {
    q4_tile_kernel<kNorm, 0><<<grid, kThreads, 0, stream>>>(
        x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
  } else if ((K / G) % kKB == 0) {
    q4_tile_kernel<kNorm, 1><<<grid, kThreads, 0, stream>>>(
        x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
  } else {
    q4_tile_kernel<kNorm, 2><<<grid, kThreads, 0, stream>>>(
        x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// grouped: G groups of K / G columns each, an even number so that both
// halves of K hold whole groups (as quantize_int4 makes them); any width
bool valid_shape(int M, int N, int K, int G) {
  return M >= 1 && M <= 512 && N >= 1 && K >= 2 && K % 2 == 0 &&
         (G == 0 || (G >= 2 && G % 2 == 0 && K % G == 0));
}

// gelu (no norm): the gelu epilogue of the few-row kernel, on the "rows"
// route only
template <bool kNorm>
int launch(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
           const uint8_t* qt, const float* scale, int G, void* work, void* out, int out_dtype,
           int M, int N, int K, int gelu, void* stream) {
  if (!valid_shape(M, N, K, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Route route = route_of(x, qt, M, K, G);
  if (gelu && (kNorm || route != kRows)) return cudaErrorInvalidValue;
  switch (route) {
    case kRows:
      return q4_rows_matvec(x, x_dtype, kNorm ? norm_w : nullptr, norm_dtype, eps, qt, scale, G,
                            out, out_dtype, M, N, K, gelu, s);
    case kSmall: {
      const dim3 grid((N + kWarps - 1) / kWarps), block(kWarps * 32);
      q4_small_kernel<kNorm><<<grid, block, 0, s>>>(x, x_dtype, norm_w, norm_dtype, eps, qt,
                                                    scale, G, out, out_dtype, M, N, K);
      return static_cast<int>(cudaGetLastError());
    }
    case kTiled:
      return G == 0 ? launch_mma<kNorm, false>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G,
                                               work, out, out_dtype, M, N, K, s)
                    : launch_mma<kNorm, true>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G,
                                              work, out, out_dtype, M, N, K, s);
    default:
      return launch_fma<kNorm>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype,
                               M, N, K, s);
  }
}

}  // namespace

// The kernel (Route) that q4_matvec / q4_rmsnorm_matvec launch for these
// operands; launches nothing
extern "C" int q4_route(const void* x, const void* qt, int M, int K, int G) {
  return route_of(x, qt, M, K, G);
}

// The bytes of the work buffer that q4_matvec / q4_rmsnorm_matvec need for
// these operands (x' staged as bf16 and, with a K split, the partial sums),
// 0 where the call takes another route than the tensor-core kernel
extern "C" int q4_work_bytes(const void* x, const void* qt, int M, int N, int K, int G) {
  if (!valid_shape(M, N, K, G) || route_of(x, qt, M, K, G) != kTiled) return 0;
  return static_cast<int>(work_bytes(M, N, K, G));
}

// work: q4_work_bytes(...) bytes of device memory (null on the other
// routes, where it is not touched). gelu: the weight is gate | up (N = 2 I)
// and out (M, I) bf16 receives gelu(gate) * up from the few-row kernel's
// epilogue (q8_matvec.cu), on the "rows" route only
extern "C" int q4_matvec(const void* x, int x_dtype, const uint8_t* qt, const float* scale, int G,
                         void* work, void* out, int out_dtype, int M, int N, int K, int gelu,
                         void* stream) {
  return launch<false>(x, x_dtype, nullptr, DT_F32, 0.f, qt, scale, G, work, out, out_dtype, M,
                       N, K, gelu, stream);
}

extern "C" int q4_rmsnorm_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype,
                                 float eps, const uint8_t* qt, const float* scale, int G,
                                 void* work, void* out, int out_dtype, int M, int N, int K,
                                 void* stream) {
  return launch<true>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, work, out, out_dtype, M,
                      N, K, 0, stream);
}

// h_out = bf16(bf16(h_in) + bf16(rms(upd) * (1 + post_w))), then out = the
// q4_rmsnorm_matvec of h_out with norm_w, in one launch of the few-row
// kernel (q8_matvec.cu's header). Only on the "rows" route (x and qt
// 16-byte aligned, per channel or in groups of a multiple of 16 columns) at
// M <= 4 and K <= 4096; other operands are refused with
// cudaErrorInvalidValue, and the caller runs norm_residual with the next
// norm's x' and q4_matvec instead (quant.residual_route); gelu as for
// q4_matvec
extern "C" int q4_residual_rmsnorm_matvec(const float* h_in, const bf16* upd, const void* post_w,
                                          int post_dtype, const void* norm_w, int norm_dtype,
                                          float eps, const uint8_t* qt, const float* scale, int G,
                                          float* h_out, void* out, int out_dtype, int M, int N,
                                          int K, int gelu, void* stream) {
  if (!valid_shape(M, N, K, G) || route_of(h_in, qt, M, K, G) != kRows)
    return cudaErrorInvalidValue;
  return q4_rows_residual_matvec(h_in, upd, post_w, post_dtype, norm_w, norm_dtype, eps, qt, scale,
                                 G, h_out, out, out_dtype, M, N, K, gelu,
                                 static_cast<cudaStream_t>(stream));
}

// The FMA tiles (q4_tile_kernel) for any scales, norm_w null for no norm:
// what the calls of M > 16 took before the tensor-core kernel, launched by
// chip_smoke.py and scripts/bench_q4_tile.py to time the two side by side
extern "C" int q4_tiled_fma(const void* x, int x_dtype, const void* norm_w, int norm_dtype,
                            float eps, const uint8_t* qt, const float* scale, int G, void* out,
                            int out_dtype, int M, int N, int K, void* stream) {
  if (!valid_shape(M, N, K, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return norm_w ? launch_fma<true>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out,
                                   out_dtype, M, N, K, s)
                : launch_fma<false>(x, x_dtype, nullptr, DT_F32, 0.f, qt, scale, G, out, out_dtype,
                                    M, N, K, s);
}
