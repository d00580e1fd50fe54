// Weight-only matvec for few rows, int8 or packed int4 weights with
// per-channel scales, or packed int4 with a scale per group of columns,
// optionally with the Gemma RMSNorm fused in front, and optionally with the
// decode step's residual update fused in front of that:
//   per channel: y[m, n] = scale[n] * sum_k bf16(x'[m, k]) * code[n, k];
//   grouped:     y[m, n] = sum_k scale[n, k / g] * bf16(x'[m, k]) * code[n, k]
// with g = K / G columns a group.
//
// Replaces the Pallas kernels spatialvla_tpu/ops/quant.py:int8_matmul
// (_q8_kernel / _q_dot_scaled: the int8 branch, the int4 per-channel branch
// :221-238 and grouped_int4_dot :163) and quant.py:int8_rmsnorm_matmul
// (_q8_norm_kernel), at M <= 16. The int8 entry points are q8_matvec /
// q8_rmsnorm_matvec below; q4_matvec.cu sends its aligned calls of M <= 16,
// per channel or in groups of a multiple of 16 columns, to q4_rows_matvec
// (kInt4, kGrouped), and keeps its many-row kernel and one for groups of
// other widths.
//
// The residual variant (kResid; q8_residual_rmsnorm_matvec below and
// q4_matvec.cu's q4_residual_rmsnorm_matvec) replaces the JAX decode kernel's
// phases that update the residual stream and norm it for the next
// projection (spatialvla_tpu/ops/decode_step.py: _post_attn, which adds the
// post-attention norm of o and applies the pre-FFN norm; _post_ffn with the
// next layer's _input_norm). From the fp32 residual h_in (M, K), the
// sublayer's bf16 output upd (M, K) and the two norm weights it computes
//   h_out = bf16(bf16(h_in) + bf16(rms(upd) * (1 + post_w)))   (fp32, M x K)
//   y     = matvec(bf16(rms(h_out) * (1 + norm_w)))
// with the rounding points of norm_residual (decode.cu) followed by the
// RMSNorm matvec, in one launch instead of two. The TPU keeps the residual
// row in VMEM between the phases; here every block reads the row's h_in and
// upd (about 14 KB a row at K = 2304, from L2 after the first block) and
// computes rms(upd), h_out and rms(h_out) itself, in the fixed order of the
// norm pass below, so every block stages the same x'; block 0 alone writes
// h_out, which must not overlap h_in (other blocks are still reading it).
// h_out is bf16-exact, so the norm pass writes it into shared memory as it
// goes and the staging norms it in place there (no third pass over global
// memory); at one row int8 too takes the one-round register path of the
// int4 instance. What bounds it is the weight stream, as for the RMSNorm
// matvec, plus a prologue of two passes over all M rows in every block: on
// the H100 that beats norm_residual + the RMSNorm matvec up to 4 rows and
// loses from 8 on, so the variant takes at most kResidMaxRows = 4 rows
// (instances MR = 1, 2, 4), and all of K staged at once even before the
// opt-in to more than 48 KB (K <= 4096); launch_resid refuses other shapes
// (quant.residual_route, the same rule). Above that the decode step runs
// norm_residual, which also writes the next norm's bf16 x', and the plain
// matvec on x' (no norm prologue).
//
// The gelu epilogue (kGelu; the plain matvec and the residual variant, every
// format and MR they have) replaces the decode step's gelu_mul (decode.cu)
// behind the gate|up projection: the weight is gate | up, N = 2 I rows, and
// the output (M, I) bf16 is act = bf16(bf16(gelu_tanh(bf16(gate))) *
// bf16(up)), the rounding points of the JAX decode kernel's g_scr
// (decode_step.py:345-355). Warp tile p owns gate rows 2p, 2p + 1 and up rows
// I + 2p, I + 2p + 1 instead of rows 4p .. 4p + 3, so both halves of an
// output column end in one warp's sums; the store loop rounds each to bf16
// and applies gelu_mul_value (common.cuh, gelu_mul_kernel's arithmetic). Each
// channel's sum keeps its order (the same K split as N = 2 I rows), so the
// output has the bits of the gate|up kernel followed by gelu_mul, with half
// the output bytes and one launch fewer: 5 a layer and one at the end at up
// to 4 rows, 131 a step of Gemma2-2B's 26 layers (157 with gelu_mul), and 7
// a layer less the one of layer 0 above 4 rows, 182 (208). Applying it in the
// down matvec's staging instead would recompute tanhf for all of x' in
// every block (and every chunk), about the work of the launch it removes.
//
// Weight formats (one 16-byte load, a "unit", of an output channel's row):
//  * int8, qt (N, K): unit u holds the codes of columns 16u..16u+15;
//  * packed int4, qt (N, K/2) uint8: byte k holds column k in its low nibble
//    and column K/2 + k in its high nibble, each as code + 8. Unit u holds
//    32 codes: its low nibbles meet x unit u (columns 16u..), its high
//    nibbles x unit u + K/32 (columns K/2 + 16u..); word q of the load
//    meets quarter q of both.
// A code becomes fp32 by a byte permute and one subtraction, both exact:
// 0x4B0000xx is 2^23 + xx, with xx = code + 128 (int8 XOR 0x80) or code + 8
// (a nibble masked out of the word). So the int4 sums are of x * (c - 8)
// directly, with no second sum of x for the +8 bias.
//
// Grouped int4 (the grouped instance): with g a multiple of 16, the 16 low
// columns of unit u lie in group j(u) = 16u / g and its 16 high columns in
// group G/2 + j(u) (K/2 is G/2 whole groups), so each half of each unit has
// one scale:
//   y[m, n] = sum_u ( s[n, j(u)] * sum_low x'(c - 8) + s[n, G/2 + j(u)] * sum_high x'(c - 8) )
// in fp32, and no per-channel multiply at the end. j uses the absolute unit
// (chunks start at c0), as a shift where g / 16 is a power of two. Below
// kScaleCodesFromRows rows a lane keeps each half's sums apart and adds
// them scaled (2 MR x 4 FMAs a unit on top of 32 MR x 4, MR x 4 more
// registers), with the unit's 8 scales loaded one unit ahead with its
// weights; from there on each code is scaled after the permute (32 x 4
// FMULs a unit, no more sums), a half's 4 scales loaded as the half starts
// (the FMAs of other warps cover the wait). From 8 rows on a grouped block
// has an SM to itself and up to 255 registers: in 128 (two blocks an SM)
// the 16-row instance spilled 556 B and ran 15-20% slower at 8 and 16 rows.
// 8 lanes share a 128-column group, so the scales are cached loads; a
// channel's scale row is its weight row (`chan`, clamped past N).
//
// What bounds it on the H100: weight bytes at one row (int8 gate|up streams
// 42.5 MB a call, int4 21.2 MB), and at 16 rows the fp32 FMAs on the CUDA
// cores (16 per int8 weight byte, 32 per packed int4 byte). The design:
//  * Rows are a template size MR in {1, 2, 4, 8, 16}, the smallest that
//    holds M; spare rows are zero in shared memory, so the row loop has no
//    guards. Each lane keeps MR x 4 fp32 sums.
//  * x is prepared once per block, not per output channel: the block
//    computes each row's fp32 inverse RMS (MR row groups of threads, 16-byte
//    loads), then writes the normed rows rounded to bf16 (bf16 x without the
//    norm: a cp.async copy) into shared memory, laid out [row][quarter of a
//    16-column unit][unit] so that the lanes of a warp read consecutive
//    8-byte words. The weight loop does no norm or rounding work. (int4 at
//    one row, K <= 4096: the norm pass and the staging share one round of
//    loads: about 1 us less a launch on the H100.)
//  * Blocks are persistent: a grid of at most the resident block slots walks
//    over tiles of output channels, and when all of K fits (up to 108 KB of
//    dynamic shared memory; 48 KB until the opt-in, which is never made
//    during a CUDA-graph capture) x is staged once for all of a block's
//    tiles. Otherwise (M = 16, K = 9216; int4 also M = 8, K = 9216) each
//    tile stages K in chunks of weight units; an int4 chunk [c0, c0 + cn)
//    stages both x ranges it meets, [c0, c0 + cn) and K/32 + [c0, c0 + cn).
//  * Each warp owns 4 output channels of a tile; each lane streams 16-byte
//    weight loads of all 4, one unit ahead of the one it computes (the first
//    unit of the next tile is loaded before the current tile's reduction),
//    and feeds every bf16 x value it reads from shared memory into 4
//    channels' FMAs. A code -> fp32 is a byte permute and one subtraction
//    (above; int4 adds a shift and a mask per 4 codes), not an int-to-float
//    conversion.
//  * Small N: the block's 8 warps split K 2-8 ways where that gives the
//    busiest lane fewer unit steps; partial sums meet in shared memory and
//    are added in warp order. Lanes reduce with a butterfly that halves the
//    values each step (62 shuffles for 64 sums, not 320).
//  * The same summation order on every launch (no atomics): two launches
//    give identical bits. The per-channel scale multiplies the fp32 sum
//    (the grouped scales were applied per half unit), which is rounded once
//    to the output type.
// Tensor cores (mma.sync / wgmma at M >= 8) are left for later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kC = 4;              // output channels per warp
constexpr int kXBytesMax = 110592;  // staged bf16 x per block (108 KB: two blocks an SM)
constexpr int kSmemPerSM = 233472;  // 228 KB of shared memory on an H100 SM
constexpr int kResidMaxRows = 4;    // rows and columns the residual variant takes (the
constexpr int kResidMaxK = 4096;    // header): all of K staged within 48 KB at 4 rows
// grouped int4: rows from which the codes are scaled, not the half-unit sums
constexpr int kScaleCodesFromRows = 8;

// one weight unit (16 bytes), streamed once: no L1 allocation
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// The 4 codes of word `w` of a weight unit as fp32, half h (int4: 0 the low
// nibbles, 1 the high ones): each byte, made unsigned (int8: XOR 0x80, code
// + 128; int4: the nibble, code + 8), goes into the low byte of 0x4B000000
// (2^23 + byte) and the bias 2^23 + 128 or 2^23 + 8 comes off
template <bool kInt4>
__device__ __forceinline__ void codes4(unsigned w, int h, float (&f)[4]) {
  const unsigned b = kInt4 ? (w >> (4 * h)) & 0x0F0F0F0Fu : w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __int_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + j)) -
           (kInt4 ? 8388616.f : 8388736.f);
  }
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

// acc[m][c] += sum over the columns of half h of weight unit u of x[m] *
// w[c] (int8: h = 0, the whole unit; int4: 0 the low nibbles, 1 the high
// ones), with staged x unit xu. Grouped int4: s[c] scales channel c's half,
// applied to the half's sums (kScale 1) or to its codes (kScale 2); kScale
// 0 per channel
template <int MR, bool kInt4, int kScale>
__device__ __forceinline__ void fma_half(float (&acc)[MR][kC], const int4 (&w)[kC],
                                         const float (&s)[kC], const uint2* xs, int stride,
                                         int xu, int h) {
  float part[MR][kC];  // kScale 1: this half's sums
  if constexpr (kScale == 1) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int c = 0; c < kC; ++c) part[m][c] = 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float wf[kC][4];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      codes4<kInt4>(word(w[c], q), h, wf[c]);
      if constexpr (kScale == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wf[c][j] *= s[c];
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const uint2 xv = xs[(m * 4 + q) * stride + xu];
      const float xf[4] = {__uint_as_float(xv.x << 16), __uint_as_float(xv.x & 0xffff0000u),
                           __uint_as_float(xv.y << 16), __uint_as_float(xv.y & 0xffff0000u)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if constexpr (kScale == 1) {
            part[m][c] = fmaf(xf[j], wf[c][j], part[m][c]);
          } else {
            acc[m][c] = fmaf(xf[j], wf[c][j], acc[m][c]);
          }
        }
      }
    }
  }
  if constexpr (kScale == 1) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[m][c] = fmaf(s[c], part[m][c], acc[m][c]);
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

// The residual variant's other operands (kResid): x is then h_in, fp32
struct Resid {
  const bf16* upd;     // (M, K) the sublayer's output
  const void* post_w;  // (K,) its post-norm weight, f32 or bf16
  int post_dtype;
  float* h_out;        // (M, K) the updated residual, written by block 0
};

// kInt4: packed int4 weights (N, K/2); otherwise int8 (N, K). kGrouped
// (int4 only): scale (N, G), groups of a multiple of 16 columns; otherwise
// (N,). kResid (kNorm only): x' is the RMSNorm of the residual update of x
// (the header), h_out its fp32 result. kGelu: the weight is gate | up (N =
// 2 I rows) and out (M, I) bf16 receives gelu(gate) * up (the header)
template <int MR, bool kNorm, bool kInt4, bool kGrouped, bool kResid, bool kGelu>
__global__ void __launch_bounds__(kThreads, kGrouped && MR >= 8 ? 1 : 2)
qmatvec_kernel(const void* __restrict__ x, int x_dtype,
               const void* __restrict__ norm_w, int norm_dtype, float eps,
               const int8_t* __restrict__ qt, const float* __restrict__ scale, int G,
               void* __restrict__ out, int out_dtype, int M, int N, int K, int warps_k,
               int xs_units, Resid rs) {
  static_assert(kNorm || !kResid, "the residual variant norms its result");
  static_assert(!kGelu || !kNorm || kResid, "no gelu instance of the plain RMSNorm form");
  // [m][quarter][position] of 4 bf16; int4 keeps a chunk's high-nibble x
  // units `cu` positions after its low ones
  extern __shared__ __align__(16) uint2 xs[];
  __shared__ float red[kWarps][MR * kC];
  __shared__ float s_part[kThreads / 16];
  __shared__ float s_rinv[MR];
  __shared__ float s_rupd[kResid ? MR : 1];  // kResid: each row's inverse RMS of upd

  constexpr int H = kInt4 ? 2 : 1;  // x units a weight unit meets
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp & (warps_k - 1), wn = warp / warps_k, warps_n = kWarps / warps_k;
  const int tiles = (N + kC * warps_n - 1) / (kC * warps_n);
  // weight units a row; int8 shifts and int4 divides, the forms each was
  // measured with (MR = 16 sits at 128 registers, and ptxas spills on less)
  const int U = kInt4 ? K / 32 : K >> 4;
  const int step = 32 * warps_k;  // units between a lane's consecutive units
  // weight units staged at a time: all of them, or a multiple of `step`
  const int cu = U <= xs_units ? U : xs_units / step * step;
  const int xstride = H * cu;     // staged x units a (row, quarter)
  const int u0 = lane + 32 * wk;  // this lane's first unit of a chunk
  // grouped: how the half units take their scales (fma_half), and the
  // weight units a group, gu = g / 16, as a shift where a power of two
  constexpr int kScale = !kGrouped ? 0 : MR < kScaleCodesFromRows ? 1 : 2;
  const int gu = kGrouped ? K / G / 16 : 1;
  const int gshift = (gu & (gu - 1)) ? -1 : __ffs(gu) - 1;

  const int4* wrow[kC];
  // the warp's tile index: channels 4p .. 4p + 3, or (kGelu) the gate rows
  // 2p, 2p + 1 and the up rows I + 2p, I + 2p + 1 of output columns 2p, 2p + 1
  int p0 = 0;
  const auto chan = [&](int c) {  // channel c of the warp (past N: clamped, as N - 1 or I - 1)
    if constexpr (kGelu) {
      return (c >> 1) * (N / 2) + min(2 * p0 + (c & 1), N / 2 - 1);
    } else {
      return min(kC * p0 + c, N - 1);
    }
  };
  const auto rows_of = [&](int tile) {
    p0 = tile * warps_n + wn;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      wrow[c] = reinterpret_cast<const int4*>(qt + static_cast<long>(chan(c)) * (K / H));
    }
  };
  // grouped: channel c's scales of half h of absolute weight unit ua (zero
  // where !ok), group ua / gu of the low columns and G/2 + ua / gu of the
  // high; a channel past N reads the row its weights come from
  const auto scales_of = [&](int ua, int h, bool ok, float (&s)[kC]) {
    const int j = h * (G / 2) + (gshift >= 0 ? ua >> gshift : ua / gu);
#pragma unroll
    for (int c = 0; c < kC; ++c) s[c] = ok ? __ldg(scale + chan(c) * G + j) : 0.f;
  };
  const auto unit_scales = [&](int ua, bool ok, float (&s)[2][kC]) {  // both halves
    scales_of(ua, 0, ok, s[0]);
    scales_of(ua, 1, ok, s[1]);
  };
  // the weights (and, kScale 1, the scales) of this lane's first unit of a
  // tile, loaded ahead of it
  int4 pre[kC];
  float psc[2][kC];
  const auto prefetch = [&]() {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      pre[c] = u0 < cu ? ld_stream(wrow[c] + u0) : make_int4(0, 0, 0, 0);
    }
    if (kScale == 1) unit_scales(u0, u0 < cu, psc);
  };
  int tile = blockIdx.x;  // the grid holds at most `tiles` blocks
  rows_of(tile);
  prefetch();

  // kResid: 4 columns from `col` of row m of h' = bf16(bf16(h_in) +
  // bf16(rms(upd) * (1 + post_w))), ru the row's inverse RMS of upd (the
  // arithmetic of norm_residual_kernel, decode.cu)
  const auto resid4 = [&](int m, int col, float ru, float (&v)[4]) {
    float u[4];
    load_x4(x, DT_F32, static_cast<long>(m) * K + col, v);
    load_x4(rs.upd, DT_BF16, static_cast<long>(m) * K + col, u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = bf16r(bf16r(v[j]) + bf16r((u[j] * ru) * (1.f + load_any(rs.post_w, rs.post_dtype,
                                                                      col + j))));
    }
  };
  const auto store4 = [&](int m, int col, const float (&v)[4]) {  // h_out, block 0 only
    *reinterpret_cast<float4*>(rs.h_out + static_cast<long>(m) * K + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  };
  // the sum of `ss` over the block, in warp order (the same on every block)
  const auto block_total = [&](float ss) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) s_part[warp] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_part[w];
    __syncthreads();  // s_part is free again
    return total;
  };

  // int4 (and the residual variant), one row, all of x staged (the decode
  // step's RMSNorm matvecs): the columns thread t stages, 4 (t + 256 p), are
  // the ones its norm pass reads, so x and the gains are loaded once, in one
  // round, and kept in registers between the passes (the same arithmetic
  // and order)
  constexpr int kP = 4;  // pieces a thread: K <= 4096
  const bool fused = kNorm && (kInt4 || kResid) && MR == 1 && cu == U && K <= 4 * kThreads * kP;
  if (fused) {
    float v[kP][4], gain[kP][4];
    float ss = 0.f;
    if (kResid) {  // rms(upd) first; h' = the residual update, in registers
      float u[kP][4];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int k = 4 * (threadIdx.x + kThreads * p);
        if (k < K) {
          load_x4(rs.upd, DT_BF16, k, u[p]);
          load_x4(x, DT_F32, k, v[p]);
          ss += u[p][0] * u[p][0] + u[p][1] * u[p][1] + u[p][2] * u[p][2] + u[p][3] * u[p][3];
        }
      }
      const float ru = rsqrtf(block_total(ss) / static_cast<float>(K) + eps);
      ss = 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int k = 4 * (threadIdx.x + kThreads * p);
        if (k < K) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[p][j] = bf16r(bf16r(v[p][j]) +
                            bf16r((u[p][j] * ru) * (1.f + load_any(rs.post_w, rs.post_dtype, k + j))));
            gain[p][j] = 1.f + load_any(norm_w, norm_dtype, k + j);
          }
          if (blockIdx.x == 0) store4(0, k, v[p]);
          ss += v[p][0] * v[p][0] + v[p][1] * v[p][1] + v[p][2] * v[p][2] + v[p][3] * v[p][3];
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int k = 4 * (threadIdx.x + kThreads * p);
        if (k < K) {
          load_x4(x, x_dtype, k, v[p]);
#pragma unroll
          for (int j = 0; j < 4; ++j) gain[p][j] = 1.f + load_any(norm_w, norm_dtype, k + j);
          ss += v[p][0] * v[p][0] + v[p][1] * v[p][1] + v[p][2] * v[p][2] + v[p][3] * v[p][3];
        }
      }
    }
    const float ri = rsqrtf(block_total(ss) / static_cast<float>(K) + eps);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int g = threadIdx.x + kThreads * p;  // as `stage` numbers its pieces
      if (4 * g < K) {
        const int h = g >= 4 * U, r = g - h * 4 * U;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = (v[p][j] * ri) * gain[p][j];
        xs[(r & 3) * xstride + h * cu + (r >> 2)] =
            make_uint2(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]));
      }
    }
    __syncthreads();
  }

  if (kNorm && !fused) {  // fp32 inverse RMS of every row: T threads a row, 4 values a load
    constexpr int T = kThreads / MR, G = T < 32 ? T : 32;
    const int m = threadIdx.x / T, t = threadIdx.x % T;
    // pass 0: of x (kResid: of h', which block 0 writes to h_out); pass 1
    // (kResid, first): of upd
    const auto row_rinv = [&](int pass, float* dst) {
      float ss = 0.f;
      if (m < M) {
#pragma unroll 4
        for (int k = t * 4; k < K; k += T * 4) {
          float v[4];
          if (kResid && pass == 1) {
            load_x4(rs.upd, DT_BF16, static_cast<long>(m) * K + k, v);
          } else if (kResid) {
            resid4(m, k, s_rupd[m], v);
            if (blockIdx.x == 0) store4(m, k, v);
            // h' is bf16-exact: staged as it is (all of K), normed in place below
            const int half = kInt4 ? K / 2 : K, h = k >= half, kk = k - h * half;
            xs[(m * 4 + ((kk >> 2) & 3)) * xstride + h * cu + (kk >> 4)] =
                make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
          } else {
            load_x4(x, x_dtype, static_cast<long>(m) * K + k, v);
          }
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
        dst[threadIdx.x] = rsqrtf(s / static_cast<float>(K) + eps);
      }
      __syncthreads();
    };
    if (kResid) row_rinv(1, s_rupd);
    row_rinv(0, s_rinv);
  }

  // the x units that weight units [c0, c0 + cn) meet, normed and rounded to
  // bf16, into xs: x[:, c0 * 16 : (c0 + cn) * 16] at positions [0, cn), and
  // for int4 also x[:, K/2 + c0 * 16 : K/2 + (c0 + cn) * 16] at cu + [0, cn)
  // (not kResid, whose norm pass stages all of h')
  const auto stage = [&](int c0, int cn) {
#pragma unroll 4
    for (int g = threadIdx.x; g < MR * 4 * H * cn; g += kThreads) {
      const int m = g / (4 * H * cn), r0 = g - m * 4 * H * cn;
      const int h = kInt4 && r0 >= 4 * cn, r = r0 - h * 4 * cn, u = r >> 2, q = r & 3;
      const int col = (h * U + c0 + u) * 16 + q * 4;
      uint2* dst = xs + (m * 4 + q) * xstride + h * cu + u;
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
  if (kResid && !fused) {  // h' staged by the norm pass: norm it in place
    for (int g = threadIdx.x; g < MR * 4 * H * U; g += kThreads) {
      const int m = g / (4 * H * U), r0 = g - m * 4 * H * U;
      const int h = kInt4 && r0 >= 4 * U, r = r0 - h * 4 * U, u = r >> 2, q = r & 3;
      const int col = (h * U + u) * 16 + q * 4;
      uint2* dst = xs + (m * 4 + q) * xstride + h * cu + u;
      float v[4] = {0.f, 0.f, 0.f, 0.f};  // rows from M to MR stay zero
      if (m < M) {
        const uint2 b = *dst;
        const float ri = s_rinv[m];
        v[0] = __uint_as_float(b.x << 16), v[1] = __uint_as_float(b.x & 0xffff0000u);
        v[2] = __uint_as_float(b.y << 16), v[3] = __uint_as_float(b.y & 0xffff0000u);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = (v[j] * ri) * (1.f + load_any(norm_w, norm_dtype, col + j));
      }
      *dst = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    }
    __syncthreads();
  } else if (cu == U && !fused) {
    stage(0, U);  // x fits: staged once for every tile of the block
  }

  float acc[MR][kC];
  // this lane's units of the chunk from unit c0; `w` holds the first one's
  // weights (and `s`, kScale 1, its scales), and each unit's loads are
  // issued before the one before is used. kScale 2 loads a half's scales
  // as the half starts, into s[0]
  const auto stream_units = [&](int c0, int cn, int4 (&w)[kC], float (&s)[2][kC]) {
    for (int u = u0; u < cn; u += step) {
      int4 next[kC];
      float nsc[2][kC];
      const bool more = u + step < cn;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        next[c] = more ? ld_stream(wrow[c] + c0 + u + step) : make_int4(0, 0, 0, 0);
      }
      if (kScale == 1) unit_scales(c0 + u + step, more, nsc);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (kScale == 2) scales_of(c0 + u, h, true, s[0]);
        fma_half<MR, kInt4, kScale>(acc, w, s[kScale == 1 ? h : 0], xs, xstride, u + h * cu, h);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        w[c] = next[c];
        if (kScale == 1) s[0][c] = nsc[0][c], s[1][c] = nsc[1][c];
      }
    }
  };

  for (; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[m][c] = 0.f;
    }
    if (!kResid && cu < U) stage(0, cu);
    stream_units(0, cu, pre, psc);
    for (int c0 = cu; c0 < U; c0 += cu) {
      const int cn = min(cu, U - c0);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        pre[c] = u0 < cn ? ld_stream(wrow[c] + c0 + u0) : make_int4(0, 0, 0, 0);
      }
      if (kScale == 1) unit_scales(c0 + u0, u0 < cn, psc);
      __syncthreads();  // every warp is done with the previous chunk
      if (!kResid) stage(c0, cn);
      stream_units(c0, cn, pre, psc);
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
    // the K-split warps' partials, added in warp order; scaled per channel
    // (grouped: already scaled); rounded once. kGelu: a gate and an up sum,
    // each rounded to bf16 as the gate|up output would be, then gelu(gate) *
    // up rounded to bf16 into column j of the (M, I) output
    const auto channel_sum = [&](int g, int i, int n) {
      float s = 0.f;
      for (int w = 0; w < warps_k; ++w) s += red[g * warps_k + w][i];
      return kGrouped ? s : s * scale[n];
    };
    if constexpr (kGelu) {
      const int I = N / 2;
      for (int t = threadIdx.x; t < warps_n * MR * 2; t += kThreads) {
        const int g = t / (MR * 2), i = t - g * MR * 2, m = i >> 1, c = i & 1;
        const int j = (tile * warps_n + g) * 2 + c;
        if (m < M && j < I) {
          const float gate = bf16r(channel_sum(g, m * kC + c, j));
          const float up = bf16r(channel_sum(g, m * kC + 2 + c, I + j));
          store_any(out, DT_BF16, static_cast<long>(m) * I + j, gelu_mul_value(gate, up));
        }
      }
    } else {
      for (int t = threadIdx.x; t < warps_n * MR * kC; t += kThreads) {
        const int g = t / (MR * kC), i = t - g * MR * kC, m = i / kC, c = i - m * kC;
        const int n = (tile * warps_n + g) * kC + c;
        if (m < M && n < N) {
          store_any(out, out_dtype, static_cast<long>(m) * N + n, channel_sum(g, i, n));
        }
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

template <int MR, bool kNorm, bool kInt4, bool kGrouped, bool kResid, bool kGelu>
int launch_rows(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
                const int8_t* qt, const float* scale, int G, void* out, int out_dtype, int M,
                int N, int K, Resid rs, cudaStream_t stream) {
  const auto kernel = qmatvec_kernel<MR, kNorm, kInt4, kGrouped, kResid, kGelu>;
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
  constexpr int H = kInt4 ? 2 : 1;
  const int U = K / (16 * H);  // weight units a row
  const int xs_units = min(U, limit / (MR * 32 * H));  // 32 x bytes a row a unit
  if (kResid && xs_units < U) return cudaErrorInvalidValue;  // stages all of K (the header)
  const int xs_bytes = xs_units * MR * 32 * H;
  // resident blocks per SM, from registers (256 a warp at a time) and
  // shared memory (1 KB reserved a block)
  const int warp_regs = (attr.numRegs * 32 + 255) / 256 * 256;
  const int by_regs = 65536 / (kWarps * warp_regs);
  const int by_smem = kSmemPerSM / (static_cast<int>(attr.sharedSizeBytes) + xs_bytes + 1024);
  const int slots = max(1, min(min(by_regs, by_smem), 2048 / kThreads)) * sm_count();
  // K split 1-8 ways (every lane keeps a unit of each chunk): the fewest
  // unit steps for the busiest lane, and the fewest blocks on a tie. kGelu
  // tiles the same N rows 4 a warp, so it splits K as the gate|up matvec
  // does, and each channel's sum keeps its order
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
      x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, out, out_dtype, M, N, K, warps_k,
      xs_units, rs);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNorm, bool kInt4, bool kGrouped, bool kResid = false, bool kGelu = false>
int launch(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
           const int8_t* qt, const float* scale, int G, void* out, int out_dtype,
           int M, int N, int K, cudaStream_t s, Resid rs = Resid{}) {
  const int unit = kInt4 ? 32 : 16;  // columns of a weight unit
  if (M < 1 || M > (kResid ? kResidMaxRows : 16) || N < 1 || K < unit || K % unit != 0)
    return cudaErrorInvalidValue;
  // kGelu: gate | up, N = 2 I rows, into bf16 act (M, I)
  if (kGelu && (N % 2 != 0 || out_dtype != DT_BF16)) return cudaErrorInvalidValue;
  // grouped: G groups, both halves of K whole groups of a multiple of 16 columns
  if (kGrouped && (G < 2 || G % 2 != 0 || K % G != 0 || (K / G) % 16 != 0))
    return cudaErrorInvalidValue;
#define QMV_ROWS(MR)                                                                         \
  return launch_rows<MR, kNorm, kInt4, kGrouped, kResid, kGelu>(x, x_dtype, norm_w, norm_dtype, \
                                                                eps, qt, scale, G, out,         \
                                                                out_dtype, M, N, K, rs, s)
  if (M == 1) QMV_ROWS(1);
  if (M == 2) QMV_ROWS(2);
  if (M <= 4) QMV_ROWS(4);
  if constexpr (!kResid) {  // the residual variant: no 8- or 16-row instances
    if (M <= 8) QMV_ROWS(8);
    QMV_ROWS(16);
  }
  return cudaErrorInvalidValue;
#undef QMV_ROWS
}

// The residual variant: h_in (M <= 4, K <= 4096) and h_out f32, upd bf16,
// all 16-byte aligned; h_out must not overlap h_in (other blocks still read
// h_in while block 0 writes h_out)
template <bool kInt4, bool kGrouped, bool kGelu>
int launch_resid(const float* h_in, const bf16* upd, const void* post_w, int post_dtype,
                 const void* norm_w, int norm_dtype, float eps, const int8_t* qt,
                 const float* scale, int G, float* h_out, void* out, int out_dtype, int M, int N,
                 int K, cudaStream_t s) {
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const uintptr_t bytes = static_cast<uintptr_t>(M > 0 ? M : 0) * (K > 0 ? K : 0) * 4;
  if (K > kResidMaxK || !h_in || !upd || !post_w || !norm_w || !h_out || addr(h_in) % 16 ||
      addr(upd) % 16 || addr(h_out) % 16 ||
      (addr(h_in) < addr(h_out) + bytes && addr(h_out) < addr(h_in) + bytes))
    return cudaErrorInvalidValue;
  return launch<true, kInt4, kGrouped, true, kGelu>(h_in, DT_F32, norm_w, norm_dtype, eps, qt,
                                                    scale, G, out, out_dtype, M, N, K, s,
                                                    Resid{upd, post_w, post_dtype, h_out});
}

// The few-row plain matvec with the gelu epilogue or without it
template <bool kInt4, bool kGrouped>
int launch_plain(const void* x, int x_dtype, const int8_t* qt, const float* scale, int G,
                 void* out, int out_dtype, int M, int N, int K, int gelu, cudaStream_t s) {
  return gelu ? launch<false, kInt4, kGrouped, false, true>(x, x_dtype, nullptr, DT_F32, 0.f, qt,
                                                            scale, G, out, out_dtype, M, N, K, s)
              : launch<false, kInt4, kGrouped>(x, x_dtype, nullptr, DT_F32, 0.f, qt, scale, G, out,
                                               out_dtype, M, N, K, s);
}

template <bool kInt4, bool kGrouped>
int launch_resid_any(const float* h_in, const bf16* upd, const void* post_w, int post_dtype,
                     const void* norm_w, int norm_dtype, float eps, const int8_t* qt,
                     const float* scale, int G, float* h_out, void* out, int out_dtype, int M,
                     int N, int K, int gelu, cudaStream_t s) {
  return gelu ? launch_resid<kInt4, kGrouped, true>(h_in, upd, post_w, post_dtype, norm_w,
                                                    norm_dtype, eps, qt, scale, G, h_out, out,
                                                    out_dtype, M, N, K, s)
              : launch_resid<kInt4, kGrouped, false>(h_in, upd, post_w, post_dtype, norm_w,
                                                     norm_dtype, eps, qt, scale, G, h_out, out,
                                                     out_dtype, M, N, K, s);
}

}  // namespace

// The packed-int4 instances, for q4_matvec.cu: x (M <= 16, K), qt (N, K/2)
// with K a multiple of 32, x and qt 16-byte aligned; scale (N,) with G = 0,
// or (N, G) in groups of a multiple of 16 columns; norm_w null for no
// RMSNorm; gelu (no norm_w): the gelu epilogue into out (M, N / 2) bf16.
// Returns cudaGetLastError().
int q4_rows_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype, float eps,
                   const uint8_t* qt, const float* scale, int G, void* out, int out_dtype, int M,
                   int N, int K, int gelu, cudaStream_t stream) {
  const int8_t* q = reinterpret_cast<const int8_t*>(qt);
  if (norm_w && gelu) return cudaErrorInvalidValue;
  if (G != 0) {
    return norm_w ? launch<true, true, true>(x, x_dtype, norm_w, norm_dtype, eps, q, scale, G,
                                             out, out_dtype, M, N, K, stream)
                  : launch_plain<true, true>(x, x_dtype, q, scale, G, out, out_dtype, M, N, K,
                                             gelu, stream);
  }
  return norm_w ? launch<true, true, false>(x, x_dtype, norm_w, norm_dtype, eps, q, scale, 0, out,
                                            out_dtype, M, N, K, stream)
                : launch_plain<true, false>(x, x_dtype, q, scale, 0, out, out_dtype, M, N, K,
                                            gelu, stream);
}

// The packed-int4 residual variant, for q4_matvec.cu (its aligned calls of
// M <= 4, per channel or in groups of a multiple of 16 columns)
int q4_rows_residual_matvec(const float* h_in, const bf16* upd, const void* post_w, int post_dtype,
                            const void* norm_w, int norm_dtype, float eps, const uint8_t* qt,
                            const float* scale, int G, float* h_out, void* out, int out_dtype,
                            int M, int N, int K, int gelu, cudaStream_t stream) {
  const int8_t* q = reinterpret_cast<const int8_t*>(qt);
  return G != 0 ? launch_resid_any<true, true>(h_in, upd, post_w, post_dtype, norm_w, norm_dtype,
                                               eps, q, scale, G, h_out, out, out_dtype, M, N, K,
                                               gelu, stream)
                : launch_resid_any<true, false>(h_in, upd, post_w, post_dtype, norm_w, norm_dtype,
                                                eps, q, scale, 0, h_out, out, out_dtype, M, N, K,
                                                gelu, stream);
}

// gelu: the weight is gate | up (N = 2 I rows) and out (M, I) bf16 receives
// bf16(bf16(gelu_tanh(gate)) * up), gate and up rounded to bf16 first
extern "C" int q8_matvec(const void* x, int x_dtype, const int8_t* qt, const float* scale,
                         void* out, int out_dtype, int M, int N, int K, int gelu, void* stream) {
  return launch_plain<false, false>(x, x_dtype, qt, scale, 0, out, out_dtype, M, N, K, gelu,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int q8_rmsnorm_matvec(const void* x, int x_dtype, const void* norm_w, int norm_dtype,
                                 float eps, const int8_t* qt, const float* scale, void* out,
                                 int out_dtype, int M, int N, int K, void* stream) {
  return launch<true, false, false>(x, x_dtype, norm_w, norm_dtype, eps, qt, scale, 0, out,
                                    out_dtype, M, N, K, static_cast<cudaStream_t>(stream));
}

// h_out = bf16(bf16(h_in) + bf16(rms(upd) * (1 + post_w))), then
// out = the q8_rmsnorm_matvec of h_out with norm_w (the header); gelu as
// for q8_matvec
extern "C" int q8_residual_rmsnorm_matvec(const float* h_in, const bf16* upd, const void* post_w,
                                          int post_dtype, const void* norm_w, int norm_dtype,
                                          float eps, const int8_t* qt, const float* scale,
                                          float* h_out, void* out, int out_dtype, int M, int N,
                                          int K, int gelu, void* stream) {
  return launch_resid_any<false, false>(h_in, upd, post_w, post_dtype, norm_w, norm_dtype, eps,
                                        qt, scale, 0, h_out, out, out_dtype, M, N, K, gelu,
                                        static_cast<cudaStream_t>(stream));
}
