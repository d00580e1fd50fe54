// Flash attention for the training path: the forward (out + fp32 LSE) and
// the two backward kernels (dq, and dk/dv), with Gemma2's tanh logit
// softcap, grouped-query heads, the prefix-LM / right-padding / sliding-window
// mask and dead-block skipping.
//
// Replaces the Pallas kernels of spatialvla_tpu/ops/flash_attention.py:
//   flash_fwd     <- _flash_attention_impl (:188, pallas_call :261, _fa_kernel :67)
//   flash_bwd_dq  <- _fa_bwd_dq_kernel (:340, pallas_call :498)
//   flash_bwd_dkv <- _fa_bwd_dkv_kernel (:390, pallas_call :530) together
//                    with the XLA sum over the q-head group at :553: one
//                    block loops over the G query heads of its kv head and
//                    writes dk/dv in k's dtype, so no (B, Nq, Tk, D) fp32
//                    buffer exists.
// delta = rowsum(dO * O) stays a plain torch op, as JAX leaves it to XLA.
//
// Two routes (route_of, exported as flash_fwd_route and flash_bwd_route
// without a launch): bf16 calls take the tensor-core kernels ("mma"), fp32
// calls the FMA kernels ("fma"). flash_fwd_fma and flash_bwd_fma launch the
// FMA kernels in either dtype, to time the two routes side by side.
//
// The FMA kernels (translation of the TPU grid): one thread block per (q
// tile, head, batch row) -- (k tile, kv head, batch row) for dk/dv -- with
// the Pallas grid's sequential k (or q) axis as a loop inside the block.
// Each block reads its own prefix/valid/offset scalars, masks the ragged
// edge itself (rows past T load as zeros and are never stored) instead of
// padding q/k/v, and skips dead tiles by the rule of _dead_block (:327) at
// its own tile size. Masked logits are -1e30, not -inf (:36, :137): a row
// whose keys in a live tile are all masked gets p = exp(0) = 1 there, and
// its output is 0 only when every tile is dead (:155), as in the Pallas
// kernel. fp32 CUDA cores, fp32 tiles in shared memory, 32 x 32 tiles, 256
// threads, each thread a 2 x 2 logit micro-tile and 2 rows x D/16 output
// lanes; probabilities and ds are rounded to the operand dtype before their
// products, where the Pallas kernel casts them (:146, :381, :426, :436).
//
// The tensor-core backward (flash_bwd_mma_kernel, one template for dq and
// for dk/dv). What bounds it at the training shape (B = 2, T = 320, 8 / 4
// heads, D = 256, prefix 277) is bytes: 0.0031 ms for each kernel against
// about 0.002 ms of operations at 989 TFLOP/s, so at T = 320 the time is
// latency and filling the card. At T = 2048 it is operations: dq 0.0528 ms,
// dk/dv 0.0704 ms (6 and 8 D flops an allowed (q, k) pair). The design:
//   * bf16 mma.sync.m16n8k16 with fp32 sums; operands by ldmatrix, the
//     transposed products (dS K for dq; P^T dO and dS^T Q for dk/dv) by
//     ldmatrix.trans from the row-major tiles, so nothing is transposed in
//     memory.
//   * A block owns 32 rows (q rows for dq, keys for dk/dv) and streams
//     tiles of 32 rows of the other side (k/v for dq; q/dO of the group's
//     q heads for dk/dv) through shared memory as bf16, by cp.async 16
//     bytes a thread (zero-filled past T and past D), double buffered: the
//     next live tile loads during this tile's products. Rows are padded by
//     16 bytes (DMAX + 8 elements), so the 8 rows an ldmatrix reads start
//     in 8 different bank groups.
//   * Registers decide the warp layout at D = 256: a warp that held all of
//     D for 16 keys would need dk and dv at 256 fp32 registers a thread. So
//     the 4 warps are 2 row groups x 2 halves of D: each warp computes a
//     16 x 16 quarter of S and dP (over all of D), rounds P and dS to bf16
//     into shared memory (they go there anyway for the products with the
//     other half of D), and after one barrier accumulates its 16 rows x D/2
//     of dq (64 registers) or dk and dv (128).
//   * p and ds on the special-function unit (ex2, rcp: the softcap's tanh
//     as 1 - 2 / (e^2y + 1)), one straight-line copy for each case of a
//     tile (softcap or not; every pair allowed, so no mask, or not).
//   * dq keeps its q and dO fragments in registers for the whole loop
//     (kDqCacheOwn): its S and dP products then read only k and v from
//     shared memory.
//   * Filling the card at T = 320: dq has (10, 8, 2) = 160 blocks. dk/dv
//     has 80 (10 key tiles x 4 kv heads x 2 rows), and each block's time is
//     its serial run over G q heads x 10 q tiles, so halving its keys gives
//     160 blocks and no gain. Instead the G blocks of a thread-block cluster
//     take the group's q heads in turn (dkv_split, where 32-key blocks do
//     not give every SM one), and sum their fp32 partials through
//     distributed shared memory in rank order: (10, 8, 2) = 160 blocks, each
//     with half the serial run. Each block owns its outputs and sums in one
//     fixed order: no atomics, identical bits run to run.
//   * The dead-tile rule of _dead_block at the kernels' own 32 x 32 tiles.
// Stopped short of wgmma and TMA: with 16-row groups and D split in halves,
// a block's tiles are smaller than a 64-row warpgroup product, and at T =
// 320 the kernels are bound by latency, where mma.sync's tiles already fill
// the card. What bounds them now is the S and dP products: a 16 x 16 warp
// tile runs one ldmatrix.x4 for each mma in dk/dv (about a third of the time at
// T = 2048, by scripts/compare_flash_bwd_variants.py); wgmma reading both
// operands from shared memory, on 64-row tiles, is the step for long
// sequences.
//
// The tensor-core forward (flash_fwd_mma_kernel). At the training shape it is
// bound by bytes (0.0024 ms against about 0.0015 ms of operations, 4 D flops
// an allowed pair), so at T = 320 its time is latency and filling the card;
// at T = 2048 it is operations (0.0352 ms). The design, from the backward's
// pieces:
//   * A warp owns 16 q rows and all of D: the output is 128 fp32 registers a
//     thread at D = 256, the running max and sum stay in the warp (a row's 4
//     lanes), and P never leaves registers: the m16n8 C fragments of two key
//     octets, rounded to bf16, are the A fragment of the P.V product. q is
//     read by ldmatrix from shared memory every tile (its fragments would
//     take 64 more registers).
//   * 4 warps a block (64 q rows) share 32-key K/V tiles staged by cp.async
//     (16 bytes a thread, zero-filled past T and D, rows padded 16 bytes),
//     double buffered; V reaches P.V by ldmatrix.trans from its row-major
//     tile. The products run over all of DMAX (the columns past D are zeros),
//     so no branch breaks the unrolled loops, and each k-step's fragments
//     are loaded one step ahead of its mma.
//   * One block a (64-row q tile, q head, batch row): 80 blocks at the
//     training shape (T = 320), 40 at the 277-token flash prefill. Sharing a
//     q tile's key tiles between the 2 blocks of a cluster, merged over
//     distributed shared memory, took the prefill from 0.0242 to 0.0185 ms
//     and gained nothing at T = 320 (scripts/bench_flash_fwd.py, PR 14): a
//     second code path for 0.15 ms of a 170 ms request, so it is not kept.
//   * The logits on the special-function unit (ex2, rcp; the softcap as in
//     p_and_ds_mma), in log2 units, with one straight-line copy for each case
//     of a warp's tile (softcap or not; every pair allowed, so no mask, or
//     not); a warp skips a tile dead for its own 16 rows, a block one dead
//     for all its rows (_dead_block's rule at both sizes); the output rows
//     are rescaled only when some row's max moved.
//   * The reference's semantics (_fa_kernel): masked logits -1e30, p rounded
//     to bf16 before P.V and summed before that rounding, a row with no live
//     tile gets output 0 and LSE 0, the LSE in fp32 natural log, out in bf16.
#include "common.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16: tx = column group, ty = row pair
constexpr int kPS = kTile + 1; // row stride of the (32, 32) probability tiles
constexpr float kNegInf = -1e30f;

struct Geometry {
  int Tq, Tk, Nq, Nkv, D;
  float scale, cap;  // cap <= 0: no softcap
  int window;        // <= 0: no sliding window
  int causal;
};

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
  static __device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Elem<bf16> {
  static __device__ __forceinline__ float load(const bf16* p, long i) { return __bfloat162float(p[i]); }
  static __device__ __forceinline__ void store(bf16* p, long i, float v) { p[i] = __float2bfloat16(v); }
  static __device__ __forceinline__ float round(float x) { return bf16r(x); }
};

// k < valid AND (k <= q OR k < prefix) AND q - k < window (flash_attention.py:130-136)
__device__ __forceinline__ bool allowed(int qpos, int kpos, int prefix, int valid, const Geometry& g) {
  bool ok = kpos < valid && kpos < g.Tk;
  if (g.causal) ok = ok && (kpos <= qpos || kpos < prefix);
  if (g.window > 0) ok = ok && (qpos - kpos) < g.window;
  return ok;
}

// _dead_block (flash_attention.py:327) for a bq x bk tile
__device__ __forceinline__ bool dead_block(int q_start, int bq, int k_start, int bk, int prefix,
                                           int valid, const Geometry& g) {
  const int k_end = k_start + bk - 1;
  bool dead = k_start >= valid;
  if (g.causal) dead = dead || (k_start > q_start + bq - 1 && k_start >= prefix);
  if (g.window > 0) dead = dead || (q_start - k_end) >= g.window;
  return dead;
}

// rows [row0, row0 + kTile) of a (T, heads, D) head slice into a
// (kTile, D + 4) fp32 shared tile; rows past `rows` load as zeros
template <typename T>
__device__ void load_tile(float* dst, const T* src, int row0, int rows, int row_stride, int D) {
  const int SD = D + 4;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = row0 + r;
    dst[r * SD + d] = row < rows ? Elem<T>::load(src, static_cast<long>(row) * row_stride + d) : 0.f;
  }
}

// s[r][c] = A[ty*2 + r] . B[tx + 16 c] over D (fp32 tiles, float4 reads)
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int D, float s[2][2]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int SD = D + 4;
  const float* a0 = A + (ty * 2) * SD;
  const float* a1 = a0 + SD;
  const float* b0 = Bm + tx * SD;
  const float* b1 = Bm + (tx + 16) * SD;
  s[0][0] = s[0][1] = s[1][0] = s[1][1] = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + d);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + d);
    s[0][0] = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x0.z, y0.z, fmaf(x0.w, y0.w, s[0][0]))));
    s[0][1] = fmaf(x0.x, y1.x, fmaf(x0.y, y1.y, fmaf(x0.z, y1.z, fmaf(x0.w, y1.w, s[0][1]))));
    s[1][0] = fmaf(x1.x, y0.x, fmaf(x1.y, y0.y, fmaf(x1.z, y0.z, fmaf(x1.w, y0.w, s[1][0]))));
    s[1][1] = fmaf(x1.x, y1.x, fmaf(x1.y, y1.y, fmaf(x1.z, y1.z, fmaf(x1.w, y1.w, s[1][1]))));
  }
}

// reductions over the 16 lanes that share a row pair (one half warp)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// scaled, softcapped logit and the softcap derivative 1 - tanh^2
// (_block_mask_and_p, flash_attention.py:302-305)
__device__ __forceinline__ float cap_logit(float raw, const Geometry& g, float* dcap) {
  float x = raw * g.scale;
  if (g.cap > 0.f) {
    x = tanhf(x / g.cap) * g.cap;
    const float t = x / g.cap;
    *dcap = 1.f - t * t;
  } else {
    *dcap = 1.f;
  }
  return x;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ prefix_lens, const int* __restrict__ valid_lens,
                 const int* __restrict__ q_offset, T* __restrict__ out, float* __restrict__ lse,
                 Geometry g) {
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  const int D = g.D, SD = D + 4;
  float* Qs = smem;
  float* Ks = Qs + kTile * SD;
  float* Vs = Ks + kTile * SD;
  float* Ps = Vs + kTile * SD;  // (kTile, kPS) probabilities in the operand dtype

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.Nq / g.Nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int prefix = prefix_lens[b], valid = valid_lens[b], qoff = q_offset[b];
  const T* qb = q + (static_cast<long>(b) * g.Tq * g.Nq + h) * D;
  const T* kb = k + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  const T* vb = v + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  load_tile(Qs, qb, q0, g.Tq, g.Nq * D, D);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[0][j] = acc[1][j] = 0.f;

  const int nk = (g.Tk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (dead_block(qoff + q0, kTile, k0, kTile, prefix, valid, g)) continue;  // uniform
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kb, k0, g.Tk, g.Nkv * D, D);
    load_tile(Vs, vb, k0, g.Tk, g.Nkv * D, D);
    __syncthreads();
    float s[2][2];
    dot_tile(Qs, Ks, D, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qoff + q0 + ty * 2 + r;
      float dcap;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = cap_logit(s[r][c], g, &dcap);
        s[r][c] = allowed(qpos, k0 + tx + 16 * c, prefix, valid, g) ? x : kNegInf;
      }
      const float m_new = fmaxf(m[r], half_warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = corr * l[r] + half_warp_sum(p0 + p1);
      m[r] = m_new;
      Ps[(ty * 2 + r) * kPS + tx] = Elem<T>::round(p0);
      Ps[(ty * 2 + r) * kPS + tx + 16] = Elem<T>::round(p1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      const float p0 = Ps[(ty * 2) * kPS + kk], p1 = Ps[(ty * 2 + 1) * kPS + kk];
      const float* vr = Vs + kk * SD + tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j * 16 < D) {
          const float vv = vr[16 * j];
          acc[0][j] = fmaf(p0, vv, acc[0][j]);
          acc[1][j] = fmaf(p1, vv, acc[1][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty * 2 + r;
    if (row >= g.Tq) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];  // fully masked rows -> 0 output
    const long o = (static_cast<long>(b) * g.Tq + row) * g.Nq * D + static_cast<long>(h) * D + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 16 < D) Elem<T>::store(out, o + 16 * j, acc[r][j] / lr);
    }
    if (tx == 0) {
      lse[(static_cast<long>(b) * g.Nq + h) * g.Tq + row] = isfinite(m[r]) ? m[r] + logf(lr) : 0.f;
    }
  }
}

// p and ds of a 2 x 2 micro-tile from the raw logits s and dp = dO . v
// (_block_mask_and_p and the ds lines of :377-379 / :432-434)
__device__ __forceinline__ void p_and_ds(const float s[2][2], const float dp[2][2], int qrow0,
                                         int qoff, int k0, int Tq, const float lse_r[2],
                                         const float delta_r[2], int prefix, int valid,
                                         const Geometry& g, float p[2][2], float ds[2][2]) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float dcap;
      float x = cap_logit(s[r][c], g, &dcap);
      if (!allowed(qoff + qrow0 + r, k0 + tx + 16 * c, prefix, valid, g)) x = kNegInf;
      float pv = expf(x - lse_r[r]);
      float dv = pv * (dp[r][c] - delta_r[r]);
      if (g.cap > 0.f) dv = dv * dcap;
      if (qrow0 + r >= Tq) pv = dv = 0.f;  // ragged q edge
      p[r][c] = pv;
      ds[r][c] = dv;
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ prefix_lens,
                    const int* __restrict__ valid_lens, const int* __restrict__ q_offset,
                    T* __restrict__ dq, Geometry g) {
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  const int D = g.D, SD = D + 4;
  float* Qs = smem;
  float* dOs = Qs + kTile * SD;
  float* Ks = dOs + kTile * SD;
  float* Vs = Ks + kTile * SD;
  float* dSs = Vs + kTile * SD;  // (kTile, kPS) ds in the operand dtype

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.Nq / g.Nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int prefix = prefix_lens[b], valid = valid_lens[b], qoff = q_offset[b];
  const long qhead = (static_cast<long>(b) * g.Tq * g.Nq + h) * D;
  const T* kb = k + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  const T* vb = v + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  load_tile(Qs, q + qhead, q0, g.Tq, g.Nq * D, D);
  load_tile(dOs, dout + qhead, q0, g.Tq, g.Nq * D, D);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty * 2 + r;
    const long i = (static_cast<long>(b) * g.Nq + h) * g.Tq + row;
    lse_r[r] = row < g.Tq ? lse[i] : 0.f;
    delta_r[r] = row < g.Tq ? delta[i] : 0.f;
  }

  float acc[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[0][j] = acc[1][j] = 0.f;

  const int nk = (g.Tk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (dead_block(qoff + q0, kTile, k0, kTile, prefix, valid, g)) continue;
    __syncthreads();
    load_tile(Ks, kb, k0, g.Tk, g.Nkv * D, D);
    load_tile(Vs, vb, k0, g.Tk, g.Nkv * D, D);
    __syncthreads();
    float s[2][2], dp[2][2], p[2][2], ds[2][2];
    dot_tile(Qs, Ks, D, s);
    dot_tile(dOs, Vs, D, dp);
    p_and_ds(s, dp, q0 + ty * 2, qoff, k0, g.Tq, lse_r, delta_r, prefix, valid, g, p, ds);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dSs[(ty * 2 + r) * kPS + tx] = Elem<T>::round(ds[r][0]);
      dSs[(ty * 2 + r) * kPS + tx + 16] = Elem<T>::round(ds[r][1]);
    }
    __syncthreads();
    // acc += scale * (ds @ k) for this tile (flash_attention.py:380)
    float part[2][NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) part[0][j] = part[1][j] = 0.f;
    for (int kk = 0; kk < kTile; ++kk) {
      const float d0 = dSs[(ty * 2) * kPS + kk], d1 = dSs[(ty * 2 + 1) * kPS + kk];
      const float* kr = Ks + kk * SD + tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j * 16 < D) {
          const float kv = kr[16 * j];
          part[0][j] = fmaf(d0, kv, part[0][j]);
          part[1][j] = fmaf(d1, kv, part[1][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(g.scale, part[0][j], acc[0][j]);
      acc[1][j] = fmaf(g.scale, part[1][j], acc[1][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty * 2 + r;
    if (row >= g.Tq) continue;
    const long o = (static_cast<long>(b) * g.Tq + row) * g.Nq * D + static_cast<long>(h) * D + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 16 < D) Elem<T>::store(dq, o + 16 * j, acc[r][j]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ prefix_lens,
                     const int* __restrict__ valid_lens, const int* __restrict__ q_offset,
                     T* __restrict__ dk, T* __restrict__ dv, Geometry g) {
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  const int D = g.D, SD = D + 4;
  float* Ks = smem;
  float* Vs = Ks + kTile * SD;
  float* Qs = Vs + kTile * SD;
  float* dOs = Qs + kTile * SD;
  float* Ps = dOs + kTile * SD;   // (kTile q rows, kPS) p in the operand dtype
  float* dSs = Ps + kTile * kPS;  // (kTile q rows, kPS) ds in the operand dtype
  float* lse_s = dSs + kTile * kPS;
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int G = g.Nq / g.Nkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int prefix = prefix_lens[b], valid = valid_lens[b], qoff = q_offset[b];
  const long khead = (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  load_tile(Ks, k + khead, k0, g.Tk, g.Nkv * D, D);
  load_tile(Vs, v + khead, k0, g.Tk, g.Nkv * D, D);

  // this thread's k rows ty*2 + r, output lanes tx + 16 j
  float dk_acc[2][NJ], dv_acc[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk_acc[0][j] = dk_acc[1][j] = dv_acc[0][j] = dv_acc[1][j] = 0.f;

  const int nq = (g.Tq + kTile - 1) / kTile;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long qhead = (static_cast<long>(b) * g.Tq * g.Nq + h) * D;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (dead_block(qoff + q0, kTile, k0, kTile, prefix, valid, g)) continue;
      __syncthreads();
      load_tile(Qs, q + qhead, q0, g.Tq, g.Nq * D, D);
      load_tile(dOs, dout + qhead, q0, g.Tq, g.Nq * D, D);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long i = (static_cast<long>(b) * g.Nq + h) * g.Tq + row;
        lse_s[threadIdx.x] = row < g.Tq ? lse[i] : 0.f;
        delta_s[threadIdx.x] = row < g.Tq ? delta[i] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2], p[2][2], ds[2][2];
      dot_tile(Qs, Ks, D, s);    // rows: q, columns: k
      dot_tile(dOs, Vs, D, dp);
      const float lse_r[2] = {lse_s[ty * 2], lse_s[ty * 2 + 1]};
      const float delta_r[2] = {delta_s[ty * 2], delta_s[ty * 2 + 1]};
      p_and_ds(s, dp, q0 + ty * 2, qoff, k0, g.Tq, lse_r, delta_r, prefix, valid, g, p, ds);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          Ps[(ty * 2 + r) * kPS + tx + 16 * c] = Elem<T>::round(p[r][c]);
          dSs[(ty * 2 + r) * kPS + tx + 16 * c] = Elem<T>::round(ds[r][c]);
        }
      }
      __syncthreads();
      // dv += p^T @ dO; dk += scale * (ds^T @ q) for this tile (:425-438)
      float part[2][NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) part[0][j] = part[1][j] = 0.f;
      for (int i = 0; i < kTile; ++i) {
        const float p0 = Ps[i * kPS + ty * 2], p1 = Ps[i * kPS + ty * 2 + 1];
        const float d0 = dSs[i * kPS + ty * 2], d1 = dSs[i * kPS + ty * 2 + 1];
        const float* dor = dOs + i * SD + tx;
        const float* qr = Qs + i * SD + tx;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j * 16 < D) {
            const float a = dor[16 * j], qv = qr[16 * j];
            dv_acc[0][j] = fmaf(p0, a, dv_acc[0][j]);
            dv_acc[1][j] = fmaf(p1, a, dv_acc[1][j]);
            part[0][j] = fmaf(d0, qv, part[0][j]);
            part[1][j] = fmaf(d1, qv, part[1][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dk_acc[0][j] = fmaf(g.scale, part[0][j], dk_acc[0][j]);
        dk_acc[1][j] = fmaf(g.scale, part[1][j], dk_acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + ty * 2 + r;
    if (row >= g.Tk) continue;
    const long o = (static_cast<long>(b) * g.Tk + row) * g.Nkv * D + static_cast<long>(hk) * D + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 16 < D) {
        Elem<T>::store(dk, o + 16 * j, dk_acc[r][j]);
        Elem<T>::store(dv, o + 16 * j, dv_acc[r][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core backward (bf16 operands)
// ---------------------------------------------------------------------------

constexpr int kInner = 32;       // rows of a streamed tile: keys (dq) or q rows (dk/dv)
constexpr int kSP = kInner + 8;  // row stride (bf16) of the P and dS tiles

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// every (q, k) pair of a bq x bk tile allowed, and every q row below Tq:
// the tile needs no mask (q_start and the rows are indices; qoff offsets q)
__device__ __forceinline__ bool full_block(int q_start, int bq, int k_start, int bk, int qoff,
                                           int prefix, int valid, const Geometry& g) {
  const int q_end = q_start + bq - 1, k_end = k_start + bk - 1;
  bool full = k_end < valid && k_end < g.Tk && q_end < g.Tq;
  if (g.causal) full = full && (k_end <= qoff + q_start || k_end < prefix);
  if (g.window > 0) full = full && (qoff + q_end - k_start) < g.window;
  return full;
}

// 2^x and 1 / x on the special-function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The 16-byte columns of a (T, heads, D) head slice that one thread stages
// into a (ROWS, DMAX + 8) bf16 tile: the same column of rows r0, r0 +
// kStep, ..., so only the row changes from tile to tile. Rows past `rows`
// and columns past D are zero-filled.
template <int DMAX, int ROWS, int NT>
struct RowStager {
  static constexpr int kChunks = DMAX / 8, kStep = NT / kChunks;
  static_assert(NT % kChunks == 0 && ROWS % kStep == 0, "whole rows a pass");
  int r0, col;
  bool col_ok;
  __device__ __forceinline__ explicit RowStager(int D)
      : r0(threadIdx.x / kChunks), col((threadIdx.x % kChunks) * 8), col_ok(col < D) {}
  // rows [row0, row0 + ROWS) of src (row stride `stride` elements)
  __device__ __forceinline__ void operator()(bf16* dst, const bf16* src, int row0, int rows,
                                             long stride) const {
    const bf16* g = src + col;
    bf16* d = dst + r0 * (DMAX + 8) + col;
#pragma unroll
    for (int it = 0; it < ROWS / kStep; ++it) {
      const int row = row0 + r0 + it * kStep;
      const bool ok = col_ok && row < rows;
      cp_async<16>(d + it * kStep * (DMAX + 8), ok ? g + row * stride : src, ok);
    }
  }
};

// p and ds of a warp's 16 x 16 quarter of a tile (_block_mask_and_p and
// :377-379 / :432-434), rounded to bf16 into the (32, kSP) dS and (dk/dv) P
// tiles at [own row][inner column]. The softcap as cap tanh(y) with tanh(y)
// = 1 - 2 / (2^(2 y log2 e) + 1), and p = 2^(x log2 e - lse log2 e), on the
// special-function unit (tanh within about 1e-7; tanhf and expf take
// several times the instructions). kFull: every pair of the tile is
// allowed, no mask. One straight-line copy for each case of the tile.
// r0 / c0: this lane's first own row and inner column in the tile;
// own_base / inner_base: the tile's first own and inner row indices.
template <bool kDKV, bool kFull, bool kCapped>
__device__ __forceinline__ void p_and_ds_mma(
    const float (&s)[2][4], const float (&dp)[2][4], const float* lse_c, const float* delta_c,
    const float (&lse_r)[2], const float (&delta_r)[2], int r0, int c0, int own_base,
    int inner_base, int qoff, int prefix, int valid, float cap2, const Geometry& g, bf16* dSs,
    bf16* Ps) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + hh * 8, c = c0 + t * 8;
      float pv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // dk/dv: the LSE and delta of inner column c + e; dq: of own row r
        const float l2 = (kDKV ? lse_c[c + e] : lse_r[hh]) * kLog2e;
        const float de = kDKV ? delta_c[c + e] : delta_r[hh];
        float x = s[t][2 * hh + e] * g.scale, dcap = 1.f;
        if constexpr (kCapped) {
          const float th = fmaf(-2.f, rcp(ex2(x * cap2) + 1.f), 1.f);
          x = g.cap * th;
          dcap = fmaf(-th, th, 1.f);
        }
        bool zero = false;
        if constexpr (!kFull) {
          const int qi = kDKV ? inner_base + c + e : own_base + r;
          const int ki = kDKV ? own_base + r : inner_base + c + e;
          if (!allowed(qoff + qi, ki, prefix, valid, g)) x = kNegInf;
          zero = qi >= g.Tq;  // ragged q edge
        }
        float p = ex2(fmaf(x, kLog2e, -l2));
        float d = p * (dp[t][2 * hh + e] - de) * dcap;
        if (zero) p = d = 0.f;
        pv[e] = p;
        dv[e] = d;
      }
      *reinterpret_cast<__nv_bfloat162*>(dSs + r * kSP + c) = __floats2bfloat162_rn(dv[0], dv[1]);
      if constexpr (kDKV) {
        *reinterpret_cast<__nv_bfloat162*>(Ps + r * kSP + c) = __floats2bfloat162_rn(pv[0], pv[1]);
      }
    }
  }
}

// dq keeps its 16 q rows' fragments of q and dO (the A operands of S = q k^T
// and dP = dO v^T) in registers for the whole loop, halving what its S and dP
// products read from shared memory (255 registers at D = 256, no spill);
// dk/dv has no registers for that
constexpr bool kDqCacheOwn = true;

constexpr int kOwn = 32;         // own rows of a block: q rows (dq) or keys (dk/dv)
constexpr int kMmaThreads = 128;  // 4 warps: 2 row groups of 16 x 2 halves of D

// dq (kDKV false) or dk/dv (true) on bf16 tensor cores; see the note at the
// head of the file. Block (own tile, head, batch row): 32 q rows x q head
// for dq; for dk/dv 32 keys x (kv head, rank in its cluster), the cluster's
// blocks taking the group's q heads in turn. Warp w is row group w / 2 and
// half w % 2 of D.
template <int DMAX, bool kDKV>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ prefix_lens, const int* __restrict__ valid_lens,
                     const int* __restrict__ q_offset, bf16* __restrict__ out0,
                     bf16* __restrict__ out1, Geometry g) {
  constexpr int NT = kMmaThreads, R = kOwn;
  constexpr int SD = DMAX + 8;   // row stride of the q/k/v/dO tiles
  constexpr int NP = DMAX / 32;  // 16-column steps of a half of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* own1 = reinterpret_cast<bf16*>(smem_raw);  // q (dq) or k (dk/dv)
  bf16* own2 = own1 + R * SD;                       // dO (dq) or v (dk/dv)
  bf16* in1 = own2 + R * SD;                        // 2 stages of k (dq) or q (dk/dv)
  bf16* in2 = in1 + 2 * kInner * SD;                // 2 stages of v (dq) or dO (dk/dv)
  bf16* dSs = in2 + 2 * kInner * SD;                // (R, kSP) ds, own rows x inner columns
  bf16* Ps = dSs + R * kSP;                         // (R, kSP) p (dk/dv)
  float* lse_s = reinterpret_cast<float*>(Ps + (kDKV ? R * kSP : 0));  // 2 stages (dk/dv)
  float* delta_s = lse_s + 2 * kInner;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp >> 1, ch = warp & 1;
  const int b = blockIdx.z, G = g.Nq / g.Nkv, D = g.D;
  // dk/dv: this block takes q heads rank, rank + split, ... of its group
  int split = 1, rank = 0;
  if constexpr (kDKV) {
    const cg::cluster_group cluster = cg::this_cluster();
    split = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int h = kDKV ? 0 : blockIdx.y;  // q head (dq)
  const int hk = blockIdx.y / (kDKV ? split : G);
  const int own0 = blockIdx.x * R;
  const int prefix = prefix_lens[b], valid = valid_lens[b], qoff = q_offset[b];
  const long qstride = static_cast<long>(g.Nq) * D, kstride = static_cast<long>(g.Nkv) * D;
  const bf16* kb = k + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  const bf16* vb = v + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  const int nt = ((kDKV ? g.Tq : g.Tk) + kInner - 1) / kInner;  // inner tiles of one head
  // dk/dv: tile j is tile j % nt of q head hk G + rank + (j / nt) split
  const int n = kDKV ? (G - rank + split - 1) / split * nt : nt;

  const RowStager<DMAX, R, NT> stage_own(D);
  const RowStager<DMAX, kInner, NT> stage_in(D);
  if constexpr (kDKV) {
    stage_own(own1, kb, own0, g.Tk, kstride);
    stage_own(own2, vb, own0, g.Tk, kstride);
  } else {
    const long qh = (static_cast<long>(b) * g.Tq * g.Nq + h) * D;
    stage_own(own1, q + qh, own0, g.Tq, qstride);
    stage_own(own2, dout + qh, own0, g.Tq, qstride);
  }

  // the first inner tile at or after j that the mask does not leave dead
  auto next_live = [&](int j) {
    for (; j < n; ++j) {
      const int t = kDKV ? j % nt : j;
      const bool dead = kDKV ? dead_block(qoff + t * kInner, kInner, own0, R, prefix, valid, g)
                             : dead_block(qoff + own0, R, t * kInner, kInner, prefix, valid, g);
      if (!dead) break;
    }
    return j;
  };
  auto stage_inner = [&](int j, int st) {
    bf16* d1 = in1 + st * kInner * SD;
    bf16* d2 = in2 + st * kInner * SD;
    if constexpr (kDKV) {
      const int t = j % nt, hq = hk * G + rank + j / nt * split;
      const long qh = (static_cast<long>(b) * g.Tq * g.Nq + hq) * D;
      stage_in(d1, q + qh, t * kInner, g.Tq, qstride);
      stage_in(d2, dout + qh, t * kInner, g.Tq, qstride);
      const long li = (static_cast<long>(b) * g.Nq + hq) * g.Tq;
      for (int i = threadIdx.x; i < 2 * kInner; i += NT) {
        const int r = i % kInner, row = t * kInner + r;
        const bool ok = row < g.Tq;
        const float* src = (i < kInner ? lse : delta) + (ok ? li + row : 0);
        cp_async<4>((i < kInner ? lse_s : delta_s) + st * kInner + r, src, ok);
      }
    } else {
      stage_in(d1, kb, j * kInner, g.Tk, kstride);
      stage_in(d2, vb, j * kInner, g.Tk, kstride);
    }
  };

  // dq: the LSE and delta of this thread's two q rows
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!kDKV) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = own0 + rg * 16 + (lane >> 2) + hh * 8;
      if (row < g.Tq) {
        const long i = (static_cast<long>(b) * g.Nq + h) * g.Tq + row;
        lse_r[hh] = lse[i];
        delta_r[hh] = delta[i];
      }
    }
  }

  // this warp's 16 own rows x its half of D: dq (or dk), and dv
  float acc0[2 * NP][4], acc1[kDKV ? 2 * NP : 1][4];
#pragma unroll
  for (int t = 0; t < 2 * NP; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc0[t][e] = 0.f;
      if constexpr (kDKV) acc1[t][e] = 0.f;
    }
  }
  const bool capped = g.cap > 0.f;
  const float cap2 = capped ? 2.f * kLog2e / g.cap : 0.f;  // 2 y log2 e = x cap2
  const int Dh = (D + 31) / 32 * 16;  // columns of each half, a multiple of 16
  const int c0 = ch * Dh;
  // ldmatrix lane offsets: A (and B by .trans) from a row-major tile, and B
  // from a tile whose rows are its columns
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;

  int j = next_live(0);
  if (j < n) stage_inner(j, 0);
  cp_async_commit();
  // dq: this warp's fragments of its own q and dO rows, read once
  constexpr bool kCache = !kDKV && kDqCacheOwn;
  unsigned fa1[kCache ? DMAX / 16 : 1][4], fa2[kCache ? DMAX / 16 : 1][4];
  if constexpr (kCache) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < D) {
        ldmatrix_x4(fa1[kk], own1 + (rg * 16 + arow) * SD + kk * 16 + acol);
        ldmatrix_x4(fa2[kk], own2 + (rg * 16 + arow) * SD + kk * 16 + acol);
      }
    }
  }
  int st = 0;
  while (j < n) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with the other stage and dS
    const int jn = next_live(j + 1);
    if (jn < n) stage_inner(jn, st ^ 1);
    cp_async_commit();
    const bf16* i1 = in1 + st * kInner * SD;
    const bf16* i2 = in2 + st * kInner * SD;

    // s = own1 . in1 and dp = own2 . in2 over D: own rows rg * 16 + [0, 16),
    // inner columns ch * 16 + [0, 16) (two n8 tiles)
    float s[2][4], dp[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < D) {
        unsigned a[4], bb[4];
        if constexpr (kCache) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = fa1[kk][e];
        } else {
          ldmatrix_x4(a, own1 + (rg * 16 + arow) * SD + kk * 16 + acol);
        }
        ldmatrix_x4(bb, i1 + (ch * 16 + brow) * SD + kk * 16 + bcol);
        mma_bf16(s[0], a, bb[0], bb[1]);
        mma_bf16(s[1], a, bb[2], bb[3]);
        if constexpr (kCache) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = fa2[kk][e];
        } else {
          ldmatrix_x4(a, own2 + (rg * 16 + arow) * SD + kk * 16 + acol);
        }
        ldmatrix_x4(bb, i2 + (ch * 16 + brow) * SD + kk * 16 + bcol);
        mma_bf16(dp[0], a, bb[0], bb[1]);
        mma_bf16(dp[1], a, bb[2], bb[3]);
      }
    }

    // p and ds, by a copy of p_and_ds_mma for each case of the tile
    const int jt = kDKV ? j % nt : j;  // the tile's index within its head
    const bool full = kDKV ? full_block(jt * kInner, kInner, own0, R, qoff, prefix, valid, g)
                           : full_block(own0, R, jt * kInner, kInner, qoff, prefix, valid, g);
#define P_DS_ARGS                                                                          \
  s, dp, lse_s + st * kInner, delta_s + st * kInner, lse_r, delta_r, rg * 16 + (lane >> 2), \
      ch * 16 + ((lane & 3) << 1), own0, jt * kInner, qoff, prefix, valid, cap2, g, dSs, Ps
    if (full) {
      if (capped) p_and_ds_mma<kDKV, true, true>(P_DS_ARGS);
      else p_and_ds_mma<kDKV, true, false>(P_DS_ARGS);
    } else {
      if (capped) p_and_ds_mma<kDKV, false, true>(P_DS_ARGS);
      else p_and_ds_mma<kDKV, false, false>(P_DS_ARGS);
    }
#undef P_DS_ARGS
    __syncthreads();  // the whole (R, 32) ds (and p) tile is in shared memory

    // dq += ds . k, or dk += ds^T . q and dv += p^T . dO: this warp's 16 own
    // rows x columns [c0, c0 + Dh) of D
#pragma unroll
    for (int kc = 0; kc < kInner / 16; ++kc) {
      unsigned a[4], ap[4];
      ldmatrix_x4(a, dSs + (rg * 16 + arow) * kSP + kc * 16 + acol);
      if constexpr (kDKV) ldmatrix_x4(ap, Ps + (rg * 16 + arow) * kSP + kc * 16 + acol);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const int col = c0 + np * 16;
        if (np * 16 < Dh && col < D) {
          unsigned bb[4];
          ldmatrix_x4_trans(bb, i1 + (kc * 16 + arow) * SD + col + acol);
          mma_bf16(acc0[2 * np], a, bb[0], bb[1]);
          mma_bf16(acc0[2 * np + 1], a, bb[2], bb[3]);
          if constexpr (kDKV) {
            ldmatrix_x4_trans(bb, i2 + (kc * 16 + arow) * SD + col + acol);
            mma_bf16(acc1[2 * np], ap, bb[0], bb[1]);
            mma_bf16(acc1[2 * np + 1], ap, bb[2], bb[3]);
          }
        }
      }
    }
    j = jn;
    st ^= 1;
  }
  cp_async_wait_all();

  // scale . dq, or scale . dk and dv, in bf16; rows past T are not stored
  const int T_own = kDKV ? g.Tk : g.Tq;
  const long ostride = kDKV ? kstride : qstride;
  const long obase = kDKV ? (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D
                          : (static_cast<long>(b) * g.Tq * g.Nq + h) * D;
  if constexpr (kDKV) {
    if (split > 1) {
      // The cluster's partial dk and dv, summed in rank order through
      // distributed shared memory: each block's partials into a (2, R,
      // DMAX + 8) fp32 buffer over its stream tiles, then each block sums
      // and stores every split-th (row, column pair) of the tile.
      constexpr int RS = DMAX + 8;
      float* red = reinterpret_cast<float*>(in1);
      __syncthreads();  // every warp is done with the last tile
#pragma unroll
      for (int t = 0; t < 2 * NP; ++t) {
        const int col = c0 + t * 8 + ((lane & 3) << 1);
        if (t * 8 < Dh && col < D) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = rg * 16 + (lane >> 2) + hh * 8;
            *reinterpret_cast<float2*>(red + r * RS + col) =
                make_float2(acc0[t][2 * hh], acc0[t][2 * hh + 1]);
            *reinterpret_cast<float2*>(red + (R + r) * RS + col) =
                make_float2(acc1[t][2 * hh], acc1[t][2 * hh + 1]);
          }
        }
      }
      const cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's partials are in its shared memory
      const int pairs = D / 2;
      for (int u = rank * NT + static_cast<int>(threadIdx.x); u < R * pairs; u += split * NT) {
        const int r = u / pairs, col = (u - r * pairs) * 2;
        float2 sk = make_float2(0.f, 0.f), sv = sk;
        for (int i = 0; i < split; ++i) {
          const float* peer = cluster.map_shared_rank(red, i);
          const float2 pk = *reinterpret_cast<const float2*>(peer + r * RS + col);
          const float2 pv = *reinterpret_cast<const float2*>(peer + (R + r) * RS + col);
          sk.x += pk.x;
          sk.y += pk.y;
          sv.x += pv.x;
          sv.y += pv.y;
        }
        if (own0 + r < T_own) {
          const long o = obase + static_cast<long>(own0 + r) * ostride + col;
          *reinterpret_cast<__nv_bfloat162*>(out0 + o) =
              __floats2bfloat162_rn(g.scale * sk.x, g.scale * sk.y);
          *reinterpret_cast<__nv_bfloat162*>(out1 + o) = __floats2bfloat162_rn(sv.x, sv.y);
        }
      }
      cluster.sync();  // the peers are done reading this block's partials
      return;
    }
  }
#pragma unroll
  for (int t = 0; t < 2 * NP; ++t) {
    const int col = c0 + t * 8 + ((lane & 3) << 1);
    if (t * 8 < Dh && col < D) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = own0 + rg * 16 + (lane >> 2) + hh * 8;
        if (row < T_own) {
          const long o = obase + static_cast<long>(row) * ostride + col;
          *reinterpret_cast<__nv_bfloat162*>(out0 + o) =
              __floats2bfloat162_rn(g.scale * acc0[t][2 * hh], g.scale * acc0[t][2 * hh + 1]);
          if constexpr (kDKV) {
            *reinterpret_cast<__nv_bfloat162*>(out1 + o) =
                __floats2bfloat162_rn(acc1[t][2 * hh], acc1[t][2 * hh + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core forward (bf16 operands)
// ---------------------------------------------------------------------------

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // a masked logit, in log2 units

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The online softmax of a warp's 16 x 32 tile of raw logits s, in place:
// s[t][e] is the m16n8 C fragment of key octet t (row lane / 4 + 8 (e / 2),
// key t * 8 + 2 (lane % 4) + e % 2). Each logit is scaled, softcapped (cap
// tanh(y) with tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1), as p_and_ds_mma),
// masked to -1e30 and taken to log2 units; m2 (the running max, log2 units)
// and l (this lane's share of the running sum) move on; s becomes p = 2^(x -
// m2) and corr the factor of each row's old sum and output. kFull: every
// pair of the tile is allowed, no mask. One straight-line copy for each case.
// qi0: the warp's first q row; sl2 = scale log2 e; cap2 = scale 2 log2 e /
// cap; capl2 = cap log2 e.
template <bool kFull, bool kCapped>
__device__ __forceinline__ void online_softmax(float (&s)[4][4], float (&m2)[2], float (&l)[2],
                                               float (&corr)[2], int qi0, int k0, int qoff,
                                               int prefix, int valid, float sl2, float cap2,
                                               float capl2, const Geometry& g) {
  const int lane = threadIdx.x & 31;
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if constexpr (kCapped) {
        x = fmaf(-2.f, rcp(ex2(s[t][e] * cap2) + 1.f), 1.f) * capl2;
      } else {
        x = s[t][e] * sl2;
      }
      if constexpr (!kFull) {
        const int qi = qi0 + (lane >> 2) + (e >> 1) * 8;
        const int ki = k0 + t * 8 + ((lane & 3) << 1) + (e & 1);
        if (!allowed(qoff + qi, ki, prefix, valid, g)) x = kNegInf2;
      }
      s[t][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the 4 lanes of a row
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    corr[hh] = ex2(m2[hh] - mx[hh]);  // 0 for the first live tile (m2 = -inf)
    m2[hh] = mx[hh];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = ex2(s[t][e] - m2[e >> 1]);
      sum[e >> 1] += s[t][e];
    }
  }
  l[0] = fmaf(l[0], corr[0], sum[0]);
  l[1] = fmaf(l[1], corr[1], sum[1]);
}

constexpr int kFwdWarps = 4;  // warps of a forward block, 16 q rows each

// The forward on bf16 tensor cores (flash_fwd on bf16 operands; see the note
// at the head of the file). Block (q tile, q head, batch row): kFwdWarps
// warps, each owning 16 q rows and all of D, so a warp's running max, sum
// and output stay in its registers and P goes from the S fragments straight
// into the P.V product; the warps share the block's K/V tiles.
template <int DMAX>
__global__ void __launch_bounds__(kFwdWarps * 32)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ prefix_lens,
                     const int* __restrict__ valid_lens, const int* __restrict__ q_offset,
                     bf16* __restrict__ out, float* __restrict__ lse, Geometry g) {
  constexpr int NT = kFwdWarps * 32, R = kFwdWarps * 16;
  constexpr int SD = DMAX + 8;  // row stride of the q/k/v tiles
  constexpr int NJ = DMAX / 8;  // n8 tiles of the output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (R, SD)
  bf16* Ks = Qs + R * SD;                          // 2 stages of (kInner, SD)
  bf16* Vs = Ks + 2 * kInner * SD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z, D = g.D;
  const int hk = h / (g.Nq / g.Nkv);
  const int prefix = prefix_lens[b], valid = valid_lens[b], qoff = q_offset[b];
  const long qstride = static_cast<long>(g.Nq) * D, kstride = static_cast<long>(g.Nkv) * D;
  const long qh = (static_cast<long>(b) * g.Tq * g.Nq + h) * D;
  const bf16* kb = k + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  const bf16* vb = v + (static_cast<long>(b) * g.Tk * g.Nkv + hk) * D;
  const int nt = (g.Tk + kInner - 1) / kInner;

  const RowStager<DMAX, R, NT> stage_q(D);
  const RowStager<DMAX, kInner, NT> stage_kv(D);
  stage_q(Qs, q + qh, q0, g.Tq, qstride);
  // the next key tile at or after j that the mask does not leave dead for
  // the block's rows
  auto next_live = [&](int j) {
    while (j < nt && dead_block(qoff + q0, R, j * kInner, kInner, prefix, valid, g)) ++j;
    return j;
  };
  auto stage = [&](int j, int st) {
    stage_kv(Ks + st * kInner * SD, kb, j * kInner, g.Tk, kstride);
    stage_kv(Vs + st * kInner * SD, vb, j * kInner, g.Tk, kstride);
  };
  int j = next_live(0);
  if (j < nt) stage(j, 0);
  cp_async_commit();

  float acc[NJ][4];
#pragma unroll
  for (int t = 0; t < NJ; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool capped = g.cap > 0.f;
  const float sl2 = g.scale * kLog2e;
  const float cap2 = capped ? g.scale * 2.f * kLog2e / g.cap : 0.f;
  const float capl2 = g.cap * kLog2e;
  // ldmatrix lane offsets: A (and B by .trans) from a row-major tile, and B
  // from a tile whose rows are its columns
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int w0 = q0 + warp * 16;  // this warp's first q row
  const bf16* qw = Qs + (warp * 16 + arow) * SD + acol;

  int st = 0;
  while (j < nt) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with the other stage
    const int jn = next_live(j + 1);
    if (jn < nt) stage(jn, st ^ 1);
    cp_async_commit();
    const int k0 = j * kInner;
    // warp-uniform: this warp's 16 rows skip a tile dead for them
    if (w0 < g.Tq && !dead_block(qoff + w0, 16, k0, kInner, prefix, valid, g)) {
      const bf16* Kt = Ks + st * kInner * SD;
      const bf16* Vt = Vs + st * kInner * SD;
      // s = q . k over DMAX (the columns past D are zeros in shared memory,
      // so no branch breaks the unrolled loop): 16 rows x 32 keys (four n8
      // tiles), each k-step's fragments loaded one step ahead
      float s[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
      }
      unsigned fq[2][4], fk0[2][4], fk1[2][4];
      ldmatrix_x4(fq[0], qw);
      ldmatrix_x4(fk0[0], Kt + brow * SD + bcol);
      ldmatrix_x4(fk1[0], Kt + (16 + brow) * SD + bcol);
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const int c = kk & 1, n = c ^ 1;
        if (kk + 1 < DMAX / 16) {
          ldmatrix_x4(fq[n], qw + (kk + 1) * 16);
          ldmatrix_x4(fk0[n], Kt + brow * SD + (kk + 1) * 16 + bcol);
          ldmatrix_x4(fk1[n], Kt + (16 + brow) * SD + (kk + 1) * 16 + bcol);
        }
        mma_bf16(s[0], fq[c], fk0[c][0], fk0[c][1]);
        mma_bf16(s[1], fq[c], fk0[c][2], fk0[c][3]);
        mma_bf16(s[2], fq[c], fk1[c][0], fk1[c][1]);
        mma_bf16(s[3], fq[c], fk1[c][2], fk1[c][3]);
      }
      float corr[2];
      const bool full = full_block(w0, 16, k0, kInner, qoff, prefix, valid, g);
#define SOFTMAX_ARGS s, m2, l, corr, w0, k0, qoff, prefix, valid, sl2, cap2, capl2, g
      if (full) {
        if (capped) online_softmax<true, true>(SOFTMAX_ARGS);
        else online_softmax<true, false>(SOFTMAX_ARGS);
      } else {
        if (capped) online_softmax<false, true>(SOFTMAX_ARGS);
        else online_softmax<false, false>(SOFTMAX_ARGS);
      }
#undef SOFTMAX_ARGS
      // rescale the output rows whose max moved (none, in most tiles once a
      // row has met its largest logits)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          acc[t][0] *= corr[0];
          acc[t][1] *= corr[0];
          acc[t][2] *= corr[1];
          acc[t][3] *= corr[1];
        }
      }
      // out += p . v over DMAX columns: p rounded to bf16
      // (flash_attention.py:146) as the A fragments of 16-key chunks (the C
      // fragments of two key octets), v by ldmatrix.trans from the
      // row-major tile, each fragment loaded one step ahead
      unsigned pa[kInner / 16][4];
#pragma unroll
      for (int kc = 0; kc < kInner / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
      constexpr int NPV = kInner / 16 * (DMAX / 16);  // (key chunk, 16 columns) steps
      unsigned fv[2][4];
      ldmatrix_x4_trans(fv[0], Vt + arow * SD + acol);
#pragma unroll
      for (int i = 0; i < NPV; ++i) {
        const int kc = i / (DMAX / 16), np = i % (DMAX / 16), c = i & 1;
        if (i + 1 < NPV) {
          const int kn = (i + 1) / (DMAX / 16), nn = (i + 1) % (DMAX / 16);
          ldmatrix_x4_trans(fv[c ^ 1], Vt + (kn * 16 + arow) * SD + nn * 16 + acol);
        }
        mma_bf16(acc[2 * np], pa[kc], fv[c][0], fv[c][1]);
        mma_bf16(acc[2 * np + 1], pa[kc], fv[c][2], fv[c][3]);
      }
    }
    j = jn;
    st ^= 1;
  }
  cp_async_wait_all();

  // out = acc / l in bf16 and the LSE (natural log) of each row below Tq; a
  // row that met no live tile (l = 0) gets output 0 and LSE 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = w0 + (lane >> 2) + hh * 8;
    if (row < g.Tq) {
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      bf16* o = out + qh + static_cast<long>(row) * qstride;
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        const int col = t * 8 + ((lane & 3) << 1);
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(acc[t][2 * hh] * inv, acc[t][2 * hh + 1] * inv);
        }
      }
      if ((lane & 3) == 0) {
        lse[(static_cast<long>(b) * g.Nq + h) * g.Tq + row] =
            lr == 0.f ? 0.f : fmaf(m2[hh], kLn2, logf(lr));
      }
    }
  }
}

size_t fwd_smem(int D) { return (3 * kTile * (D + 4) + kTile * kPS) * sizeof(float); }
size_t dq_smem(int D) { return (4 * kTile * (D + 4) + kTile * kPS) * sizeof(float); }
size_t dkv_smem(int D) { return (4 * kTile * (D + 4) + 2 * kTile * kPS + 2 * kTile) * sizeof(float); }

// Allow a kernel the shared memory of its largest head dim, once per
// instantiation (the first launch; later launches, CUDA-graph captures
// included, make no attribute call).
template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

bool bad_geometry(int B, const Geometry& g) {
  return B < 1 || g.Tq < 1 || g.Tk < 1 || g.Nkv < 1 || g.Nq % g.Nkv != 0 || g.D < 16 ||
         g.D % 16 != 0 || g.D > 256 || B > 65535 || g.Nq > 65535;
}

template <typename T, int DMAX>
int fwd_launch(const void* q, const void* k, const void* v, const int* prefix, const int* valid,
               const int* qoff, void* out, float* lse, int B, const Geometry& g, cudaStream_t st) {
  const size_t smem = fwd_smem(g.D);
  static const int attr = prepare(flash_fwd_kernel<T, DMAX>, fwd_smem(DMAX));
  if (attr) return attr;
  const dim3 grid((g.Tq + kTile - 1) / kTile, g.Nq, B);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), prefix, valid,
      qoff, static_cast<T*>(out), lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* prefix, const int* valid, const int* qoff, void* dq,
              int B, const Geometry& g, cudaStream_t st) {
  const size_t smem = dq_smem(g.D);
  static const int attr = prepare(flash_bwd_dq_kernel<T, DMAX>, dq_smem(DMAX));
  if (attr) return attr;
  const dim3 grid((g.Tq + kTile - 1) / kTile, g.Nq, B);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, prefix, valid, qoff, static_cast<T*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* prefix, const int* valid, const int* qoff, void* dk,
               void* dv, int B, const Geometry& g, cudaStream_t st) {
  const size_t smem = dkv_smem(g.D);
  static const int attr = prepare(flash_bwd_dkv_kernel<T, DMAX>, dkv_smem(DMAX));
  if (attr) return attr;
  const dim3 grid((g.Tk + kTile - 1) / kTile, g.Nkv, B);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, prefix, valid, qoff, static_cast<T*>(dk),
      static_cast<T*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

// dtype x head-dim bound dispatch: D <= 64, <= 128 or <= 256 output lanes
#define FLASH_DISPATCH(LAUNCH, ...)                                                       \
  do {                                                                                    \
    if (dtype == DT_F32) {                                                                \
      if (g.D <= 64) return LAUNCH<float, 64>(__VA_ARGS__);                               \
      if (g.D <= 128) return LAUNCH<float, 128>(__VA_ARGS__);                             \
      return LAUNCH<float, 256>(__VA_ARGS__);                                             \
    }                                                                                     \
    if (dtype == DT_BF16) {                                                               \
      if (g.D <= 64) return LAUNCH<bf16, 64>(__VA_ARGS__);                                \
      if (g.D <= 128) return LAUNCH<bf16, 128>(__VA_ARGS__);                              \
      return LAUNCH<bf16, 256>(__VA_ARGS__);                                              \
    }                                                                                     \
    return cudaErrorInvalidValue;                                                         \
  } while (0)

int fma_fwd(const void* q, const void* k, const void* v, const int* prefix, const int* valid,
            const int* qoff, void* out, float* lse, int dtype, int B, const Geometry& g,
            cudaStream_t st) {
  FLASH_DISPATCH(fwd_launch, q, k, v, prefix, valid, qoff, out, lse, B, g, st);
}

int fma_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const int* prefix, const int* valid, const int* qoff, void* dq,
           int dtype, int B, const Geometry& g, cudaStream_t st) {
  FLASH_DISPATCH(dq_launch, q, k, v, dout, lse, delta, prefix, valid, qoff, dq, B, g, st);
}

int fma_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, const int* prefix, const int* valid, const int* qoff, void* dk,
            void* dv, int dtype, int B, const Geometry& g, cudaStream_t st) {
  FLASH_DISPATCH(dkv_launch, q, k, v, dout, lse, delta, prefix, valid, qoff, dk, dv, B, g, st);
}

// ---------------------------------------------------------------- routes

enum { kRouteFma = 0, kRouteMma = 1 };

// The route of the forward and of the backward: bf16 -> the tensor-core
// kernels, fp32 -> the FMA kernels; -1 for operands the kernels do not take
int route_of(int dtype, int D) {
  if (D < 16 || D > 256 || D % 16 != 0) return -1;
  if (dtype == DT_BF16) return kRouteMma;
  if (dtype == DT_F32) return kRouteFma;
  return -1;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The blocks (a cluster) that share a dk/dv tile's q heads: 1 where 32-key
// blocks give every SM a block, else the group's size up to the portable
// cluster size of 8. dq blocks take no split.
int dkv_split(int B, const Geometry& g) {
  const int G = g.Nq / g.Nkv;
  if (static_cast<long>((g.Tk + kOwn - 1) / kOwn) * g.Nkv * B >= sm_count()) return 1;
  return G < 8 ? G : 8;
}

template <int DMAX, bool kDKV>
size_t mma_smem() {
  constexpr int SD = DMAX + 8;
  return sizeof(bf16) * (2 * kOwn * SD + 4 * kInner * SD + (kDKV ? 2 : 1) * kOwn * kSP) +
         (kDKV ? 4 * kInner * sizeof(float) : 0);
}

template <bool kDKV>
dim3 mma_grid(int split, int B, const Geometry& g) {
  return dim3(((kDKV ? g.Tk : g.Tq) + kOwn - 1) / kOwn, kDKV ? g.Nkv * split : g.Nq, B);
}

// f(DMAX), a std::integral_constant: the head-dim bucket of a call
template <typename F>
int mma_instance(const Geometry& g, F&& f) {
  if (g.D <= 64) return f(std::integral_constant<int, 64>{});
  if (g.D <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kDKV>
int mma_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* prefix, const int* valid, const int* qoff,
               void* out0, void* out1, int B, const Geometry& g, cudaStream_t st) {
  // 16-byte cp.async of every row, 4-byte stores of column pairs
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(out0) ||
      (kDKV && !aligned16(out1)))
    return cudaErrorMisalignedAddress;
  const int split = kDKV ? dkv_split(B, g) : 1;
  return mma_instance(g, [&](auto dmax) {
    constexpr int DM = decltype(dmax)::value;
    const auto kernel = flash_bwd_mma_kernel<DM, kDKV>;
    const size_t smem = mma_smem<DM, kDKV>();
    static const int attr = prepare(kernel, smem);
    if (attr) return attr;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = split;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = mma_grid<kDKV>(split, B, g);
    cfg.blockDim = dim3(kMmaThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const int err = static_cast<int>(cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta, prefix, valid,
        qoff, static_cast<bf16*>(out0), static_cast<bf16*>(out1), g));
    return err ? err : static_cast<int>(cudaGetLastError());
  });
}

constexpr int kFwdRows = kFwdWarps * 16;  // q rows of a forward block

template <int DMAX>
size_t fwd_mma_smem() {
  return sizeof(bf16) * (kFwdRows + 4 * kInner) * (DMAX + 8);
}

dim3 fwd_grid(int B, const Geometry& g) {
  return dim3((g.Tq + kFwdRows - 1) / kFwdRows, g.Nq, B);
}

int fwd_mma_launch(const void* q, const void* k, const void* v, const int* prefix,
                   const int* valid, const int* qoff, void* out, float* lse, int B,
                   const Geometry& g, cudaStream_t st) {
  // 16-byte cp.async of every row, 4-byte stores of column pairs
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  return mma_instance(g, [&](auto dmax) {
    constexpr int DM = decltype(dmax)::value;
    const auto kernel = flash_fwd_mma_kernel<DM>;
    const size_t smem = fwd_mma_smem<DM>();
    static const int attr = prepare(kernel, smem);
    if (attr) return attr;
    kernel<<<fwd_grid(B, g), kFwdWarps * 32, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        prefix, valid, qoff, static_cast<bf16*>(out), lse, g);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------- plans

// out[0..6]: grid x, y, z, threads a block, dynamic shared memory bytes,
// blocks an SM (the occupancy calculator's), blocks a cluster
template <typename K>
int fill_plan(K kernel, size_t smem_max, dim3 grid, int threads, size_t smem, int cluster,
              int* out) {
  if (prepare(kernel, smem_max)) return -2;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem)) return -2;
  const int v[7] = {static_cast<int>(grid.x), static_cast<int>(grid.y), static_cast<int>(grid.z),
                    threads, static_cast<int>(smem), blocks, cluster};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

template <bool kDKV>
int mma_plan(int B, const Geometry& g, int* out) {
  const int split = kDKV ? dkv_split(B, g) : 1;
  return mma_instance(g, [&](auto dmax) {
    constexpr int DM = decltype(dmax)::value;
    const size_t smem = mma_smem<DM, kDKV>();
    return fill_plan(flash_bwd_mma_kernel<DM, kDKV>, smem, mma_grid<kDKV>(split, B, g),
                     kMmaThreads, smem, split, out);
  });
}

template <typename T, int DMAX>
int fma_plan(bool dkv, int B, const Geometry& g, int* out) {
  if (dkv) {
    return fill_plan(flash_bwd_dkv_kernel<T, DMAX>, dkv_smem(DMAX),
                     dim3((g.Tk + kTile - 1) / kTile, g.Nkv, B), kThreads, dkv_smem(g.D), 1, out);
  }
  return fill_plan(flash_bwd_dq_kernel<T, DMAX>, dq_smem(DMAX),
                   dim3((g.Tq + kTile - 1) / kTile, g.Nq, B), kThreads, dq_smem(g.D), 1, out);
}

int fma_plan_of(int dtype, bool dkv, int B, const Geometry& g, int* out) {
  FLASH_DISPATCH(fma_plan, dkv, B, g, out);
}

// out[0..9]: grid x, y, z, threads a block, dynamic shared memory bytes,
// blocks an SM, blocks a cluster, q rows a block, registers a thread, local
// memory bytes a thread (spills)
template <typename K>
int fill_fwd_plan(K kernel, size_t smem_max, dim3 grid, int threads, size_t smem, int cluster,
                  int rows, int* out) {
  if (fill_plan(kernel, smem_max, grid, threads, smem, cluster, out)) return -2;
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel)) return -2;
  out[7] = rows;
  out[8] = a.numRegs;
  out[9] = static_cast<int>(a.localSizeBytes);
  return 0;
}

int fwd_mma_plan(int B, const Geometry& g, int* out) {
  return mma_instance(g, [&](auto dmax) {
    constexpr int DM = decltype(dmax)::value;
    const size_t smem = fwd_mma_smem<DM>();
    return fill_fwd_plan(flash_fwd_mma_kernel<DM>, smem, fwd_grid(B, g), kFwdWarps * 32, smem, 1,
                         kFwdRows, out);
  });
}

template <typename T, int DMAX>
int fwd_fma_plan(int B, const Geometry& g, int* out) {
  return fill_fwd_plan(flash_fwd_kernel<T, DMAX>, fwd_smem(DMAX),
                       dim3((g.Tq + kTile - 1) / kTile, g.Nq, B), kThreads, fwd_smem(g.D), 1,
                       kTile, out);
}

int fwd_fma_plan_of(int dtype, int B, const Geometry& g, int* out) {
  FLASH_DISPATCH(fwd_fma_plan, B, g, out);
}

}  // namespace

// bf16 on the tensor-core kernel, fp32 on the FMA kernel (route_of); a
// refused launch is returned, never retried on the other route
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* prefix,
                         const int* valid, const int* qoff, void* out, float* lse, int dtype,
                         int B, int Tq, int Tk, int Nq, int Nkv, int D, float scale, float cap,
                         int window, int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  const int route = route_of(dtype, D);
  if (bad_geometry(B, g) || route < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) return fwd_mma_launch(q, k, v, prefix, valid, qoff, out, lse, B, g, st);
  return fma_fwd(q, k, v, prefix, valid, qoff, out, lse, dtype, B, g, st);
}

// The route (kRouteFma 0, kRouteMma 1) that flash_fwd takes for these
// operands, -1 for operands it refuses; launches nothing
extern "C" int flash_fwd_route(int dtype, int D) { return route_of(dtype, D); }

// The FMA forward in either dtype: what bf16 calls took before the
// tensor-core kernel, kept so that the two can be timed side by side
// (chip_smoke.py); no wrapper of the training or serving path calls it
extern "C" int flash_fwd_fma(const void* q, const void* k, const void* v, const int* prefix,
                             const int* valid, const int* qoff, void* out, float* lse, int dtype,
                             int B, int Tq, int Tk, int Nq, int Nkv, int D, float scale, float cap,
                             int window, int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  if (bad_geometry(B, g)) return cudaErrorInvalidValue;
  return fma_fwd(q, k, v, prefix, valid, qoff, out, lse, dtype, B, g,
                 static_cast<cudaStream_t>(stream));
}

// What a forward call launches, without launching it: fma 0 for the
// wrapper's route, 1 for the FMA kernel of flash_fwd_fma. Fills out[0..9]
// (grid x, y, z, threads, dynamic shared bytes, blocks an SM, blocks a
// cluster, q rows a block, registers, local bytes a thread) and returns the
// route, or -1 for operands the kernels refuse, -2 for a CUDA error
extern "C" int flash_fwd_plan(int fma, int dtype, int B, int Tq, int Tk, int Nq, int Nkv, int D,
                              int* out) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, 1.f, 0.f, 0, 1};
  if (bad_geometry(B, g) || route_of(dtype, D) < 0) return -1;
  const int route = fma ? kRouteFma : route_of(dtype, D);
  const int err = route == kRouteMma ? fwd_mma_plan(B, g, out) : fwd_fma_plan_of(dtype, B, g, out);
  return err ? (err < 0 ? err : -2) : route;
}

// bf16 on the tensor-core kernel, fp32 on the FMA kernel (bwd_route); a
// refused launch is returned, never retried on the other route
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* prefix,
                            const int* valid, const int* qoff, void* dq, int dtype, int B, int Tq,
                            int Tk, int Nq, int Nkv, int D, float scale, float cap, int window,
                            int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  const int route = route_of(dtype, D);
  if (bad_geometry(B, g) || route < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) {
    return mma_launch<false>(q, k, v, dout, lse, delta, prefix, valid, qoff, dq, nullptr, B, g,
                             st);
  }
  return fma_dq(q, k, v, dout, lse, delta, prefix, valid, qoff, dq, dtype, B, g, st);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* prefix,
                             const int* valid, const int* qoff, void* dk, void* dv, int dtype,
                             int B, int Tq, int Tk, int Nq, int Nkv, int D, float scale, float cap,
                             int window, int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  const int route = route_of(dtype, D);
  if (bad_geometry(B, g) || route < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) {
    return mma_launch<true>(q, k, v, dout, lse, delta, prefix, valid, qoff, dk, dv, B, g, st);
  }
  return fma_dkv(q, k, v, dout, lse, delta, prefix, valid, qoff, dk, dv, dtype, B, g, st);
}

// The route (kRouteFma 0, kRouteMma 1) that flash_bwd_dq / flash_bwd_dkv
// take for these operands, -1 for operands they refuse; launches nothing
extern "C" int flash_bwd_route(int dtype, int D) { return route_of(dtype, D); }

// The FMA kernels in either dtype: dq where dq is not null, dk/dv where dk
// is not null. What bf16 calls took before the tensor-core route, kept so
// that the two can be timed side by side (chip_smoke.py); no wrapper of the
// training path calls it
extern "C" int flash_bwd_fma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* prefix,
                             const int* valid, const int* qoff, void* dq, void* dk, void* dv,
                             int dtype, int B, int Tq, int Tk, int Nq, int Nkv, int D, float scale,
                             float cap, int window, int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  if (bad_geometry(B, g)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dq) {
    const int err = fma_dq(q, k, v, dout, lse, delta, prefix, valid, qoff, dq, dtype, B, g, st);
    if (err) return err;
  }
  if (dk) return fma_dkv(q, k, v, dout, lse, delta, prefix, valid, qoff, dk, dv, dtype, B, g, st);
  return 0;
}

// What a backward call launches, without launching it: which 0 for dq, 1
// for dk/dv; fma 0 for the wrappers' route, 1 for the FMA kernels of
// flash_bwd_fma. Fills out[0..6] (grid x, y, z, threads, dynamic shared
// bytes, blocks an SM, blocks a cluster) and returns the route, or -1 for operands the kernels
// refuse, -2 for a CUDA error
extern "C" int flash_bwd_plan(int which, int fma, int dtype, int B, int Tq, int Tk, int Nq,
                              int Nkv, int D, int* out) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, 1.f, 0.f, 0, 1};
  const int route = fma ? kRouteFma : route_of(dtype, D);
  if (bad_geometry(B, g) || route_of(dtype, D) < 0 || (which != 0 && which != 1)) return -1;
  int err;
  if (route == kRouteMma) {
    err = which ? mma_plan<true>(B, g, out) : mma_plan<false>(B, g, out);
  } else {
    err = fma_plan_of(dtype, which == 1, B, g, out);
  }
  return err ? (err < 0 ? err : -2) : route;
}
