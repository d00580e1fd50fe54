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
// Design (translation of the TPU grid): one thread block per (q tile, head,
// batch row) -- (k tile, kv head, batch row) for dk/dv -- with the Pallas
// grid's sequential k (or q) axis as a loop inside the block. Each block
// reads its own prefix/valid/offset scalars, masks the ragged edge itself
// (rows past T load as zeros and are never stored) instead of padding q/k/v,
// and skips dead tiles by the rule of _dead_block (:327) at its own tile
// size. Masked logits are -1e30, not -inf (:36, :137): a row whose keys in a
// live tile are all masked gets p = exp(0) = 1 there, and its output is 0
// only when every tile is dead (:155), as in the Pallas kernel.
//
// What bounds it: arithmetic. At the training shapes (T = 320, D = 256) a
// head's q.k and p.v products are ~52 MFLOP each against ~0.3 MB of q/k/v,
// far above the card's ~295 operations per byte. This first version is a
// plain FMA kernel (fp32 CUDA cores, fp32 tiles in shared memory, 32 x 32
// tiles, 256 threads, each thread a 2 x 2 logit micro-tile and 2 rows x D/16
// output lanes). It takes fp32 or bf16 operands and accumulates in fp32;
// probabilities and ds are rounded to the operand dtype before their
// products, where the Pallas kernel casts them (:146, :381, :426, :436).
// Tensor cores (mma.sync / wgmma) and TMA are left for later work.
#include "common.cuh"

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

// _dead_block (flash_attention.py:327) for a kTile x kTile tile
__device__ __forceinline__ bool dead_tile(int q_start, int k_start, int prefix, int valid,
                                          const Geometry& g) {
  const int k_end = k_start + kTile - 1;
  bool dead = k_start >= valid;
  if (g.causal) dead = dead || (k_start > q_start + kTile - 1 && k_start >= prefix);
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
    if (dead_tile(qoff + q0, k0, prefix, valid, g)) continue;  // uniform over the block
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
    if (dead_tile(qoff + q0, k0, prefix, valid, g)) continue;
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
      if (dead_tile(qoff + q0, k0, prefix, valid, g)) continue;
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

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* prefix,
                         const int* valid, const int* qoff, void* out, float* lse, int dtype,
                         int B, int Tq, int Tk, int Nq, int Nkv, int D, float scale, float cap,
                         int window, int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  if (bad_geometry(B, g)) return cudaErrorInvalidValue;
  FLASH_DISPATCH(fwd_launch, q, k, v, prefix, valid, qoff, out, lse, B, g,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* prefix,
                            const int* valid, const int* qoff, void* dq, int dtype, int B, int Tq,
                            int Tk, int Nq, int Nkv, int D, float scale, float cap, int window,
                            int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  if (bad_geometry(B, g)) return cudaErrorInvalidValue;
  FLASH_DISPATCH(dq_launch, q, k, v, dout, lse, delta, prefix, valid, qoff, dq, B, g,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* prefix,
                             const int* valid, const int* qoff, void* dk, void* dv, int dtype,
                             int B, int Tq, int Tk, int Nq, int Nkv, int D, float scale, float cap,
                             int window, int causal, void* stream) {
  const Geometry g{Tq, Tk, Nq, Nkv, D, scale, cap, window, causal};
  if (bad_geometry(B, g)) return cudaErrorInvalidValue;
  FLASH_DISPATCH(dkv_launch, q, k, v, dout, lse, delta, prefix, valid, qoff, dk, dv, B, g,
                 static_cast<cudaStream_t>(stream));
}
