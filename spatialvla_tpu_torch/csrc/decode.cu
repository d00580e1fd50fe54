// The per-layer stages of one greedy decode step that are not matvecs:
// attention over the KV cache (with RoPE, the new token's self-logit and the
// tanh softcap), the post-norm + residual update, and the gated-GELU
// activation. Together with the int8 and int4 matvecs (q8_matvec.cu,
// q4_matvec.cu) they replace the
// whole-LM Pallas kernel spatialvla_tpu/ops/decode_step.py:fused_decode_step
// (_decode_kernel), launched per layer from a Python loop
// (spatialvla_tpu_torch/ops/decode_step.py).
//
// The bf16 rounding points follow decode_step.py:220-372 (the attention's
// probability aside, see decode_attention_kernel); each is marked `bf16r`
// below. Products that the reference writes as separate
// multiply and add use __fmul_rn / __fadd_rn so that nvcc does not contract
// them into an FMA with a different rounding.
#include "common.cuh"

namespace {

constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kAttnThreads = 128;

// decode_attention / decode_attention_kv8: flash-decoding over the KV cache.
// They replace the attention phase of the Pallas kernel
// spatialvla_tpu/ops/decode_step.py:_decode_kernel (:232-326).
//
// What bounds it: the valid cache bytes, 2 * pos * Nkv * D * 2 in bf16 and
// half that in int8 (1.1 MB at M = 1, pos = 270, Nkv = 4, D = 256: 0.33 us at
// 3.35 TB/s). At that size the time is latency: the launch and the chain of
// dependent steps of the slowest block (memory round trips, barriers, shuffle
// trees), so the design is about how many SMs take part and how long each
// block's chain is. The kernel it replaced ran one block per (row, kv head),
// 4 blocks at batch 1, with 2- or 1-byte scalar loads: 0.1054 ms (bf16) and
// 0.1469 ms (int8) on an H100 at M = 1, S = 278.
//
// The split: one block per (row m, kv head h, chunk c) of C consecutive cache
// slots. C comes from the wrapper (ops/decode_step.py:attention_chunk: 32,
// doubled while a (m, h) would have more than kMaxChunks chunks or the grid
// more than 512 blocks). The grid is sized from S, which the host knows,
// never from `position`, which lives on the card (the step is captured in
// CUDA graphs); a chunk wholly past position[m] exits at once, except chunk
// 0, which always runs: it writes k_new / v_new, and a row with an empty
// cache still gets its self term. Each block keeps all G query heads of its
// kv head in shared memory, so each K and V row is read once for the group.
//
// The loads: cache rows are read as 16-byte vectors, 8 bf16 or 16 int8 codes
// a thread. A sub-group of tpr lanes (the largest power of two <= D / 8 or
// D / 16, at most 32) covers one row, so at D = 256 a warp reads a bf16 row in
// one load per lane, or two int8 rows. Each sub-group keeps kRows rows in
// flight, and the first kRows rows of K and V are loaded at the kernel's
// start, beside the RoPE inputs, before `position` is known. For p @ V each
// lane owns the 8 or 16 output columns of its vector, sub-groups and warps
// split the chunk's slots, and their sums meet in a fixed order (xor
// shuffles, then warp by warp).
//
// The merge: each block leaves, per query head, its local max, its local sum
// of exp(l - local max) and its unnormalised (G, D) partial p @ V in fp32
// scratch. The last block of each (m, h) to finish merges them: it learns
// that it is last from an atomic ticket taken after a __threadfence(), and
// resets the ticket to 0 for the next launch, so the tickets are zeroed only
// when the scratch is allocated. One launch and no second kernel, because
// decode is host-bound at batch 1 and a launch costs more host time than the
// merge costs the card. The merger stages every chunk's max and sum in
// shared memory with one parallel load, and walks the partials in chunk
// order 0, 1, ..., kBatch chunks' loads in flight, whatever order the blocks
// finished in, so two runs give bit-identical output. A row whose valid
// slots fit in one chunk skips the scratch and merges in place.
//
// Scratch: M * Nkv * ceil(S / C) * G * (D + 2) floats of partials after
// M * Nkv tickets (74 KB at M = 1, S = 278, C = 32, G = 2, D = 256). Shared
// memory: (2 G D + 2 D + G C + 2 C + 3 G (1 + kMaxChunks)) floats, which
// depends on C and not on S (the kernel it replaced kept G S probabilities).
//
// Rounding: the reference rounds p = e / denom to bf16 with the global max
// (decode_step.py:302-316); here exp(l - local max) (times the V scale on an
// int8 cache) is rounded to bf16 before the rescale by exp(local max - global
// max) / denom. Both round the same quantity to bf16 once, at other scales;
// on the serving path's shapes the outputs differ from the plain version by
// 3-6e-3 of max|plain| (bf16 ulps of the output), inside the kernels'
// tolerance of 1e-2. The other bf16 rounding points are the reference's:
// RoPE on bf16 inputs with bf16-rounded cos and sin, q scaled then rounded,
// the tanh softcap on the logits, the new token's own logit and its bf16
// probability, k_new and v_new unquantized.
//
// KV = int8_t is the int8 cache of kv_bits=8 (decode_step.py:276-293,
// 313-316): the codes enter the dots exactly, the per-slot K scale
// multiplies each logit before the softcap, the per-slot V scale multiplies
// each probability before its bf16 rounding. ks / vs are this layer's scales
// in the flat (Nkv, 1, M * S) layout (decode_step.py:91-103): slot (m, t) of
// kv head h at h * M * S + m * S + t.
template <typename KV>
struct CacheVec;

template <>
struct CacheVec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4 u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // little endian: element 2j is the low half
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <>
struct CacheVec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4 u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {  // sign-extend byte b of word j
        v[4 * j + b] = static_cast<float>(static_cast<int>(w[j] << (24 - 8 * b)) >> 24);
      }
    }
  }
};

template <typename KV>
__device__ __forceinline__ uint4 load_vec(const KV* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float softcap(float v, float cap) {
  return cap > 0.f ? tanhf(v / cap) * cap : v;
}

constexpr int kRows = 8;        // cache rows a sub-group has in flight at once
constexpr int kMaxChunks = 64;  // chunks of one (m, h): their statistics fit in shared memory
constexpr int kBatch = 4;       // chunks whose partials a merging thread has in flight

// GM: the register arrays' size for G (the launcher picks 1, 2, 4 or 8 >= G)
template <typename KV, int GM>
__global__ void __launch_bounds__(kAttnThreads) decode_attention_kernel(
    const bf16* __restrict__ qkv,    // (M, (Nq + 2 Nkv) D) bf16 qkv projection
    const float* __restrict__ cos_t, // (M, D) fp32 RoPE tables
    const float* __restrict__ sin_t,
    const KV* __restrict__ ck,       // (M, Nkv, S, D) this layer's cache
    const KV* __restrict__ cv,
    const float* __restrict__ ks,    // (Nkv, 1, M S) per-slot scales (int8 cache only)
    const float* __restrict__ vs,
    const int* __restrict__ position,  // (M,) valid cache slots [0, position)
    bf16* __restrict__ attn_out,     // (M, Nq D)
    bf16* __restrict__ k_new,        // (M, Nkv, D)
    bf16* __restrict__ v_new,
    float* __restrict__ part,        // (M Nkv, nch, G (D + 2)) partials
    unsigned* __restrict__ tickets,  // (M Nkv,) zero between launches
    int M, int Nq, int Nkv, int D, int S, int C, float q_scale, float cap) {
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int VE = CacheVec<KV>::N;
  constexpr int kWarps = kAttnThreads / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  const int G = Nq / Nkv;
  const int nch = (S + C - 1) / C;
  const int c = blockIdx.x % nch, mh = blockIdx.x / nch;  // mh = m * Nkv + h
  const int m = mh / Nkv, h = mh % Nkv;
  const int pos = min(max(position[m], 0), S);

  float* q16 = smem;               // (G, D) roped, scaled, bf16-rounded queries
  float* own = q16 + G * D;        // this chunk's partial: max (G), sum (G), p @ V (G, D)
  float* ob = own + 2 * G;
  float* lg = own + G * (D + 2);   // (G, C) logits -> bf16 probabilities
  float* kvn = lg + G * C;         // (2, D) the new token's roped k (bf16-rounded) and v
  float* fin = kvn + 2 * D;        // (3, G) merged max, denominator, self logit
  float* cst = fin + 3 * G;        // (kMaxChunks, 2 G) each chunk's max and sum, for the merge
  float* wts = cst + 2 * kMaxChunks * G;  // (kMaxChunks, G) merge weights
  float* ksc = wts + kMaxChunks * G;  // (2, C) the chunk's K and V scales (int8 cache)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = D >> 1;
  const long scale0 = ((long)h * M + m) * S;  // slot (m, 0) in the flat scales

  // a sub-group of tpr lanes per cache slot, each lane one 16-byte vector
  // (v = j, j + tpr, ...) of the row; the block covers rpp slots a pass
  const int nvec = D / VE;
  int tpr = 32;
  while (tpr > nvec) tpr >>= 1;
  const int spw = 32 / tpr, sub = lane / tpr, j = lane % tpr;
  const int rpp = kWarps * spw;         // slots per pass of the block
  const int first = warp * spw + sub;   // this sub-group's first slot
  const int t0 = c * C, rows = min(C, S - t0);
  const KV* K = ck + ((long)mh * S + t0) * D;
  const KV* V = cv + ((long)mh * S + t0) * D;
  // the first kRows slots' vectors j of K and V, loaded before `pos` and the
  // queries are known (slots past `pos` are read and not used), so that
  // these loads and those of the RoPE below are in flight together
  uint4 kpre[kRows], vpre[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = first + k * rpp;
    if (r < rows) {
      kpre[k] = load_vec(K + (long)r * D + j * VE);
      vpre[k] = load_vec(V + (long)r * D + j * VE);
    }
  }
  const bf16* row = qkv + (long)m * (Nq + 2 * Nkv) * D;
  // RoPE (half rotation) with bf16-rounded fp32 cos/sin, on bf16 inputs;
  // issued before `pos` is known, so both loads are in flight together
  auto rope = [&](const bf16* v, int d) {
    const float cs = bf16r(cos_t[(long)m * D + d]), sn = bf16r(sin_t[(long)m * D + d]);
    const float x = __bfloat162float(v[d]);
    const float r = d < half ? -__bfloat162float(v[d + half]) : __bfloat162float(v[d - half]);
    return __fadd_rn(__fmul_rn(x, cs), __fmul_rn(r, sn));
  };
#pragma unroll 4
  for (int i = tid; i < G * D; i += kAttnThreads) {
    const int g = i / D;
    q16[i] = bf16r(__fmul_rn(rope(row + (long)(h * G + g) * D, i - g * D), q_scale));
  }
  if (kQuant) {
    for (int r = tid; r < rows; r += kAttnThreads) {
      ksc[r] = ks[scale0 + t0 + r];
      ksc[C + r] = vs[scale0 + t0 + r];
    }
  }
  const bf16* krow = row + (long)Nq * D + h * D;
  const bf16* vrow = row + (long)(Nq + Nkv) * D + h * D;
#pragma unroll 2
  for (int d = tid; d < D; d += kAttnThreads) {
    const float kn = rope(krow, d);
    kvn[d] = bf16r(kn);
    kvn[D + d] = __bfloat162float(vrow[d]);
    if (c == 0) {  // chunk 0 always runs: it writes the new token's k and v
      k_new[(long)mh * D + d] = __float2bfloat16(kn);
      v_new[(long)mh * D + d] = vrow[d];
    }
  }
  const int nlive = max(1, (pos + C - 1) / C);  // chunks holding valid slots (chunk 0 always)
  if (c >= nlive) return;
  __syncthreads();

  // logits of this chunk's valid slots, kRows slots in flight
  const int nt = max(0, min(t0 + C, pos) - t0);
  for (int k0 = 0; k0 * rpp < nt; k0 += kRows) {  // uniform in the block
    float acc[kRows][GM];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
      for (int g = 0; g < GM; ++g) acc[k][g] = 0.f;
    }
    for (int v = j; v < nvec; v += tpr) {
      uint4 raw[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = first + (k0 + k) * rpp;
        if (k0 == 0 && v == j) {
          raw[k] = kpre[k];
        } else if (r < nt) {
          raw[k] = load_vec(K + (long)r * D + v * VE);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (first + (k0 + k) * rpp < nt) {
          float kv[VE];
          CacheVec<KV>::unpack(raw[k], kv);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
              const float4* q4 = reinterpret_cast<const float4*>(q16 + g * D + v * VE);
#pragma unroll
              for (int e = 0; e < VE / 4; ++e) {
                const float4 q = q4[e];
                acc[k][g] = fmaf(q.x, kv[4 * e], acc[k][g]);
                acc[k][g] = fmaf(q.y, kv[4 * e + 1], acc[k][g]);
                acc[k][g] = fmaf(q.z, kv[4 * e + 2], acc[k][g]);
                acc[k][g] = fmaf(q.w, kv[4 * e + 3], acc[k][g]);
              }
            }
          }
        }
      }
    }
    // sums over the sub-group, the kRows x GM chains interleaved
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < tpr) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
#pragma unroll
          for (int g = 0; g < GM; ++g) acc[k][g] += __shfl_xor_sync(0xffffffffu, acc[k][g], o);
        }
      }
    }
    // every lane of the sub-group holds every sum: lane j finishes values
    // j, j + tpr, ... (slot k, head g = value / GM, value % GM), so the
    // scale and the softcap run on all lanes at once
    for (int x = j; x < kRows * GM; x += tpr) {
      float val = 0.f;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
#pragma unroll
        for (int g = 0; g < GM; ++g) val = x == k * GM + g ? acc[k][g] : val;
      }
      const int g = x % GM, r = first + (k0 + x / GM) * rpp;
      if (g < G && r < nt) lg[g * C + r] = softcap(kQuant ? val * ksc[r] : val, cap);
    }
  }
  __syncthreads();

  // a warp per query head: the local softmax statistics, the probabilities
  // rounded to bf16 relative to the local max (times the V scale on an int8
  // cache), and the new token's own logit
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int r = lane; r < nt; r += 32) mx = fmaxf(mx, lg[g * C + r]);
    mx = warp_max(mx);
    float se = 0.f;
    for (int r = lane; r < nt; r += 32) {
      const float e = expf(lg[g * C + r] - mx);
      se += e;
      lg[g * C + r] = bf16r(kQuant ? e * ksc[C + r] : e);
    }
    se = warp_sum(se);
    float sl = 0.f;
    for (int d = lane; d < D; d += 32) sl += q16[g * D + d] * kvn[d];
    sl = warp_sum(sl);
    if (lane == 0) {
      own[g] = mx;  // -inf and 0 for a chunk with no valid slot
      own[G + g] = se;
      fin[2 * G + g] = softcap(sl, cap);
    }
  }
  __syncthreads();

  // p @ V: each lane owns the VE columns of vector v; sub-groups and warps
  // split the slots, kRows in flight, and their sums meet in a fixed order
  for (int v0 = 0; v0 < nvec; v0 += tpr) {
    const int v = v0 + j;
    float o[GM][VE];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < VE; ++e) o[g][e] = 0.f;
    }
    if (v < nvec) {
      for (int k0 = 0; k0 * rpp < nt; k0 += kRows) {
        uint4 raw[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int r = first + (k0 + k) * rpp;
          if (k0 == 0 && v0 == 0) {
            raw[k] = vpre[k];
          } else if (r < nt) {
            raw[k] = load_vec(V + (long)r * D + v * VE);
          }
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int r = first + (k0 + k) * rpp;
          if (r < nt) {
            float vv[VE];
            CacheVec<KV>::unpack(raw[k], vv);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
              if (g < G) {
                const float p = lg[g * C + r];
#pragma unroll
                for (int e = 0; e < VE; ++e) o[g][e] = fmaf(p, vv[e], o[g][e]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // sum over the sub-groups: same columns
      if (off >= tpr) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
#pragma unroll
          for (int e = 0; e < VE; ++e) o[g][e] += __shfl_xor_sync(0xffffffffu, o[g][e], off);
        }
      }
    }
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w && sub == 0 && v < nvec) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VE; ++e) {
              float* dst = ob + g * D + v * VE + e;
              *dst = w == 0 ? o[g][e] : *dst + o[g][e];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // hand the partial over; the last block of (m, h) merges
  const long stride = (long)G * (D + 2);
  if (nlive > 1) {
    float* mine = part + ((long)mh * nch + c) * stride;
    for (int i = tid; i < stride; i += kAttnThreads) mine[i] = own[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const unsigned prev = atomicAdd(tickets + mh, 1u);
      is_last = prev == static_cast<unsigned>(nlive - 1);
      if (is_last) atomicExch(tickets + mh, 0u);  // every other block has taken its ticket
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }
  const float* parts = part + (long)mh * nch * stride;

  // The merge. Each thread owns elements i = base + k * kAttnThreads + tid
  // of the (G, D) output; its partials' loads go out before anything waits:
  // the first kBatch chunks' now, together with every chunk's max and sum
  // into shared memory.
  float x[kBatch][4];
  auto load_batch = [&](int base, int t) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = base + k * kAttnThreads + tid;
        x[u][k] = t + u < nlive && i < G * D
                      ? __ldcg(parts + (long)(t + u) * stride + 2 * G + i) : 0.f;
      }
    }
  };
  if (nlive > 1) load_batch(0, 0);
  for (int q = tid; q < nlive * 2 * G; q += kAttnThreads) {
    cst[q] = nlive == 1 ? own[q] : __ldcg(parts + (long)(q / (2 * G)) * stride + q % (2 * G));
  }
  __syncthreads();
  // a thread per query head: the global max (the self logit included), the
  // chunk weights exp(max_c - max) and the denominator, in chunk order
  if (tid < G) {
    const float sl = fin[2 * G + tid];
    float mx = sl;
    for (int cc = 0; cc < nlive; ++cc) mx = fmaxf(mx, cst[cc * 2 * G + tid]);
    float den = 0.f;
    for (int cc = 0; cc < nlive; ++cc) {
      const float w = expf(cst[cc * 2 * G + tid] - mx);
      wts[cc * G + tid] = w;
      den += cst[cc * 2 * G + G + tid] * w;
    }
    fin[tid] = mx;
    fin[G + tid] = den + expf(sl - mx);
  }
  __syncthreads();
  // out = sum_c w_c (p @ V)_c / denom + bf16(e_self / denom) v_new
  for (int base = 0; base < G * D; base += 4 * kAttnThreads) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (nlive == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = base + k * kAttnThreads + tid;
        if (i < G * D) a[k] = wts[i / D] * ob[i];
      }
    } else {
      for (int t = 0; t < nlive; t += kBatch) {
        if (base > 0 || t > 0) load_batch(base, t);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = base + k * kAttnThreads + tid;
            if (t + u < nlive && i < G * D) a[k] = fmaf(wts[(t + u) * G + i / D], x[u][k], a[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kAttnThreads + tid;
      if (i < G * D) {
        const int g = i / D, d = i - g * D;
        const float mx = fin[g], den = fin[G + g];
        const float ps = bf16r(expf(fin[2 * G + g] - mx) / den);
        attn_out[(long)m * Nq * D + (long)(h * G + g) * D + d] =
            __float2bfloat16(__fadd_rn(a[k] / den, __fmul_rn(ps, kvn[D + d])));
      }
    }
  }
}

// norm_residual: h = bf16(bf16(h) + bf16(rms(upd) * (1 + w))) in place; with
// `final_w` also out = bf16(rms(h) * (1 + final_w)), the next norm's x' (the
// final norm, or above 4 rows the input of the plain matvec that follows:
// ops/decode_step.py). The residual phases of the Pallas decode kernel
// (decode_step.py:_post_attn, _post_ffn, :335-340, 364) with their rounding
// points.
//
// What bounds it: one launch and the latency of its row, not its bytes (14
// KB a row at H = 2304, 0.004 us at 3.35 TB/s). So every value is loaded
// once, in one round: a block a row, thread t holds columns [8t, 8t + 8) in
// registers (upd by one 16-byte load, h by two, each norm weight by one or
// two), and the two sums of squares are warp shuffles and one round through
// shared memory each, added in warp order (the same on every launch). h' is
// written once and the normed output computed from registers. One chunk of 8
// columns a thread: H a multiple of 8 up to 8 * kNormMaxThreads = 8192
// (Gemma2's 2304, 3584 and 4608 take 288, 448 and 576 threads); the entry
// point refuses other widths.
constexpr int kNormMaxThreads = 1024;

// 8 consecutive values from `off` (16-byte aligned), f32 or bf16
__device__ __forceinline__ void load8(const void* p, int dtype, long off, float (&v)[8]) {
  if (dtype == DT_F32) {
    const float4* q = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + off);
    const float4 a = __ldg(q), b = __ldg(q + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(p) + off));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // little endian: element 2j is the low half
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__global__ void __launch_bounds__(kNormMaxThreads)
norm_residual_kernel(float* __restrict__ h, const bf16* __restrict__ upd,
                     const void* __restrict__ w, int w_dtype, const void* __restrict__ final_w,
                     int final_dtype, bf16* __restrict__ out, int H, float eps) {
  __shared__ float red[2][kNormMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long row = static_cast<long>(blockIdx.x) * H, col = 8L * threadIdx.x;
  const bool live = col < H;  // the last warp's lanes past H hold nothing
  float4* hr = reinterpret_cast<float4*>(h + row + col);
  float u[8], hv[8], wv[8], fv[8];
  float ss = 0.f;
  if (live) {  // every load of the launch, issued together
    load8(upd, DT_BF16, row + col, u);
    const float4 a = hr[0], b = hr[1];  // h is written below: no read-only path
    hv[0] = a.x, hv[1] = a.y, hv[2] = a.z, hv[3] = a.w;
    hv[4] = b.x, hv[5] = b.y, hv[6] = b.z, hv[7] = b.w;
    load8(w, w_dtype, col, wv);
    if (final_w != nullptr) load8(final_w, final_dtype, col, fv);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += u[j] * u[j];
  }
  // the block's sum of v, the same on every thread: warp shuffles, then the
  // warps' sums in warp order
  const auto block_total = [&](float v, float* r) {
    v = warp_sum(v);
    if (lane == 0) r[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += r[i];
    return s;
  };
  const float ru = rsqrtf(block_total(ss, red[0]) / static_cast<float>(H) + eps);
  float ss2 = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hv[j] = bf16r(bf16r(hv[j]) + bf16r((u[j] * ru) * (1.f + wv[j])));
      ss2 += hv[j] * hv[j];
    }
    hr[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
    hr[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
  }
  if (final_w == nullptr) return;  // the same for the whole block
  const float rh = rsqrtf(block_total(ss2, red[1]) / static_cast<float>(H) + eps);
  if (live) {
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (hv[j] * rh) * (1.f + fv[j]);
    unsigned p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // element 2j in the low half
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
      p[j] = *reinterpret_cast<const unsigned*>(&b2);
    }
    *reinterpret_cast<uint4*>(out + row + col) = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// act = bf16(bf16(gelu_tanh(gate)) * up) from the fused (M, 2I) gate|up output.
// Elementwise and bound by its 3 * M * I * 2 bytes. The decode step launches
// it only where the gate|up matvec's kernel refuses the weight
// (quant.gelu_route); elsewhere that kernel's epilogue computes the same bits
// (q8_matvec.cu, kGelu).
__global__ void gelu_mul_kernel(const bf16* __restrict__ gu, bf16* __restrict__ act, int M, int I) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * I) return;
  const long m = i / I, j = i % I;
  act[i] = __float2bfloat16(gelu_mul_value(__bfloat162float(gu[m * 2 * I + j]),
                                           __bfloat162float(gu[m * 2 * I + I + j])));
}

template <typename KV, int GM>
int launch_attention_g(const void* qkv, const float* cos_t, const float* sin_t, const void* ck,
                       const void* cv, const float* ks, const float* vs, const int* position,
                       void* attn_out, void* k_new, void* v_new, float* part, unsigned* tickets,
                       int M, int Nq, int Nkv, int D, int S, int C, float q_scale, float cap,
                       void* stream) {
  const int G = Nq / Nkv;
  const size_t smem = (static_cast<size_t>(G) * (2 * D + 2) + static_cast<size_t>(G) * C +
                       2 * static_cast<size_t>(D) + static_cast<size_t>(G) * (3 + 3 * kMaxChunks) +
                       2 * static_cast<size_t>(C)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<KV, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long blocks = static_cast<long>(M) * Nkv * ((S + C - 1) / C);
  decode_attention_kernel<KV, GM><<<static_cast<unsigned>(blocks), kAttnThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), cos_t, sin_t, static_cast<const KV*>(ck),
      static_cast<const KV*>(cv), ks, vs, position, static_cast<bf16*>(attn_out),
      static_cast<bf16*>(k_new), static_cast<bf16*>(v_new), part, tickets, M, Nq, Nkv, D, S, C,
      q_scale, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch_attention(const void* qkv, const float* cos_t, const float* sin_t, const void* ck,
                     const void* cv, const float* ks, const float* vs, const int* position,
                     void* attn_out, void* k_new, void* v_new, float* part, unsigned* tickets,
                     int M, int Nq, int Nkv, int D, int S, int C, float q_scale, float cap,
                     void* stream) {
  if (M < 1 || Nkv < 1 || Nq % Nkv != 0 || Nq / Nkv > kMaxG || D % 32 != 0 || D > 1024 ||
      S < 1 || C < 1 || C > 1024 || (S + C - 1) / C > kMaxChunks)
    return cudaErrorInvalidValue;
  const int G = Nq / Nkv;
#define SPATIALVLA_ATTN(GM)                                                                   \
  return launch_attention_g<KV, GM>(qkv, cos_t, sin_t, ck, cv, ks, vs, position, attn_out,    \
                                    k_new, v_new, part, tickets, M, Nq, Nkv, D, S, C, q_scale, \
                                    cap, stream)
  if (G == 1) SPATIALVLA_ATTN(1);
  if (G == 2) SPATIALVLA_ATTN(2);
  if (G <= 4) SPATIALVLA_ATTN(4);
  SPATIALVLA_ATTN(8);
#undef SPATIALVLA_ATTN
}

}  // namespace

// part / tickets: the scratch of ops/decode_step.py:attention_scratch (the
// tickets zero when it is allocated; each launch leaves them zero)
extern "C" int decode_attention(const void* qkv, const float* cos_t, const float* sin_t,
                                const void* ck, const void* cv, const int* position,
                                void* attn_out, void* k_new, void* v_new, float* part,
                                unsigned* tickets, int M, int Nq, int Nkv, int D, int S, int C,
                                float q_scale, float cap, void* stream) {
  return launch_attention<bf16>(qkv, cos_t, sin_t, ck, cv, nullptr, nullptr, position, attn_out,
                                k_new, v_new, part, tickets, M, Nq, Nkv, D, S, C, q_scale, cap,
                                stream);
}

extern "C" int decode_attention_kv8(const void* qkv, const float* cos_t, const float* sin_t,
                                    const void* ck, const void* cv, const float* ks,
                                    const float* vs, const int* position, void* attn_out,
                                    void* k_new, void* v_new, float* part, unsigned* tickets,
                                    int M, int Nq, int Nkv, int D, int S, int C, float q_scale,
                                    float cap, void* stream) {
  return launch_attention<int8_t>(qkv, cos_t, sin_t, ck, cv, ks, vs, position, attn_out, k_new,
                                  v_new, part, tickets, M, Nq, Nkv, D, S, C, q_scale, cap,
                                  stream);
}

// h, upd, w, final_w and out 16-byte aligned, H a multiple of 8 up to 8192
// (norm_residual_kernel holds a row in registers, 8 columns a thread)
extern "C" int norm_residual(float* h, const void* upd, const void* w, int w_dtype,
                             const void* final_w, int final_dtype, void* out, int M, int H,
                             float eps, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || H < 8 || H % 8 != 0 || H > 8 * kNormMaxThreads || misaligned(h) ||
      misaligned(upd) || misaligned(w) || (final_w && (misaligned(final_w) || misaligned(out))))
    return cudaErrorInvalidValue;
  const int threads = (H / 8 + 31) / 32 * 32;
  norm_residual_kernel<<<M, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, static_cast<const bf16*>(upd), w, w_dtype, final_w, final_dtype,
      static_cast<bf16*>(out), H, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gelu_mul(const void* gu, void* act, int M, int I, void* stream) {
  if (M < 1 || I < 1) return cudaErrorInvalidValue;
  const long n = static_cast<long>(M) * I;
  const int threads = 256;
  gelu_mul_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(gu),
                                                         static_cast<bf16*>(act), M, I);
  return static_cast<int>(cudaGetLastError());
}
