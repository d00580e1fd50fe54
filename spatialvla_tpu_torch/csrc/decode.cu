// The per-layer stages of one greedy decode step that are not matvecs:
// attention over the KV cache (with RoPE, the new token's self-logit and the
// tanh softcap), the post-norm + residual update, and the gated-GELU
// activation. Together with the int8 and int4 matvecs (q8_matvec.cu,
// q4_matvec.cu) they replace the
// whole-LM Pallas kernel spatialvla_tpu/ops/decode_step.py:fused_decode_step
// (_decode_kernel), launched per layer from a Python loop
// (spatialvla_tpu_torch/ops/decode_step.py).
//
// The bf16 rounding points follow decode_step.py:220-372 exactly; each is
// marked `bf16r` below. Products that the reference writes as separate
// multiply and add use __fmul_rn / __fadd_rn so that nvcc does not contract
// them into an FMA with a different rounding.
#include "common.cuh"

namespace {

constexpr int kMaxG = 8;  // query heads per kv head

// What bounds it: reading the cache rows of one (row, kv head), about
// 2 * S * D * 2 bytes in bf16 (285 KB at S = 278, D = 256), half that in
// int8. One block per (row m, kv head h) keeps the G query heads of the group
// in shared memory so each K and V row is read once for all of them; warps
// sweep the key slots for the logits, and each thread owns one of the D
// output lanes for p @ V so the V rows are read coalesced. At batch 1 that is
// only Nkv = 4 blocks, so the cache read runs on 4 SMs; splitting the key
// range across blocks (flash-decoding) is left for later work.
//
// KV = int8_t is the int8 cache of kv_bits=8 (decode_step.py:276-293,
// 313-316): the codes enter the dots exactly, the per-slot K scale
// multiplies each logit before the softcap, the per-slot V scale multiplies
// each probability before its bf16 rounding, and the new token's own k and v
// stay unquantized. ks / vs are this layer's scales in the flat
// (Nkv, 1, M * S) layout (decode_step.py:91-103): slot (m, t) of kv head h
// at h * M * S + m * S + t.
__device__ __forceinline__ float kv_value(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float kv_value(int8_t v) { return static_cast<float>(v); }

template <typename KV>
__global__ void decode_attention_kernel(
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
    int Nq, int Nkv, int D, int S, float q_scale, float cap) {
  extern __shared__ float smem[];
  constexpr bool kQuant = sizeof(KV) == 1;
  const int G = Nq / Nkv;
  float* q16 = smem;             // (G, D) roped, scaled, bf16-rounded queries
  float* prob = q16 + G * D;     // (G, S) logits -> exp -> bf16 probabilities
  float* red = prob + G * S;     // 32 floats of reduction scratch

  const int m = blockIdx.x / Nkv, h = blockIdx.x % Nkv;
  const long scale0 = ((long)h * gridDim.x / Nkv + m) * S;  // slot (m, 0) in the flat scales
  const int d = threadIdx.x, half = D >> 1;
  const int lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  const bf16* row = qkv + (long)m * (Nq + 2 * Nkv) * D;
  const int pos = min(max(position[m], 0), S);

  // RoPE (half rotation) with bf16-rounded fp32 cos/sin, on bf16 inputs
  const float c = bf16r(cos_t[(long)m * D + d]), s = bf16r(sin_t[(long)m * D + d]);
  auto rope = [&](const bf16* v) {
    const float x = __bfloat162float(v[d]);
    const float r = d < half ? -__bfloat162float(v[d + half]) : __bfloat162float(v[d - half]);
    return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
  };
  const bf16* krow = row + (long)Nq * D + h * D;
  const bf16* vrow = row + (long)(Nq + Nkv) * D + h * D;
  const float kn = rope(krow);
  const long kvo = ((long)m * Nkv + h) * D + d;
  k_new[kvo] = __float2bfloat16(kn);
  v_new[kvo] = vrow[d];
  const float k16 = bf16r(kn);
  const float vn = __bfloat162float(vrow[d]);
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) q16[g * D + d] = bf16r(__fmul_rn(rope(row + (long)(h * G + g) * D), q_scale));
  }
  __syncthreads();

  // the new token's own logit (it is not in the cache yet)
  float self_l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float v = block_sum(q16[g * D + d] * k16, red);
      self_l[g] = cap > 0.f ? tanhf(v / cap) * cap : v;
    }
  }

  // logits over the valid cache slots: one warp per slot, all G heads
  const KV* K = ck + ((long)m * Nkv + h) * S * D;
  for (int t = warp; t < pos; t += nwarps) {
    const KV* kr = K + (long)t * D;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int e = lane; e < D; e += 32) {
      const float kv = kv_value(kr[e]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) acc[g] = fmaf(q16[g * D + e], kv, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float v = warp_sum(acc[g]);
        if (kQuant) v *= ks[scale0 + t];
        if (lane == 0) prob[g * S + t] = cap > 0.f ? tanhf(v / cap) * cap : v;
      }
    }
  }
  __syncthreads();

  // fp32 softmax over [cache slots | self]; masked slots contribute exp(-1e30 - mx) == 0
  float denom[kMaxG], e_self[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float lm = -1e30f;
      for (int t = d; t < pos; t += blockDim.x) lm = fmaxf(lm, prob[g * S + t]);
      const float mx = fmaxf(block_max(lm, red), self_l[g]);
      float se = 0.f;
      for (int t = d; t < pos; t += blockDim.x) {
        const float e = expf(prob[g * S + t] - mx);
        prob[g * S + t] = e;
        se += e;
      }
      e_self[g] = expf(self_l[g] - mx);
      denom[g] = block_sum(se, red) + e_self[g];
      for (int t = d; t < pos; t += blockDim.x) {
        const float p = prob[g * S + t] / denom[g];
        prob[g * S + t] = bf16r(kQuant ? p * vs[scale0 + t] : p);
      }
    }
  }
  __syncthreads();

  // p @ V with bf16 probabilities, fp32 accumulation, plus the self term
  const KV* V = cv + ((long)m * Nkv + h) * S * D;
  float o[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) o[g] = 0.f;
  for (int t = 0; t < pos; ++t) {
    const float vv = kv_value(V[(long)t * D + d]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) o[g] = fmaf(prob[g * S + t], vv, o[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float ps = bf16r(e_self[g] / denom[g]);
      attn_out[(long)m * Nq * D + (long)(h * G + g) * D + d] =
          __float2bfloat16(__fadd_rn(o[g], __fmul_rn(ps, vn)));
    }
  }
}

// h = bf16(bf16(h) + bf16(rms(upd) * (1 + w))) in place, one block per row;
// with `final_w` also out = bf16(rms(h) * (1 + final_w)) (the final norm).
// Bound by the few KB of its row; it exists to keep the residual stream
// on the card between the matvecs.
__global__ void norm_residual_kernel(float* __restrict__ h, const bf16* __restrict__ upd,
                                     const void* __restrict__ w, int w_dtype,
                                     const void* __restrict__ final_w, int final_dtype,
                                     bf16* __restrict__ out, int H, float eps) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  float* hr = h + (long)m * H;
  const bf16* ur = upd + (long)m * H;
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    const float u = __bfloat162float(ur[k]);
    ss += u * u;
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(H) + eps);
  float ss2 = 0.f;
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    const float u = __bfloat162float(ur[k]);
    const float up = bf16r((u * r) * (1.f + load_any(w, w_dtype, k)));
    const float hn = bf16r(bf16r(hr[k]) + up);
    hr[k] = hn;
    ss2 += hn * hn;
  }
  if (final_w != nullptr) {
    const float r2 = rsqrtf(block_sum(ss2, red) / static_cast<float>(H) + eps);
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      out[(long)m * H + k] =
          __float2bfloat16((hr[k] * r2) * (1.f + load_any(final_w, final_dtype, k)));
    }
  }
}

// act = bf16(bf16(gelu_tanh(gate)) * up) from the fused (M, 2I) gate|up output.
// Elementwise and bound by its 3 * M * I * 2 bytes.
__global__ void gelu_mul_kernel(const bf16* __restrict__ gu, bf16* __restrict__ act, int M, int I) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * I) return;
  const long m = i / I, j = i % I;
  const float g = __bfloat162float(gu[m * 2 * I + j]);
  const float u = __bfloat162float(gu[m * 2 * I + I + j]);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(g, __fmul_rn(0.044715f, g * g * g)));
  const float a = bf16r(g * (0.5f * (1.f + tanhf(inner))));
  act[i] = __float2bfloat16(a * u);
}

template <typename KV>
int launch_attention(const void* qkv, const float* cos_t, const float* sin_t, const void* ck,
                     const void* cv, const float* ks, const float* vs, const int* position,
                     void* attn_out, void* k_new, void* v_new, int M, int Nq, int Nkv, int D,
                     int S, float q_scale, float cap, void* stream) {
  if (M < 1 || Nkv < 1 || Nq % Nkv != 0 || Nq / Nkv > kMaxG || D % 32 != 0 || D > 1024 ||
      D % 2 != 0 || S < 1)
    return cudaErrorInvalidValue;
  const int G = Nq / Nkv;
  const size_t smem = (static_cast<size_t>(G) * D + static_cast<size_t>(G) * S + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<KV><<<M * Nkv, D, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), cos_t, sin_t, static_cast<const KV*>(ck),
      static_cast<const KV*>(cv), ks, vs, position, static_cast<bf16*>(attn_out),
      static_cast<bf16*>(k_new), static_cast<bf16*>(v_new), Nq, Nkv, D, S, q_scale, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention(const void* qkv, const float* cos_t, const float* sin_t,
                                const void* ck, const void* cv, const int* position,
                                void* attn_out, void* k_new, void* v_new, int M, int Nq,
                                int Nkv, int D, int S, float q_scale, float cap, void* stream) {
  return launch_attention<bf16>(qkv, cos_t, sin_t, ck, cv, nullptr, nullptr, position, attn_out,
                                k_new, v_new, M, Nq, Nkv, D, S, q_scale, cap, stream);
}

extern "C" int decode_attention_kv8(const void* qkv, const float* cos_t, const float* sin_t,
                                    const void* ck, const void* cv, const float* ks,
                                    const float* vs, const int* position, void* attn_out,
                                    void* k_new, void* v_new, int M, int Nq, int Nkv, int D, int S,
                                    float q_scale, float cap, void* stream) {
  return launch_attention<int8_t>(qkv, cos_t, sin_t, ck, cv, ks, vs, position, attn_out, k_new,
                                  v_new, M, Nq, Nkv, D, S, q_scale, cap, stream);
}

extern "C" int norm_residual(float* h, const void* upd, const void* w, int w_dtype,
                             const void* final_w, int final_dtype, void* out, int M, int H,
                             float eps, void* stream) {
  if (M < 1 || H < 1) return cudaErrorInvalidValue;
  norm_residual_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
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
