// Shared device helpers for the hand-written Hopper kernels of the port.
//
// Every entry point has a plain C interface (loaded with ctypes), launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError() so
// that a refused launch surfaces in the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// dtype codes passed from Python (ops/_lib.py)
enum { DT_F32 = 0, DT_BF16 = 1 };

// round an fp32 value to bf16 (nearest-even) and widen it back: the
// `.astype(bfloat16).astype(float32)` rounding points of the JAX kernels
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float load_any(const void* p, int dtype, long i) {
  return dtype == DT_F32 ? reinterpret_cast<const float*>(p)[i]
                         : __bfloat162float(reinterpret_cast<const bf16*>(p)[i]);
}

__device__ __forceinline__ void store_any(void* p, int dtype, long i, float v) {
  if (dtype == DT_F32) {
    reinterpret_cast<float*>(p)[i] = v;
  } else {
    reinterpret_cast<bf16*>(p)[i] = __float2bfloat16(v);
  }
}

// 16 consecutive activations starting at element `off` (16-byte aligned)
__device__ __forceinline__ void load_x16(const void* x, int dtype, long off, float* v) {
  if (dtype == DT_F32) {
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 f = __ldg(p + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(x) + off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 u = __ldg(p + i);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // little endian: element 2j is the low half
        v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
        v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; `scratch` holds >= 32 floats of shared memory. The
// result is returned to every thread. blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : 0.f;
  return warp_sum(t);
}

// ---- tensor-core tiles (q4_matvec.cu, flash_attention.cu)

// kBytes global -> shared without registers; zero-filled where !valid
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? kBytes : 0;
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s), "l"(gmem),
                 "n"(kBytes), "r"(n)
                 : "memory");
  }
}

// four 8 x 8 bf16 matrices from shared memory (mma fragments); lane t gives
// the address of row t % 8 of matrix t / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// the same, each 8 x 8 matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// d += a (16 x 16, bf16) b (16 x 8, bf16), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
