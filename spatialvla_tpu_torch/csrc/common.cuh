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
