// Element types of the per-op Mamba-1 kernels (K1-K5): activations are fp32
// or bf16 in device memory and fp32 in registers. Every load widens to fp32
// (exact), every store rounds to the nearest even (__float2bfloat16_rn), as
// the TPU kernels' `.astype` does; all arithmetic runs in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and widened back: what a value stored as T reads back as.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Two bf16 packed in 32 bits (low half first in memory) to fp32 and back.
__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo, the lower address
  return *reinterpret_cast<const unsigned int*>(&p);
}
