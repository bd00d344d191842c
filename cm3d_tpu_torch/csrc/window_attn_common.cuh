// Pieces shared by the two fused window-attention sources
// (window_attn.cu: Swin's table bias; window_attn_relpos.cu: SAM's
// decomposed relative-position bias): type conversion and the operand-tile
// row stride.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace wattn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to T, carried as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__host__ __device__ inline size_t round128(size_t v) { return (v + 127) & ~size_t(127); }

// Row stride (elements) of a GEMM operand tile of KC columns: 16 bytes of
// padding keep wmma's loads aligned and off the same banks; the SIMT f32
// path pads by one element.
template <typename T>
__host__ __device__ constexpr int tile_ld(int kc) {
  return std::is_same<T, bf16>::value ? kc + 8 : kc + 1;
}

}  // namespace wattn
