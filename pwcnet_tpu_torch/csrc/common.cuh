// Shared helpers for the pwcnet_tpu_torch kernels (sm_90a).
//
// Model tensors are float32 or bfloat16; every kernel converts to float32
// on load, accumulates in float32 and rounds to the model dtype on store
// (round-to-nearest-even, as PyTorch's .to(torch.bfloat16) does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace pwc {

// dtype codes passed from Python
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value as the model dtype would hold it, back in float32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// 8 consecutive values (16-byte aligned) into float32, by 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x, v[2 * k + 1] = f.y;
  }
}

// 16 bytes from device to shared memory without passing through registers;
// an invalid source writes zeros (zero bytes are read from `gmem`).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}
// 4 bytes likewise (cached in L1: neighbouring copies share its lines)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// whether a pointer (or null) may be read and written by 16-byte accesses
inline bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// LeakyReLU(0.1), as jnp.where(v >= 0, v, v * 0.1)
__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * 0.1f; }

}  // namespace pwc

// Each library is one translation unit, so this definition is not duplicated.
extern "C" const char* pwc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
