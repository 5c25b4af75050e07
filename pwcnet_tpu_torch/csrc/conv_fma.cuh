// float32-FMA pieces of the 3x3 convs shared by K3 (pyramid_conv.cu) and
// its backward K6 (pyramid_conv_bwd.cu): one thread per position, all C
// output channels in registers, the weights in shared memory as
// [tap][cin][cout] read as float4 broadcasts.
#pragma once

#include "common.cuh"

namespace pwc {

constexpr int kPlThreads = 256;
constexpr int kPlTH = 8;    // tile rows of the one-thread-per-position kernels
constexpr int kPlTW = 32;   // tile columns

// acc[co] += v * w[co] for co < C, weights read as float4 broadcasts
template <int C>
__device__ __forceinline__ void axpy(float (&acc)[C], float v, const float* w) {
#pragma unroll
  for (int co = 0; co < C; co += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + co);
    acc[co + 0] = fmaf(v, w4.x, acc[co + 0]);
    acc[co + 1] = fmaf(v, w4.y, acc[co + 1]);
    acc[co + 2] = fmaf(v, w4.z, acc[co + 2]);
    acc[co + 3] = fmaf(v, w4.w, acc[co + 3]);
  }
}

// 3x3 stride-1 conv at one position of a channel-major shared plane set;
// `src` points at the top-left tap of channel 0.
template <int C>
__device__ __forceinline__ void conv_s1(float (&acc)[C], const float* src, int plane, int row,
                                        const float* w_s) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* sp = src + ky * row + kx;
      const float* w = w_s + (ky * 3 + kx) * C * C;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) axpy<C>(acc, sp[ci * plane], w + ci * C);
    }
  }
}

}  // namespace pwc
