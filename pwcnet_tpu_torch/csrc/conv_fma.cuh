// float32-FMA pieces of the 3x3 convs shared by K3 (pyramid_conv.cu) and
// its backward K6 (pyramid_conv_bwd.cu).
//
// Activations sit in shared memory position-major: a position's channels
// are consecutive, positions P floats apart (C + 4, so that the 16-byte
// loads of 8 neighbouring positions fall on 8 different bank quads). A
// tap's weights are [ci][co] (ci the conv's input channel), read as float4
// broadcasts. A thread sums a column of R positions x 4 NJ output
// channels: each weight broadcast serves R positions and each 16-byte load
// of 4 input channels feeds 16 NJ FMAs. Every sum runs tap by tap and, in a
// tap, input channel by input channel: the order of the one-position-a-
// thread bodies these columns replaced in K3 and K6, so their results are
// the same bits.
#pragma once

#include "common.cuh"

namespace pwc {

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

// OIHW kernel [C][CI][3][3] -> shared [tap][ci][co], the conv itself, by
// 4-byte asynchronous copies taken in the source's order (the caller
// commits the group)
template <int CI, int C, int THREADS>
__device__ __forceinline__ void stage_weights_async(float* w_s, const float* __restrict__ k) {
  for (int i = threadIdx.x; i < 9 * CI * C; i += THREADS) {
    const int tap = i % 9, ci = (i / 9) % CI, co = i / (9 * CI);
    cp_async4(w_s + (tap * CI + ci) * C + co, k + i, true);
  }
}

// OIHW kernel [CO][CI][3][3] -> shared [t][co][ci]: its transpose in the
// input, a conv whose input channels are the forward's outputs. t = 8 - tap
// when MIRROR (the transpose of a stride-1 conv is a conv with the taps
// mirrored), else t = tap (the stride-2 conv1^T picks its taps by phase).
// 4-byte asynchronous copies in the source's order; the caller commits.
template <int CO, int CI, int THREADS, bool MIRROR>
__device__ __forceinline__ void stage_weights_t_async(float* w_s, const float* __restrict__ k) {
  for (int i = threadIdx.x; i < 9 * CI * CO; i += THREADS) {
    const int tap = i % 9, ci = (i / 9) % CI, co = i / (9 * CI);
    cp_async4(w_s + ((MIRROR ? 8 - tap : tap) * CO + co) * CI + ci, k + i, true);
  }
}

// acc[r][4 h + j] += one tap at R positions down one column, output channel
// 4 tn + h CO / NJ + j: `sp` points at the tap's source for the column's
// first position, `row` is the plane's width in positions, `wp` at the
// tap's [ci][co] weights + 4 tn. Channels go 4 at a time: one 16-byte load a
// position, then 4 x NJ float4 weight broadcasts for 16 R NJ FMAs. UNROLL
// groups of 4 channels an iteration (2 lets the next group's loads fly
// early, at the price of R more float4 registers).
template <int CI, int CO, int R, int NJ, int P, int UNROLL = 2>
__device__ __forceinline__ void conv_col_tap(float (&acc)[R][4 * NJ], const float* sp, int row, const float* wp) {
#pragma unroll (UNROLL)
  for (int c4 = 0; c4 < CI / 4; ++c4) {
    float4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = *reinterpret_cast<const float4*>(sp + r * row * P + 4 * c4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int h = 0; h < NJ; ++h) {
        const float4 w = *reinterpret_cast<const float4*>(wp + (4 * c4 + c) * CO + h * (CO / NJ));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = c == 0 ? v[r].x : c == 1 ? v[r].y : c == 2 ? v[r].z : v[r].w;
          acc[r][4 * h + 0] = fmaf(x, w.x, acc[r][4 * h + 0]);
          acc[r][4 * h + 1] = fmaf(x, w.y, acc[r][4 * h + 1]);
          acc[r][4 * h + 2] = fmaf(x, w.z, acc[r][4 * h + 2]);
          acc[r][4 * h + 3] = fmaf(x, w.w, acc[r][4 * h + 3]);
        }
      }
    }
  }
}

template <int R, int N>
__device__ __forceinline__ void zero_acc(float (&acc)[R][N]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[r][j] = 0.f;
}

// acc[r][4 h + j] = the 3x3 stride-1 conv (C -> C channels) at R positions
// down one column, output channel 4 tn + h C / NJ + j, from position-major
// planes of pixel stride P; `src` points at the top-left tap of the
// column's first position, `row` is the plane's width in positions, `w_s`
// is [tap][ci][co].
template <int C, int R, int NJ, int P, int UNROLL = 2>
__device__ __forceinline__ void conv_col_s1(float (&acc)[R][4 * NJ], const float* src, int row, const float* w_s,
                                            int tn) {
  zero_acc(acc);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap)
    conv_col_tap<C, C, R, NJ, P, UNROLL>(acc, src + ((tap / 3) * row + tap % 3) * P, row,
                                         w_s + tap * C * C + 4 * tn);
}

}  // namespace pwc
