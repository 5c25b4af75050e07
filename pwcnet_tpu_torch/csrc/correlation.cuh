// The 81-tap correlation shared by K2 (cost_volume.cu) and K1 (warped_cv.cu).
//
//   out[b, y, x, (v+d)*(2d+1) + (u+d)] =
//       leaky_relu( sum_c f0[b, y, x, c] * g[b, y+v, x+u, c] / C, 0.1 )
//
// g is what the Loader stages: frame-1 features for K2, the bilinear-warped
// frame-1 features for K1, a shard's frame-1 rows with their halo rows for
// K8, the shard's warped rows against the whole frame for K9. g is zero
// outside the columns [0, W) and outside the rows the Loader accepts (the
// cost volume's zero padding). All tensors are NHWC; the output keeps the
// taps innermost. A Loader has
//   `bool row_ok(y)`: whether window row y (output coordinates, may be
//       negative or >= H) holds values: [0, H) for K1 and K2, [-d, H + d)
//       for K8 (the halo rows), the global frame's rows for K9;
//   `float operator()(b, y, x, c)`, called only where row_ok(y);
//   `void save(b, y, x, c, v)`, called once for every staged value of the
//       block's own tile and, in the first and last row of tiles, of the
//       window rows above row 0 and below row H - 1 (K9 keeps them as the
//       backward's residual).
//
// Design. One block of 256 threads owns a TH x TW = 8 x 32 tile of output
// pixels of one batch element, one thread per pixel, one warp per tile
// row. Channels go through shared memory CC = 8 at a time: the f0 tile and
// the (TH + 2d) x (TW + 2d) window of g, both converted to float32. Each
// thread keeps its pixel's (2d+1)^2 sums in registers, so the window is read
// from device memory once per block and never written back. The epilogue
// stages one tile row (TW x 81 values) at a time in shared memory, so the
// stores to the NHWC output are contiguous across the block.
//
// Bound on the H100: the output, 81 values per pixel, is the largest
// tensor; at d = 4 the kernel moves (2C + 81) values per pixel
// (+2 for K1's flow) and does 2 * 81 * C operations. It is bytes-bound on
// paper (at C = 32 about 3 operations per byte in bf16). This version
// does one shared-memory load per FMA, so shared-memory bandwidth, not
// device memory, limits it; reusing loads across neighbouring pixels in
// registers is later work.
#pragma once

#include "common.cuh"

namespace pwc {

constexpr int kCorrTH = 8;    // output rows per block
constexpr int kCorrTW = 32;   // output columns per block (one warp per row)
constexpr int kCorrCC = 8;    // channels staged per chunk
constexpr int kCorrThreads = kCorrTH * kCorrTW;

template <typename T, int D, typename Loader>
__global__ void __launch_bounds__(kCorrThreads)
    correlation_kernel(const T* __restrict__ f0, T* __restrict__ out, int H, int W, int C,
                       Loader load) {
  constexpr int N = 2 * D + 1;
  constexpr int TAPS = N * N;
  constexpr int WH = kCorrTH + 2 * D;
  constexpr int WW = kCorrTW + 2 * D;
  constexpr int WPLANE = WH * WW + 1;                 // +1: planes start on other banks
  constexpr int FPLANE = kCorrTH * kCorrTW + 1;
  static_assert(kCorrTW * TAPS <= kCorrCC * WPLANE, "epilogue staging must fit the window");
  __shared__ float s_win[kCorrCC * WPLANE];
  __shared__ float s_f0[kCorrCC * FPLANE];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kCorrTH;
  const int x0 = blockIdx.x * kCorrTW;
  const int tid = threadIdx.x;
  const int tx = tid % kCorrTW;
  const int ty = tid / kCorrTW;
  const T* f0b = f0 + (size_t)b * H * W * C;

  float acc[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) acc[t] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCorrCC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < WH * WW * kCorrCC; i += kCorrThreads) {
      const int c = i % kCorrCC;
      const int p = i / kCorrCC;
      const int gy = y0 - D + p / WW;
      const int gx = x0 - D + p % WW;
      const int gc = c0 + c;
      float v = 0.f;
      if (load.row_ok(gy) && gx >= 0 && gx < W && gc < C) {
        v = load(b, gy, gx, gc);
        // each staged row is saved by exactly one block: the tile's own
        // rows, and the rows above the frame (below it) by the first (last)
        // row of tiles. The Loader may keep them as a residual.
        const bool own_row = (gy >= y0 && gy < y0 + kCorrTH) || (gy < 0 && y0 == 0) ||
                             (gy >= H && y0 + kCorrTH >= H);
        if (own_row && gx >= x0 && gx < x0 + kCorrTW) load.save(b, gy, gx, gc, v);
      }
      s_win[c * WPLANE + p] = v;
    }
    for (int i = tid; i < kCorrTH * kCorrTW * kCorrCC; i += kCorrThreads) {
      const int c = i % kCorrCC;
      const int p = i / kCorrCC;
      const int gy = y0 + p / kCorrTW;
      const int gx = x0 + p % kCorrTW;
      const int gc = c0 + c;
      float v = 0.f;
      if (gy < H && gx < W && gc < C) v = to_f32(f0b[((size_t)gy * W + gx) * C + gc]);
      s_f0[c * FPLANE + p] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCorrCC; ++c) {
      const float a = s_f0[c * FPLANE + ty * kCorrTW + tx];
      const float* win = s_win + c * WPLANE + ty * WW + tx;
#pragma unroll
      for (int v = 0; v < N; ++v) {
#pragma unroll
        for (int u = 0; u < N; ++u) acc[v * N + u] = fmaf(a, win[v * WW + u], acc[v * N + u]);
      }
    }
  }

  // epilogue: 1/C, LeakyReLU(0.1), round to T; one tile row at a time
  const float inv_c = 1.f / (float)C;
  float* stage = s_win;
  const int n_cols = min(kCorrTW, W - x0);
  for (int r = 0; r < kCorrTH; ++r) {
    __syncthreads();
    if (ty == r) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) stage[tx * TAPS + t] = leaky(acc[t] * inv_c);
    }
    __syncthreads();
    const int y = y0 + r;
    if (y < H) {
      T* dst = out + (((size_t)b * H + y) * W + x0) * TAPS;
      for (int i = tid; i < n_cols * TAPS; i += kCorrThreads) dst[i] = from_f32<T>(stage[i]);
    }
  }
}

// Launch on `stream` for search range d in 1..4; returns cudaGetLastError().
template <typename T, typename Loader>
cudaError_t launch_correlation(const T* f0, T* out, int B, int H, int W, int C, int d,
                               Loader load, cudaStream_t stream) {
  const dim3 grid((W + kCorrTW - 1) / kCorrTW, (H + kCorrTH - 1) / kCorrTH, B);
  switch (d) {
    case 1: correlation_kernel<T, 1><<<grid, kCorrThreads, 0, stream>>>(f0, out, H, W, C, load); break;
    case 2: correlation_kernel<T, 2><<<grid, kCorrThreads, 0, stream>>>(f0, out, H, W, C, load); break;
    case 3: correlation_kernel<T, 3><<<grid, kCorrThreads, 0, stream>>>(f0, out, H, W, C, load); break;
    case 4: correlation_kernel<T, 4><<<grid, kCorrThreads, 0, stream>>>(f0, out, H, W, C, load); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace pwc
