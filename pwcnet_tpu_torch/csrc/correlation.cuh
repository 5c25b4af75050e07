// The 81-tap correlation shared by K2 and K8 (cost_volume.cu) and K1 and K9
// (warped_cv.cu).
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
//   `void gather8(b, y, x, c0, float (&v)[8])`: operator() of channels c0 ..
//       c0 + 7 at once by 16-byte loads, used where C is a multiple of 8
//       (every main-path level): one flow read and one set of corners for
//       K1 and K9, one load per corner instead of eight;
//   `void save(b, y, x, c, v)`, called once for every staged value of the
//       block's own tile and, in the first and last row of tiles, of the
//       window rows above row 0 and below row H - 1 (K9 keeps them as the
//       backward's residual).
//
// Design. A tile is TH x TW = 8 x 32 output pixels of one batch element (8 x
// 16 where W <= 16, so that a narrow level idles no half of its block). The
// blocks of one tile form a thread-block cluster of `split` blocks (1, 2, 4
// or 8), each of which correlates a contiguous share of the channel chunks;
// the host picks TW and `split` per (B, H, W, C) so that the grid fills the
// 132 SMs at every level (ops/cuda/_common.py::correlation_plan, which the
// CPU tests also hold to this tiling). Channels go through shared memory CC
// = 8 at a time, converted to float32: the f0 tile and the (TH + 2d) x (TW +
// 2d) window of g. A thread owns P = 8 neighbouring output pixels of one
// tile row and one tap row v: per channel it reads the P f0 values and the
// P + 2d window values of row v by 16-byte loads and does P x (2d + 1) FMAs
// from registers (3 FMAs a loaded float at d = 4). A
// thread stages whole pixels of 8 channels: gather8 reads K1's and K9's
// flow once for the 8 and each corner by one 16-byte load (K2's and K8's
// values by one), and all of a chunk's loads are in flight before the first
// is used. (Measured on the H100 and dropped, none faster: fetching the
// next chunk into registers while this one is correlated; stages of 16
// channels; stages of 32 with neighbouring lanes on one pixel's chunks;
// two blocks an SM under a register cap that spills.)
// The partial sums then go to
// shared memory as [pixel][tap]; after a cluster barrier each block of the
// cluster sums a slice of them over the cluster's blocks through
// distributed shared memory in rank order 0, 1, ... (no atomics: the result
// is the same bits in every run), applies 1/C, LeakyReLU(0.1), rounds, and
// writes its slice, contiguous in the NHWC output; a second cluster barrier
// keeps every block's shared memory alive until its partners have read it.
//
// Bound on the H100: the output, 81 values per pixel, is the largest
// tensor; at d = 4 the kernel moves (2C + 81) values per pixel (+2 for K1's
// flow) and does 2 * 81 * C operations, on the CUDA cores in float32 (67
// TFLOP/s): about even at C = 32, operations-bound above. What bounds this
// kernel is the staging: at the two finest levels K1's gathers of the
// halo window (2.5x the tile, four corners a pixel) take most of its time.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace pwc {

namespace cg = cooperative_groups;

constexpr int kCorrTH = 8;  // output rows per tile
constexpr int kCorrP = 8;   // output pixels along x per thread
constexpr int kCorrCC = 8;  // channels staged per chunk
constexpr int kCorrMaxSplit = 8;  // blocks a tile, a portable cluster

template <int D, int TW>
struct CorrLayout {
  static constexpr int N = 2 * D + 1;
  static constexpr int TAPS = N * N;
  static constexpr int GX = TW / kCorrP;          // pixel groups per tile row
  static constexpr int G = kCorrTH * GX;          // pixel groups per tile
  static constexpr int kThreads = G * N;          // one thread per (pixel group, tap row)
  static constexpr int WH = kCorrTH + 2 * D;      // window rows
  static constexpr int WW = TW + 2 * D;           // window columns
  // row pitches in floats: a quarter warp's 16-byte loads of two tile rows fall on other banks
  static constexpr int WP = TW == 32 ? 44 : 28;
  static constexpr int FP = TW + 4;
  static constexpr int WPLANE = WH * WP;
  static constexpr int FPLANE = kCorrTH * FP;
  static constexpr int SEG = kCorrP + 2 * D;      // window values a thread reads per channel
  static constexpr int SLOTS_W = (WH * WW + kThreads - 1) / kThreads;
  static constexpr int SLOTS_F = (kCorrTH * TW + kThreads - 1) / kThreads;
  static constexpr int kStageFloats = kCorrCC * (WPLANE + FPLANE);
  // the partial sums, [tile row][pixel][tap]; rows 4 floats apart from a bank multiple
  static constexpr int RROW = TW * TAPS + 4;
  static constexpr int kRedFloats = kCorrTH * RROW;
  static constexpr int kBytes = 4 * (kStageFloats > kRedFloats ? kStageFloats : kRedFloats);
  static_assert(TW % kCorrP == 0 && WP >= WW && WP % 4 == 0 && FP % 4 == 0, "16-byte aligned rows");
  static_assert(kBytes <= 232448, "at most 227 KB of shared memory per block");
};

// n floats (n even) of shared memory, 8-byte aligned, into registers by the widest loads that fit
template <int NV>
__device__ __forceinline__ void load_row(float (&dst)[NV], const float* src) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NV; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      dst[i] = q.x, dst[i + 1] = q.y, dst[i + 2] = q.z, dst[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(src + i);
      dst[i] = q.x, dst[i + 1] = q.y;
    }
  }
}

// One pixel's kCorrCC staged values as T holds them, in as few registers as
// that takes (bf16 two to a register), between fetch and put.
template <typename T>
struct Staged {
  float v[kCorrCC];
  __device__ __forceinline__ void set(int c, float x) { v[c] = x; }
  __device__ __forceinline__ float get(int c) const { return v[c]; }
};
template <>
struct Staged<__nv_bfloat16> {
  __nv_bfloat162 v[kCorrCC / 2];
  __device__ __forceinline__ void set(int c, float x) {
    if (c % 2) v[c / 2].y = __float2bfloat16_rn(x);
    else v[c / 2].x = __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ float get(int c) const {
    return __bfloat162float(c % 2 ? v[c / 2].y : v[c / 2].x);
  }
};

template <typename T, int D, int TW, typename Loader>
__global__ void __launch_bounds__(CorrLayout<D, TW>::kThreads, 1)
    correlation_kernel(const T* __restrict__ f0, T* __restrict__ out, int H, int W, int C, int split,
                       Loader load) {
  using L = CorrLayout<D, TW>;
  constexpr int N = L::N, TAPS = L::TAPS, NT = L::kThreads;
  extern __shared__ __align__(16) float corr_smem[];
  float* s_win = corr_smem;                        // [CC][WH][WP]
  float* s_f0 = corr_smem + kCorrCC * L::WPLANE;   // [CC][TH][FP]
  float* red = corr_smem;                          // [TH * TW][TAPS], after the last chunk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();      // blockIdx.x % split
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kCorrTH;
  const int x0 = (blockIdx.x / split) * TW;
  const int tid = threadIdx.x;
  const T* f0b = f0 + (size_t)b * H * W * C;

  // this block's chunks of channels
  const int chunks = (C + kCorrCC - 1) / kCorrCC;
  const int per = (chunks + split - 1) / split;
  const int k_begin = rank * per;
  const int k_end = min(chunks, k_begin + per);

  // ---- staging: chunk k into registers (fetch: every load of the chunk in
  // flight before the first is used), then into shared memory (put)
  Staged<T> pw[L::SLOTS_W];
  Staged<T> pf[L::SLOTS_F];
  auto fetch = [&](int k) {
    const int c0 = k * kCorrCC;
#pragma unroll
    for (int s = 0; s < L::SLOTS_W; ++s) {
      const int i = tid + s * NT;
      const int gy = y0 - D + i / L::WW;
      const int gx = x0 - D + i % L::WW;
      const bool ok = i < L::WH * L::WW && gx >= 0 && gx < W && load.row_ok(gy);
      if (ok && C % kCorrCC == 0) {
        float v[kCorrCC];
        load.gather8(b, gy, gx, c0, v);
#pragma unroll
        for (int c = 0; c < kCorrCC; ++c) pw[s].set(c, v[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kCorrCC; ++c)
          pw[s].set(c, ok && c0 + c < C ? load(b, gy, gx, c0 + c) : 0.f);
      }
    }
#pragma unroll
    for (int s = 0; s < L::SLOTS_F; ++s) {
      const int i = tid + s * NT;
      const int gy = y0 + i / TW;
      const int gx = x0 + i % TW;
      const bool ok = i < kCorrTH * TW && gy < H && gx < W;
      const T* src = f0b + ((size_t)gy * W + gx) * C + c0;
      if (ok && C % kCorrCC == 0) {
        float v[kCorrCC];
        load8(src, v);
#pragma unroll
        for (int c = 0; c < kCorrCC; ++c) pf[s].set(c, v[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kCorrCC; ++c) pf[s].set(c, ok && c0 + c < C ? to_f32(src[c]) : 0.f);
      }
    }
  };
  auto put = [&](int k) {
    const int c0 = k * kCorrCC;
#pragma unroll
    for (int s = 0; s < L::SLOTS_W; ++s) {
      const int i = tid + s * NT;
      if (i >= L::WH * L::WW) continue;
      const int wy = i / L::WW, wx = i % L::WW;
      const int gy = y0 - D + wy, gx = x0 - D + wx;
#pragma unroll
      for (int c = 0; c < kCorrCC; ++c) s_win[c * L::WPLANE + wy * L::WP + wx] = pw[s].get(c);
      // each staged value is saved by exactly one block: the tile's own
      // rows and columns, and the rows above the frame (below it) by the
      // first (last) row of tiles, in the block of the cluster that owns
      // the channel
      const bool own_row = (gy >= y0 && gy < y0 + kCorrTH) || (gy < 0 && y0 == 0) ||
                           (gy >= H && y0 + kCorrTH >= H);
      if (own_row && gx >= x0 && gx < x0 + TW && gx < W && load.row_ok(gy)) {
#pragma unroll
        for (int c = 0; c < kCorrCC; ++c)
          if (c0 + c < C) load.save(b, gy, gx, c0 + c, pw[s].get(c));
      }
    }
#pragma unroll
    for (int s = 0; s < L::SLOTS_F; ++s) {
      const int i = tid + s * NT;
      if (i >= kCorrTH * TW) continue;
#pragma unroll
      for (int c = 0; c < kCorrCC; ++c) s_f0[c * L::FPLANE + (i / TW) * L::FP + i % TW] = pf[s].get(c);
    }
  };

  // ---- this thread: pixels x0 + px .. + P - 1 of tile row ty, tap row v
  const int v = tid / L::G;
  const int ty = (tid % L::G) / L::GX;
  const int px = (tid % L::GX) * kCorrP;
  float acc[kCorrP][N];
#pragma unroll
  for (int p = 0; p < kCorrP; ++p)
#pragma unroll
    for (int u = 0; u < N; ++u) acc[p][u] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    fetch(k);
    __syncthreads();  // the previous chunk's reads are done
    put(k);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCorrCC; ++c) {
      float a[kCorrP], w[L::SEG];
      load_row(a, s_f0 + c * L::FPLANE + ty * L::FP + px);
      load_row(w, s_win + c * L::WPLANE + (ty + v) * L::WP + px);
#pragma unroll
      for (int p = 0; p < kCorrP; ++p)
#pragma unroll
        for (int u = 0; u < N; ++u) acc[p][u] = fmaf(a[p], w[p + u], acc[p][u]);
    }
  }

  // ---- partial sums -> shared memory; the cluster sums them in rank order
  __syncthreads();  // `red` reuses the staging buffers
#pragma unroll
  for (int p = 0; p < kCorrP; ++p)
#pragma unroll
    for (int u = 0; u < N; ++u) red[ty * L::RROW + (px + p) * TAPS + v * N + u] = acc[p][u];
  cluster.sync();
  // epilogue: 1/C, LeakyReLU(0.1), round to T; block `rank` takes slice
  // `rank` of the tile's TH x TW x TAPS values (in output order), four at a
  // time, and sums them over the cluster's blocks in rank order
  const float inv_c = 1.f / (float)C;
  constexpr int kRow = TW * TAPS;
  constexpr int kTotal = kCorrTH * kRow;
  static_assert(kRow % 4 == 0 && kTotal % (4 * kCorrMaxSplit) == 0, "whole float4 groups per slice and row");
  const int slice = kTotal / split;
  const int lo = rank * slice, hi = lo + slice;
  const int n_cols = min(TW, W - x0);
  for (int i = lo + 4 * tid; i < hi; i += 4 * NT) {
    const int at = i / kRow * L::RROW + i % kRow;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kCorrMaxSplit; ++q) {
      if (q < split) {
        const float4 part = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + at);
        sum[0] += part.x, sum[1] += part.y, sum[2] += part.z, sum[3] += part.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pix = (i + j) / TAPS;
      const int y = y0 + pix / TW, x = pix % TW;
      if (y < H && x < n_cols)
        out[(((size_t)b * H + y) * W + x0 + x) * TAPS + (i + j) % TAPS] = from_f32<T>(leaky(sum[j] * inv_c));
    }
  }
  cluster.sync();  // no block leaves while a partner may still read its partial sums
}

template <typename T, int D, int TW, typename Loader>
cudaError_t launch_correlation_tiled(const T* f0, T* out, int B, int H, int W, int C, int split, Loader load,
                                     cudaStream_t stream) {
  using L = CorrLayout<D, TW>;
  auto kernel = correlation_kernel<T, D, TW, Loader>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + TW - 1) / TW * split, (H + kCorrTH - 1) / kCorrTH, B);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;  // the cluster's blocks are neighbours along x: one tile
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, f0, out, H, W, C, split, load);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch on `stream` for search range d in 1..4, tile width tw (16 or 32)
// and `split` blocks a tile (1, 2, 4 or 8), as correlation_plan picks them;
// returns the launch's error.
template <typename T, typename Loader>
cudaError_t launch_correlation(const T* f0, T* out, int B, int H, int W, int C, int d, int tw, int split,
                               Loader load, cudaStream_t stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8) return cudaErrorInvalidValue;
#define PWC_CORR(D, TW_) \
  if (d == D && tw == TW_) return launch_correlation_tiled<T, D, TW_>(f0, out, B, H, W, C, split, load, stream);
  PWC_CORR(1, 16) PWC_CORR(1, 32) PWC_CORR(2, 16) PWC_CORR(2, 32)
  PWC_CORR(3, 16) PWC_CORR(3, 32) PWC_CORR(4, 16) PWC_CORR(4, 32)
#undef PWC_CORR
  return cudaErrorInvalidValue;
}

}  // namespace pwc
