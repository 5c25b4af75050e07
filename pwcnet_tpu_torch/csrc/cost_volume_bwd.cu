// K4: backward of the cost volume (K2) and of the correlation half of the
// fused warp + cost volume (K1, where f1 is the saved warped map).
//
// Replaces pwcnet_tpu/ops/pallas/cost_volume.py::_cv_bwd (the Pallas calls
// _run_df0 and _run_df1, kernel bodies _cv_bwd_df0_kernel and
// _cv_bwd_df1_kernel; their windowed and double-buffered variants exist only
// for VMEM capacity and compute the same function).
//
// With gt = g * lrelu'(out) / C, the sign read from the forward's saved
// output (1 where out >= 0, else 0.1), and off_t = (v - d, u - d) for tap
// t = v * (2d+1) + u:
//
//   df0[p, c] = sum_t gt[p, t]         * f1[p + off_t, c]
//   df1[q, c] = sum_t gt[q - off_t, t] * f0[q - off_t, c]
//
// with zero wherever the source pixel lies outside the frame. gt is formed
// here from g and out in float32; sums are float32; df0 and df1 are rounded
// to the model dtype on store. On the training path it runs 5 times per
// step: once at the K2 shape and once at each of the four K1 shapes.
//
// Design. Both halves are gathers and share one kernel template. A block of
// 256 threads owns an 8 x 8 tile of output pixels of one batch element and a
// chunk of 32 channels; a warp owns one tile row and a lane one channel, so
// every access to the NHWC tensors and to the staged window is 32
// consecutive channels. The (8 + 2d)^2 window of the other frame's features
// for this chunk sits in shared memory as float32, position-major. The taps
// go one vertical offset v at a time: the block stages the 2d+1 values
// gt[., v, 0..2d] of the pixels that v pairs with the tile (the tile itself
// for df0, the tile shifted by -off for df1, with its 2d halo columns), then
// each thread walks the window row once and feeds its 8 accumulators: one
// shared load per window value, one broadcast load per gt value, per FMA.
//
// K8b, the backward of K8 (the cost volume of a shard against f1_ext with
// d halo rows on each side), is the same two kernels with a row pad:
// replaces pwcnet_tpu/ops/pallas/cost_volume.py::_cv_hpad_bwd (the same
// _run_df0 / _run_df1 Pallas calls). df0 reads f1_ext's halo rows where K4
// reads zeros; df1_ext covers the h + 2d extended rows, with gt and f0 zero
// outside [0, h), so the halo rows' cotangents flow back to the neighbour
// shards through the exchange. On the main path it runs inside K9's backward
// at every sharded warped level, and at level 0 when that level is sharded.
//
// Bound on the H100: bytes. It reads g and out (81 values per pixel each),
// f0 and f1 and writes df0 and df1: (2 * 81 + 4C) values per pixel against
// 4 * 81 * C operations, about 30 operations per byte in bf16 at C = 32.
// This version re-reads g and out once per channel chunk and per half (L2
// serves them) and is limited by shared-memory loads, not by device memory.
#include "common.cuh"

namespace pwc {

constexpr int kBwdT = 8;       // tile rows and columns
constexpr int kBwdCC = 32;     // channels per block: one lane each
constexpr int kBwdThreads = kBwdT * 32;

// DF1 = false: res = df0 (H rows), feat = f1 with H + 2 pad rows.
// DF1 = true:  res = df1 with H + 2 pad rows, feat = f0 (H rows).
// Row y of a tensor with H + 2 pad rows lies at index y + pad; K4 has pad 0.
template <typename T, int D, bool DF1>
__global__ void __launch_bounds__(kBwdThreads)
    cv_bwd_kernel(const T* __restrict__ g, const T* __restrict__ out, const T* __restrict__ feat,
                  T* __restrict__ res, int H, int W, int C, int tiles_x, int pad) {
  constexpr int N = 2 * D + 1;
  constexpr int TAPS = N * N;
  constexpr int WW = kBwdT + 2 * D;              // window rows and columns
  constexpr int GX = DF1 ? WW : kBwdT;           // gt columns staged per row
  __shared__ float s_win[WW * WW * kBwdCC];
  __shared__ float s_gt[kBwdT * GX * N];

  const int feat_pad = DF1 ? 0 : pad;
  const int res_pad = DF1 ? pad : 0;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kBwdCC;
  const int y0 = (blockIdx.x / tiles_x) * kBwdT - res_pad;
  const int x0 = (blockIdx.x % tiles_x) * kBwdT;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = tid / 32;  // tile row of this warp
  const float inv_c = 1.f / (float)C;
  const size_t frame = (size_t)b * H * W;
  const size_t feat_frame = (size_t)b * (H + 2 * feat_pad) * W;
  const size_t res_frame = (size_t)b * (H + 2 * res_pad) * W;

  // the window of the other frame's features, zero outside its rows
  for (int i = tid; i < WW * WW * kBwdCC; i += kBwdThreads) {
    const int c = i % kBwdCC;
    const int p = i / kBwdCC;
    const int gy = y0 - D + p / WW;
    const int gx = x0 - D + p % WW;
    float v = 0.f;
    if (gy >= -feat_pad && gy < H + feat_pad && gx >= 0 && gx < W && c0 + c < C)
      v = to_f32(feat[(feat_frame + (size_t)(gy + feat_pad) * W + gx) * C + c0 + c]);
    s_win[i] = v;
  }

  float acc[kBwdT];
#pragma unroll
  for (int i = 0; i < kBwdT; ++i) acc[i] = 0.f;

  for (int v = 0; v < N; ++v) {
    __syncthreads();  // the window is staged; the previous s_gt is read
    // gt[., v*N + u] of the pixels that vertical offset v pairs with the tile
    for (int i = tid; i < kBwdT * GX * N; i += kBwdThreads) {
      const int u = i % N;
      const int x = (i / N) % GX;
      const int rr = i / (N * GX);
      const int py = DF1 ? y0 + rr + D - v : y0 + rr;
      const int px = DF1 ? x0 - D + x : x0 + x;
      float val = 0.f;
      if (py >= 0 && py < H && px >= 0 && px < W) {
        const size_t at = (frame + (size_t)py * W + px) * TAPS + v * N + u;
        val = to_f32(g[at]) * (to_f32(out[at]) >= 0.f ? 1.f : 0.1f) * inv_c;
      }
      s_gt[i] = val;
    }
    __syncthreads();
    // df0 pairs tile pixel (r, i) with window (r + v, i + u);
    // df1 pairs it with window (r + 2D - v, i + 2D - u), whose own gt it takes
    const float* win = s_win + (DF1 ? r + 2 * D - v : r + v) * WW * kBwdCC + lane;
    const float* gt = s_gt + r * GX * N;
#pragma unroll
    for (int x = 0; x < WW; ++x) {
      const float f = win[x * kBwdCC];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int i = DF1 ? x - 2 * D + u : x - u;
        if (i >= 0 && i < kBwdT) acc[i] = fmaf(gt[(DF1 ? x : i) * N + u], f, acc[i]);
      }
    }
  }

  const int y = y0 + r;
  if (y < H + res_pad && c0 + lane < C) {
#pragma unroll
    for (int i = 0; i < kBwdT; ++i) {
      const int x = x0 + i;
      if (x < W) res[(res_frame + (size_t)(y + res_pad) * W + x) * C + c0 + lane] = from_f32<T>(acc[i]);
    }
  }
}

template <typename T, int D>
cudaError_t run_d(const T* f0, const T* f1, const T* out, const T* g, T* df0, T* df1, int B, int H,
                  int W, int C, int pad, cudaStream_t stream) {
  const int tiles_x = (W + kBwdT - 1) / kBwdT;
  const int chunks = (C + kBwdCC - 1) / kBwdCC;
  const dim3 grid0(tiles_x * ((H + kBwdT - 1) / kBwdT), chunks, B);
  cv_bwd_kernel<T, D, false><<<grid0, kBwdThreads, 0, stream>>>(g, out, f1, df0, H, W, C, tiles_x, pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid1(tiles_x * ((H + 2 * pad + kBwdT - 1) / kBwdT), chunks, B);
  cv_bwd_kernel<T, D, true><<<grid1, kBwdThreads, 0, stream>>>(g, out, f0, df1, H, W, C, tiles_x, pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* f0, const void* f1, const void* out, const void* g, void* df0, void* df1,
                int B, int H, int W, int C, int d, int pad, cudaStream_t stream) {
  auto a = static_cast<const T*>(f0);
  auto bb = static_cast<const T*>(f1);
  auto o = static_cast<const T*>(out);
  auto gg = static_cast<const T*>(g);
  auto r0 = static_cast<T*>(df0);
  auto r1 = static_cast<T*>(df1);
  switch (d) {
    case 1: return run_d<T, 1>(a, bb, o, gg, r0, r1, B, H, W, C, pad, stream);
    case 2: return run_d<T, 2>(a, bb, o, gg, r0, r1, B, H, W, C, pad, stream);
    case 3: return run_d<T, 3>(a, bb, o, gg, r0, r1, B, H, W, C, pad, stream);
    case 4: return run_d<T, 4>(a, bb, o, gg, r0, r1, B, H, W, C, pad, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pwc

// f0, f1, df0, df1: (B, H, W, C); out, g: (B, H, W, (2d+1)^2). All contiguous
// and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_cost_volume_bwd(const void* f0, const void* f1, const void* out, const void* g,
                                   void* df0, void* df1, int B, int H, int W, int C, int d,
                                   int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1, out, g, df0, df1, B, H, W, C, d, 0, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16>(f0, f1, out, g, df0, df1, B, H, W, C, d, 0, s);
    default: return cudaErrorInvalidValue;
  }
}

// K8b. f0, df0: (B, H, W, C); f1_ext, df1_ext: (B, H + 2d, W, C); out, g: (B, H, W, (2d+1)^2).
// All contiguous and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_cost_volume_hpad_bwd(const void* f0, const void* f1_ext, const void* out,
                                        const void* g, void* df0, void* df1_ext, int B, int H, int W,
                                        int C, int d, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1_ext, out, g, df0, df1_ext, B, H, W, C, d, d, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16>(f0, f1_ext, out, g, df0, df1_ext, B, H, W, C, d, d, s);
    default: return cudaErrorInvalidValue;
  }
}
