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
// Summation order. Every output is one float32 accumulator that takes its
// 81 taps by fmaf, v ascending and within v u ascending (df0) or u
// descending (df1), and is rounded once on store: the order of the first
// body (two launches, one lane a channel), so the two agree to the bit.
//
// Design. Both halves are gathers and run in ONE launch: the first blocks
// of the grid are df1's tiles (K8b: over the h + 2d extended rows), the
// rest df0's, and the block index picks the half. A block owns a tile of
// TH x 8 output pixels of one batch element and a chunk of 32 channels; TH
// is 8, 4 or 2, chosen on the host (ops/cuda/_common.py::cv_bwd_plan) so
// that the coarse levels still give two blocks an SM. A thread owns 4
// consecutive channels of 4 pixels of one tile row (16 accumulators): one
// window read (16 bytes in float32) feeds 4 pixels and one broadcast gt
// read feeds 4 FMAs, 0.33 shared loads an FMA at d = 4.
//
// Staging, with the loads in flight: the (TH + 2d) x (8 + 2d) window of the
// other frame's features for the chunk goes to shared memory in the input
// dtype by 16-byte cp.async (4 float32 or 8 bf16 channels; zero-filled
// outside the frame's rows and columns), all issued before any is waited
// for; while they fly, the gt values the tile needs for all 81 taps are
// loaded in batches of kCvbBatch per thread (read-only loads with a 256-byte
// L2 fill), every load of a batch issued before its shared stores, and
// stored once: df0's are the tile's own
// pixels' taps, df1's only the (pixel, tap) pairs some output of the tile
// reads (TH x 9 x 8 x 9 at d = 4, not the (8 + 2d) x 9 columns of all
// shifts). Both are TH x 8 x 81 floats (20.7 KB at TH = 8). One barrier,
// then the 81 taps from shared memory, then one 16- or 8-byte store per
// pixel.
//
// K8b, the backward of K8 (the cost volume of a shard against f1_ext with
// d halo rows on each side), is the same kernel with a row pad: replaces
// pwcnet_tpu/ops/pallas/cost_volume.py::_cv_hpad_bwd (the same _run_df0 /
// _run_df1 Pallas calls). df0 reads f1_ext's halo rows where K4 reads
// zeros; df1_ext covers the h + 2d extended rows, with gt and f0 zero
// outside [0, h), so the halo rows' cotangents flow back to the neighbour
// shards through the exchange. On the main path it runs inside K9's
// backward at every sharded warped level, and at level 0 when that level
// is sharded.
//
// Bound on the H100: in bf16 bytes, (2 * 81 + 4C) * 2 bytes a pixel (g,
// out, f0, f1 read once, df0, df1 written once) against 4 * 81 * C
// operations, about 30 operations a byte at C = 32; in float32 the larger
// of (2 * 81 + 4C) * 4 bytes and 4 * 81 * C operations at 67 TFLOP/s. The
// kernel reads g and out once per 32-channel chunk and per half (L2 serves
// the repeats), df1's gt as 9-tap runs of the tile's 8 + 2d columns and the
// window with its halo (4x the tile at 8 x 8, d = 4). At the coarse levels
// it is bound by the latency of its staging; at the finest the gt loads
// take over half its time (the tap loop under a fifth), held by the L2 and
// device-memory traffic this tiling moves, not by the order of the loads:
// see PERF.md.
#include "common.cuh"

namespace pwc {

constexpr int kCvbTW = 8;      // tile columns
constexpr int kCvbCC = 32;     // channels a block
constexpr int kCvbCPT = 4;     // channels a thread
constexpr int kCvbPX = 4;      // tile columns a thread
constexpr int kCvbGroups = kCvbCC / kCvbCPT;  // channel groups: a quarter warp
constexpr int kCvbBatch = 24;  // gt loads of each of g and out a thread keeps in flight

template <typename T, int D, int TH>
struct CvbLayout {
  static constexpr int N = 2 * D + 1;
  static constexpr int TAPS = N * N;
  static constexpr int WH = TH + 2 * D;       // window rows
  static constexpr int WW = kCvbTW + 2 * D;   // window columns
  static constexpr int VEC = 16 / (int)sizeof(T);  // channels a 16-byte copy
  // window position stride in elements: bf16 rows of 80 bytes keep the two
  // pixel halves of a half warp's 8-byte reads on other banks
  static constexpr int POS = kCvbCC + (sizeof(T) == 2 ? 8 : 0);
  static constexpr int kThreads = TH * (kCvbTW / kCvbPX) * kCvbGroups;
  static constexpr int kWinBytes = WH * WW * POS * (int)sizeof(T);
  static constexpr int kGt = TH * kCvbTW * TAPS;  // staged gt floats (either half)
  static constexpr int kBytes = kWinBytes + kGt * 4;
};

// 4 consecutive channels of the staged window as float32
__device__ __forceinline__ void win4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}
__device__ __forceinline__ void win4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

// 4 consecutive channels rounded to the model dtype, by one store
__device__ __forceinline__ void store4(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&a)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// One value of g or out as float32, by the read-only path with a 256-byte
// L2 fill: df1's gt runs are 9 taps of pixels 81 taps apart, and the
// neighbouring runs other slots and tiles read come in with the first
__device__ __forceinline__ float ld_gt(const float* p) {
  float v;
  asm("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_gt(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L2::256B.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);  // bf16 -> float32 is exact
}

// Where slot e of the gt staging reads g and out (false: outside the frame,
// gt 0). The slot's place in shared memory is e itself: df0 stages
// [tile row][tile column][tap] of the tile's own pixels; df1 stages
// [tile row][v][tile column][u], the gt of pixel (row + d - v, column + d -
// u) at tap (v, u), which the tile's output (row, column) takes at that tap.
template <int D, bool DF1>
__device__ __forceinline__ bool gt_source(int e, int y0, int x0, int H, int W, size_t frame, size_t& at) {
  constexpr int N = 2 * D + 1;
  constexpr int TAPS = N * N;
  int py, px, t;
  if (DF1) {
    const int q = e / (kCvbTW * N);  // tile row * N + v
    const int m = e % (kCvbTW * N);  // tile column * N + u
    const int v = q % N, u = m % N;
    py = y0 + q / N + D - v;
    px = x0 + m / N + D - u;
    t = v * N + u;
  } else {
    const int m = e % (kCvbTW * TAPS);
    py = y0 + e / (kCvbTW * TAPS);
    px = x0 + m / TAPS;
    t = m % TAPS;
  }
  if (py < 0 || py >= H || px < 0 || px >= W) return false;
  at = (frame + (size_t)py * W + px) * TAPS + t;
  return true;
}

// One half's tile: DF1 = false: res = df0 (H rows), feat = f1 with H + 2 pad
// rows; DF1 = true: res = df1 with H + 2 pad rows, feat = f0 (H rows). Row y
// of a tensor with H + 2 pad rows lies at index y + pad; K4 has pad 0.
template <typename T, int D, int TH, bool DF1>
__device__ __forceinline__ void cv_bwd_tile(const T* __restrict__ g, const T* __restrict__ out,
                                            const T* __restrict__ feat, T* __restrict__ res, int bid,
                                            int H, int W, int C, int pad, int tiles_x, int chunks, bool vec,
                                            unsigned char* smem) {
  using L = CvbLayout<T, D, TH>;
  constexpr int N = L::N;
  constexpr int TAPS = L::TAPS;
  constexpr int WW = L::WW;
  constexpr int THREADS = L::kThreads;
  T* s_win = reinterpret_cast<T*>(smem);
  float* s_gt = reinterpret_cast<float*>(smem + L::kWinBytes);

  const int feat_pad = DF1 ? 0 : pad;
  const int res_pad = DF1 ? pad : 0;
  const int tiles_y = (H + 2 * res_pad + TH - 1) / TH;
  // chunks of one tile are neighbours in the grid: they read the same gt from L2
  const int c0 = (bid % chunks) * kCvbCC;
  int t = bid / chunks;
  const int x0 = (t % tiles_x) * kCvbTW;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * TH - res_pad;
  const int b = t / tiles_y;
  const int tid = threadIdx.x;
  const float inv_c = 1.f / (float)C;
  const size_t frame = (size_t)b * H * W;
  const size_t feat_frame = (size_t)b * (H + 2 * feat_pad) * W;
  const size_t res_frame = (size_t)b * (H + 2 * res_pad) * W;

  // the window of the other frame's features, zero outside its rows and columns
  if (vec) {
    constexpr int PER_POS = kCvbCC / L::VEC;
#pragma unroll 4
    for (int i = tid; i < L::WH * WW * PER_POS; i += THREADS) {
      const int p = i / PER_POS;
      const int c = (i % PER_POS) * L::VEC;
      const int gy = y0 - D + p / WW;
      const int gx = x0 - D + p % WW;
      const bool ok = gy >= -feat_pad && gy < H + feat_pad && gx >= 0 && gx < W && c0 + c < C;
      const T* src = ok ? feat + (feat_frame + (size_t)(gy + feat_pad) * W + gx) * C + c0 + c : feat;
      cp_async16(s_win + p * L::POS + c, src, ok);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < L::WH * WW * kCvbCC; i += THREADS) {
      const int p = i / kCvbCC;
      const int c = i % kCvbCC;
      const int gy = y0 - D + p / WW;
      const int gx = x0 - D + p % WW;
      T val = from_f32<T>(0.f);
      if (gy >= -feat_pad && gy < H + feat_pad && gx >= 0 && gx < W && c0 + c < C)
        val = feat[(feat_frame + (size_t)(gy + feat_pad) * W + gx) * C + c0 + c];
      s_win[p * L::POS + c] = val;
    }
  }

  // gt of every (pixel, tap) pair the tile takes, once; a batch's loads
  // are all issued before its stores
  constexpr int PER = (L::kGt + THREADS - 1) / THREADS;
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += kCvbBatch) {
    float gv[kCvbBatch], ov[kCvbBatch];
#pragma unroll
    for (int j = 0; j < kCvbBatch; ++j) {
      const int e = tid + (j0 + j) * THREADS;
      size_t at;
      gv[j] = 0.f;
      ov[j] = 0.f;
      if (j0 + j < PER && e < L::kGt && gt_source<D, DF1>(e, y0, x0, H, W, frame, at)) {
        gv[j] = ld_gt(g + at);
        ov[j] = ld_gt(out + at);
      }
    }
#pragma unroll
    for (int j = 0; j < kCvbBatch; ++j) {
      const int e = tid + (j0 + j) * THREADS;
      if (j0 + j < PER && e < L::kGt) s_gt[e] = gv[j] * (ov[j] >= 0.f ? 1.f : 0.1f) * inv_c;
    }
  }
  if (vec) cp_async_wait<0>();
  __syncthreads();

  // thread: 4 channels (cg) of tile columns hx * 4 .. hx * 4 + 3 of tile row r
  const int cg = tid % kCvbGroups;
  const int hx = (tid / kCvbGroups) % (kCvbTW / kCvbPX);
  const int r = tid / (kCvbGroups * (kCvbTW / kCvbPX));
  float acc[kCvbPX][kCvbCPT];
#pragma unroll
  for (int i = 0; i < kCvbPX; ++i)
#pragma unroll
    for (int k = 0; k < kCvbCPT; ++k) acc[i][k] = 0.f;

  for (int v = 0; v < N; ++v) {
    // df0 pairs tile pixel (r, i) with window (r + v, i + u) at tap (v, u);
    // df1 pairs it with window (r + 2D - v, i + 2D - u), whose own gt it takes
    const T* win = s_win + ((DF1 ? r + 2 * D - v : r + v) * WW + hx * kCvbPX) * L::POS + cg * kCvbCPT;
    const float* gt = DF1 ? s_gt + ((r * N + v) * kCvbTW + hx * kCvbPX) * N
                          : s_gt + (r * kCvbTW + hx * kCvbPX) * TAPS + v * N;
#pragma unroll
    for (int x = 0; x < kCvbPX + 2 * D; ++x) {
      float f[kCvbCPT];
      win4(win + x * L::POS, f);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        // as x rises, u rises for a df0 pixel and falls for a df1 pixel
        const int i = DF1 ? x - 2 * D + u : x - u;
        if (i >= 0 && i < kCvbPX) {
          const float gtv = gt[i * (DF1 ? N : TAPS) + u];
#pragma unroll
          for (int k = 0; k < kCvbCPT; ++k) acc[i][k] = fmaf(gtv, f[k], acc[i][k]);
        }
      }
    }
  }

  const int y = y0 + r;
  const int c = c0 + cg * kCvbCPT;
  if (y >= H + res_pad || c >= C) return;
#pragma unroll
  for (int i = 0; i < kCvbPX; ++i) {
    const int x = x0 + hx * kCvbPX + i;
    if (x >= W) continue;
    T* dst = res + (res_frame + (size_t)(y + res_pad) * W + x) * C + c;
    if (vec) {
      store4(dst, acc[i]);
    } else {
#pragma unroll
      for (int k = 0; k < kCvbCPT; ++k)
        if (c + k < C) dst[k] = from_f32<T>(acc[i][k]);
    }
  }
}

// The first blocks1 blocks are df1's tiles, the rest df0's.
template <typename T, int D, int TH>
__global__ void __launch_bounds__(CvbLayout<T, D, TH>::kThreads)
    cv_bwd_kernel(const T* __restrict__ f0, const T* __restrict__ f1, const T* __restrict__ out,
                  const T* __restrict__ g, T* __restrict__ df0, T* __restrict__ df1, int H, int W, int C,
                  int pad, int tiles_x, int chunks, int blocks1, bool vec) {
  extern __shared__ __align__(16) unsigned char cvb_smem[];
  const int bid = blockIdx.x;
  if (bid < blocks1)
    cv_bwd_tile<T, D, TH, true>(g, out, f0, df1, bid, H, W, C, pad, tiles_x, chunks, vec, cvb_smem);
  else
    cv_bwd_tile<T, D, TH, false>(g, out, f1, df0, bid - blocks1, H, W, C, pad, tiles_x, chunks, vec, cvb_smem);
}

template <typename T, int D, int TH>
cudaError_t run_plan(const T* f0, const T* f1, const T* out, const T* g, T* df0, T* df1, int B, int H,
                     int W, int C, int pad, cudaStream_t stream) {
  using L = CvbLayout<T, D, TH>;
  auto kernel = cv_bwd_kernel<T, D, TH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kCvbTW - 1) / kCvbTW;
  const int chunks = (C + kCvbCC - 1) / kCvbCC;
  const int blocks0 = B * ((H + TH - 1) / TH) * tiles_x * chunks;
  const int blocks1 = B * ((H + 2 * pad + TH - 1) / TH) * tiles_x * chunks;
  // 16-byte window copies and 4-channel stores: whole vectors of channels, aligned
  const bool vec = C % L::VEC == 0 && aligned16(f0) && aligned16(f1) && aligned16(df0) && aligned16(df1);
  cv_bwd_kernel<T, D, TH><<<blocks0 + blocks1, L::kThreads, L::kBytes, stream>>>(
      f0, f1, out, g, df0, df1, H, W, C, pad, tiles_x, chunks, blocks1, vec);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_d(const T* f0, const T* f1, const T* out, const T* g, T* df0, T* df1, int B, int H,
                  int W, int C, int pad, int tile_rows, cudaStream_t stream) {
  switch (tile_rows) {
    case 8: return run_plan<T, D, 8>(f0, f1, out, g, df0, df1, B, H, W, C, pad, stream);
    case 4: return run_plan<T, D, 4>(f0, f1, out, g, df0, df1, B, H, W, C, pad, stream);
    case 2: return run_plan<T, D, 2>(f0, f1, out, g, df0, df1, B, H, W, C, pad, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* f0, const void* f1, const void* out, const void* g, void* df0, void* df1,
                int B, int H, int W, int C, int d, int pad, int tile_rows, cudaStream_t stream) {
  auto a = static_cast<const T*>(f0);
  auto bb = static_cast<const T*>(f1);
  auto o = static_cast<const T*>(out);
  auto gg = static_cast<const T*>(g);
  auto r0 = static_cast<T*>(df0);
  auto r1 = static_cast<T*>(df1);
  switch (d) {
    case 1: return run_d<T, 1>(a, bb, o, gg, r0, r1, B, H, W, C, pad, tile_rows, stream);
    case 2: return run_d<T, 2>(a, bb, o, gg, r0, r1, B, H, W, C, pad, tile_rows, stream);
    case 3: return run_d<T, 3>(a, bb, o, gg, r0, r1, B, H, W, C, pad, tile_rows, stream);
    case 4: return run_d<T, 4>(a, bb, o, gg, r0, r1, B, H, W, C, pad, tile_rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D, int TH>
cudaError_t info_plan(int* smem, int* threads, int* blocks) {
  using L = CvbLayout<T, D, TH>;
  auto kernel = cv_bwd_kernel<T, D, TH>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  *smem = L::kBytes;
  *threads = L::kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, L::kThreads, L::kBytes);
}

template <typename T>
cudaError_t info(int d, int tile_rows, int* smem, int* threads, int* blocks) {
  if (d != 4) return cudaErrorInvalidValue;  // the model's search range
  switch (tile_rows) {
    case 8: return info_plan<T, 4, 8>(smem, threads, blocks);
    case 4: return info_plan<T, 4, 4>(smem, threads, blocks);
    case 2: return info_plan<T, 4, 2>(smem, threads, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pwc

// f0, f1, df0, df1: (B, H, W, C); out, g: (B, H, W, (2d+1)^2). All contiguous
// and of one dtype: 0 f32 / 1 bf16. tile_rows: 8, 4 or 2 (cv_bwd_plan).
extern "C" int pwc_cost_volume_bwd(const void* f0, const void* f1, const void* out, const void* g,
                                   void* df0, void* df1, int B, int H, int W, int C, int d,
                                   int dtype, int tile_rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1, out, g, df0, df1, B, H, W, C, d, 0, tile_rows, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16>(f0, f1, out, g, df0, df1, B, H, W, C, d, 0, tile_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// K8b. f0, df0: (B, H, W, C); f1_ext, df1_ext: (B, H + 2d, W, C); out, g: (B, H, W, (2d+1)^2).
// All contiguous and of one dtype: 0 f32 / 1 bf16. tile_rows: 8, 4 or 2 (cv_bwd_plan).
extern "C" int pwc_cost_volume_hpad_bwd(const void* f0, const void* f1_ext, const void* out,
                                        const void* g, void* df0, void* df1_ext, int B, int H, int W,
                                        int C, int d, int dtype, int tile_rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1_ext, out, g, df0, df1_ext, B, H, W, C, d, d, tile_rows, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16>(f0, f1_ext, out, g, df0, df1_ext, B, H, W, C, d, d, tile_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// For the build log: dynamic shared memory, threads and resident blocks an
// SM of the kernel at search range d (4) and tile_rows.
extern "C" int pwc_cost_volume_bwd_info(int d, int dtype, int tile_rows, int* smem, int* threads, int* blocks) {
  switch (dtype) {
    case pwc::kF32: return pwc::info<float>(d, tile_rows, smem, threads, blocks);
    case pwc::kBF16: return pwc::info<__nv_bfloat16>(d, tile_rows, smem, threads, blocks);
    default: return cudaErrorInvalidValue;
  }
}
