// K3: one feature-pyramid level fused into one kernel:
//   conv3x3 stride 2 (SAME) + b1, LeakyReLU(0.1) -> s1
//   conv3x3 (SAME) + b2, LeakyReLU(0.1)           -> s2
//   conv3x3 (SAME) + b3, LeakyReLU(0.1)           -> out
// with float32 accumulation and s1, s2 rounded to the model dtype between
// the convs.
//
// Replaces pwcnet_tpu/ops/pallas/pyramid_conv.py::pyramid_level_fused
// (banded bodies _plevel_kernel_banded / _plevel_kernel_banded_infer and
// row-loop bodies _plevel_kernel / _plevel_kernel_infer, which compute the
// same function). On the main path it computes the two finest levels of
// both frames: (B, 448, 1024, 3) -> (B, 224, 512, 16) and
// (B, 224, 512, 16) -> (B, 112, 256, 32).
//
// SAME padding. With stride 2 on an even size TF pads only the bottom and
// right, so s1(i, j) reads x rows 2i..2i+2 and cols 2j..2j+2, with row H and
// col W zero. The stride-1 convs pad one on each side. s1 and s2 positions
// outside the level's frame are zero (each conv's own zero padding), not
// values computed past the edge.
//
// Design. One block of 256 threads owns a tile of half-resolution outputs
// of one batch element. It computes s1 on the tile plus a 2-pixel halo
// straight from x in device memory, then s2 on a 1-pixel halo from s1, then
// the tile from s2; s1 and s2 live only in shared memory. The halo
// recomputes about 1.7x the conv1 and 1.3x the conv2 work of the tile.
// conv1 (stride 2, 3 or 16 input channels) runs as float32 FMAs, one
// position and all C outputs per thread, the weights in shared memory as
// [tap][cin][cout] read as float4 broadcasts.
//
// - float32 (pyramid_level_kernel): conv2 and conv3 run the same way, with
//   s1 and s2 channel-major so that neighbouring threads read neighbouring
//   banks. Tile 8 x 32.
// - bfloat16 (pyramid_level_tc_kernel): conv2 and conv3 run on the tensor
//   cores as implicit GEMMs, WMMA 16x16x16 bf16 with float32 accumulation:
//   M = 16 positions along a row, N = C, K = 9 taps x C. s1 and s2 are
//   position-major [row][col][C], so the A tile of one tap is a strided
//   16 x 16 block of them. Tile 8 x 30: two 16-wide M tiles per row cover
//   the 30 outputs plus the 2-column halo that conv3 needs from s2.
//
// Bound on the H100: the level reads x and writes the output once (about
// 51 MB per bf16 batch of 8 at level 0, 44 MB at level 1) and does
// 2 x 315 x C MACs per output pixel at level 0 (2 x 720 x C at level 1),
// which is bytes-bound at the bf16 tensor-core rate. conv1 on FMAs and the
// shared-memory traffic of the WMMA tiles keep it above that bound; TMA
// loads and wgmma are later work.
#include <mma.h>

#include "common.cuh"

namespace pwc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kPlThreads = 256;

// OIHW kernel [C][CI][3][3] -> shared [tap][ci][co] float32.
template <typename T, int CI, int C>
__device__ __forceinline__ void stage_weights_f32(float* w_s, const T* __restrict__ k) {
  for (int i = threadIdx.x; i < 9 * CI * C; i += kPlThreads) {
    const int co = i % C;
    const int ci = (i / C) % CI;
    const int tap = i / (C * CI);
    w_s[i] = to_f32(k[(co * CI + ci) * 9 + tap]);
  }
}

template <typename T, int C>
__device__ __forceinline__ void stage_bias(float* b_s, const T* __restrict__ bias) {
  for (int i = threadIdx.x; i < C; i += kPlThreads) b_s[i] = to_f32(bias[i]);
}

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

// conv1 (3x3, stride 2, bottom/right SAME pad) at half-res (gy, gx), no bias
template <typename T, int CIN, int C>
__device__ __forceinline__ void conv1_at(float (&acc)[C], const T* __restrict__ xb, int H, int W,
                                         int gy, int gx, const float* w_s) {
#pragma unroll
  for (int co = 0; co < C; ++co) acc[co] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = 2 * gy + ky;
    if (iy >= H) continue;  // bottom SAME pad
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = 2 * gx + kx;
      if (ix >= W) continue;  // right SAME pad
      const T* xp = xb + ((size_t)iy * W + ix) * CIN;
      const float* w = w_s + (ky * 3 + kx) * CIN * C;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) axpy<C>(acc, to_f32(xp[ci]), w + ci * C);
    }
  }
}

// ------------------------------------------------------------ float32
constexpr int kPlTH = 8;
constexpr int kPlTW = 32;

template <int CIN, int C>
struct PlevelLayout {
  static_assert(CIN <= C && C % 4 == 0, "weights buffer sized for the C x C convs");
  static constexpr int S1H = kPlTH + 4, S1W = kPlTW + 4, S1 = S1H * S1W;
  static constexpr int S2H = kPlTH + 2, S2W = kPlTW + 2, S2 = S2H * S2W;
  static constexpr int W_FLOATS = 9 * C * C;
  static constexpr size_t kBytes = (size_t)(W_FLOATS + C + C * (S1 + S2)) * sizeof(float);
};

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

template <int CIN, int C>
__global__ void __launch_bounds__(kPlThreads)
    pyramid_level_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                         const float* __restrict__ b1, const float* __restrict__ k2,
                         const float* __restrict__ b2, const float* __restrict__ k3,
                         const float* __restrict__ b3, float* __restrict__ out, int H, int W) {
  using L = PlevelLayout<CIN, C>;
  extern __shared__ float4 smem_f4[];
  float* w_s = reinterpret_cast<float*>(smem_f4);
  float* b_s = w_s + L::W_FLOATS;
  float* s1 = b_s + C;
  float* s2 = s1 + C * L::S1;

  const int HH = H / 2;
  const int WH = W / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kPlTH;
  const int q0 = blockIdx.x * kPlTW;
  const int tid = threadIdx.x;
  const float* xb = x + (size_t)b * H * W * CIN;
  float acc[C];

  // ---- conv1 (stride 2) on the tile + 2-pixel halo, from device memory
  stage_weights_f32<float, CIN, C>(w_s, k1);
  stage_bias<float, C>(b_s, b1);
  __syncthreads();
  for (int p = tid; p < L::S1; p += kPlThreads) {
    const int gy = r0 - 2 + p / L::S1W;
    const int gx = q0 - 2 + p % L::S1W;
    const bool inside = gy >= 0 && gy < HH && gx >= 0 && gx < WH;
    if (inside) conv1_at<float, CIN, C>(acc, xb, H, W, gy, gx, w_s);
#pragma unroll
    for (int co = 0; co < C; ++co) s1[co * L::S1 + p] = inside ? leaky(acc[co] + b_s[co]) : 0.f;
  }
  __syncthreads();

  // ---- conv2 on the tile + 1-pixel halo, from s1
  stage_weights_f32<float, C, C>(w_s, k2);
  stage_bias<float, C>(b_s, b2);
  __syncthreads();
  for (int p = tid; p < L::S2; p += kPlThreads) {
    const int sy = p / L::S2W;
    const int sx = p % L::S2W;
    const int gy = r0 - 1 + sy;
    const int gx = q0 - 1 + sx;
    const bool inside = gy >= 0 && gy < HH && gx >= 0 && gx < WH;
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = 0.f;
    if (inside) conv_s1<C>(acc, s1 + sy * L::S1W + sx, L::S1, L::S1W, w_s);
#pragma unroll
    for (int co = 0; co < C; ++co) s2[co * L::S2 + p] = inside ? leaky(acc[co] + b_s[co]) : 0.f;
  }
  __syncthreads();

  // ---- conv3 on the tile, from s2, to the NHWC output
  stage_weights_f32<float, C, C>(w_s, k3);
  stage_bias<float, C>(b_s, b3);
  __syncthreads();
  const int oy = tid / kPlTW;
  const int ox = tid % kPlTW;
  const int gy = r0 + oy;
  const int gx = q0 + ox;
  if (gy < HH && gx < WH) {
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = 0.f;
    conv_s1<C>(acc, s2 + oy * L::S2W + ox, L::S2, L::S2W, w_s);
    float* dst = out + (((size_t)b * HH + gy) * WH + gx) * C;
#pragma unroll
    for (int co = 0; co < C; ++co) dst[co] = leaky(acc[co] + b_s[co]);
  }
}

template <int CIN, int C>
cudaError_t run_f32(const void* x, const void* k1, const void* b1, const void* k2, const void* b2,
                    const void* k3, const void* b3, void* out, int B, int H, int W,
                    cudaStream_t stream) {
  using L = PlevelLayout<CIN, C>;
  auto kernel = pyramid_level_kernel<CIN, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kPlTW - 1) / kPlTW, (H / 2 + kPlTH - 1) / kPlTH, B);
  kernel<<<grid, kPlThreads, L::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k1), static_cast<const float*>(b1),
      static_cast<const float*>(k2), static_cast<const float*>(b2), static_cast<const float*>(k3),
      static_cast<const float*>(b3), static_cast<float*>(out), H, W);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bfloat16
constexpr int kTcTH = 8;           // output rows per block
constexpr int kTcTW = 30;          // output columns per block
constexpr int kTcW = kTcTW + 4;    // s1 / s2 row width (positions)
constexpr int kTcS1H = kTcTH + 4;
constexpr int kTcS2H = kTcTH + 2;
constexpr int kTcWarps = kPlThreads / 32;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// shared memory, byte offsets (all multiples of 32, as WMMA needs)
template <int CIN, int C>
struct TcLayout {
  static_assert(C % 16 == 0 && CIN <= C, "WMMA tiles need C a multiple of 16");
  static constexpr size_t kS1 = 0;                                          // bf16 [12][34][C]
  static constexpr size_t kS2 = kS1 + (size_t)kTcS1H * kTcW * C * 2;        // bf16 [10][34][C]
  static constexpr size_t kW = kS2 + (size_t)kTcS2H * kTcW * C * 2;         // conv1 f32 | conv2/3 bf16
  static constexpr size_t kBias = kW + cmax(9 * CIN * C * 4, 9 * C * C * 2);  // f32 [3][C]
  static constexpr size_t kScratch = kBias + 3 * C * 4;                     // f32 [warps][16][C]
  static constexpr size_t kBytes = kScratch + (size_t)kTcWarps * 16 * C * 4;
};

// OIHW bf16 kernel -> shared [tap][ci][co] bf16, the WMMA B layout
template <int C>
__device__ __forceinline__ void stage_weights_bf16(bf16* wt, const bf16* __restrict__ k) {
  for (int i = threadIdx.x; i < 9 * C * C; i += kPlThreads) {
    const int co = i % C;
    const int ci = (i / C) % C;
    const int tap = i / (C * C);
    wt[i] = k[(co * C + ci) * 9 + tap];
  }
}

// One M tile of a 3x3 stride-1 conv over position-major [rows][kTcW][C]
// planes: the 16 positions (r, cj .. cj+15) read src rows r..r+2, columns
// cj..cj+17. The 16 x C float32 sums go to this warp's `scratch`.
template <int C>
__device__ __forceinline__ void conv_tile_tc(const bf16* src, const bf16* wt, float* scratch, int r,
                                             int cj) {
  constexpr int NT = C / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) wmma::fill_fragment(acc[nt], 0.f);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const bf16* a_base = src + ((r + tap / 3) * kTcW + cj + tap % 3) * C;
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_base + c0, C);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, wt + (tap * C + c0) * C + nt * 16, C);
        wmma::mma_sync(acc[nt], a, bw, acc[nt]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    wmma::store_matrix_sync(scratch + nt * 16, acc[nt], C, wmma::mem_row_major);
  __syncwarp();
}

template <int CIN, int C>
__global__ void __launch_bounds__(kPlThreads)
    pyramid_level_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k1,
                            const bf16* __restrict__ b1, const bf16* __restrict__ k2,
                            const bf16* __restrict__ b2, const bf16* __restrict__ k3,
                            const bf16* __restrict__ b3, bf16* __restrict__ out, int H, int W) {
  using L = TcLayout<CIN, C>;
  extern __shared__ float4 smem_f4[];
  char* smem = reinterpret_cast<char*>(smem_f4);
  bf16* s1 = reinterpret_cast<bf16*>(smem + L::kS1);
  bf16* s2 = reinterpret_cast<bf16*>(smem + L::kS2);
  float* w1 = reinterpret_cast<float*>(smem + L::kW);
  bf16* wt = reinterpret_cast<bf16*>(smem + L::kW);
  float* bias = reinterpret_cast<float*>(smem + L::kBias);

  const int HH = H / 2;
  const int WH = W / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTcTH;
  const int q0 = blockIdx.x * kTcTW;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* scratch = reinterpret_cast<float*>(smem + L::kScratch) + warp * 16 * C;
  const bf16* xb = x + (size_t)b * H * W * CIN;

  // ---- conv1 (stride 2, FMAs) on the tile + 2-pixel halo, from device memory
  stage_weights_f32<bf16, CIN, C>(w1, k1);
  stage_bias<bf16, C>(bias, b1);
  stage_bias<bf16, C>(bias + C, b2);
  stage_bias<bf16, C>(bias + 2 * C, b3);
  __syncthreads();
  for (int p = tid; p < kTcS1H * kTcW; p += kPlThreads) {
    const int gy = r0 - 2 + p / kTcW;
    const int gx = q0 - 2 + p % kTcW;
    const bool inside = gy >= 0 && gy < HH && gx >= 0 && gx < WH;
    float acc[C];
    if (inside) conv1_at<bf16, CIN, C>(acc, xb, H, W, gy, gx, w1);
    bf16* dst = s1 + p * C;
#pragma unroll
    for (int co = 0; co < C; ++co) dst[co] = from_f32<bf16>(inside ? leaky(acc[co] + bias[co]) : 0.f);
  }
  __syncthreads();

  // ---- conv2 (tensor cores) on the tile + 1-pixel halo: 10 rows x 32 columns
  stage_weights_bf16<C>(wt, k2);
  __syncthreads();
  for (int mt = warp; mt < kTcS2H * 2; mt += kTcWarps) {
    const int r = mt / 2;
    const int cj = (mt % 2) * 16;
    conv_tile_tc<C>(s1, wt, scratch, r, cj);
    const int gy = r0 - 1 + r;
    for (int e = lane; e < 16 * C; e += 32) {
      const int m = e / C;
      const int co = e % C;
      const int gx = q0 - 1 + cj + m;
      const bool inside = gy >= 0 && gy < HH && gx >= 0 && gx < WH;
      s2[(r * kTcW + cj + m) * C + co] =
          from_f32<bf16>(inside ? leaky(scratch[e] + bias[C + co]) : 0.f);
    }
    __syncwarp();  // scratch is reused by this warp's next tile
  }
  __syncthreads();

  // ---- conv3 (tensor cores) on the tile, to the NHWC output. Columns 30
  // and 31 of the second M tile read s2 columns 32..33, which conv2 did not
  // write; those two outputs are discarded.
  stage_weights_bf16<C>(wt, k3);
  __syncthreads();
  for (int mt = warp; mt < kTcTH * 2; mt += kTcWarps) {
    const int r = mt / 2;
    const int cj = (mt % 2) * 16;
    conv_tile_tc<C>(s2, wt, scratch, r, cj);
    const int gy = r0 + r;
    if (gy < HH) {
      bf16* dst = out + ((size_t)b * HH + gy) * WH * C;
      for (int e = lane; e < 16 * C; e += 32) {
        const int m = e / C;
        const int co = e % C;
        const int gx = q0 + cj + m;
        if (cj + m < kTcTW && gx < WH)
          dst[(size_t)gx * C + co] = from_f32<bf16>(leaky(scratch[e] + bias[2 * C + co]));
      }
    }
    __syncwarp();
  }
}

template <int CIN, int C>
cudaError_t run_bf16(const void* x, const void* k1, const void* b1, const void* k2, const void* b2,
                     const void* k3, const void* b3, void* out, int B, int H, int W,
                     cudaStream_t stream) {
  using L = TcLayout<CIN, C>;
  auto kernel = pyramid_level_tc_kernel<CIN, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kTcTW - 1) / kTcTW, (H / 2 + kTcTH - 1) / kTcTH, B);
  kernel<<<grid, kPlThreads, L::kBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(k2), static_cast<const bf16*>(b2), static_cast<const bf16*>(k3),
      static_cast<const bf16*>(b3), static_cast<bf16*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace pwc

// x: (B, H, W, cin) with H, W even; k1: (c, cin, 3, 3); k2, k3: (c, c, 3, 3) (OIHW);
// b1..b3: (c,); out: (B, H/2, W/2, c). All contiguous and of one dtype: 0 f32 / 1 bf16.
// (cin, c) is (3, 16) or (16, 32), the two finest PWCDCNet pyramid levels.
extern "C" int pwc_pyramid_level(const void* x, const void* k1, const void* b1, const void* k2,
                                 const void* b2, const void* k3, const void* b3, void* out, int B,
                                 int H, int W, int cin, int c, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool l0 = cin == 3 && c == 16;
  const bool l1 = cin == 16 && c == 32;
  if (dtype == pwc::kF32 && l0) return pwc::run_f32<3, 16>(x, k1, b1, k2, b2, k3, b3, out, B, H, W, s);
  if (dtype == pwc::kF32 && l1) return pwc::run_f32<16, 32>(x, k1, b1, k2, b2, k3, b3, out, B, H, W, s);
  if (dtype == pwc::kBF16 && l0) return pwc::run_bf16<3, 16>(x, k1, b1, k2, b2, k3, b3, out, B, H, W, s);
  if (dtype == pwc::kBF16 && l1) return pwc::run_bf16<16, 32>(x, k1, b1, k2, b2, k3, b3, out, B, H, W, s);
  return cudaErrorInvalidValue;
}
