// K6: backward of the fused pyramid level (K3): the cotangent chain back
// through its three convs.
//
// Replaces pwcnet_tpu/ops/pallas/pyramid_conv.py::_plevel_bwd_banded (kernel
// body _plevel_bwd_kernel_banded) and ::_plevel_bwd_pallas (body
// _plevel_bwd_kernel), which compute the same function. On the training path
// it runs 4 times per step: the two finest pyramid levels of both frames.
//
// With mask(a) = 1 where a >= 0, else 0.1, read from the saved activations
// (LeakyReLU keeps the sign), and conv^T the transpose of a conv in its input:
//
//   gz3 = g * mask(out)
//   gz2 = conv3^T(gz3) * mask(s2)
//   gz1 = conv2^T(gz2) * mask(s1)
//   dx  = conv1^T(gz1)        stride 2, the forward's bottom/right-only SAME pad
//
// gz1..gz3 (the cotangents of the three pre-activations) are outputs: the
// weight and bias gradients are plain conv weight gradients on the saved
// activations, taken outside, as the JAX package does (_dkdb_xla). Positions
// outside the level's frame hold no gradient. Sums are float32; gz1..gz3 and
// dx are rounded to the model dtype on store, and each stage reads the
// rounded cotangent the previous one stored (the same values the weight
// gradients see). dx is skipped when the caller passes null: at level 0 the
// input is the image.
//
// Design. The three cotangents are outputs, so the stages are kernels that
// hand them over through device memory (L2 holds them), not one kernel with
// halo recomputation: the TPU kernel's banded layout, lane rolls and
// H-space-to-depth dx planes have no counterpart here. A transposed 3x3
// stride-1 conv is a 3x3 conv with the taps mirrored and the channel roles
// swapped.
//
// bfloat16 (three launches at level 0, four at level 1, the weight packing
// included), on the tensor cores as K3's forward (hopper.cuh):
// - the transposed kernels are packed on the card in one launch, in the
//   wgmma B layout [K/16][tap][2][N][8]: conv3^T and conv2^T with tap 8 - t
//   and K = the forward's output channels, conv1^T with its taps as they are;
// - conv3^T (conv_t_wg_kernel<C, true>): one block of two warpgroups owns an
//   8 x 56 tile; it stages gz3 = g * mask(out) on the tile + 1-pixel halo
//   chunk-planar in shared memory as it loads g and out (16 bytes a thread),
//   writes the tile's own gz3, runs the implicit GEMM (m64 x N = C, one
//   shifted descriptor per tap, four m64 tiles in flight per warpgroup) and
//   writes gz2 = acc * mask(s2) straight from the accumulators;
// - conv2^T (conv_t_wg_kernel<C, false>): the same from gz2 to gz1;
// - conv1^T at level 1 (conv1_t_wg_kernel): with stride 2 each output pixel
//   of dx belongs to one of four phases (row and column parity); phase (py,
//   px) is a GEMM over the taps with ky & 1 = py and kx & 1 = px (4, 2, 2, 1
//   taps) of gz1 on the tile + 1-pixel halo above and left, N = 16. Level
//   0's dx (3 channels; the training path never asks for it) keeps the FMA
//   kernel below.
//
// float32 stays on FMAs (a TF32 path would change the numbers), two
// launches at level 0 and three at level 1, on conv_fma.cuh's register-
// blocked columns, as K3's float32 forward:
// - conv3^T (conv_t_col_kernel<C, true>): one block of 224 threads owns a
//   tile of 16 x 28 positions at level 0 (12 x 28 at level 1); it stages
//   gz3 = g * mask(out) on the tile + 1-pixel halo position-major in shared
//   memory (pixel stride C + 4) as it loads g and out (16 bytes a thread),
//   writes the tile's own gz3, while the weights arrive by cp.async as
//   [mirrored tap][cout of the forward][cin of the forward]; a thread then
//   sums a column of 8 (6) positions x 4 (8) channels and writes gz2 =
//   acc * mask(s2), reading s2 and writing gz2 16 bytes at a time;
// - conv2^T (conv_t_col_kernel<C, false>): the same from gz2 to gz1;
// - conv1^T at level 1 (conv1_t_col_kernel): gz1 on a 12 x 28 tile + 1
//   pixel above and left staged likewise, the weights unmirrored; a thread
//   sums a column of 6 half-res positions x 4 of dx's 16 channels for each
//   of the four phases in turn (4, 2, 2, 1 taps) and stores each pixel's
//   4 channels by one 16-byte store. Level 0's dx keeps the one-thread-a-
//   position kernel below (conv_t_s2_kernel).
// Each sum runs tap by tap (ky, then kx) and channel by channel, the order
// of the one-position-a-thread body these replaced, so the results are the
// same bits. The tiles are sized for the B=8 384x448 training step: two
// blocks an SM at level 1 (95 KB) and one wave of 256 blocks on the 132
// SMs; three at level 0 (51 KB), 768 blocks in two waves.
//
// Bound on the H100: bytes at the bf16 tensor-core rate (it reads g, out,
// s1, s2 and writes gz1..gz3 and dx: 7 half-res tensors of C channels and x;
// 2 * 2 * 9 * C * C + 2 * 9 * CIN * C operations per half-res position).
// The bf16 kernels read each staged cotangent 1.2-1.3x (the halo) and
// gz2, gz1 once more from L2; float32 is bound by its FMAs (at level 0 its
// bytes take about as long).
#include "conv_fma.cuh"
#include "hopper.cuh"

namespace pwc {

__device__ __forceinline__ float lrelu_mask(float a) { return a >= 0.f ? 1.f : 0.1f; }

// ------------------------------------------------------------ float32 on FMAs
__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 mul_mask(float4 v, float4 a) {
  return make_float4(v.x * lrelu_mask(a.x), v.y * lrelu_mask(a.y), v.z * lrelu_mask(a.z), v.w * lrelu_mask(a.w));
}

// conv3^T / conv2^T: 224 threads, 56 units (columns of R positions, two
// down each of the tile's 28 columns) x 4 channel groups (threadIdx.x % 4)
// of 4 NJ channels; the incoming cotangent's plane covers the tile + 1
// position each side, the weights follow it
template <int C>
struct FtLayout {
  static_assert(C == 16 || C == 32, "the two finest pyramid levels");
  static constexpr int kG = 4;
  static constexpr int kNJ = C / (4 * kG);    // float4s of channels a thread: 1 at level 0, 2 at level 1
  static constexpr int kR = C == 16 ? 8 : 6;  // positions a unit
  static constexpr int kTW = 28, kTH = 2 * kR;
  static constexpr int kThreads = kG * 2 * kTW;
  static constexpr int kBlocks = C == 16 ? 3 : 2;  // resident blocks an SM
  // channel groups a conv_col_tap iteration: three blocks of 7 warps leave 80
  // registers a thread, too few for two groups' loads in flight at level 0
  static constexpr int kUnroll = C == 16 ? 1 : 2;
  static constexpr int kPix = C + 4;               // pixel stride of the plane (floats)
  static constexpr int kSH = kTH + 2, kSW = kTW + 2;
  static constexpr int kW = kSH * kSW * kPix;      // the weights' offset (floats)
  static constexpr size_t kBytes = (size_t)(kW + 9 * C * C) * sizeof(float);
  static_assert(kW % 4 == 0 && kBlocks * (kBytes + 1024) <= 233472, "float4 weights; kBlocks blocks fit an SM");
};

// conv1^T at level 1: the same units over dx's 16 channels (NJ = 1), a
// 12 x 28 tile of half-res positions, gz1's plane with 1 position above and left
struct Ft1Layout {
  static constexpr int C = 32, CIN = 16;
  static constexpr int kG = 4, kR = 6, kTW = 28, kTH = 2 * kR;
  static constexpr int kThreads = kG * 2 * kTW;
  static constexpr int kBlocks = 3;
  static constexpr int kPix = C + 4;
  static constexpr int kSH = kTH + 1, kSW = kTW + 1;
  static constexpr int kW = kSH * kSW * kPix;
  static constexpr size_t kBytes = (size_t)(kW + 9 * C * CIN) * sizeof(float);
  static_assert(kW % 4 == 0 && kBlocks * (kBytes + 1024) <= 233472, "float4 weights; kBlocks blocks fit an SM");
};

// C channels of the plane positions [0, SH) x [0, SW) <- level positions
// (r0 - 1 + y, q0 - 1 + x) of src, zero outside the frame, 16 bytes a
// thread. MASK: src * mask(src_mask), and the positions of the tile
// (TH x TW from plane position (1, 1)) written to `own` as well.
template <int C, int SH, int SW, int TH, int TW, int THREADS, bool MASK>
__device__ __forceinline__ void stage_plane(float* plane, const float* __restrict__ src,
                                            const float* __restrict__ src_mask, float* __restrict__ own,
                                            size_t frame, int r0, int q0, int HH, int WH) {
  constexpr int kPix = C + 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < SH * SW * (C / 4); e += THREADS) {
    const int p = e / (C / 4), c4 = e % (C / 4);
    const int y = p / SW, x = p % SW;
    const int gy = r0 - 1 + y, gx = q0 - 1 + x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < HH && gx >= 0 && gx < WH) {
      const size_t at = (frame + (size_t)gy * WH + gx) * C + 4 * c4;
      v = ldg4(src + at);
      if constexpr (MASK) {
        v = mul_mask(v, ldg4(src_mask + at));
        if (y >= 1 && y <= TH && x >= 1 && x <= TW) *reinterpret_cast<float4*>(own + at) = v;
      }
    }
    *reinterpret_cast<float4*>(plane + p * kPix + 4 * c4) = v;
  }
}

// gz_out = conv^T(gz_in; k) * mask(act), all (B, HH, WH, C); k is the
// forward's (C, C, 3, 3) OIHW kernel. FIRST: gz_in = src * mask(src_mask),
// computed as it is staged, and the tile's own part written to gz_in_out
// (gz3); else gz_in = src.
template <int C, bool FIRST>
__global__ void __launch_bounds__(FtLayout<C>::kThreads, FtLayout<C>::kBlocks)
    conv_t_col_kernel(const float* __restrict__ src, const float* __restrict__ src_mask, const float* __restrict__ k,
                      const float* __restrict__ act, float* __restrict__ gz_in_out, float* __restrict__ gz_out,
                      int HH, int WH) {
  using L = FtLayout<C>;
  constexpr int R = L::kR, NJ = L::kNJ;
  extern __shared__ float4 ft_smem[];
  float* plane = reinterpret_cast<float*>(ft_smem);
  float* w_s = plane + L::kW;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * L::kTH;
  const int q0 = blockIdx.x * L::kTW;
  const size_t frame = (size_t)b * HH * WH;

  // ds[u, ci] = sum_{ky, kx, co} gz[u + (ky - 1, kx - 1), co] * k[co, ci, 2 - ky, 2 - kx]: a conv
  // over the mirrored taps with input channel co; the weights land while the cotangent is staged
  stage_weights_t_async<C, C, L::kThreads, true>(w_s, k);
  cp_async_commit();
  stage_plane<C, L::kSH, L::kSW, L::kTH, L::kTW, L::kThreads, FIRST>(plane, src, src_mask, gz_in_out, frame, r0,
                                                                       q0, HH, WH);
  cp_async_wait<0>();
  __syncthreads();

  const int tn = threadIdx.x % L::kG, u = threadIdx.x / L::kG;
  const int y0 = (u / L::kTW) * R, x = u % L::kTW;
  float acc[R][4 * NJ];
  conv_col_s1<C, R, NJ, L::kPix, L::kUnroll>(acc, plane + (y0 * L::kSW + x) * L::kPix, L::kSW, w_s, tn);
  const int gx = q0 + x;
  if (gx >= WH) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = r0 + y0 + r;
    if (gy >= HH) break;
    const size_t at = (frame + (size_t)gy * WH + gx) * C;
#pragma unroll
    for (int h = 0; h < NJ; ++h) {
      const int co = 4 * tn + h * (C / NJ);
      const float4 v = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
      *reinterpret_cast<float4*>(gz_out + at + co) = mul_mask(v, ldg4(act + at + co));
    }
  }
}

// dx (B, 2 HH, 2 WH, 16) = conv1^T(gz1 (B, HH, WH, 32)); k1 is (32, 16, 3, 3)
// OIHW. Phase (py, px) writes dx pixels (2 a + py, 2 c + px) from the taps
// with ky & 1 = py, kx & 1 = px, which read gz1 at (a - [ky == 2], c - [kx == 2]).
__global__ void __launch_bounds__(Ft1Layout::kThreads, Ft1Layout::kBlocks)
    conv1_t_col_kernel(const float* __restrict__ gz1, const float* __restrict__ k1, float* __restrict__ dx, int HH,
                       int WH) {
  using L = Ft1Layout;
  constexpr int C = L::C, CIN = L::CIN, R = L::kR;
  extern __shared__ float4 ft_smem[];
  float* plane = reinterpret_cast<float*>(ft_smem);
  float* w_s = plane + L::kW;  // [tap][co][ci]
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * L::kTH;
  const int q0 = blockIdx.x * L::kTW;

  stage_weights_t_async<C, CIN, L::kThreads, false>(w_s, k1);
  cp_async_commit();
  stage_plane<C, L::kSH, L::kSW, L::kTH, L::kTW, L::kThreads, false>(plane, gz1, nullptr, nullptr,
                                                                       (size_t)b * HH * WH, r0, q0, HH, WH);
  cp_async_wait<0>();
  __syncthreads();

  const int tn = threadIdx.x % L::kG, u = threadIdx.x / L::kG;
  const int y0 = (u / L::kTW) * R, x = u % L::kTW;
  const int gx = q0 + x;
#pragma unroll 1
  for (int ph = 0; ph < 4; ++ph) {
    const int py = ph / 2, px = ph % 2;
    float acc[R][4];
    zero_acc(acc);
#pragma unroll 1
    for (int ky = py; ky < 3; ky += 2)
#pragma unroll 1
      for (int kx = px; kx < 3; kx += 2)
        conv_col_tap<C, CIN, R, 1, L::kPix>(
            acc, plane + ((y0 + 1 - (ky == 2)) * L::kSW + x + 1 - (kx == 2)) * L::kPix, L::kSW,
            w_s + (ky * 3 + kx) * C * CIN + 4 * tn);
    if (gx >= WH) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gy = r0 + y0 + r;
      if (gy >= HH) break;
      *reinterpret_cast<float4*>(dx + (((size_t)b * 2 * HH + 2 * gy + py) * 2 * WH + 2 * gx + px) * CIN + 4 * tn) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// level 0's dx: one thread a half-res position
constexpr int kPlThreads = 256;
constexpr int kPlTH = 8;    // tile rows
constexpr int kPlTW = 32;   // tile columns

// dx (B, 2 HH, 2 WH, CIN) = conv1^T(gz1 (B, HH, WH, C)); k1 is (C, CIN, 3, 3) OIHW.
template <typename T, int CIN, int C>
__global__ void __launch_bounds__(kPlThreads)
    conv_t_s2_kernel(const T* __restrict__ gz1, const T* __restrict__ k1, T* __restrict__ dx, int HH,
                     int WH) {
  __shared__ float w_s[9 * C * CIN];  // [tap][co][ci]
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int a = blockIdx.y * kPlTH + tid / kPlTW;
  const int c = blockIdx.x * kPlTW + tid % kPlTW;
  for (int i = tid; i < 9 * C * CIN; i += kPlThreads) {
    const int ci = i % CIN;
    const int co = (i / CIN) % C;
    const int tap = i / (CIN * C);
    w_s[i] = to_f32(k1[(co * CIN + ci) * 9 + tap]);
  }
  __syncthreads();
  if (a >= HH || c >= WH) return;

  float acc[4][CIN];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) acc[q][ci] = 0.f;
  const T* gzb = gz1 + (size_t)b * HH * WH * C;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int gy = a - (ky == 2 ? 1 : 0);  // x row 2 gy + ky = 2 a + (ky & 1)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int gx = c - (kx == 2 ? 1 : 0);
      if (gy < 0 || gx < 0) continue;
      const T* src = gzb + ((size_t)gy * WH + gx) * C;
      const float* w = w_s + (ky * 3 + kx) * C * CIN;
      float(&dst)[CIN] = acc[(ky & 1) * 2 + (kx & 1)];
#pragma unroll 4
      for (int co = 0; co < C; ++co) {
        const float v = to_f32(src[co]);
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) dst[ci] = fmaf(v, w[co * CIN + ci], dst[ci]);
      }
    }
  }
  const int W = 2 * WH;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    T* out = dx + (((size_t)b * 2 * HH + 2 * a + q / 2) * W + 2 * c + q % 2) * CIN;
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) out[ci] = from_f32<T>(acc[q][ci]);
  }
}

template <int CIN, int C>
cudaError_t run_f32(const void* g, const void* out, const void* s1, const void* s2, const void* k1,
                    const void* k2, const void* k3, void* gz1, void* gz2, void* gz3, void* dx, int B, int H,
                    int W, cudaStream_t stream) {
  using L = FtLayout<C>;
  const int HH = H / 2, WH = W / 2;
  // 16-byte accesses to every activation and cotangent
  const void* ptrs[] = {g, out, s1, s2, gz1, gz2, gz3, dx};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorInvalidValue;
  auto k_first = conv_t_col_kernel<C, true>;
  auto k_next = conv_t_col_kernel<C, false>;
  cudaError_t err = cudaFuncSetAttribute(k_first, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_next, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((WH + L::kTW - 1) / L::kTW, (HH + L::kTH - 1) / L::kTH, B);
  auto z1 = static_cast<float*>(gz1);
  auto z2 = static_cast<float*>(gz2);
  k_first<<<grid, L::kThreads, L::kBytes, stream>>>(static_cast<const float*>(g), static_cast<const float*>(out),
                                                     static_cast<const float*>(k3), static_cast<const float*>(s2),
                                                     static_cast<float*>(gz3), z2, HH, WH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_next<<<grid, L::kThreads, L::kBytes, stream>>>(z2, nullptr, static_cast<const float*>(k2),
                                                    static_cast<const float*>(s1), nullptr, z1, HH, WH);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return err;
  if constexpr (CIN == 16) {
    using L1 = Ft1Layout;
    err = cudaFuncSetAttribute(conv1_t_col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L1::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid1((WH + L1::kTW - 1) / L1::kTW, (HH + L1::kTH - 1) / L1::kTH, B);
    conv1_t_col_kernel<<<grid1, L1::kThreads, L1::kBytes, stream>>>(z1, static_cast<const float*>(k1),
                                                                     static_cast<float*>(dx), HH, WH);
  } else {
    const dim3 grid_fma((WH + kPlTW - 1) / kPlTW, (HH + kPlTH - 1) / kPlTH, B);
    conv_t_s2_kernel<float, CIN, C><<<grid_fma, kPlThreads, 0, stream>>>(z1, static_cast<const float*>(k1),
                                                                         static_cast<float*>(dx), HH, WH);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------ bfloat16 on wgmma
using bf16 = __nv_bfloat16;

constexpr int kBwTH = 8;        // output rows per block
constexpr int kBwTW = 56;       // output columns per block: 224 and 112 are whole tiles
constexpr int kBwP = kBwTW + 2;   // plane pitch of the stride-1 transposes (1-pixel halo each side)
constexpr int kBwP1 = kBwTW + 1;  // conv1^T: 1-pixel halo above and left
constexpr int kBwThreads = 256;   // two warpgroups
constexpr int kBwTiles = 4;       // m64 tiles a warpgroup keeps in flight

// conv3^T / conv2^T: the incoming cotangent's planes [C/8][kInPos][8], then the packed weights
template <int C>
struct BwLayout {
  static constexpr int kN = round_up(kBwTH * kBwP, 64);  // GEMM rows: flat output positions
  static constexpr int kInPos = round_up(imax(kN + 2 * kBwP + 2, (kBwTH + 2) * kBwP), 8);
  static constexpr int kInBytes = C / 8 * kInPos * 16;
  static constexpr int kWBytes = 9 * C * C * 2;
  static constexpr int kBytes = kInBytes + kWBytes;
};

// conv1^T: gz1's planes (C channels), then the packed weights (K = C, N = 16)
template <int C>
struct Bw1Layout {
  static constexpr int kN = round_up(kBwTH * kBwP1, 64);
  static constexpr int kInPos = round_up(imax(kN + kBwP1 + 1, (kBwTH + 1) * kBwP1), 8);
  static constexpr int kInBytes = C / 8 * kInPos * 16;
  static constexpr int kWBytes = 9 * C * 16 * 2;
  static constexpr int kBytes = kInBytes + kWBytes;
};

// 16-byte copies of the packed weights into shared memory
__device__ __forceinline__ void stage_packed(unsigned char* dst, const bf16* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// 8 bf16 values of g times mask(8 bf16 values of a), rounded
__device__ __forceinline__ uint4 masked(uint4 g, uint4 a) {
  const auto* gp = reinterpret_cast<const __nv_bfloat162*>(&g);
  const auto* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
  uint4 r;
  auto* rp = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 gf = __bfloat1622float2(gp[k]);
    const float2 af = __bfloat1622float2(ap[k]);
    rp[k] = __floats2bfloat162_rn(gf.x * lrelu_mask(af.x), gf.y * lrelu_mask(af.y));
  }
  return r;
}

// gz_out = conv^T(gz_in; w) * mask(act) on an 8 x 56 tile, all (B, HH, WH, C).
// FIRST: gz_in = src * mask(src_mask), computed as it is staged, and the
// tile's own part written to gz_in_out (gz3); else gz_in = src.
template <int C, bool FIRST>
__global__ void __launch_bounds__(kBwThreads)
    conv_t_wg_kernel(const bf16* __restrict__ src, const bf16* __restrict__ src_mask, const bf16* __restrict__ w,
                     const bf16* __restrict__ act, bf16* __restrict__ gz_in_out, bf16* __restrict__ gz_out, int HH,
                     int WH) {
  using L = BwLayout<C>;
  extern __shared__ __align__(128) unsigned char bw_smem[];
  const uint32_t sbase = smem_u32(bw_smem);
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kBwTH;
  const int q0 = blockIdx.x * kBwTW;
  const size_t frame = (size_t)b * HH * WH;

  stage_packed(bw_smem + L::kInBytes, w, L::kWBytes);
  // plane position (y, x) is level position (r0 - 1 + y, q0 - 1 + x); zero outside the frame
  for (int e = threadIdx.x; e < C / 8 * L::kInPos; e += kBwThreads) {
    const int ch = e / L::kInPos, p = e % L::kInPos;
    const int y = p / kBwP, x = p % kBwP;
    const int gy = r0 - 1 + y, gx = q0 - 1 + x;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y < kBwTH + 2 && gy >= 0 && gy < HH && gx >= 0 && gx < WH) {
      const size_t at = (frame + (size_t)gy * WH + gx) * C + ch * 8;
      v = *reinterpret_cast<const uint4*>(src + at);
      if constexpr (FIRST) {
        v = masked(v, *reinterpret_cast<const uint4*>(src_mask + at));
        if (y >= 1 && y <= kBwTH && x >= 1 && x <= kBwTW) *reinterpret_cast<uint4*>(gz_in_out + at) = v;
      }
    }
    *reinterpret_cast<uint4*>(bw_smem + (size_t)e * 16) = v;
  }
  fence_proxy_async();
  __syncthreads();

  const int t = threadIdx.x % 128;
  conv_wgmma_tiles<C, C / 16, kBwThreads / 128, kBwTiles>(
      L::kN, L::kInPos * 16, sbase + L::kInBytes,
      [&](int tap, int ks) { return sbase + (uint32_t)(2 * ks * L::kInPos + (tap / 3) * kBwP + tap % 3) * 16; },
      [&](int p0, const float(&acc)[C / 2]) {
#pragma unroll
        for (int i = 0; i < C / 2; i += 2) {
          const int p = p0 + acc_row(t, i), c = acc_col(t, i);
          const int y = p / kBwP, x = p % kBwP;
          const int gy = r0 + y, gx = q0 + x;
          if (y < kBwTH && x < kBwTW && gy < HH && gx < WH) {
            const size_t at = (frame + (size_t)gy * WH + gx) * C + c;
            const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(act + at));
            *reinterpret_cast<__nv_bfloat162*>(gz_out + at) =
                __floats2bfloat162_rn(acc[i] * lrelu_mask(a.x), acc[i + 1] * lrelu_mask(a.y));
          }
        }
      });
}

// dx (B, 2 HH, 2 WH, 16) = conv1^T(gz1 (B, HH, WH, C)) as four phase GEMMs:
// phase (py, px) writes dx pixels (2 a + py, 2 c + px) from the taps with
// ky & 1 = py, kx & 1 = px, which read gz1 at (a - [ky == 2], c - [kx == 2]).
template <int C>
__global__ void __launch_bounds__(kBwThreads)
    conv1_t_wg_kernel(const bf16* __restrict__ gz1, const bf16* __restrict__ w, bf16* __restrict__ dx, int HH,
                      int WH) {
  using L = Bw1Layout<C>;
  constexpr int N = 16;
  extern __shared__ __align__(128) unsigned char bw_smem[];
  const uint32_t sbase = smem_u32(bw_smem);
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kBwTH;
  const int q0 = blockIdx.x * kBwTW;

  stage_packed(bw_smem + L::kInBytes, w, L::kWBytes);
  // plane position (y, x) is level position (r0 - 1 + y, q0 - 1 + x)
  for (int e = threadIdx.x; e < C / 8 * L::kInPos; e += kBwThreads) {
    const int ch = e / L::kInPos, p = e % L::kInPos;
    const int y = p / kBwP1, x = p % kBwP1;
    const int gy = r0 - 1 + y, gx = q0 - 1 + x;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y < kBwTH + 1 && gy >= 0 && gy < HH && gx >= 0 && gx < WH)
      v = *reinterpret_cast<const uint4*>(gz1 + (((size_t)b * HH + gy) * WH + gx) * C + ch * 8);
    *reinterpret_cast<uint4*>(bw_smem + (size_t)e * 16) = v;
  }
  fence_proxy_async();
  __syncthreads();

  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  constexpr int kWgs = kBwThreads / 128;
  constexpr int kTiles = L::kN / 64;
  for (int j0 = g; j0 < kTiles; j0 += kWgs * kBwTiles) {
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const int py = ph / 2, px = ph % 2;
      float acc[kBwTiles][N / 2];
#pragma unroll
      for (int m = 0; m < kBwTiles; ++m) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
        acc_fence(acc[m]);
      }
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
#pragma unroll
        for (int ky = py; ky < 3; ky += 2)
#pragma unroll
          for (int kx = px; kx < 3; kx += 2) {
            const uint64_t db = wg_desc(sbase + L::kInBytes + (ks * 9 + ky * 3 + kx) * 2 * N * 16, N * 16, 128);
            const int shift = (ky == 2 ? 0 : kBwP1) + (kx == 2 ? 0 : 1);
#pragma unroll
            for (int m = 0; m < kBwTiles; ++m)
              if (j0 + kWgs * m < kTiles)
                Wgmma<N>::mma(acc[m],
                              wg_desc(sbase + (uint32_t)(2 * ks * L::kInPos + shift + 64 * (j0 + kWgs * m)) * 16,
                                      L::kInPos * 16, 128),
                              db);
          }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int m = 0; m < kBwTiles; ++m) {
        acc_fence(acc[m]);
        if (j0 + kWgs * m >= kTiles) continue;
#pragma unroll
        for (int i = 0; i < N / 2; i += 2) {
          const int p = 64 * (j0 + kWgs * m) + acc_row(t, i), c = acc_col(t, i);
          const int y = p / kBwP1, x = p % kBwP1;
          const int gy = r0 + y, gx = q0 + x;
          if (y < kBwTH && x < kBwTW && gy < HH && gx < WH)
            *reinterpret_cast<__nv_bfloat162*>(
                dx + (((size_t)b * 2 * HH + 2 * gy + py) * 2 * WH + 2 * gx + px) * N + c) =
                __floats2bfloat162_rn(acc[m][i], acc[m][i + 1]);
        }
      }
    }
  }
}

template <int CIN, int C>
cudaError_t run_bf16(const void* g, const void* out, const void* s1, const void* s2, const void* k1,
                     const void* k2, const void* k3, void* gz1, void* gz2, void* gz3, void* dx, void* packed,
                     int B, int H, int W, cudaStream_t stream) {
  using L = BwLayout<C>;
  using L1 = Bw1Layout<C>;
  const int HH = H / 2, WH = W / 2;
  const bool dx_wg = dx != nullptr && CIN == 16;  // level 1's dx on wgmma
  PackJobs jobs{};
  auto* dst = static_cast<bf16*>(packed);
  jobs.job[0] = {static_cast<const bf16*>(k3), dst, C, C, C, 0, 1};
  dst += packed_elems(jobs.job[0]);
  jobs.job[1] = {static_cast<const bf16*>(k2), dst, C, C, C, 0, 1};
  dst += packed_elems(jobs.job[1]);
  jobs.job[2] = {static_cast<const bf16*>(k1), dst, C, CIN, 16, 0, 2};
  cudaError_t err = pack_weights(jobs, dx_wg ? 3 : 2, stream);
  if (err != cudaSuccess) return err;
  auto k_first = conv_t_wg_kernel<C, true>;
  auto k_next = conv_t_wg_kernel<C, false>;
  err = cudaFuncSetAttribute(k_first, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(k_next, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((WH + kBwTW - 1) / kBwTW, (HH + kBwTH - 1) / kBwTH, B);
  auto z1 = static_cast<bf16*>(gz1);
  auto z2 = static_cast<bf16*>(gz2);
  k_first<<<grid, kBwThreads, L::kBytes, stream>>>(static_cast<const bf16*>(g), static_cast<const bf16*>(out),
                                                   jobs.job[0].dst, static_cast<const bf16*>(s2),
                                                   static_cast<bf16*>(gz3), z2, HH, WH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_next<<<grid, kBwThreads, L::kBytes, stream>>>(z2, nullptr, jobs.job[1].dst, static_cast<const bf16*>(s1),
                                                  nullptr, z1, HH, WH);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return err;
  if (dx_wg) {
    auto k1t = conv1_t_wg_kernel<C>;
    err = cudaFuncSetAttribute(k1t, cudaFuncAttributeMaxDynamicSharedMemorySize, L1::kBytes);
    if (err != cudaSuccess) return err;
    k1t<<<grid, kBwThreads, L1::kBytes, stream>>>(z1, jobs.job[2].dst, static_cast<bf16*>(dx), HH, WH);
  } else {
    const dim3 grid_fma((WH + kPlTW - 1) / kPlTW, (HH + kPlTH - 1) / kPlTH, B);
    conv_t_s2_kernel<bf16, CIN, C><<<grid_fma, kPlThreads, 0, stream>>>(z1, static_cast<const bf16*>(k1),
                                                                       static_cast<bf16*>(dx), HH, WH);
  }
  return cudaGetLastError();
}

}  // namespace pwc

// g, out, s1, s2, gz1, gz2, gz3: (B, H/2, W/2, c); k1: (c, cin, 3, 3); k2, k3: (c, c, 3, 3)
// (OIHW); dx: (B, H, W, cin) or null; packed: bfloat16 scratch for the transposed kernels,
// 2 * 2304 elements at level 0, 2 * 9216 + 4608 at level 1 (unused in float32). H, W even.
// All contiguous and of one dtype: 0 f32 / 1 bf16. (cin, c) is (3, 16) or (16, 32), as in the
// forward.
extern "C" int pwc_pyramid_level_bwd(const void* g, const void* out, const void* s1, const void* s2,
                                     const void* k1, const void* k2, const void* k3, void* gz1,
                                     void* gz2, void* gz3, void* dx, void* packed, int B, int H, int W,
                                     int cin, int c, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool l0 = cin == 3 && c == 16;
  const bool l1 = cin == 16 && c == 32;
#define PWC_BWD_ARGS g, out, s1, s2, k1, k2, k3, gz1, gz2, gz3, dx
  if (dtype == pwc::kF32 && l0) return pwc::run_f32<3, 16>(PWC_BWD_ARGS, B, H, W, s);
  if (dtype == pwc::kF32 && l1) return pwc::run_f32<16, 32>(PWC_BWD_ARGS, B, H, W, s);
  if (dtype == pwc::kBF16 && l0) return pwc::run_bf16<3, 16>(PWC_BWD_ARGS, packed, B, H, W, s);
  if (dtype == pwc::kBF16 && l1) return pwc::run_bf16<16, 32>(PWC_BWD_ARGS, packed, B, H, W, s);
#undef PWC_BWD_ARGS
  return cudaErrorInvalidValue;
}

// The transpose of one OIHW bf16 kernel (cout, cin, 3, 3) packed into `dst` as K6 packs it (K = cout,
// N = cin; taps mirrored when `mirror`): for holding the layout against its PyTorch version.
extern "C" int pwc_pack_wgmma_transposed(const void* k, void* dst, int cout, int cin, int mirror, void* stream) {
  const int n = pwc::wgmma_n(cin);
  if (n == 0) return cudaErrorInvalidValue;
  pwc::PackJobs jobs{};
  jobs.job[0] = {static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(dst), cout, cin, n, 0,
                 mirror ? 1 : 2};
  return pwc::pack_weights(jobs, 1, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of the bf16 kernels of a level (conv^T, conv1^T), for the build log
extern "C" int pwc_pyramid_level_bwd_smem_bytes(int c, int conv1) {
  if (c == 16) return conv1 ? 0 : pwc::BwLayout<16>::kBytes;
  if (c == 32) return conv1 ? pwc::Bw1Layout<32>::kBytes : pwc::BwLayout<32>::kBytes;
  return 0;
}

// a float32 kernel of a level, for the build log: `which` 0 conv3^T (gz3
// folded in), 1 conv2^T, 2 conv1^T (c = 32); its dynamic shared memory,
// threads and resident blocks an SM
template <typename L, typename Kernel>
static cudaError_t f32_info(Kernel kernel, int* smem, int* threads, int* blocks) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  *smem = (int)L::kBytes;
  *threads = L::kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, L::kThreads, L::kBytes);
}

extern "C" int pwc_pyramid_level_bwd_f32_info(int c, int which, int* smem, int* threads, int* blocks) {
  using pwc::FtLayout;
  if (c == 16 && which == 0) return f32_info<FtLayout<16>>(pwc::conv_t_col_kernel<16, true>, smem, threads, blocks);
  if (c == 16 && which == 1) return f32_info<FtLayout<16>>(pwc::conv_t_col_kernel<16, false>, smem, threads, blocks);
  if (c == 32 && which == 0) return f32_info<FtLayout<32>>(pwc::conv_t_col_kernel<32, true>, smem, threads, blocks);
  if (c == 32 && which == 1) return f32_info<FtLayout<32>>(pwc::conv_t_col_kernel<32, false>, smem, threads, blocks);
  if (c == 32 && which == 2) return f32_info<pwc::Ft1Layout>(pwc::conv1_t_col_kernel, smem, threads, blocks);
  return cudaErrorInvalidValue;
}
