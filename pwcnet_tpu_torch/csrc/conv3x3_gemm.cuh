// One 3x3 stride-1 SAME convolution as an implicit GEMM with a fused
// epilogue, the building block of K7's float32 forward (estimator_conv.cu)
// and of its backward (estimator_conv_bwd.cu, which adds its bf16 kernel):
//
//   acc[p, co] = sum_{tap, ci} in[p + tap - (1, 1), ci] * wt[tap', ci, co]
//   v = acc (+ bias[co]) ; (LeakyReLU(0.1)) ; (+ add[p, co]) ; (* mask(act[p, co]))
//   out[p, co] = round(v)
//
// with in (B, H, W, Cin) and out, add, act (B, H, W, Cout), NHWC, and the
// weights tap-major [9][Cin][ldw], ldw = Cout rounded up to a multiple of 8
// with a zero tail. A transposed 3x3 conv is a 3x3 conv with the taps
// mirrored and the channel roles swapped, so the backward passes the very
// array of the forward, which for it reads [9][Cout][ldw] with ldw = Cin
// rounded up, and sets `flip`: tap' is then 8 - tap and the weight tile is
// read transposed.
// mask(a) is 1 where a >= 0, else 0.1 (the LeakyReLU's slope read from its
// saved output). Positions outside the frame read as zero: that is each
// conv's own zero padding of its input. Sums are float32; the result is
// rounded to the model dtype on store.
//
// Channel counts are run-time values (the estimator's inputs are 147..273
// wide, its outputs 128, 128, 96, 64, 32, 2); ragged edges in channels and
// in space are masked when a tile is staged and when it is stored.
//
// float32 (conv3x3_fma_kernel): CUDA-core FMAs. A block of 256 threads owns
// 8 x 16 positions and 64 output channels; a thread one column of 8
// positions and 4 channels (32 sums in registers). Input channels go by in
// chunks of 8: the tile + 1 halo is staged channel-major, the weights as
// [tap][ci][co]; per (ci, kx) a thread loads 10 inputs and 3 float4s of
// weights for 96 FMAs.
#pragma once

#include "common.cuh"

namespace pwc {

constexpr int kCgThreads = 256;
constexpr int kCgTN = 64;  // output channels per block

struct ConvArgs {
  const void* in;
  const void* wt;
  const void* bias;  // (Cout,) or null
  const void* add;   // (B, H, W, Cout) or null
  const void* act;   // (B, H, W, Cout) or null
  void* out;
  int H, W, Cin, Cout;
  int ldw;  // row stride of wt, a multiple of 8 with a zero tail: Cout rounded up, with flip Cin
  int relu;
  int flip;
};

template <typename T>
__device__ __forceinline__ void conv_epilogue(const ConvArgs& a, size_t pixel, int co, float v) {
  if (a.bias != nullptr) v += to_f32(static_cast<const T*>(a.bias)[co]);
  if (a.relu) v = leaky(v);
  const size_t at = pixel * a.Cout + co;
  if (a.add != nullptr) v += to_f32(static_cast<const T*>(a.add)[at]);
  if (a.act != nullptr) v *= to_f32(static_cast<const T*>(a.act)[at]) >= 0.f ? 1.f : 0.1f;
  static_cast<T*>(a.out)[at] = from_f32<T>(v);
}

// ------------------------------------------------------------ float32 FMAs
constexpr int kFmTH = 8, kFmTW = 16;              // tile rows, columns
constexpr int kFmIH = kFmTH + 2, kFmIW = kFmTW + 2;
constexpr int kFmKC = 8;                          // input channels per chunk
constexpr int kFmWS = kCgTN + 4;                  // weight row stride: the transposed staging hits 32 banks

template <typename T>
__global__ void __launch_bounds__(kCgThreads) conv3x3_fma_kernel(ConvArgs a) {
  __shared__ float in_s[kFmKC][kFmIH][kFmIW];
  __shared__ __align__(16) float w_s[9][kFmKC][kFmWS];

  const int tiles_x = (a.W + kFmTW - 1) / kFmTW;
  const int ty0 = (blockIdx.x / tiles_x) * kFmTH;
  const int tx0 = (blockIdx.x % tiles_x) * kFmTW;
  const int n0 = blockIdx.y * kCgTN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tm = tid % kFmTW;  // column of the tile
  const int tn = tid / kFmTW;  // group of 4 output channels
  const T* in = static_cast<const T*>(a.in) + (size_t)b * a.H * a.W * a.Cin;
  const T* wt = static_cast<const T*>(a.wt);

  float acc[kFmTH][4];
#pragma unroll
  for (int r = 0; r < kFmTH; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += kFmKC) {
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < kFmKC * kFmIH * kFmIW; i += kCgThreads) {
      const int ci = i % kFmKC;
      const int p = i / kFmKC;
      const int gy = ty0 - 1 + p / kFmIW;
      const int gx = tx0 - 1 + p % kFmIW;
      float v = 0.f;
      if (c0 + ci < a.Cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
        v = to_f32(in[((size_t)gy * a.W + gx) * a.Cin + c0 + ci]);
      in_s[ci][p / kFmIW][p % kFmIW] = v;
    }
    for (int i = tid; i < 9 * kFmKC * kCgTN; i += kCgThreads) {
      const int tap = i / (kCgTN * kFmKC);
      // the fastest index follows the array's last dimension
      const int co = a.flip ? (i / kFmKC) % kCgTN : i % kCgTN;
      const int ci = a.flip ? i % kFmKC : (i / kCgTN) % kFmKC;
      float v = 0.f;
      if (c0 + ci < a.Cin && n0 + co < a.Cout)
        v = to_f32(a.flip ? wt[((size_t)(8 - tap) * a.Cout + n0 + co) * a.ldw + c0 + ci]
                          : wt[((size_t)tap * a.Cin + c0 + ci) * a.ldw + n0 + co]);
      w_s[tap][ci][co] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < kFmKC; ++ci) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float col[kFmIH];
#pragma unroll
        for (int r = 0; r < kFmIH; ++r) col[r] = in_s[ci][r][tm + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4 w4 = *reinterpret_cast<const float4*>(&w_s[ky * 3 + kx][ci][tn * 4]);
#pragma unroll
          for (int r = 0; r < kFmTH; ++r) {
            const float v = col[r + ky];
            acc[r][0] = fmaf(v, w4.x, acc[r][0]);
            acc[r][1] = fmaf(v, w4.y, acc[r][1]);
            acc[r][2] = fmaf(v, w4.z, acc[r][2]);
            acc[r][3] = fmaf(v, w4.w, acc[r][3]);
          }
        }
      }
    }
  }

  const int gx = tx0 + tm;
  if (gx >= a.W) return;
#pragma unroll
  for (int r = 0; r < kFmTH; ++r) {
    const int gy = ty0 + r;
    if (gy >= a.H) break;
    const size_t pixel = ((size_t)b * a.H + gy) * a.W + gx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tn * 4 + j;
      if (co < a.Cout) conv_epilogue<T>(a, pixel, co, acc[r][j]);
    }
  }
}

inline cudaError_t conv3x3_f32(const ConvArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(((a.W + kFmTW - 1) / kFmTW) * ((a.H + kFmTH - 1) / kFmTH), (a.Cout + kCgTN - 1) / kCgTN, B);
  conv3x3_fma_kernel<float><<<grid, kCgThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pwc
