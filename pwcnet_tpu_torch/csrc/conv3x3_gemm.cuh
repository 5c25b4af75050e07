// One 3x3 stride-1 SAME convolution as an implicit GEMM with a fused
// epilogue, the building block of K7 (estimator_conv.cu) and its backward
// (estimator_conv_bwd.cu):
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
// - float32 (conv3x3_fma_kernel): CUDA-core FMAs. A block of 256 threads
//   owns 8 x 16 positions and 64 output channels; a thread one column of 8
//   positions and 4 channels (32 sums in registers). Input channels go by in
//   chunks of 8: the tile + 1 halo is staged channel-major, the weights as
//   [tap][ci][co]; per (ci, kx) a thread loads 10 inputs and 3 float4s of
//   weights for 96 FMAs.
// - bfloat16 (conv3x3_tc_kernel): tensor cores, WMMA 16x16x16 with float32
//   accumulation. A block owns 16 x 16 positions and 64 output channels; each
//   of its 8 warps two rows of 16 positions (2 x 4 accumulator fragments).
//   Input channels go by in chunks of 16: the tile + 1 halo is staged
//   position-major [18][18][16], so the A tile of one tap is 16 consecutive
//   positions of 16 channels; the weights [tap][16][64] are the B tiles.
//   Chunks are double-buffered: 16-byte cp.async copies bring chunk k + 1
//   from device memory (zero-filled outside the frame) while the tensor
//   cores multiply chunk k; two blocks share an SM. Where Cin is no multiple
//   of 8 (the chain's first conv, 147..273 wide, and the 2-channel flow
//   cotangent) a pixel's channels do not start on 16 bytes, and the inputs of
//   that conv are staged element by element instead. With `flip` the weight
//   tile is staged [tap][64][16] and read as column-major B tiles. The sums
//   leave through a per-warp float32 scratch that reuses the staging memory.
#pragma once

#include <mma.h>

#include <type_traits>

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

// ------------------------------------------------------------ bfloat16 tensor cores
constexpr int kTcT = 16;            // tile rows and columns
constexpr int kTcI = kTcT + 2;      // staged rows and columns
constexpr int kTcKC = 16;           // input channels per chunk (one WMMA depth)
constexpr int kTcWS = kCgTN + 8;    // weight row stride in shared memory: off the 128-byte bank period
constexpr int kTcWT = kTcKC + 8;    // the same for the transposed tile [64][16]
constexpr int kTcWarps = kCgThreads / 32;
constexpr int kTcInElems = kTcI * kTcI * kTcKC;
constexpr int kTcWElems = 9 * kCgTN * kTcWT;  // the larger of the two tiles
static_assert(kTcWElems >= 9 * kTcKC * kTcWS, "the weight stage holds either tile");
constexpr int kTcStageElems = kTcInElems + kTcWElems;
constexpr size_t kTcScratchBytes = (size_t)kTcWarps * 16 * kCgTN * sizeof(float);
constexpr size_t kTcStageBytes = (size_t)2 * kTcStageElems * sizeof(__nv_bfloat16);  // two buffers
constexpr size_t kTcSmemBytes = kTcScratchBytes > kTcStageBytes ? kTcScratchBytes : kTcStageBytes;
static_assert((kTcInElems * sizeof(__nv_bfloat16)) % 32 == 0, "WMMA tiles start on 32 bytes");
static_assert((kTcStageElems * sizeof(__nv_bfloat16)) % 32 == 0, "WMMA tiles start on 32 bytes");

// 16 bytes from device to shared memory without passing through registers;
// an invalid source writes zeros (zero bytes are read from `gmem`).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldw is a multiple of 8 and every tensor starts on 16 bytes, so a weight
// row goes as 16-byte copies, and so do a pixel's channels where Cin is a
// multiple of 8.
template <bool kFlip>
__global__ void __launch_bounds__(kCgThreads, 2) conv3x3_tc_kernel(ConvArgs a) {
  using bf16 = __nv_bfloat16;
  namespace wmma = nvcuda::wmma;
  extern __shared__ float4 cg_smem_f4[];
  // 2 x ([18][18][16] inputs, [9][16][72] weights or, transposed, [9][64][24])
  bf16* stage = reinterpret_cast<bf16*>(cg_smem_f4);

  const int tiles_x = (a.W + kTcT - 1) / kTcT;
  const int ty0 = (blockIdx.x / tiles_x) * kTcT;
  const int tx0 = (blockIdx.x % tiles_x) * kTcT;
  const int n0 = blockIdx.y * kCgTN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* in = static_cast<const bf16*>(a.in) + (size_t)b * a.H * a.W * a.Cin;
  const bf16* wt = static_cast<const bf16*>(a.wt);
  // 16-wide groups of output channels this block really has
  const int nt_live = min(kCgTN / 16, (a.Cout - n0 + 15) / 16);
  const bool in_by_16_bytes = a.Cin % 8 == 0;

  auto load_chunk = [&](int c0, bf16* in_s) {
    bf16* w_s = in_s + kTcInElems;
    for (int i = tid; i < kTcI * kTcI * (kTcKC / 8); i += kCgThreads) {
      const int v = i % (kTcKC / 8);
      const int p = i / (kTcKC / 8);
      const int gy = ty0 - 1 + p / kTcI;
      const int gx = tx0 - 1 + p % kTcI;
      const int c = c0 + v * 8;
      const bool ok = c < a.Cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const bf16* src = in + ((size_t)gy * a.W + gx) * a.Cin + c;
      bf16* dst = in_s + p * kTcKC + v * 8;
      if (in_by_16_bytes) {
        cp_async16(dst, ok ? src : in, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = ok && c + j < a.Cin ? src[j] : from_f32<bf16>(0.f);
      }
    }
    if constexpr (kFlip) {
      for (int i = tid; i < 9 * kCgTN * (kTcKC / 8); i += kCgThreads) {
        const int v = i % (kTcKC / 8);
        const int n = (i / (kTcKC / 8)) % kCgTN;
        const int tap = i / (kTcKC / 8 * kCgTN);
        const int c = c0 + v * 8;
        const bool ok = c < a.ldw && n0 + n < a.Cout;
        cp_async16(w_s + (tap * kCgTN + n) * kTcWT + v * 8,
                   ok ? wt + ((size_t)(8 - tap) * a.Cout + n0 + n) * a.ldw + c : wt, ok);
      }
    } else {
      for (int i = tid; i < 9 * kTcKC * (kCgTN / 8); i += kCgThreads) {
        const int v = i % (kCgTN / 8);
        const int ci = (i / (kCgTN / 8)) % kTcKC;
        const int tap = i / (kCgTN / 8 * kTcKC);
        const int co = n0 + v * 8;
        const bool ok = c0 + ci < a.Cin && co < a.ldw;
        cp_async16(w_s + (tap * kTcKC + ci) * kTcWS + v * 8,
                   ok ? wt + ((size_t)tap * a.Cin + c0 + ci) * a.ldw + co : wt, ok);
      }
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kCgTN / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < kCgTN / 16; ++nt) wmma::fill_fragment(acc[i][nt], 0.f);

  const int chunks = (a.Cin + kTcKC - 1) / kTcKC;
  load_chunk(0, stage);
  for (int k = 0; k < chunks; ++k) {
    const bf16* in_s = stage + (k & 1) * kTcStageElems;
    const bf16* w_s = in_s + kTcInElems;
    if (k + 1 < chunks) {  // the next chunk travels while this one is multiplied
      load_chunk((k + 1) * kTcKC, stage + ((k + 1) & 1) * kTcStageElems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], in_s + ((2 * warp + i + tap / 3) * kTcI + tap % 3) * kTcKC,
                               kTcKC);
#pragma unroll
      for (int nt = 0; nt < kCgTN / 16; ++nt) {
        if (nt < nt_live) {
          using BLayout = std::conditional_t<kFlip, wmma::col_major, wmma::row_major>;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
          if constexpr (kFlip)
            wmma::load_matrix_sync(fb, w_s + (tap * kCgTN + nt * 16) * kTcWT, kTcWT);
          else
            wmma::load_matrix_sync(fb, w_s + tap * kTcKC * kTcWS + nt * 16, kTcWS);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][nt], fa[i], fb, acc[i][nt]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks on; after the last chunk it becomes scratch
  }

  float* scratch = reinterpret_cast<float*>(cg_smem_f4) + warp * 16 * kCgTN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int nt = 0; nt < kCgTN / 16; ++nt)
      wmma::store_matrix_sync(scratch + nt * 16, acc[i][nt], kCgTN, wmma::mem_row_major);
    __syncwarp();
    const int gy = ty0 + 2 * warp + i;
    if (gy < a.H) {
      for (int e = lane; e < 16 * kCgTN; e += 32) {
        const int m = e / kCgTN;
        const int co = n0 + e % kCgTN;
        const int gx = tx0 + m;
        if (gx < a.W && co < a.Cout)
          conv_epilogue<bf16>(a, ((size_t)b * a.H + gy) * a.W + gx, co, scratch[e]);
      }
    }
    __syncwarp();  // scratch is reused for this warp's second row
  }
}

// The tensor-core kernels take more dynamic shared memory than the default
// limit, which is allowed once per device. The flag has internal linkage: a
// function's static would be one object for every library that includes
// this header, each of which holds kernels of its own.
constexpr int kTcMaxDevices = 64;
static bool tc_smem_allowed[kTcMaxDevices] = {};

template <typename T>
struct ConvLaunch;

template <>
struct ConvLaunch<float> {
  static cudaError_t run(const ConvArgs& a, int B, cudaStream_t stream) {
    const dim3 grid(((a.W + kFmTW - 1) / kFmTW) * ((a.H + kFmTH - 1) / kFmTH),
                    (a.Cout + kCgTN - 1) / kCgTN, B);
    conv3x3_fma_kernel<float><<<grid, kCgThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
};

template <>
struct ConvLaunch<__nv_bfloat16> {
  static cudaError_t run(const ConvArgs& a, int B, cudaStream_t stream) {
    const dim3 grid(((a.W + kTcT - 1) / kTcT) * ((a.H + kTcT - 1) / kTcT),
                    (a.Cout + kCgTN - 1) / kCgTN, B);
    if (a.ldw % 8 != 0) return cudaErrorInvalidValue;  // 16-byte copies
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kTcMaxDevices || !tc_smem_allowed[device]) {
      err = cudaFuncSetAttribute(conv3x3_tc_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemBytes);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(conv3x3_tc_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemBytes);
      if (err != cudaSuccess) return err;
      if (device < kTcMaxDevices) tc_smem_allowed[device] = true;
    }
    if (a.flip)
      conv3x3_tc_kernel<true><<<grid, kCgThreads, kTcSmemBytes, stream>>>(a);
    else
      conv3x3_tc_kernel<false><<<grid, kCgThreads, kTcSmemBytes, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace pwc
