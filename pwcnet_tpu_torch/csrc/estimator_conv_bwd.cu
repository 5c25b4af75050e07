// K7's backward: the cotangent chain back through the estimator's six convs.
//
// Replaces pwcnet_tpu/ops/pallas/estimator_conv.py::_est_bwd_pallas (kernel
// body _est_bwd_kernel). With mask(a) = 1 where a >= 0, else 0.1, read from
// the saved activations s1..s5 (LeakyReLU keeps the sign), and conv^T the
// transpose of a conv in its input:
//
//   gz6  = g_flow                                  (the flow conv is linear)
//   gz5  = (conv6^T(gz6) + g_feat) * mask(s5)      (features = s5 is an output too)
//   gz_i = conv_{i+1}^T(gz_{i+1}) * mask(s_i)      i = 4..1
//   dxin = conv1^T(gz1)
//
// gz1..gz5 (the cotangents of the pre-activations) are outputs: the weight
// and bias gradients are plain conv weight gradients on the saved
// activations, taken outside, as the JAX package does. Sums are float32;
// every gz_i and dxin is rounded to the model dtype on store, and each stage
// reads the rounded cotangent the stage before stored (the values the
// weight gradients see). dxin is skipped when the caller passes null.
//
// Design. One launch per stage: each stage is a tiled implicit GEMM (float32:
// conv3x3_gemm.cuh; bfloat16: conv3x3_tc_kernel below) with the taps
// mirrored, reading the [ky][kx][cin][cout] kernels transposed, and the mask (and at
// stage 5 the features' cotangent) fused into its epilogue. Every stage computes whole frames, so
// no cotangent row depends on a neighbouring tile's partial sums: the halo
// rows of the TPU kernel's exact-row scheme, and the tile-seam fault it
// replaced, have no counterpart. Bound as the forward: operations.
#include <mma.h>

#include <type_traits>

#include "conv3x3_gemm.cuh"

namespace pwc {

// ------------------------------------------------------------ bfloat16 tensor cores
// bfloat16 (conv3x3_tc_kernel): tensor cores, WMMA 16x16x16 with float32
// accumulation, the transposed conv of conv3x3_gemm.cuh (`flip`). A block
// owns 16 x 16 positions and 64 output channels; each of its 8 warps two
// rows of 16 positions (2 x 4 accumulator fragments). Input channels go by
// in chunks of 16: the tile + 1 halo is staged position-major [18][18][16],
// so the A tile of one tap is 16 consecutive positions of 16 channels; the
// weight tile is staged [tap][64][16] and read as column-major B tiles.
// Chunks are double-buffered: 16-byte cp.async copies bring chunk k + 1 from
// device memory (zero-filled outside the frame) while the tensor cores
// multiply chunk k; two blocks share an SM. Where Cin is no multiple of 8
// (the 2-channel flow cotangent) a pixel's channels do not start on 16
// bytes, and the inputs of that conv are staged element by element instead.
// The sums leave through a per-warp float32 scratch that reuses the staging
// memory. (The bf16 forward runs on wgmma, estimator_conv.cu; this kernel
// is already faster than cuDNN's conv2d_input chain and keeps WMMA.)
constexpr int kTcT = 16;            // tile rows and columns
constexpr int kTcI = kTcT + 2;      // staged rows and columns
constexpr int kTcKC = 16;           // input channels per chunk (one WMMA depth)
constexpr int kTcWT = kTcKC + 8;    // row stride of the transposed weight tile [64][16]: off the bank period
constexpr int kTcWarps = kCgThreads / 32;
constexpr int kTcInElems = kTcI * kTcI * kTcKC;
constexpr int kTcWElems = 9 * kCgTN * kTcWT;
constexpr int kTcStageElems = kTcInElems + kTcWElems;
constexpr size_t kTcScratchBytes = (size_t)kTcWarps * 16 * kCgTN * sizeof(float);
constexpr size_t kTcStageBytes = (size_t)2 * kTcStageElems * sizeof(__nv_bfloat16);  // two buffers
constexpr size_t kTcSmemBytes = kTcScratchBytes > kTcStageBytes ? kTcScratchBytes : kTcStageBytes;
static_assert((kTcInElems * sizeof(__nv_bfloat16)) % 32 == 0, "WMMA tiles start on 32 bytes");
static_assert((kTcStageElems * sizeof(__nv_bfloat16)) % 32 == 0, "WMMA tiles start on 32 bytes");

// ldw is a multiple of 8 and every tensor starts on 16 bytes, so a weight
// row goes as 16-byte copies, and so do a pixel's channels where Cin is a
// multiple of 8.
__global__ void __launch_bounds__(kCgThreads, 2) conv3x3_tc_kernel(ConvArgs a) {
  using bf16 = __nv_bfloat16;
  namespace wmma = nvcuda::wmma;
  extern __shared__ float4 cg_smem_f4[];
  // 2 x ([18][18][16] inputs, [9][64][24] transposed weights)
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
    for (int i = tid; i < 9 * kCgTN * (kTcKC / 8); i += kCgThreads) {
      const int v = i % (kTcKC / 8);
      const int n = (i / (kTcKC / 8)) % kCgTN;
      const int tap = i / (kTcKC / 8 * kCgTN);
      const int c = c0 + v * 8;
      const bool ok = c < a.ldw && n0 + n < a.Cout;
      cp_async16(w_s + (tap * kCgTN + n) * kTcWT + v * 8,
                 ok ? wt + ((size_t)(8 - tap) * a.Cout + n0 + n) * a.ldw + c : wt, ok);
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, w_s + (tap * kCgTN + nt * 16) * kTcWT, kTcWT);
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

// The kernel takes more dynamic shared memory than the default limit, which
// is allowed once per device.
constexpr int kTcMaxDevices = 64;
static bool tc_smem_allowed[kTcMaxDevices] = {};

cudaError_t conv3x3_tc(const ConvArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(((a.W + kTcT - 1) / kTcT) * ((a.H + kTcT - 1) / kTcT), (a.Cout + kCgTN - 1) / kCgTN, B);
  if (a.ldw % 8 != 0 || !a.flip) return cudaErrorInvalidValue;  // 16-byte copies of the transposed tile
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kTcMaxDevices || !tc_smem_allowed[device]) {
    err = cudaFuncSetAttribute(conv3x3_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemBytes);
    if (err != cudaSuccess) return err;
    if (device < kTcMaxDevices) tc_smem_allowed[device] = true;
  }
  conv3x3_tc_kernel<<<grid, kCgThreads, kTcSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

constexpr int kEstConvs = 6;

template <typename T>
cudaError_t run_chain_bwd(const void* g_flow, const void* g_feat, const void* const* acts,
                          const void* const* wts, void* const* gz, void* dxin, const int* chans,
                          int B, int H, int W, cudaStream_t stream) {
  const void* src = g_flow;
  for (int i = kEstConvs - 1; i >= 0; --i) {
    if (i == 0 && dxin == nullptr) break;
    ConvArgs a{};
    a.in = src;
    a.wt = wts[i];
    a.out = i == 0 ? dxin : gz[i - 1];
    a.act = i == 0 ? nullptr : acts[i - 1];
    a.add = i == kEstConvs - 1 ? g_feat : nullptr;
    a.H = H;
    a.W = W;
    a.Cin = chans[i + 1];
    a.Cout = chans[i];
    a.ldw = (a.Cin + 7) / 8 * 8;
    a.flip = 1;
    const cudaError_t err = std::is_same_v<T, float> ? conv3x3_f32(a, B, stream) : conv3x3_tc(a, B, stream);
    if (err != cudaSuccess) return err;
    src = a.out;
  }
  return cudaSuccess;
}

}  // namespace pwc

// g_flow: (B, H, W, chans[6]); g_feat: (B, H, W, chans[5]); acts[i]: s_{i+1}
// (B, H, W, chans[i+1]), i < 5; wts[i]: conv i+1 as the forward takes it,
// [ky][kx][chans[i]][ldw], ldw = chans[i+1] rounded up to a multiple of 8
// (zero tail); gz[i]: gz_{i+1} like acts[i]; dxin: (B, H, W, chans[0]) or
// null. chans[1..5] are multiples of 8. All contiguous and of one dtype:
// 0 f32 / 1 bf16.
extern "C" int pwc_estimator_chain_bwd(const void* g_flow, const void* g_feat,
                                       const void* const* acts, const void* const* wts,
                                       void* const* gz, void* dxin, const int* chans, int B, int H,
                                       int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32)
    return pwc::run_chain_bwd<float>(g_flow, g_feat, acts, wts, gz, dxin, chans, B, H, W, s);
  if (dtype == pwc::kBF16)
    return pwc::run_chain_bwd<__nv_bfloat16>(g_flow, g_feat, acts, wts, gz, dxin, chans, B, H, W,
                                             s);
  return cudaErrorInvalidValue;
}
