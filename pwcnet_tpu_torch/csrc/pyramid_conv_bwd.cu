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
// Design. The three cotangents are outputs, so the stages are three kernels
// that hand them over through device memory (L2 holds them), not one kernel
// with halo recomputation: the TPU kernel's banded layout, lane rolls and
// H-space-to-depth dx planes have no counterpart here.
// - gz3: one elementwise pass.
// - conv3^T and conv2^T: a transposed 3x3 stride-1 conv is a 3x3 conv with
//   the taps mirrored and the channel roles swapped. One block of 256
//   threads owns an 8 x 32 tile of positions; it stages the tile + 1 halo of
//   the incoming cotangent channel-major in shared memory and the weights as
//   [mirrored tap][cout of the forward][cin of the forward]; each thread
//   computes all C channels of one position with float32 FMAs (conv_fma.cuh,
//   the forward's float32 path), applies the mask and stores.
// - conv1^T: with stride 2 each of the nine taps of conv1 feeds exactly one
//   pixel of a 2 x 2 block of x. One thread owns the block of half-res
//   position (a, c): tap (ky, kx) reads gz1 at (a - [ky == 2], c - [kx == 2])
//   and adds into pixel (ky & 1, kx & 1), so all threads run the same taps.
//
// Bound on the H100: bytes at the bf16 tensor-core rate (it reads g, out,
// s1, s2 and writes gz1..gz3 and dx: 7 half-res tensors of C channels and x;
// 2 * 2 * 9 * C * C + 2 * 9 * CIN * C operations per half-res position).
// This version runs float32 FMAs on the CUDA cores in both dtypes and is
// bound by those; tensor cores are later work.
#include "conv_fma.cuh"

namespace pwc {

__device__ __forceinline__ float lrelu_mask(float a) { return a >= 0.f ? 1.f : 0.1f; }

template <typename T>
__global__ void __launch_bounds__(kPlThreads)
    gz3_kernel(const T* __restrict__ g, const T* __restrict__ out, T* __restrict__ gz3, size_t n) {
  const size_t i = (size_t)blockIdx.x * kPlThreads + threadIdx.x;
  if (i < n) gz3[i] = from_f32<T>(to_f32(g[i]) * lrelu_mask(to_f32(out[i])));
}

template <int C>
struct ConvTLayout {
  static constexpr int SH = kPlTH + 2, SW = kPlTW + 2, PLANE = SH * SW;
  static constexpr int W_FLOATS = 9 * C * C;
  static constexpr size_t kBytes = (size_t)(W_FLOATS + C * PLANE) * sizeof(float);
};

// gz_out = conv^T(gz_in; k) * mask(act), all (B, HH, WH, C); k is (C, C, 3, 3) OIHW.
template <typename T, int C>
__global__ void __launch_bounds__(kPlThreads)
    conv_t_s1_kernel(const T* __restrict__ gz_in, const T* __restrict__ k, const T* __restrict__ act,
                     T* __restrict__ gz_out, int HH, int WH) {
  using L = ConvTLayout<C>;
  extern __shared__ float4 smem_f4[];
  float* w_s = reinterpret_cast<float*>(smem_f4);
  float* win = w_s + L::W_FLOATS;

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kPlTH;
  const int q0 = blockIdx.x * kPlTW;
  const int tid = threadIdx.x;
  const size_t frame = (size_t)b * HH * WH;

  // ds[u, ci] = sum_{ky, kx, co} gz[u + (1 - ky, 1 - kx), co] * k[co, ci, ky, kx]:
  // a conv over taps (2 - ky, 2 - kx) with input channel co and output channel ci
  for (int i = tid; i < L::W_FLOATS; i += kPlThreads) {
    const int ci = i % C;
    const int co = (i / C) % C;
    const int tap = i / (C * C);
    w_s[i] = to_f32(k[(co * C + ci) * 9 + (8 - tap)]);
  }
  for (int i = tid; i < L::PLANE * C; i += kPlThreads) {
    const int co = i % C;
    const int p = i / C;
    const int gy = r0 - 1 + p / L::SW;
    const int gx = q0 - 1 + p % L::SW;
    float v = 0.f;
    if (gy >= 0 && gy < HH && gx >= 0 && gx < WH)
      v = to_f32(gz_in[(frame + (size_t)gy * WH + gx) * C + co]);
    win[co * L::PLANE + p] = v;
  }
  __syncthreads();

  const int oy = tid / kPlTW;
  const int ox = tid % kPlTW;
  const int gy = r0 + oy;
  const int gx = q0 + ox;
  if (gy < HH && gx < WH) {
    float acc[C];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) acc[ci] = 0.f;
    conv_s1<C>(acc, win + oy * L::SW + ox, L::PLANE, L::SW, w_s);
    const size_t at = (frame + (size_t)gy * WH + gx) * C;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
      gz_out[at + ci] = from_f32<T>(acc[ci] * lrelu_mask(to_f32(act[at + ci])));
  }
}

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

template <typename T, int C>
cudaError_t launch_conv_t_s1(const T* gz_in, const T* k, const T* act, T* gz_out, int B, int HH,
                             int WH, cudaStream_t stream) {
  using L = ConvTLayout<C>;
  auto kernel = conv_t_s1_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((WH + kPlTW - 1) / kPlTW, (HH + kPlTH - 1) / kPlTH, B);
  kernel<<<grid, kPlThreads, L::kBytes, stream>>>(gz_in, k, act, gz_out, HH, WH);
  return cudaGetLastError();
}

template <typename T, int CIN, int C>
cudaError_t run(const void* g, const void* out, const void* s1, const void* s2, const void* k1,
                const void* k2, const void* k3, void* gz1, void* gz2, void* gz3, void* dx, int B,
                int H, int W, cudaStream_t stream) {
  const int HH = H / 2;
  const int WH = W / 2;
  const size_t n = (size_t)B * HH * WH * C;
  auto z1 = static_cast<T*>(gz1);
  auto z2 = static_cast<T*>(gz2);
  auto z3 = static_cast<T*>(gz3);
  gz3_kernel<T><<<(unsigned)((n + kPlThreads - 1) / kPlThreads), kPlThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(out), z3, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_conv_t_s1<T, C>(z3, static_cast<const T*>(k3), static_cast<const T*>(s2), z2, B, HH,
                               WH, stream);
  if (err != cudaSuccess) return err;
  err = launch_conv_t_s1<T, C>(z2, static_cast<const T*>(k2), static_cast<const T*>(s1), z1, B, HH,
                               WH, stream);
  if (err != cudaSuccess || dx == nullptr) return err;
  const dim3 grid((WH + kPlTW - 1) / kPlTW, (HH + kPlTH - 1) / kPlTH, B);
  conv_t_s2_kernel<T, CIN, C><<<grid, kPlThreads, 0, stream>>>(z1, static_cast<const T*>(k1),
                                                               static_cast<T*>(dx), HH, WH);
  return cudaGetLastError();
}

}  // namespace pwc

// g, out, s1, s2, gz1, gz2, gz3: (B, H/2, W/2, c); k1: (c, cin, 3, 3); k2, k3: (c, c, 3, 3)
// (OIHW); dx: (B, H, W, cin) or null. H, W even. All contiguous and of one dtype:
// 0 f32 / 1 bf16. (cin, c) is (3, 16) or (16, 32), as in the forward.
extern "C" int pwc_pyramid_level_bwd(const void* g, const void* out, const void* s1, const void* s2,
                                     const void* k1, const void* k2, const void* k3, void* gz1,
                                     void* gz2, void* gz3, void* dx, int B, int H, int W, int cin,
                                     int c, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool l0 = cin == 3 && c == 16;
  const bool l1 = cin == 16 && c == 32;
#define PWC_BWD_ARGS g, out, s1, s2, k1, k2, k3, gz1, gz2, gz3, dx, B, H, W, s
  if (dtype == pwc::kF32 && l0) return pwc::run<float, 3, 16>(PWC_BWD_ARGS);
  if (dtype == pwc::kF32 && l1) return pwc::run<float, 16, 32>(PWC_BWD_ARGS);
  if (dtype == pwc::kBF16 && l0) return pwc::run<__nv_bfloat16, 3, 16>(PWC_BWD_ARGS);
  if (dtype == pwc::kBF16 && l1) return pwc::run<__nv_bfloat16, 16, 32>(PWC_BWD_ARGS);
#undef PWC_BWD_ARGS
  return cudaErrorInvalidValue;
}
