// K5: backward of the bilinear warp inside the fused warp + cost volume.
//
// Replaces pwcnet_tpu/ops/pallas/warped_cv.py::warp_bwd_pallas (kernel body
// _warp_bwd_kernel), which computes pwcnet_tpu/ops/warp.py::_bilinear_warp_bwd.
// On the training path it runs after K4 at each of the four K1 shapes, with
// g = the cotangent of the warped map.
//
// Forward: out(p) = sum over the four corners of weight * f1[corner], the
// corners (y + floor(fy) + {0,1}, x + floor(fx) + {0,1}) clamped into the
// frame independently, the weights from the unclamped fraction.
//
//   df1   = the transpose of that gather: every pixel adds weight * g(p) onto
//           its four clamped corners; corners that clamp onto one edge pixel
//           both add there (the JAX code's fold of the padded border).
//   dflow = through the weights only (the indices are integer casts):
//           dfx = sum_c g * (wy0 * (p01 - p00) + wy1 * (p11 - p10))
//           dfy = sum_c g * (wx0 * (p10 - p00) + wx1 * (p11 - p01))
//
// Design. The TPU kernel could not scatter and swept a candidate-offset tent
// filter over the frame. Here one warp owns one pixel and its lanes stride
// over the channels: the four corner reads and the four atomicAdds of a warp
// touch consecutive channels, and dflow is a warp-shuffle reduction. df1 is
// accumulated with float32 atomics, in a float32 buffer that a second small
// kernel rounds once to bfloat16 (for float32 the atomics go straight to
// df1); bf16 atomics would round on every addition. The order of the
// float32 additions, and so the last bits of df1, varies from run to run.
//
// Bound on the H100: bytes. It reads g and f1's corners, reads and writes
// the flow, and writes df1: about 3C + 4 values per pixel against 14C
// operations. The float32 accumulator adds 8C bytes per pixel in bf16.
#include "common.cuh"

namespace pwc {

constexpr int kWarpBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWarpBwdThreads)
    warp_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ flow, const T* __restrict__ g,
                    float* __restrict__ acc, T* __restrict__ dflow, int B, int H, int W, int C) {
  const int lane = threadIdx.x % 32;
  const size_t pix = (size_t)blockIdx.x * (kWarpBwdThreads / 32) + threadIdx.x / 32;
  if (pix >= (size_t)B * H * W) return;  // whole warps leave together
  const int gx = (int)(pix % W);
  const int gy = (int)((pix / W) % H);
  const size_t frame = (pix / ((size_t)H * W)) * H * W;

  const float fx = to_f32(flow[pix * 2]);
  const float fy = to_f32(flow[pix * 2 + 1]);
  const float fx0 = floorf(fx);
  const float fy0 = floorf(fy);
  const float ty = (float)gy + fy0;
  const float tx = (float)gx + fx0;
  const float hmax = (float)(H - 1);
  const float wmax = (float)(W - 1);
  const int ya = (int)fminf(fmaxf(ty, 0.f), hmax);
  const int yb = (int)fminf(fmaxf(ty + 1.f, 0.f), hmax);
  const int xa = (int)fminf(fmaxf(tx, 0.f), wmax);
  const int xb = (int)fminf(fmaxf(tx + 1.f, 0.f), wmax);
  const float wy1 = fy - fy0;
  const float wy0 = 1.f - wy1;
  const float wx1 = fx - fx0;
  const float wx0 = 1.f - wx1;
  const size_t i00 = (frame + (size_t)ya * W + xa) * C;
  const size_t i01 = (frame + (size_t)ya * W + xb) * C;
  const size_t i10 = (frame + (size_t)yb * W + xa) * C;
  const size_t i11 = (frame + (size_t)yb * W + xb) * C;

  float dfx = 0.f;
  float dfy = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float gv = to_f32(g[pix * C + c]);
    const float p00 = to_f32(f1[i00 + c]);
    const float p01 = to_f32(f1[i01 + c]);
    const float p10 = to_f32(f1[i10 + c]);
    const float p11 = to_f32(f1[i11 + c]);
    dfx = fmaf(gv, wy0 * (p01 - p00) + wy1 * (p11 - p10), dfx);
    dfy = fmaf(gv, wx0 * (p10 - p00) + wx1 * (p11 - p01), dfy);
    atomicAdd(acc + i00 + c, wy0 * wx0 * gv);
    atomicAdd(acc + i01 + c, wy0 * wx1 * gv);
    atomicAdd(acc + i10 + c, wy1 * wx0 * gv);
    atomicAdd(acc + i11 + c, wy1 * wx1 * gv);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    dfx += __shfl_down_sync(0xffffffffu, dfx, s);
    dfy += __shfl_down_sync(0xffffffffu, dfy, s);
  }
  if (lane == 0) {
    dflow[pix * 2] = from_f32<T>(dfx);
    dflow[pix * 2 + 1] = from_f32<T>(dfy);
  }
}

// the one rounding of the float32 sums to the model dtype
template <typename T>
__global__ void __launch_bounds__(kWarpBwdThreads)
    round_kernel(const float* __restrict__ acc, T* __restrict__ dst, size_t n) {
  const size_t i = (size_t)blockIdx.x * kWarpBwdThreads + threadIdx.x;
  if (i < n) dst[i] = from_f32<T>(acc[i]);
}

template <typename T>
cudaError_t run(const void* f1, const void* flow, const void* g, float* acc, void* df1, void* dflow,
                int B, int H, int W, int C, cudaStream_t stream) {
  const size_t pixels = (size_t)B * H * W;
  const size_t per_block = kWarpBwdThreads / 32;
  warp_bwd_kernel<T><<<(unsigned)((pixels + per_block - 1) / per_block), kWarpBwdThreads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(flow), static_cast<const T*>(g), acc,
      static_cast<T*>(dflow), B, H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || static_cast<void*>(acc) == df1) return err;
  const size_t n = pixels * C;
  round_kernel<T><<<(unsigned)((n + kWarpBwdThreads - 1) / kWarpBwdThreads), kWarpBwdThreads, 0, stream>>>(
      acc, static_cast<T*>(df1), n);
  return cudaGetLastError();
}

}  // namespace pwc

// f1, g, df1: (B, H, W, C); flow, dflow: (B, H, W, 2) pixels, x first; acc: (B, H, W, C)
// float32, zeroed by the caller. For dtype 0 (f32) acc may be df1 itself; for dtype 1
// (bf16) acc is scratch and df1 receives its rounded values.
extern "C" int pwc_warp_bwd(const void* f1, const void* flow, const void* g, void* acc, void* df1,
                            void* dflow, int B, int H, int W, int C, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<float*>(acc);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f1, flow, g, a, df1, dflow, B, H, W, C, s);
    case pwc::kBF16: return pwc::run<__nv_bfloat16>(f1, flow, g, a, df1, dflow, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}
