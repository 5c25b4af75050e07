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
// Design. One launch per stage, as the forward: each stage is the same tiled
// implicit GEMM (conv3x3_gemm.cuh) with the taps mirrored, reading the
// forward's own [ky][kx][cin][cout] kernels transposed, and the mask (and at
// stage 5 the features' cotangent) fused into its epilogue. Every stage computes whole frames, so
// no cotangent row depends on a neighbouring tile's partial sums: the halo
// rows of the TPU kernel's exact-row scheme, and the tile-seam fault it
// replaced, have no counterpart. Bound as the forward: operations.
#include "conv3x3_gemm.cuh"

namespace pwc {

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
    const cudaError_t err = ConvLaunch<T>::run(a, B, stream);
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
