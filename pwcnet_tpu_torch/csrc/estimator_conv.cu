// K7: the optical-flow estimator's conv chain,
//   xin -> 5 x (conv3x3 SAME + bias, LeakyReLU(0.1)) -> conv3x3 SAME + bias (linear, 2 channels)
// returning flow_raw (the last conv) and features (s5, the fifth activation),
// with float32 accumulation and every activation rounded to the model dtype
// between the convs.
//
// Replaces pwcnet_tpu/ops/pallas/estimator_conv.py::estimator_chain_fused
// (forward body _est_kernel). With --fused-estimator N it runs at the N
// finest estimator levels: inputs 147..273 channels wide, outputs 128, 128,
// 96, 64, 32, 2.
//
// Design. The TPU kernel keeps the whole chain of one H tile in VMEM. Here
// the 128-channel intermediates of a useful tile (plus the 5-pixel halo a
// whole-chain fusion recomputes) do not fit an SM's 227 KB of shared memory,
// so the chain is one launch per conv, each a tiled implicit GEMM with its
// bias and LeakyReLU fused (conv3x3_gemm.cuh), handing its activation to the
// next through device memory, where L2 (50 MB) holds it: at 96x112, B = 8,
// the widest activation is 22 MB in bfloat16. Nothing else touches the
// activations between the convs. In training s1..s5 are the residuals of
// the backward and are kept; in serving they are scratch the caller drops.
// The (B, H, C, W) margin-lane layout, the H-tile planner and the lane rolls
// of the TPU kernel have no counterpart.
//
// Bound on the H100: operations. 2 x 9 x sum(Cin_i x Cout_i) per pixel is
// about 1 M operations against about 0.9 KB moved, above the card's 295
// operations per byte in bfloat16. The bfloat16 path runs WMMA tensor-core
// tiles fed from double-buffered shared memory and is bound by the loads of
// those tiles, the float32 path by the CUDA cores' FMA rate.
#include "conv3x3_gemm.cuh"

namespace pwc {

constexpr int kEstConvs = 6;

template <typename T>
cudaError_t run_chain(const void* xin, const void* const* wts, const void* const* biases,
                      void* const* outs, const int* chans, int B, int H, int W,
                      cudaStream_t stream) {
  const void* src = xin;
  for (int i = 0; i < kEstConvs; ++i) {
    ConvArgs a{};
    a.in = src;
    a.wt = wts[i];
    a.bias = biases[i];
    a.out = outs[i];
    a.H = H;
    a.W = W;
    a.Cin = chans[i];
    a.Cout = chans[i + 1];
    a.ldw = (a.Cout + 7) / 8 * 8;
    a.relu = i < kEstConvs - 1;  // the flow conv is linear
    const cudaError_t err = ConvLaunch<T>::run(a, B, stream);
    if (err != cudaSuccess) return err;
    src = outs[i];
  }
  return cudaSuccess;
}

}  // namespace pwc

// xin: (B, H, W, chans[0]); wts[i]: conv i+1 as [ky][kx][chans[i]][ldw], ldw =
// chans[i+1] rounded up to a multiple of 8 (zero tail); biases[i]: (chans[i+1],);
// outs[i]: (B, H, W, chans[i+1]), the activations s1..s5 and then the flow.
// chans[1..5] are multiples of 8. All contiguous and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_estimator_chain(const void* xin, const void* const* wts,
                                   const void* const* biases, void* const* outs, const int* chans,
                                   int B, int H, int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::run_chain<float>(xin, wts, biases, outs, chans, B, H, W, s);
  if (dtype == pwc::kBF16)
    return pwc::run_chain<__nv_bfloat16>(xin, wts, biases, outs, chans, B, H, W, s);
  return cudaErrorInvalidValue;
}
