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
// every gz_i and dxin is rounded to the model dtype once, after the add and
// the mask, and each stage reads the rounded cotangent the stage before
// stored (the values the weight gradients see). dxin is skipped when the
// caller passes null.
//
// Design. One launch per stage: each stage is a tiled implicit GEMM with the
// taps mirrored and the channel roles swapped (the transpose of a stride-1
// 3x3 conv is one), the mask (and at stage 5 the features' cotangent) fused
// into its epilogue. Every stage computes whole frames, so no cotangent row
// depends on a neighbouring tile's partial sums: the halo rows of the TPU
// kernel's exact-row scheme, and the tile-seam fault it replaced, have no
// counterpart. Bound as the forward: operations.
//
// - float32: conv3x3_fma_kernel (conv3x3_gemm.cuh) with `flip`, reading the
//   forward's tap-major [ky][kx][cin][cout] kernels transposed.
// - bfloat16: the forward's wgmma + TMA kernel (conv3x3_wgmma.cuh) with its
//   backward epilogue, conv3x3_wgmma_kernel<N, true>. One launch of the
//   packer lays out the transposed kernels (taps mirrored, K = the forward's
//   output channels, N = its input channels) in a scratch buffer; dxin's
//   147..280 channels are wider than the widest wgmma (128), so conv1^T runs
//   in ceil(C / 128) N tiles over blockIdx.y, each packed on its own
//   (wgmma_tiles: 152 and 184 channels take two tiles of 96, 280 three). The
//   2-channel flow cotangent arrives padded to 8 channels by the caller,
//   since TMA needs 16-byte global strides (its K step of 16 is zero past
//   the 2 channels in the data and in the weights).
#include "conv3x3_gemm.cuh"
#include "conv3x3_wgmma.cuh"

namespace pwc {

constexpr int kEstConvs = 6;

cudaError_t run_chain_bwd_f32(const void* g_flow, const void* g_feat, const void* const* acts,
                              const void* const* wts, void* const* gz, void* dxin, const int* chans, int B,
                              int H, int W, cudaStream_t stream) {
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
    const cudaError_t err = conv3x3_f32(a, B, stream);
    if (err != cudaSuccess) return err;
    src = a.out;
  }
  return cudaSuccess;
}

cudaError_t run_chain_bwd_bf16(const void* g_flow, const void* g_feat, const void* const* acts,
                               const void* const* ks, void* const* gz, void* dxin, void* scratch,
                               const int* chans, int B, int H, int W, cudaStream_t stream) {
  TilePacker pk{static_cast<__nv_bfloat16*>(scratch), stream};
  const __nv_bfloat16* wpk[kEstConvs];
  const int first = dxin == nullptr ? 1 : 0;
  for (int i = kEstConvs - 1; i >= first; --i) {
    const cudaError_t err = pk.add(ks[i], chans[i + 1], chans[i], 1, &wpk[i]);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = pk.flush();
  if (err != cudaSuccess) return err;
  const void* src = g_flow;
  int cin = round_up(chans[kEstConvs], 8);  // g_flow's channel stride
  for (int i = kEstConvs - 1; i >= first; --i) {
    EwArgs a{};
    a.wpk = wpk[i];
    a.add = i == kEstConvs - 1 ? static_cast<const __nv_bfloat16*>(g_feat) : nullptr;
    a.act = i == 0 ? nullptr : static_cast<const __nv_bfloat16*>(acts[i - 1]);
    a.out = static_cast<__nv_bfloat16*>(i == 0 ? dxin : gz[i - 1]);
    a.H = H;
    a.W = W;
    a.Cout = chans[i];
    err = conv_wgmma<true>(src, a, B, cin, stream);
    if (err != cudaSuccess) return err;
    src = a.out;
    cin = chans[i];
  }
  return cudaSuccess;
}

}  // namespace pwc

// g_flow: (B, H, W, chans[6]) in float32, (B, H, W, round_up(chans[6], 8))
// with a zero tail in bfloat16 (the TMA loads need 16-byte strides); g_feat:
// (B, H, W, chans[5]); acts[i]: s_{i+1} (B, H, W, chans[i+1]), i < 5; gz[i]:
// gz_{i+1} like acts[i]; dxin: (B, H, W, chans[0]) or null. chans[1..5] are
// multiples of 8. wts[i], conv i+1: float32 as the forward takes it,
// [ky][kx][chans[i]][ldw], ldw = chans[i+1] rounded up to a multiple of 8
// (zero tail); bfloat16 as PyTorch holds it, OIHW (chans[i+1], chans[i], 3,
// 3), with `scratch` room for the transposed kernels packed for wgmma (over
// the stages run, conv i+1^T: N tiles of wgmma_tiles(chans[i]), each
// ceil(chans[i+1] / 16) * 9 * 2 * N * 8 elements); unused in float32. All
// contiguous and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_estimator_chain_bwd(const void* g_flow, const void* g_feat,
                                       const void* const* acts, const void* const* wts,
                                       void* const* gz, void* dxin, void* scratch, const int* chans, int B,
                                       int H, int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32)
    return pwc::run_chain_bwd_f32(g_flow, g_feat, acts, wts, gz, dxin, chans, B, H, W, s);
  if (dtype == pwc::kBF16)
    return pwc::run_chain_bwd_bf16(g_flow, g_feat, acts, wts, gz, dxin, scratch, chans, B, H, W, s);
  return cudaErrorInvalidValue;
}

// The transpose of one OIHW bf16 forward kernel (cout, cin, 3, 3) packed
// into `dst` as the backward packs it (K = cout, taps mirrored, the N tiles
// of wgmma_tiles(cin) one after another): for holding the layout against its
// PyTorch version.
extern "C" int pwc_pack_wgmma_transposed_tiles(const void* k, void* dst, int cout, int cin, void* stream) {
  pwc::TilePacker pk{static_cast<__nv_bfloat16*>(dst), static_cast<cudaStream_t>(stream)};
  const __nv_bfloat16* at = nullptr;
  const cudaError_t err = pk.add(k, cout, cin, 1, &at);
  return err != cudaSuccess ? err : pk.flush();
}

// The N tiles of a conv of `cout` output channels (wgmma_tiles), for the
// build log and for holding the plan against its PyTorch version.
extern "C" int pwc_wgmma_tiles(int cout, int* tiles, int* n) {
  *tiles = pwc::wgmma_tiles(cout, n);
  return *n == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// The bf16 backward conv kernel of wgmma width n, for the build log: its
// dynamic shared memory, registers and resident blocks an SM.
extern "C" int pwc_estimator_conv_bwd_info(int n, int* smem, int* regs, int* blocks) {
  return pwc::wgmma_kernel_info<true>(n, smem, regs, blocks);
}
