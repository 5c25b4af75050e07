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
// The TPU kernel keeps the whole chain of one H tile in VMEM. Here the
// 128-channel intermediates of a useful tile (plus the 5-pixel halo a
// whole-chain fusion recomputes) do not fit an SM's 227 KB of shared memory,
// so the chain is one launch per conv, each a tiled implicit GEMM with its
// bias and LeakyReLU fused, handing its activation to the next through
// device memory, where L2 (50 MB) holds it: at 96x112, B = 8, the widest
// activation is 22 MB in bfloat16. In training s1..s5 are the residuals of
// the backward and are kept; in serving they are scratch the caller drops.
//
// Bound on the H100: operations. 2 x 9 x sum(Cin_i x Cout_i) per pixel is
// about 1 M operations against about 0.9 KB moved, above the card's 295
// operations per byte in bfloat16.
//
// - float32: conv3x3_fma_kernel (conv3x3_gemm.cuh), CUDA-core FMAs.
// - bfloat16: conv3x3_wgmma_kernel<N, false> (conv3x3_wgmma.cuh), Hopper's
//   wgmma fed by TMA, its epilogue the bias and the LeakyReLU. The six
//   kernels are packed for it on the card by one small kernel per chain
//   call. TMA needs 16-byte global strides, so the chain's input arrives
//   with its channels padded to a multiple of 8 (zero tail, zero weight
//   rows): the model writes that padding in the NHWC copy it makes anyway.
#include "conv3x3_gemm.cuh"
#include "conv3x3_wgmma.cuh"

namespace pwc {

constexpr int kEstConvs = 6;

cudaError_t run_chain_f32(const void* xin, const void* const* wts, const void* const* biases,
                          void* const* outs, const int* chans, int B, int H, int W, cudaStream_t stream) {
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
    const cudaError_t err = conv3x3_f32(a, B, stream);
    if (err != cudaSuccess) return err;
    src = outs[i];
  }
  return cudaSuccess;
}

cudaError_t run_chain_bf16(const void* xin, const void* const* ks, const void* const* biases,
                           void* const* outs, void* packed, const int* chans, int B, int H, int W,
                           cudaStream_t stream) {
  TilePacker pk{static_cast<__nv_bfloat16*>(packed), stream};
  const __nv_bfloat16* wpk[kEstConvs];
  for (int i = 0; i < kEstConvs; ++i) {
    const cudaError_t err = pk.add(ks[i], chans[i], chans[i + 1], 0, &wpk[i]);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = pk.flush();
  if (err != cudaSuccess) return err;
  const void* src = xin;
  for (int i = 0; i < kEstConvs; ++i) {
    EwArgs a{};
    a.wpk = wpk[i];
    a.bias = static_cast<const __nv_bfloat16*>(biases[i]);
    a.out = static_cast<__nv_bfloat16*>(outs[i]);
    a.H = H;
    a.W = W;
    a.Cout = chans[i + 1];
    a.relu = i < kEstConvs - 1;  // the flow conv is linear
    err = conv_wgmma<false>(src, a, B, chans[i], stream);
    if (err != cudaSuccess) return err;
    src = outs[i];
  }
  return cudaSuccess;
}

}  // namespace pwc

// xin: (B, H, W, chans[0]); biases[i]: (chans[i+1],); outs[i]: (B, H, W,
// chans[i+1]), the activations s1..s5 and then the flow. chans[1..5] are
// multiples of 8. wts[i], conv i+1: float32 as [ky][kx][chans[i]][ldw], ldw =
// chans[i+1] rounded up to a multiple of 8 (zero tail); bfloat16 as PyTorch
// holds it, OIHW, with chans[0] a multiple of 8 and `packed` room for the six
// kernels packed for wgmma (for conv i+1, the N tiles of
// wgmma_tiles(chans[i+1]), each ceil(chans[i] / 16) * 9 * 2 * N * 8
// elements; unused in float32). All contiguous and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_estimator_chain(const void* xin, const void* const* wts,
                                   const void* const* biases, void* const* outs, void* packed,
                                   const int* chans, int B, int H, int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::run_chain_f32(xin, wts, biases, outs, chans, B, H, W, s);
  if (dtype == pwc::kBF16) return pwc::run_chain_bf16(xin, wts, biases, outs, packed, chans, B, H, W, s);
  return cudaErrorInvalidValue;
}

// One OIHW bf16 kernel (cout, cin, 3, 3) packed for wgmma into `dst`, as
// the chain packs it: for holding the layout against its PyTorch version.
extern "C" int pwc_pack_wgmma(const void* k, void* dst, int cin, int cout, void* stream) {
  pwc::TilePacker pk{static_cast<__nv_bfloat16*>(dst), static_cast<cudaStream_t>(stream)};
  const __nv_bfloat16* at = nullptr;
  const cudaError_t err = pk.add(k, cin, cout, 0, &at);
  return err != cudaSuccess ? err : pk.flush();
}

// The bf16 forward conv kernel of wgmma width n, for the build log: its
// dynamic shared memory, registers and resident blocks an SM.
extern "C" int pwc_estimator_conv_info(int n, int* smem, int* regs, int* blocks) {
  return pwc::wgmma_kernel_info<false>(n, smem, regs, blocks);
}

// The float32 conv kernel (conv3x3_gemm.cuh) for the build log: the N
// tile and width a conv of `cout` output channels on (B, H, W) runs at
// (on 132 SMs), and for a tile n x tw its dynamic shared memory, threads
// and resident blocks an SM.
extern "C" int pwc_conv3x3_f32_tile(int cout, int B, int H, int W, int* n, int* tw) {
  *n = pwc::fma_tile_n(cout);
  *tw = pwc::fma_tile_w(*n, H, W, B, cout, 132);
  return 0;
}

extern "C" int pwc_conv3x3_f32_info(int n, int tw, int* smem, int* threads, int* blocks) {
  int info[3] = {0, 0, 0};
  const cudaError_t err = pwc::fma_dispatch(n, nullptr, 0, tw, nullptr, info);
  *smem = info[0], *threads = info[1], *blocks = info[2];
  return err;
}
