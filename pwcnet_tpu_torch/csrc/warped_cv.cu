// K1: bilinear warp of frame-1 features by a pixel-unit flow, fused with
// the cost volume against frame-0 features.
//
// Replaces pwcnet_tpu/ops/pallas/warped_cv.py::warped_cost_volume (forward
// _wcv_forward, kernel body _wcv_kernel). On the main path it runs at
// levels 1-4: (B, 14, 32, 128), (B, 28, 64, 96), (B, 56, 128, 64) and
// (B, 112, 256, 32) at 448x1024.
//
// Warp semantics (pwcnet_tpu/ops/warp.py): flow channel 0 is x; the four
// corners clamp into the frame independently and the weights come from
// the unclamped fractional flow; the blend is float32 and the warped value
// is rounded to the model dtype before it is correlated (as the TPU kernel
// stores it). Window pixels outside the frame are zero: the cost volume's
// zero padding, applied after the warp.
//
// Design. The TPU kernel could not gather (Mosaic), so it swept a
// candidate-offset tent filter over the frame. Here every thread of the
// block gathers directly: for each pixel of the (tile + 2d halo) window it
// reads that pixel's flow and the four clamped corners from device memory
// (L1/L2 serve the reuse between neighbours), blends and stores the result
// in the shared-memory window that correlation.cuh correlates. In serving
// the warped map never goes to device memory. When a gradient is wanted the
// caller passes `f1w`, and each block also writes the warped values of its
// own tile there (the values it rounded into shared memory): the residual
// the backward (K4 over f0 and f1w, then K5) needs, as _wcv_fwd saves it.
//
// Bound: as correlation.cuh, plus the flow (2 values per pixel) and the
// corner gathers, which stay in L1/L2 when the flow is smooth.
#include "correlation.cuh"

namespace pwc {

template <typename T>
struct WarpLoader {
  const T* f1;
  const T* flow;
  T* f1w;  // (B, H, W, C) warped-map residual, or nullptr
  int H, W, C;
  __device__ __forceinline__ void save(int b, int gy, int gx, int gc, float v) const {
    if (f1w != nullptr) f1w[(((size_t)b * H + gy) * W + gx) * C + gc] = from_f32<T>(v);
  }
  __device__ __forceinline__ float operator()(int b, int gy, int gx, int gc) const {
    const T* fl = flow + (((size_t)b * H + gy) * W + gx) * 2;
    const float fx = to_f32(fl[0]);
    const float fy = to_f32(fl[1]);
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
    const T* base = f1 + (size_t)b * H * W * C + gc;
    const float p00 = to_f32(base[((size_t)ya * W + xa) * C]);
    const float p01 = to_f32(base[((size_t)ya * W + xb) * C]);
    const float p10 = to_f32(base[((size_t)yb * W + xa) * C]);
    const float p11 = to_f32(base[((size_t)yb * W + xb) * C]);
    const float top = p00 * wx0 + p01 * wx1;
    const float bot = p10 * wx0 + p11 * wx1;
    return round_to<T>(top * wy0 + bot * wy1);
  }
};

template <typename T>
cudaError_t run(const void* f0, const void* f1, const void* flow, void* out, void* f1w, int B, int H,
                int W, int C, int d, cudaStream_t stream) {
  const WarpLoader<T> load{static_cast<const T*>(f1), static_cast<const T*>(flow),
                           static_cast<T*>(f1w), H, W, C};
  return launch_correlation<T>(static_cast<const T*>(f0), static_cast<T*>(out), B, H, W, C, d,
                               load, stream);
}

}  // namespace pwc

// f0, f1: (B, H, W, C); flow: (B, H, W, 2) pixels, x first; out: (B, H, W, (2d+1)^2);
// f1w: (B, H, W, C) or null. All contiguous and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_warped_cost_volume(const void* f0, const void* f1, const void* flow, void* out,
                                      void* f1w, int B, int H, int W, int C, int d, int dtype,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1, flow, out, f1w, B, H, W, C, d, s);
    case pwc::kBF16: return pwc::run<__nv_bfloat16>(f0, f1, flow, out, f1w, B, H, W, C, d, s);
    default: return cudaErrorInvalidValue;
  }
}
