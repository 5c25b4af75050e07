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
// owns it reads that pixel's flow once per chunk of 8 channels and each of
// the four clamped corners by one 16-byte load (gather8; L1/L2 serve the
// reuse between neighbours), blends and hands the result to the
// shared-memory window that correlation.cuh correlates. In serving
// the warped map never goes to device memory. When a gradient is wanted the
// caller passes `f1w`, and each block also writes the warped values of its
// own tile there (the values it rounded into shared memory): the residual
// the backward (K4 over f0 and f1w, then K5) needs, as _wcv_fwd saves it.
//
// Bound: as correlation.cuh, plus the flow (2 values per pixel) and the
// corner gathers, which stay in L1/L2 when the flow is smooth.
//
// K9 (GlobalWarpLoader) replaces pwcnet_tpu/ops/pallas/warped_cv.py::
// warped_cost_volume_global (forward _wcv_global_fwd: _wcv_forward with
// valid_rows and save_ext). Under H-sharding a shard holds h rows of f0, the
// WHOLE frame 1 (Hf rows, all-gathered: the warp's reach depends on the
// flow) and flow_ext (B, h + 2d, W, 2) in float32: its own flow rows with d
// halo rows from each neighbour and the shard's global row offset already
// added to flow y. Window row y (-d <= y < h + d) warps with flow_ext row
// y + d, its corners clamp into [0, Hf - 1], and it is zero outside [vlo,
// vhi], the rows of the global frame in the shard's coordinates. With a
// gradient wanted it saves the warped rows over all h + 2d rows, halo rows
// included (f1w_ext, zeroed by the caller): the backward correlates them
// again (K8's backward) without another exchange. The flow stays float32
// whatever the model dtype: at level 4 of 448 rows over 2 shards the offset
// is 56, where bfloat16 steps by 0.25. On the main path: levels 1-4 of
// every sharded frame, e.g. (B, 7, 32, 128) .. (B, 56, 256, 32) per shard
// at 448x1024 over 2 shards.
#include "correlation.cuh"

namespace pwc {

// The bilinear sample of window pixel (gy, gx) displaced by (fx, fy): the
// four corners' element offsets in a frame of `rows` x W pixels of C
// channels, each clamped into the frame, and the weights from the
// unclamped fractional flow.
struct Bilinear {
  size_t a00, a01, a10, a11;
  float wx0, wx1, wy0, wy1;
};

__device__ __forceinline__ Bilinear bilinear_at(float fx, float fy, int gy, int gx, int rows, int W, int C) {
  const float fx0 = floorf(fx);
  const float fy0 = floorf(fy);
  const float ty = (float)gy + fy0;
  const float tx = (float)gx + fx0;
  const float hmax = (float)(rows - 1);
  const float wmax = (float)(W - 1);
  const int ya = (int)fminf(fmaxf(ty, 0.f), hmax);
  const int yb = (int)fminf(fmaxf(ty + 1.f, 0.f), hmax);
  const int xa = (int)fminf(fmaxf(tx, 0.f), wmax);
  const int xb = (int)fminf(fmaxf(tx + 1.f, 0.f), wmax);
  Bilinear q;
  q.a00 = ((size_t)ya * W + xa) * C;
  q.a01 = ((size_t)ya * W + xb) * C;
  q.a10 = ((size_t)yb * W + xa) * C;
  q.a11 = ((size_t)yb * W + xb) * C;
  q.wy1 = fy - fy0;
  q.wy0 = 1.f - q.wy1;
  q.wx1 = fx - fx0;
  q.wx0 = 1.f - q.wx1;
  return q;
}

// the float32 blend of the four corners, rounded to the model dtype
template <typename T>
__device__ __forceinline__ float blend(const Bilinear& q, float p00, float p01, float p10, float p11) {
  const float top = p00 * q.wx0 + p01 * q.wx1;
  const float bot = p10 * q.wx0 + p11 * q.wx1;
  return round_to<T>(top * q.wy0 + bot * q.wy1);
}

template <typename T>
__device__ __forceinline__ float sample(const T* frame, const Bilinear& q, int gc) {
  const T* base = frame + gc;
  return blend<T>(q, to_f32(base[q.a00]), to_f32(base[q.a01]), to_f32(base[q.a10]), to_f32(base[q.a11]));
}

template <typename T>
__device__ __forceinline__ void sample8(const T* frame, const Bilinear& q, int c0, float (&v)[8]) {
  float p00[8], p01[8], p10[8], p11[8];
  load8(frame + q.a00 + c0, p00);
  load8(frame + q.a01 + c0, p01);
  load8(frame + q.a10 + c0, p10);
  load8(frame + q.a11 + c0, p11);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = blend<T>(q, p00[c], p01[c], p10[c], p11[c]);
}

template <typename T>
struct WarpLoader {
  const T* f1;
  const T* flow;
  T* f1w;  // (B, H, W, C) warped-map residual, or nullptr
  int H, W, C;
  __device__ __forceinline__ bool row_ok(int gy) const { return gy >= 0 && gy < H; }
  __device__ __forceinline__ void save(int b, int gy, int gx, int gc, float v) const {
    if (f1w != nullptr) f1w[(((size_t)b * H + gy) * W + gx) * C + gc] = from_f32<T>(v);
  }
  __device__ __forceinline__ Bilinear at(int b, int gy, int gx) const {
    const T* fl = flow + (((size_t)b * H + gy) * W + gx) * 2;
    return bilinear_at(to_f32(fl[0]), to_f32(fl[1]), gy, gx, H, W, C);
  }
  __device__ __forceinline__ float operator()(int b, int gy, int gx, int gc) const {
    return sample(f1 + (size_t)b * H * W * C, at(b, gy, gx), gc);
  }
  __device__ __forceinline__ void gather8(int b, int gy, int gx, int c0, float (&v)[8]) const {
    sample8(f1 + (size_t)b * H * W * C, at(b, gy, gx), c0, v);
  }
};

// K9: h rows of the shard against Hf rows of the whole frame
template <typename T>
struct GlobalWarpLoader {
  const T* f1;        // (B, Hf, W, C)
  const float* flow;  // (B, h + 2d, W, 2), offset folded into y
  T* f1w;             // (B, h + 2d, W, C) warped rows, or nullptr
  int H, Hf, W, C, d, lo, hi;  // valid window rows [lo, hi]
  __device__ __forceinline__ bool row_ok(int gy) const { return gy >= lo && gy <= hi; }
  __device__ __forceinline__ void save(int b, int gy, int gx, int gc, float v) const {
    if (f1w != nullptr) f1w[(((size_t)b * (H + 2 * d) + gy + d) * W + gx) * C + gc] = from_f32<T>(v);
  }
  __device__ __forceinline__ Bilinear at(int b, int gy, int gx) const {
    const float* fl = flow + (((size_t)b * (H + 2 * d) + gy + d) * W + gx) * 2;
    return bilinear_at(fl[0], fl[1], gy, gx, Hf, W, C);
  }
  __device__ __forceinline__ float operator()(int b, int gy, int gx, int gc) const {
    return sample(f1 + (size_t)b * Hf * W * C, at(b, gy, gx), gc);
  }
  __device__ __forceinline__ void gather8(int b, int gy, int gx, int c0, float (&v)[8]) const {
    sample8(f1 + (size_t)b * Hf * W * C, at(b, gy, gx), c0, v);
  }
};

template <typename T>
cudaError_t run_global(const void* f0, const void* f1, const float* flow, void* out, void* f1w, int B,
                       int H, int Hf, int W, int C, int d, int vlo, int vhi, int tw, int split,
                       cudaStream_t stream) {
  const GlobalWarpLoader<T> load{static_cast<const T*>(f1), flow, static_cast<T*>(f1w), H, Hf, W, C, d,
                                 vlo > -d ? vlo : -d, vhi < H + d - 1 ? vhi : H + d - 1};
  return launch_correlation<T>(static_cast<const T*>(f0), static_cast<T*>(out), B, H, W, C, d, tw,
                               split, load, stream);
}

template <typename T>
cudaError_t run(const void* f0, const void* f1, const void* flow, void* out, void* f1w, int B, int H,
                int W, int C, int d, int tw, int split, cudaStream_t stream) {
  const WarpLoader<T> load{static_cast<const T*>(f1), static_cast<const T*>(flow),
                           static_cast<T*>(f1w), H, W, C};
  return launch_correlation<T>(static_cast<const T*>(f0), static_cast<T*>(out), B, H, W, C, d, tw,
                               split, load, stream);
}

}  // namespace pwc

// f0, f1: (B, H, W, C); flow: (B, H, W, 2) pixels, x first; out: (B, H, W, (2d+1)^2);
// f1w: (B, H, W, C) or null. All contiguous and of one dtype: 0 f32 / 1 bf16. tw, split: the
// tile width and the blocks a tile (ops/cuda/_common.py::correlation_plan).
extern "C" int pwc_warped_cost_volume(const void* f0, const void* f1, const void* flow, void* out,
                                      void* f1w, int B, int H, int W, int C, int d, int tw, int split,
                                      int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1, flow, out, f1w, B, H, W, C, d, tw, split, s);
    case pwc::kBF16: return pwc::run<__nv_bfloat16>(f0, f1, flow, out, f1w, B, H, W, C, d, tw, split, s);
    default: return cudaErrorInvalidValue;
  }
}

// K9. f0: (B, H, W, C) the shard's rows; f1: (B, Hf, W, C) the whole frame; flow: (B, H + 2d, W, 2)
// float32 pixels, x first, the shard's row offset added to y; out: (B, H, W, (2d+1)^2); f1w:
// (B, H + 2d, W, C) zeroed, or null. Window rows outside [vlo, vhi] are zero. f0, f1, out and f1w
// are of one dtype: 0 f32 / 1 bf16. tw, split as pwc_warped_cost_volume.
extern "C" int pwc_warped_cost_volume_global(const void* f0, const void* f1, const void* flow, void* out,
                                             void* f1w, int B, int H, int Hf, int W, int C, int d,
                                             int vlo, int vhi, int tw, int split, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fl = static_cast<const float*>(flow);
  switch (dtype) {
    case pwc::kF32:
      return pwc::run_global<float>(f0, f1, fl, out, f1w, B, H, Hf, W, C, d, vlo, vhi, tw, split, s);
    case pwc::kBF16:
      return pwc::run_global<__nv_bfloat16>(f0, f1, fl, out, f1w, B, H, Hf, W, C, d, vlo, vhi, tw, split, s);
    default: return cudaErrorInvalidValue;
  }
}
