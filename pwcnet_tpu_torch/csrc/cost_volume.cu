// K2: the cost volume, f0 against shifted f1 over (2d+1)^2 taps.
//
// Replaces pwcnet_tpu/ops/pallas/cost_volume.py::cost_volume_pallas
// (kernel bodies _cv_kernel and _cv_kernel_windowed; the windowed body is
// only a VMEM-capacity variant of the same function, so one kernel covers
// both). On the main path it runs once per forward, at the deepest level:
// (B, 7, 16, 192) at 448x1024, where it is bound by launch latency.
//
// The correlation, its tiling and its bound are in correlation.cuh; here
// the staged window is frame 1 itself.
#include "correlation.cuh"

namespace pwc {

template <typename T>
struct PlainLoader {
  const T* f1;
  int H, W, C;
  __device__ __forceinline__ float operator()(int b, int gy, int gx, int gc) const {
    return to_f32(f1[(((size_t)b * H + gy) * W + gx) * C + gc]);
  }
  __device__ __forceinline__ void save(int, int, int, int, float) const {}  // f1 is its own residual
};

template <typename T>
cudaError_t run(const void* f0, const void* f1, void* out, int B, int H, int W, int C, int d,
                cudaStream_t stream) {
  const PlainLoader<T> load{static_cast<const T*>(f1), H, W, C};
  return launch_correlation<T>(static_cast<const T*>(f0), static_cast<T*>(out), B, H, W, C, d,
                               load, stream);
}

}  // namespace pwc

// f0, f1: (B, H, W, C); out: (B, H, W, (2d+1)^2); all contiguous, dtype 0 f32 / 1 bf16.
extern "C" int pwc_cost_volume(const void* f0, const void* f1, void* out, int B, int H, int W,
                               int C, int d, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1, out, B, H, W, C, d, s);
    case pwc::kBF16: return pwc::run<__nv_bfloat16>(f0, f1, out, B, H, W, C, d, s);
    default: return cudaErrorInvalidValue;
  }
}
