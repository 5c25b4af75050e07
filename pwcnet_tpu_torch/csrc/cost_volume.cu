// K2: the cost volume, f0 against shifted f1 over (2d+1)^2 taps, and K8,
// the same on a row shard whose f1 carries d halo rows on each side.
//
// Replaces pwcnet_tpu/ops/pallas/cost_volume.py::cost_volume_pallas
// (kernel bodies _cv_kernel and _cv_kernel_windowed; the windowed body is
// only a VMEM-capacity variant of the same function, so one kernel covers
// both). On the main path it runs once per forward, at the deepest level:
// (B, 7, 16, 192) at 448x1024, where it is bound by launch latency.
//
// K8 replaces pwcnet_tpu/ops/pallas/cost_volume.py::cost_volume_pallas_hpad
// (forward _cv_hpad_fwd: _cv_forward with h_prepadded=True). Under H-sharding
// a shard holds h rows of f0 and receives f1_ext, (B, h + 2d, W, C): its own
// h rows of f1 with the d rows of each neighbour shard above and below
// (zeros at the global top and bottom, the frame's zero padding). Window
// row y of the output's coordinates is f1_ext row y + d, valid for y in
// [-d, h + d); only the columns are zero-padded. On the main path it runs at
// level 0 when that level is sharded (at least 4 rows per shard, e.g. a
// 1024-row frame over 2 shards: (B, 8, W/64, 192)).
//
// The correlation, its tiling and its bound are in correlation.cuh; here
// the staged window is frame 1 itself (K2) or its halo-extended rows (K8).
#include "correlation.cuh"

namespace pwc {

template <typename T>
struct PlainLoader {
  const T* f1;
  int H, W, C;
  __device__ __forceinline__ bool row_ok(int gy) const { return gy >= 0 && gy < H; }
  __device__ __forceinline__ float operator()(int b, int gy, int gx, int gc) const {
    return to_f32(f1[(((size_t)b * H + gy) * W + gx) * C + gc]);
  }
  __device__ __forceinline__ void gather8(int b, int gy, int gx, int c0, float (&v)[8]) const {
    load8(f1 + (((size_t)b * H + gy) * W + gx) * C + c0, v);
  }
  __device__ __forceinline__ void save(int, int, int, int, float) const {}  // f1 is its own residual
};

// f1_ext (B, H + 2d, W, C): output-coordinate row gy is f1_ext row gy + d
template <typename T>
struct HpadLoader {
  const T* f1_ext;
  int H, W, C, d;
  __device__ __forceinline__ bool row_ok(int gy) const { return gy >= -d && gy < H + d; }
  __device__ __forceinline__ float operator()(int b, int gy, int gx, int gc) const {
    return to_f32(f1_ext[(((size_t)b * (H + 2 * d) + gy + d) * W + gx) * C + gc]);
  }
  __device__ __forceinline__ void gather8(int b, int gy, int gx, int c0, float (&v)[8]) const {
    load8(f1_ext + (((size_t)b * (H + 2 * d) + gy + d) * W + gx) * C + c0, v);
  }
  __device__ __forceinline__ void save(int, int, int, int, float) const {}  // f1_ext is its own residual
};

template <typename T>
cudaError_t run(const void* f0, const void* f1, void* out, int B, int H, int W, int C, int d, int tw,
                int split, cudaStream_t stream) {
  const PlainLoader<T> load{static_cast<const T*>(f1), H, W, C};
  return launch_correlation<T>(static_cast<const T*>(f0), static_cast<T*>(out), B, H, W, C, d, tw,
                               split, load, stream);
}

template <typename T>
cudaError_t run_hpad(const void* f0, const void* f1_ext, void* out, int B, int H, int W, int C, int d,
                     int tw, int split, cudaStream_t stream) {
  const HpadLoader<T> load{static_cast<const T*>(f1_ext), H, W, C, d};
  return launch_correlation<T>(static_cast<const T*>(f0), static_cast<T*>(out), B, H, W, C, d, tw,
                               split, load, stream);
}

}  // namespace pwc

// f0, f1: (B, H, W, C); out: (B, H, W, (2d+1)^2); all contiguous, dtype 0 f32 / 1 bf16;
// tw, split: the tile width and the blocks a tile (ops/cuda/_common.py::correlation_plan).
extern "C" int pwc_cost_volume(const void* f0, const void* f1, void* out, int B, int H, int W,
                               int C, int d, int tw, int split, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run<float>(f0, f1, out, B, H, W, C, d, tw, split, s);
    case pwc::kBF16: return pwc::run<__nv_bfloat16>(f0, f1, out, B, H, W, C, d, tw, split, s);
    default: return cudaErrorInvalidValue;
  }
}

// K8. f0: (B, H, W, C); f1_ext: (B, H + 2d, W, C); out: (B, H, W, (2d+1)^2); all contiguous,
// dtype 0 f32 / 1 bf16; tw, split as pwc_cost_volume.
extern "C" int pwc_cost_volume_hpad(const void* f0, const void* f1_ext, void* out, int B, int H, int W,
                                    int C, int d, int tw, int split, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32: return pwc::run_hpad<float>(f0, f1_ext, out, B, H, W, C, d, tw, split, s);
    case pwc::kBF16: return pwc::run_hpad<__nv_bfloat16>(f0, f1_ext, out, B, H, W, C, d, tw, split, s);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the correlation kernel at search range d and tile width tw, for the build log
extern "C" int pwc_correlation_smem_bytes(int d, int tw) {
#define PWC_CORR_BYTES(D, TW_) \
  if (d == D && tw == TW_) return pwc::CorrLayout<D, TW_>::kBytes;
  PWC_CORR_BYTES(1, 16) PWC_CORR_BYTES(1, 32) PWC_CORR_BYTES(2, 16) PWC_CORR_BYTES(2, 32)
  PWC_CORR_BYTES(3, 16) PWC_CORR_BYTES(3, 32) PWC_CORR_BYTES(4, 16) PWC_CORR_BYTES(4, 32)
#undef PWC_CORR_BYTES
  return 0;
}
