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
// The tall-frame variant (pwc_warp_bwd_rows) is K9b, the last stage of K9's
// backward (pwcnet_tpu/ops/pallas/warped_cv.py::_wcv_global_bwd, its
// warp_bwd_pallas call on the full frame): f1 is the whole frame (Hf rows),
// g and the float32 flow are a shard's h + 2d warped rows, and row j of them
// sits at row j + row0 (row0 = -d) of the shard, so the corners are
// (j + row0 + floor(fy) + {0,1}, ...) clamped into [0, Hf - 1]. The flow
// carries the shard's offset; folding row0 here, not into the flow, keeps
// the corners and weights exactly those K9's forward used. A row whose
// shard row j + row0 lies outside [vlo, vhi] (the frame's rows in the
// shard's coordinates) reads its cotangent as zero: its dflow is 0 and it
// scatters nothing, as the JAX code's zeroed rows do.
//
// Design. The TPU kernel could not scatter and swept a candidate-offset tent
// filter over the frame. Here a call is one cooperative kernel and no other
// device operation: a persistent grid of as many blocks as the card holds
// at once (fewer where the call needs fewer) runs three phases, separated
// by grid-wide barriers:
//   (a) zero the float32 accumulator (df1 itself in float32, a scratch
//       buffer in bf16) by 16-byte stores;
//   (b) scatter and dflow: a group of `lanes` lanes (a power of two, from
//       ops/cuda/_common.py::warp_bwd_lanes) serves one pixel, each lane 4
//       channels at a time: g and the four clamped corners by one vector
//       load each (16 bytes in float32, 8 in bf16), each corner's weight * g
//       by one 4-float vector atomic, so that two neighbouring lanes fill a
//       32-byte sector of the accumulator in one instruction. dflow is a
//       shuffle reduction inside the group. On the H100, 8 bf16 channels a
//       lane by 16-byte loads (each atomic half-filling a sector, or lanes
//       trading halves by shuffles to fill it) ran slower than this, and
//       so did 64-bit offsets. A C that is no multiple of 4, or a tensor off
//       alignment, takes the same lanes channel by channel (the scalar
//       tail);
//   (c) bf16 only: round the accumulator once into df1, 8 channels a
//       thread (two 16-byte loads, one 16-byte store). bf16 atomics would
//       round on every addition.
// The order of the float32 additions, and so the last bits of df1, varies
// from run to run.
//
// Bound on the H100: bytes. It reads g and f1's corners, reads the flow,
// and writes df1 and dflow: about 3C + 4 values per pixel against 14C
// operations. The float32 accumulator adds 8C bytes per pixel in bf16.
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace pwc {

constexpr int kWarpBwdThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kChannels = 4;  // a lane's channels at a time: one 4-float atomic a corner
// offsets are 32-bit (fewer instructions a pixel than 64-bit ones, measured):
// f1, g, the flow and the accumulator hold at most 2^30 elements, so that
// every offset, stride step and flow index stays below 2^31
constexpr size_t kMaxElements = size_t{1} << 30;

// 4 channels as raw bits: 16 bytes of float32, 8 of bf16; widened to
// float32 where they are used
template <typename T>
using Raw = std::conditional_t<std::is_same<T, float>::value, uint4, uint2>;

template <typename T>
__device__ __forceinline__ Raw<T> load4(const T* p) {
  return __ldg(reinterpret_cast<const Raw<T>*>(p));
}
// channel k of 4 (k a constant after unrolling)
__device__ __forceinline__ float chan(const uint4& q, int k) {
  return __uint_as_float(k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w);
}
__device__ __forceinline__ float chan(const uint2& q, int k) {  // bf16: the upper half of a float32
  const unsigned w = k < 2 ? q.x : q.y;
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

// acc[0, 4) += w * the 4 channels: one 4-float vector reduction
template <typename R>
__device__ __forceinline__ void red4(float* p, float w, const R& q) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * chan(q, 0), w * chan(q, 1), w * chan(q, 2), w * chan(q, 3)));
}

// two floats rounded to bf16, as the 32 bits of a bf16 pair (x low)
__device__ __forceinline__ unsigned bits(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return reinterpret_cast<const unsigned&>(h);
}

// g, flow, dflow: Ho rows; f1, acc, df1: Hf rows; flow row j is frame row
// j + row0 and scatters only where j + row0 lies in [vlo, vhi]. acc is df1
// itself for T = float (df1 unused), a float32 scratch buffer for bf16.
// vec: the lanes load and add 4 channels at once (else one by one).
template <typename T, typename F>
__global__ void __launch_bounds__(kWarpBwdThreads)
    warp_bwd_coop_kernel(const T* __restrict__ f1, const F* __restrict__ flow, const T* __restrict__ g,
                         float* __restrict__ acc, T* __restrict__ df1, F* __restrict__ dflow, int B, int Ho,
                         int Hf, int W, int C, int row0, int vlo, int vhi, int lanes_log2, int vec) {
  constexpr int V = kChannels;
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * kWarpBwdThreads + threadIdx.x;
  const int nthreads = gridDim.x * kWarpBwdThreads;
  const int n = B * Hf * W * C;
  const int lane = threadIdx.x % 32;
  const int lanes = 1 << lanes_log2;
  const int sub = lane & (lanes - 1);
  const int pixels = B * Ho * W;
  const int step = nthreads / 32 * (32 >> lanes_log2);  // warp w takes pixels w * per_warp + k * step
  const float hmax = (float)(Hf - 1);
  const float wmax = (float)(W - 1);

  // (a) zero the accumulator (bypassing L1: phase (c) reads it back)
  for (int i = tid; i < n / 4; i += nthreads)
    __stcg(reinterpret_cast<float4*>(acc) + i, make_float4(0.f, 0.f, 0.f, 0.f));
  for (int i = n / 4 * 4 + tid; i < n; i += nthreads) __stcg(acc + i, 0.f);
  grid.sync();

  // (b) scatter and dflow
  for (int first = tid / 32 * (32 >> lanes_log2); first < pixels; first += step) {  // uniform in the warp
    const int pix = first + (lane >> lanes_log2);
    const int gy = pix / W % Ho + row0;
    float dfx = 0.f;
    float dfy = 0.f;
    if (pix < pixels && gy >= vlo && gy <= vhi) {
      const int gx = pix % W;
      const int frame = pix / (Ho * W) * Hf * W;
      const float fx = to_f32(flow[pix * 2]);
      const float fy = to_f32(flow[pix * 2 + 1]);
      const float fx0 = floorf(fx);
      const float fy0 = floorf(fy);
      const float ty = (float)gy + fy0;
      const float tx = (float)gx + fx0;
      const int ya = (int)fminf(fmaxf(ty, 0.f), hmax);
      const int yb = (int)fminf(fmaxf(ty + 1.f, 0.f), hmax);
      const int xa = (int)fminf(fmaxf(tx, 0.f), wmax);
      const int xb = (int)fminf(fmaxf(tx + 1.f, 0.f), wmax);
      const float wy1 = fy - fy0;
      const float wy0 = 1.f - wy1;
      const float wx1 = fx - fx0;
      const float wx0 = 1.f - wx1;
      const float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
      const int i00 = (frame + ya * W + xa) * C;
      const int i01 = (frame + ya * W + xb) * C;
      const int i10 = (frame + yb * W + xa) * C;
      const int i11 = (frame + yb * W + xb) * C;
      for (int c = sub * V; c < C; c += lanes * V) {
        if (!vec) {  // the scalar tail: the lane's channels one by one
          for (int j = c; j < min(c + V, C); ++j) {
            const float gj = to_f32(g[pix * C + j]);
            const float p00 = to_f32(f1[i00 + j]), p01 = to_f32(f1[i01 + j]);
            const float p10 = to_f32(f1[i10 + j]), p11 = to_f32(f1[i11 + j]);
            dfx = fmaf(gj, wy0 * (p01 - p00) + wy1 * (p11 - p10), dfx);
            dfy = fmaf(gj, wx0 * (p10 - p00) + wx1 * (p11 - p01), dfy);
            atomicAdd(acc + i00 + j, w00 * gj);
            atomicAdd(acc + i01 + j, w01 * gj);
            atomicAdd(acc + i10 + j, w10 * gj);
            atomicAdd(acc + i11 + j, w11 * gj);
          }
          continue;
        }
        const Raw<T> gq = load4(g + pix * C + c);
        const Raw<T> q00 = load4(f1 + i00 + c), q01 = load4(f1 + i01 + c);
        const Raw<T> q10 = load4(f1 + i10 + c), q11 = load4(f1 + i11 + c);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gk = chan(gq, k);
          const float p00 = chan(q00, k), p01 = chan(q01, k), p10 = chan(q10, k), p11 = chan(q11, k);
          dfx = fmaf(gk, wy0 * (p01 - p00) + wy1 * (p11 - p10), dfx);
          dfy = fmaf(gk, wx0 * (p10 - p00) + wx1 * (p11 - p01), dfy);
        }
        red4(acc + i00 + c, w00, gq);
        red4(acc + i01 + c, w01, gq);
        red4(acc + i10 + c, w10, gq);
        red4(acc + i11 + c, w11, gq);
      }
    }
    for (int s = lanes >> 1; s > 0; s >>= 1) {  // inside the pixel's group only
      dfx += __shfl_xor_sync(0xffffffffu, dfx, s);
      dfy += __shfl_xor_sync(0xffffffffu, dfy, s);
    }
    if (sub == 0 && pix < pixels) {
      dflow[pix * 2] = from_f32<F>(dfx);
      dflow[pix * 2 + 1] = from_f32<F>(dfy);
    }
  }

  if constexpr (!std::is_same<T, float>::value) {
    // (c) the one rounding of the float32 sums to the model dtype
    grid.sync();
    for (int i = tid; i < n / 8; i += nthreads) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(acc) + 2 * i);
      const float4 b = __ldcg(reinterpret_cast<const float4*>(acc) + 2 * i + 1);
      *reinterpret_cast<uint4*>(df1 + 8 * i) =
          make_uint4(bits(a.x, a.y), bits(a.z, a.w), bits(b.x, b.y), bits(b.z, b.w));
    }
    for (int i = n / 8 * 8 + tid; i < n; i += nthreads) df1[i] = from_f32<T>(__ldcg(acc + i));
  }
}

// Blocks of the kernel the card holds at once: SMs x resident blocks an SM,
// looked up once per device and kernel instance (a static of this library
// alone: no header shares it).
template <typename T, typename F>
cudaError_t resident_blocks(int* blocks) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*blocks = cache[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_bwd_coop_kernel<T, F>, kWarpBwdThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (*blocks <= 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kMaxDevices) cache[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// The grid: enough blocks for one pass of the scatter (a lane per 4
// channels of each pixel's group) or of the zeroing (a float4 a thread), at most the
// resident blocks; ops/cuda/_common.py::warp_bwd_blocks is its model.
inline unsigned grid_blocks(size_t pixels, int lanes, size_t n, int resident) {
  const size_t t = kWarpBwdThreads;
  const size_t need = std::max((pixels * lanes + t - 1) / t, (n / 4 + t - 1) / t);
  return (unsigned)std::max<size_t>(1, std::min<size_t>(need, (size_t)resident));
}

template <typename T, typename F>
cudaError_t run(const void* f1, const void* flow, const void* g, void* acc, void* df1, void* dflow, int B, int Ho,
                int Hf, int W, int C, int row0, int vlo, int vhi, int lanes, cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  if (lanes < 1 || lanes > 32 || (1 << lanes_log2) != lanes) return cudaErrorInvalidValue;
  const bool f32 = std::is_same<T, float>::value;
  float* a = static_cast<float*>(f32 ? df1 : acc);
  if (a == nullptr || !aligned16(a) || !aligned16(df1)) return cudaErrorInvalidValue;
  const size_t pixels = (size_t)B * Ho * W;
  const size_t n = (size_t)B * Hf * W * C;
  if (pixels == 0 || n == 0) return cudaSuccess;
  if (n > kMaxElements || pixels * std::max(C, 2) > kMaxElements) return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_blocks<T, F>(&resident);
  if (err != cudaSuccess) return err;
  int vec = C % kChannels == 0 && aligned16(f1) && aligned16(g);
  auto pf1 = static_cast<const T*>(f1);
  auto pflow = static_cast<const F*>(flow);
  auto pg = static_cast<const T*>(g);
  auto pdf1 = static_cast<T*>(df1);
  auto pdflow = static_cast<F*>(dflow);
  void* args[] = {&pf1, &pflow, &pg, &a, &pdf1, &pdflow, &B, &Ho, &Hf, &W, &C, &row0, &vlo, &vhi, &lanes_log2,
                  &vec};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(warp_bwd_coop_kernel<T, F>),
                                    dim3(grid_blocks(pixels, lanes, n, resident)), dim3(kWarpBwdThreads), args, 0,
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename F>
cudaError_t info(int* threads, int* blocks_per_sm, int* sms) {
  *threads = kWarpBwdThreads;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, warp_bwd_coop_kernel<T, F>,
                                                                  kWarpBwdThreads, 0);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace pwc

// f1, g, df1: (B, H, W, C); flow, dflow: (B, H, W, 2) pixels, x first, of
// dtype 0 (f32) or 1 (bf16) like the rest. acc: (B, H, W, C) float32 scratch
// for bf16 (its contents are overwritten); unused (may be null) for f32,
// where df1 is the accumulator. lanes: a power of two up to 32, the lanes
// that serve one pixel (warp_bwd_lanes).
extern "C" int pwc_warp_bwd(const void* f1, const void* flow, const void* g, void* acc, void* df1,
                            void* dflow, int B, int H, int W, int C, int lanes, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32:
      return pwc::run<float, float>(f1, flow, g, acc, df1, dflow, B, H, H, W, C, 0, 0, H - 1, lanes, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16, __nv_bfloat16>(f1, flow, g, acc, df1, dflow, B, H, H, W, C, 0, 0, H - 1,
                                                    lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tall-frame variant (K9b). f1, df1: (B, Hf, W, C); g: (B, Ho, W, C); flow, dflow: (B, Ho, W, 2)
// float32 pixels, x first, flow row j at frame row j + row0; rows with j + row0 outside [vlo, vhi] read
// g as zero (g itself is not written). acc as for pwc_warp_bwd. f1, g and df1 are of one dtype
// (0 f32 / 1 bf16).
extern "C" int pwc_warp_bwd_rows(const void* f1, const void* flow, const void* g, void* acc, void* df1,
                                 void* dflow, int B, int Ho, int Hf, int W, int C, int row0, int vlo, int vhi,
                                 int lanes, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32:
      return pwc::run<float, float>(f1, flow, g, acc, df1, dflow, B, Ho, Hf, W, C, row0, vlo, vhi, lanes, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16, float>(f1, flow, g, acc, df1, dflow, B, Ho, Hf, W, C, row0, vlo, vhi,
                                            lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// For the build log: threads a block, resident blocks an SM and the SMs of
// the current device, for dtype 0 / 1 and the flow's dtype (rows 0: the
// model dtype, K5; 1: float32, K9b).
extern "C" int pwc_warp_bwd_info(int dtype, int rows, int* threads, int* blocks_per_sm, int* sms) {
  switch (dtype) {
    case pwc::kF32: return pwc::info<float, float>(threads, blocks_per_sm, sms);
    case pwc::kBF16:
      return rows ? pwc::info<__nv_bfloat16, float>(threads, blocks_per_sm, sms)
                  : pwc::info<__nv_bfloat16, __nv_bfloat16>(threads, blocks_per_sm, sms);
    default: return cudaErrorInvalidValue;
  }
}
