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
// filter over the frame, whose sums have one order. Here df1 is a scatter,
// and it gives the same bits in every launch, at every grid size and on
// every card: each term w * g (float32, as the plain version forms it)
// becomes the integer rint(w * g * 2^s), the terms are summed by 64-bit
// integer atomics (integer addition is associative, so no order of the
// atomics changes the sum) and each sum is converted back once. The scale
// 2^s is an image's own (a pixel scatters only into its image), so an
// image's df1 has the same bits whatever images share its batch. A call is
// one cooperative kernel and no other device operation: a persistent grid
// of as many blocks as the card holds at once (fewer where the call needs
// fewer, at most kMaxBlocks) runs four phases, separated by grid-wide
// barriers:
//   (a) zero the int64 scratch (the accumulators and the class words) by
//       16-byte stores, and find the largest finite |g| of each image over
//       the rows that scatter (phase 0: max is exact, so its order does
//       not matter): G / B blocks an image (where the grid has G >= B
//       blocks; else one block an image, several images a block), one
//       word a block and image;
//   (s) a block an image reduces that image's words to max|g| = m 2^e
//       (m in [0.5, 1)) and writes its scale s = 62 - k - e, with
//       4 Ho W <= 2^k (ops/cuda/_common.py::warp_bwd_scale mirrors it):
//       then 4 Ho W max|g| 2^s < 2^62, and no element's sum leaves an
//       int64 even where every pixel of the image puts all four corners on
//       it;
//   (b) the scatter and dflow: a group of `lanes` lanes (a power of
//       two, ops/cuda/_common.py::warp_bwd_lanes) serves one pixel, lane l
//       the channels l, l + lanes, ..., so that one 64-bit reduction of the
//       group covers consecutive accumulators (sm_90 has no vector 64-bit
//       atomic). A term that is not finite adds nothing and sets its
//       element's class bits instead (+Inf 1, -Inf 2, both or NaN 3) by a
//       32-bit atomic OR. dflow is each lane's float32 sum over its
//       channels in channel order, then a fixed shuffle tree inside the
//       group: its order depends on C alone, so it too has the same bits in
//       every launch;
//   (c) convert: an element of class 0 becomes float32(sum) * 2^-s with its
//       image's s (one rounding of the integer sum to float32; the scaling
//       by a power of two is exact unless the result is subnormal), then in
//       bf16 the one rounding to the model dtype; class 1, 2, 3 give +Inf,
//       -Inf, NaN, the class any float sum of those terms has in any order.
// Accuracy: each term is off by at most 2^-(s+1) < 2^(k+e-63), e its image's,
// so an element that n terms reach is off by at most n 2^(k+e-63) <=
// n 2^(k-62) of its image's max|g|: with its usual n <= 4 terms 2^(k-60)
// (2^-44, 6e-14, at the 384x448 training step's finest call, k = 16), at
// most 4 Ho W terms 2^(2k-62) (1e-9). That bound is absolute, not relative:
// a term below 2^(k-63) of its image's max|g| (2^-47 at that call) rounds to
// 0, and an element whose sum is r of that max keeps about n 2^(k-62) / r
// of relative precision where the float32 sum keeps 2^-24 (at k = 16 and
// n = 4, below float32's where r < 2^-20, 1e-6). Images are independent:
// one image's g at 1e-8 of another's loses nothing.
//
// Bound on the H100: bytes. The function reads g, f1's corners and the flow
// and writes df1 and dflow; this design also reads g a second time (phase
// 0) and writes, reduces into and reads back 8 bytes of scratch an element
// of df1 (chip_smoke.py reports that traffic beside the bound).
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace pwc {

constexpr int kWarpBwdThreads = 256;
constexpr int kMaxBlocks = 4096;  // the grid's cap, and phase 0's words in the scratch
constexpr int kSumBits = 62;      // every fixed-point sum stays below 2^kSumBits in magnitude
constexpr int kMaxDevices = 64;
// offsets are 32-bit (fewer instructions a pixel than 64-bit ones, measured):
// f1, g, the flow and df1 hold at most 2^30 elements, so that every element
// offset, stride step and flow index stays below 2^31; the int64 scratch
// (8 bytes an element, 2^33 bytes at most) is indexed by the same element
// offsets, scaled to bytes in 64-bit address arithmetic
constexpr size_t kMaxElements = size_t{1} << 30;
// the element classes, two bits each, 16 elements a 32-bit word
constexpr unsigned kPosInf = 1, kNegInf = 2, kNaN = 3;

// int64 words of the scratch for n elements of df1 in B images: n
// accumulators, the class words of n elements (2 words of 32 bits an int64),
// then 32-bit words: phase 0's, one a block and image (at most
// max(kMaxBlocks, B) <= kMaxBlocks + B), and one scale an image
// (ops/cuda/_common.py::warp_bwd_scratch)
inline size_t scratch_words(size_t n, size_t B) { return n + (n + 31) / 32 + kMaxBlocks / 2 + B; }

// 2^x as a float32, x in [-126, 127]
__device__ __forceinline__ float pow2f(int x) { return __int_as_float((x + 127) << 23); }

// the exponent e of math.frexp: m 2^e, m in [0.5, 1), for the bits of a
// finite float >= 0 (0 gives 0)
__device__ __forceinline__ int frexp_exponent(unsigned bits) {
  if (bits == 0) return 0;
  const int biased = bits >> 23;
  return biased > 0 ? biased - 126 : (32 - __clz(bits)) - 149;
}

// the largest finite |value| of 8 values, as float bits (0 if none)
template <typename T>
__device__ __forceinline__ unsigned max_bits8(const T* p) {
  float v[8];
  load8(p, v);
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned b = __float_as_uint(fabsf(v[k]));
    if (b < 0x7f800000u) m = max(m, b);
  }
  return m;
}

// df1's term w * g: its fixed point into the accumulator, or, not finite, its class
__device__ __forceinline__ void add_term(unsigned long long* acc, unsigned* cls, int i, float term, float fa,
                                         float fb) {
  if (fabsf(term) <= 3.402823466e38f) {  // false for Inf and NaN
    atomicAdd(acc + i, static_cast<unsigned long long>(__float2ll_rn(term * fa * fb)));
  } else {
    const unsigned c = term != term ? kNaN : term > 0.f ? kPosInf : kNegInf;
    atomicOr(cls + i / 16, c << (2 * (i % 16)));
  }
}

// 2^-s as a double, s in [-98, 208]
__device__ __forceinline__ double inv_pow2(int s) { return __longlong_as_double(static_cast<long long>(1023 - s) << 52); }

// the largest m of the block's threads, to every thread (warp_max: a shared word a warp)
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* warp_max) {
  m = __reduce_max_sync(0xffffffffu, m);
  __syncthreads();  // the last reads of warp_max are done
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  for (int w = 0; w < kWarpBwdThreads / 32; ++w) m = max(m, warp_max[w]);
  return m;
}

// element of class c with fixed-point sum a, back in float32
__device__ __forceinline__ float value(long long a, unsigned c, double inv) {
  if (c == 0) return static_cast<float>(static_cast<double>(__ll2float_rn(a)) * inv);
  return __uint_as_float(c == kPosInf ? 0x7f800000u : c == kNegInf ? 0xff800000u : 0x7fc00000u);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(reinterpret_cast<const unsigned&>(lo), reinterpret_cast<const unsigned&>(hi));
}

// g, flow, dflow: Ho rows; f1, df1: Hf rows; flow row j is frame row j + row0
// and scatters only where j + row0 lies in [vlo, vhi]. scratch: int64 words
// (scratch_words(B Hf W C, B)), overwritten.
template <typename T, typename F>
__global__ void __launch_bounds__(kWarpBwdThreads)
    warp_bwd_coop_kernel(const T* __restrict__ f1, const F* __restrict__ flow, const T* __restrict__ g,
                         long long* __restrict__ scratch, T* __restrict__ df1, F* __restrict__ dflow, int B, int Ho,
                         int Hf, int W, int C, int row0, int vlo, int vhi, int lanes_log2) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned warp_max[kWarpBwdThreads / 32];
  const int tid = blockIdx.x * kWarpBwdThreads + threadIdx.x;
  const int nthreads = gridDim.x * kWarpBwdThreads;
  const int n = B * Hf * W * C;
  const int zeroed = n + (n + 31) / 32;  // the accumulators and class words, in int64 words
  auto* acc = reinterpret_cast<unsigned long long*>(scratch);
  auto* cls = reinterpret_cast<unsigned*>(scratch + n);
  auto* part_max = reinterpret_cast<unsigned*>(scratch + zeroed);
  auto* scales = reinterpret_cast<int*>(part_max + kMaxBlocks + B);
  const int lane = threadIdx.x % 32;

  // (a) zero the scratch (bypassing L1: the atomics and phase (c) work in L2) ...
  for (int i = tid; i < zeroed / 2; i += nthreads)
    __stcg(reinterpret_cast<longlong2*>(scratch) + i, make_longlong2(0, 0));
  if (zeroed % 2 && tid == 0) __stcg(scratch + zeroed - 1, 0LL);
  // ... and each image's largest finite |g| over the rows that scatter: rows
  // [jlo, jhi] of the image, a contiguous run of g, in `per` parts
  const int row = W * C;
  const int jlo = max(vlo - row0, 0);
  const int jhi = min(vhi - row0, Ho - 1);
  const int run = (jhi - jlo + 1) * row;
  const bool by8 = row % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int per = max((int)gridDim.x / B, 1);
  for (int u = blockIdx.x; u < B * per; u += gridDim.x) {  // uniform in the block
    const T* p = g + ((u / per) * Ho + jlo) * row;
    const int stride = per * kWarpBwdThreads;
    unsigned m = 0;
    if (by8) {
      for (int i = u % per * kWarpBwdThreads + threadIdx.x; i < run / 8; i += stride) m = max(m, max_bits8(p + 8 * i));
    } else {
      for (int i = u % per * kWarpBwdThreads + threadIdx.x; i < run; i += stride) {
        const unsigned bits = __float_as_uint(fabsf(to_f32(p[i])));
        if (bits < 0x7f800000u) m = max(m, bits);
      }
    }
    m = block_max(m, warp_max);
    if (threadIdx.x == 0) __stcg(part_max + u, m);
  }
  grid.sync();

  // (s) each image's max|g| from its parts, and its scale
  const int k = 64 - __clzll(4LL * Ho * W - 1);
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    unsigned m = 0;
    for (int i = threadIdx.x; i < per; i += kWarpBwdThreads) m = max(m, __ldcg(part_max + b * per + i));
    m = block_max(m, warp_max);
    // s in [-98, 208]: k in [2, 32], e in [-148, 128]
    if (threadIdx.x == 0) __stcg(scales + b, kSumBits - k - frexp_exponent(m));
  }
  grid.sync();

  // (b) the scatter and dflow
  const int lanes = 1 << lanes_log2;
  const int sub = lane & (lanes - 1);
  const int pixels = B * Ho * W;
  const int step = nthreads / 32 * (32 >> lanes_log2);  // warp w takes pixels w * per_warp + k * step
  const float hmax = (float)(Hf - 1);
  const float wmax = (float)(W - 1);
  for (int first = tid / 32 * (32 >> lanes_log2); first < pixels; first += step) {  // uniform in the warp
    const int pix = first + (lane >> lanes_log2);
    const int gy = pix / W % Ho + row0;
    float dfx = 0.f;
    float dfy = 0.f;
    if (pix < pixels && gy >= vlo && gy <= vhi) {
      const int gx = pix % W;
      const int img = pix / (Ho * W);
      const int frame = img * Hf * W;
      const int s = __ldcg(scales + img);
      const int sa = min(max(s, -126), 127);
      const float fa = pow2f(sa);      // w * g * fa * fb = w * g * 2^s, both products exact:
      const float fb = pow2f(s - sa);  // |w g| <= max|g| keeps them below 2^62
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
      for (int c = sub; c < C; c += lanes) {
        const float gc = to_f32(g[pix * C + c]);
        const float p00 = to_f32(f1[i00 + c]), p01 = to_f32(f1[i01 + c]);
        const float p10 = to_f32(f1[i10 + c]), p11 = to_f32(f1[i11 + c]);
        dfx = fmaf(gc, wy0 * (p01 - p00) + wy1 * (p11 - p10), dfx);
        dfy = fmaf(gc, wx0 * (p10 - p00) + wx1 * (p11 - p01), dfy);
        add_term(acc, cls, i00 + c, w00 * gc, fa, fb);
        add_term(acc, cls, i01 + c, w01 * gc, fa, fb);
        add_term(acc, cls, i10 + c, w10 * gc, fa, fb);
        add_term(acc, cls, i11 + c, w11 * gc, fa, fb);
      }
    }
    for (int t = lanes >> 1; t > 0; t >>= 1) {  // inside the pixel's group only
      dfx += __shfl_xor_sync(0xffffffffu, dfx, t);
      dfy += __shfl_xor_sync(0xffffffffu, dfy, t);
    }
    if (sub == 0 && pix < pixels) {
      dflow[pix * 2] = from_f32<F>(dfx);
      dflow[pix * 2 + 1] = from_f32<F>(dfy);
    }
  }
  grid.sync();

  // (c) each sum back to float32 (x 2^-s of its image), then into the model dtype, 4 elements a thread
  const int image = Hf * W * C;
  for (int i = tid; i < n / 4; i += nthreads) {
    const int e = 4 * i;
    const double inv = inv_pow2(__ldcg(scales + e / image));
    const bool one = e + 3 < (e / image + 1) * image;  // elements e .. e + 3 in one image (else each its own)
    auto inv_at = [&](int q) { return one ? inv : inv_pow2(__ldcg(scales + (e + q) / image)); };
    const longlong2 a = __ldcg(reinterpret_cast<const longlong2*>(scratch) + 2 * i);
    const longlong2 b = __ldcg(reinterpret_cast<const longlong2*>(scratch) + 2 * i + 1);
    const unsigned c = __ldcg(cls + i / 4) >> (8 * (i % 4));  // elements 4i .. 4i + 3
    store4(df1 + e, value(a.x, c & 3, inv), value(a.y, (c >> 2) & 3, inv_at(1)), value(b.x, (c >> 4) & 3, inv_at(2)),
           value(b.y, (c >> 6) & 3, inv_at(3)));
  }
  for (int i = n / 4 * 4 + tid; i < n; i += nthreads)
    df1[i] = from_f32<T>(value(__ldcg(scratch + i), (__ldcg(cls + i / 16) >> (2 * (i % 16))) & 3,
                               inv_pow2(__ldcg(scales + i / image))));
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

// The grid: enough blocks for one pass of the scatter (`lanes` threads a
// pixel) or of the conversion (4 elements a thread), at most the resident
// blocks and kMaxBlocks; ops/cuda/_common.py::warp_bwd_blocks is its model.
inline unsigned grid_blocks(size_t pixels, int lanes, size_t n, int resident) {
  const size_t t = kWarpBwdThreads;
  const size_t need = std::max((pixels * lanes + t - 1) / t, (n / 4 + t - 1) / t);
  return (unsigned)std::max<size_t>(1, std::min<size_t>(need, (size_t)std::min(resident, kMaxBlocks)));
}

template <typename T, typename F>
cudaError_t run(const void* f1, const void* flow, const void* g, void* scratch, void* df1, void* dflow, int B,
                int Ho, int Hf, int W, int C, int row0, int vlo, int vhi, int lanes, cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  if (lanes < 1 || lanes > 32 || (1 << lanes_log2) != lanes) return cudaErrorInvalidValue;
  if (scratch == nullptr || !aligned16(scratch) || !aligned16(df1)) return cudaErrorInvalidValue;
  const size_t pixels = (size_t)B * Ho * W;
  const size_t n = (size_t)B * Hf * W * C;
  if (pixels == 0 || n == 0) return cudaSuccess;
  if (n > kMaxElements || pixels * std::max(C, 2) > kMaxElements) return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_blocks<T, F>(&resident);
  if (err != cudaSuccess) return err;
  auto pf1 = static_cast<const T*>(f1);
  auto pflow = static_cast<const F*>(flow);
  auto pg = static_cast<const T*>(g);
  auto ps = static_cast<long long*>(scratch);
  auto pdf1 = static_cast<T*>(df1);
  auto pdflow = static_cast<F*>(dflow);
  void* args[] = {&pf1, &pflow, &pg, &ps, &pdf1, &pdflow, &B, &Ho, &Hf, &W, &C, &row0, &vlo, &vhi, &lanes_log2};
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
// dtype 0 (f32) or 1 (bf16) like the rest. scratch: 16-byte aligned int64
// words, pwc_warp_bwd_scratch_words(B H W C, B) of them, overwritten. lanes: a
// power of two up to 32, the lanes that serve one pixel (warp_bwd_lanes).
extern "C" int pwc_warp_bwd(const void* f1, const void* flow, const void* g, void* scratch, void* df1,
                            void* dflow, int B, int H, int W, int C, int lanes, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32:
      return pwc::run<float, float>(f1, flow, g, scratch, df1, dflow, B, H, H, W, C, 0, 0, H - 1, lanes, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16, __nv_bfloat16>(f1, flow, g, scratch, df1, dflow, B, H, H, W, C, 0, 0, H - 1,
                                                    lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tall-frame variant (K9b). f1, df1: (B, Hf, W, C); g: (B, Ho, W, C); flow, dflow: (B, Ho, W, 2)
// float32 pixels, x first, flow row j at frame row j + row0; rows with j + row0 outside [vlo, vhi] read
// g as zero (g itself is not written). scratch as for pwc_warp_bwd (for B Hf W C elements in B images). f1, g and
// df1 are of one dtype (0 f32 / 1 bf16).
extern "C" int pwc_warp_bwd_rows(const void* f1, const void* flow, const void* g, void* scratch, void* df1,
                                 void* dflow, int B, int Ho, int Hf, int W, int C, int row0, int vlo, int vhi,
                                 int lanes, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pwc::kF32:
      return pwc::run<float, float>(f1, flow, g, scratch, df1, dflow, B, Ho, Hf, W, C, row0, vlo, vhi, lanes, s);
    case pwc::kBF16:
      return pwc::run<__nv_bfloat16, float>(f1, flow, g, scratch, df1, dflow, B, Ho, Hf, W, C, row0, vlo, vhi,
                                            lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// int64 words of the scratch a call on n elements of df1 in B images takes (the
// wrappers allocate _common.warp_bwd_scratch(n, B); chip_smoke.py checks the two agree).
extern "C" long long pwc_warp_bwd_scratch_words(long long n, long long B) {
  return (long long)pwc::scratch_words((size_t)n, (size_t)B);
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
