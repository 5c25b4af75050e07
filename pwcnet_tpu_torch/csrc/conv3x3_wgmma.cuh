// One 3x3 stride-1 SAME bf16 convolution on Hopper's wgmma fed by TMA: the
// core of K7's bf16 forward (estimator_conv.cu) and of its backward, K7b
// (estimator_conv_bwd.cu), which runs the transposed convs on the same
// kernel with the taps mirrored and the channel roles swapped in the packed
// weights (hopper.cuh, PackJob::transposed):
//
//   acc[p, co] = sum_{tap, ci} in[p + tap - (1, 1), ci] * w[tap, ci, co]
//   forward  (BWD false): v = LeakyReLU(acc + bias[co])        (the flow conv: no LeakyReLU)
//   backward (BWD true):  v = (acc (+ add[p, co])) * mask(act[p, co])   (no act: v = acc)
//   out[p, co] = round(v)
//
// the steps of conv3x3_gemm.cuh's conv_epilogue, in its order; mask(a) is 1
// where a >= 0, else 0.1. Sums are float32 and each result is rounded to
// bf16 once, after the add and the mask.
//
// A block owns 8 rows x 30 columns of positions and one N tile of the output
// channels: N = Cout rounded up to a built wgmma width (8, 16, 32, 64, 96 or
// 128), or, where Cout is wider than 128 (K7b's dxin: 147..280 channels),
// ceil(Cout / 128) equal tiles of the narrowest width that holds one
// (wgmma_tiles), one per blockIdx.y, each with its own packed weights. So
// each input tile is staged once for all of a tile's channels. Input
// channels go by 16 at a time through a ring of 4 stages; a stage is two TMA
// boxes of the input tile plus its 1-pixel halo, 10 x 32 positions of 8
// channels each (zero-filled outside the frame: the SAME pad), and one bulk
// copy of that K chunk's weights, packed as [K/16][tap][2][N][8] by one small
// kernel per chain call. One producer warp keeps the ring full; two consumer
// warpgroups each multiply 128 positions, with one stage's products in
// flight while the next stage's are issued. The staged tile has a row pitch
// of 32 positions and the GEMM's rows are its flat positions, so the A
// operand of tap (dy, dx) is the tile shifted by dy * 32 + dx: 64
// consecutive positions are one m64 operand read by descriptor, and the two
// columns past the 30 outputs of each row are computed and dropped (1.07x).
// The sums stay in registers until the last stage is multiplied; then they
// go, still float32, into shared memory (the stages' room), and the store
// loop applies the epilogue to 8 channels at a time, reading bias, add and
// act by 16-byte loads, and writes 16 bytes a thread. Where Cout is no
// multiple of 8 (the forward's 2-channel flow, a dxin of 147) it goes
// channel by channel. TMA needs 16-byte global strides, so the input's
// channels are a multiple of 8: the forward's input arrives padded (zero
// tail, zero weight rows), and K7b pads the 2-channel flow cotangent.
//
// Bound: operations (2 x 9 x Cin x Cout per position, about 1 M a pixel for
// the chain, above the card's 295 operations per byte in bf16).
#pragma once

#include <atomic>

#include "hopper.cuh"

namespace pwc {

constexpr int kEwTH = 8;                    // output rows per block
constexpr int kEwTW = 30;                   // output columns per block
constexpr int kEwPitch = kEwTW + 2;         // staged row pitch (positions)
constexpr int kEwM = kEwTH * kEwPitch;      // GEMM rows per block: 256 flat positions
constexpr int kEwRows = kEwTH + 2;          // staged rows
constexpr int kEwPlane = 328;               // positions per staged plane: 10 x 32 + the last tile's overreach (2)
constexpr int kEwPlaneBytes = kEwPlane * 16;
constexpr int kEwBoxBytes = kEwRows * kEwPitch * 16;
constexpr int kEwStages = 4;
constexpr int kEwConsumers = 256;           // two warpgroups
constexpr int kEwThreads = kEwConsumers + 32;  // + the producer warp
static_assert(kEwM == 4 * 64, "two m64 tiles per consumer warpgroup");
static_assert(kEwPlane >= kEwM - 1 + 2 * kEwPitch + 2 + 1, "the last tap of the last row stays in the plane");

template <int N>
struct EwLayout {
  static constexpr int kWBytes = 9 * 2 * N * 16;               // one K chunk of weights
  static constexpr int kStage = 2 * kEwPlaneBytes + kWBytes;   // a multiple of 128
  static constexpr int kOutPitch = N + 8;                      // epilogue row stride (float32): a half-warp's 8-byte stores hit 32 banks
  static constexpr size_t kBars = (size_t)kEwStages * kStage;
  static constexpr size_t kBytes = kBars + 2 * kEwStages * sizeof(uint64_t);
  static_assert((size_t)kEwM * kOutPitch * sizeof(float) <= kBars, "the epilogue tile reuses the stages");
};

struct EwArgs {
  const __nv_bfloat16* wpk;   // the N tiles one after another, each [Kp/16][9][2][N][8]
  const __nv_bfloat16* bias;  // forward: (Cout,)
  const __nv_bfloat16* add;   // backward: (B, H, W, Cout) or null
  const __nv_bfloat16* act;   // backward: (B, H, W, Cout) or null (no mask)
  __nv_bfloat16* out;         // (B, H, W, Cout)
  int H, W, Cout, ksteps, relu;
  int vec;                    // Cout a multiple of 8 and out, add, act 16-byte aligned: 16-byte stores
};

// V values of a bf16 tensor from `p` into float32 (V = 8: one 16-byte load)
template <int V>
__device__ __forceinline__ void ew_load(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    load8(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// the epilogue on V consecutive channels from co of the value at flat element `at` of out
template <bool BWD, int V>
__device__ __forceinline__ void ew_epilogue(const EwArgs& a, size_t at, int co, float (&v)[V]) {
  if constexpr (!BWD) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] += __bfloat162float(a.bias[co + j]);
      if (a.relu) v[j] = leaky(v[j]);
    }
  } else {
    float t[V];
    if (a.add != nullptr) {
      ew_load<V>(a.add + at, t);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += t[j];
    }
    if (a.act != nullptr) {
      ew_load<V>(a.act + at, t);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] *= t[j] >= 0.f ? 1.f : 0.1f;
    }
  }
}

template <int N, bool BWD>
__global__ void __launch_bounds__(kEwThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap in_map, EwArgs a) {
  using L = EwLayout<N>;
  extern __shared__ __align__(128) unsigned char ew_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ew_smem + L::kBars);
  uint64_t* empty = full + kEwStages;

  const int tiles_x = (a.W + kEwTW - 1) / kEwTW;
  const int ty0 = (blockIdx.x / tiles_x) * kEwTH;
  const int tx0 = (blockIdx.x % tiles_x) * kEwTW;
  const int n0 = blockIdx.y * N;  // this block's N tile of the output channels
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kEwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEwConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kEwConsumers) {  // ---- producer warp: one lane keeps the ring full
    if (tid == kEwConsumers) {
      const __nv_bfloat16* wpk = a.wpk + (size_t)blockIdx.y * a.ksteps * (L::kWBytes / 2);
      for (int k = 0; k < a.ksteps; ++k) {
        const int s = k % kEwStages;
        if (k >= kEwStages) mbar_wait(&empty[s], ((k / kEwStages) - 1) & 1);
        unsigned char* st = ew_smem + (size_t)s * L::kStage;
        mbar_arrive_expect_tx(&full[s], 2 * kEwBoxBytes + L::kWBytes);
        tma_load_4d(st, &in_map, &full[s], 16 * k, tx0 - 1, ty0 - 1, b);
        tma_load_4d(st + kEwPlaneBytes, &in_map, &full[s], 16 * k + 8, tx0 - 1, ty0 - 1, b);
        bulk_load(st + 2 * kEwPlaneBytes, wpk + (size_t)k * (L::kWBytes / 2), L::kWBytes, &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g multiplies flat positions [128 g, 128 g + 128)
  const int g = tid / 128;
  const int t = tid % 128;
  float acc[2][N / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;

  for (int k = 0; k < a.ksteps; ++k) {
    const int s = k % kEwStages;
    mbar_wait(&full[s], (k / kEwStages) & 1);
    const uint32_t st = smem_u32(ew_smem + (size_t)s * L::kStage);
    acc_fence(acc[0]);
    acc_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t db = wg_desc(st + 2 * kEwPlaneBytes + tap * 2 * N * 16, N * 16, 128);
      const int shift = (tap / 3) * kEwPitch + tap % 3;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint64_t da = wg_desc(st + (128 * g + 64 * m + shift) * 16, kEwPlaneBytes, 128);
        Wgmma<N>::mma(acc[m], da, db);
      }
    }
    wg_commit();
    // one group stays in flight: the previous stage's products are done, so its buffers go back
    wg_wait<1>();
    if (k > 0 && t % 32 == 0) mbar_arrive(&empty[(k - 1) % kEwStages]);
  }
  wg_wait<0>();
  acc_fence(acc[0]);
  acc_fence(acc[1]);

  // ---- epilogue: the float32 sums through shared memory, then the epilogue and one rounding
  asm volatile("bar.sync 1, %0;\n" ::"n"(kEwConsumers) : "memory");  // every stage has been read
  float* tile = reinterpret_cast<float*>(ew_smem);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int p = 128 * g + 64 * m + acc_row(t, i);
      *reinterpret_cast<float2*>(tile + p * L::kOutPitch + acc_col(t, i)) = make_float2(acc[m][i], acc[m][i + 1]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kEwConsumers) : "memory");
  const size_t img = (size_t)b * a.H;
  const int nc = min(N, a.Cout - n0);  // live channels of this tile
  if (a.vec) {
    const int vec = nc / 8;
    for (int e = tid; e < kEwM * vec; e += kEwConsumers) {
      const int p = e / vec, v = e % vec;
      const int gy = ty0 + p / kEwPitch, gx = tx0 + p % kEwPitch;
      if (p % kEwPitch < kEwTW && gy < a.H && gx < a.W) {
        const float4* src = reinterpret_cast<const float4*>(tile + p * L::kOutPitch + 8 * v);
        const float4 lo = src[0], hi = src[1];
        float r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const size_t at = ((img + gy) * a.W + gx) * a.Cout + n0 + 8 * v;
        ew_epilogue<BWD, 8>(a, at, n0 + 8 * v, r);
        uint4 q;
        auto* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(r[2 * j], r[2 * j + 1]);
        *reinterpret_cast<uint4*>(a.out + at) = q;
      }
    }
  } else {  // channel by channel
    for (int e = tid; e < kEwM * nc; e += kEwConsumers) {
      const int p = e / nc, c = e % nc;
      const int gy = ty0 + p / kEwPitch, gx = tx0 + p % kEwPitch;
      if (p % kEwPitch < kEwTW && gy < a.H && gx < a.W) {
        float r[1] = {tile[p * L::kOutPitch + c]};
        const size_t at = ((img + gy) * a.W + gx) * a.Cout + n0 + c;
        ew_epilogue<BWD, 1>(a, at, n0 + c, r);
        a.out[at] = __float2bfloat16_rn(r[0]);
      }
    }
  }
}

// The kernel takes more dynamic shared memory than the default limit, which
// is allowed once per device and kernel. A namespace-scope static has
// internal linkage, so each library that includes this header keeps its own
// flags for its own kernels (a function-level static in an inline function
// would be one object shared by every library in the process).
constexpr int kEwMaxDevices = 64;
constexpr int ew_width_index(int n) { return n == 8 ? 0 : n == 16 ? 1 : n == 32 ? 2 : n == 64 ? 3 : n == 96 ? 4 : 5; }
static std::atomic<bool> ew_smem_allowed[kEwMaxDevices][2][6];

template <int N, bool BWD>
cudaError_t allow_wgmma_smem() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::atomic<bool>* done = device < kEwMaxDevices ? &ew_smem_allowed[device][BWD][ew_width_index(N)] : nullptr;
  if (done != nullptr && done->load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<N, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)EwLayout<N>::kBytes);
  if (err == cudaSuccess && done != nullptr) done->store(true, std::memory_order_relaxed);
  return err;
}

template <int N, bool BWD>
cudaError_t run_wgmma(const CUtensorMap& map, const EwArgs& a, int tiles, int B, cudaStream_t stream) {
  cudaError_t err = allow_wgmma_smem<N, BWD>();
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.W + kEwTW - 1) / kEwTW) * ((a.H + kEwTH - 1) / kEwTH), tiles, B);
  conv3x3_wgmma_kernel<N, BWD><<<grid, kEwThreads, EwLayout<N>::kBytes, stream>>>(map, a);
  return cudaGetLastError();
}

// One conv: in (B, H, W, Cin), Cin a multiple of 8 (read by TMA); a.wpk
// holds the N tiles of wgmma_tiles(a.Cout) as TilePacker packs them. Sets
// a.ksteps and a.vec.
template <bool BWD>
cudaError_t conv_wgmma(const void* in, EwArgs a, int B, int Cin, cudaStream_t stream) {
  if (Cin % 8 != 0 || !aligned16(in)) return cudaErrorInvalidValue;
  CUtensorMap map;
  const uint64_t dims[4] = {(uint64_t)Cin, (uint64_t)a.W, (uint64_t)a.H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Cin * 2, (uint64_t)a.W * Cin * 2, (uint64_t)a.H * a.W * Cin * 2};
  const uint32_t box[4] = {8, kEwPitch, kEwRows, 1};
  const uint32_t estride[4] = {1, 1, 1, 1};
  cudaError_t err = make_map_4d(&map, in, dims, strides, box, estride);
  if (err != cudaSuccess) return err;
  a.ksteps = (Cin + 15) / 16;
  a.vec = a.Cout % 8 == 0 && aligned16(a.out) && aligned16(a.add) && aligned16(a.act);
  int n = 0;
  const int tiles = wgmma_tiles(a.Cout, &n);
  switch (n) {
    case 8: return run_wgmma<8, BWD>(map, a, tiles, B, stream);
    case 16: return run_wgmma<16, BWD>(map, a, tiles, B, stream);
    case 32: return run_wgmma<32, BWD>(map, a, tiles, B, stream);
    case 64: return run_wgmma<64, BWD>(map, a, tiles, B, stream);
    case 96: return run_wgmma<96, BWD>(map, a, tiles, B, stream);
    case 128: return run_wgmma<128, BWD>(map, a, tiles, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// For the build log: the dynamic shared memory, registers and resident
// blocks an SM of the kernel of width n (the attribute is set first, so the
// occupancy counts the real shared memory).
template <bool BWD>
cudaError_t wgmma_kernel_info(int n, int* smem, int* regs, int* blocks) {
  const void* fn = nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (n) {
#define PWC_EW_CASE(W)                                                  \
  case W:                                                               \
    fn = reinterpret_cast<const void*>(conv3x3_wgmma_kernel<W, BWD>); \
    *smem = (int)EwLayout<W>::kBytes;                                   \
    err = allow_wgmma_smem<W, BWD>();                                   \
    break;
    PWC_EW_CASE(8)
    PWC_EW_CASE(16)
    PWC_EW_CASE(32)
    PWC_EW_CASE(64)
    PWC_EW_CASE(96)
    PWC_EW_CASE(128)
#undef PWC_EW_CASE
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kEwThreads, (size_t)*smem);
}

// The packed weights of a chain's convs, each cut into the N tiles of
// wgmma_tiles(cout) and packed one tile after another into `dst`, in as few
// launches of the packer as its job table allows.
struct TilePacker {
  __nv_bfloat16* dst;
  cudaStream_t stream;
  PackJobs jobs{};
  int count = 0;

  // kernel k (OIHW as the forward holds it) with K = kdim rows and cout
  // columns (for `transposed` 1, the transpose: kdim its output channels,
  // cout its input channels); *at is where its first tile lands
  cudaError_t add(const void* k, int kdim, int cout, int transposed, const __nv_bfloat16** at) {
    int n = 0;
    const int tiles = wgmma_tiles(cout, &n);
    if (n == 0) return cudaErrorInvalidValue;
    *at = dst;
    for (int j = 0; j < tiles; ++j) {
      if (count == kMaxPackJobs) {
        const cudaError_t err = flush();
        if (err != cudaSuccess) return err;
      }
      PackJob& p = jobs.job[count++];
      p = {static_cast<const __nv_bfloat16*>(k), dst, kdim, cout, n, 0, transposed, j * n};
      dst += packed_elems(p);
    }
    return cudaSuccess;
  }

  cudaError_t flush() {
    if (count == 0) return cudaSuccess;
    const cudaError_t err = pack_weights(jobs, count, stream);
    count = 0;
    return err;
  }
};

}  // namespace pwc
