// R1: RAFT's correlation lookup, the radius-4 windows of all four pyramid
// levels of every query pixel in one launch (ops/corr_lookup.py `lookup`;
// its plain version is `lookup_plain`, which builds each level's sampling
// grid in about ten small launches, runs grid_sample on it and concatenates
// the four levels: about 42 launches and 1 GB of traffic an update at
// 448x1024 B=16, against the 333 MB that the work needs).
//
// Replaces no TPU kernel: the JAX package has no RAFT. The id is the port's
// own (R for RAFT).
//
// Bound: memory. Per query pixel and level the 81 taps read a 10x10 float32
// window of the query's own map and write 81 floats. No byte is reused
// across query pixels (each has its own map) or across updates (the pyramid
// is 4.4 GB at B=16, far above the 50 MB L2), and 7 flops a tap make about
// 0.6 flop a byte. benchmark/raft_work.py `lookup_bound` counts the 400 B
// window and the 324 B of outputs a level at 3.35 TB/s; the window's ten
// rows of 40 B fetch whole 32-byte sectors, about 1.7x the window's bytes.
//
// Design: one warp a query pixel, three phases on the warp's own shared
// memory, joined by __syncwarp:
//   1. the 72 tap positions (9 offsets on each axis at 4 levels), one a lane
//      in three rounds, in the plain path's float32 roundings (below);
//   2. each level's window, the rows of the query's map that its taps touch,
//      read with read-only loads into an 11x11 box (zeros outside the map;
//      the 11th row and column only where rounding moved a floor), all four
//      levels' loads issued before any is stored;
//   3. the 324 outputs blended from the box, four channels a lane written as
//      one 16-byte store, so each warp store covers 512 contiguous bytes.
// Offsets into the maps are 64-bit: level 0 at B=16 is 3.3 GB.
//
// Each tap's position follows the plain path's roundings, every step rounded
// on its own (no contraction into an FMA):
//   at = x / 2**k + (i - r);  g = 2 at / (size - 1) - 1;
//   pos = ((g + 1) / 2) (size - 1)   (grid_sample, align_corners=True);
// then floor, the corner weights (c0 + 1 - pos, pos - c0) and their products
// as ATen's CUDA grid sampler forms them, and zero for a corner outside the
// map. The blend is ATen's sum in the order nw, ne, sw, se with each term
// fused into the sum. A non-finite coordinate reads zeros.
#include "common.cuh"

namespace pwc {

constexpr int kLookupLevels = 4;
constexpr int kLookupRadius = 4;
constexpr int kLookupTaps = 2 * kLookupRadius + 1;  // offsets an axis
constexpr int kLookupBox = kLookupTaps + 2;  // a box side: the window's 10, and one for a floor moved by rounding
constexpr int kLookupBoxArea = kLookupBox * kLookupBox;
constexpr int kLookupChannels = kLookupLevels * kLookupTaps * kLookupTaps;  // 324
constexpr int kLookupWarps = 8;  // query pixels a block
constexpr int kLookupOff = -(1 << 30);  // a tap neither of whose corners lies in the map

struct LookupMaps {
  const float* map[kLookupLevels];  // level k: (n, h[k], w[k]) contiguous
  int h[kLookupLevels], w[kLookupLevels];
};

// One axis of one tap: the first corner, the two corners' weights, and the
// floor as computed (any value: it sets the window's extent).
struct __align__(16) LookupTap {
  int c0;
  float a, b;
  float fl;
};

struct LookupWarp {
  LookupTap tap[kLookupLevels][2][kLookupTaps];  // [level][x, y][offset]
  float box[kLookupLevels][kLookupBoxArea];      // [level][row * 11 + column]
  int2 origin[kLookupLevels];                    // the box's first column and row
};

// Level k's entry of one of the kernel's parameter arrays, picked by value: indexing the parameters by a
// register, or taking their address, would copy them to local memory.
template <typename T>
__device__ __forceinline__ T at_level(int k, T a0, T a1, T a2, T a3) {
  return k == 0 ? a0 : k == 1 ? a1 : k == 2 ? a2 : a3;
}
#define PWC_AT_LEVEL(a, k) at_level(k, (a)[0], (a)[1], (a)[2], (a)[3])

__device__ __forceinline__ LookupTap lookup_tap(float x, int level, int offset, int size) {
  const float span = static_cast<float>(size - 1);
  const float at = __fadd_rn(__fdiv_rn(x, static_cast<float>(1 << level)), static_cast<float>(offset));
  const float g = __fsub_rn(__fdiv_rn(__fmul_rn(2.f, at), span), 1.f);
  const float pos = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f), span);  // (g + 1) / 2 exactly
  LookupTap t;
  t.fl = floorf(pos);
  if (t.fl >= -1.f && t.fl <= span) {  // corner c0 or c0 + 1 in [0, size)
    t.c0 = static_cast<int>(t.fl);
    t.a = __fsub_rn(__fadd_rn(t.fl, 1.f), pos);
    t.b = __fsub_rn(pos, t.fl);
  } else {
    t.c0 = kLookupOff;
    t.a = t.b = 0.f;
  }
  return t;
}

// The box's first index and its extent on one axis: the corners in the map of
// every tap lie in [max(floor_0, -1), min(floor_8 + 1, size - 1)], since the
// positions rise with the offset. A tap that reaches the map lies within 9 of
// it, where the positions' rounding errors are far below a pixel, so floor_8 -
// floor_0 is at most 9 and each such tap's c0 lies 0 to 9 past the box's
// first index: its four corners are in the box (zeros where off the map).
__device__ __forceinline__ int2 lookup_extent(float fl_first, float fl_last, int size) {
  const float lo = fmaxf(fl_first, -1.f);  // fmaxf and fminf drop a NaN
  const float hi = fminf(fl_last + 1.f, static_cast<float>(size - 1));
  if (!(lo <= hi)) return make_int2(0, 0);
  const int origin = static_cast<int>(lo);
  return make_int2(origin, min(static_cast<int>(hi) - origin + 1, kLookupBox));
}

__global__ void __launch_bounds__(kLookupWarps * 32)
raft_lookup_kernel(LookupMaps maps, const float* __restrict__ coords, float* __restrict__ out, int n) {
  __shared__ LookupWarp smem[kLookupWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kLookupWarps + warp;
  if (q >= n) return;
  LookupWarp& s = smem[warp];
  const float cx = __ldg(coords + 2 * q), cy = __ldg(coords + 2 * q + 1);

  // 1. tap positions: entry e is level e / 18, axis (e / 9) % 2, offset e % 9
#pragma unroll
  for (int e = lane; e < kLookupLevels * 2 * kLookupTaps; e += 32) {
    const int level = e / (2 * kLookupTaps), axis = (e / kLookupTaps) & 1, i = e % kLookupTaps;
    s.tap[level][axis][i] = lookup_tap(axis ? cy : cx, level, i - kLookupRadius,
                                       axis ? PWC_AT_LEVEL(maps.h, level) : PWC_AT_LEVEL(maps.w, level));
  }
  __syncwarp();

  // 2. the windows: box entry p = lane + 32 j is row p / 11, column p % 11
  int row[4], col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    row[j] = (lane + 32 * j) / kLookupBox;
    col[j] = (lane + 32 * j) % kLookupBox;
  }
  float v[kLookupLevels][4];
#pragma unroll
  for (int k = 0; k < kLookupLevels; ++k) {
    const int h = maps.h[k], w = maps.w[k];
    const int2 ex = lookup_extent(s.tap[k][0][0].fl, s.tap[k][0][kLookupTaps - 1].fl, w);
    const int2 ey = lookup_extent(s.tap[k][1][0].fl, s.tap[k][1][kLookupTaps - 1].fl, h);
    if (lane == 0) s.origin[k] = make_int2(ex.x, ey.x);
    const float* map = maps.map[k] + static_cast<size_t>(q) * h * w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = ex.x + col[j], y = ey.x + row[j];
      const bool in = row[j] < ey.y && col[j] < ex.y && x >= 0 && y >= 0;  // x < w, y < h by the extent
      v[k][j] = in ? __ldg(map + y * w + x) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kLookupLevels; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lane + 32 * j < kLookupBoxArea) s.box[k][lane + 32 * j] = v[k][j];
    }
  }
  __syncwarp();

  // 3. the outputs: lane writes channels 4 f .. 4 f + 3 for f = lane, lane + 32, lane + 64
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(q) * kLookupChannels);
#pragma unroll
  for (int f = lane; f < kLookupChannels / 4; f += 32) {
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * f + u;
      const int k = c / (kLookupTaps * kLookupTaps), t = c % (kLookupTaps * kLookupTaps);
      const LookupTap tx = s.tap[k][0][t / kLookupTaps], ty = s.tap[k][1][t % kLookupTaps];
      o[u] = 0.f;
      if (tx.c0 == kLookupOff || ty.c0 == kLookupOff) continue;
      const int2 org = s.origin[k];
      const float* b = s.box[k] + (ty.c0 - org.y) * kLookupBox + (tx.c0 - org.x);  // both in [0, 9]
      const float v00 = b[0], v01 = b[1], v10 = b[kLookupBox], v11 = b[kLookupBox + 1];
      const float nw = __fmul_rn(tx.a, ty.a), ne = __fmul_rn(tx.b, ty.a);
      const float sw = __fmul_rn(tx.a, ty.b), se = __fmul_rn(tx.b, ty.b);
      o[u] = __fmaf_rn(v11, se, __fmaf_rn(v10, sw, __fmaf_rn(v01, ne, __fmul_rn(v00, nw))));
    }
    dst[f] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace pwc

// maps: the pyramid's four float32 levels (n, 1, h_k, w_k), contiguous, each side at least 2;
// coords: (n, 2) float32 (x, y); out: (n, 324) float32, 16-byte aligned.
extern "C" int pwc_corr_lookup(const void* m0, const void* m1, const void* m2, const void* m3, int h0, int w0,
                               int h1, int w1, int h2, int w2, int h3, int w3, const void* coords, void* out,
                               int n, void* stream) {
  pwc::LookupMaps maps{{static_cast<const float*>(m0), static_cast<const float*>(m1),
                        static_cast<const float*>(m2), static_cast<const float*>(m3)},
                       {h0, h1, h2, h3},
                       {w0, w1, w2, w3}};
  for (int k = 0; k < pwc::kLookupLevels; ++k) {
    if (maps.map[k] == nullptr || maps.h[k] < 2 || maps.w[k] < 2) return cudaErrorInvalidValue;
  }
  if (n <= 0 || !pwc::aligned16(out)) return cudaErrorInvalidValue;
  const int blocks = (n + pwc::kLookupWarps - 1) / pwc::kLookupWarps;
  pwc::raft_lookup_kernel<<<blocks, pwc::kLookupWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(coords), static_cast<float*>(out), n);
  return cudaGetLastError();
}

// registers a thread, local memory a thread, static shared memory a block and resident blocks an SM,
// for the build log
extern "C" int pwc_corr_lookup_info(int* regs, int* local_bytes, int* smem_bytes, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, pwc::raft_lookup_kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pwc::raft_lookup_kernel, pwc::kLookupWarps * 32, 0);
}
