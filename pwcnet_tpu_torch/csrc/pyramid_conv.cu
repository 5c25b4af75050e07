// K3: one feature-pyramid level fused into one kernel:
//   conv3x3 stride 2 (SAME) + b1, LeakyReLU(0.1) -> s1
//   conv3x3 (SAME) + b2, LeakyReLU(0.1)           -> s2
//   conv3x3 (SAME) + b3, LeakyReLU(0.1)           -> out
// with float32 accumulation and s1, s2 rounded to the model dtype between
// the convs. When a gradient is wanted the caller passes s1_out and s2_out
// and each block also writes its own tile of s1 and s2 there, the residuals
// of the backward (K6), as _plevel_fwd saves them; serving passes null and
// keeps s1 and s2 in shared memory only.
//
// Replaces pwcnet_tpu/ops/pallas/pyramid_conv.py::pyramid_level_fused
// (banded bodies _plevel_kernel_banded / _plevel_kernel_banded_infer and
// row-loop bodies _plevel_kernel / _plevel_kernel_infer, which compute the
// same function). On the main path it computes the two finest levels of
// both frames: (B, 448, 1024, 3) -> (B, 224, 512, 16) and
// (B, 224, 512, 16) -> (B, 112, 256, 32).
//
// SAME padding. With stride 2 on an even size TF pads only the bottom and
// right, so s1(i, j) reads x rows 2i..2i+2 and cols 2j..2j+2, with row H and
// col W zero. The stride-1 convs pad one on each side. s1 and s2 positions
// outside the level's frame are zero (each conv's own zero padding), not
// values computed past the edge.
//
// Design. One block owns a tile of half-resolution outputs of one batch
// element. It computes s1 on the tile plus a 2-pixel halo, then s2 on a
// 1-pixel halo from s1, then the tile from s2; s1 and s2 live only in
// shared memory.
//
// - float32 (pyramid_level_kernel): 256 threads, tile 14 x 28, every conv
//   as float32 FMAs, register-blocked: a thread sums a column of 7-9
//   positions x 4 or 8 output channels, so each weight broadcast serves 7-9
//   positions. s1 and s2 are position-major (a 16-byte load brings 4
//   channels of a position): conv2 and conv3 at level 1 take 16 shared
//   loads for 256 FMAs. Every sum runs tap by tap and, in a tap, channel by
//   channel, the order of the earlier one-position-a-thread body, so the
//   results are the same bits. conv3 writes the output from registers.
//   The weights are [tap][ci][co] in shared memory, copied from the OIHW
//   kernels by cp.async: w2 lands while conv1 runs, w3 (in w1's place)
//   while conv2 runs. conv1 reads x from device memory: at level 1 16
//   bytes (4 channels) a load, the 16 weights of a tap's 4 channels held
//   in registers; at level 0 (3 channels, 27 MACs a channel) one position
//   a thread with all 16 channels. Every stage hands whole units to
//   224-256 threads; the halo recomputes 1.47x the conv1 and 1.22x the
//   conv2 work. Level 0 takes 103 KB of shared memory (two blocks an SM),
//   level 1 226 KB.
// - bfloat16 (pyramid_level_wg_kernel): tile 8 x 64, conv2 and conv3 (and
//   at level 1 conv1) as implicit GEMMs on wgmma, m64 x N = C with float32
//   sums in registers, both operands read from shared memory by descriptor
//   (hopper.cuh); two warpgroups at level 0 (two blocks an SM), four at
//   level 1 (one), each with up to four m64 tiles in flight. The weights arrive packed for wgmma
//   ([K/16][tap][2][C][8], laid out once by the wrapper), each matrix by one
//   bulk copy on an mbarrier, while conv1 runs. At level 1 x arrives by TMA
//   as four phase planes (row and column parity, every second pixel), so
//   that the stride-2 conv reads consecutive positions like the others;
//   TMA's zero fill outside the image is the bottom/right SAME pad. At level
//   0 (3 channels, whose 6-byte pixels TMA cannot stride) x is staged by
//   coalesced loads and conv1 runs as float32 FMAs from shared memory. The
//   epilogues add the bias, apply the LeakyReLU, round and zero what lies
//   outside the frame straight from the accumulators; the tile's s1, s2
//   and output leave shared memory by 16-byte stores. The halo recomputes
//   1.62x the conv1, 1.35x the conv2 and 1.08x the conv3 work (1.3x of the
//   level's MACs at level 1).
//
// Bound on the H100: the level reads x and writes the output once (about
// 51 MB per bf16 batch of 8 at level 0, 44 MB at level 1) and does
// 2 x 315 x C MACs per output pixel at level 0 (2 x 720 x C at level 1),
// which is bytes-bound at the bf16 tensor-core rate and bound by
// operations at the float32 CUDA-core rate (0.14 / 0.16 ms at levels 0 / 1
// of a 448 x 1024 batch of 8).
#include "conv_fma.cuh"
#include "hopper.cuh"

namespace pwc {

using bf16 = __nv_bfloat16;

// conv1 (3x3, stride 2, bottom/right SAME pad) at half-res (gy, gx), no bias
template <typename T, int CIN, int C>
__device__ __forceinline__ void conv1_at(float (&acc)[C], const T* __restrict__ xb, int H, int W,
                                         int gy, int gx, const float* w_s) {
#pragma unroll
  for (int co = 0; co < C; ++co) acc[co] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = 2 * gy + ky;
    if (iy >= H) continue;  // bottom SAME pad
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = 2 * gx + kx;
      if (ix >= W) continue;  // right SAME pad
      const T* xp = xb + ((size_t)iy * W + ix) * CIN;
      const float* w = w_s + (ky * 3 + kx) * CIN * C;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) axpy<C>(acc, to_f32(xp[ci]), w + ci * C);
    }
  }
}

// ------------------------------------------------------------ float32
// Tile: kPfTH x kPfTW outputs. s1 covers the tile + a 2-position halo (18 x
// 32 positions), s2 the tile + 1 (16 x 30), position-major with a pixel
// stride of C + 4 floats, so that the 16-byte loads of 8 neighbouring
// positions fall on 8 different bank quads. A thread is one of 4 channel
// groups (threadIdx.x % 4) of a unit, a column of R positions: conv1 9 at
// level 1 (2 x 32 units), conv2 8 (2 x 30), conv3 7 (2 x 28).
constexpr int kPfTH = 14, kPfTW = 28;
constexpr int kPfThreads = 256;
constexpr int kPfGroups = 4;
constexpr int kPfS1H = kPfTH + 4, kPfS1W = kPfTW + 4;
constexpr int kPfS2H = kPfTH + 2, kPfS2W = kPfTW + 2;

template <int CIN, int C>
struct PfLayout {
  static_assert((CIN == 3 && C == 16) || (CIN == 16 && C == 32), "the two finest pyramid levels");
  static constexpr int kNJ = C / (4 * kPfGroups);  // float4s of output channels a thread: 1 at level 0, 2 at level 1
  static constexpr int kPix = C + 4;               // pixel stride of s1, s2 (floats)
  // offsets (floats): s1 | s2 | wA (w1, then w3) | wB (w2) | biases
  static constexpr int kS1 = 0;
  static constexpr int kS2 = kS1 + kPfS1H * kPfS1W * kPix;
  static constexpr int kWA = kS2 + kPfS2H * kPfS2W * kPix;
  static constexpr int kWB = kWA + 9 * C * C;
  static constexpr int kBias = kWB + 9 * C * C;
  static constexpr size_t kBytes = (size_t)(kBias + 3 * C) * sizeof(float);
  static_assert(kWA % 4 == 0 && kWB % 4 == 0, "weights are read as float4s");
  static_assert(kBytes <= 232448, "at most 227 KB of shared memory per block");
};

// conv1 at level 1 (16 input channels, stride 2, bottom/right SAME pad) at R
// positions down one column, level rows gy0.. and column gx, channels as
// conv_col_s1 (conv_fma.cuh) and summed in the same order (tap, then
// channel, as conv1_at). x is read from device memory (L1 and L2) 4
// channels at a time; the weights of a tap's 4 channels sit in registers
// while the column's R positions are summed. Positions outside the frame
// sum whatever they read: the caller zeroes them.
template <int C, int R, int NJ>
__device__ __forceinline__ void conv1_col_s2(float (&acc)[R][4 * NJ], const float* __restrict__ xb, int H, int W,
                                             int gy0, int gx, const float* w_s, int tn) {
  constexpr int CIN = 16;
  zero_acc(acc);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const int ix = 2 * gx + kx;
    const bool col_ok = ix >= 0 && ix < W;  // ix == W: the right SAME pad
#pragma unroll
    for (int c4 = 0; c4 < CIN / 4; ++c4) {
      float4 w[4][NJ];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int h = 0; h < NJ; ++h)
          w[c][h] = *reinterpret_cast<const float4*>(w_s + (tap * CIN + 4 * c4 + c) * C + 4 * tn + h * (C / NJ));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int iy = 2 * (gy0 + r) + ky;
        float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col_ok && iy >= 0 && iy < H)  // iy == H: the bottom SAME pad
          xv = __ldg(reinterpret_cast<const float4*>(xb + ((size_t)iy * W + ix) * CIN + 4 * c4));
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < NJ; ++h) {
            acc[r][4 * h + 0] = fmaf(xs[c], w[c][h].x, acc[r][4 * h + 0]);
            acc[r][4 * h + 1] = fmaf(xs[c], w[c][h].y, acc[r][4 * h + 1]);
            acc[r][4 * h + 2] = fmaf(xs[c], w[c][h].z, acc[r][4 * h + 2]);
            acc[r][4 * h + 3] = fmaf(xs[c], w[c][h].w, acc[r][4 * h + 3]);
          }
      }
    }
  }
}

// bias + LeakyReLU of a unit's sums at region rows y0.. and column x, the
// region's (0, 0) being level position (gy0, gx0): into position-major
// `planes` of pixel stride P (when given), zero outside the frame, and, for
// the positions of the block's own tile (`halo` rows and columns into the
// region) inside the frame, into NHWC `dst` (when given); 16-byte stores
template <int C, int R, int NJ, int P>
__device__ __forceinline__ void epi_col(const float (&acc)[R][4 * NJ], const float* bias, int tn, float* planes,
                                        int row, int y0, int x, int gy0, int gx0, int halo,
                                        float* __restrict__ dst, int b, int HH, int WH) {
  const int gx = gx0 + x;
  const bool col_in = gx >= 0 && gx < WH;
  const bool col_tile = x >= halo && x < halo + kPfTW;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r, gy = gy0 + y;
    const bool inside = col_in && gy >= 0 && gy < HH;
#pragma unroll
    for (int h = 0; h < NJ; ++h) {
      const int co = 4 * tn + h * (C / NJ);
      float4 v;
      v.x = inside ? leaky(acc[r][4 * h + 0] + bias[co + 0]) : 0.f;
      v.y = inside ? leaky(acc[r][4 * h + 1] + bias[co + 1]) : 0.f;
      v.z = inside ? leaky(acc[r][4 * h + 2] + bias[co + 2]) : 0.f;
      v.w = inside ? leaky(acc[r][4 * h + 3] + bias[co + 3]) : 0.f;
      if (planes != nullptr) *reinterpret_cast<float4*>(planes + (y * row + x) * P + co) = v;
      if (dst != nullptr && inside && col_tile && y >= halo && y < halo + kPfTH)
        *reinterpret_cast<float4*>(dst + (((size_t)b * HH + gy) * WH + gx) * C + co) = v;
    }
  }
}

template <int CIN, int C>
__global__ void __launch_bounds__(kPfThreads, CIN == 3 ? 2 : 1)
    pyramid_level_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                         const float* __restrict__ b1, const float* __restrict__ k2,
                         const float* __restrict__ b2, const float* __restrict__ k3,
                         const float* __restrict__ b3, float* __restrict__ out,
                         float* __restrict__ s1_out, float* __restrict__ s2_out, int H, int W) {
  using L = PfLayout<CIN, C>;
  constexpr int NJ = L::kNJ;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float* s1 = sm + L::kS1;
  float* s2 = sm + L::kS2;
  float* wa = sm + L::kWA;
  float* wb = sm + L::kWB;
  float* bias = sm + L::kBias;

  const int HH = H / 2;
  const int WH = W / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kPfTH;
  const int q0 = blockIdx.x * kPfTW;
  const int tid = threadIdx.x;
  const int tn = tid % kPfGroups;
  const int u = tid / kPfGroups;  // unit
  const float* xb = x + (size_t)b * H * W * CIN;

  // w1 and the biases, then w2 behind them: w2 lands while conv1 runs
  stage_weights_async<CIN, C, kPfThreads>(wa, k1);
  for (int i = tid; i < 3 * C; i += kPfThreads) bias[i] = (i < C ? b1 : i < 2 * C ? b2 : b3)[i % C];
  cp_async_commit();
  stage_weights_async<C, C, kPfThreads>(wb, k2);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // ---- conv1 (stride 2) -> s1 on the tile + 2-position halo, from device memory
  if constexpr (CIN == 3) {  // 27 MACs a channel: one position a thread, all C channels
    for (int p = tid; p < kPfS1H * kPfS1W; p += kPfThreads) {
      const int y = p / kPfS1W, xq = p % kPfS1W;
      const int gy = r0 - 2 + y, gx = q0 - 2 + xq;
      const bool inside = gy >= 0 && gy < HH && gx >= 0 && gx < WH;
      float acc[C];
      if (inside) conv1_at<float, CIN, C>(acc, xb, H, W, gy, gx, wa);
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = inside ? leaky(acc[co] + bias[co]) : 0.f;
#pragma unroll
      for (int co = 0; co < C; co += 4)
        *reinterpret_cast<float4*>(s1 + p * L::kPix + co) = make_float4(acc[co], acc[co + 1], acc[co + 2], acc[co + 3]);
      if (s1_out != nullptr && inside && y >= 2 && y < 2 + kPfTH && xq >= 2 && xq < 2 + kPfTW) {
        float* dst = s1_out + (((size_t)b * HH + gy) * WH + gx) * C;
#pragma unroll
        for (int co = 0; co < C; co += 4)
          *reinterpret_cast<float4*>(dst + co) = make_float4(acc[co], acc[co + 1], acc[co + 2], acc[co + 3]);
      }
    }
  } else if (u < 2 * kPfS1W) {
    const int y0 = (u / kPfS1W) * (kPfS1H / 2), xq = u % kPfS1W;
    float acc[kPfS1H / 2][4 * NJ];
    conv1_col_s2<C, kPfS1H / 2, NJ>(acc, xb, H, W, r0 - 2 + y0, q0 - 2 + xq, wa, tn);
    epi_col<C, kPfS1H / 2, NJ, L::kPix>(acc, bias, tn, s1, kPfS1W, y0, xq, r0 - 2, q0 - 2, 2, s1_out, b, HH, WH);
  }
  cp_async_wait<0>();
  __syncthreads();  // s1 is complete, w2 has landed, w1 is no longer read
  stage_weights_async<C, C, kPfThreads>(wa, k3);  // lands while conv2 runs
  cp_async_commit();

  // ---- conv2 -> s2 on the tile + 1-position halo, from s1
  if (u < 2 * kPfS2W) {
    const int y0 = (u / kPfS2W) * (kPfS2H / 2), xq = u % kPfS2W;
    float acc[kPfS2H / 2][4 * NJ];
    conv_col_s1<C, kPfS2H / 2, NJ, L::kPix>(acc, s1 + (y0 * kPfS1W + xq) * L::kPix, kPfS1W, wb, tn);
    epi_col<C, kPfS2H / 2, NJ, L::kPix>(acc, bias + C, tn, s2, kPfS2W, y0, xq, r0 - 1, q0 - 1, 1, s2_out, b, HH,
                                        WH);
  }
  cp_async_wait<0>();
  __syncthreads();  // s2 is complete, w3 has landed

  // ---- conv3 -> the tile, from s2, to the NHWC output
  if (u < 2 * kPfTW) {
    const int y0 = (u / kPfTW) * (kPfTH / 2), xq = u % kPfTW;
    float acc[kPfTH / 2][4 * NJ];
    conv_col_s1<C, kPfTH / 2, NJ, L::kPix>(acc, s2 + (y0 * kPfS2W + xq) * L::kPix, kPfS2W, wa, tn);
    epi_col<C, kPfTH / 2, NJ, L::kPix>(acc, bias + 2 * C, tn, nullptr, 0, y0, xq, r0, q0, 0, out, b, HH, WH);
  }
}

template <int CIN, int C>
cudaError_t run_f32(const void* x, const void* k1, const void* b1, const void* k2, const void* b2,
                    const void* k3, const void* b3, void* out, void* s1_out, void* s2_out, int B,
                    int H, int W, cudaStream_t stream) {
  using L = PfLayout<CIN, C>;
  // 16-byte stores of the outputs; at level 1 16-byte loads of x
  if (!aligned16(out) || !aligned16(s1_out) || !aligned16(s2_out) || (CIN % 4 == 0 && !aligned16(x)))
    return cudaErrorInvalidValue;
  auto kernel = pyramid_level_kernel<CIN, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kPfTW - 1) / kPfTW, (H / 2 + kPfTH - 1) / kPfTH, B);
  kernel<<<grid, kPfThreads, L::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k1), static_cast<const float*>(b1),
      static_cast<const float*>(k2), static_cast<const float*>(b2), static_cast<const float*>(k3),
      static_cast<const float*>(b3), static_cast<float*>(out), static_cast<float*>(s1_out),
      static_cast<float*>(s2_out), H, W);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bfloat16
// Tile: 8 rows x 64 columns of outputs. s1, s2 and the output tile live in
// shared memory chunk-planar, [C/8][position][8], in planes of row pitch
// kPwP = 69 positions: plane position (y, x) of s1 is level position
// (r0 - 2 + y, q0 - 2 + x), of s2 (r0 - 1 + y, q0 - 1 + x), of the output
// (r0 + y, q0 + x). The convs' GEMM rows are flat plane positions: output
// position p reads source position p + dy * kPwP + dx at tap (dy, dx), so
// 64 consecutive positions of one 8-channel chunk are an m64 operand read
// by descriptor, and a plane row's last columns are computed and dropped.
constexpr int kPwTH = 8;                 // output rows per block
constexpr int kPwTW = 64;                // output columns per block
constexpr int kPwP = kPwTW + 5;          // plane row pitch: s1 reads the x phase planes one column on
constexpr int kPwTiles = 4;              // m64 tiles a warpgroup keeps in flight
constexpr int kPwXRows = kPwTH + 5;      // x phase-plane rows (level 1)


template <int CIN, int C>
struct PwLayout {
  static constexpr bool kL0 = CIN == 3;
  // level 0: two warpgroups, two blocks an SM; level 1 (one block an SM): four
  static constexpr int kThreads = kL0 ? 256 : 512;
  static_assert((CIN == 3 && C == 16) || (CIN == 16 && C == 32), "the two finest pyramid levels");
  // GEMM rows (flat positions, whole m64 tiles) of each conv
  static constexpr int kN1 = round_up((kPwTH + 4) * kPwP, 64);
  static constexpr int kN2 = round_up((kPwTH + 2) * kPwP, 64);
  static constexpr int kN3 = round_up(kPwTH * kPwP, 64);
  // positions per plane: what a conv writes and what the next one reads
  static constexpr int kS1Pos = round_up(imax(kN1, kN2 + 2 * kPwP + 2), 8);
  static constexpr int kS2Pos = round_up(imax(kN2, kN3 + 2 * kPwP + 2), 8);
  static constexpr int kXPos = round_up(imax(kPwXRows * kPwP, kN1 + kPwP + 1), 8);
  // level 0: x rows (2 per s1 row + 1) x elements (3 per pixel) staged as they lie
  static constexpr int kX0Rows = 2 * (kPwTH + 4) + 1;
  static constexpr int kX0Elems = 3 * (2 * (kPwTW + 4) + 1);
  static constexpr int kX0Pitch = kX0Elems + 1;
  static constexpr int kXBytes = kL0 ? round_up(kX0Rows * kX0Pitch * 2, 128) : 2 * 4 * kXPos * 16;
  static constexpr int kS1Bytes = C / 8 * kS1Pos * 16;
  static constexpr int kS2Bytes = C / 8 * kS2Pos * 16;
  static constexpr int kOutBytes = C / 8 * kN3 * 16;
  static constexpr int kW1Copy = kL0 ? 27 * C * 2 : 9 * 2 * C * 16;  // bytes of the packed conv1 weights
  static constexpr int kW1Bytes = round_up(kW1Copy, 128);
  static constexpr int kWBytes = 9 * C * C * 2;  // conv2, conv3
  // offsets: x | s1 | (level 0: s2) | w1 | (level 0: w1 in float32) | w2 | w3 | bias | barriers.
  // Level 1's s2 and the output tile reuse x's space once conv1 is done;
  // level 0's output tile reuses x's.
  static constexpr int kX = 0;
  static constexpr int kS1 = kX + kXBytes;
  static constexpr int kS2 = kL0 ? kS1 + kS1Bytes : kX;
  static constexpr int kOut = kL0 ? kX : kS2 + kS2Bytes;
  static constexpr int kW1 = kL0 ? kS2 + kS2Bytes : kS1 + kS1Bytes;
  static constexpr int kW1f = kW1 + kW1Bytes;
  static constexpr int kW2 = kW1f + (kL0 ? round_up(27 * C * 4, 128) : 0);
  static constexpr int kW3 = kW2 + kWBytes;
  static constexpr int kBias = kW3 + kWBytes;
  static constexpr int kBars = kBias + 3 * C * 4;
  static constexpr int kBytes = kBars + 2 * 8;
  static_assert(kOut + kOutBytes <= kXBytes, "the output tile (and level 1's s2) fit x's space");
  static_assert(kBytes <= 232448, "at most 227 KB of shared memory per block");
};

// bias + LeakyReLU of a tile's accumulators, rounded, into chunk-planar
// planes `pos` positions apart; plane positions outside [0, rows) x
// [0, cols) of the frame-clipped window (origin gy0, gx0 in level
// coordinates) are written as zeros: each conv's own zero padding.
template <int C>
__device__ __forceinline__ void epi_planes(bf16* dst, int pos, int p0, const float (&acc)[C / 2],
                                           const float* bias, int gy0, int gx0, int rows, int cols, int HH,
                                           int WH) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < C / 2; i += 2) {
    const int p = p0 + acc_row(t, i);
    const int c = acc_col(t, i);
    const int y = p / kPwP, x = p % kPwP;
    const int gy = gy0 + y, gx = gx0 + x;
    const bool keep = y < rows && x < cols && gy >= 0 && gy < HH && gx >= 0 && gx < WH;
    const float v0 = keep ? leaky(acc[i] + bias[c]) : 0.f;
    const float v1 = keep ? leaky(acc[i + 1] + bias[c + 1]) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(dst + ((c / 8) * pos + p) * 8 + c % 8) = __floats2bfloat162_rn(v0, v1);
  }
}

// The tile's own TH x TW part of chunk-planar planes (whose position (0, 0)
// is `halo` rows and columns before the tile) -> NHWC device memory, 16
// bytes a thread.
template <int C>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const bf16* src, int pos, int halo, int b,
                                           int r0, int q0, int HH, int WH) {
  for (int e = threadIdx.x; e < kPwTH * kPwTW * (C / 8); e += blockDim.x) {
    const int ch = e % (C / 8);
    const int ox = (e / (C / 8)) % kPwTW;
    const int oy = e / (C / 8) / kPwTW;
    const int gy = r0 + oy, gx = q0 + ox;
    if (gy < HH && gx < WH)
      *reinterpret_cast<uint4*>(dst + (((size_t)b * HH + gy) * WH + gx) * C + ch * 8) =
          *reinterpret_cast<const uint4*>(src + ((size_t)ch * pos + (oy + halo) * kPwP + ox + halo) * 8);
  }
}

template <int CIN, int C>
__global__ void __launch_bounds__(PwLayout<CIN, C>::kThreads, CIN == 3 ? 2 : 1)
    pyramid_level_wg_kernel(const __grid_constant__ CUtensorMap x_map, const bf16* __restrict__ x,
                            const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                            const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                            const bf16* __restrict__ w3, const bf16* __restrict__ b3, bf16* __restrict__ out,
                            bf16* __restrict__ s1_out, bf16* __restrict__ s2_out, int H, int W) {
  using L = PwLayout<CIN, C>;
  extern __shared__ __align__(128) unsigned char pw_smem[];
  bf16* xs = reinterpret_cast<bf16*>(pw_smem + L::kX);
  bf16* s1 = reinterpret_cast<bf16*>(pw_smem + L::kS1);
  bf16* s2 = reinterpret_cast<bf16*>(pw_smem + L::kS2);
  bf16* os = reinterpret_cast<bf16*>(pw_smem + L::kOut);
  float* bias = reinterpret_cast<float*>(pw_smem + L::kBias);
  uint64_t* bar_in = reinterpret_cast<uint64_t*>(pw_smem + L::kBars);  // x (level 1) and w1
  uint64_t* bar_w = bar_in + 1;                                        // w2, w3
  const uint32_t sbase = smem_u32(pw_smem);

  const int HH = H / 2, WH = W / 2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kPwTH;
  const int q0 = blockIdx.x * kPwTW;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_in, 1);
    mbar_init(bar_w, 1);
    mbar_fence_init();
    if constexpr (L::kL0) {
      mbar_arrive_expect_tx(bar_in, L::kW1Copy);
    } else {
      // x as four phase planes (row, column parity) of two 8-channel chunks:
      // plane (py, px) position (i, j) is x pixel (2 (r0 - 2) + py + 2 i,
      // 2 (q0 - 2) + px + 2 j); TMA zero-fills what lies outside the image,
      // which is the stride-2 conv's bottom/right SAME pad
      mbar_arrive_expect_tx(bar_in, 8 * kPwXRows * kPwP * 16 + L::kW1Copy);
      for (int ph = 0; ph < 4; ++ph)
        for (int ch = 0; ch < 2; ++ch)
          tma_load_4d(xs + (size_t)(ph * 2 + ch) * L::kXPos * 8, &x_map, bar_in, 8 * ch,
                      2 * (q0 - 2) + ph % 2, 2 * (r0 - 2) + ph / 2, b);
    }
    bulk_load(pw_smem + L::kW1, w1, L::kW1Copy, bar_in);
    mbar_arrive_expect_tx(bar_w, 2 * L::kWBytes);
    bulk_load(pw_smem + L::kW2, w2, L::kWBytes, bar_w);
    bulk_load(pw_smem + L::kW3, w3, L::kWBytes, bar_w);
  }
  constexpr int kWgs = L::kThreads / 128;
  for (int i = tid; i < 3 * C; i += L::kThreads) bias[i] = __bfloat162float((i < C ? b1 : i < 2 * C ? b2 : b3)[i % C]);
  __syncthreads();  // the barriers are initialised, the biases staged

  // ---- conv1 (stride 2) -> s1 on the tile + 2-pixel halo: (TH + 4) rows x (TW + 4) columns
  if constexpr (L::kL0) {
    // x rows 2 (r0 - 2) .. + 24, pixels 2 (q0 - 2) .. + 136, as they lie (3
    // channels), by 4-byte asynchronous copies, all in flight at once: W is
    // even, so a pair of elements is all inside the image or all outside
    // (zero-filled)
    const int gy0 = 2 * (r0 - 2), ge0 = 3 * 2 * (q0 - 2);
    const bf16* xb = x + (size_t)b * H * W * 3;
    constexpr int kPairs = (L::kX0Elems + 1) / 2;
    for (int e = tid; e < L::kX0Rows * kPairs; e += L::kThreads) {
      const int i = e / kPairs, k = 2 * (e % kPairs);
      const int gy = gy0 + i, ge = ge0 + k;
      const bool in = gy >= 0 && gy < H && ge >= 0 && ge < 3 * W;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(xs + i * L::kX0Pitch + k)),
                   "l"(in ? xb + (size_t)gy * 3 * W + ge : xb), "r"(in ? 4 : 0)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    mbar_wait(bar_in, 0);
    float* w1f = reinterpret_cast<float*>(pw_smem + L::kW1f);  // [tap][ci][co]
    const bf16* w1s = reinterpret_cast<const bf16*>(pw_smem + L::kW1);
    for (int i = tid; i < 27 * C; i += L::kThreads) w1f[i] = __bfloat162float(w1s[i]);
    __syncthreads();
    for (int p = tid; p < L::kN1; p += L::kThreads) {
      const int y = p / kPwP, xq = p % kPwP;
      const int gy = r0 - 2 + y, gx = q0 - 2 + xq;
      const bool keep = y < kPwTH + 4 && xq < kPwTW + 4 && gy >= 0 && gy < HH && gx >= 0 && gx < WH;
      float acc[C];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = 0.f;
      if (keep) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const bf16* xp = xs + (2 * y + ky) * L::kX0Pitch + 3 * (2 * xq + kx);
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) axpy<C>(acc, __bfloat162float(xp[ci]), w1f + ((ky * 3 + kx) * 3 + ci) * C);
          }
      }
#pragma unroll
      for (int ch = 0; ch < C / 8; ++ch) {
        __align__(16) __nv_bfloat162 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = ch * 8 + 2 * k;
          v[k] = __floats2bfloat162_rn(keep ? leaky(acc[c] + bias[c]) : 0.f,
                                       keep ? leaky(acc[c + 1] + bias[c + 1]) : 0.f);
        }
        *reinterpret_cast<uint4*>(s1 + ((size_t)ch * L::kS1Pos + p) * 8) = *reinterpret_cast<const uint4*>(v);
      }
    }
  } else {
    mbar_wait(bar_in, 0);
    // tap (dy, dx) reads phase (dy % 2, dx % 2) at (y + dy / 2, x + dx / 2); K = 16 channels, one step
    conv_wgmma_tiles<C, 1, kWgs, kPwTiles>(
        L::kN1, L::kXPos * 16, sbase + L::kW1,
        [&](int tap, int) {
          const int dy = tap / 3, dx = tap % 3;
          return sbase + L::kX + (uint32_t)(((dy % 2) * 2 + dx % 2) * 2 * L::kXPos + (dy / 2) * kPwP + dx / 2) * 16;
        },
        [&](int p0, const float(&acc)[C / 2]) {
          epi_planes<C>(s1, L::kS1Pos, p0, acc, bias, r0 - 2, q0 - 2, kPwTH + 4, kPwTW + 4, HH, WH);
        });
  }
  fence_proxy_async();
  __syncthreads();
  if (s1_out != nullptr) store_tile<C>(s1_out, s1, L::kS1Pos, 2, b, r0, q0, HH, WH);

  // ---- conv2 -> s2 on the tile + 1-pixel halo: (TH + 2) rows x (TW + 2) columns
  mbar_wait(bar_w, 0);
  conv_wgmma_tiles<C, C / 16, kWgs, kPwTiles>(
      L::kN2, L::kS1Pos * 16, sbase + L::kW2,
      [&](int tap, int ks) {
        return sbase + L::kS1 + (uint32_t)(2 * ks * L::kS1Pos + (tap / 3) * kPwP + tap % 3) * 16;
      },
      [&](int p0, const float(&acc)[C / 2]) {
        epi_planes<C>(s2, L::kS2Pos, p0, acc, bias + C, r0 - 1, q0 - 1, kPwTH + 2, kPwTW + 2, HH, WH);
      });
  fence_proxy_async();
  __syncthreads();
  if (s2_out != nullptr) store_tile<C>(s2_out, s2, L::kS2Pos, 1, b, r0, q0, HH, WH);

  // ---- conv3 -> the output tile, then to device memory
  conv_wgmma_tiles<C, C / 16, kWgs, kPwTiles>(
      L::kN3, L::kS2Pos * 16, sbase + L::kW3,
      [&](int tap, int ks) {
        return sbase + L::kS2 + (uint32_t)(2 * ks * L::kS2Pos + (tap / 3) * kPwP + tap % 3) * 16;
      },
      [&](int p0, const float(&acc)[C / 2]) {
        epi_planes<C>(os, L::kN3, p0, acc, bias + 2 * C, r0, q0, kPwTH, kPwTW, HH, WH);
      });
  __syncthreads();
  store_tile<C>(out, os, L::kN3, 0, b, r0, q0, HH, WH);
}

// The OIHW kernels are first packed on the card into `packed`: w1 at level
// 0 as [ky][kx][ci][co] (27 x 16), at level 1 for wgmma like w2 and w3,
// [C/16][tap][2][C][8] (ops/cuda/_common.py::pack_wgmma).
template <int CIN, int C>
cudaError_t run_bf16(const void* x, const void* k1, const void* b1, const void* k2, const void* b2,
                     const void* k3, const void* b3, void* out, void* s1_out, void* s2_out, void* packed,
                     int B, int H, int W, cudaStream_t stream) {
  using L = PwLayout<CIN, C>;
  PackJobs jobs{};
  auto* dst = static_cast<bf16*>(packed);
  const void* ks[3] = {k1, k2, k3};
  for (int i = 0; i < 3; ++i) {
    jobs.job[i] = {static_cast<const bf16*>(ks[i]), dst, i == 0 ? CIN : C, C, C, i == 0 && L::kL0, 0};
    dst += packed_elems(jobs.job[i]);
  }
  cudaError_t err = pack_weights(jobs, 3, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap map{};  // level 0 stages x by plain loads (3 channels: no 16-byte strides for TMA)
  if constexpr (!L::kL0) {
    const uint64_t dims[4] = {(uint64_t)CIN, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)CIN * 2, (uint64_t)W * CIN * 2, (uint64_t)H * W * CIN * 2};
    const uint32_t box[4] = {8, 2 * kPwP, 2 * kPwXRows, 1};  // every second pixel: kPwP x kPwXRows
    const uint32_t estride[4] = {1, 2, 2, 1};
    err = make_map_4d(&map, x, dims, strides, box, estride);
    if (err != cudaSuccess) return err;
  }
  auto kernel = pyramid_level_wg_kernel<CIN, C>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kPwTW - 1) / kPwTW, (H / 2 + kPwTH - 1) / kPwTH, B);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      map, static_cast<const bf16*>(x), jobs.job[0].dst, static_cast<const bf16*>(b1), jobs.job[1].dst,
      static_cast<const bf16*>(b2), jobs.job[2].dst, static_cast<const bf16*>(b3), static_cast<bf16*>(out), static_cast<bf16*>(s1_out),
      static_cast<bf16*>(s2_out), H, W);
  return cudaGetLastError();
}

}  // namespace pwc

// x: (B, H, W, cin) with H, W even; k1: (c, cin, 3, 3); k2, k3: (c, c, 3, 3)
// (OIHW); b1..b3: (c,); out: (B, H/2, W/2, c); s1_out, s2_out: like out, or
// both null; packed: bfloat16 scratch for the packed kernels, 27 * 16 +
// 2 * 2304 elements at level 0, 4608 + 2 * 9216 at level 1 (unused in
// float32). All contiguous and of one dtype: 0 f32 / 1 bf16.
// (cin, c) is (3, 16) or (16, 32), the two finest PWCDCNet pyramid levels.
extern "C" int pwc_pyramid_level(const void* x, const void* k1, const void* b1, const void* k2,
                                 const void* b2, const void* k3, const void* b3, void* out,
                                 void* s1_out, void* s2_out, void* packed, int B, int H, int W, int cin,
                                 int c, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool l0 = cin == 3 && c == 16;
  const bool l1 = cin == 16 && c == 32;
#define PWC_LEVEL_ARGS x, k1, b1, k2, b2, k3, b3, out, s1_out, s2_out
  if (dtype == pwc::kF32 && l0) return pwc::run_f32<3, 16>(PWC_LEVEL_ARGS, B, H, W, s);
  if (dtype == pwc::kF32 && l1) return pwc::run_f32<16, 32>(PWC_LEVEL_ARGS, B, H, W, s);
  if (dtype == pwc::kBF16 && l0) return pwc::run_bf16<3, 16>(PWC_LEVEL_ARGS, packed, B, H, W, s);
  if (dtype == pwc::kBF16 && l1) return pwc::run_bf16<16, 32>(PWC_LEVEL_ARGS, packed, B, H, W, s);
#undef PWC_LEVEL_ARGS
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the bf16 kernel of a level, for the build log
extern "C" int pwc_pyramid_level_smem_bytes(int cin, int c) {
  if (cin == 3 && c == 16) return pwc::PwLayout<3, 16>::kBytes;
  if (cin == 16 && c == 32) return pwc::PwLayout<16, 32>::kBytes;
  return 0;
}

// the float32 kernel of a level, for the build log: dynamic shared memory,
// threads and resident blocks an SM
template <int CIN, int C>
static cudaError_t f32_info(int* smem, int* threads, int* blocks) {
  using L = pwc::PfLayout<CIN, C>;
  auto kernel = pwc::pyramid_level_kernel<CIN, C>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  *smem = (int)L::kBytes;
  *threads = pwc::kPfThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, pwc::kPfThreads, L::kBytes);
}

extern "C" int pwc_pyramid_level_f32_info(int cin, int c, int* smem, int* threads, int* blocks) {
  if (cin == 3 && c == 16) return f32_info<3, 16>(smem, threads, blocks);
  if (cin == 16 && c == 32) return f32_info<16, 32>(smem, threads, blocks);
  return cudaErrorInvalidValue;
}
