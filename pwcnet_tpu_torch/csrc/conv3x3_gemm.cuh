// One 3x3 stride-1 SAME convolution as an implicit GEMM with a fused
// epilogue, the building block of K7's float32 forward (estimator_conv.cu)
// and of its backward (estimator_conv_bwd.cu; in bf16 both run on
// conv3x3_wgmma.cuh):
//
//   acc[p, co] = sum_{tap, ci} in[p + tap - (1, 1), ci] * wt[tap', ci, co]
//   v = acc (+ bias[co]) ; (LeakyReLU(0.1)) ; (+ add[p, co]) ; (* mask(act[p, co]))
//   out[p, co] = round(v)
//
// with in (B, H, W, Cin) and out, add, act (B, H, W, Cout), NHWC, and the
// weights tap-major [9][Cin][ldw], ldw = Cout rounded up to a multiple of 8
// with a zero tail. A transposed 3x3 conv is a 3x3 conv with the taps
// mirrored and the channel roles swapped, so the backward passes the very
// array of the forward, which for it reads [9][Cout][ldw] with ldw = Cin
// rounded up, and sets `flip`: tap' is then 8 - tap and the weight tile is
// read transposed.
// mask(a) is 1 where a >= 0, else 0.1 (the LeakyReLU's slope read from its
// saved output). Positions outside the frame read as zero: that is each
// conv's own zero padding of its input. Sums are float32; the result is
// rounded to the model dtype on store.
//
// Channel counts are run-time values (the estimator's inputs are 147..273
// wide, its outputs 128, 128, 96, 64, 32, 2); ragged edges in channels and
// in space are masked when a tile is staged and when it is stored.
//
// float32 (conv3x3_fma_kernel<BN, TW, KC>): CUDA-core FMAs, bound by the
// card's float32 rate (about 1.2 K operations a pixel per byte moved at
// Cin = 147). A block owns 8 rows x TW columns of positions and BN output
// channels, BN matched to the conv's Cout (8, 16, 32, 64, 96 or 128;
// fma_tile_n), so the input tile is staged once for all of a conv's
// outputs (Cout above 128, the backward's dxin, takes the fewest 64/96/128
// tiles). A thread owns one column of 8 positions and 8 channels, 4 at 4 tn
// and 4 at BN/2 + 4 tn (so the float4 weight reads of 8 neighbouring
// threads cover 128 bytes): 64 sums in registers, and per (ci, kx) 10
// input and 6 float4 weight loads for 192 FMAs, at most 128 registers, so
// 512 threads an SM. Input channels go by in chunks of KC through a ring
// filled by cp.async, one barrier a chunk: the tile + 1 halo position-major,
// 16 bytes (4 channels) a copy (4-byte copies where Cin is no multiple of
// 4), zero-filled outside the frame; the weights [tap][ci][co] by 16-byte
// copies of the forward's rows, or with `flip` by 4-byte copies that
// transpose the [tap][co][ci] rows on the way. Wide tiles (TW = 16, 32 for
// BN <= 32) take 8 channels a chunk through 2 stages; where they would give
// fewer than two blocks an SM, narrow ones (TW = 8) take 4 through 3
// stages (fma_tile_w).
#pragma once

#include "common.cuh"

namespace pwc {

constexpr int kCgThreads = 256;
constexpr int kCgTN = 64;  // output channels per block

struct ConvArgs {
  const void* in;
  const void* wt;
  const void* bias;  // (Cout,) or null
  const void* add;   // (B, H, W, Cout) or null
  const void* act;   // (B, H, W, Cout) or null
  void* out;
  int H, W, Cin, Cout;
  int ldw;  // row stride of wt, a multiple of 8 with a zero tail: Cout rounded up, with flip Cin
  int relu;
  int flip;
};

template <typename T>
__device__ __forceinline__ void conv_epilogue(const ConvArgs& a, size_t pixel, int co, float v) {
  if (a.bias != nullptr) v += to_f32(static_cast<const T*>(a.bias)[co]);
  if (a.relu) v = leaky(v);
  const size_t at = pixel * a.Cout + co;
  if (a.add != nullptr) v += to_f32(static_cast<const T*>(a.add)[at]);
  if (a.act != nullptr) v *= to_f32(static_cast<const T*>(a.act)[at]) >= 0.f ? 1.f : 0.1f;
  static_cast<T*>(a.out)[at] = from_f32<T>(v);
}

// ------------------------------------------------------------ float32 FMAs
constexpr int kFmTH = 8;     // tile rows: a thread's column of positions

// The tile widths of an N tile: wide, and narrow for small grids (at least
// 32 threads a block either way).
constexpr int fma_tw_wide(int bn) { return bn >= 64 ? 16 : 32; }
constexpr int fma_tw_narrow(int bn) { return bn >= 32 ? 8 : bn == 16 ? 16 : 32; }

// BN output channels x TW columns x 8 rows, input channels KC a chunk: 8
// through 2 stages on the wide tiles, 4 through 3 on the narrow ones (whose
// blocks then fit three an SM).
template <int BN, int TW, int KC>
struct FmTile {
  static_assert(BN % 8 == 0 && BN <= 128, "8 channels a thread, two float4s");
  static_assert(KC == 4 || KC == 8, "one or two 16-byte copies a pixel");
  static_assert((8 * KC) % TW == 0, "the transposing copies split BN evenly");
  static constexpr int kGroups = BN / 8;            // channel groups, the fastest thread index
  static constexpr int kThreads = kGroups * TW;
  static constexpr int kStages = KC == 4 ? 3 : 2;
  static constexpr int kIW = TW + 2;                // staged columns
  static constexpr int kPix = KC == 8 ? 12 : 4;     // staged pixel stride: 8 neighbouring pixels hit 8 bank quads
  static constexpr int kInFloats = (kFmTH + 2) * kIW * kPix;
  static constexpr int kWS = BN + 8;                // weight row stride: the transposing copies spread over the banks
  static constexpr int kStage = kInFloats + 9 * KC * kWS;
  static constexpr size_t kBytes = (size_t)kStages * kStage * sizeof(float);
};

// bias, LeakyReLU, the added tensor and the mask on 4 channels at once,
// by 16-byte loads and stores (Cout a multiple of 4, every tensor 16-byte aligned)
__device__ __forceinline__ void conv_epilogue4(const ConvArgs& a, size_t pixel, int co, float4 v) {
  float* r = reinterpret_cast<float*>(&v);
  if (a.bias != nullptr) {
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(a.bias) + co);
    v.x += b.x, v.y += b.y, v.z += b.z, v.w += b.w;
  }
  if (a.relu) {
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = leaky(r[j]);
  }
  const size_t at = pixel * a.Cout + co;
  if (a.add != nullptr) {
    const float4 d = *reinterpret_cast<const float4*>(static_cast<const float*>(a.add) + at);
    v.x += d.x, v.y += d.y, v.z += d.z, v.w += d.w;
  }
  if (a.act != nullptr) {
    const float4 m = *reinterpret_cast<const float4*>(static_cast<const float*>(a.act) + at);
    const float* mm = reinterpret_cast<const float*>(&m);
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] *= mm[j] >= 0.f ? 1.f : 0.1f;
  }
  *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) = v;
}

// at most 128 registers a thread: 512 threads an SM
template <int BN, int TW, int KC>
__global__ void __launch_bounds__(FmTile<BN, TW, KC>::kThreads, 512 / FmTile<BN, TW, KC>::kThreads)
    conv3x3_fma_kernel(ConvArgs a, int in16, int vec4) {
  using L = FmTile<BN, TW, KC>;
  extern __shared__ float4 fm_smem_f4[];
  float* smem = reinterpret_cast<float*>(fm_smem_f4);

  const int tiles_x = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * kFmTH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tn = tid % L::kGroups;  // channels 4 tn .. + 3 and BN / 2 + 4 tn .. + 3
  const int tm = tid / L::kGroups;  // column of the tile
  const float* in = static_cast<const float*>(a.in) + (size_t)b * a.H * a.W * a.Cin;
  const float* wt = static_cast<const float*>(a.wt);

  // chunk [c0, c0 + KC) into stage buffer st: inputs [row][col][kPix], weights [tap][ci][kWS]
  auto stage = [&](int c0, float* st) {
    // the thread index through an opaque move: what the copies' addresses
    // derive from it is recomputed each chunk, not hoisted out of the chunk
    // loop into registers the sums need
    int tid;
    asm volatile("mov.u32 %0, %1;\n" : "=r"(tid) : "r"(threadIdx.x));
    for (int e = tid; e < (kFmTH + 2) * L::kIW * (KC / 4); e += L::kThreads) {
      const int p = e / (KC / 4), c = c0 + 4 * (e % (KC / 4));
      const int gy = ty0 - 1 + p / L::kIW;
      const int gx = tx0 - 1 + p % L::kIW;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const float* src = in + ((size_t)gy * a.W + gx) * a.Cin + c;
      float* dst = st + p * L::kPix + (c - c0);
      if (in16) {
        cp_async16(dst, inside && c < a.Cin ? src : in, inside && c < a.Cin);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = inside && c + j < a.Cin;
          cp_async4(dst + j, ok ? src + j : in, ok);
        }
      }
    }
    float* w_s = st + L::kInFloats;
    if (!a.flip) {  // rows of BN output channels, 4 at a time; the zero tail of ldw and beyond reads as zero
      const int v = tid % (BN / 4), co = n0 + 4 * v;
      for (int row = tid / (BN / 4); row < 9 * KC; row += TW / 2) {  // row = tap * KC + ci
        const int ci = row % KC, tap = row / KC;
        const bool ok = c0 + ci < a.Cin && co < a.ldw;
        cp_async16(w_s + row * L::kWS + 4 * v, ok ? wt + ((size_t)tap * a.Cin + c0 + ci) * a.ldw + co : wt, ok);
      }
    } else {  // the forward's [8 - tap][co][ci], transposed element by element
      // a thread copies channel ci of output channels co0 + m T at every tap
      constexpr int T = L::kThreads / KC;
      const int ci = tid % KC, co0 = tid / KC;
      const size_t tap_stride = (size_t)a.Cout * a.ldw;
      const float* src = wt + (size_t)(n0 + co0) * a.ldw + c0 + ci;
#pragma unroll
      for (int m = 0; m < BN / T; ++m) {
        const bool ok = c0 + ci < a.Cin && n0 + co0 + m * T < a.Cout;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          cp_async4(w_s + (tap * KC + ci) * L::kWS + co0 + m * T,
                    ok ? src + (8 - tap) * tap_stride + (size_t)m * T * a.ldw : wt, ok);
      }
    }
  };

  float acc[kFmTH][8];
#pragma unroll
  for (int r = 0; r < kFmTH; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  constexpr int S = L::kStages;
  const int chunks = (a.Cin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < chunks) stage(s * KC, smem + s * L::kStage);
    cp_async_commit();  // one group a chunk, empty past the last, so the wait below counts right
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<S - 2>();  // chunk k has landed (this thread's copies)
    __syncthreads();         // everyone's copies of chunk k; everyone is done with chunk k - 1
    if (k + S - 1 < chunks)  // refill the buffer chunk k - 1 was read from
      stage((k + S - 1) * KC, smem + ((k + S - 1) % S) * L::kStage);
    cp_async_commit();
    const float* in_s = smem + (k % S) * L::kStage;
    const float* w_s = in_s + L::kInFloats + 4 * tn;
    // one (ci, kx) an iteration: unrolled further, ptxas hoists the next loads and spills
#pragma unroll 1
    for (int ck = 0; ck < 3 * KC; ++ck) {
      const int ci = ck / 3, kx = ck % 3;
      float col[kFmTH + 2];
#pragma unroll
      for (int r = 0; r < kFmTH + 2; ++r) col[r] = in_s[(r * L::kIW + tm + kx) * L::kPix + ci];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* w = w_s + ((ky * 3 + kx) * KC + ci) * L::kWS;
        const float4 wa = *reinterpret_cast<const float4*>(w);
        const float4 wb = *reinterpret_cast<const float4*>(w + BN / 2);
#pragma unroll
        for (int r = 0; r < kFmTH; ++r) {
          const float v = col[r + ky];
          acc[r][0] = fmaf(v, wa.x, acc[r][0]);
          acc[r][1] = fmaf(v, wa.y, acc[r][1]);
          acc[r][2] = fmaf(v, wa.z, acc[r][2]);
          acc[r][3] = fmaf(v, wa.w, acc[r][3]);
          acc[r][4] = fmaf(v, wb.x, acc[r][4]);
          acc[r][5] = fmaf(v, wb.y, acc[r][5]);
          acc[r][6] = fmaf(v, wb.z, acc[r][6]);
          acc[r][7] = fmaf(v, wb.w, acc[r][7]);
        }
      }
    }
  }

  const int gx = tx0 + tm;
  if (gx >= a.W) return;
#pragma unroll
  for (int r = 0; r < kFmTH; ++r) {
    const int gy = ty0 + r;
    if (gy >= a.H) break;
    const size_t pixel = ((size_t)b * a.H + gy) * a.W + gx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = n0 + h * (BN / 2) + 4 * tn;
      if (vec4 && co < a.Cout) {
        conv_epilogue4(a, pixel, co, make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < a.Cout) conv_epilogue<float>(a, pixel, co + j, acc[r][4 * h + j]);
      }
    }
  }
}

// The N tile of a conv of `cout` output channels: the smallest that holds
// it, and above 128 the width of the fewest channels computed (ties to the
// wider tile: fewer times the input tile is staged).
inline int fma_tile_n(int cout) {
  const int widths[6] = {8, 16, 32, 64, 96, 128};
  for (int n : widths)
    if (cout <= n) return n;
  const auto padded = [cout](int n) { return (cout + n - 1) / n * n; };
  int best = 128;
  if (padded(96) < padded(best)) best = 96;
  if (padded(64) < padded(best)) best = 64;
  return best;
}

template <int BN, int TW, int KC>
cudaError_t run_fma(const ConvArgs& a, int B, cudaStream_t stream) {
  using L = FmTile<BN, TW, KC>;
  const cudaError_t err = cudaFuncSetAttribute(conv3x3_fma_kernel<BN, TW, KC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int in16 = a.Cin % 4 == 0 && aligned16(a.in);
  const int vec4 = a.Cout % 4 == 0 && aligned16(a.out) && aligned16(a.bias) && aligned16(a.add) && aligned16(a.act);
  const dim3 grid(((a.W + TW - 1) / TW) * ((a.H + kFmTH - 1) / kFmTH), (a.Cout + BN - 1) / BN, B);
  conv3x3_fma_kernel<BN, TW, KC><<<grid, L::kThreads, L::kBytes, stream>>>(a, in16, vec4);
  return cudaGetLastError();
}

// shared memory, threads and resident blocks an SM of the kernel of N tile BN and width tw
template <int BN, int TW, int KC>
cudaError_t fma_info(int* smem, int* threads, int* blocks) {
  using L = FmTile<BN, TW, KC>;
  const cudaError_t err = cudaFuncSetAttribute(conv3x3_fma_kernel<BN, TW, KC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  *smem = (int)L::kBytes;
  *threads = L::kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, conv3x3_fma_kernel<BN, TW, KC>, L::kThreads,
                                                       L::kBytes);
}

// the launch (info == nullptr) or the occupancy query of N tile BN at width tw
template <int BN>
cudaError_t fma_dispatch(const ConvArgs* a, int B, int tw, cudaStream_t stream, int* info) {
  constexpr int wide = fma_tw_wide(BN), narrow = fma_tw_narrow(BN);
  if (tw != wide && tw != narrow) return cudaErrorInvalidValue;
  if constexpr (wide == narrow) {  // N tile 8: one width
    return info != nullptr ? fma_info<BN, wide, 8>(info, info + 1, info + 2) : run_fma<BN, wide, 8>(*a, B, stream);
  } else {
    if (info != nullptr)
      return tw == wide ? fma_info<BN, wide, 8>(info, info + 1, info + 2)
                        : fma_info<BN, narrow, 4>(info, info + 1, info + 2);
    return tw == wide ? run_fma<BN, wide, 8>(*a, B, stream) : run_fma<BN, narrow, 4>(*a, B, stream);
  }
}

inline cudaError_t fma_dispatch(int bn, const ConvArgs* a, int B, int tw, cudaStream_t stream, int* info) {
  switch (bn) {
    case 8: return fma_dispatch<8>(a, B, tw, stream, info);
    case 16: return fma_dispatch<16>(a, B, tw, stream, info);
    case 32: return fma_dispatch<32>(a, B, tw, stream, info);
    case 64: return fma_dispatch<64>(a, B, tw, stream, info);
    case 96: return fma_dispatch<96>(a, B, tw, stream, info);
    case 128: return fma_dispatch<128>(a, B, tw, stream, info);
    default: return cudaErrorInvalidValue;
  }
}

// The tile width of a conv: the wide one, or the narrow one where the wide
// tiles give fewer than two blocks an SM (the 48 x 56 level of a 384 x 448
// frame: 192 blocks at B = 8 on 132 SMs; narrow tiles, 336 blocks, run its
// chain 9% faster, while at 56 x 128, 448 wide blocks, they run 8% slower).
inline int fma_tile_w(int bn, int H, int W, int B, int cout, int sms) {
  const int wide = fma_tw_wide(bn);
  const long blocks = (long)((W + wide - 1) / wide) * ((H + kFmTH - 1) / kFmTH) * B * ((cout + bn - 1) / bn);
  return blocks < 2L * sms ? fma_tw_narrow(bn) : wide;
}

inline cudaError_t conv3x3_f32(const ConvArgs& a, int B, cudaStream_t stream) {
  // the weight rows go by 16-byte copies
  if (a.ldw % 8 != 0 || !aligned16(a.wt)) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int bn = fma_tile_n(a.Cout);
  return fma_dispatch(bn, &a, B, fma_tile_w(bn, a.H, a.W, B, a.Cout, sms), stream, nullptr);
}

}  // namespace pwc
