// K7: the optical-flow estimator's conv chain,
//   xin -> 5 x (conv3x3 SAME + bias, LeakyReLU(0.1)) -> conv3x3 SAME + bias (linear, 2 channels)
// returning flow_raw (the last conv) and features (s5, the fifth activation),
// with float32 accumulation and every activation rounded to the model dtype
// between the convs.
//
// Replaces pwcnet_tpu/ops/pallas/estimator_conv.py::estimator_chain_fused
// (forward body _est_kernel). With --fused-estimator N it runs at the N
// finest estimator levels: inputs 147..273 channels wide, outputs 128, 128,
// 96, 64, 32, 2.
//
// The TPU kernel keeps the whole chain of one H tile in VMEM. Here the
// 128-channel intermediates of a useful tile (plus the 5-pixel halo a
// whole-chain fusion recomputes) do not fit an SM's 227 KB of shared memory,
// so the chain is one launch per conv, each a tiled implicit GEMM with its
// bias and LeakyReLU fused, handing its activation to the next through
// device memory, where L2 (50 MB) holds it: at 96x112, B = 8, the widest
// activation is 22 MB in bfloat16. In training s1..s5 are the residuals of
// the backward and are kept; in serving they are scratch the caller drops.
//
// Bound on the H100: operations. 2 x 9 x sum(Cin_i x Cout_i) per pixel is
// about 1 M operations against about 0.9 KB moved, above the card's 295
// operations per byte in bfloat16.
//
// - float32: conv3x3_fma_kernel (conv3x3_gemm.cuh), CUDA-core FMAs.
// - bfloat16 (conv3x3_wgmma_kernel below): Hopper's wgmma fed by TMA. A
//   block owns 8 rows x 30 columns of positions and every output channel
//   (N = Cout rounded up to 8, 16, 32, 64, 96 or 128), so each input tile
//   is staged once per conv. Input channels go by 16 at a time through a
//   ring of 4 stages; a stage is two TMA boxes of the input tile plus its
//   1-pixel halo, 10 x 32 positions of 8 channels each (zero-filled outside
//   the frame: the SAME pad), and one bulk copy of that K chunk's weights,
//   packed as [K/16][tap][2][N][8] by one small kernel per chain call. One producer warp keeps
//   the ring full; two consumer warpgroups each multiply 128 positions,
//   with one stage's products in flight while the next stage's are issued.
//   The staged tile has a row pitch of 32 positions and the GEMM's rows are
//   its flat positions, so the A operand of tap (dy, dx) is the tile shifted
//   by dy * 32 + dx: 64 consecutive positions are one m64 operand read by
//   descriptor, and the two columns past the 30 outputs of each row are
//   computed and dropped (1.07x). The sums stay in registers; the epilogue
//   adds the bias, applies the LeakyReLU, rounds, and goes through shared
//   memory to 16-byte stores. TMA needs 16-byte global strides, so the
//   chain's input arrives with its channels padded to a multiple of 8 (zero
//   tail, zero weight rows): the model writes that padding in the NHWC copy
//   it makes anyway.
#include "conv3x3_gemm.cuh"
#include "hopper.cuh"

namespace pwc {

constexpr int kEstConvs = 6;

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
  static constexpr int kOutPitch = N + 8;                      // epilogue row stride (bf16): off the bank period
  static constexpr size_t kBars = (size_t)kEwStages * kStage;
  static constexpr size_t kBytes = kBars + 2 * kEwStages * sizeof(uint64_t);
  static_assert((size_t)kEwM * kOutPitch * 2 <= kBars, "the epilogue tile reuses the stages");
};

struct EwArgs {
  const __nv_bfloat16* wpk;   // [Kp/16][9][2][N][8]
  const __nv_bfloat16* bias;  // (Cout,)
  __nv_bfloat16* out;         // (B, H, W, Cout)
  int H, W, Cout, ksteps, relu;
};

template <int N>
__global__ void __launch_bounds__(kEwThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap in_map, EwArgs a) {
  using L = EwLayout<N>;
  extern __shared__ __align__(128) unsigned char ew_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ew_smem + L::kBars);
  uint64_t* empty = full + kEwStages;

  const int tiles_x = (a.W + kEwTW - 1) / kEwTW;
  const int ty0 = (blockIdx.x / tiles_x) * kEwTH;
  const int tx0 = (blockIdx.x % tiles_x) * kEwTW;
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
      for (int k = 0; k < a.ksteps; ++k) {
        const int s = k % kEwStages;
        if (k >= kEwStages) mbar_wait(&empty[s], ((k / kEwStages) - 1) & 1);
        unsigned char* st = ew_smem + (size_t)s * L::kStage;
        mbar_arrive_expect_tx(&full[s], 2 * kEwBoxBytes + L::kWBytes);
        tma_load_4d(st, &in_map, &full[s], 16 * k, tx0 - 1, ty0 - 1, b);
        tma_load_4d(st + kEwPlaneBytes, &in_map, &full[s], 16 * k + 8, tx0 - 1, ty0 - 1, b);
        bulk_load(st + 2 * kEwPlaneBytes, a.wpk + (size_t)k * (L::kWBytes / 2), L::kWBytes, &full[s]);
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

  // ---- epilogue: bias, LeakyReLU, round, through shared memory to 16-byte stores
  asm volatile("bar.sync 1, %0;\n" ::"n"(kEwConsumers) : "memory");  // every stage has been read
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ew_smem);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int p = 128 * g + 64 * m + acc_row(t, i);
      const int c = acc_col(t, i);
      float v0 = acc[m][i], v1 = acc[m][i + 1];
      if (c < a.Cout) v0 += __bfloat162float(a.bias[c]);
      if (c + 1 < a.Cout) v1 += __bfloat162float(a.bias[c + 1]);
      if (a.relu) {
        v0 = leaky(v0);
        v1 = leaky(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + p * L::kOutPitch + c) = __floats2bfloat162_rn(v0, v1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kEwConsumers) : "memory");
  const size_t img = (size_t)b * a.H;
  if (a.Cout % 8 == 0) {
    const int vec = a.Cout / 8;
    for (int e = tid; e < kEwM * vec; e += kEwConsumers) {
      const int p = e / vec, v = e % vec;
      const int gy = ty0 + p / kEwPitch, gx = tx0 + p % kEwPitch;
      if (p % kEwPitch < kEwTW && gy < a.H && gx < a.W)
        *reinterpret_cast<uint4*>(a.out + ((img + gy) * a.W + gx) * a.Cout + 8 * v) =
            *reinterpret_cast<const uint4*>(tile + p * L::kOutPitch + 8 * v);
    }
  } else {  // the 2-channel flow
    for (int e = tid; e < kEwM * a.Cout; e += kEwConsumers) {
      const int p = e / a.Cout, c = e % a.Cout;
      const int gy = ty0 + p / kEwPitch, gx = tx0 + p % kEwPitch;
      if (p % kEwPitch < kEwTW && gy < a.H && gx < a.W)
        a.out[((img + gy) * a.W + gx) * a.Cout + c] = tile[p * L::kOutPitch + c];
    }
  }
}

template <int N>
cudaError_t run_wgmma(const CUtensorMap& map, const EwArgs& a, int B, cudaStream_t stream) {
  using L = EwLayout<N>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.W + kEwTW - 1) / kEwTW) * ((a.H + kEwTH - 1) / kEwTH), 1, B);
  conv3x3_wgmma_kernel<N><<<grid, kEwThreads, L::kBytes, stream>>>(map, a);
  return cudaGetLastError();
}

// one bf16 conv: in (B, H, W, Cin), Cin a multiple of 8; wpk packed for N = wgmma_n(Cout)
inline cudaError_t conv_wgmma(const void* in, const void* wpk, const void* bias, void* out, int B, int H,
                              int W, int Cin, int Cout, int relu, cudaStream_t stream) {
  if (Cin % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap map;
  const uint64_t dims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Cin * 2, (uint64_t)W * Cin * 2, (uint64_t)H * W * Cin * 2};
  const uint32_t box[4] = {8, kEwPitch, kEwRows, 1};
  const uint32_t estride[4] = {1, 1, 1, 1};
  cudaError_t err = make_map_4d(&map, in, dims, strides, box, estride);
  if (err != cudaSuccess) return err;
  EwArgs a{static_cast<const __nv_bfloat16*>(wpk), static_cast<const __nv_bfloat16*>(bias),
           static_cast<__nv_bfloat16*>(out), H, W, Cout, (Cin + 15) / 16, relu};
  switch (wgmma_n(Cout)) {
    case 8: return run_wgmma<8>(map, a, B, stream);
    case 16: return run_wgmma<16>(map, a, B, stream);
    case 32: return run_wgmma<32>(map, a, B, stream);
    case 64: return run_wgmma<64>(map, a, B, stream);
    case 96: return run_wgmma<96>(map, a, B, stream);
    case 128: return run_wgmma<128>(map, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run_chain_f32(const void* xin, const void* const* wts, const void* const* biases,
                          void* const* outs, const int* chans, int B, int H, int W, cudaStream_t stream) {
  const void* src = xin;
  for (int i = 0; i < kEstConvs; ++i) {
    ConvArgs a{};
    a.in = src;
    a.wt = wts[i];
    a.bias = biases[i];
    a.out = outs[i];
    a.H = H;
    a.W = W;
    a.Cin = chans[i];
    a.Cout = chans[i + 1];
    a.ldw = (a.Cout + 7) / 8 * 8;
    a.relu = i < kEstConvs - 1;  // the flow conv is linear
    const cudaError_t err = conv3x3_f32(a, B, stream);
    if (err != cudaSuccess) return err;
    src = outs[i];
  }
  return cudaSuccess;
}

cudaError_t run_chain_bf16(const void* xin, const void* const* ks, const void* const* biases,
                           void* const* outs, void* packed, const int* chans, int B, int H, int W,
                           cudaStream_t stream) {
  PackJobs jobs{};
  auto* dst = static_cast<__nv_bfloat16*>(packed);
  for (int i = 0; i < kEstConvs; ++i) {
    const int n = wgmma_n(chans[i + 1]);
    if (n == 0) return cudaErrorInvalidValue;
    jobs.job[i] = {static_cast<const __nv_bfloat16*>(ks[i]), dst, chans[i], chans[i + 1], n, 0, 0};
    dst += packed_elems(jobs.job[i]);
  }
  cudaError_t err = pack_weights(jobs, kEstConvs, stream);
  if (err != cudaSuccess) return err;
  const void* src = xin;
  for (int i = 0; i < kEstConvs; ++i) {
    err = conv_wgmma(src, jobs.job[i].dst, biases[i], outs[i], B, H, W, chans[i], chans[i + 1],
                     i < kEstConvs - 1, stream);
    if (err != cudaSuccess) return err;
    src = outs[i];
  }
  return cudaSuccess;
}

}  // namespace pwc

// xin: (B, H, W, chans[0]); biases[i]: (chans[i+1],); outs[i]: (B, H, W,
// chans[i+1]), the activations s1..s5 and then the flow. chans[1..5] are
// multiples of 8. wts[i], conv i+1: float32 as [ky][kx][chans[i]][ldw], ldw =
// chans[i+1] rounded up to a multiple of 8 (zero tail); bfloat16 as PyTorch
// holds it, OIHW, with chans[0] a multiple of 8 and `packed` room for the six
// kernels packed for wgmma (sum over i of ceil(chans[i] / 16) * 9 * 2 * N * 8
// elements, N the wgmma width of chans[i+1]: 8, 16, 32, 64, 96 or 128;
// unused in float32). All contiguous and of one dtype: 0 f32 / 1 bf16.
extern "C" int pwc_estimator_chain(const void* xin, const void* const* wts,
                                   const void* const* biases, void* const* outs, void* packed,
                                   const int* chans, int B, int H, int W, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::run_chain_f32(xin, wts, biases, outs, chans, B, H, W, s);
  if (dtype == pwc::kBF16) return pwc::run_chain_bf16(xin, wts, biases, outs, packed, chans, B, H, W, s);
  return cudaErrorInvalidValue;
}

// One OIHW bf16 kernel (cout, cin, 3, 3) packed for wgmma into `dst`, as
// the chain packs it: for holding the layout against its PyTorch version.
extern "C" int pwc_pack_wgmma(const void* k, void* dst, int cin, int cout, void* stream) {
  const int n = pwc::wgmma_n(cout);
  if (n == 0) return cudaErrorInvalidValue;
  pwc::PackJobs jobs{};
  jobs.job[0] = {static_cast<const __nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(dst), cin, cout, n, 0, 0};
  return pwc::pack_weights(jobs, 1, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of the bf16 conv kernel of wgmma width n, for the build log
extern "C" int pwc_estimator_conv_smem_bytes(int n) {
  switch (n) {
    case 8: return (int)pwc::EwLayout<8>::kBytes;
    case 16: return (int)pwc::EwLayout<16>::kBytes;
    case 32: return (int)pwc::EwLayout<32>::kBytes;
    case 64: return (int)pwc::EwLayout<64>::kBytes;
    case 96: return (int)pwc::EwLayout<96>::kBytes;
    case 128: return (int)pwc::EwLayout<128>::kBytes;
    default: return 0;
  }
}

// The float32 conv kernel (conv3x3_gemm.cuh) for the build log: the N
// tile and width a conv of `cout` output channels on (B, H, W) runs at
// (on 132 SMs), and for a tile n x tw its dynamic shared memory, threads
// and resident blocks an SM.
extern "C" int pwc_conv3x3_f32_tile(int cout, int B, int H, int W, int* n, int* tw) {
  *n = pwc::fma_tile_n(cout);
  *tw = pwc::fma_tile_w(*n, H, W, B, cout, 132);
  return 0;
}

extern "C" int pwc_conv3x3_f32_info(int n, int tw, int* smem, int* threads, int* blocks) {
  int info[3] = {0, 0, 0};
  const cudaError_t err = pwc::fma_dispatch(n, nullptr, 0, tw, nullptr, info);
  *smem = info[0], *threads = info[1], *blocks = info[2];
  return err;
}
