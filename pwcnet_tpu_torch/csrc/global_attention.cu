// R4: GMFlow's global matching and flow propagation, softmax(q k^T / sqrt(128)) v
// over every key of a frame, in one launch (ops/attention.py `global_attention`;
// its plain version is `_plain`, the scores written out in float32). q and k are
// bf16 (B, N, 128), v is float32 (B, N, 2) (the pixel grid, batch stride 0, or
// the flow), the output float32 (B, N, 2).
//
// Replaces no TPU kernel: the JAX package has no GMFlow. The id is the port's
// own (R4, after RAFT's R1-R3). It replaces a float32 memory-efficient
// scaled_dot_product_attention call with q and k widened and v padded to 8
// columns (9.3 ms a call at B=16, N=7168, on the H100).
//
// Bound: per pair and product, N^2 = 51.4 M scores at N = 7168 (a 1/8 grid of
// 448x1024): 13.2 GFLOP of bf16 products (27 us for both products at 989
// TFLOP/s), 51.4 M exponentials (16 a clock an SM on 132 SMs at 1.98 GHz: 25 us for both)
// and about 5 float32 operations a score (17 us). No score leaves the chip:
// the bytes (q, k, v once, the output) are 3.8 MB a product.
//
// Design: a block takes one batch row and 128 queries, and walks all keys in
// tiles of 128.
//   - One producer warp keeps a ring of 4 stages full: each stage is one K
//     tile (two TMA boxes of 64 channels x 128 keys, 32 KB, in the 128-byte
//     swizzle) and the tile's 128 x 2 float32 values (1 KB, plain loads: any
//     batch stride, zeros past N). The block's Q tile is loaded once the same
//     way.
//   - Two consumer warpgroups own 64 queries each. A tile's scores are one
//     m64n128 product of 8 K steps on wgmma, bf16 operands read from shared
//     memory, float32 sums in registers: the product of two bf16 values is
//     exact in float32, so these are the scores a float32 product computes,
//     summed in another order.
//   - The softmax is online and float32. Each thread keeps, for each of its
//     two rows, its own running maximum over the 32 columns of a tile it
//     holds, its own sum of exponentials and its own two value sums; no
//     shuffle inside the loop. The scale log2(e) / sqrt(128) is folded into
//     one FFMA and the hardware exp2 (ex2.approx, full float32 range, no
//     polynomial). A tile's terms are summed first and then added to the
//     running sums rescaled by exp2(old max - new max), so each sum is a
//     32-term sum plus one term a tile. The value product is two FMAs a score
//     on the CUDA cores: the probabilities are never rounded to bf16.
//     At the end the four threads of a row merge their maxima and sums by
//     shuffles, and one writes the row's two float32 outputs.
//   - The two warpgroups take turns on the tensor cores (two named barriers):
//     one issues its product while the other runs its softmax.
//   - Keys past N score -inf; rows past N are computed and not written, so
//     any N works. Nothing but the output is written to device memory.
//
// R5 (`attention_softmax_kernel`, since GMA): GMA's attention, once a forward,
// written out as bf16 probabilities for the 32 aggregations that read it
// (ops/attention.py `global_softmax`; its plain version is `_softmax_plain`).
// cuBLAS writes one block of rows of float32 scores q k^T (bf16 products,
// float32 sums); this kernel turns each row into softmax(scale * scores) over
// its N keys, in float32, and rounds each probability once to bf16 into its
// row of the (B, N, N) probabilities. One block a row: each thread keeps an
// online maximum and sum of exponentials over its strided share of the row,
// the block merges them, then reads the row again (from L2: two blocks of 1024
// threads an SM hold 264 rows of 130 KB at N = 32640, under the 50 MB L2) and
// writes exp(scale * x - max) / sum. Bound: memory, 4 bytes read and 2
// written a score (2.13 GB of probabilities a 1088x1920 pair: 0.95 ms at
// 3.35 TB/s, the scores' write by cuBLAS besides).
#include "hopper.cuh"

#include <atomic>

namespace pwc {

constexpr int kGaChannels = 128;                  // q and k's channels, which the kernel is built for
constexpr int kGaTile = 128;                      // queries a block, keys a stage
constexpr int kGaConsumers = 256;                 // two warpgroups of 64 queries
constexpr int kGaThreads = kGaConsumers + 32;     // + the producer warp
constexpr int kGaStages = 4;
constexpr int kGaHalfBytes = kGaTile * 128;       // 64 channels of a tile: 128 rows of 128 bytes
constexpr int kGaTileBytes = 2 * kGaHalfBytes;    // 32 KB
constexpr int kGaValueBytes = kGaTile * 2 * 4;    // 128 keys x 2 float32
constexpr int kGaKOff = kGaTileBytes;             // after the Q tile
constexpr int kGaVOff = kGaKOff + kGaStages * kGaTileBytes;
constexpr int kGaBarOff = kGaVOff + kGaStages * kGaValueBytes;
constexpr int kGaBytes = kGaBarOff + (2 * kGaStages + 1) * 8 + 1024;  // + the slack to align the base to 1024
constexpr float kGaScale = (float)(1.4426950408889634 / 11.313708498984761);  // log2(e) / sqrt(128)
static_assert(kGaChannels == 2 * 64, "two 128-byte swizzled halves a row");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kGaThreads, 1)
    global_attention_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                            const float* __restrict__ v, long long v_batch, float* __restrict__ out, int n) {
  extern __shared__ unsigned char ga_raw[];
  // the swizzled boxes and their wgmma descriptors assume 1024-byte aligned groups
  unsigned char* smem = ga_raw + ((1024 - (smem_u32(ga_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGaBarOff);
  uint64_t* empty = full + kGaStages;
  uint64_t* q_bar = empty + kGaStages;

  const int tiles = (n + kGaTile - 1) / kGaTile;
  const int q0 = blockIdx.x * kGaTile;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kGaStages; ++s) {
      mbar_init(&full[s], 2);                     // the K boxes' arrival with their bytes, then the values'
      mbar_init(&empty[s], kGaConsumers / 32);    // every consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kGaConsumers) {  // ---- the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, kGaTileBytes);
      tma_load_4d(smem, &q_map, q_bar, 0, q0, b, 0);
      tma_load_4d(smem + kGaHalfBytes, &q_map, q_bar, 64, q0, b, 0);
    }
    const float2* vb = reinterpret_cast<const float2*>(v + b * v_batch);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kGaStages;
      float2 val[4];  // keys k0 + 4 lane .. + 3, loaded before the wait for the stage
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = j * kGaTile + 4 * lane + u;
        val[u] = key < n ? vb[key] : make_float2(0.f, 0.f);
      }
      if (j >= kGaStages) mbar_wait(&empty[s], ((j / kGaStages) - 1) & 1);
      unsigned char* kt = smem + kGaKOff + s * kGaTileBytes;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], kGaTileBytes);
        tma_load_4d(kt, &k_map, &full[s], 0, j * kGaTile, b, 0);
        tma_load_4d(kt + kGaHalfBytes, &k_map, &full[s], 64, j * kGaTile, b, 0);
      }
      float4* vt = reinterpret_cast<float4*>(smem + kGaVOff + s * kGaValueBytes) + 2 * lane;
      vt[0] = make_float4(val[0].x, val[0].y, val[1].x, val[1].y);
      vt[1] = make_float4(val[2].x, val[2].y, val[3].x, val[3].y);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers: warpgroup g takes queries q0 + 64 g .. + 63; thread t holds rows
  // acc_row(t, 0) and acc_row(t, 2) and, of each tile, the 32 columns acc_col(t, i)
  const int g = tid / 128;
  const int t = tid % 128;
  const uint32_t qa = smem_u32(smem) + g * 64 * 128;
  float base[2] = {-INFINITY, -INFINITY};  // the running maximum times kGaScale, as the exponents used it
  float l[2] = {0.f, 0.f}, ox[2] = {0.f, 0.f}, oy[2] = {0.f, 0.f};
  float acc[64];

  if (g == 1) asm volatile("bar.arrive 1, %0;\n" ::"n"(kGaConsumers) : "memory");  // warpgroup 0 goes first
  mbar_wait(q_bar, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kGaStages;
    mbar_wait(&full[s], (j / kGaStages) & 1);
    const uint32_t kb = smem_u32(smem + kGaKOff + s * kGaTileBytes);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(kGaConsumers) : "memory");  // this warpgroup's turn
    acc_fence(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kGaChannels / 16; ++ks) {
      const uint32_t off = (ks / 4) * kGaHalfBytes + (ks % 4) * 32;
      Wgmma<128>::mma(acc, wg_desc_sw128(qa + off), wg_desc_sw128(kb + off), ks);
    }
    wg_commit();
    if (g == 0 || j + 1 < tiles)  // the other's turn (warpgroup 1's last arrival would have no taker)
      asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - g), "n"(kGaConsumers) : "memory");
    wg_wait<0>();
    acc_fence(acc);

    const int live = n - j * kGaTile;  // keys of this tile inside the frame
    if (live < kGaTile) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (acc_col(t, i) >= live) acc[i] = -INFINITY;
    }
    // each row's maximum over this thread's columns, in four chains
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[r][c] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i / 2) % 2][(i / 4) % 4] = fmaxf(mx[(i / 2) % 2][(i / 4) % 4], acc[i]);
    float use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3])) * kGaScale;
      const float nb = fmaxf(base[r], m);  // scaling is monotonic: the scaled maximum of the old and new
      use[r] = nb == -INFINITY ? 0.f : nb;  // a row with no live key yet: every term is 0
      corr[r] = ex2(base[r] - use[r]);
      base[r] = nb;
    }
    // the tile's terms: each score's exponential, its sum and its two value products
    float ls[2][2] = {}, xs[2][2] = {}, ys[2][2] = {};
    const float4* vt = reinterpret_cast<const float4*>(smem + kGaVOff + s * kGaValueBytes);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float4 kv = vt[acc_col(t, 4 * c) / 2];  // keys acc_col and acc_col + 1: (x, y) of each
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = ex2(fmaf(acc[4 * c + 2 * r], kGaScale, -use[r]));
        const float p1 = ex2(fmaf(acc[4 * c + 2 * r + 1], kGaScale, -use[r]));
        ls[r][0] += p0;
        ls[r][1] += p1;
        xs[r][0] = fmaf(p0, kv.x, xs[r][0]);
        xs[r][1] = fmaf(p1, kv.z, xs[r][1]);
        ys[r][0] = fmaf(p0, kv.y, ys[r][0]);
        ys[r][1] = fmaf(p1, kv.w, ys[r][1]);
      }
    }
    __syncwarp();
    if (t % 32 == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = fmaf(l[r], corr[r], ls[r][0] + ls[r][1]);
      ox[r] = fmaf(ox[r], corr[r], xs[r][0] + xs[r][1]);
      oy[r] = fmaf(oy[r], corr[r], ys[r][0] + ys[r][1]);
    }
  }

  // ---- merge the four threads of each row and write it
  float* ob = out + (size_t)b * n * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = base[r];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float f = ex2(base[r] - m);
    float sl = l[r] * f, sx = ox[r] * f, sy = oy[r] * f;
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      sl += __shfl_xor_sync(0xffffffffu, sl, d);
      sx += __shfl_xor_sync(0xffffffffu, sx, d);
      sy += __shfl_xor_sync(0xffffffffu, sy, d);
    }
    const int row = q0 + 64 * g + acc_row(t, 2 * r);
    if (t % 4 == r && row < n) reinterpret_cast<float2*>(ob)[row] = make_float2(sx / sl, sy / sl);
  }
}

// The kernel takes more dynamic shared memory than the default limit, which is
// allowed once per device (a namespace-scope flag table, as conv3x3_wgmma.cuh).
constexpr int kGaMaxDevices = 64;
static std::atomic<bool> ga_smem_allowed[kGaMaxDevices];

cudaError_t allow_global_attention_smem() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::atomic<bool>* done = device < kGaMaxDevices ? &ga_smem_allowed[device] : nullptr;
  if (done != nullptr && done->load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(global_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGaBytes);
  if (err == cudaSuccess && done != nullptr) done->store(true, std::memory_order_relaxed);
  return err;
}

// (B, N, 128) bf16, contiguous, as boxes of 64 channels x 128 rows in the 128-byte swizzle
cudaError_t ga_map(CUtensorMap* map, const void* x, int batch, int n) {
  const uint64_t dims[4] = {(uint64_t)kGaChannels, (uint64_t)n, (uint64_t)batch, 1};
  const uint64_t row = kGaChannels * 2;
  const uint64_t strides[3] = {row, row * n, row * n * batch};
  const uint32_t box[4] = {64, kGaTile, 1, 1};
  const uint32_t estride[4] = {1, 1, 1, 1};
  return make_map_4d(map, x, dims, strides, box, estride, CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int kSmThreads = 1024;  // R5: threads a row

// merges (m2, s2) into (m, s): the running maximum of scaled scores and the sum of exp(x - maximum)
__device__ __forceinline__ void merge_softmax(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2, s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <int V>
__device__ __forceinline__ void load_scores(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_probs(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned*>(&a);
    raw.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// scores: (rows, n) float32, contiguous; row i = (b, r) with b = i / rows_per_batch, r = i % rows_per_batch,
// its probabilities at out + b * out_batch + r * out_row
template <int V>
__global__ void __launch_bounds__(kSmThreads)
    attention_softmax_kernel(const float* __restrict__ scores, __nv_bfloat16* __restrict__ out, int n,
                             int rows_per_batch, long long out_batch, long long out_row, float scale) {
  __shared__ float part_m[kSmThreads / 32], part_s[kSmThreads / 32];
  const long long row = blockIdx.x;
  const float* x = scores + row * n;
  const long long b = row / rows_per_batch;
  __nv_bfloat16* o = out + b * out_batch + (row - b * rows_per_batch) * out_row;
  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x * V; i < n; i += kSmThreads * V) {
    float v[V];
    load_scores<V>(x + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = v[j] * scale;
      if (t > m) {
        s = s * expf(m - t) + 1.f;
        m = t;
      } else {
        s += expf(t - m);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off), s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge_softmax(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part_m[warp] = m, part_s[warp] = s;
  __syncthreads();
  if (warp == 0) {
    m = part_m[lane], s = part_s[lane];  // kSmThreads / 32 == 32 warps
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off), s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge_softmax(m, s, m2, s2);
    }
    if (lane == 0) part_m[0] = m, part_s[0] = s;
  }
  __syncthreads();
  m = part_m[0];
  const float inv = 1.f / part_s[0];
  for (int i = threadIdx.x * V; i < n; i += kSmThreads * V) {
    float v[V];
    load_scores<V>(x + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = expf(v[j] * scale - m) * inv;
    store_probs<V>(o + i, v);
  }
}
static_assert(kSmThreads == 32 * 32, "the second merge takes one warp's lanes, one a warp");

}  // namespace pwc

// R5: scores (rows, n) float32, contiguous; out bf16, row i (= (b, r), b = i / rows_per_batch) at
// out + b * out_batch + r * out_row, n contiguous elements. Float4 loads where n, the strides and the pointers
// allow them.
extern "C" int pwc_attention_softmax(const void* scores, void* out, int rows, int rows_per_batch, int n,
                                     long long out_batch, long long out_row, float scale, void* stream) {
  if (rows <= 0 || rows_per_batch <= 0 || n <= 0 || scores == nullptr || out == nullptr) return cudaErrorInvalidValue;
  const bool wide = n % 4 == 0 && out_batch % 4 == 0 && out_row % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(scores) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(scores);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (wide) {
    pwc::attention_softmax_kernel<4><<<rows, pwc::kSmThreads, 0, st>>>(x, o, n, rows_per_batch, out_batch, out_row,
                                                                         scale);
  } else {
    pwc::attention_softmax_kernel<1><<<rows, pwc::kSmThreads, 0, st>>>(x, o, n, rows_per_batch, out_batch, out_row,
                                                                         scale);
  }
  return cudaGetLastError();
}

// q, k: (batch, n, 128) bf16, contiguous, 16-byte aligned; v: float32 (batch, n, 2) with rows of 2
// contiguous values, 8-byte aligned, batch b at v + b * v_batch (v_batch 0: one value for every row);
// out: (batch, n, 2) float32, contiguous, 8-byte aligned.
extern "C" int pwc_global_attention(const void* q, const void* k, const void* v, long long v_batch, void* out,
                                    int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535 || v_batch < 0) return cudaErrorInvalidValue;
  if (!pwc::aligned16(q) || !pwc::aligned16(k) || reinterpret_cast<uintptr_t>(v) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map;
  cudaError_t err = pwc::ga_map(&q_map, q, batch, n);
  if (err == cudaSuccess) err = pwc::ga_map(&k_map, k, batch, n);
  if (err == cudaSuccess) err = pwc::allow_global_attention_smem();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + pwc::kGaTile - 1) / pwc::kGaTile, batch);
  pwc::global_attention_kernel<<<grid, pwc::kGaThreads, pwc::kGaBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, static_cast<const float*>(v), v_batch, static_cast<float*>(out), n);
  return cudaGetLastError();
}

// registers a thread, local memory a thread, dynamic shared memory a block and resident blocks an SM,
// for the build log
extern "C" int pwc_global_attention_info(int* regs, int* local_bytes, int* smem_bytes, int* blocks) {
  cudaError_t err = pwc::allow_global_attention_smem();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, pwc::global_attention_kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = pwc::kGaBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pwc::global_attention_kernel, pwc::kGaThreads,
                                                       pwc::kGaBytes);
}
