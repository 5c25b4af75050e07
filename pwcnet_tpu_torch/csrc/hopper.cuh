// Hopper (sm_90a) building blocks shared by the bf16 kernels of K3
// (pyramid_conv.cu), its backward K6 (pyramid_conv_bwd.cu) and K7 and its
// backward (conv3x3_wgmma.cuh): mbarriers, TMA and bulk copies completing on them,
// warpgroup matrix multiplies (wgmma) with both operands in shared memory,
// the implicit-GEMM 3x3 conv over chunk-planar planes, the on-card weight
// packer, and the tensor maps the copies read.
//
// Operand layout. Every wgmma operand here is K-major without swizzle: a
// "core matrix" is 8 rows of 16 bytes (8 bf16 along K) stored as 128
// contiguous bytes. An m64 (or nN) x k16 operand is 8 (N/8) such matrices
// down the rows, `sbo` bytes apart, times 2 along K, `lbo` bytes apart.
// The convolutions keep activations "chunk-planar": [C/8][positions][8], so
// 8 consecutive positions of one 8-channel chunk are one core matrix (sbo
// 128) and the next chunk is one plane further (lbo = the plane's bytes).
// The weights are packed by the wrappers as [K/16][tap][2][N][8] (the same
// layout along N): lbo N * 16, sbo 128.
//
// R4 (global_attention.cu) reads its operands in the 128-byte swizzled
// K-major layout instead (wg_desc_sw128): rows of 64 bf16 (128 bytes) as
// TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B, 8 rows (1024 bytes) a
// core-matrix group, each 16-byte chunk of row r stored at chunk ^ (r % 8).
//
// Accumulators: thread t of the warpgroup holds d[N/2] of an m64nN product;
// d[i] is row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2 (acc_row, acc_col).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "common.cuh"

namespace pwc {

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------ TMA and bulk copies
// One box of a 4-D tensor map (coordinates innermost first; out-of-bounds
// elements are written as zeros) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma and TMA reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor, no swizzle: start address, leading
// (K-direction) and stride (row-direction) byte offsets, all >> 4.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// The same for a K-major operand in the 128-byte swizzle, 1024-byte aligned
// groups of 8 rows of 128 bytes: the stride between groups is 1024 bytes, the
// leading offset is unused (1), and a K step of 16 bf16 inside a row adds 32
// bytes to the start address (the hardware swizzles the address it forms).
__device__ __forceinline__ uint64_t wg_desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma fence or wait
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ int acc_row(int t, int i) { return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i / 4) + 2 * (t % 4) + i % 2; }

// D[64 x N] += A[64 x 16] * B[16 x N], both by descriptor, both K-major,
// float32 accumulators in registers; N a multiple of 8 (the ones built below)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db));
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db));
  }
};
template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db));
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db));
  }

  // the same where `accumulate` is 0 overwrites d (the first K step of a product: no zeroing pass)
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// One 3x3 conv over chunk-planar planes ([C/8][position][8]) as m64 x N
// wgmma tiles: rows [0, n) of the output planes, a multiple of 64. `src(tap,
// ks)` is the shared address of the source's first chunk of K step ks,
// shifted by the tap; its second chunk is `src_lbo` bytes on. `w` holds the
// weights packed as [K/16][tap][2][N][8]. Warpgroup g of WGS takes tiles g,
// g + WGS, ..., up to TILES of them at once, so that as many independent
// accumulator chains keep the tensor cores busy; `epi` gets each tile's
// first row and its accumulators.
template <int N, int KSTEPS, int WGS, int TILES, typename Src, typename Epi>
__device__ __forceinline__ void conv_wgmma_tiles(int n, uint32_t src_lbo, uint32_t w, Src src, Epi epi) {
  const int g = threadIdx.x / 128;
  const int tiles = n / 64;
  for (int j0 = g; j0 < tiles; j0 += WGS * TILES) {
    float acc[TILES][N / 2];
#pragma unroll
    for (int m = 0; m < TILES; ++m) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
      acc_fence(acc[m]);
    }
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t db = wg_desc(w + (ks * 9 + tap) * 2 * N * 16, N * 16, 128);
#pragma unroll
        for (int m = 0; m < TILES; ++m)
          if (j0 + WGS * m < tiles)
            Wgmma<N>::mma(acc[m], wg_desc(src(tap, ks) + 64 * (j0 + WGS * m) * 16, src_lbo, 128), db);
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int m = 0; m < TILES; ++m) {
      acc_fence(acc[m]);
      if (j0 + WGS * m < tiles) epi(64 * (j0 + WGS * m), acc[m]);
    }
  }
}

// ------------------------------------------------------------ weight packing
// OIHW 3x3 bf16 kernels laid out for the wgmma kernels on the card, all of
// one call in one launch (a host-side layout would cost a few PyTorch ops a
// kernel): [ceil(cin / 16)][tap][2][n][8] with zero rows past cin and zero
// columns past cout (ops/cuda/_common.py::pack_wgmma is the same layout in
// PyTorch), or with `tap_major` [ky][kx][cin][cout]. `transposed` packs the
// transpose of a forward kernel k (cin, cout, 3, 3) for the backward GEMMs
// of K6 and K7, K = the forward's output channels (cin here), N = its input
// channels (cout here): 1 with the taps mirrored (tap 8 - t: the transpose
// of a stride-1 conv is a conv), 2 as they are (the stride-2 conv's phases).
// A job packs the n columns from co0 on: one N tile of a conv wider than
// the widest wgmma (wgmma_tiles).
struct PackJob {
  const __nv_bfloat16* k;
  __nv_bfloat16* dst;
  int cin, cout, n, tap_major, transposed;
  int co0;
};
constexpr int kMaxPackJobs = 8;

// the N a conv of Cout channels runs at (ops/cuda/_common.py::wgmma_n); 0 past the widest
inline int wgmma_n(int cout) {
  constexpr int kWidths[] = {8, 16, 32, 64, 96, 128};
  for (int n : kWidths)
    if (cout <= n) return n;
  return 0;
}

// The N tiles of a conv of Cout channels (ops/cuda/_common.py::wgmma_tiles):
// ceil(Cout / 128) tiles of *n = the narrowest built width that holds an
// equal share; tile j takes channels [j n, min((j + 1) n, Cout)).
inline int wgmma_tiles(int cout, int* n) {
  const int tiles = cout > 0 ? (cout + 127) / 128 : 1;
  *n = wgmma_n((cout + tiles - 1) / tiles);
  return tiles;
}
struct PackJobs {
  PackJob job[kMaxPackJobs];
};

__host__ __device__ inline int packed_elems(const PackJob& p) {
  return p.tap_major ? 9 * p.cin * p.cout : (p.cin + 15) / 16 * 9 * 2 * p.n * 8;
}

__global__ void pack_weights_kernel(PackJobs jobs) {
  const PackJob p = jobs.job[blockIdx.y];
  const int total = packed_elems(p);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    int co, ci, tap;
    if (p.tap_major) {
      co = i % p.cout;
      ci = (i / p.cout) % p.cin;
      tap = i / (p.cout * p.cin);
    } else {
      co = p.co0 + (i / 8) % p.n;
      ci = i / (16 * p.n * 9) * 16 + (i / (8 * p.n)) % 2 * 8 + i % 8;
      tap = (i / (16 * p.n)) % 9;
    }
    const int at = p.transposed ? (ci * p.cout + co) * 9 + (p.transposed == 1 ? 8 - tap : tap)
                                : (co * p.cin + ci) * 9 + tap;
    p.dst[i] = co < p.cout && ci < p.cin ? p.k[at] : __float2bfloat16_rn(0.f);
  }
}

// 64 blocks a job: K7's kernels run to 150 K elements a job (16 blocks took 15 us a call on the H100)
inline cudaError_t pack_weights(const PackJobs& jobs, int count, cudaStream_t stream) {
  pack_weights_kernel<<<dim3(64, count), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// ------------------------------------------------------------ tensor maps (host)
// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// address, so the libraries need no -lcuda. The pointer has internal
// linkage: each library that includes this header looks it up once.
using TensorMapEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                       const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                       const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                       CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static TensorMapEncodeFn tensor_map_encoder = nullptr;

// A 4-D bf16 tensor map, dims and boxes innermost first, strides in bytes
// of dims 1..3; `estride` the traversal stride of each dim (1, or 2 to take
// every second element); `swizzle` how the box is laid out in shared memory.
// Out-of-bounds elements load as zeros.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                               const uint64_t (&strides)[3], const uint32_t (&box)[4],
                               const uint32_t (&estride)[4],
                               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  if (tensor_map_encoder == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    tensor_map_encoder = reinterpret_cast<TensorMapEncodeFn>(fn);
  }
  const CUresult res = tensor_map_encoder(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace pwc
