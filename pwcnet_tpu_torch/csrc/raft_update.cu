// R2 and R3: RAFT's update block without its eager tail (ops/raft_update.py; the plain versions are
// `conv_epilogue_plain`, `coords_update_plain`, `gru_gate_zr_plain` and `gru_gate_h_plain`).
//
// Every conv of the update runs through cuDNN without its bias. PyTorch would add the bias in a pass of its
// own, apply the activation in another, and the update would copy the results into seven concatenations
// and run the GRU's gate arithmetic in five more passes: about 3.7 GB of traffic an update at 448x1024
// B=16. Here one kernel reads each conv's output once and writes its result once, in the model's dtype,
// into the channel slot of the buffer that the next conv reads (models/raft.py allocates the buffers once
// a forward):
//   R2 `raft_epilogue_kernel`: out = act(conv + bias), act one of identity, ReLU, sigmoid, tanh, into one
//      or two channel slots; `raft_epilogue_coords_kernel`, flow_head.conv2's: delta = conv + bias rounded
//      to the model's dtype, coords += delta in float32 in place, and flow = coords - the pixel's own
//      coordinates, rounded, into up to three slots;
//   R3 `raft_gate_zr_kernel`: z = sigmoid(z_pre + b_z), r = sigmoid(r_pre + b_r), r h into its slot and z
//      to a tensor; `raft_gate_h_kernel`: h = (1 - z) h + z tanh(q_pre + b_q) in place, and to a second
//      tensor where given.
//   R6 `raft_aggregate_kernel` (GMA's update, since GMA): out = mf + gamma * agg, mf the motion features'
//      slot (126 + the flow's 2 channels), agg the float32 aggregation (attention x to_v(mf)), gamma a
//      scalar, into the global slots of A and Q; the product and the sum each rounded in float32 (no
//      fused multiply-add, as the plain version computes them), then once to the model's dtype.
// Arithmetic in float32, one rounding a result. About 1.06 GB an update at B=16, with the float32 lookup's
// cast to bf16 (0.22 GB) still outside.
//
// Replaces no TPU kernel: the JAX package has no RAFT. The ids are the port's own (R for RAFT).
//
// Bound: memory. Each is a few flops per element it moves (a transcendental at most), far below the
// card's 295 operations a byte. Design: a grid-stride loop over (pixel, vector of V channels), V the widest
// of 16, 8, 4 or 2 bytes that every channel count, slot offset and pixel stride of the call allows (16
// bytes, 8 bf16 channels, at every slot of the update but the 126-channel motion features, which take 4);
// neighbouring threads take neighbouring vectors, so a warp's access is contiguous within a pixel and runs
// on across pixels of a contiguous tensor; one resident wave of 256-thread blocks (8 an SM). Indices are
// 32-bit (the host refuses a call of 2**31 vectors or more), offsets into the tensors 64-bit.
#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace pwc {

enum Act : int { kIdentity = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

constexpr int kEpilogueThreads = 256;
constexpr int kEpilogueBlocksPerSm = 8;

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kRelu) return fmaxf(v, 0.f);
  if constexpr (ACT == kSigmoid) return 1.f / (1.f + expf(-v));
  if constexpr (ACT == kTanh) return tanhf(v);
  return v;
}

// V values of type T as one access of V * sizeof(T) bytes (the pointer aligned to it)
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<2> { using type = unsigned short; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  using Raw = typename RawOf<V * sizeof(T)>::type;
  const Raw raw = __ldg(reinterpret_cast<const Raw*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
}

// as load_vec, through the ordinary path: for data that this launch also writes (the GRU's hidden state)
template <typename T, int V>
__device__ __forceinline__ void load_vec_rw(const T* p, float (&v)[V]) {
  using Raw = typename RawOf<V * sizeof(T)>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using Raw = typename RawOf<V * sizeof(T)>::type;
  Raw raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[j]);
  *reinterpret_cast<Raw*>(p) = raw;
}

// A channel slot: channel 0 of pixel 0, and the elements from one pixel to the next (the buffer's channels).
template <typename T>
struct Slot {
  T* ptr;
  long long stride;
};

template <typename T, int ACT, int V>
__global__ void __launch_bounds__(kEpilogueThreads)
raft_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ bias, int c, Slot<T> o0, Slot<T> o1,
                     unsigned items) {
  const unsigned vecs = c / V;  // vectors a pixel
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const unsigned p = i / vecs;
    const int k = static_cast<int>(i - p * vecs) * V;
    float v[V], b[V];
    load_vec<T, V>(x + static_cast<size_t>(p) * c + k, v);
    load_vec<T, V>(bias + k, b);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = activate<ACT>(v[j] + b[j]);
    store_vec<T, V>(o0.ptr + p * o0.stride + k, v);
    if (o1.ptr != nullptr) store_vec<T, V>(o1.ptr + p * o1.stride + k, v);
  }
}

// V float32 values, by 16-byte loads where V is 8 (the pointer 16-byte aligned) and as one access otherwise
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    load8(p, v);
  } else {
    load_vec<float, V>(p, v);
  }
}

// R6: mf (a slot), agg (n, c) float32 contiguous, gamma one value; out = mf + gamma agg into one or two slots
template <typename T, int V>
__global__ void __launch_bounds__(kEpilogueThreads)
raft_aggregate_kernel(const T* __restrict__ mf, long long smf, const float* __restrict__ agg,
                      const T* __restrict__ gamma, int c, Slot<T> o0, Slot<T> o1, unsigned items) {
  const float g = to_f32(*gamma);
  const unsigned vecs = c / V;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const unsigned p = i / vecs;
    const int k = static_cast<int>(i - p * vecs) * V;
    float m[V], a[V];
    load_vec<T, V>(mf + p * smf + k, m);
    load_f32<V>(agg + static_cast<size_t>(p) * c + k, a);
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = __fadd_rn(m[j], __fmul_rn(g, a[j]));
    store_vec<T, V>(o0.ptr + p * o0.stride + k, m);
    if (o1.ptr != nullptr) store_vec<T, V>(o1.ptr + p * o1.stride + k, m);
  }
}

template <typename T>
__device__ __forceinline__ void put_flow(const Slot<T>& o, unsigned p, T fx, T fy) {
  if (o.ptr == nullptr) return;
  o.ptr[p * o.stride] = fx;
  o.ptr[p * o.stride + 1] = fy;
}

// x: flow_head.conv2's output (n, 2); coords: (n, 2) float32 (x, y), pixel p at column p % w, row (p / w) % h
template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
raft_epilogue_coords_kernel(const T* __restrict__ x, const T* __restrict__ bias, float* __restrict__ coords,
                            int h, int w, Slot<T> o0, Slot<T> o1, Slot<T> o2, unsigned n) {
  const float b0 = to_f32(bias[0]), b1 = to_f32(bias[1]);
  for (unsigned p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += gridDim.x * blockDim.x) {
    const float dx = round_to<T>(to_f32(x[2 * static_cast<size_t>(p)]) + b0);
    const float dy = round_to<T>(to_f32(x[2 * static_cast<size_t>(p) + 1]) + b1);
    float2* at = reinterpret_cast<float2*>(coords) + p;
    float2 xy = *at;
    xy.x += dx;
    xy.y += dy;
    *at = xy;
    const T fx = from_f32<T>(xy.x - static_cast<float>(p % w));
    const T fy = from_f32<T>(xy.y - static_cast<float>((p / w) % h));
    put_flow(o0, p, fx, fy);
    put_flow(o1, p, fx, fy);
    put_flow(o2, p, fx, fy);
  }
}

// R3, gate 1: zr (zp, rp: (n, c) contiguous), h (a slot), rh out (a slot), z out (n, c) contiguous
template <typename T, int V>
__global__ void __launch_bounds__(kEpilogueThreads)
raft_gate_zr_kernel(const T* __restrict__ zp, const T* __restrict__ rp, const T* __restrict__ bz,
                    const T* __restrict__ br, const T* __restrict__ h, long long sh, T* __restrict__ rh,
                    long long srh, T* __restrict__ z, int c, unsigned items) {
  const unsigned vecs = c / V;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const unsigned p = i / vecs;
    const int k = static_cast<int>(i - p * vecs) * V;
    const size_t at = static_cast<size_t>(p) * c + k;
    float zv[V], rv[V], hv[V], b[V];
    load_vec<T, V>(zp + at, zv);
    load_vec<T, V>(rp + at, rv);
    load_vec<T, V>(h + p * sh + k, hv);
    load_vec<T, V>(bz + k, b);
#pragma unroll
    for (int j = 0; j < V; ++j) zv[j] = activate<kSigmoid>(zv[j] + b[j]);
    load_vec<T, V>(br + k, b);
#pragma unroll
    for (int j = 0; j < V; ++j) rv[j] = activate<kSigmoid>(rv[j] + b[j]) * hv[j];
    store_vec<T, V>(rh + p * srh + k, rv);
    store_vec<T, V>(z + at, zv);
  }
}

// R3, gate 2: qp, z (n, c) contiguous; h (a slot) read and written in place; net (n, c) contiguous or null
template <typename T, int V>
__global__ void __launch_bounds__(kEpilogueThreads)
raft_gate_h_kernel(const T* __restrict__ qp, const T* __restrict__ bq, const T* __restrict__ z, T* h,
                   long long sh, T* __restrict__ net, int c, unsigned items) {
  const unsigned vecs = c / V;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const unsigned p = i / vecs;
    const int k = static_cast<int>(i - p * vecs) * V;
    const size_t at = static_cast<size_t>(p) * c + k;
    float qv[V], zv[V], hv[V], b[V];
    load_vec<T, V>(qp + at, qv);
    load_vec<T, V>(z + at, zv);
    load_vec_rw<T, V>(h + p * sh + k, hv);
    load_vec<T, V>(bq + k, b);
#pragma unroll
    for (int j = 0; j < V; ++j) hv[j] = (1.f - zv[j]) * hv[j] + zv[j] * activate<kTanh>(qv[j] + b[j]);
    store_vec<T, V>(h + p * sh + k, hv);
    if (net != nullptr) store_vec<T, V>(net + at, hv);
  }
}

// The widest vector, in elements of `bytes` bytes, that divides every count and stride and to whose size
// every pointer is aligned.
inline int vector_width(int bytes, std::initializer_list<long long> counts, std::initializer_list<const void*> ptrs) {
  for (int v = 16 / bytes; v > 1; v /= 2) {
    bool ok = true;
    for (long long n : counts) ok = ok && n % v == 0;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % (v * bytes) == 0;
    if (ok) return v;
  }
  return 1;
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices] = {};  // each device's SMs, read once (a namespace-scope table, not a function-level static)

// one wave of resident blocks on the current device
inline int resident_blocks() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 132 * kEpilogueBlocksPerSm;
  if (g_sms[device] == 0 && cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    g_sms[device] = 132;
  }
  return g_sms[device] * kEpilogueBlocksPerSm;
}

inline unsigned grid_for(long long items) {
  return static_cast<unsigned>(std::min<long long>((items + kEpilogueThreads - 1) / kEpilogueThreads, resident_blocks()));
}

constexpr long long kMaxItems = (1LL << 31) - 1;

template <typename T, int ACT>
cudaError_t epilogue(const void* x, const void* bias, int c, void* o0, long long s0, void* o1, long long s1,
                     long long n, cudaStream_t stream) {
  const int v = vector_width(sizeof(T), {c, s0, s1}, {x, bias, o0, o1});
  const long long items = n * (c / v);
  if (items > kMaxItems) return cudaErrorInvalidValue;
  const Slot<T> a{static_cast<T*>(o0), s0}, b{static_cast<T*>(o1), s1};
  const auto* xp = static_cast<const T*>(x);
  const auto* bp = static_cast<const T*>(bias);
  const unsigned grid = grid_for(items);
  if constexpr (sizeof(T) <= 2) {
    if (v == 8) raft_epilogue_kernel<T, ACT, 8><<<grid, kEpilogueThreads, 0, stream>>>(xp, bp, c, a, b, items);
  }
  if (v == 4) raft_epilogue_kernel<T, ACT, 4><<<grid, kEpilogueThreads, 0, stream>>>(xp, bp, c, a, b, items);
  if (v == 2) raft_epilogue_kernel<T, ACT, 2><<<grid, kEpilogueThreads, 0, stream>>>(xp, bp, c, a, b, items);
  if (v == 1) raft_epilogue_kernel<T, ACT, 1><<<grid, kEpilogueThreads, 0, stream>>>(xp, bp, c, a, b, items);
  return cudaGetLastError();
}

template <typename T>
cudaError_t epilogue_act(int act, const void* x, const void* bias, int c, void* o0, long long s0, void* o1,
                         long long s1, long long n, cudaStream_t stream) {
  switch (act) {
    case kIdentity: return epilogue<T, kIdentity>(x, bias, c, o0, s0, o1, s1, n, stream);
    case kRelu: return epilogue<T, kRelu>(x, bias, c, o0, s0, o1, s1, n, stream);
    case kSigmoid: return epilogue<T, kSigmoid>(x, bias, c, o0, s0, o1, s1, n, stream);
    case kTanh: return epilogue<T, kTanh>(x, bias, c, o0, s0, o1, s1, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t coords_update(const void* x, const void* bias, void* coords, int h, int w, void* o0, long long s0,
                          void* o1, long long s1, void* o2, long long s2, long long n, cudaStream_t stream) {
  if (n > kMaxItems || reinterpret_cast<uintptr_t>(coords) % 8 != 0) return cudaErrorInvalidValue;
  raft_epilogue_coords_kernel<T><<<grid_for(n), kEpilogueThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<float*>(coords), h, w,
      Slot<T>{static_cast<T*>(o0), s0}, Slot<T>{static_cast<T*>(o1), s1}, Slot<T>{static_cast<T*>(o2), s2}, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gate_zr(const void* zp, const void* rp, const void* bz, const void* br, const void* h, long long sh,
                    void* rh, long long srh, void* z, int c, long long n, cudaStream_t stream) {
  const int v = vector_width(sizeof(T), {c, sh, srh}, {zp, rp, bz, br, h, rh, z});
  const long long items = n * (c / v);
  if (items > kMaxItems) return cudaErrorInvalidValue;
  const auto* zpp = static_cast<const T*>(zp);
  const auto* rpp = static_cast<const T*>(rp);
  const auto* bzp = static_cast<const T*>(bz);
  const auto* brp = static_cast<const T*>(br);
  const auto* hp = static_cast<const T*>(h);
  auto* rhp = static_cast<T*>(rh);
  auto* zo = static_cast<T*>(z);
  const unsigned grid = grid_for(items);
#define PWC_GATE_ZR(V) \
  raft_gate_zr_kernel<T, V><<<grid, kEpilogueThreads, 0, stream>>>(zpp, rpp, bzp, brp, hp, sh, rhp, srh, zo, c, items)
  if constexpr (sizeof(T) <= 2) {
    if (v == 8) PWC_GATE_ZR(8);
  }
  if (v == 4) PWC_GATE_ZR(4);
  if (v == 2) PWC_GATE_ZR(2);
  if (v == 1) PWC_GATE_ZR(1);
#undef PWC_GATE_ZR
  return cudaGetLastError();
}

template <typename T>
cudaError_t gate_h(const void* qp, const void* bq, const void* z, void* h, long long sh, void* net, int c,
                   long long n, cudaStream_t stream) {
  const int v = vector_width(sizeof(T), {c, sh}, {qp, bq, z, h, net});
  const long long items = n * (c / v);
  if (items > kMaxItems) return cudaErrorInvalidValue;
  const auto* qpp = static_cast<const T*>(qp);
  const auto* bqp = static_cast<const T*>(bq);
  const auto* zp = static_cast<const T*>(z);
  auto* hp = static_cast<T*>(h);
  auto* netp = static_cast<T*>(net);
  const unsigned grid = grid_for(items);
#define PWC_GATE_H(V) \
  raft_gate_h_kernel<T, V><<<grid, kEpilogueThreads, 0, stream>>>(qpp, bqp, zp, hp, sh, netp, c, items)
  if constexpr (sizeof(T) <= 2) {
    if (v == 8) PWC_GATE_H(8);
  }
  if (v == 4) PWC_GATE_H(4);
  if (v == 2) PWC_GATE_H(2);
  if (v == 1) PWC_GATE_H(1);
#undef PWC_GATE_H
  return cudaGetLastError();
}

template <typename T>
cudaError_t aggregate(const void* mf, long long smf, const void* agg, const void* gamma, int c, void* o0,
                      long long s0, void* o1, long long s1, long long n, cudaStream_t stream) {
  int v = vector_width(sizeof(T), {c, smf, s0, s1}, {mf, o0, o1});
  while (v > 1 && reinterpret_cast<uintptr_t>(agg) % (std::min(v, 4) * 4) != 0) v /= 2;  // agg's float4 loads
  const long long items = n * (c / v);
  if (items > kMaxItems) return cudaErrorInvalidValue;
  const auto* mp = static_cast<const T*>(mf);
  const auto* ap = static_cast<const float*>(agg);
  const auto* gp = static_cast<const T*>(gamma);
  const Slot<T> a{static_cast<T*>(o0), s0}, b{static_cast<T*>(o1), s1};
  const unsigned grid = grid_for(items);
#define PWC_AGGREGATE(V) \
  raft_aggregate_kernel<T, V><<<grid, kEpilogueThreads, 0, stream>>>(mp, smf, ap, gp, c, a, b, items)
  if constexpr (sizeof(T) <= 2) {
    if (v == 8) PWC_AGGREGATE(8);
  }
  if (v == 4) PWC_AGGREGATE(4);
  if (v == 2) PWC_AGGREGATE(2);
  if (v == 1) PWC_AGGREGATE(1);
#undef PWC_AGGREGATE
  return cudaGetLastError();
}

}  // namespace pwc

// Each entry point: dtype 0 float32, 1 bfloat16 (every tensor but coords); slots as (pointer, pixel stride
// in elements), a null pointer for a slot not written; n the pixels. Returns a cudaError_t.
extern "C" int pwc_raft_epilogue(int dtype, int act, const void* x, const void* bias, int c, void* o0,
                                 long long s0, void* o1, long long s1, long long n, void* stream) {
  if (n <= 0 || c <= 0 || x == nullptr || bias == nullptr || o0 == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::epilogue_act<float>(act, x, bias, c, o0, s0, o1, s1, n, st);
  if (dtype == pwc::kBF16) return pwc::epilogue_act<__nv_bfloat16>(act, x, bias, c, o0, s0, o1, s1, n, st);
  return cudaErrorInvalidValue;
}

extern "C" int pwc_raft_coords(int dtype, const void* x, const void* bias, void* coords, int h, int w, void* o0,
                               long long s0, void* o1, long long s1, void* o2, long long s2, long long n,
                               void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || x == nullptr || bias == nullptr || coords == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::coords_update<float>(x, bias, coords, h, w, o0, s0, o1, s1, o2, s2, n, st);
  if (dtype == pwc::kBF16) {
    return pwc::coords_update<__nv_bfloat16>(x, bias, coords, h, w, o0, s0, o1, s1, o2, s2, n, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" int pwc_raft_gate_zr(int dtype, const void* zp, const void* rp, const void* bz, const void* br,
                                const void* h, long long sh, void* rh, long long srh, void* z, int c, long long n,
                                void* stream) {
  if (n <= 0 || c <= 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::gate_zr<float>(zp, rp, bz, br, h, sh, rh, srh, z, c, n, st);
  if (dtype == pwc::kBF16) return pwc::gate_zr<__nv_bfloat16>(zp, rp, bz, br, h, sh, rh, srh, z, c, n, st);
  return cudaErrorInvalidValue;
}

extern "C" int pwc_raft_gate_h(int dtype, const void* qp, const void* bq, const void* z, void* h, long long sh,
                               void* net, int c, long long n, void* stream) {
  if (n <= 0 || c <= 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::gate_h<float>(qp, bq, z, h, sh, net, c, n, st);
  if (dtype == pwc::kBF16) return pwc::gate_h<__nv_bfloat16>(qp, bq, z, h, sh, net, c, n, st);
  return cudaErrorInvalidValue;
}

// R6: mf a slot (pointer, pixel stride), agg (n, c) float32 contiguous, gamma one value of the model's dtype,
// o0 and o1 slots (o1 null: not written).
extern "C" int pwc_raft_aggregate(int dtype, const void* mf, long long smf, const void* agg, const void* gamma,
                                  int c, void* o0, long long s0, void* o1, long long s1, long long n, void* stream) {
  if (n <= 0 || c <= 0 || mf == nullptr || agg == nullptr || gamma == nullptr || o0 == nullptr) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pwc::kF32) return pwc::aggregate<float>(mf, smf, agg, gamma, c, o0, s0, o1, s1, n, st);
  if (dtype == pwc::kBF16) return pwc::aggregate<__nv_bfloat16>(mf, smf, agg, gamma, c, o0, s0, o1, s1, n, st);
  return cudaErrorInvalidValue;
}

// registers a thread, local memory a thread and resident blocks an SM of the bf16 kernels the update runs
// (which: 0 the ReLU epilogue at 8 channels a vector, 1 the gate zr, 2 the gate h, 3 the coordinates), for
// the build log
extern "C" int pwc_raft_update_info(int which, int* regs, int* local_bytes, int* blocks) {
  using T = __nv_bfloat16;
  cudaFuncAttributes attr;
  const void* fn = which == 0   ? reinterpret_cast<const void*>(pwc::raft_epilogue_kernel<T, pwc::kRelu, 8>)
                   : which == 1 ? reinterpret_cast<const void*>(pwc::raft_gate_zr_kernel<T, 8>)
                   : which == 2 ? reinterpret_cast<const void*>(pwc::raft_gate_h_kernel<T, 8>)
                                : reinterpret_cast<const void*>(pwc::raft_epilogue_coords_kernel<T>);
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, pwc::kEpilogueThreads, 0);
}
