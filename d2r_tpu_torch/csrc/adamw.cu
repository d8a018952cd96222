// AdamW, optax's operation order, in one pass over every parameter, for
// Hopper (sm_90a), with the step count and the learning-rate schedule read
// and advanced on the card.
//
// Computes what the JAX package's fused_adamw / fused_leaf_adamw compute
// (d2r_tpu/train/optimizer.py:112,181; XLA fusions there, not Pallas
// kernels), per element, every operation rounded to fp32 on its own
// (__fmul_rn and friends: no contraction into FMAs, so the kernel equals
// its plain twin, d2r_tpu_torch/ops/kernels/adamw.py::adamw_plain, bit for
// bit):
//
//   mu = (1-b1) g + b1 mu          nu = (1-b2) g^2 + b2 nu
//   u  = (mu / c1) / (sqrt(nu / c2) + eps) + wd p
//   p  = p + (-lr) u
//
// with t = count + 1, c = 1 - b^t, and lr = base_lr[group] * schedule(count)
// at the pre-increment count: HF's linear warmup then linear decay with a
// fractional warmup, in fp32 as the JAX package's jnp schedule evaluates
// it (d2r_tpu/train/optimizer.py:74-99). First moments are fp32, or bf16
// with optax's rounding on its grouped path: b1 rounded to bf16, b1 * mu
// rounded to bf16, the sum with (1-b1) g in fp32 feeding the update, and
// mu stored rounded to bf16.
//
// What bounds it on the H100: bytes. Per element it reads p, g, mu, nu and
// writes p, mu, nu: 28 bytes with fp32 first moments, 24 with bf16, against
// about 20 floating-point operations; 400,186,367 elements (D2R-base) move
// 11.2 GB, 3.345 ms at 3.35 TB/s (bf16 moments 2.867 ms). The arithmetic
// is IEEE on purpose (three __fdiv_rn, one __fsqrt_rn: 70-100 instructions
// an element), so it has to run under the loads. The design:
// - 16-byte accesses: a float4 of p, g and nu, a float4 or four bf16 of mu.
//   A thread loads kVec vectors of every stream before its first
//   arithmetic, through __restrict__ pointers, and stores them after it:
//   256 threads x 4 vectors is one chunk of 4,096 elements a block;
// - a persistent grid of kBlocksPerSM blocks an SM walks a table in device
//   memory: each tensor's row (p, g, mu, nu, numel, group, vector end) and
//   the chunks (tensor, first element, elements), each starting at a
//   multiple of 4 elements, largest first. A block takes chunk blockIdx.x,
//   then claims the next from a counter in the table (one atomicAdd a
//   chunk, issued while the chunk before runs), so the blocks of faster
//   SMs take more chunks; a static cut of the list into equal shares a
//   block left the fast SMs idle at the end and ran slower on the card, as
//   did larger chunks. A chunk's table row is read once;
// - the count-dependent scalars (b^t, the schedule, -lr of each group) are
//   computed once a block;
// - a tensor whose four pointers are not all aligned for those accesses
//   (the wrapper sets its vector end to 0), and the numel % 4 elements at
//   a tensor's end, take a scalar body in the same kernel.
// A second one-thread launch adds 1 to the count and resets the chunk
// counter after it. The table is built once per set of addresses; inside a
// CUDA graph those are fixed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;           // vectors of each stream in flight a thread
constexpr int kBlocksPerSM = 2;   // ops/kernels/adamw.py::BLOCKS_PER_SM
constexpr int kRowWords = 7;      // p, g, mu, nu, numel, group, vector end
constexpr int kChunkWords = 3;    // tensor row, first element, elements

struct Scalars {
  float b1, b2, omb1, omb2, b1_low, eps, wd;
  float warmup, warm_div, total, decay_div;
};

__device__ __forceinline__ float schedule(float step, const Scalars& s) {
  const float warm = __fdiv_rn(step, s.warm_div);
  const float decay = fmaxf(0.f, __fdiv_rn(__fsub_rn(s.total, step), s.decay_div));
  return step < s.warmup ? warm : decay;
}

// One element: m and v are the moments in fp32 (m read from bf16 storage
// where kBf16Mu) and come back updated; m unrounded, the caller stores it.
template <bool kBf16Mu>
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Scalars& s,
                                     float c1, float c2, float neg_lr) {
  const float scaled = __fmul_rn(g, s.omb1);
  if (kBf16Mu)
    m = __fadd_rn(scaled, __bfloat162float(__float2bfloat16_rn(__fmul_rn(m, s.b1_low))));
  else
    m = __fadd_rn(__fmul_rn(m, s.b1), scaled);
  const float sq = __fmul_rn(__fmul_rn(g, g), s.omb2);
  v = __fadd_rn(__fmul_rn(v, s.b2), sq);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), s.eps);
  float u = __fdiv_rn(__fdiv_rn(m, c1), den);
  u = __fadd_rn(u, __fmul_rn(p, s.wd));
  p = __fadd_rn(p, __fmul_rn(u, neg_lr));
}

// Four first moments as stored: a float4, or four bf16 in 8 bytes.
template <bool kBf16Mu>
struct Mu4;
template <>
struct Mu4<false> {
  using type = float4;
  static __device__ __forceinline__ void unpack(const float4& a, float (&m)[4]) {
    m[0] = a.x;
    m[1] = a.y;
    m[2] = a.z;
    m[3] = a.w;
  }
  static __device__ __forceinline__ float4 pack(const float (&m)[4]) {
    return make_float4(m[0], m[1], m[2], m[3]);
  }
};
template <>
struct Mu4<true> {
  using type = uint2;
  // a bf16 is the high half of its fp32 value
  static __device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void unpack(const uint2& a, float (&m)[4]) {
    m[0] = lo(a.x);
    m[1] = hi(a.x);
    m[2] = lo(a.y);
    m[3] = hi(a.y);
  }
  static __device__ __forceinline__ uint2 pack(const float (&m)[4]) {
    return make_uint2(bits(m[0]) | (bits(m[1]) << 16), bits(m[2]) | (bits(m[3]) << 16));
  }
};

template <bool kBf16Mu>
struct Mu1;
template <>
struct Mu1<false> {
  using type = float;
  static __device__ __forceinline__ float load(const float* a) { return *a; }
  static __device__ __forceinline__ void store(float* a, float m) { *a = m; }
};
template <>
struct Mu1<true> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ float load(const __nv_bfloat16* a) {
    return __bfloat162float(*a);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* a, float m) {
    *a = __float2bfloat16_rn(m);
  }
};

// Elements [begin, end) of one tensor (begin, end multiples of 4), in
// 16-byte vectors: kVec vectors of every stream loaded a thread before its
// first arithmetic, through __restrict__ pointers.
template <bool kBf16Mu>
__device__ __forceinline__ void update_vectors(float* __restrict__ p, const float* __restrict__ g,
                                               void* __restrict__ mu, float* __restrict__ nu,
                                               long long begin, long long end, const Scalars& s,
                                               float c1, float c2, float neg_lr) {
  using M = Mu4<kBf16Mu>;
  using MV = typename M::type;
  float4* __restrict__ P = reinterpret_cast<float4*>(p + begin);
  const float4* __restrict__ G = reinterpret_cast<const float4*>(g + begin);
  MV* __restrict__ U = reinterpret_cast<MV*>(static_cast<typename Mu1<kBf16Mu>::type*>(mu) + begin);
  float4* __restrict__ N = reinterpret_cast<float4*>(nu + begin);
  const int vectors = (int)((end - begin) / 4);
  for (int base = threadIdx.x; base < vectors; base += kThreads * kVec) {
    float4 pv[kVec], gv[kVec], nv[kVec];
    MV uv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = base + j * kThreads;
      if (i < vectors) {
        pv[j] = P[i];
        gv[j] = G[i];
        uv[j] = U[i];
        nv[j] = N[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = base + j * kThreads;
      if (i < vectors) {
        float m[4];
        M::unpack(uv[j], m);
        adam<kBf16Mu>(pv[j].x, gv[j].x, m[0], nv[j].x, s, c1, c2, neg_lr);
        adam<kBf16Mu>(pv[j].y, gv[j].y, m[1], nv[j].y, s, c1, c2, neg_lr);
        adam<kBf16Mu>(pv[j].z, gv[j].z, m[2], nv[j].z, s, c1, c2, neg_lr);
        adam<kBf16Mu>(pv[j].w, gv[j].w, m[3], nv[j].w, s, c1, c2, neg_lr);
        P[i] = pv[j];
        U[i] = M::pack(m);
        N[i] = nv[j];
      }
    }
  }
}

// Elements [begin, end) of one tensor, one at a time.
template <bool kBf16Mu>
__device__ __forceinline__ void update_scalars(float* __restrict__ p, const float* __restrict__ g,
                                               void* __restrict__ mu, float* __restrict__ nu,
                                               long long begin, long long end, const Scalars& s,
                                               float c1, float c2, float neg_lr) {
  using M = Mu1<kBf16Mu>;
  typename M::type* __restrict__ U = static_cast<typename M::type*>(mu);
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float pi = p[i], m = M::load(U + i), v = nu[i];
    adam<kBf16Mu>(pi, g[i], m, v, s, c1, c2, neg_lr);
    p[i] = pi;
    M::store(U + i, m);
    nu[i] = v;
  }
}

template <bool kBf16Mu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
adamw_kernel(const long long* __restrict__ table, const long long* __restrict__ chunks,
             long long n_chunks, unsigned long long* __restrict__ next, int n_groups,
             const float* __restrict__ base_lr, const float* __restrict__ count, Scalars s) {
  extern __shared__ float neg_lr[];  // one a group
  __shared__ long long claimed[2];
  long long c = blockIdx.x;  // the first chunk; the rest are claimed from *next
  if (c >= n_chunks) return;

  const float step = *count;  // pre-increment
  const float tt = __fadd_rn(step, 1.f);
  const float c1 = __fsub_rn(1.f, powf(s.b1, tt));
  const float c2 = __fsub_rn(1.f, powf(s.b2, tt));
  const float factor = schedule(step, s);
  for (int i = threadIdx.x; i < n_groups; i += kThreads)
    neg_lr[i] = -__fmul_rn(base_lr[i], factor);
  __syncthreads();

  for (int k = 0; c < n_chunks; ++k) {
    // claim the next chunk while this one runs; two slots, so a slot is
    // rewritten only after every thread has read it (one barrier a chunk)
    if (threadIdx.x == 0) claimed[k & 1] = gridDim.x + (long long)atomicAdd(next, 1ull);
    const long long* chunk = chunks + kChunkWords * c;
    const long long* row = table + kRowWords * chunk[0];
    const long long begin = chunk[1], end = begin + chunk[2];
    float* p = reinterpret_cast<float*>(row[0]);
    const float* g = reinterpret_cast<const float*>(row[1]);
    void* mu = reinterpret_cast<void*>(row[2]);
    float* nu = reinterpret_cast<float*>(row[3]);
    const float lr = neg_lr[row[5]];
    const long long split = max(begin, min(end, row[6]));  // vector body up to here
    if (split > begin)
      update_vectors<kBf16Mu>(p, g, mu, nu, begin, split, s, c1, c2, lr);
    if (end > split)
      update_scalars<kBf16Mu>(p, g, mu, nu, split, end, s, c1, c2, lr);
    __syncthreads();
    c = claimed[k & 1];
  }
}

// After the update: the count advances and the chunk counter is reset for
// the next launch (inside a CUDA graph too).
__global__ void adamw_tick(float* count, unsigned long long* next) {
  *count = __fadd_rn(*count, 1.f);
  *next = 0;
}

}  // namespace

// table: one row of 7 int64 a tensor (p, g, mu, nu pointers, numel, group,
// vector end: the elements from 0 that take the 16-byte body, 0 where a
// pointer is not aligned for it); chunks: n_chunks (tensor
// row, first element, elements) triples, the first element a multiple of
// 4; next: the chunk counter, 0 before the launch (the tick resets it);
// n_blocks: the persistent grid; base_lr: n_groups fp32; count: the fp32
// step count, read before the update and incremented after it. mu_bf16:
// first moments are bf16. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int d2r_adamw(int mu_bf16, const void* table, const void* chunks, long long n_chunks,
                         void* next, int n_blocks, int n_groups, const void* base_lr,
                         void* count, float b1, float b2, float omb1, float omb2, float b1_low,
                         float eps, float wd, float warmup, float warm_div, float total,
                         float decay_div, void* stream) {
  if (n_blocks < 1 || n_groups < 1 || n_chunks < 1 || table == nullptr || chunks == nullptr ||
      next == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  const Scalars s{b1, b2, omb1, omb2, b1_low, eps, wd, warmup, warm_div, total, decay_div};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(table);
  const long long* chk = static_cast<const long long*>(chunks);
  unsigned long long* nxt = static_cast<unsigned long long*>(next);
  const float* lr = static_cast<const float*>(base_lr);
  float* c = static_cast<float*>(count);
  const size_t smem = sizeof(float) * (size_t)n_groups;
  if (mu_bf16)
    adamw_kernel<true><<<n_blocks, kThreads, smem, st>>>(tab, chk, n_chunks, nxt, n_groups, lr,
                                                         c, s);
  else
    adamw_kernel<false><<<n_blocks, kThreads, smem, st>>>(tab, chk, n_chunks, nxt, n_groups, lr,
                                                          c, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adamw_tick<<<1, 1, 0, st>>>(c, nxt);
  return (int)cudaGetLastError();
}
