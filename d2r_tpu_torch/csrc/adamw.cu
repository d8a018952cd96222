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
// One launch covers every tensor of every lr group: a table in device
// memory lists each tensor's (p, g, mu, nu, numel, group), and a block map
// gives each block one chunk of one tensor. A second one-thread launch
// adds 1 to the count after it. The table is built once per set of
// gradient addresses; inside a CUDA graph those are fixed.
//
// What bounds it on the H100: bytes. Per element it reads p, g, mu, nu and
// writes p, mu, nu: 28 bytes with fp32 first moments, 24 with bf16, against
// about 20 floating-point operations; 400,186,367 elements (D2R-base) move
// 11.2 GB, 3.35 ms at 3.35 TB/s. Consecutive threads take consecutive
// elements, so every access is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableWords = 6;  // p, g, mu, nu, numel, group

struct Scalars {
  float b1, b2, omb1, omb2, b1_low, eps, wd;
  float warmup, warm_div, total, decay_div;
  long long chunk;
};

__device__ __forceinline__ float schedule(float step, const Scalars& s) {
  const float warm = __fdiv_rn(step, s.warm_div);
  const float decay = fmaxf(0.f, __fdiv_rn(__fsub_rn(s.total, step), s.decay_div));
  return step < s.warmup ? warm : decay;
}

template <bool kBf16Mu>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const long long* __restrict__ table, const long long* __restrict__ blocks,
             const float* __restrict__ base_lr, const float* __restrict__ count, Scalars s) {
  const long long t = blocks[2 * blockIdx.x];
  const long long start = blocks[2 * blockIdx.x + 1];
  const long long* e = table + kTableWords * t;
  float* p = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* nu = reinterpret_cast<float*>(e[3]);
  const long long n = e[4];
  const long long end = start + s.chunk < n ? start + s.chunk : n;

  const float step = *count;  // pre-increment
  const float tt = __fadd_rn(step, 1.f);
  const float c1 = __fsub_rn(1.f, powf(s.b1, tt));
  const float c2 = __fsub_rn(1.f, powf(s.b2, tt));
  const float neg_lr = -__fmul_rn(base_lr[e[5]], schedule(step, s));

  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float gi = g[i];
    const float pi = p[i];
    const float scaled = __fmul_rn(gi, s.omb1);
    float m;
    if (kBf16Mu) {
      __nv_bfloat16* mu = reinterpret_cast<__nv_bfloat16*>(e[2]);
      const float prod = __bfloat162float(
          __float2bfloat16_rn(__fmul_rn(__bfloat162float(mu[i]), s.b1_low)));
      m = __fadd_rn(scaled, prod);
      mu[i] = __float2bfloat16_rn(m);
    } else {
      float* mu = reinterpret_cast<float*>(e[2]);
      m = __fadd_rn(__fmul_rn(mu[i], s.b1), scaled);
      mu[i] = m;
    }
    const float sq = __fmul_rn(__fmul_rn(gi, gi), s.omb2);
    const float v = __fadd_rn(__fmul_rn(nu[i], s.b2), sq);
    nu[i] = v;
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), s.eps);
    float u = __fdiv_rn(__fdiv_rn(m, c1), den);
    u = __fadd_rn(u, __fmul_rn(pi, s.wd));
    p[i] = __fadd_rn(pi, __fmul_rn(u, neg_lr));
  }
}

__global__ void adamw_tick(float* count) { *count = __fadd_rn(*count, 1.f); }

}  // namespace

// table: n_tensors rows of 6 int64 (p, g, mu, nu pointers, numel, group);
// blocks: n_blocks pairs (tensor row, first element), each block taking
// `chunk` elements from there; base_lr: one fp32 per group; count: the
// fp32 step count, read before the update and incremented after it.
// mu_bf16: first moments are bf16. Returns the cudaError_t of the launches
// (0 on success).
extern "C" int d2r_adamw(int mu_bf16, const void* table, const void* blocks, int n_blocks,
                         long long chunk, const void* base_lr, void* count, float b1,
                         float b2, float omb1, float omb2, float b1_low, float eps, float wd,
                         float warmup, float warm_div, float total, float decay_div,
                         void* stream) {
  if (n_blocks < 1 || chunk < 1 || table == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  const Scalars s{b1, b2, omb1, omb2, b1_low, eps, wd, warmup, warm_div, total, decay_div,
                  chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(table);
  const long long* blk = static_cast<const long long*>(blocks);
  const float* lr = static_cast<const float*>(base_lr);
  float* c = static_cast<float*>(count);
  if (mu_bf16)
    adamw_kernel<true><<<n_blocks, kThreads, 0, st>>>(tab, blk, lr, c, s);
  else
    adamw_kernel<false><<<n_blocks, kThreads, 0, st>>>(tab, blk, lr, c, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adamw_tick<<<1, 1, 0, st>>>(c);
  return (int)cudaGetLastError();
}
