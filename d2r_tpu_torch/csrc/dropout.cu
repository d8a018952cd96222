// Hidden dropout of the training forward and backward, for Hopper (sm_90a).
//
// y[e] = keep(e) ? x[e] * inv_keep : 0, rounded to x's type, for the n
// elements of a contiguous fp32 or bf16 tensor, with keep(e) iff the bits
// of element e (dropout_philox.cuh: word e % 4 of Philox4x32-10 at counter
// ((e / 4) mod 2^32, (e / 4) >> 32, 0, 0)) are >= threshold, under the key
// site_key(*seed, site). The function is linear in x with the mask fixed by
// (seed, site), so the backward is the same launch on the gradient: the
// mask is regenerated, never stored.
//
// Replaces no TPU kernel: the JAX package's nn.Dropout draws its mask with
// jax.random inside the jitted step (d2r_tpu/models/layers.py). The port
// needs a kernel because its step is one CUDA graph: the mask has to come
// from a seed in device memory, which the graph's replays rewrite, and a
// remat recompute has to draw it again from the site's ordinal alone.
//
// The tensor may be a slice of a larger one, the whole step's tensor (a
// data rank's batch rows, a sequence slice under seq_shard, or both):
// element e then draws the bits of element
// g = (e / seg) * whole + offset + e % seg of the whole, so the slices'
// masks are the rows of the whole tensor's mask. seg, whole and offset are
// multiples of 4 (the wrapper checks), so a group of four elements stays on
// one Philox call. seg = whole, offset = 0 is the tensor itself: the launch
// then takes the kernel without the slice arithmetic (kSliced false), whose
// counter is the group's index, as before slices were added.
//
// What bounds it on the H100: bytes. One read and one write of each
// element (8 bytes in fp32, 4 in bf16) against one Philox call (ten rounds
// of two 32-bit multiplies) per four elements. Each thread takes groups of
// four elements, one Philox call each, in a grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, long long seg,
               long long whole, long long offset, unsigned int threshold, float inv_keep,
               const unsigned long long* __restrict__ seed, unsigned int site) {
  const unsigned long long key = d2r::site_key(seed, site);
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < groups;
       q += stride) {
    const long long c = kSliced ? ((4 * q / seg) * whole + offset + 4 * q % seg) / 4 : q;
    const uint4 w = d2r::philox4x32_10((uint32_t)c, (uint32_t)(c >> 32), 0u, 0u, key);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long e = 4 * q + r;
      if (e < n)
        y[e] = words[r] >= threshold ? from_float<T>(__fmul_rn(to_float(x[e]), inv_keep))
                                     : from_float<T>(0.f);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, long long seg, long long whole,
           long long offset, unsigned int threshold, float inv_keep,
           const unsigned long long* seed, unsigned int site, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  const long long want = (groups + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (seg == whole && offset == 0)
    dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, seg, whole, offset, threshold,
        inv_keep, seed, site);
  else
    dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, seg, whole, offset, threshold,
        inv_keep, seed, site);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y contiguous, n >= 1 elements,
// a slice of the whole as (seg, whole, offset) (see above); seed points at
// the step's 64-bit seed in device memory. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int d2r_dropout(int dtype, const void* x, void* y, long long n, long long seg,
                           long long whole, long long offset, unsigned int threshold,
                           float inv_keep, const void* seed, unsigned int site, void* stream) {
  if (n < 1 || seed == nullptr || seg < 1 || offset < 0) return (int)cudaErrorInvalidValue;
  const unsigned long long* s = static_cast<const unsigned long long*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, n, seg, whole, offset, threshold, inv_keep, s, site, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, n, seg, whole, offset, threshold, inv_keep, s, site, st);
  return (int)cudaErrorInvalidValue;
}
