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
// one Philox call; a thread's groups need not be neighbours in the whole
// (seg = 4 mod 8 splits a thread's two groups across rows), so each group
// keeps its own counter. seg = whole, offset = 0 is the tensor itself: the
// launch then takes the body without the slice arithmetic (kSliced false),
// whose counter is the group's index.
//
// What bounds it on the H100: bytes. One read and one write of each
// element (8 bytes in fp32, 4 in bf16): 12.6 MB at a BERT-base hidden
// state at batch 64 (64, 64, 768) in bf16, 3.76 us at 3.35 TB/s. Philox is
// ten rounds of two 32-bit multiply pairs a group of four elements, about
// 1.5-2 us of integer issue there, which has to hide under the memory
// traffic. The design:
// - a thread owns kPerThread consecutive elements (kPerThread / 4 Philox
//   groups) and moves them in 16-byte accesses: one or two in bf16, two or
//   four in fp32;
// - it issues its loads first, then reads the seed and runs its Philox
//   rounds while the loads are in flight, then selects, scales
//   (__fmul_rn(x, inv_keep), rounded to x's type) and stores;
// - the grid is sized to the work, one unit a thread, with no cap that
//   would send some threads round a second time;
// - y is the wrapper's own allocation, 16-byte aligned. x is a contiguous
//   tensor that may be a view at any element offset: where it is not
//   16-byte aligned its loads are as wide as its alignment allows (8, 4 or
//   2 bytes), in the same kernel. The last n % kPerThread elements take a
//   scalar body, a group of four a thread, in the same launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_philox.cuh"

namespace {

constexpr int kThreads = 256;
// elements a thread: two Philox groups (16 ran slower on the card in fp32
// and at D2R-large's site, and no faster at D2R-base's in bf16)
constexpr int kPerThread = 8;

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

// Element j of a register image of consecutive elements, 32-bit words.
template <typename T>
__device__ __forceinline__ float element(const uint32_t* w, int j);
template <>
__device__ __forceinline__ float element<float>(const uint32_t* w, int j) {
  return __uint_as_float(w[j]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint32_t* w, int j) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[j >> 1] >> (16 * (j & 1)))));
}

// Sets element j of a zeroed image to v rounded to T (0.f: all bits 0).
template <typename T>
__device__ __forceinline__ void set_element(uint32_t* w, int j, float v);
template <>
__device__ __forceinline__ void set_element<float>(uint32_t* w, int j, float v) {
  w[j] = __float_as_uint(v);
}
template <>
__device__ __forceinline__ void set_element<__nv_bfloat16>(uint32_t* w, int j, float v) {
  w[j >> 1] |= (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v)) << (16 * (j & 1));
}

// kWords words from p, in accesses of kBytes (p is kBytes-aligned).
template <int kBytes, int kWords>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[kWords]) {
  if constexpr (kBytes == 16) {
    const uint4* q = static_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = q[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2* q = static_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < kWords / 2; ++i) {
      const uint2 v = q[i];
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else if constexpr (kBytes == 4) {
    const uint32_t* q = static_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = q[i];
  } else {
    static_assert(kBytes == 2, "accesses of 16, 8, 4 or 2 bytes");
    const unsigned short* q = static_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = (uint32_t)q[2 * i] | ((uint32_t)q[2 * i + 1] << 16);
  }
}

template <int kWords>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[kWords]) {
  uint4* q = static_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i)
    q[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// The Philox counter of the group whose first element is e: e / 4 of the
// tensor itself, or of e's element in the whole under the slice layout.
template <bool kSliced>
__device__ __forceinline__ long long counter(long long e, long long seg, long long whole,
                                             long long offset) {
  return kSliced ? ((e / seg) * whole + offset + e % seg) >> 2 : e >> 2;
}

// kXBytes: the width of x's loads (its alignment, at most 16).
template <typename T, int kXBytes, bool kSliced>
__global__ void __launch_bounds__(kThreads)
hidden_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, long long seg,
                      long long whole, long long offset, unsigned int threshold,
                      float inv_keep, const unsigned long long* __restrict__ seed,
                      unsigned int site) {
  constexpr int kWords = kPerThread * (int)sizeof(T) / 4;
  constexpr int kGroups = kPerThread / 4;
  const long long units = n / kPerThread;
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u < units) {
    const long long e0 = u * kPerThread;
    uint32_t in[kWords];
    load_words<kXBytes>(x + e0, in);
    const unsigned long long key = d2r::site_key(seed, site);
    uint32_t out[kWords] = {};
    // the slice arithmetic once a thread; a group's (row, column) of seg
    // then advances by 4 columns a group
    long long row = 0, col = 0;
    if (kSliced) {
      row = e0 / seg;
      col = e0 - row * seg;
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long c = kSliced ? (row * whole + offset + col) >> 2 : (e0 >> 2) + k;
      const uint4 r = d2r::philox4x32_10((uint32_t)c, (uint32_t)(c >> 32), 0u, 0u, key);
      const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        set_element<T>(out, 4 * k + i,
                       bits[i] >= threshold ? __fmul_rn(element<T>(in, 4 * k + i), inv_keep)
                                            : 0.f);
      if (kSliced) {
        col += 4;
        if (col == seg) {
          col = 0;
          ++row;
        }
      }
    }
    store_words(y + e0, out);
  } else {
    // the last n % kPerThread elements, a group of four a thread
    const long long e0 = units * kPerThread + 4 * (u - units);
    if (e0 >= n) return;
    const long long c = counter<kSliced>(e0, seg, whole, offset);
    const uint4 r = d2r::philox4x32_10((uint32_t)c, (uint32_t)(c >> 32), 0u, 0u,
                                       d2r::site_key(seed, site));
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + i < n)
        y[e0 + i] = bits[i] >= threshold ? from_float<T>(__fmul_rn(to_float(x[e0 + i]), inv_keep))
                                         : from_float<T>(0.f);
  }
}

template <typename T, int kXBytes>
int launch_width(const T* x, T* y, long long n, long long seg, long long whole,
                 long long offset, unsigned int threshold, float inv_keep,
                 const unsigned long long* seed, unsigned int site, cudaStream_t stream) {
  const long long units = n / kPerThread;
  const long long threads = units + (n - units * kPerThread + 3) / 4;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (seg == whole && offset == 0)
    hidden_dropout_kernel<T, kXBytes, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, n, seg, whole, offset, threshold, inv_keep, seed, site);
  else
    hidden_dropout_kernel<T, kXBytes, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, y, n, seg, whole, offset, threshold, inv_keep, seed, site);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, void* yv, long long n, long long seg, long long whole,
           long long offset, unsigned int threshold, float inv_keep,
           const unsigned long long* seed, unsigned int site, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xv);
  if (reinterpret_cast<uintptr_t>(yv) % 16 != 0 || xa % sizeof(T) != 0)
    return (int)cudaErrorInvalidValue;
  if (xa % 16 == 0)
    return launch_width<T, 16>(x, y, n, seg, whole, offset, threshold, inv_keep, seed, site,
                               stream);
  if (xa % 8 == 0)
    return launch_width<T, 8>(x, y, n, seg, whole, offset, threshold, inv_keep, seed, site,
                              stream);
  if (xa % 4 == 0)
    return launch_width<T, 4>(x, y, n, seg, whole, offset, threshold, inv_keep, seed, site,
                              stream);
  if constexpr (sizeof(T) == 2)
    return launch_width<T, 2>(x, y, n, seg, whole, offset, threshold, inv_keep, seed, site,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y contiguous, n >= 1 elements,
// y 16-byte aligned, x aligned to its element; a slice of the whole as
// (seg, whole, offset) (see above); seed points at the step's 64-bit seed
// in device memory. Returns the cudaError_t of the launch (0 on success).
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
