// Short-sequence fused attention, backward (K2), for Hopper (sm_90a).
//
// Replaces d2r_tpu/ops/kernels/fused_attention.py::_bwd_kernel. For each
// (batch b, head h), with g = d loss / d out and the forward's
// p = softmax(q.k^T * scale + bias[b]) recomputed in fp32:
//
//   pd   = keep ? p * 1/(1-rate) : 0             (p when no dropout)
//   dv   = round(pd)^T . g                       (pd rounded to g's type)
//   dpd  = g . v^T,  dp = keep ? dpd * 1/(1-rate) : 0
//   dlog = p * (dp - rowsum(dp * p))             (softmax VJP, fp32)
//   dq   = round(dlog) . k * scale,  dk = round(dlog)^T . q * scale
//   dbias[b, j] += sum over queries of dlog      (summed over heads)
//
// with L, S <= 128 and D <= 128; products accumulate in fp32 and dq, dk,
// dv are rounded to the input type once, as fused_attention.py:124-165 does.
// The dropout mask is regenerated from the seed (dropout_philox.cuh), never
// stored.
//
// What bounds it on the H100: bytes. At the model's sites it does about
// 10*L*S*D operations per (b,h) against 2*(2L+2S)*D bytes in bf16 (read q,
// k, v, g, write dq, dk, dv), some 5L/6 operations a byte, far below the
// ~295 at which the tensor cores become the limit. So the design reads each
// input once into shared memory and keeps the (L,S) tiles in registers and
// per-warp rows; nothing of size (L,S) reaches device memory. The products
// run on the CUDA cores in fp32; a tensor-core version is later work.
//
// Grid: one block per (h, b), 8 warps, in two passes over the tile:
//   pass 1, warps over query rows i, with K and V staged: p, dp and dlog
//     for row i, then dq[i]; the row's softmax max, sum and rowsum(dp*p)
//     are kept in shared memory;
//   pass 2, warps over key columns j, with Q and G staged in the same
//     shared memory: p and dp of column j recomputed from those statistics
//     with the same operations as pass 1 (so the same fp32 values), then
//     dk[j], dv[j] and the column sum of dlog.
// Each dk/dv row is summed by one warp in a fixed order, with no atomics,
// so two runs give the same bits. dbias (off the main path: the padding
// bias needs no gradient, and the wrapper passes null) is summed over heads
// with fp32 atomics, in no fixed order.
//
// Shared memory: two (max(L,S), D+1) fp32 tiles, 3L row statistics and per
// warp two D-rows and two max(L,S)-rows: 150 KB at L = S = D = 128, 42 KB at
// the model's 64/64/64. Rows are padded to D+1 floats so that 32 lanes, each
// on its own row, read 32 different banks.
//
// Layout: q, g are (B,L,H,D) and k, v (B,S,H,D) with the head stride D and
// the element stride 1, any batch and row stride (q, k, v are views of the
// fused QKV product). dq, dk, dv are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dropout_philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;
constexpr int kMaxDim = 128;
constexpr int kPerLane = 4;  // kMaxSeq / 32 rows and kMaxDim / 32 columns a lane
static_assert(kMaxSeq == 32 * kPerLane && kMaxDim == 32 * kPerLane, "lane tiling");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// x . y over D fp32 values, in index order: pass 1 and pass 2 call it on the
// same operands, so they get the same bits.
__device__ __forceinline__ float dot(const float* x, const float* y, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

// Copy rows [0, n) of a (.., n, H, D) tensor's head h into an (n, D+1) fp32 tile.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs, int n, int D,
                                      int tid) {
  const int ld = D + 1;
  for (int x = tid; x < n * D; x += kThreads) {
    const int r = x / D;
    const int d = x - r * D;
    dst[r * ld + d] = to_float(src[r * rs + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const T* __restrict__ g, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dbias, int L, int S, int H, int D,
                           long long q_bs, long long q_rs, long long k_bs,
                           long long k_rs, long long v_bs, long long v_rs,
                           long long g_bs, long long g_rs, float scale,
                           unsigned int threshold, float inv_keep,
                           unsigned long long seed, int dropout) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int n = L > S ? L : S;
  float* ta = smem;               // [n][ld]: K in pass 1, Q in pass 2
  float* tb = ta + n * ld;        // [n][ld]: V in pass 1, G in pass 2
  float* row_max = tb + n * ld;   // [L]
  float* row_sum = row_max + L;   // [L]
  float* row_dot = row_sum + L;   // [L]: rowsum(dp * p)

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* xw = row_dot + L + warp * (2 * D + 2 * n);  // [D]
  float* yw = xw + D;                                 // [D]
  float* uw = yw + D;                                 // [n]
  float* vw = uw + n;                                 // [n]

  const T* qb = q + b * q_bs + (long long)h * D;
  const T* kb = k + b * k_bs + (long long)h * D;
  const T* vb = v + b * v_bs + (long long)h * D;
  const T* gb = g + b * g_bs + (long long)h * D;
  const long long hD = (long long)H * D;

  // ---- pass 1: rows. K, V staged; lane owns keys lane + 32t. ----
  stage(ta, kb, k_rs, S, D, tid);
  stage(tb, vb, v_rs, S, D, tid);
  float key_bias[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int j = lane + 32 * t;
    key_bias[t] = (bias != nullptr && j < S) ? bias[b * S + j] : 0.f;
  }
  __syncthreads();

  for (int i = warp; i < L; i += kWarps) {
    for (int d = lane; d < D; d += 32) {
      xw[d] = to_float(qb[i * q_rs + d]);
      yw[d] = to_float(gb[i * g_rs + d]);
    }
    __syncwarp();
    float s[kPerLane], dp[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      dp[t] = 0.f;
      if (j < S) {
        s[t] = fmaf(dot(xw, ta + j * ld, D), scale, key_bias[t]);
        m = fmaxf(m, s[t]);
        dp[t] = dot(yw, tb + j * ld, D);
      }
    }
    m = warp_max(m);
    float e[kPerLane];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      e[t] = (lane + 32 * t < S) ? expf(s[t] - m) : 0.f;
      sum += e[t];
    }
    sum = warp_sum(sum);
    float p[kPerLane];
    float pdp = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      p[t] = e[t] / sum;
      if (j < S && dropout)
        dp[t] = d2r::dropout_bits(seed, (uint32_t)b, h, i, j) >= threshold ? dp[t] * inv_keep
                                                                           : 0.f;
      pdp = fmaf(dp[t], p[t], pdp);
    }
    pdp = warp_sum(pdp);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) uw[j] = rounded<T>(p[t] * (dp[t] - pdp));
    }
    if (lane == 0) {
      row_max[i] = m;
      row_sum[i] = sum;
      row_dot[i] = pdp;
    }
    __syncwarp();
    // dq[i] = round(dlog[i,:]) . K * scale; lane owns columns lane + 32t
    float acc[kPerLane] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < S; ++j) {
      const float w = uw[j];
      const float* kr = ta + j * ld;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int d = lane + 32 * t;
        if (d < D) acc[t] = fmaf(w, kr[d], acc[t]);
      }
    }
    T* dqr = dq + (b * L + i) * hD + (long long)h * D;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int d = lane + 32 * t;
      if (d < D) dqr[d] = from_float<T>(acc[t] * scale);
    }
    __syncwarp();  // xw, yw and uw are rewritten for the next row
  }
  __syncthreads();  // pass 2 overwrites the K and V tiles

  // ---- pass 2: columns. Q, G staged; lane owns queries lane + 32t. ----
  stage(ta, qb, q_rs, L, D, tid);
  stage(tb, gb, g_rs, L, D, tid);
  __syncthreads();

  for (int j = warp; j < S; j += kWarps) {
    for (int d = lane; d < D; d += 32) {
      xw[d] = to_float(kb[j * k_rs + d]);
      yw[d] = to_float(vb[j * v_rs + d]);
    }
    const float bj = bias != nullptr ? bias[b * S + j] : 0.f;
    __syncwarp();
    float dlog_sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int i = lane + 32 * t;
      if (i < L) {
        const float s = fmaf(dot(ta + i * ld, xw, D), scale, bj);
        const float p = expf(s - row_max[i]) / row_sum[i];
        float dp = dot(tb + i * ld, yw, D);
        float pd = p;
        if (dropout) {
          const bool keep = d2r::dropout_bits(seed, (uint32_t)b, h, i, j) >= threshold;
          dp = keep ? dp * inv_keep : 0.f;
          pd = keep ? p * inv_keep : 0.f;
        }
        const float dlog = p * (dp - row_dot[i]);
        dlog_sum += dlog;
        uw[i] = rounded<T>(dlog);
        vw[i] = rounded<T>(pd);
      }
    }
    __syncwarp();
    // dk[j] = round(dlog[:,j])^T . Q * scale, dv[j] = round(pd[:,j])^T . G
    float ak[kPerLane] = {0.f, 0.f, 0.f, 0.f};
    float av[kPerLane] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < L; ++i) {
      const float wk = uw[i], wv = vw[i];
      const float* qr = ta + i * ld;
      const float* gr = tb + i * ld;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          ak[t] = fmaf(wk, qr[d], ak[t]);
          av[t] = fmaf(wv, gr[d], av[t]);
        }
      }
    }
    T* dkr = dk + (b * S + j) * hD + (long long)h * D;
    T* dvr = dv + (b * S + j) * hD + (long long)h * D;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        dkr[d] = from_float<T>(ak[t] * scale);
        dvr[d] = from_float<T>(av[t]);
      }
    }
    if (dbias != nullptr) {
      dlog_sum = warp_sum(dlog_sum);
      if (lane == 0) atomicAdd(dbias + b * S + j, dlog_sum);
    }
    __syncwarp();  // xw, yw, uw and vw are rewritten for the next column
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* g,
           void* dq, void* dk, void* dv, float* dbias, int B, int L, int S, int H, int D,
           long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
           long long v_rs, long long g_bs, long long g_rs, float scale,
           unsigned int threshold, float inv_keep, unsigned long long seed, int dropout,
           cudaStream_t stream) {
  const size_t n = L > S ? L : S;
  const size_t smem =
      sizeof(float) * (2 * n * (D + 1) + 3 * (size_t)L + (size_t)kWarps * (2 * D + 2 * n));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B);
  fused_attention_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dbias, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs,
      g_rs, scale, threshold, inv_keep, seed, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no key bias); dbias
// may be null (not wanted), else a zeroed (B, S) fp32 buffer it adds into.
// dropout = 0: no dropout; else keep iff the element's Philox bits >=
// threshold, kept values times inv_keep (as K1 with the same seed).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int d2r_fused_attention_bwd(int dtype, const void* q, const void* k,
                                       const void* v, const void* bias, const void* g,
                                       void* dq, void* dk, void* dv, void* dbias, int B,
                                       int L, int S, int H, int D, long long q_bs,
                                       long long q_rs, long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, long long g_bs,
                                       long long g_rs, float scale,
                                       unsigned int threshold, float inv_keep,
                                       unsigned long long seed, int dropout,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || D < 1 || L > kMaxSeq || S > kMaxSeq ||
      D > kMaxDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bi = static_cast<const float*>(bias);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bi, g, dq, dk, dv, db, B, L, S, H, D, q_bs, q_rs, k_bs,
                         k_rs, v_bs, v_rs, g_bs, g_rs, scale, threshold, inv_keep, seed,
                         dropout, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bi, g, dq, dk, dv, db, B, L, S, H, D, q_bs,
                                 q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, scale,
                                 threshold, inv_keep, seed, dropout, st);
  return (int)cudaErrorInvalidValue;
}
