// Short-sequence fused attention, forward (K1), for Hopper (sm_90a).
//
// Replaces d2r_tpu/ops/kernels/fused_attention.py::_fwd_kernel. Per
// (batch b, head h), for every query row i:
//
//   s[j] = (q[b,i,h,:] . k[b,j,h,:]) * scale + bias[b,j]      (fp32)
//   p[j] = exp(s[j] - max s) / sum exp(s - max s)               (fp32)
//   with dropout: p[j] = keep(b,h,i,j) ? p[j] * 1/(1-rate) : 0  (fp32,
//                 fused_attention.py:90-92; bits: dropout_philox.cuh)
//   p[j] rounded to the input type (fused_attention.py:94)
//   out[b,i,h,:] = sum_j p[j] * v[b,j,h,:]                      (fp32 acc)
//
// with L, S <= 128 and D <= 128. The bias is the additive (B,S) key bias,
// used exactly as given (-10000 on pads), or absent.
//
// What bounds it on the H100: bytes. At the model's sites (L, S <= 64,
// D = 64 or 48) the kernel does 4*L*S*D operations per (b,h) against
// 2*(L+2S)*D bytes in bf16, about L/3 operations a byte, far below the
// ~295 a byte at which the tensor cores become the limit. So the design
// reads each input once from device memory into shared memory and never
// writes the (L,S) scores or probabilities anywhere: they live in registers
// and a per-warp row of shared memory. The products run on the CUDA cores
// in fp32; a tensor-core (wgmma) version is later work.
//
// Layout: q is (B,L,H,D) and k, v are (B,S,H,D) with the head stride D and
// the element stride 1, but any batch and row stride. The fused QKV
// projection yields q, k, v as views of one (B,L,3,H*D) product with a row
// stride of 3*H*D; passing the strides lets the kernel read those views
// without copies. out is a contiguous (B,L,H,D).
//
// Grid: (ceil(L / 8) query tiles, H, B), 4 warps a block, 2 query rows a
// warp. Batch 1 at 12 heads and L = 64 still gives 96 blocks. Each block
// stages its (b,h)'s K and V in shared memory as fp32, with rows padded to
// D+1 floats so that the 32 lanes of a warp, each scoring its own key,
// read 32 different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dropout_philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxSeq = 128;
constexpr int kMaxDim = 128;
constexpr int kPerLane = 4;  // kMaxSeq / 32 keys and kMaxDim / 32 columns a lane
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
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           T* __restrict__ out, int L, int S, int H, int D,
                           long long q_bs, long long q_rs, long long k_bs,
                           long long k_rs, long long v_bs, long long v_rs,
                           float scale, unsigned int threshold, float inv_keep,
                           unsigned long long seed, int dropout) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;               // [S][ld]
  float* vs = ks + S * ld;        // [S][ld]
  float* qs = vs + S * ld;        // [kWarps][D]
  float* ps = qs + kWarps * D;    // [kWarps][S]

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Stage K and V of (b, h): neighbouring threads read neighbouring columns.
  const T* kb = k + b * k_bs + (long long)h * D;
  const T* vb = v + b * v_bs + (long long)h * D;
  for (int i = tid; i < S * D; i += kThreads) {
    const int j = i / D;
    const int d = i - j * D;
    ks[j * ld + d] = to_float(kb[j * k_rs + d]);
    vs[j * ld + d] = to_float(vb[j * v_rs + d]);
  }

  float key_bias[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int j = lane + 32 * t;
    key_bias[t] = (bias != nullptr && j < S) ? bias[b * S + j] : 0.f;
  }
  __syncthreads();

  float* qw = qs + warp * D;
  float* pw = ps + warp * S;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = tile * kRowsPerBlock + warp * kRowsPerWarp + r;
    if (row >= L) break;  // uniform across the warp
    const T* qr = q + b * q_bs + row * q_rs + (long long)h * D;
    for (int d = lane; d < D; d += 32) qw[d] = to_float(qr[d]);
    __syncwarp();

    // Scores: lane owns keys lane, lane+32, ...; ragged S masked by bounds.
    float s[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < S) {
        const float* kr = ks + j * ld;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qw[d], kr[d], acc);
        s[t] = acc * scale + key_bias[t];
        m = fmaxf(m, s[t]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

    float e[kPerLane];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      e[t] = (j < S) ? expf(s[t] - m) : 0.f;
      sum += e[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);

#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        float p = e[t] / sum;
        if (dropout)
          p = d2r::dropout_bits(seed, (uint32_t)b, h, row, j) >= threshold ? p * inv_keep
                                                                           : 0.f;
        pw[j] = to_float(from_float<T>(p));
      }
    }
    __syncwarp();

    // PV: lane owns columns lane, lane+32, ...
    float acc[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc[t] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = pw[j];
      const float* vr = vs + j * ld;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int d = lane + 32 * t;
        if (d < D) acc[t] = fmaf(p, vr[d], acc[t]);
      }
    }
    T* orow = out + ((b * L + row) * H + h) * (long long)D;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = from_float<T>(acc[t]);
    }
    __syncwarp();  // qw and pw are rewritten for the next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int L, int S, int H, int D, long long q_bs,
           long long q_rs, long long k_bs, long long k_rs, long long v_bs,
           long long v_rs, float scale, unsigned int threshold, float inv_keep,
           unsigned long long seed, int dropout, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)S * (D + 1) + (size_t)kWarps * D + (size_t)kWarps * S);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  fused_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
      scale, threshold, inv_keep, seed, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no key bias).
// dropout = 0: no dropout (threshold, inv_keep and seed unused); else keep
// iff the element's Philox bits >= threshold, kept p times inv_keep.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int d2r_fused_attention_fwd(int dtype, const void* q, const void* k,
                                       const void* v, const void* bias, void* out,
                                       int B, int L, int S, int H, int D,
                                       long long q_bs, long long q_rs,
                                       long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, float scale,
                                       unsigned int threshold, float inv_keep,
                                       unsigned long long seed, int dropout,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || D < 1 || L > kMaxSeq || S > kMaxSeq ||
      D > kMaxDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, b, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs,
                         v_bs, v_rs, scale, threshold, inv_keep, seed, dropout, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, b, out, B, L, S, H, D, q_bs, q_rs, k_bs,
                                 k_rs, v_bs, v_rs, scale, threshold, inv_keep, seed,
                                 dropout, st);
  return (int)cudaErrorInvalidValue;
}
