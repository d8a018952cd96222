// Short-sequence fused attention, forward (K1), for Hopper (sm_90a): a bf16
// kernel on the tensor cores and an fp32 kernel on the CUDA cores.
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
// writes the (L,S) scores or probabilities anywhere.
//
// Layout: q is (B,L,H,D) and k, v are (B,S,H,D) with the head stride D and
// the element stride 1, but any batch and row stride. The fused QKV
// projection yields q, k, v as views of one (B,L,3,H*D) product with a row
// stride of 3*H*D; passing the strides lets the kernel read those views
// without copies. out is a contiguous (B,L,H,D).
//
// bf16: tensor cores (fused_attention_fwd_bf16_kernel). The JAX kernel has
// no online softmax: it softmaxes the whole (L,S) tile (:83-97), and S,
// D <= 128 let one block hold it. Grid (H, B), one block a (b,h): 384
// blocks at the BERT site (B = 32, H = 12). ceil(L/16) warps, 16 query
// rows each. The block stages q, K and V of its (b,h) once, as bf16, by
// 16-byte cp.async (rows and columns zero-filled up to multiples of 16),
// and then each warp
//   - multiplies its q rows by K on the tensor cores (mma.sync m16n8k16,
//     bf16 operands, fp32 sums; D = 48 takes three k16 steps), then
//     applies scale and bias in fp32, as :83-86;
//   - softmaxes each full row in registers (max and sum over the 4 lanes
//     that hold a row, by __shfl_xor_sync), p = e / sum in fp32;
//   - with dropout, keeps p * 1/(1-rate) where the element's Philox bits
//     pass the threshold: a lane holds keys 2t, 2t+1 of each n8 tile in
//     rows g and g+8, so the lanes t and t^1 need the same two Philox calls
//     (counter (j/4, row)); each makes one of them and the two swap the
//     halves by shuffle;
//   - rounds p to bf16 (:93-96) straight from the score accumulators into
//     the A operand of p.V, and accumulates p.V in fp32.
// The score product, the scale, bias and mask step, the p.V product and the
// row store are mma_bf16.cuh's, shared with K3; the whole-row softmax and
// the dropout are this kernel's.
// Why mma.sync and not wgmma: a warpgroup product takes 64 rows, and at
// L, S <= 64 each (b,h) is one such tile; at L/3 operations a byte the
// kernel is bytes-bound whatever unit multiplies, and the warp-level
// product keeps each warp's rows, softmax and dropout in its own registers.
// Shared memory: 27 KiB at L = S = D = 64, 102 KiB at L = S = D = 128.
//
// fp32: CUDA cores (fused_attention_fwd_kernel), the first design, kept as
// it was: the card-versus-CPU checks hold it bit for bit to the plain
// version, which TF32 would break. Grid (ceil(L / 8) query tiles, H, B), 4
// warps a block, 2 query rows a warp. Each block stages its (b,h)'s K and
// V in shared memory as fp32, with rows padded to D+1 floats so that the
// 32 lanes of a warp, each scoring its own key, read 32 different banks;
// probabilities pass through a per-warp row of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dropout_philox.cuh"
#include "mma_bf16.cuh"

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
                           const unsigned long long* __restrict__ seed_ptr,
                           unsigned int site, unsigned int b0, unsigned int h0, int dropout) {
  // the site's Philox key, from the step's seed in device memory
  const unsigned long long seed = dropout ? d2r::site_key(seed_ptr, site) : 0ull;
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
          p = d2r::dropout_bits(seed, (uint32_t)b + b0, h + h0, row, j) >= threshold
                  ? p * inv_keep
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
           const unsigned long long* seed, unsigned int site,
           unsigned int b0, unsigned int h0, int dropout, cudaStream_t stream) {
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
      scale, threshold, inv_keep, seed, site, b0, h0, dropout);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int kTcMaxWarps = kMaxSeq / 16;  // 16 query rows a warp

// SMAX, DMAX: the key count and head width the registers are sized for
// (64 or 128 each); the loops run over the S keys and D columns present,
// rounded up to 16.
template <int SMAX, int DMAX>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
fused_attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                bf16* __restrict__ out, int L, int S, int H, int D,
                                long long q_bs, long long q_rs, long long k_bs,
                                long long k_rs, long long v_bs, long long v_rs, float scale,
                                unsigned int threshold, float inv_keep,
                                const unsigned long long* __restrict__ seed_ptr,
                                unsigned int site,
                                unsigned int b0, unsigned int h0, int dropout, int vec) {
  // the site's Philox key, from the step's seed in device memory
  const unsigned long long seed = dropout ? d2r::site_key(seed_ptr, site) : 0ull;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x;
  const int rows_q = nthreads / 2;  // 16 a warp
  const int s16 = (S + 15) & ~15;
  const int d16 = (D + 15) & ~15;
  const int ld = d16 + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [rows_q][ld]
  bf16* ks = qs + rows_q * ld;                   // [s16][ld]
  bf16* vs = ks + s16 * ld;                      // [s16][ld]

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  d2r::zero_pad_columns(qs, ld, rows_q + 2 * s16, D, d16, tid, nthreads);
  d2r::load_tile(qs, ld, q + b * q_bs + (long long)h * D, q_rs, rows_q, L, D, vec, tid,
                 nthreads);
  d2r::load_tile(ks, ld, k + b * k_bs + (long long)h * D, k_rs, s16, S, D, vec, tid,
                 nthreads);
  d2r::load_tile(vs, ld, v + b * v_bs + (long long)h * D, v_rs, s16, S, D, vec, tid,
                 nthreads);
  d2r::cp_async_commit();
  d2r::cp_async_wait<0>();
  __syncthreads();

  const int nkd = d16 / 16;  // k16 steps over the head
  const int row_w = warp * 16;

  // scores: bf16 q . k, fp32 sums
  float s[SMAX / 8][4];
#pragma unroll
  for (int n = 0; n < SMAX / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk >= nkd) break;
    uint32_t a[4];
    d2r::ldmatrix_x4(a, qs + (row_w + lane % 16) * ld + kk * 16 + (lane / 16) * 8);
    d2r::score_step<SMAX>(s, a, ks, ld, kk, S, lane);
  }
  // scale and bias in fp32 after the product (:83-86), keys past S to -inf
  d2r::scale_bias_mask<SMAX>(s, scale, bias == nullptr ? nullptr : bias + b * S, S, t4);

  // softmax over each full row, p = e / sum in fp32 (:87-89)
  d2r::softmax_rows<SMAX>(s);

  // dropout: lanes t4 and t4 ^ 1 share their Philox calls
  if (dropout) {
#pragma unroll
    for (int n = 0; n < SMAX / 8; ++n) {
      if (n * 8 >= S) break;
      uint32_t bits[4];
      d2r::fragment_dropout_bits(bits, seed, (uint32_t)b + b0, h + h0, row_w, n, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = bits[e] >= threshold ? s[n][e] * inv_keep : 0.f;
    }
  }

  // p.V: p rounded to bf16 (:93-96) as the A operand, fp32 accumulation
  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SMAX / 16; ++kk) {
    if (kk * 16 >= S) break;
    uint32_t a[1][4];
    d2r::pack_a<SMAX>(a[0], s, kk);
    d2r::pv_step<DMAX, 1>(acc, a, vs, ld, kk, nkd, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    if (row < L) d2r::store_row<DMAX>(out + ((b * L + row) * H + h) * (long long)D, acc, r, 1.f,
                                      D, t4);
  }
}

template <int SMAX, int DMAX>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int L, int S, int H, int D, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
                unsigned int threshold, float inv_keep,
                const unsigned long long* seed, unsigned int site,
                unsigned int b0, unsigned int h0, int dropout,
                cudaStream_t stream) {
  const int warps = (L + 15) / 16;
  const size_t ld = ((D + 15) & ~15) + 8;
  const size_t smem = sizeof(bf16) * (16 * warps + 2 * ((S + 15) & ~15)) * ld;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fused_attention_fwd_bf16_kernel<SMAX, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = d2r::vec_ok(q, D, q_bs, q_rs) && d2r::vec_ok(k, D, k_bs, k_rs) &&
                  d2r::vec_ok(v, D, v_bs, v_rs);
  const dim3 grid(1, H, B);
  fused_attention_fwd_bf16_kernel<SMAX, DMAX><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
      threshold, inv_keep, seed, site, b0, h0, dropout, vec);
  return (int)cudaGetLastError();
}

template <int SMAX>
int launch_bf16_d(int D, const void* q, const void* k, const void* v, const float* bias,
                  void* out, int B, int L, int S, int H, long long q_bs, long long q_rs,
                  long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
                  unsigned int threshold, float inv_keep,
                  const unsigned long long* seed, unsigned int site,
                  unsigned int b0, unsigned int h0, int dropout,
                  cudaStream_t stream) {
  if (D <= 64)
    return launch_bf16<SMAX, 64>(q, k, v, bias, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs,
                                 v_bs, v_rs, scale, threshold, inv_keep,
                                 seed, site, b0, h0, dropout, stream);
  return launch_bf16<SMAX, 128>(q, k, v, bias, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs,
                                v_bs, v_rs, scale, threshold, inv_keep,
                                seed, site, b0, h0, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no key bias).
// dropout = 0: no dropout (threshold, inv_keep, seed and site unused); else
// keep iff the element's Philox bits >= threshold, kept p times inv_keep,
// under the key site_key(seed, site) (dropout_philox.cuh): seed points at
// the step's 64-bit seed in device memory, so a CUDA graph that captured
// the launch draws the masks of whatever step the buffer holds.
// b0 and h0: the global batch row and head of this launch's (0, 0), so the
// bits of element (b, h, i, j) are those of (b + b0, h + h0, i, j) of the
// whole step's tensor, whichever rows and heads this process holds.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int d2r_fused_attention_fwd(int dtype, const void* q, const void* k,
                                       const void* v, const void* bias, void* out,
                                       int B, int L, int S, int H, int D,
                                       long long q_bs, long long q_rs,
                                       long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, float scale,
                                       unsigned int threshold, float inv_keep,
                                       const unsigned long long* seed,
                                       unsigned int site,
                                       unsigned int b0, unsigned int h0, int dropout,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || D < 1 || L > kMaxSeq || S > kMaxSeq ||
      D > kMaxDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, b, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs,
                         v_bs, v_rs, scale, threshold, inv_keep,
                         seed, site, b0, h0, dropout, st);
  if (dtype == 1) {
    if (S <= 64)
      return launch_bf16_d<64>(D, q, k, v, b, out, B, L, S, H, q_bs, q_rs, k_bs, k_rs, v_bs,
                               v_rs, scale, threshold, inv_keep,
                               seed, site, b0, h0, dropout, st);
    return launch_bf16_d<128>(D, q, k, v, b, out, B, L, S, H, q_bs, q_rs, k_bs, k_rs, v_bs,
                              v_rs, scale, threshold, inv_keep,
                              seed, site, b0, h0, dropout, st);
  }
  return (int)cudaErrorInvalidValue;
}
