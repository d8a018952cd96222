// Short-sequence fused attention, backward (K2), for Hopper (sm_90a): a bf16
// kernel on the tensor cores and an fp32 kernel on the CUDA cores.
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
// ~295 at which the tensor cores become the limit. So both kernels read
// each input once into shared memory and keep the (L,S) tiles on chip;
// nothing of size (L,S) reaches device memory. Each dk/dv row is summed by
// one warp in a fixed order, with no atomics, so two runs give the same
// bits. dbias (off the main path: the padding bias needs no gradient, and
// the wrapper passes null) is summed over heads with fp32 atomics, in no
// fixed order.
//
// Layout: q, g are (B,L,H,D) and k, v (B,S,H,D) with the head stride D and
// the element stride 1, any batch and row stride (q, k, v are views of the
// fused QKV product). dq, dk, dv are contiguous.
//
// bf16: tensor cores (fused_attention_bwd_bf16_kernel), one pass. S, D <=
// 128 let one block hold a whole (b,h): grid (H, B), 768 blocks at the BERT
// site (B = 64, H = 12), ceil(max(L,S)/16) warps. The block stages q, g, K
// and V once as bf16 by 16-byte cp.async (element loads where a view is not
// 16-byte aligned; rows and columns zero-filled up to multiples of 16).
//   Row phase, a warp over 16 query rows:
//   - s = q.K^T and dpd = g.V^T on the tensor cores (mma.sync m16n8k16,
//     bf16 operands, fp32 sums), then scale and bias in fp32, keys past S
//     to -inf; the whole-row softmax in registers (max and sum over the 4
//     lanes of a row by __shfl_xor_sync);
//   - the dropout mask applied to pd and dp: each element's bits are drawn
//     once a launch, here, one Philox call a lane covering four elements
//     (lanes t and t^1 share two calls by shuffle, as K1);
//   - rowsum(dp*p) and dlog = p*(dp - rowsum) in fp32 (dbias's column sums
//     from these fp32 values: shuffles over the 8 lanes of a column, then
//     warps in shared memory in a fixed order);
//   - round(dlog), packed to bf16 from the fragments, is at once the A
//     operand of dq = round(dlog).K (K read transposed, as K1 reads V), and
//     scale multiplies the fp32 sums; round(dlog) and round(pd) also go to
//     two (L,S) bf16 tiles in shared memory.
//   Column phase, after __syncthreads, a warp over 16 keys:
//   - dk = round(dlog)^T.Q * scale and dv = round(pd)^T.G, the A operands
//     read transposed from the (L,S) tiles by ldmatrix.trans, Q and G as
//     the B operands read as p.V reads V. No score is recomputed and no
//     mask bit is drawn again.
// So each of s, dpd, dq, dk, dv is one tensor-core product, and the JAX
// kernel's rounding points hold: p, dropout and dlog fp32; pd and dlog
// rounded to bf16 before their products; scale after the fp32 sums; dq,
// dk, dv rounded once at the store. bf16 products are exact in fp32, so the
// kernel differs from the plain version only in summation order.
// Shared memory: q, g, K, V at (d16 + 8) bf16 a row and the two (L,S) tiles
// at (s16 + 8) a row (d16, s16: D and S rounded up to 16), plus ceil(L/16)
// x s16 fp32 for dbias when asked: 54 KiB at the model's L = S = D = 64 (4
// blocks an SM), 204 KiB at L = S = D = 128 (+ 4 KiB with dbias), under the
// 227 KiB a block may have. Registers: templated on (SMAX, DMAX) in
// {64, 128}^2, as K1. Why mma.sync and not wgmma: as K1, a (b,h) is one
// 64-row tile at the model's sites, its roofline bound is the bytes
// whatever unit multiplies, and the warp-level product keeps each warp's
// rows, softmax and mask in its own registers.
//
// fp32: CUDA cores (fused_attention_bwd_kernel), the first design, kept as
// it was: the card-versus-CPU train-step checks hold it to the plain version
// at 1e-5, which TF32 would break. Grid (H, B), 8 warps, two passes over
// the tile:
//   pass 1, warps over query rows i, with K and V staged: p, dp and dlog
//     for row i, then dq[i]; the row's softmax max, sum and rowsum(dp*p)
//     are kept in shared memory;
//   pass 2, warps over key columns j, with Q and G staged in the same
//     shared memory: p and dp of column j recomputed from those statistics
//     with the same operations as pass 1 (so the same fp32 values), then
//     dk[j], dv[j] and the column sum of dlog.
// Shared memory: two (max(L,S), D+1) fp32 tiles, 3L row statistics and per
// warp two D-rows and two max(L,S)-rows: 150 KB at L = S = D = 128, 42 KB at
// the model's 64/64/64. Rows are padded to D+1 floats so that 32 lanes, each
// on its own row, read 32 different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "dropout_philox.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;
constexpr int kMaxDim = 128;
constexpr int kPerLane = 4;  // kMaxSeq / 32 rows and kMaxDim / 32 columns a lane
static_assert(kMaxSeq == 32 * kPerLane && kMaxDim == 32 * kPerLane, "lane tiling");

// The fp32 kernel's template is instantiated for float alone: bf16 has its
// own kernel below.
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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
                           const unsigned long long* __restrict__ seed_ptr,
                           unsigned int site, unsigned int b0, unsigned int h0, int dropout) {
  // the site's Philox key, from the step's seed in device memory
  const unsigned long long seed = dropout ? d2r::site_key(seed_ptr, site) : 0ull;
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
        dp[t] = d2r::dropout_bits(seed, (uint32_t)b + b0, h + h0, i, j) >= threshold
                    ? dp[t] * inv_keep
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
          const bool keep =
              d2r::dropout_bits(seed, (uint32_t)b + b0, h + h0, i, j) >= threshold;
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
           unsigned int threshold, float inv_keep,
           const unsigned long long* seed, unsigned int site,
           unsigned int b0, unsigned int h0, int dropout,
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
      g_rs, scale, threshold, inv_keep, seed, site, b0, h0, dropout);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int kTcMaxWarps = kMaxSeq / 16;  // 16 query rows, then 16 keys, a warp

// SMAX, DMAX: the key count and head width the registers are sized for
// (64 or 128 each); the loops run over the L queries, S keys and D columns
// present, rounded up to 16.
template <int SMAX, int DMAX>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
fused_attention_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                const bf16* __restrict__ g, bf16* __restrict__ dq,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                float* __restrict__ dbias, int L, int S, int H, int D,
                                long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                                long long v_bs, long long v_rs, long long g_bs, long long g_rs,
                                float scale, unsigned int threshold, float inv_keep,
                                const unsigned long long* __restrict__ seed_ptr,
                                unsigned int site,
                                unsigned int b0, unsigned int h0, int dropout, int vec) {
  // the site's Philox key, from the step's seed in device memory
  const unsigned long long seed = dropout ? d2r::site_key(seed_ptr, site) : 0ull;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x;
  const int l16 = (L + 15) & ~15;
  const int s16 = (S + 15) & ~15;
  const int d16 = (D + 15) & ~15;
  const int ld = d16 + 8;   // row stride of the q, g, K, V tiles
  const int lds = s16 + 8;  // row stride of the (L,S) tiles
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [l16][ld]
  bf16* gs = qs + l16 * ld;                      // [l16][ld]
  bf16* ks = gs + l16 * ld;                      // [s16][ld]
  bf16* vs = ks + s16 * ld;                      // [s16][ld]
  bf16* dls = vs + s16 * ld;                     // [l16][lds]: round(dlog)
  bf16* pds = dls + l16 * lds;                   // [l16][lds]: round(pd)
  float* cols = reinterpret_cast<float*>(pds + l16 * lds);  // [l16/16][s16]: dbias

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const long long hD = (long long)H * D;

  d2r::zero_pad_columns(qs, ld, 2 * l16 + 2 * s16, D, d16, tid, nthreads);
  d2r::load_tile(qs, ld, q + b * q_bs + (long long)h * D, q_rs, l16, L, D, vec, tid, nthreads);
  d2r::load_tile(gs, ld, g + b * g_bs + (long long)h * D, g_rs, l16, L, D, vec, tid, nthreads);
  d2r::load_tile(ks, ld, k + b * k_bs + (long long)h * D, k_rs, s16, S, D, vec, tid, nthreads);
  d2r::load_tile(vs, ld, v + b * v_bs + (long long)h * D, v_rs, s16, S, D, vec, tid, nthreads);
  d2r::cp_async_commit();
  d2r::cp_async_wait<0>();
  __syncthreads();

  const int nkd = d16 / 16;  // k16 steps over the head

  // ---- row phase: this warp's 16 query rows ----
  const int row_w = warp * 16;
  if (row_w < L) {  // uniform across the warp
    float s[SMAX / 8][4], dp[SMAX / 8][4];
#pragma unroll
    for (int n = 0; n < SMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    // s = q.K^T and dpd = g.V^T: bf16 operands, fp32 sums
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk >= nkd) break;
      uint32_t a[4];
      d2r::ldmatrix_x4(a, qs + (row_w + lane % 16) * ld + kk * 16 + (lane / 16) * 8);
      d2r::score_step<SMAX>(s, a, ks, ld, kk, S, lane);
      d2r::ldmatrix_x4(a, gs + (row_w + lane % 16) * ld + kk * 16 + (lane / 16) * 8);
      d2r::score_step<SMAX>(dp, a, vs, ld, kk, S, lane);
    }
    // scale and bias in fp32 after the product (:124-127), keys past S to
    // -inf, then p = softmax in fp32 (:128-130)
    d2r::scale_bias_mask<SMAX>(s, scale, bias == nullptr ? nullptr : bias + b * S, S, t4);
    d2r::softmax_rows<SMAX>(s);

    // rows g4 (e = 0, 1) and g4 + 8 (e = 2, 3); rows past L give zeros
    const bool live[2] = {row_w + g4 < L, row_w + g4 + 8 < L};
    // the mask on pd and dp (:131-135, :145-148), drawn once; round(pd)
    // (:136) into its tile. Keys in [S, s16) have p = 0, so pd = 0.
#pragma unroll
    for (int n = 0; n < SMAX / 8; ++n) {
      if (n * 8 >= s16) break;
      float pd[4] = {s[n][0], s[n][1], s[n][2], s[n][3]};
      if (dropout && n * 8 < S) {
        uint32_t bits[4];
        d2r::fragment_dropout_bits(bits, seed, (uint32_t)b + b0, h + h0, row_w, n, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = bits[e] >= threshold;
          pd[e] = keep ? pd[e] * inv_keep : 0.f;
          dp[n][e] = keep ? dp[n][e] * inv_keep : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(pds + (row_w + g4 + 8 * r) * lds + n * 8 + 2 * t4) =
            d2r::pack_bf16(live[r] ? pd[2 * r] : 0.f, live[r] ? pd[2 * r + 1] : 0.f);
    }

    // dlog = p * (dp - rowsum(dp * p)) in fp32 (:150), in place of p
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < SMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dot[e / 2] = fmaf(dp[n][e], s[n][e], dot[e / 2]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
    }
#pragma unroll
    for (int n = 0; n < SMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = live[e / 2] ? s[n][e] * (dp[n][e] - dot[e / 2]) : 0.f;

    // dbias: this warp's column sums of the fp32 dlog, over the 8 lanes
    // that hold a column; warps are summed after the barrier
    if (dbias != nullptr) {
#pragma unroll
      for (int n = 0; n < SMAX / 8; ++n) {
        if (n * 8 >= s16) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = s[n][e] + s[n][e + 2];
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (g4 == 0) cols[warp * s16 + n * 8 + 2 * t4 + e] = c;
        }
      }
    }

    // round(dlog) (:151) into its tile, and dq = round(dlog).K * scale
    // (:152-154): the packed fragments are the A operand straight away
#pragma unroll
    for (int n = 0; n < SMAX / 8; ++n) {
      if (n * 8 >= s16) break;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(dls + (row_w + g4 + 8 * r) * lds + n * 8 + 2 * t4) =
            d2r::pack_bf16(s[n][2 * r], s[n][2 * r + 1]);
    }
    float acc[DMAX / 8][4];
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < SMAX / 16; ++kk) {
      if (kk * 16 >= S) break;
      uint32_t a[1][4];
      d2r::pack_a<SMAX>(a[0], s, kk);
      d2r::pv_step<DMAX, 1>(acc, a, ks, ld, kk, nkd, lane);
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= scale;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (live[r])
        d2r::store_row<DMAX>(dq + (b * L + row_w + g4 + 8 * r) * hD + (long long)h * D, acc, r,
                             1.f, D, t4);
  }
  __syncthreads();  // the (L,S) tiles and the column sums are complete

  // dbias[b, j]: the row warps' sums in a fixed order, then over heads
  if (dbias != nullptr && tid < S) {
    float c = 0.f;
    for (int w = 0; w < l16 / 16; ++w) c += cols[w * s16 + tid];
    atomicAdd(dbias + b * S + tid, c);
  }

  // ---- column phase: this warp's 16 keys ----
  const int key_w = warp * 16;
  if (key_w < S) {  // uniform across the warp
    float ak[DMAX / 8][4], av[DMAX / 8][4];
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
    // dk = round(dlog)^T.Q (:155-157), dv = round(pd)^T.G (:138-140), over
    // the queries 16 at a time
    for (int kk = 0; kk < l16 / 16; ++kk) {
      uint32_t a[1][4];
      d2r::load_a_trans(a[0], dls, lds, kk * 16, key_w, lane);
      d2r::pv_step<DMAX, 1>(ak, a, qs, ld, kk, nkd, lane);
      d2r::load_a_trans(a[0], pds, lds, kk * 16, key_w, lane);
      d2r::pv_step<DMAX, 1>(av, a, gs, ld, kk, nkd, lane);
    }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[n][e] *= scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = key_w + g4 + 8 * r;
      if (j < S) {
        d2r::store_row<DMAX>(dk + (b * S + j) * hD + (long long)h * D, ak, r, 1.f, D, t4);
        d2r::store_row<DMAX>(dv + (b * S + j) * hD + (long long)h * D, av, r, 1.f, D, t4);
      }
    }
  }
}

template <int SMAX, int DMAX>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, const void* g,
                void* dq, void* dk, void* dv, float* dbias, int B, int L, int S, int H, int D,
                long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                long long v_rs, long long g_bs, long long g_rs, float scale,
                unsigned int threshold, float inv_keep,
                const unsigned long long* seed, unsigned int site,
                unsigned int b0, unsigned int h0, int dropout,
                cudaStream_t stream) {
  const size_t l16 = (L + 15) & ~15, s16 = (S + 15) & ~15;
  const size_t ld = ((D + 15) & ~15) + 8, lds = s16 + 8;
  const size_t smem = sizeof(bf16) * ((2 * l16 + 2 * s16) * ld + 2 * l16 * lds) +
                      (dbias != nullptr ? sizeof(float) * (l16 / 16) * s16 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fused_attention_bwd_bf16_kernel<SMAX, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = d2r::vec_ok(q, D, q_bs, q_rs) && d2r::vec_ok(k, D, k_bs, k_rs) &&
                  d2r::vec_ok(v, D, v_bs, v_rs) && d2r::vec_ok(g, D, g_bs, g_rs);
  const int warps = ((L > S ? L : S) + 15) / 16;
  const dim3 grid(H, B);
  fused_attention_bwd_bf16_kernel<SMAX, DMAX><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbias, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs,
      scale, threshold, inv_keep, seed, site, b0, h0, dropout, vec);
  return (int)cudaGetLastError();
}

template <int SMAX>
int launch_bf16_d(const void* q, const void* k, const void* v, const float* bias, const void* g,
                  void* dq, void* dk, void* dv, float* dbias, int B, int L, int S, int H, int D,
                  long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                  long long v_bs, long long v_rs, long long g_bs, long long g_rs, float scale,
                  unsigned int threshold, float inv_keep,
                  const unsigned long long* seed, unsigned int site,
                  unsigned int b0, unsigned int h0, int dropout,
                  cudaStream_t stream) {
  if (D <= 64)
    return launch_bf16<SMAX, 64>(q, k, v, bias, g, dq, dk, dv, dbias, B, L, S, H, D, q_bs,
                                 q_rs, k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, scale, threshold,
                                 inv_keep, seed, site, b0, h0, dropout, stream);
  return launch_bf16<SMAX, 128>(q, k, v, bias, g, dq, dk, dv, dbias, B, L, S, H, D, q_bs, q_rs,
                                k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, scale, threshold, inv_keep,
                                seed, site, b0, h0, dropout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no key bias); dbias
// may be null (not wanted), else a zeroed (B, S) fp32 buffer it adds into.
// dropout = 0: no dropout; else keep iff the element's Philox bits >=
// threshold, kept values times inv_keep (as K1 with the same seed, site, b0
// and h0).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int d2r_fused_attention_bwd(int dtype, const void* q, const void* k,
                                       const void* v, const void* bias, const void* g,
                                       void* dq, void* dk, void* dv, void* dbias, int B,
                                       int L, int S, int H, int D, long long q_bs,
                                       long long q_rs, long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, long long g_bs,
                                       long long g_rs, float scale,
                                       unsigned int threshold, float inv_keep,
                                       const unsigned long long* seed,
                                       unsigned int site,
                                       unsigned int b0, unsigned int h0, int dropout,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || D < 1 || L > kMaxSeq || S > kMaxSeq ||
      D > kMaxDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bi = static_cast<const float*>(bias);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bi, g, dq, dk, dv, db, B, L, S, H, D, q_bs, q_rs, k_bs,
                         k_rs, v_bs, v_rs, g_bs, g_rs, scale, threshold, inv_keep, seed, site,
                         b0, h0, dropout, st);
  if (dtype == 1) {
    if (S <= 64)
      return launch_bf16_d<64>(q, k, v, bi, g, dq, dk, dv, db, B, L, S, H, D, q_bs, q_rs,
                               k_bs, k_rs, v_bs, v_rs, g_bs, g_rs, scale, threshold, inv_keep,
                               seed, site, b0, h0, dropout, st);
    return launch_bf16_d<128>(q, k, v, bi, g, dq, dk, dv, db, B, L, S, H, D, q_bs, q_rs, k_bs,
                              k_rs, v_bs, v_rs, g_bs, g_rs, scale, threshold, inv_keep, seed,
                              site, b0, h0, dropout, st);
  }
  return (int)cudaErrorInvalidValue;
}
