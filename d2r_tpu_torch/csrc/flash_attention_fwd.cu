// Long-context attention, forward (K3), for Hopper (sm_90a): two bf16
// bodies on the tensor cores (warpgroup MMA over TMA tiles where the views
// allow it, mma.sync elsewhere) and an fp32 body on the CUDA cores. Which
// body takes a launch is the wrapper's rule on type, shape and alignment
// (flash_attention.py body_for); a body that cannot take a launch refuses
// it.
//
// Replaces d2r_tpu/ops/kernels/flash_attention.py::_attention_kernel. Per
// (batch b, head h), for every query row i, over the keys j < S in tiles:
//
//   qs[:]  = q[b,i,h,:] * scale                          (fp32, :48)
//   s[j]   = qs . k[b,j,h,:] + bias[b,j]                 (fp32)
//   m      = max(m_prev, max_j s[j]), m starting at -1e30
//   p[j]   = exp(s[j] - m); c = exp(m_prev - m)          (fp32)
//   l      = l * c + sum_j p[j]
//   acc    = acc * c + sum_j p[j] * v[b,j,h,:]           (p stays fp32, :65)
//   out[b,i,h,:] = acc / l, cast once to the input type  (:73)
//
// for any L, S, D >= 1, fp32 or bf16, with the additive (B,S)
// fp32 key bias or none. No dropout (the JAX dispatch sends dropout
// elsewhere). Keys past S are not padded but absent: they are masked to
// -inf in the scores of the last key tile.
//
// What bounds it on the H100: at the vision sites of D2R-large (L = S = 257,
// D = 64) it does 4*L*S*D operations per (b,h) against 2*(L+2S)*D bytes in
// bf16, about 86 operations a byte. In bf16 that is under the tensor cores'
// ridge (~295), so the bound is bytes; in fp32 on the CUDA cores (~20 a
// byte) it is operations.
//
// Layout: q is (B,L,H,D), k and v (B,S,H,D), with the head stride D and
// the element stride 1 but any batch and row stride, so the strided views
// of the fused QKV projection are read without copies. out is a contiguous
// (B,L,H,D).
//
// bf16 at D = 64 on views TMA can describe (every K3 site of D2R-large):
// the wgmma body, flash_attention_fwd_wgmma_kernel (its section below).
//
// Other bf16 views up to D = 256: the mma.sync body
// (flash_attention_fwd_bf16_kernel). Grid (ceil(L/64),
// H, B), 4 warps a block, 16 query rows a warp: 5 x 16 x 32 = 2,560 blocks
// at the CLIP-L site. K and V come in tiles of 64 keys (32 at D > 128),
// double-buffered, staged as bf16 by 16-byte cp.async (zero-filled past S);
// the block's 64 query rows are staged once the same way. Per tile a warp
//   - multiplies its raw bf16 q rows by the K tile on the tensor cores
//     (mma.sync m16n8k16, fp32 accumulation), then applies scale in fp32
//     to the fp32 sums and adds the bias: this differs from the JAX
//     kernel's q * scale first (:48) by fp32 rounding alone;
//   - runs the online softmax in registers (m from -1e30, the correction
//     factor, a row sum l per lane), each row's max and sum reduced over
//     the 4 lanes that hold it by __shfl_xor_sync;
//   - splits p into hi = bf16(p) and lo = bf16(p - hi) and runs both
//     through p.V into the same fp32 accumulator, so p enters p.V with
//     ~16 bits of mantissa instead of bf16's 8: the JAX kernel keeps p in
//     fp32 (:65), and rounding p to bf16 once would take the error to the
//     edge of the 4e-3 tolerance. The accumulators of the score tile are
//     the A operand of p.V directly (see mma_bf16.cuh);
//   - skips the key columns of a ragged last tile 16 at a time.
// The output is acc / l, cast once (:73). The score product, the scale,
// bias and mask step, the p.V product and the row store are mma_bf16.cuh's,
// shared with K1; the online softmax and the hi/lo split are this kernel's.
// A warp whose 16 rows all lie past L still helps load tiles but does no
// products, so the 257th row costs one warp, not a block. Each block of 64
// rows stages K and V again (five times a (b, h) at L = 257), and a warp
// runs its products, softmax and split in series: at the CLIP-L site (B
// 32) on an H100 SXM at 700 W it takes 130 us against SDPA's 62, and the
// wgmma body replaces it there. Shared
// memory: 45 KiB at D = 64 (four blocks an SM), 85 KiB at D = 128, 99 KiB
// at D = 256.
//
// fp32: CUDA cores (flash_attention_fwd_kernel), the first design, kept as
// it was: its fp32 products are what the card-versus-CPU checks hold
// within 1.2e-6, which TF32 tensor cores would break. Grid (ceil(L / 32)
// query tiles, H, B), 8 warps a block, 4 query rows a warp. Each block
// stages its 32 query rows once (scaled, fp32) and then walks the keys in
// tiles of 64, staged in shared memory as fp32: K transposed to [d][j] with
// rows of 65 floats, so the 32 lanes, each scoring its own keys, read 32
// different banks; V as [j][d], lanes owning columns. A warp scores its 4
// rows at once; p goes through a per-warp row of shared memory to the p.V
// products. 48.25 KiB at D = 64, 88.5 KiB at D = 128, 169 KiB at D = 256.
//
// D > 256, fp32 and bf16: CUDA cores (flash_attention_fwd_wide_kernel), the
// fp32 kernel's arithmetic with the head walked in slabs of 64 columns for
// the scores and the output cut in chunks of 128 columns, one a block, so
// shared memory stays at 64.25 KiB and the registers at 4 output columns a
// lane for any D (see its comment). JAX's kernel has no limit on D; neither
// has this one.
//
// A launch that needs more than 48 KiB of shared memory raises the dynamic
// limit first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 32
constexpr int kTileK = 64;                            // keys a tile: 2 a lane
constexpr int kLdK = kTileK + 1;                      // K^T row, padded
constexpr int kMaxDim = 256;                          // wider heads: the wide kernel
constexpr float kNegInit = -1e30f;                    // flash_attention.py:34

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

__device__ __forceinline__ float lane_of(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// NT = ceil(D / 32): the columns a lane owns in p.V (d = lane + 32 t).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           T* __restrict__ out, int L, int S, int H, int D,
                           long long q_bs, long long q_rs, long long k_bs,
                           long long k_rs, long long v_bs, long long v_rs,
                           float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = (D + 3) & ~3;               // q rows and K^T rows padded to 4
  float* qs = smem;                          // [kRowsPerBlock][dp]
  float* kt = qs + kRowsPerBlock * dp;       // [dp][kLdK]
  float* vs = kt + dp * kLdK;                // [kTileK][D]
  float* ps = vs + kTileK * D;               // [kWarps][kRowsPerWarp][kTileK]

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Stage the block's query rows, scaled; rows past L and columns past D
  // are zero, so they add nothing to a score.
  const T* qb = q + b * q_bs + (long long)h * D;
  for (int i = tid; i < kRowsPerBlock * dp; i += kThreads) {
    const int r = i / dp;
    const int d = i - r * dp;
    const int row = row0 + r;
    qs[i] = (row < L && d < D) ? to_float(qb[row * q_rs + d]) * scale : 0.f;
  }
  // K^T rows past D stay zero for every tile (uninitialised shared memory
  // could hold a NaN pattern, and 0 * NaN is NaN).
  for (int i = D * kLdK + tid; i < dp * kLdK; i += kThreads) kt[i] = 0.f;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInit;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  const T* kb = k + b * k_bs + (long long)h * D;
  const T* vb = v + b * v_bs + (long long)h * D;
  const float* bb = bias == nullptr ? nullptr : bias + b * S;
  const float4* qw = reinterpret_cast<const float4*>(qs + warp * kRowsPerWarp * dp);
  float* pw = ps + warp * kRowsPerWarp * kTileK;

  for (int j0 = 0; j0 < S; j0 += kTileK) {
    const int nk = min(kTileK, S - j0);
    __syncthreads();  // the previous tile is no longer read (and qs is staged)
    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      float kv = 0.f, vv = 0.f;  // keys past S: zero, so p.V meets no NaN
      if (j < nk) {
        kv = to_float(kb[(long long)(j0 + j) * k_rs + d]);
        vv = to_float(vb[(long long)(j0 + j) * v_rs + d]);
      }
      kt[d * kLdK + j] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    // Scores: lane owns keys lane and lane + 32 of the tile, for 4 rows.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d4 = 0; d4 < dp / 4; ++d4) {
      float4 qv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) qv[r] = qw[r * (dp / 4) + d4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* kr = kt + (4 * d4 + e) * kLdK;
        const float k0 = kr[lane];
        const float k1 = kr[lane + 32];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float qd = lane_of(qv[r], e);
          s[r][0] = fmaf(qd, k0, s[r][0]);
          s[r][1] = fmaf(qd, k1, s[r][1]);
        }
      }
    }
    const bool in0 = lane < nk, in1 = lane + 32 < nk;
    const float b0 = (bb != nullptr && in0) ? bb[j0 + lane] : 0.f;
    const float b1 = (bb != nullptr && in1) ? bb[j0 + lane + 32] : 0.f;

    // Online softmax, one row at a time; the max is warp-wide, the sum stays
    // per lane until the end (the correction factor is the same on every
    // lane, so the lanes' partial sums rescale like the whole).
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float s0 = in0 ? s[r][0] + b0 : -INFINITY;
      const float s1 = in1 ? s[r][1] + b1 : -INFINITY;
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[r], mt);
      const float c = expf(m[r] - m_new);
      const float p0 = expf(s0 - m_new);  // exp(-inf) = 0 for absent keys
      const float p1 = expf(s1 - m_new);
      m[r] = m_new;
      l[r] = l[r] * c + (p0 + p1);
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= c;
      pw[r * kTileK + lane] = p0;
      pw[r * kTileK + lane + 32] = p1;
    }
    __syncwarp();

    // p.V: lane owns columns lane + 32 t; p read 4 keys at a time.
    const float4* pw4 = reinterpret_cast<const float4*>(pw);
    for (int j4 = 0; j4 < (nk + 3) / 4; ++j4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pv[r] = pw4[r * (kTileK / 4) + j4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vs + (4 * j4 + e) * D;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          const float x = d < D ? vr[d] : 0.f;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][t] = fmaf(lane_of(pv[r], e), x, acc[r][t]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float sum = l[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= L) continue;
    T* orow = out + ((b * L + row) * H + h) * (long long)D;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = from_float<T>(acc[r][t] / sum);
    }
  }
}

size_t smem_bytes(int D) {
  const size_t dp = (D + 3) & ~3;
  return sizeof(float) * (kRowsPerBlock * dp + dp * kLdK + (size_t)kTileK * D +
                          (size_t)kWarps * kRowsPerWarp * kTileK);
}

// NT = ceil(D / 32), picked at compile time from 1 up to kMaxDim / 32.
template <typename T, int NT = 1>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           int B, int L, int S, int H, int D, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
           cudaStream_t stream) {
  if constexpr (NT < kMaxDim / 32) {
    if (D > 32 * NT)
      return launch<T, NT + 1>(q, k, v, bias, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs,
                               v_bs, v_rs, scale, stream);
  }
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  flash_attention_fwd_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  return (int)cudaGetLastError();
}

// ---- any head width: D > 256, fp32 and bf16 ----
//
// The kernels above size registers and shared memory by the head: above
// D = 256 the fp32 one's tiles outgrow shared memory and the bf16 one's
// accumulator its registers. This one takes any D. Each block owns 32
// query rows and one chunk of kWideChunk output columns (grid
// (ceil(L / 32) x ceil(D / 128), H, B)); the scores walk the head in slabs
// of kWideSlab columns, q's and K^T's slab staged in shared memory in
// turn, and the p.V accumulator holds only the block's chunk. The blocks of
// one query tile thus compute the same scores and softmax, each for its own
// columns (ceil(D / 128) times the score work, none of it shared through
// memory). Its arithmetic is the fp32 kernel's for every input type: fp32
// products on the CUDA cores, in the same order over d, so at D <= 256 it
// would give that kernel's bits; bf16 inputs are widened on load.
// Shared memory does not grow with D: 32 x 64 + 64 x 65 + 64 x 128 +
// 8 x 4 x 64 floats = 64.25 KiB.

constexpr int kWideSlab = 64;                  // head columns a score pass
constexpr int kWideChunk = 128;                // output columns a block
constexpr int kWideNT = kWideChunk / 32;       // 4 a lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const float* __restrict__ bias,
                                T* __restrict__ out, int L, int S, int H, int D,
                                long long q_bs, long long q_rs, long long k_bs,
                                long long k_rs, long long v_bs, long long v_rs,
                                float scale, int chunks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                                // [kRowsPerBlock][kWideSlab]
  float* kt = qs + kRowsPerBlock * kWideSlab;      // [kWideSlab][kLdK]
  float* vs = kt + kWideSlab * kLdK;               // [kTileK][kWideChunk]
  float* ps = vs + kTileK * kWideChunk;            // [kWarps][kRowsPerWarp][kTileK]

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int c0 = (blockIdx.x % chunks) * kWideChunk;
  const int dc = min(kWideChunk, D - c0);
  const int row0 = (blockIdx.x / chunks) * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kWideNT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInit;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kWideNT; ++t) acc[r][t] = 0.f;
  }

  const T* qb = q + b * q_bs + (long long)h * D;
  const T* kb = k + b * k_bs + (long long)h * D;
  const T* vb = v + b * v_bs + (long long)h * D + c0;
  const float* bb = bias == nullptr ? nullptr : bias + b * S;
  const float4* qw = reinterpret_cast<const float4*>(qs + warp * kRowsPerWarp * kWideSlab);
  float* pw = ps + warp * kRowsPerWarp * kTileK;

  for (int j0 = 0; j0 < S; j0 += kTileK) {
    const int nk = min(kTileK, S - j0);
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWideSlab) {
      const int ds = min(kWideSlab, D - d0);
      __syncthreads();  // the previous slab (and tile) is no longer read
      for (int i = tid; i < kRowsPerBlock * kWideSlab; i += kThreads) {
        const int r = i / kWideSlab, d = i % kWideSlab, row = row0 + r;
        qs[i] = (row < L && d < ds) ? to_float(qb[row * q_rs + d0 + d]) * scale : 0.f;
      }
      for (int i = tid; i < kTileK * kWideSlab; i += kThreads) {
        const int j = i / kWideSlab, d = i % kWideSlab;
        kt[d * kLdK + j] = (j < nk && d < ds) ? to_float(kb[(long long)(j0 + j) * k_rs + d0 + d])
                                              : 0.f;
      }
      if (d0 == 0) {  // the tile's V chunk, read after the last slab
        for (int i = tid; i < kTileK * kWideChunk; i += kThreads) {
          const int j = i / kWideChunk, d = i % kWideChunk;
          vs[i] = (j < nk && d < dc) ? to_float(vb[(long long)(j0 + j) * v_rs + d]) : 0.f;
        }
      }
      __syncthreads();
      for (int d4 = 0; d4 < kWideSlab / 4; ++d4) {
        float4 qv[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) qv[r] = qw[r * (kWideSlab / 4) + d4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* kr = kt + (4 * d4 + e) * kLdK;
          const float k0 = kr[lane];
          const float k1 = kr[lane + 32];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float qd = lane_of(qv[r], e);
            s[r][0] = fmaf(qd, k0, s[r][0]);
            s[r][1] = fmaf(qd, k1, s[r][1]);
          }
        }
      }
    }
    const bool in0 = lane < nk, in1 = lane + 32 < nk;
    const float b0 = (bb != nullptr && in0) ? bb[j0 + lane] : 0.f;
    const float b1 = (bb != nullptr && in1) ? bb[j0 + lane + 32] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float s0 = in0 ? s[r][0] + b0 : -INFINITY;
      const float s1 = in1 ? s[r][1] + b1 : -INFINITY;
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[r], mt);
      const float c = expf(m[r] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      m[r] = m_new;
      l[r] = l[r] * c + (p0 + p1);
#pragma unroll
      for (int t = 0; t < kWideNT; ++t) acc[r][t] *= c;
      pw[r * kTileK + lane] = p0;
      pw[r * kTileK + lane + 32] = p1;
    }
    __syncwarp();
    const float4* pw4 = reinterpret_cast<const float4*>(pw);
    for (int j4 = 0; j4 < (nk + 3) / 4; ++j4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pv[r] = pw4[r * (kTileK / 4) + j4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vs + (4 * j4 + e) * kWideChunk;
#pragma unroll
        for (int t = 0; t < kWideNT; ++t) {
          const float x = vr[lane + 32 * t];  // zero past the chunk's columns
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][t] = fmaf(lane_of(pv[r], e), x, acc[r][t]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float sum = l[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= L) continue;
    T* orow = out + ((b * L + row) * H + h) * (long long)D + c0;
#pragma unroll
    for (int t = 0; t < kWideNT; ++t) {
      const int d = lane + 32 * t;
      if (d < dc) orow[d] = from_float<T>(acc[r][t] / sum);
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int L, int S, int H, int D, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRowsPerBlock * kWideSlab + kWideSlab * kLdK +
                                       kTileK * kWideChunk + kWarps * kRowsPerWarp * kTileK);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (D + kWideChunk - 1) / kWideChunk;
  const long long tiles = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  if (tiles * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * chunks), H, B);
  flash_attention_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, chunks);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // query rows a block
constexpr float kLog2e = 1.4426950408889634f;

// keys a tile: 64, or 32 for heads wider than 128 (registers and shared
// memory grow with the head)
__host__ __device__ constexpr int key_tile(int dmax) { return dmax > 128 ? 32 : 64; }

// DMAX: the head width the registers are sized for (64, 128 or 256); the
// loops run over the D columns actually present, rounded up to 16.
template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                bf16* __restrict__ out, int L, int S, int H, int D,
                                long long q_bs, long long q_rs, long long k_bs,
                                long long k_rs, long long v_bs, long long v_rs, float scale,
                                int vec) {
  constexpr int KT = key_tile(DMAX);
  constexpr bool kQInRegs = DMAX <= 128;  // else q fragments are reread per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d16 = (D + 15) & ~15;
  const int ld = d16 + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTcRows][ld]
  bf16* ks = qs + kTcRows * ld;                  // [2][KT][ld]
  bf16* vs = ks + 2 * KT * ld;                   // [2][KT][ld]

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row0 = blockIdx.x * kTcRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nkd = d16 / 16;  // k16 steps over the head
  const int ntiles = (S + KT - 1) / KT;
  const bool live = row0 + warp * 16 < L;  // warp-uniform

  const bf16* qb = q + b * q_bs + row0 * q_rs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * v_bs + (long long)h * D;
  const float* bb = bias == nullptr ? nullptr : bias + b * S;

  d2r::zero_pad_columns(qs, ld, kTcRows + 4 * KT, D, d16, tid, kTcThreads);
  d2r::load_tile(qs, ld, qb, q_rs, kTcRows, L - row0, D, vec, tid, kTcThreads);
  d2r::load_tile(ks, ld, kb, k_rs, KT, S, D, vec, tid, kTcThreads);
  d2r::load_tile(vs, ld, vb, v_rs, KT, S, D, vec, tid, kTcThreads);
  d2r::cp_async_commit();

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};  // rows g and g + 8
  uint32_t qf[kQInRegs ? DMAX / 16 : 1][4];
  const bf16* qw = qs + (warp * 16 + lane % 16) * ld + (lane / 16) * 8;  // A operand rows

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * KT;
    if (t + 1 < ntiles) {
      const int next = (t + 1) & 1, jn = j0 + KT;
      d2r::load_tile(ks + next * KT * ld, ld, kb + jn * k_rs, k_rs, KT, S - jn, D, vec, tid,
                     kTcThreads);
      d2r::load_tile(vs + next * KT * ld, ld, vb + jn * v_rs, v_rs, KT, S - jn, D, vec, tid,
                     kTcThreads);
      d2r::cp_async_commit();
      d2r::cp_async_wait<1>();  // tile t (and q) landed, tile t + 1 in flight
    } else {
      d2r::cp_async_wait<0>();
    }
    __syncthreads();

    if (live) {
      const bf16* kt = ks + (t & 1) * KT * ld;
      const bf16* vt = vs + (t & 1) * KT * ld;
      const int nk = min(KT, S - j0);
      if (kQInRegs && t == 0) {
#pragma unroll
        for (int kk = 0; kk < (kQInRegs ? DMAX / 16 : 1); ++kk)
          if (kk < nkd) d2r::ldmatrix_x4(qf[kk], qw + kk * 16);
      }

      // scores: raw bf16 q . k, fp32 sums
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk >= nkd) break;
        uint32_t a[4];
        if (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kQInRegs ? kk : 0][e];
        } else {
          d2r::ldmatrix_x4(a, qw + kk * 16);
        }
        d2r::score_step<KT>(s, a, kt, ld, kk, nk, lane);
      }
      // scale in fp32 after the product, the key bias, keys past S to -inf
      d2r::scale_bias_mask<KT>(s, scale, bb == nullptr ? nullptr : bb + j0, nk, t4);

      // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[r], mt);
        const float c = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[n][e] = exp2f((s[n][e] - m_new) * kLog2e);  // exp(-inf) = 0 past S
            sum += s[n][e];
          }
        }
        l[r] = l[r] * c + sum;
#pragma unroll
        for (int n = 0; n < DMAX / 8; ++n) {
          acc[n][2 * r] *= c;
          acc[n][2 * r + 1] *= c;
        }
      }

      // p.V with p = hi + lo, both bf16, into one fp32 accumulator
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (kk * 16 >= nk) break;
        uint32_t p[2][4];  // hi, lo
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a0..a3: (row g, row g + 8) x (keys 0-7, 8-15)
          const float p0 = s[2 * kk + e / 2][2 * (e % 2)];
          const float p1 = s[2 * kk + e / 2][2 * (e % 2) + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
          p[0][e] = *reinterpret_cast<const uint32_t*>(&h2);
          p[1][e] = d2r::pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
        }
        d2r::pv_step<DMAX, 2>(acc, p, vt, ld, kk, nkd, lane);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row < L) d2r::store_row<DMAX>(out + ((b * L + row) * H + h) * (long long)D, acc, r, sum,
                                      D, t4);
  }
}

template <int DMAX>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int L, int S, int H, int D, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
                cudaStream_t stream) {
  const size_t ld = ((D + 15) & ~15) + 8;
  const size_t smem = sizeof(bf16) * (kTcRows + 4 * key_tile(DMAX)) * ld;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_attention_fwd_bf16_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = d2r::vec_ok(q, D, q_bs, q_rs) && d2r::vec_ok(k, D, k_bs, k_rs) &&
                  d2r::vec_ok(v, D, v_bs, v_rs);
  const dim3 grid((L + kTcRows - 1) / kTcRows, H, B);
  flash_attention_fwd_bf16_kernel<DMAX><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
      vec);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper: warpgroup MMA over TMA-loaded tiles ----
//
// The body for D = 64 where TMA can describe the views (16-byte aligned
// bases, row and batch strides that are multiples of 8 elements) and K and
// V fit in shared memory whole (S <= kWgMaxKeys). Every K3 site of
// D2R-large (L = S = 257, H = 16, D = 64, the strided views of the fused
// QKV projection) takes it.
//
// Work: a unit is one (b, h) and up to 2 T tiles of 64 query rows (T, the
// tiles a consumer warpgroup takes a unit, 1 or 2). The grid is one
// persistent block an SM walking the units; 384 threads:
//   - warps 0-7, two consumer warpgroups. Tile i of unit u is warpgroup
//     (i + u) % 2's;
//   - warp 8, the load warp: per unit, into the next stage of a ring of
//     one or two (two wherever they fit: every S up to 288 at T = 2), the
//     unit's q tiles, K and V whole, by TMA through 4-D tensor maps over
//     the strided (B, rows, H, D) views ({D, H, rows, B}, the views' own
//     strides, no copies; rows and keys past the edges zero-filled),
//     128-byte swizzled, one mbarrier for q and the bias and one for each
//     64-key block of K and of V, so that a unit's first products start
//     once its first blocks have landed; the next unit's loads run under
//     this one's products;
//   - warps 9-11, the ragged warps: with `ragged`, the rows past the last
//     full tile (at most kWgRaggedRows; the 257th row at the CLIP-L site)
//     on the CUDA cores, from the stage's K and V, while the warpgroups
//     run the unit's tiles. Without, a last tile on the tensor cores takes
//     them, its rows past L zero and its warps with no live row idle
//     through the softmax.
// A warpgroup's tile runs one burst of products a 64-key block and one
// after the last: burst j issues q.K_j^T (wgmma m64nNk16, both operands in
// shared memory, raw bf16 q, fp32 sums; the last, ragged block of keys a
// narrow N = its live keys rounded up to 16: 16 at S = 257) and p_{j-1}.V
// (p = hi + lo, both bf16, as wgmma's register A operand, from the
// registers that held the scores; V the B operand read transposed by the
// descriptor's MN-major swizzle; into one fp32 accumulator), waits for
// both, and runs the softmax of block j (scale in fp32, bias, keys past S
// at -inf, the online max from m = -1e30, exp, the row sums), the
// accumulator's rescale and the hi/lo split of block j. The arithmetic and
// its order are the mma.sync body's. One warpgroup's softmax and split run
// beside the other's products. The output is acc / l, cast once, staged
// in the tile's q slot and stored by TMA (rows past L are not written).

using d2r::desc_b128;
using d2r::fence_async_smem;
using d2r::fence_regs;
using d2r::mbar_arrive;
using d2r::mbar_expect;
using d2r::mbar_init;
using d2r::mbar_wait;

constexpr int kWgDim = 64;           // the head width the body takes
constexpr int kWgRows = 64;          // query rows a tile (wgmma's M)
constexpr int kWgTileBytes = kWgRows * kWgDim * 2;
constexpr int kWgBox = 16;           // key rows a TMA box of K and V
constexpr int kWgRaggedRows = 4;     // most rows the ragged warps take
constexpr int kWgMaxKeys = 640;      // K and V whole in one stage at T = 2
constexpr int kWgMaxSmem = 232448;   // a block's shared memory on the H100
constexpr int kWgThreads = 384;      // 2 consumer warpgroups, the load warp, 3 ragged warps
constexpr int kWgRaggedThreads = 96;
constexpr int kWgEmptyCount = 256 + kWgRaggedThreads;  // a stage's release: each reader
// registers a thread after the split (setmaxnreg): 384 x 168 at launch
// becomes 256 x 216 + 128 x 72; at 168 ptxas serializes the wgmma
// pipeline (too few registers to keep the products in flight)
constexpr int kWgRegsConsumer = 216, kWgRegsLoad = 72;
// named barriers (0 is __syncthreads): 1 + w warpgroup w alone, 3 the
// ragged warps
constexpr int kBarWg = 1, kBarRagged = 3;

// wgmma m64nNk16, bf16 in, fp32 into d[0 .. N / 2) (accumulated when acc
// != 0): A (64 x 16) and B (16 x N) both K-major in shared memory, by
// descriptor.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n48(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// wgmma m64n64k16 accumulated into d: A from four registers a thread (the
// mma.sync m16n8k16 A fragment of the thread's warp), B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_tb_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// an MN-major 128-byte swizzle descriptor (B read transposed): rows of 64
// elements (128 bytes), 8 rows 1,024 bytes apart (SBO), LBO unused at N = 64
__device__ __forceinline__ uint64_t desc_b128_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// the (c0 innermost .. c3) box of `map` into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(d2r::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(d2r::smem_addr(bar))
      : "memory");
}

// the box of `map` at (c0 .. c3) from shared memory, as one bulk group;
// what lies past the tensor's edges is not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, int c0, int c1, int c2,
                                             int c3, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(d2r::smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

#ifdef D2R_K3_PROBE
// k3_sweep.py --probe: clock64 at points of each block's first unit. Slots
// 32 w + ...: warpgroup w's first thread, 0 the block's start, 1 the unit's
// q landed, 2 + 4 j + {0, 2, 3} for burst j (j < 6): K and V landed, the
// products landed, the softmax and split done; 27 the first
// tile's store issued. 28 the load warp's last load of the unit issued;
// 60 and 61 the ragged warps' first row started and last row stored, 29,
// 30, 31 its scores, block softmax and p.V done.
__device__ long long g_k3_probe[1024 * 64];
#define K3_MARK(pr, k)                        \
  do {                                        \
    if ((pr) != nullptr) (pr)[k] = clock64(); \
  } while (0)
#else
#define K3_MARK(pr, k) \
  do {                 \
  } while (0)
#endif

// bf16 bits to float: the low or the high half of a word
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// A block's shared memory, from a 1,024-aligned start (the swizzle is a
// function of address bits 4-9): `stages` stages of (the unit's q tiles,
// K and V as s_alloc rows of 128 bytes, the bias of the s_alloc keys);
// the ragged warps' scratch (q row, scores, p hi and lo, a 64-key block's
// p.V and its correction factor, the row sum); the barriers, a stage's
// full, empty, K blocks', V blocks'.
struct WgLayout {
  int s_alloc, nblk, tiles, stages;
  __host__ __device__ int kv() const { return s_alloc * 128; }
  __host__ __device__ int k_off() const { return tiles * kWgTileBytes; }
  __host__ __device__ int v_off() const { return k_off() + kv(); }
  __host__ __device__ int bias_off() const { return v_off() + kv(); }
  __host__ __device__ int stage() const { return (bias_off() + 4 * s_alloc + 1023) & ~1023; }
  __host__ __device__ int ragged_off() const { return stages * stage(); }
  __host__ __device__ int ragged_floats() const {
    return 64 + 3 * 64 * nblk + (kWgRaggedThreads / 32) * 64 * nblk + nblk + 4;
  }
  __host__ __device__ int bar_off() const {
    return (ragged_off() + 4 * ragged_floats() + 15) & ~15;
  }
  __host__ __device__ int bars() const { return 2 + 2 * nblk; }
  __host__ __device__ int bytes() const { return 1024 + bar_off() + 8 * stages * bars(); }
};

// 2^x, flushing results below 2^-126 to 0 (exp2f's denormal steps cost
// three instructions an element; such a p or correction factor is far
// below what any fp32 sum it enters can hold beside the row's largest
// term, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The scores of a block of N keys at j0 (in s, rows r0 and r0 + 8 of the
// thread): scale, bias, and with MASK (the last block) keys past S at
// -inf; the online max and sum of rows r0 (r = 0) and r0 + 8 (r = 1); s
// becomes p; c the rows' correction factors for the accumulator.
template <int N, bool MASK>
__device__ __forceinline__ void wg_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                           float (&c)[2], const float* bs, int j0, int S,
                                           float scale, int t4) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const float2 b2 = *reinterpret_cast<const float2*>(bs + j0 + n * 8 + 2 * t4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bj = e == 0 ? b2.x : b2.y;
      const bool in = !MASK || j0 + n * 8 + 2 * t4 + e < S;
      s[4 * n + e] = in ? s[4 * n + e] * scale + bj : -INFINITY;
      s[4 * n + 2 + e] = in ? s[4 * n + 2 + e] * scale + bj : -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) mt = fmaxf(mt, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt);
    c[r] = ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * n + e] = ex2((s[4 * n + e] - m_new) * kLog2e);  // exp(-inf) = 0 past S
        sum += s[4 * n + e];
      }
    }
    l[r] = l[r] * c[r] + sum;
  }
}

// p = hi + lo, both bf16, as the A operand of each k16 step of N keys:
// a0..a3 are (row r0, row r0 + 8) x (keys 0-7, 8-15) of the step
template <int N>
__device__ __forceinline__ void wg_split(const float (&s)[32], uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p0 = s[4 * (2 * kk + e / 2) + 2 * (e % 2)];
      const float p1 = s[4 * (2 * kk + e / 2) + 2 * (e % 2) + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      ph[kk][e] = *reinterpret_cast<const uint32_t*>(&h2);
      pl[kk][e] = d2r::pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
    }
  }
}

template <int N>
__device__ __forceinline__ void wg_scores(float (&s)[32], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < kWgDim / 16; ++kk) {
    const uint64_t da = desc_b128(qa + kk * 32), db = desc_b128(kb + kk * 32);
    if constexpr (N == 16) wgmma_ss_n16(s, da, db, kk);
    else if constexpr (N == 32) wgmma_ss_n32(s, da, db, kk);
    else if constexpr (N == 48) wgmma_ss_n48(s, da, db, kk);
    else wgmma_ss_n64(s, da, db, kk);
  }
}

// A warpgroup's tile in flight: its accumulator, the online max and sum of
// the thread's rows r0 and r0 + 8, and p of the last block as wgmma's A
// operand (hi, lo).
struct WgAcc {
  float o[32], s[32], m[2], l[2];
  uint32_t ph[4][4], pl[4][4];
};

__device__ __forceinline__ void wg_fence_operands(WgAcc& a) {
  fence_regs(a.o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(a.ph[kk]);
    fence_regs(a.pl[kk]);
  }
}

// Burst j of a tile: q.K_j^T for a block of NQ keys (none at NQ = 0) and
// p_{j-1}.V for the previous block of NP keys (none at NP = 0), issued
// together; then the softmax of block j (masked when LAST), the rescale of
// the accumulator and the split of block j's p. Straight-line code for
// each (NQ, NP), no wgmma under a runtime condition.
template <int NQ, int NP, bool LAST>
__device__ __forceinline__ void wg_burst(WgAcc& a, uint32_t qa, uint32_t ka, uint32_t va,
                                         const float* bs, uint64_t* kbar, uint64_t* vbar,
                                         int phase, int j, int S, float scale, bool live,
                                         int t4, long long* pr) {
  const int j0 = 64 * j;
  if (NQ > 0) mbar_wait(kbar + j, phase);
  if (NP > 0) mbar_wait(vbar + j - 1, phase);
  long long* bp = (pr != nullptr && j < 6) ? pr + 2 + 4 * j : nullptr;
  K3_MARK(bp, 0);
  wg_fence_operands(a);
  fence_regs(a.s);
  wgmma_fence();
  if constexpr (NQ > 0) {
    wg_scores<NQ>(a.s, qa, ka + j0 * 128);
    wgmma_commit();
  }
  if constexpr (NP > 0) {
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint64_t dv = desc_b128_mn(va + (j0 - 64 + 16 * kk) * 128);
      wgmma_rs_tb_n64(a.o, a.ph[kk], dv);
      wgmma_rs_tb_n64(a.o, a.pl[kk], dv);
    }
    wgmma_commit();
  }
  // both groups land before the softmax: ptxas serializes this kernel's
  // wgmma ("insufficient register resources") with p.V in flight under
  // the softmax or not, so a warpgroup overlaps none of its own products
  wgmma_wait<0>();
  fence_regs(a.s);
  wg_fence_operands(a);
  K3_MARK(bp, 2);
  if constexpr (NQ > 0) {
    if (live) {
      float c[2];
      wg_softmax<NQ, LAST>(a.s, a.m, a.l, c, bs, j0, S, scale, t4);
#pragma unroll
      for (int n = 0; n < kWgDim / 8; ++n) {
        a.o[4 * n] *= c[0];
        a.o[4 * n + 1] *= c[0];
        a.o[4 * n + 2] *= c[1];
        a.o[4 * n + 3] *= c[1];
      }
      wg_split<NQ>(a.s, a.ph, a.pl);
    }
  }
  K3_MARK(bp, 3);
}

// One tile of 64 query rows at row0 (q in the stage's slot qslot) over the
// unit's K (ka), V (va) and bias (bs), nblk blocks of keys of which the
// last is NL wide: its bursts, then acc / l, cast once, staged in the q
// slot and stored by TMA by the warpgroup's first thread.
template <int NL>
__device__ __forceinline__ void wg_tile(unsigned char* qslot, uint32_t ka, uint32_t va,
                                        const float* bs, uint64_t* kbar, uint64_t* vbar,
                                        int phase, int nblk, int S, int L, int row0, int b,
                                        int h, float scale, int w, int wt,
                                        const CUtensorMap* o_map, long long* pr) {
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int r0 = 16 * (wt / 32) + lane / 4;     // the thread's rows r0, r0 + 8 of the tile
  const bool live = row0 + 16 * (wt / 32) < L;  // warp-uniform
  const uint32_t qa = d2r::smem_addr(qslot);
  WgAcc a;
  a.m[0] = a.m[1] = kNegInit;
  a.l[0] = a.l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) a.o[i] = a.s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a.ph[kk][e] = a.pl[kk][e] = 0u;
#define K3_BURST(NQ, NP, LAST, j)                                                          \
  wg_burst<NQ, NP, LAST>(a, qa, ka, va, bs, kbar, vbar, phase, j, S, scale, live, t4, pr)
  if (nblk == 1) {
    K3_BURST(NL, 0, true, 0);
  } else {
    K3_BURST(64, 0, false, 0);
    for (int j = 1; j < nblk - 1; ++j) K3_BURST(64, 64, false, j);
    K3_BURST(NL, 64, true, nblk - 1);
  }
  K3_BURST(0, NL, false, nblk);
#undef K3_BURST
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = a.l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = r0 + 8 * r;
      unsigned char* orow = qslot + row * 128 + 4 * t4;
#pragma unroll
      for (int n = 0; n < kWgDim / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + ((n ^ (row % 8)) << 4)) =
            __floats2bfloat162_rn(a.o[4 * n + 2 * r] / sum, a.o[4 * n + 2 * r + 1] / sum);
    }
  }
  fence_async_smem();
  bar_sync(kBarWg + w, 128);
  if (wt == 0) tma_store_4d(o_map, 0, h, row0, b, qslot);
  K3_MARK(pr, 27);
}

// The rows [row_begin, L) of (b, h) on the CUDA cores by the 96 ragged
// threads (t), one row at a time, with the warpgroups' arithmetic: the
// scores of all keys (thread t: keys t, t + 96, ...), then per 64-key
// block the online max, correction factor, p = exp and its hi/lo split,
// and row sum (one warp), then each block's p.V (thread t: head columns
// 2 (t % 32) and + 1, keys t / 32, + 3, ... of every block), combined as
// the online softmax combines them: acc = acc * c_j + (p.V)_j.
__device__ void wg_ragged_rows(const bf16* __restrict__ q, long long q_bs, long long q_rs,
                               int row_begin, int L, int S, int H, int b, int h, float scale,
                               const unsigned char* ks, const unsigned char* vs, const float* bs,
                               float* scratch, int nblk, bf16* __restrict__ out, int t,
                               long long* pr) {
  constexpr int kPhases = kWgRaggedThreads / 32;
  float* qrow = scratch;                                          // [64]
  float* sb = qrow + 64;                                          // [64 nblk] scores
  float2* phl = reinterpret_cast<float2*>(sb + 64 * nblk);        // [64 nblk] p (hi, lo)
  float* part = sb + 3 * 64 * nblk;                               // [nblk][kPhases][64]
  float* cb = part + kPhases * 64 * nblk;                         // [nblk] factors, then l
  const int lane = t % 32, phase = t / 32;
  for (int row = row_begin; row < L; ++row) {
    if (row == row_begin) K3_MARK(pr, 60);
    if (t < kWgDim)
      qrow[t] = __bfloat162float(q[(long long)b * q_bs + (long long)row * q_rs +
                                   (long long)h * kWgDim + t]);
    bar_sync(kBarRagged, kWgRaggedThreads);
    for (int key = t; key < S; key += kWgRaggedThreads) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const uint4 kv = *reinterpret_cast<const uint4*>(ks + key * 128 + ((cc ^ (key % 8)) << 4));
        const uint32_t wd[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = fmaf(qrow[8 * cc + 2 * e], lo_bf16(wd[e]), x[e]);
          x[e] = fmaf(qrow[8 * cc + 2 * e + 1], hi_bf16(wd[e]), x[e]);
        }
      }
      sb[key] = ((x[0] + x[1]) + (x[2] + x[3])) * scale + bs[key];
    }
    bar_sync(kBarRagged, kWgRaggedThreads);
    if (row == row_begin) K3_MARK(pr, 29);
    if (t < 32) {
      float m = kNegInit, l = 0.f;
      for (int j = 0; j < nblk; ++j) {
        const int k0 = 64 * j + lane, k1 = k0 + 32;
        const float s0 = k0 < S ? sb[k0] : -INFINITY, s1 = k1 < S ? sb[k1] : -INFINITY;
        float mt = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m, mt);
        const float c = ex2((m - m_new) * kLog2e);
        const float p0 = ex2((s0 - m_new) * kLog2e), p1 = ex2((s1 - m_new) * kLog2e);
        m = m_new;
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l = l * c + sum;
        const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
        phl[k0] = make_float2(h0, __bfloat162float(__float2bfloat16_rn(p0 - h0)));
        phl[k1] = make_float2(h1, __bfloat162float(__float2bfloat16_rn(p1 - h1)));
        if (lane == 0) cb[j] = c;
      }
      if (lane == 0) cb[nblk] = l;
    }
    bar_sync(kBarRagged, kWgRaggedThreads);
    if (row == row_begin) K3_MARK(pr, 30);
    for (int j = 0; j < nblk; ++j) {
      const int nk = min(64, S - 64 * j);
      // two chains of the two columns, alternate keys of the phase
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
      auto step = [&](int key, float& c0, float& c1) {
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(
            vs + key * 128 + (((lane / 4) ^ (key % 8)) << 4) + (lane % 4) * 4);
        const float v0 = lo_bf16(wv), v1 = hi_bf16(wv);
        const float2 p = phl[key];
        c0 = fmaf(p.x, v0, c0);
        c0 = fmaf(p.y, v0, c0);
        c1 = fmaf(p.x, v1, c1);
        c1 = fmaf(p.y, v1, c1);
      };
#pragma unroll 2
      for (int jj = phase; jj < nk; jj += 2 * kPhases) {
        step(64 * j + jj, a0, a1);
        if (jj + kPhases < nk) step(64 * j + jj + kPhases, b0, b1);
      }
      part[(kPhases * j + phase) * 64 + 2 * lane] = a0 + b0;
      part[(kPhases * j + phase) * 64 + 2 * lane + 1] = a1 + b1;
    }
    bar_sync(kBarRagged, kWgRaggedThreads);
    if (row == row_begin) K3_MARK(pr, 31);
    if (t < 32) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < nblk; ++j) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int f = 0; f < kPhases; ++f) {
          p0 += part[(kPhases * j + f) * 64 + 2 * lane];
          p1 += part[(kPhases * j + f) * 64 + 2 * lane + 1];
        }
        a0 = a0 * cb[j] + p0;
        a1 = a1 * cb[j] + p1;
      }
      const float l = cb[nblk];
      *reinterpret_cast<__nv_bfloat162*>(out + (((long long)b * L + row) * H + h) * kWgDim +
                                         2 * lane) = __floats2bfloat162_rn(a0 / l, a1 / l);
    }
    bar_sync(kBarRagged, kWgRaggedThreads);  // the scratch is rewritten by the next row
  }
  K3_MARK(pr, 61);
}

// units: (b, h, group) with `groups` groups of up to 2 tpw tiles an item;
// `tiles` tiles of 64 rows an item; rows from ragged_begin (< L with the
// ragged warps) are theirs.
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const __grid_constant__ CUtensorMap o_map,
                                     const bf16* __restrict__ q, const float* __restrict__ bias,
                                     bf16* __restrict__ out, int L, int S, int H, long long q_bs,
                                     long long q_rs, float scale, int units, int groups,
                                     int tiles, int tpw, int stages, int ragged_begin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = d2r::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int s_alloc = (S + 15) & ~15;
  const WgLayout lay{s_alloc, (s_alloc + 63) / 64, 2 * tpw, stages};
  const int nblk = lay.nblk;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off());
  // stage st's barriers: full, empty, K blocks, V blocks
  auto full = [&](int st) { return bars + st * lay.bars(); };
  auto empty = [&](int st) { return bars + st * lay.bars() + 1; };
  auto kbar = [&](int st) { return bars + st * lay.bars() + 2; };
  auto vbar = [&](int st) { return bars + st * lay.bars() + 2 + nblk; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  long long* pr = nullptr;  // this thread's probe slots, where it has them
#ifdef D2R_K3_PROBE
  if (blockIdx.x < 1024 && lane == 0 && (warp == 0 || warp == 4))
    pr = g_k3_probe + blockIdx.x * 64 + 32 * (warp / 4);
  if (blockIdx.x < 1024 && (tid == 8 * 32 || tid == 9 * 32)) pr = g_k3_probe + blockIdx.x * 64;
#endif
  K3_MARK(warp < 8 ? pr : nullptr, 0);

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 32);  // the load warp's lanes (the bias), one with q's bytes
      mbar_init(empty(st), kWgEmptyCount);
      for (int j = 0; j < nblk; ++j) {
        mbar_init(kbar(st) + j, 1);
        mbar_init(vbar(st) + j, 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the roles never meet again (the register split holds only so): the
  // load and ragged warps' warpgroup gives registers to the consumers
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgRegsLoad) : "memory");
    if (warp == 8) {  // the load warp
      if (lane == 0) {
        const CUtensorMap* maps[4] = {&q_map, &k_map, &v_map, &o_map};
  #pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i]))
                       : "memory");
      }
      int n = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        const int st = n % stages;
        if (n >= stages) mbar_wait(empty(st), (n / stages + 1) & 1);
        const int item = u / groups, g = u % groups;
        const int b = item / H, h = item % H;
        const int t0 = g * lay.tiles, ntq = min(lay.tiles, tiles - t0);
        unsigned char* stage = smem + st * lay.stage();
        float* bs = reinterpret_cast<float*>(stage + lay.bias_off());
        for (int j = lane; j < s_alloc; j += 32)
          bs[j] = (bias != nullptr && j < S) ? bias[(long long)b * S + j] : 0.f;
        // the warp stays converged: lanes left spinning on the next
        // unit's barrier would hold back lane 0's loads
        if (lane != 0) {
          mbar_arrive(full(st));
          __syncwarp();
          continue;
        }
        mbar_expect(full(st), ntq * kWgTileBytes);
        for (int i = 0; i < ntq; ++i)
          tma_load_4d(stage + i * kWgTileBytes, &q_map, 0, h, (t0 + i) * kWgRows, b, full(st));
        for (int j = 0; j < nblk; ++j) {
          const int rows = min(64, s_alloc - 64 * j);
          mbar_expect(kbar(st) + j, rows * 128);
          for (int r = 0; r < rows; r += kWgBox)
            tma_load_4d(stage + lay.k_off() + (64 * j + r) * 128, &k_map, 0, h, 64 * j + r, b,
                        kbar(st) + j);
          mbar_expect(vbar(st) + j, rows * 128);
          for (int r = 0; r < rows; r += kWgBox)
            tma_load_4d(stage + lay.v_off() + (64 * j + r) * 128, &v_map, 0, h, 64 * j + r, b,
                        vbar(st) + j);
        }
        if (n == 0) K3_MARK(pr, 28);
        __syncwarp();
      }
    } else {  // the ragged warps
      const int t = tid - 9 * 32;
      int n = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        const int st = n % stages, phase = (n / stages) & 1;
        mbar_wait(full(st), phase);
        if (ragged_begin < L && u % groups == groups - 1) {
          const int item = u / groups, b = item / H, h = item % H;
          for (int j = 0; j < nblk; ++j) {
            mbar_wait(kbar(st) + j, phase);
            mbar_wait(vbar(st) + j, phase);
          }
          const unsigned char* stage = smem + st * lay.stage();
          const float* bs = reinterpret_cast<const float*>(stage + lay.bias_off());
          wg_ragged_rows(q, q_bs, q_rs, ragged_begin, L, S, H, b, h, scale, stage + lay.k_off(),
                         stage + lay.v_off(), bs, reinterpret_cast<float*>(smem + lay.ragged_off()),
                         nblk, out, t, n == 0 ? pr : nullptr);
        }
        mbar_arrive(empty(st));
      }
    }
  } else {  // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgRegsConsumer) : "memory");
    const int w = warp / 4, wt = tid % 128;
    int n = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const int st = n % stages, phase = (n / stages) & 1;
      const int item = u / groups, g = u % groups;
      const int b = item / H, h = item % H;
      const int t0 = g * lay.tiles, ntq = min(lay.tiles, tiles - t0);
      const int first = (w + u) & 1;  // this warpgroup's tiles: first, first + 2, ...
      const int mine = (ntq - first + 1) / 2;
      unsigned char* stage = smem + st * lay.stage();
      mbar_wait(full(st), phase);
      K3_MARK(n == 0 ? pr : nullptr, 1);
      const int last = s_alloc - 64 * (nblk - 1);  // the last block's keys: 16, 32, 48 or 64
      for (int i = 0; i < mine; ++i) {
        const int tile = first + 2 * i;
        unsigned char* qslot = stage + tile * kWgTileBytes;
        const uint32_t ka = d2r::smem_addr(stage + lay.k_off());
        const uint32_t va = d2r::smem_addr(stage + lay.v_off());
        const float* bs = reinterpret_cast<const float*>(stage + lay.bias_off());
        const int row0 = (t0 + tile) * kWgRows;
        long long* tp = (n == 0 && i == 0) ? pr : nullptr;
        if (last == 64)
          wg_tile<64>(qslot, ka, va, bs, kbar(st), vbar(st), phase, nblk, S, L, row0, b, h, scale,
                      w, wt, &o_map, tp);
        else if (last == 48)
          wg_tile<48>(qslot, ka, va, bs, kbar(st), vbar(st), phase, nblk, S, L, row0, b, h, scale,
                      w, wt, &o_map, tp);
        else if (last == 32)
          wg_tile<32>(qslot, ka, va, bs, kbar(st), vbar(st), phase, nblk, S, L, row0, b, h, scale,
                      w, wt, &o_map, tp);
        else
          wg_tile<16>(qslot, ka, va, bs, kbar(st), vbar(st), phase, nblk, S, L, row0, b, h, scale,
                      w, wt, &o_map, tp);
      }
      // the stores read their q slots before the stage is refilled
      if (wt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(empty(st));
    }
    if (wt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// A 4-D tensor map over the strided (B, rows, H, 64) bf16 view at base:
// dims {64, H, rows, B}, strides {64, rs, bs} elements, boxes of the 64
// head columns by box_rows rows, 128-byte swizzled, zeros past the edges.
int wg_tensor_map(CUtensorMap* map, const void* base, int H, int rows, int B, long long rs,
                  long long bs, int box_rows) {
  const d2r::EncodeTiled encode = d2r::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kWgDim, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kWgDim * 2, (cuuint64_t)rs * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {kWgDim, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Whether TMA can describe a (B, rows, H, D) view for the wgmma body: a
// 16-byte aligned base, and row and batch strides that are positive
// multiples of 8 elements where their axis has more than one index.
bool wg_view_ok(const void* p, int B, int rows, long long bs, long long rs) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (rows == 1 || (rs > 0 && rs % 8 == 0)) &&
         (B == 1 || (bs > 0 && bs % 8 == 0));
}

// The wgmma body's variant: 0 picks by shape (kWgAuto); 1 + v for v in
// 0-3 forces tiles a warpgroup 1 + (v >> 1) and the ragged warps (v & 1),
// for timing one against another.
constexpr int kWgAuto = 0;

int launch_wgmma(int variant, const void* q, const void* k, const void* v, const float* bias,
                 void* out, int B, int L, int S, int H, long long q_bs, long long q_rs,
                 long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale,
                 cudaStream_t stream) {
  if (S > kWgMaxKeys || variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static int sms[32] = {0};
  int nsm = dev < 32 ? sms[dev] : 0;
  if (nsm == 0) {
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_attention_fwd_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWgMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) sms[dev] = nsm;
  }
  const bool can_rag = L >= kWgRows && L % kWgRows != 0 && L % kWgRows <= kWgRaggedRows;
  const long long items = (long long)B * H;
  int tpw, ragged;
  if (variant == kWgAuto) {
    // two tiles a warpgroup once the units so made fill half the card (B 8
    // at the CLIP-L site: 128 units of four tiles beat 256 of two); the
    // ragged warps only then, as their rows outlast a unit of one tile a
    // warpgroup (B 1: a last tile on the tensor cores runs 25% faster)
    tpw = 2 * items * ((L / kWgRows + 3) / 4) >= nsm ? 2 : 1;
    ragged = can_rag && tpw == 2;
  } else {
    tpw = 1 + ((variant - 1) >> 1);
    ragged = (variant - 1) & 1;
    if (ragged && !can_rag) return (int)cudaErrorInvalidValue;
  }
  const int tiles = ragged ? L / kWgRows : (L + kWgRows - 1) / kWgRows;
  const int groups = (tiles + 2 * tpw - 1) / (2 * tpw);
  const long long units = items * groups;
  const int s_alloc = (S + 15) & ~15;
  WgLayout lay{s_alloc, (s_alloc + 63) / 64, 2 * tpw, 2};
  if (lay.bytes() > kWgMaxSmem) lay.stages = 1;
  if (lay.bytes() > kWgMaxSmem || units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // an axis of one index: any stride TMA takes (no coordinate reaches it)
  const long long hd = (long long)H * kWgDim;
  if (L == 1) q_rs = hd;
  if (S == 1) k_rs = v_rs = hd;
  if (B == 1) {
    q_bs = L * q_rs;
    k_bs = S * k_rs;
    v_bs = S * v_rs;
  }
  CUtensorMap q_map, k_map, v_map, o_map;
  int err = wg_tensor_map(&q_map, q, H, L, B, q_rs, q_bs, kWgRows);
  if (err == 0) err = wg_tensor_map(&k_map, k, H, S, B, k_rs, k_bs, kWgBox);
  if (err == 0) err = wg_tensor_map(&v_map, v, H, S, B, v_rs, v_bs, kWgBox);
  if (err == 0) err = wg_tensor_map(&o_map, out, H, L, B, hd, L * hd, kWgRows);
  if (err != 0) return err;
  const int grid = (int)(units < nsm ? units : nsm);
  flash_attention_fwd_wgmma_kernel<<<grid, kWgThreads, lay.bytes(), stream>>>(
      q_map, k_map, v_map, o_map, static_cast<const bf16*>(q), bias, static_cast<bf16*>(out), L,
      S, H, q_bs, q_rs, scale, (int)units, groups, tiles, tpw, lay.stages,
      ragged ? tiles * kWgRows : L);
  return (int)cudaGetLastError();
}

}  // namespace

// The bodies, by the wrapper's code (flash_attention.py BODIES): 0 the
// bf16 mma.sync body (D <= 256), 1 the fp32 body (D <= 256), 2 the wide
// body (any D, fp32 and bf16), 3 the bf16 wgmma body (D = 64, views TMA
// can describe, S <= kWgMaxKeys); 4-7 the wgmma body's variants 1-4
// (launch_wgmma), for timing. A body the shape or type cannot take
// returns cudaErrorInvalidValue; none gives way to another.
// dtype: 0 = float32, 1 = bfloat16. bias may be null (no key bias).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int d2r_flash_attention_fwd(int dtype, int body, const void* q, const void* k,
                                       const void* v, const void* bias, void* out,
                                       int B, int L, int S, int H, int D,
                                       long long q_bs, long long q_rs,
                                       long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, float scale,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || D < 1 || B > 65535 || H > 65535 || body < 0 ||
      body > 7 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 2)
    return dtype == 0 ? launch_wide<float>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs,
                                           k_rs, v_bs, v_rs, scale, st)
                      : launch_wide<bf16>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs,
                                          k_rs, v_bs, v_rs, scale, st);
  if (D > kMaxDim || (body == 1) != (dtype == 0)) return (int)cudaErrorInvalidValue;
  if (body == 1)
    return launch<float>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                         v_rs, scale, st);
  if (body == 0) {
    if (D <= 64)
      return launch_bf16<64>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                             v_rs, scale, st);
    if (D <= 128)
      return launch_bf16<128>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                              v_rs, scale, st);
    return launch_bf16<256>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                            v_rs, scale, st);
  }
  // the wgmma body
  if (D != kWgDim || !wg_view_ok(q, B, L, q_bs, q_rs) || !wg_view_ok(k, B, S, k_bs, k_rs) ||
      !wg_view_ok(v, B, S, v_bs, v_rs))
    return (int)cudaErrorInvalidValue;
  return launch_wgmma(body - 3, q, k, v, bp, out, B, L, S, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                      scale, st);
}

#ifdef D2R_K3_PROBE
// the probe's clocks (k3_sweep.py --probe), n values from the start
extern "C" int d2r_k3_probe(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_k3_probe, (size_t)n * sizeof(long long));
}

// the probe's slots set to 0 (before a launch whose marks are read)
extern "C" int d2r_k3_probe_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_k3_probe);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(g_k3_probe));
}
#endif
