// Long-context attention, forward (K3), for Hopper (sm_90a): a bf16 kernel
// on the tensor cores and an fp32 kernel on the CUDA cores.
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
// bf16: tensor cores (flash_attention_fwd_bf16_kernel). Grid (ceil(L/64),
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
// shared with K1; the online softmax and the hi/lo split are this kernel's. A warp whose 16 rows all lie past
// L still helps load tiles but does no products, so the 257th row costs one
// warp, not a block. Why mma.sync and not wgmma: the block is 4 warps of
// 16 rows, each warp's softmax owns its rows, and at 86 operations a byte
// the kernel is bound by bytes; warp-level mma clears the ~13 GFLOP of the
// CLIP-L site (the hi/lo split included) inside the bytes bound, so the
// warpgroup/TMA design is the step after, if the kernel stays above twice
// its bound. Shared memory: 45 KiB at D = 64 (four blocks an SM), 85 KiB
// at D = 128, 99 KiB at D = 256.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias may be null (no key bias).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int d2r_flash_attention_fwd(int dtype, const void* q, const void* k,
                                       const void* v, const void* bias, void* out,
                                       int B, int L, int S, int H, int D,
                                       long long q_bs, long long q_rs,
                                       long long k_bs, long long k_rs,
                                       long long v_bs, long long v_rs, float scale,
                                       void* stream) {
  if (B < 1 || L < 1 || S < 1 || H < 1 || D < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kMaxDim && dtype == 0)
    return launch_wide<float>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                              v_rs, scale, st);
  if (D > kMaxDim && dtype == 1)
    return launch_wide<bf16>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                             v_rs, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                         v_rs, scale, st);
  if (dtype == 1) {
    if (D <= 64)
      return launch_bf16<64>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                             v_rs, scale, st);
    if (D <= 128)
      return launch_bf16<128>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                              v_rs, scale, st);
    return launch_bf16<256>(q, k, v, bp, out, B, L, S, H, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                            v_rs, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
