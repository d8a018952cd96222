// W8A16 product of weight-only int8 serving, for Hopper (sm_90a).
//
// y[m, n] = sum_k x[m, k] * w[n, k] (+ bias[n]), rounded once to the compute
// type, where w[n, k] = q[n, k] * s[n % period] is the dequantized weight of
// an int8 module (quant.py): int8 codes q (N, K) row-major, fp32 scales s
// with one value a group of output rows (period = N for a Linear and a
// patch conv, the hidden width for a fused QKV, whose rows q, k and v share
// one scale a hidden unit). x is (M, K) with a row stride, in fp32 or bf16.
//
// Each weight element is dequantized on chip to exactly the value the plain
// path builds, quant.py's Int8Weight.weight and the JAX package's
// QuantLeaf.dequant: in bf16 bf16(bf16(q) * bf16(s)) (q and bf16(s) are
// exact in fp32 and their product fits its mantissa, so the one rounding is
// the bf16 multiply's), in fp32 fp32(q * s). No dequantized weight is ever
// written to device memory: the int8 codes are the only weight bytes read.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA,
// which fuses the dequantize into the consuming dot
// (d2r_tpu/quant.py:37,91). The port has to write that fusion by hand.
//
// What bounds it on the H100: at serving bucket 1 (M = 49-64 rows) the
// latency of a block's setup, first loads and epilogue (D2R-base's FFN
// weight is 2.4 MB of codes, 0.7 us at 3.35 TB/s); at buckets 8 and 32 (M
// up to 2,048) the bf16 tensor cores (2 M N K operations at 989 TFLOP/s)
// and the dequantize, which a warpgroup runs between its own products: a
// warpgroup's register-sourced wgmma do not overlap its own conversion of
// the next step, so a tile's step costs the products plus the conversion
// unless another warpgroup's products fill the gap. The bodies:
// - bf16 above 4 rows: warpgroup MMA with the weight as its register
//   operand ("swap AB"): y^T = W x^T, features as wgmma's M, tokens as its
//   N, so the dequantized weight never touches shared memory. A tile is 64
//   output features by NT = 64, 128 or 256 tokens. One producer warp (a
//   producer warpgroup that hands its registers to the consumer with
//   setmaxnreg at NT = 256, 128 accumulators a consumer thread) streams x's
//   tile (the 128-byte swizzled K-major layout wgmma reads as B) and the
//   codes (64-byte swizzled rows) into a ring of stages by TMA, a full and
//   an empty mbarrier a stage. A consumer thread reads each 16-byte chunk
//   of its two code rows with one shared load (the four threads of a quad
//   read the same chunk, a broadcast), picks its two code pairs with one
//   byte permute each, dequantizes them with integer masks and two bf16x2
//   operations (no float conversion), and issues wgmma m64nNk16 from those
//   registers while its previous step's products run (wgmma.wait_group 1).
//   To take the dequantize off the tensor cores' critical path, the
//   64-token body runs two consumer warpgroups on alternate k-steps of one
//   tile (k-groups): while one converts its step, the other's products run,
//   and their fp32 sums meet through shared memory at the end in k-group
//   order; the 64- and 128-token bodies also run two blocks an SM, whose
//   products interleave the same way. The grid is persistent: gridDim.x
//   blocks (the wrapper's count, at most the SMs times the blocks an SM
//   holds) walk the tiles blockIdx.x, + gridDim.x, ... feature tile fastest,
//   an order fixed by the shape and the grid; the producer loads the next
//   tile's first stages while the consumers run the current tile's
//   epilogue. The finished tile, plus the bias in fp32, is rounded once,
//   transposed by stmatrix into a staging area (128-byte swizzled token
//   rows, outside the ring) and written by one TMA store that runs on
//   beside the next tile (16-byte stores where the rows are not 16-byte
//   multiples). The body and the grid are the wrapper's choice by shape
//   (ops/kernels/w8a16.py::tiling), which takes a narrower tile where the
//   wide one would leave the last wave ragged;
// - where even those tiles leave most SMs idle (few rows under a long K),
//   the wrapper splits K over gridDim.z, one tile a block, and the splits of
//   a tile form a thread block cluster: each leaves its fp32 partial tile in
//   its shared memory, and after a cluster barrier each block sums a share
//   of the tile over the splits in split order through distributed shared
//   memory, adds the bias and rounds. One launch, no workspace, no atomics,
//   and a result that does not depend on the schedule, so a replay equals
//   the eager launch bit for bit;
// - at most 4 rows (the products of one row a post at bucket 1): a warp an
//   output column, the rows of x against 8 codes a lane at a time;
// - fp32: the CUDA cores (64 x 64 tiles, 4 x 4 outputs a thread), as K1-K3
//   keep fp32 off the tensor cores, split the same way;
// - bf16 views that TMA cannot take (K % 16 != 0, or x's rows off 16-byte
//   alignment): 64 x 64 tiles on mma.sync, x and the codes staged element
//   by element, unsplit.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using d2r::desc_b128;
using d2r::fence_async_smem;
using d2r::fence_regs;
using d2r::mbar_arrive;
using d2r::mbar_expect;
using d2r::mbar_init;
using d2r::mbar_wait;

constexpr int kBK = 64;          // k a step of the bf16 bodies
constexpr int kMaxSplits = 8;    // a portable cluster

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Results (row, col) and (row, col + 1), col even, plus the bias, rounded
// into out; one paired store where N is even.
template <typename T>
__device__ __forceinline__ void put2(T* out, const T* bias, int M, int N, int row, int col,
                                     float v0, float v1) {
  if (row >= M || col >= N) return;
  if (bias != nullptr) {
    v0 += to_float(bias[col]);
    if (col + 1 < N) v1 += to_float(bias[col + 1]);
  }
  T* o = out + (long long)row * N + col;
  if (N % 2 == 0) {
    store2(o, v0, v1);
  } else {
    store(o, v0);
    if (col + 1 < N) store(o + 1, v1);
  }
}

// Int8 codes to numbers without the conversion unit (a quarter of the
// FMA rate on Hopper, and the limit of a dequantizing product): the byte
// u = code + 128 under the exponent byte 0x4B is the float 2^23 + u, so one
// subtraction of 2^23 + 128 leaves the code exactly. The two codes in bits
// 0-15 of c, as floats:
__device__ __forceinline__ void codes_to_float2(uint32_t c, float& f0, float& f1) {
  const uint32_t u = c ^ 0x8080u;
  f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
}

// The same two codes dequantized, bf16(code * s) each, as a bf16x2 (code
// 0 low): a code has at most 8 significant bits, so its float's high half
// is its exact bf16, and one bf16x2 multiply by s2 = (s, s) rounds each
// exact product once, to nearest even: the bits of the plain path's
// bf16(q) * bf16(s).
__device__ __forceinline__ uint32_t dequant_bf16x2(uint32_t c, __nv_bfloat162 s2) {
  float f0, f1;
  codes_to_float2(c, f0, f1);
  const uint32_t qb = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  const __nv_bfloat162 w = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&qb), s2);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// The same product from the codes in bytes 0 and 2 of v (bytes 1 and 3
// ignored), in four operations and no float conversion: the bf16 0x43 |
// (c & 127) is exactly 128 + (c & 127) and 0x43 | (c & 128) exactly 128 or
// 256 by c's sign, so their bf16x2 difference is the code (exact: at most
// 8 significant bits), and the multiply by s2 rounds the exact product
// once, as dequant_bf16x2 does.
__device__ __forceinline__ uint32_t lop_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;   // (a & b) | c in one LOP3 (b and c in registers)
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t dequant_pair(uint32_t v, __nv_bfloat162 s2, uint32_t m7f,
                                                 uint32_t m80, uint32_t k43) {
  const uint32_t hi = lop_and_or(v, m7f, k43);
  const uint32_t lo = lop_and_or(v, m80, k43);
  const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&lo));
  const __nv_bfloat162 w = __hmul2(q, s2);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// bf16 bits to float: a shift
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// The split-K epilogue of a cluster of gridDim.z blocks, one a split, each
// holding its (rows x cols) fp32 partial tile at `part` (row stride ld, a
// multiple of 4): after a cluster barrier, threads [0, threads) of block r
// sum every (splits)-th group of 4 outputs of the tile over the splits, in
// split order, from their shared memories, and add the bias (the loads of
// two groups issued before their sums); a second barrier keeps each
// block's memory alive until the others have read it.
template <typename T>
__device__ __forceinline__ void cluster_reduce(float* part, int ld, int rows, int cols, int m0,
                                               int n0, const T* bias, T* out, int M, int N,
                                               int threads) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const float* parts[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) parts[s] = cluster.map_shared_rank(part, s < splits ? s : 0);
  // two groups of 4 outputs at a time: their bias and every split's
  // partials loaded before any sum
  const int stride = 4 * splits * threads;
  for (int e0 = 4 * (rank * threads + (int)threadIdx.x); e0 < rows * cols; e0 += 2 * stride) {
    float4 p[2][kMaxSplits];
    float b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * stride;
      const int r = e / cols, c = e % cols;
      const bool live = e < rows * cols && m0 + r < M;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[h][j] = (live && bias != nullptr && n0 + c + j < N) ? to_float(bias[n0 + c + j]) : 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (live && s < splits) p[h][s] = *reinterpret_cast<const float4*>(parts[s] + r * ld + c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * stride;
      const int r = e / cols, c = e % cols;
      if (e >= rows * cols || m0 + r >= M) continue;
      float4 v = p[h][0];
#pragma unroll
      for (int s = 1; s < kMaxSplits; ++s) {
        if (s < splits) {
          v.x += p[h][s].x;
          v.y += p[h][s].y;
          v.z += p[h][s].z;
          v.w += p[h][s].w;
        }
      }
      put2<T>(out, nullptr, M, N, m0 + r, n0 + c, v.x + b[h][0], v.y + b[h][1]);
      put2<T>(out, nullptr, M, N, m0 + r, n0 + c + 2, v.z + b[h][2], v.w + b[h][3]);
    }
  }
  cluster.sync();
}

// ---- bf16 views that TMA cannot take: 64 x 64 tiles on mma.sync ----
//
// Four warps of 32 x 32 outputs; x's rows and the codes of each k-step
// staged element by element (rows and k past the edges as zeros); each
// lane builds its m16n8k16 B fragments straight from the codes, two 2-byte
// shared loads a fragment converted and scaled in registers, the A
// fragments by ldmatrix; fp32 accumulation.
constexpr int kLdA = kBK + 8;    // shared row stride of x's tile, elements
constexpr int kLdQ = kBK + 16;   // shared row stride of the code tile, bytes

__global__ void __launch_bounds__(128)
    w8a16_bf16_kernel(const bf16* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, int period, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, int M, int N, int K) {
  constexpr int kTile = 64, kMT = 2, kNT = 4;   // m16 and n8 tiles a warp
  __shared__ __align__(16) bf16 as[kTile * kLdA];
  __shared__ __align__(16) int8_t qs[kTile * kLdQ];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  // the weight columns of this lane's B fragments (n = g of each n8 tile)
  // and their scales rounded to bf16, as the plain path casts them, twice
  __nv_bfloat162 sc[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + g;
    sc[nt] = __float2bfloat162_rn(n < N ? __ldg(scale + n % period) : 0.f);
  }
  float acc[kMT][kNT][4] = {};
  const bf16 zero = __float2bfloat16(0.f);
  for (int kb = 0; kb < K; kb += kBK) {
    for (int i = tid; i < kTile * kBK; i += 128) {
      const int r = i / kBK, c = i % kBK;
      as[r * kLdA + c] = (m0 + r < M && kb + c < K) ? x[(long long)(m0 + r) * ldx + kb + c] : zero;
      qs[r * kLdQ + c] = (n0 + r < N && kb + c < K) ? q[(long long)(n0 + r) * K + kb + c] : 0;
    }
    __syncthreads();
    const int8_t* qw = qs + (wn * 32 + g) * kLdQ + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        d2r::ldmatrix_x4(a[mt], as + (wm * 32 + mt * 16 + lane % 16) * kLdA + kk * 16 +
                                    (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // B rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9 of column g: two code pairs
        const int8_t* c = qw + nt * 8 * kLdQ + kk * 16;
        const uint32_t b0 = dequant_bf16x2(*reinterpret_cast<const uint16_t*>(c), sc[nt]);
        const uint32_t b1 = dequant_bf16x2(*reinterpret_cast<const uint16_t*>(c + 8), sc[nt]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) d2r::mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put2(out, bias, M, N, m0 + wm * 32 + mt * 16 + g + h * 8, n0 + wn * 32 + nt * 8 + 2 * t4,
             acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// ---- bf16 above 4 rows: the weight as wgmma's register operand ----

// the (c0 inner, c1 outer) box of `map` into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(d2r::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(d2r::smem_addr(bar))
      : "memory");
}

// the (c0 inner, c1 outer) box of `map` from shared memory, as one bulk
// group; its rows and columns past the tensor's edges are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(d2r::smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma m64nNk16, bf16 in, fp32 accumulated into d: A (64 x 16) from four
// registers a thread (the mma.sync m16n8k16 A fragment of the thread's
// warp, rows 16 (warp % 4) + lane / 4 (+ 8), k 2 (lane % 4) (+ 1, + 8, + 9)),
// B (16 x N) K-major in shared memory by descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}


template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NT == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (NT == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A tile of 64 output features (wgmma's M) by NT tokens (wgmma's N), BPS
// blocks an SM. KW consumer warpgroups: warpgroup kw takes the tile's
// k-steps kw (mod KW), so that one converts its step's codes while the
// other's products run; their fp32 sums meet in shared memory at the end,
// in k-group order. The producer is one warp, or for 256 tokens (128
// accumulators a consumer thread) a warpgroup that hands its registers to
// the consumer (setmaxnreg). Shared memory: the ring (x tiles, then code
// tiles), the staged output (NT token rows of 64 bf16 features, 128-byte
// swizzled; k-group 1's sums pass through it first, half at a time), the
// barriers.
template <int NT, int KW, int BPS>
struct WsTiling {
  static constexpr int kWG = KW;            // consumer warpgroups
  static constexpr int kF = 64;             // features a tile
  static constexpr bool kWideN = NT == 256;
  static constexpr int kThreads = kWG * 128 + (kWideN ? 128 : 32);
  static constexpr int kTileX = NT * kBK * 2;   // x's tile: NT rows of 128 bytes
  static constexpr int kTileQ = kF * kBK;       // the codes: 64 rows of 64 bytes
  static constexpr int kStage = NT * 128;       // the staged output
  // what a block may take of the SM's 228 KiB (1 KiB each kept by the
  // system), less the 1,024-byte alignment slack and the barriers
  static constexpr int kFit =
      ((BPS == 1 ? 232448 : 115712) - 1024 - kStage - 256) / (kTileX + kTileQ);
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kRing = kStages * (kTileX + kTileQ);
  static constexpr int kLdP = kF + 4;   // the split's fp32 partial tile, row stride
  static constexpr int kSmem = 1024 + kRing + kStage + 2 * kStages * 8;
  static_assert(kStages >= 2 * KW + 1, "the ring feeds every k-group");
  static_assert(NT * kLdP * 4 <= kRing + kStage, "the partial tile fits");
  static_assert(KW <= 2 && (!kWideN || (BPS == 1 && KW == 1)), "232 registers a consumer thread");
};

#ifdef D2R_W8_PROBE
// w8a16_sweep.py --probe: clock64 of the first consumer thread of a block
// at four points of each of its first 8 tiles (the tile's start, its first
// step's products issued, its last products done, its output issued)
__device__ long long g_w8_probe[4096 * 32];
#define D2R_PROBE(k)                                                                   \
  do {                                                                                 \
    if (tid == 0 && it < 8)                                                            \
      g_w8_probe[(blockIdx.x + gridDim.x * blockIdx.z) * 32 + it * 4 + (k)] = clock64(); \
  } while (0)
#else
#define D2R_PROBE(k) \
  do {               \
  } while (0)
#endif

template <int NT, int KW, int BPS>
__global__ void __launch_bounds__(WsTiling<NT, KW, BPS>::kThreads, BPS)
    w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap out_map, int tma_out,
                       const float* __restrict__ scale, int period,
                       const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K,
                       int ktiles_per_split) {
  using T = WsTiling<NT, KW, BPS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzles are functions of address bits 4-9: tiles start 1,024-aligned
  const uint32_t raw = d2r::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* x_tiles = smem;
  unsigned char* q_tiles = x_tiles + T::kStages * T::kTileX;
  unsigned char* stage = smem + T::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + T::kStage);
  uint64_t* empty = full + T::kStages;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  // tile t: features (t % tiles_n) * 64, tokens (t / tiles_n) * NT; a
  // split launch has one tile a block (gridDim.x = tiles)
  const int tiles_n = (N + T::kF - 1) / T::kF;
  const int tiles = tiles_n * ((M + NT - 1) / NT);
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int steps = min((K + kBK - 1) / kBK, kt0 + ktiles_per_split) - kt0;

  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);   // lane 0 of each warp of the step's k-group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the two roles never meet again (the register split holds only so)
  if (warp >= 4 * T::kWG) {
    if constexpr (T::kWideN) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // the block's g-th step (over its tiles) into slot g % kStages, once
    // the consumers have released the slot's previous use
    if (warp == 4 * T::kWG && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&q_map))
                   : "memory");
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * T::kF, m0 = (tile / tiles_n) * NT;
        for (int i = 0; i < steps; ++i, ++g) {
          const int slot = g % T::kStages;
          if (g >= T::kStages) mbar_wait(empty + slot, (g / T::kStages + 1) & 1);
          mbar_expect(full + slot, T::kTileX + T::kTileQ);
          tma_load_2d(x_tiles + slot * T::kTileX, &x_map, (kt0 + i) * kBK, m0, full + slot);
          tma_load_2d(q_tiles + slot * T::kTileQ, &q_map, (kt0 + i) * kBK, n0, full + slot);
        }
      }
    }
    if (gridDim.z > 1) {   // the split reduction's two cluster barriers (cluster_reduce)
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  if constexpr (T::kWideN) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // accumulator i of a thread: feature r0 (i % 4 < 2) or r0 + 8 of the
  // tile's 64, token 8 (i / 4) + 2 (lane % 4) + i % 2
  const int kw = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int t4 = lane % 4;
  // row r0's codes in a stage: 64-byte rows whose 16-byte chunk c sits at
  // c ^ ((row / 2) % 4) (TMA's 64-byte swizzle; row r0 + 8 alike)
  const int sw = (r0 / 2) % 4;
  const unsigned char* q_row = q_tiles + r0 * kBK;
  // of a chunk's words (w0, w1), this thread's code pair (k = 2 t4, + 1) to
  // bytes 0 and 2; of (w2, w3) the pair at k + 8
  const uint32_t pick = 0x1100u * (2 * t4 + 1) + 0x11u * (2 * t4);
  uint32_t m7f, m80, k43;   // the masks, in registers (one LOP3 each)
  asm volatile("mov.b32 %0, 0x007F007F;\n" : "=r"(m7f));
  asm volatile("mov.b32 %0, 0x00800080;\n" : "=r"(m80));
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(k43));
  float d[NT / 2];
  int g = 0;   // the block's steps so far, as the producer counts them
#ifdef D2R_W8_PROBE
  int it = 0;
#endif
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    D2R_PROBE(0);
    const int n0 = (tile % tiles_n) * T::kF, m0 = (tile / tiles_n) * NT;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) d[i] = 0.f;
    // the scales of rows r0 and r0 + 8, rounded to bf16 as the plain path
    // casts them, twice; their biases, for the epilogue
    const int f0 = n0 + r0, f1 = f0 + 8;
    const __nv_bfloat162 s0 = __float2bfloat162_rn(f0 < N ? __ldg(scale + f0 % period) : 0.f);
    const __nv_bfloat162 s1 = __float2bfloat162_rn(f1 < N ? __ldg(scale + f1 % period) : 0.f);
    const float b0 = (bias != nullptr && f0 < N) ? to_float(bias[f0]) : 0.f;
    const float b1 = (bias != nullptr && f1 < N) ? to_float(bias[f1]) : 0.f;

    // step gi's codes, once landed, into A fragments: k16 slice kk in a[4
    // kk .. 4 kk + 3] (rows r0, r0 + 8 at k 2t; the same at k 2t + 8), each
    // chunk of a row one 16-byte load, a quad's four threads on one chunk
    auto dequant = [&](int gi, uint32_t(&a)[16]) {
      const int slot = gi % T::kStages;
      mbar_wait(full + slot, (gi / T::kStages) & 1);
      __syncwarp();
      const unsigned char* qs = q_row + slot * T::kTileQ;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint4 c0 = *reinterpret_cast<const uint4*>(qs + ((kk ^ sw) << 4));
        const uint4 c1 = *reinterpret_cast<const uint4*>(qs + 8 * kBK + ((kk ^ sw) << 4));
        a[4 * kk + 0] = dequant_pair(__byte_perm(c0.x, c0.y, pick), s0, m7f, m80, k43);
        a[4 * kk + 1] = dequant_pair(__byte_perm(c1.x, c1.y, pick), s1, m7f, m80, k43);
        a[4 * kk + 2] = dequant_pair(__byte_perm(c0.z, c0.w, pick), s0, m7f, m80, k43);
        a[4 * kk + 3] = dequant_pair(__byte_perm(c1.z, c1.w, pick), s1, m7f, m80, k43);
      }
    };
    // step gi's four products, issued asynchronously as one group
    auto mma = [&](int gi, uint32_t(&a)[16]) {
      const uint32_t xa = d2r::smem_addr(x_tiles + (gi % T::kStages) * T::kTileX);
      fence_regs(d);
      fence_regs(a);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
        wgmma_rs<NT>(d, f, desc_b128(xa) + 2 * kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_regs(d);
    };
    // this warpgroup's i-th step of the tile is the tile's step kw + i KW;
    // once its products are issued, its (i - 1)-th step's are done and that
    // slot is released
    const int mine = steps > kw ? (steps - kw + KW - 1) / KW : 0;
    auto release = [&](int i) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(d);
      __syncwarp();
      if (lane == 0 && i > 0) mbar_arrive(empty + (g + kw + (i - 1) * KW) % T::kStages);
    };
    // two fragment buffers: step i + 1 is dequantized into one while step
    // i's products read the other
    uint32_t a0[16], a1[16];
    if (mine > 0) dequant(g + kw, a0);
    for (int i = 0; i < mine; i += 2) {
      mma(g + kw + i * KW, a0);
      if (i == 0) D2R_PROBE(1);
      release(i);
      if (i + 1 < mine) {
        dequant(g + kw + (i + 1) * KW, a1);
        mma(g + kw + (i + 1) * KW, a1);
        release(i + 1);
        if (i + 2 < mine) dequant(g + kw + (i + 2) * KW, a0);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(d);
    __syncwarp();
    if (lane == 0 && mine > 0) mbar_arrive(empty + (g + kw + (mine - 1) * KW) % T::kStages);
    g += steps;
    D2R_PROBE(2);
    if constexpr (KW > 1) {
      // k-group 1's sums into k-group 0's, half at a time through the
      // staging area, once the previous tile's store has read it (k-group 1
      // writes the next tile's only after k-group 0 reaches that tile's
      // first barrier, its epilogue done)
      // (16-byte accesses: thread t's four sums i .. i + 3 at float4 (i / 4)
      // * 128 + t)
      float4* red = reinterpret_cast<float4*>(stage);
      if (tma_out && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(1, T::kWG * 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kw == 1) {
#pragma unroll
          for (int i = 0; i < NT / 4; i += 4)
            red[(i / 4) * 128 + tid % 128] = make_float4(
                d[h * NT / 4 + i], d[h * NT / 4 + i + 1], d[h * NT / 4 + i + 2],
                d[h * NT / 4 + i + 3]);
        }
        bar_sync(1, T::kWG * 128);
        if (kw == 0) {
#pragma unroll
          for (int i = 0; i < NT / 4; i += 4) {
            const float4 v = red[(i / 4) * 128 + tid % 128];
            d[h * NT / 4 + i] += v.x;
            d[h * NT / 4 + i + 1] += v.y;
            d[h * NT / 4 + i + 2] += v.z;
            d[h * NT / 4 + i + 3] += v.w;
          }
        }
        if (h == 0) bar_sync(1, T::kWG * 128);
      }
    }

    if (gridDim.z > 1) {
      // the partial tile takes the ring
      float* part = reinterpret_cast<float*>(smem);
      if (kw == 0) {
#pragma unroll
        for (int i = 0; i < NT / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* p = part + (8 * i + 2 * t4 + j) * T::kLdP + r0;
            p[0] = d[4 * i + j];
            p[8] = d[4 * i + 2 + j];
          }
      }
      cluster_reduce(part, T::kLdP, NT, T::kF, m0, n0, bias, out, M, N, T::kWG * 128);
      return;   // a split launch has one tile a block
    }
    if (kw > 0) continue;   // k-group 0 stores the tile
    // the warpgroup's previous tile has left its staging area
    if (tma_out && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    bar_sync(2, 128);
    // the tile plus the bias, rounded, transposed into token rows by
    // stmatrix: n8 tiles i and i + 1, features 16 (warp % 4) + [0, 8) and +
    // [8, 16); lane l addresses row l % 8 of matrix l / 8: token 8 (i + mat
    // / 2) + l % 8, its 16-byte chunk 2 (warp % 4) + mat % 2 at chunk ^ (l % 8)
    const int mat = lane / 8;
    const uint32_t row_addr = d2r::smem_addr(
        stage + (8 * (mat / 2) + lane % 8) * 128 +
        (((2 * (warp % 4) + mat % 2) ^ (lane % 8)) << 4));
#pragma unroll
    for (int i = 0; i < NT / 8; i += 2) {
      uint32_t p[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(d[4 * (i + h)] + b0, d[4 * (i + h) + 1] + b0);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(d[4 * (i + h) + 2] + b1, d[4 * (i + h) + 3] + b1);
        p[2 * h] = *reinterpret_cast<const uint32_t*>(&lo);
        p[2 * h + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      asm volatile(
          "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
              row_addr + i * 1024),
          "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3])
          : "memory");
    }
    if (tma_out) {
      // the staged tile out by one TMA store (the staging area is the
      // box's 128-byte swizzled layout), asynchronous to the next tile
      fence_async_smem();
      bar_sync(2, 128);
      if (tid == 0) tma_store_2d(&out_map, n0, m0, stage);
    } else {
      bar_sync(2, 128);
      // else a token's 64 features in 16-byte stores
      const bool wide = N % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
      for (int e = tid % 128; e < NT * 8; e += 128) {
        const int r = e / 8, c = e % 8;
        const int row = m0 + r, col = n0 + 8 * c;
        if (row >= M || col >= N) continue;
        const unsigned char* src = stage + r * 128 + ((c ^ (r % 8)) << 4);
        bf16* dst = out + (long long)row * N + col;
        if (wide) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          const bf16* v = reinterpret_cast<const bf16*>(src);
          for (int j = 0; j < 8 && col + j < N; ++j) dst[j] = v[j];
        }
      }
    }
    D2R_PROBE(3);
#ifdef D2R_W8_PROBE
    ++it;
#endif
  }
  if (tma_out && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// fp32 on the CUDA cores: a 64 x 64 tile, 256 threads of 4 x 4 outputs,
// k in steps of 16, the dequantized codes fp32(q * s) in shared memory.
constexpr int kF32Tile = 64;
constexpr int kF32BK = 16;
constexpr int kF32LdP = kF32Tile + 4;

__global__ void __launch_bounds__(256)
    w8a16_f32_kernel(const float* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
                     const float* __restrict__ scale, int period, const float* __restrict__ bias,
                     float* __restrict__ out, int M, int N, int K, int ktiles_per_split) {
  __shared__ __align__(16) float as[kF32BK][kF32Tile + 4];
  __shared__ __align__(16) float bs[kF32BK][kF32Tile + 4];
  __shared__ __align__(16) float part[kF32Tile * kF32LdP];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  const int ktiles = (K + kF32BK - 1) / kF32BK;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int kt1 = min(ktiles, kt0 + ktiles_per_split);
  // the rows ty + 16 j this thread stages, and their scales
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + ty + 16 * j;
    sc[j] = n < N ? __ldg(scale + n % period) : 0.f;
  }
  float acc[4][4] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k = kt * kF32BK + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * j;
      as[tx][r] = (m0 + r < M && k < K) ? x[(long long)(m0 + r) * ldx + k] : 0.f;
      bs[tx][r] =
          (n0 + r < N && k < K) ? __fmul_rn((float)q[(long long)(n0 + r) * K + k], sc[j]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; j += 2)
        put2(out, bias, M, N, m0 + ty * 4 + i, n0 + tx * 4 + j, acc[i][j], acc[i][j + 1]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[(ty * 4 + i) * kF32LdP + tx * 4 + j] = acc[i][j];
  cluster_reduce(part, kF32LdP, kF32Tile, kF32Tile, m0, n0, bias, out, M, N, 256);
}

// M <= kGemvRows (a product of one row a post at small buckets): a warp an
// output column n, 8 codes a lane at a time (lane l takes k in [8 l, 8 l +
// 8) + 256 i), every row of x against them in fp32; the lanes' sums
// combined by a butterfly, so the order is fixed, the same in the scalar
// body that takes unaligned views.
constexpr int kGemvRows = 4;
constexpr int kGemvWarps = 4;

// 8 codes (two words) dequantized to floats: bf16(code * s) in bf16,
// fp32(code * s) in fp32
template <typename T>
__device__ __forceinline__ void dequant8(uint32_t lo, uint32_t hi, float s, float (&w)[8]) {
  const uint32_t c[4] = {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t v = dequant_bf16x2(c[j], __float2bfloat162_rn(s));
      w[2 * j] = lo_bf16(v);
      w[2 * j + 1] = hi_bf16(v);
    } else {
      float f0, f1;
      codes_to_float2(c[j], f0, f1);
      w[2 * j] = __fmul_rn(f0, s);
      w[2 * j + 1] = __fmul_rn(f1, s);
    }
  }
}

// ROWS = M, a compile-time count so that every row's loads of a step issue
// together
template <typename T, int ROWS>
__global__ void __launch_bounds__(kGemvWarps * 32)
    w8a16_gemv_kernel(const T* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, int period, const T* __restrict__ bias,
                      T* __restrict__ out, int N, int K, int vec) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvWarps + threadIdx.x / 32;
  if (n >= N) return;
  const float s = __ldg(scale + n % period);
  const int8_t* row = q + (long long)n * K;
  float acc[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int k = lane * 8; k < K; k += 32 * 8) {
    uint32_t cw[2] = {0u, 0u};
    if (vec) {
      const int2 raw = __ldg(reinterpret_cast<const int2*>(row + k));
      cw[0] = (uint32_t)raw.x;
      cw[1] = (uint32_t)raw.y;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k + j < K) cw[j / 4] |= (uint32_t)(uint8_t)row[k + j] << (8 * (j % 4));
    }
    float w[8];
    dequant8<T>(cw[0], cw[1], s, w);
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const T* xr = x + (long long)m * ldx + k;
      float xv[8];
      if constexpr (sizeof(T) == 2) {
        uint32_t u[4] = {0u, 0u, 0u, 0u};
        if (vec) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(xr));
          u[0] = (uint32_t)v.x, u[1] = (uint32_t)v.y, u[2] = (uint32_t)v.z, u[3] = (uint32_t)v.w;
        } else {
          const unsigned short* xs = reinterpret_cast<const unsigned short*>(xr);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k + j < K) u[j / 2] |= (uint32_t)xs[j] << (16 * (j % 2));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xv[2 * j] = lo_bf16(u[j]);
          xv[2 * j + 1] = hi_bf16(u[j]);
        }
      } else {
        if (vec) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(xr));
          const float4 b = __ldg(reinterpret_cast<const float4*>(xr) + 1);
          xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
          xv[4] = b.x, xv[5] = b.y, xv[6] = b.z, xv[7] = b.w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) xv[j] = k + j < K ? to_float(xr[j]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m] = fmaf(xv[j], w[j], acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    float v = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == m) store(out + (long long)m * N + n, bias != nullptr ? v + to_float(bias[n]) : v);
  }
}

// Launches `kernel` with gridDim.z = splits, the splits of a tile one
// cluster (1, 1, splits) where there are several.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem, int splits, cudaStream_t stream,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// a 2-D tensor map of `rows` rows of `cols` elements, `row_bytes` apart
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
               int cols, long long row_bytes, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  const d2r::EncodeTiled encode = d2r::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int ROWS>
int gemv_rows(const void* x, long long ldx, const int8_t* q, const float* scale, int period,
              const void* bias, void* out, int N, int K, int vec, cudaStream_t stream) {
  w8a16_gemv_kernel<T, ROWS><<<(N + kGemvWarps - 1) / kGemvWarps, kGemvWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), ldx, q, scale, period, static_cast<const T*>(bias),
      static_cast<T*>(out), N, K, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int gemv(const void* x, long long ldx, const int8_t* q, const float* scale, int period,
         const void* bias, void* out, int M, int N, int K, int vec, cudaStream_t stream) {
  switch (M) {
    case 1: return gemv_rows<T, 1>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    case 2: return gemv_rows<T, 2>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    case 3: return gemv_rows<T, 3>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    case 4: return gemv_rows<T, 4>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NT, int KW, int BPS>
int launch_wgmma(const bf16* x, long long ldx, const int8_t* q, const float* scale, int period,
                 const bf16* bias, bf16* out, int M, int N, int K, int splits,
                 int ktiles_per_split, int blocks, cudaStream_t stream) {
  using T = WsTiling<NT, KW, BPS>;
  auto kernel = w8a16_wgmma_kernel<NT, KW, BPS>;
  const int tiles = ((N + T::kF - 1) / T::kF) * ((M + NT - 1) / NT);
  if (splits == 1 && (blocks < 1 || blocks > tiles)) return (int)cudaErrorInvalidValue;
  // the shared-memory limit, raised once a device
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !((raised >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) raised |= 1u << dev;
  }
  CUtensorMap x_map, q_map, out_map;
  int err = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, ldx * 2, NT, kBK,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, K, T::kF, kBK,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  // the output by TMA where its rows are 16-byte multiples: a tile's 64
  // features (128 bytes) by NT tokens a box
  const int tma_out = N % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  memset(&out_map, 0, sizeof(out_map));
  if (err == 0 && tma_out)
    err = tensor_map(&out_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, M, N, (long long)N * 2, NT,
                     64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  // persistent (`blocks` blocks walk the tiles), or one tile a cluster of splits
  const dim3 grid(splits > 1 ? tiles : blocks, 1, splits);
  return launch(kernel, grid, T::kThreads, T::kSmem, splits, stream, x_map, q_map, out_map,
                tma_out, scale, period, bias, out, M, N, K, ktiles_per_split);
}

}  // namespace

// dtype 0 fp32, 1 bf16 (x, bias and out). tile: 2, a warp an output column
// (M <= 4, no split); 0, 64 x 64 tiles (fp32 on the CUDA cores; bf16 on
// mma.sync, no split); in bf16 100 KW + 10 + NT / 64, the warp-specialized
// wgmma body of 64 features by NT tokens with KW k-groups (WsTiling; the
// instantiations below), which views that TMA cannot take (x or q off
// 16-byte alignment, K % 16 != 0, a row stride not a multiple of 8) hand to
// tile 0. K is cut into `splits` (at most 8) runs of ktiles_per_split steps
// (64 in bf16, 16 in fp32), the splits of a tile one cluster, none of them
// empty. An unsplit wgmma launch is persistent: `blocks` blocks (1 to the
// tile count) walk the tiles; other launches ignore `blocks`.
extern "C" int d2r_w8a16_linear(int dtype, int tile, const void* x, long long ldx,
                                const void* q, const void* scale, int period,
                                const void* bias, void* out, int M, int N, int K, int splits,
                                int ktiles_per_split, int blocks, void* stream) {
  const int ktiles = (K + (dtype == 0 ? kF32BK : kBK) - 1) / (dtype == 0 ? kF32BK : kBK);
  if (M < 1 || N < 1 || K < 1 || period < 1 || splits < 1 || splits > kMaxSplits ||
      ktiles_per_split < 1 || ldx < K || (splits - 1) * ktiles_per_split >= ktiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  const int vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15) == 0 &&
                  K % 16 == 0 && ldx % 8 == 0;
  if (tile == 2) {   // M <= kGemvRows: one launch, no split
    if (M > kGemvRows || splits != 1) return (int)cudaErrorInvalidValue;
    return dtype == 0 ? gemv<float>(x, ldx, qc, sc, period, bias, out, M, N, K, vec, st)
           : dtype == 1 ? gemv<bf16>(x, ldx, qc, sc, period, bias, out, M, N, K, vec, st)
                        : (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    if (tile != 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile, splits);
    return launch(w8a16_f32_kernel, grid, 256, 0, splits, st, static_cast<const float*>(x), ldx,
                  qc, sc, period, static_cast<const float*>(bias), static_cast<float*>(out), M, N,
                  K, ktiles_per_split);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  if (tile == 0 || !vec) {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    w8a16_bf16_kernel<<<grid, 128, 0, st>>>(xb, ldx, qc, sc, period, bb, ob, M, N, K);
    return (int)cudaGetLastError();
  }
#define D2R_BODY(NT, KW, BPS)                                                                 \
  case 100 * KW + 10 + NT / 64:                                                               \
    return launch_wgmma<NT, KW, BPS>(xb, ldx, qc, sc, period, bb, ob, M, N, K, splits,        \
                                     ktiles_per_split, blocks, st);
  switch (tile) {
    D2R_BODY(64, 2, 1)
    D2R_BODY(64, 1, 2)
    D2R_BODY(128, 1, 2)
    D2R_BODY(256, 1, 1)
    default: return (int)cudaErrorInvalidValue;
  }
#undef D2R_BODY
}

#ifdef D2R_W8_PROBE
// the probe's clocks (w8a16_sweep.py --probe), n values from the start
extern "C" int d2r_w8a16_probe(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_w8_probe, (size_t)n * sizeof(long long));
}
#endif
