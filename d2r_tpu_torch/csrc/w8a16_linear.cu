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
// weight bytes and the launch (D2R-base's FFN weight is 2.4 MB of codes,
// 0.7 us at 3.35 TB/s); at bucket 32 (M up to 2,048) the bf16 tensor cores
// (2 M N K operations at 989 TFLOP/s). The design, simple first:
// - bf16 body: a block computes a BM x BN tile of y over its share of K in
//   steps of 64. x's rows and the int8 codes go to shared memory by 16-byte
//   cp.async through a ring of four stages (three steps in flight under
//   the products of the fourth). Each lane builds its mma.sync m16n8k16 B
//   fragments straight from the codes: two 2-byte shared loads a fragment,
//   converted and scaled in registers (its columns' scales read once a
//   launch); the A fragments come by ldmatrix; fp32 accumulation. One
//   barrier a step. A 64 x 64 tile of 4 warps, where M <= 256;
// - above 256 bf16 rows, warpgroup MMA: a 128 x 128 (or, for a long K
//   under few tiles, 128 x 256) tile of two warpgroups; one thread streams
//   x's tile (in the 128-byte swizzled layout wgmma reads) and the codes
//   into a four-stage ring by TMA, the block dequantizes each step's codes
//   into a swizzled bf16 tile (the same bits), and wgmma m64nNk16 reads
//   both by descriptor, asynchronously under the next step's dequantize;
// - where the tiles alone leave SMs idle (few rows, narrow N), the wrapper
//   splits K over gridDim.z (ops/kernels/w8a16.py::tiling picks the body
//   and the split from the shape), and the splits of a tile form a thread block
//   cluster: each leaves its fp32 partial tile in its shared memory, and
//   after a cluster barrier each block sums a share of the tile over the
//   splits in split order through distributed shared memory, adds the
//   bias and rounds. One launch, no workspace, and a result that does not
//   depend on the schedule, so a replay equals the eager launch bit for
//   bit;
// - at most 8 rows (the products of one row a post at buckets 1 and 8): a
//   warp an output column, the rows of x against 8 codes a lane at a time;
// - fp32 body: the CUDA cores (64 x 64 tiles, 4 x 4 outputs a thread), as
//   K1-K3 keep fp32 off the tensor cores, split the same way.
// Shapes that 16-byte copies cannot stage (K % 16 != 0, or x's rows off
// alignment) load element by element in the 64 x 64 and fp32 bodies, into
// the same shared layout (the same sums in the same order); the TMA bodies
// hand such views to the 64 x 64 body.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // k a step of the bf16 body
constexpr int kLdA = kBK + 8;    // shared row stride of x's tile, elements
constexpr int kLdQ = kBK + 16;   // shared row stride of the code tile, bytes
constexpr int kMaxSplits = 8;    // a portable cluster

template <int BM, int BN, int WM, int WN, int STAGES>
struct Tiling {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWarpM = BM / WM;
  static constexpr int kWarpN = BN / WN;
  static constexpr int kMT = kWarpM / 16;   // m16 tiles a warp
  static constexpr int kNT = kWarpN / 8;    // n8 tiles a warp
  static constexpr int kStageA = BM * kLdA * 2;
  static constexpr int kStageQ = BN * kLdQ;
  static constexpr int kLdP = BN + 4;       // the partial tile's row stride, floats
  static constexpr int kRing = STAGES * (kStageA + kStageQ);
  static constexpr int kPart = BM * kLdP * 4;
  static constexpr int kSmem = kRing > kPart ? kRing : kPart;
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

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

// bf16 bits to float: a shift
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// The split-K epilogue of a cluster of gridDim.z blocks, one a split, each
// holding its (rows x cols) fp32 partial tile at `part` (row stride ld, a
// multiple of 4): after a cluster barrier, block r sums every (splits)-th
// group of 4 outputs of the tile over the splits, in split order, from
// their shared memories (all the splits' loads issued before the sums); a
// second barrier keeps each block's memory alive until the others have
// read it.
template <typename T>
__device__ __forceinline__ void cluster_reduce(float* part, int ld, int rows, int cols, int m0,
                                               int n0, const T* bias, T* out, int M, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int threads = blockDim.x;
  const float* parts[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) parts[s] = cluster.map_shared_rank(part, s < splits ? s : 0);
  for (int e = 4 * (rank * threads + (int)threadIdx.x); e < rows * cols;
       e += 4 * splits * threads) {
    const int r = e / cols, c = e % cols;
    float4 p[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) p[s] = *reinterpret_cast<const float4*>(parts[s] + r * ld + c);
    float4 v = p[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {
      if (s < splits) {
        v.x += p[s].x;
        v.y += p[s].y;
        v.z += p[s].z;
        v.w += p[s].w;
      }
    }
    put2(out, bias, M, N, m0 + r, n0 + c, v.x, v.y);
    put2(out, bias, M, N, m0 + r, n0 + c + 2, v.z, v.w);
  }
  cluster.sync();
}

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
    w8a16_bf16_kernel(const bf16* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, int period, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, int M, int N, int K, int ktiles_per_split,
                      int vec) {
  using T = Tiling<BM, BN, WM, WN, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as_base = reinterpret_cast<bf16*>(smem);
  int8_t* qs_base = reinterpret_cast<int8_t*>(smem + STAGES * T::kStageA);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int kt1 = min(ktiles, kt0 + ktiles_per_split);

  // the weight columns of this lane's B fragments (n = g of each n8 tile)
  // and their scales rounded to bf16, as the plain path casts them, twice
  __nv_bfloat162 sc[T::kNT];
#pragma unroll
  for (int nt = 0; nt < T::kNT; ++nt) {
    const int n = n0 + wn * T::kWarpN + nt * 8 + g;
    sc[nt] = __float2bfloat162_rn(n < N ? __ldg(scale + n % period) : 0.f);
  }

  // x's rows and the codes of k-step kt into ring slot `slot`
  auto load = [&](int slot, int kt) {
    const int kb = kt * kBK;
    bf16* as = as_base + slot * BM * kLdA;
    int8_t* qs = qs_base + slot * BN * kLdQ;
    if (vec) {
#pragma unroll
      for (int i = tid; i < BM * (kBK / 8); i += T::kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool ok = m0 + r < M && kb + c < K;
        d2r::cp_async16(as + r * kLdA + c, ok ? x + (long long)(m0 + r) * ldx + kb + c : x, ok);
      }
#pragma unroll
      for (int i = tid; i < BN * (kBK / 16); i += T::kThreads) {
        const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
        const bool ok = n0 + r < N && kb + c < K;
        d2r::cp_async16(qs + r * kLdQ + c, ok ? q + (long long)(n0 + r) * K + kb + c : q, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < BM * kBK; i += T::kThreads) {
        const int r = i / kBK, c = i % kBK;
        as[r * kLdA + c] =
            (m0 + r < M && kb + c < K) ? x[(long long)(m0 + r) * ldx + kb + c] : zero;
      }
      for (int i = tid; i < BN * kBK; i += T::kThreads) {
        const int r = i / kBK, c = i % kBK;
        qs[r * kLdQ + c] = (n0 + r < N && kb + c < K) ? q[(long long)(n0 + r) * K + kb + c] : 0;
      }
    }
  };

  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) load(s, kt0 + s);
    d2r::cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int slot = (kt - kt0) % STAGES;
    d2r::cp_async_wait<STAGES - 2>();
    // step kt has landed, and every warp is done with step kt - 1, whose
    // slot takes step kt + STAGES - 1
    __syncthreads();
    {
      const int next = kt + STAGES - 1;
      if (next < kt1) load((next - kt0) % STAGES, next);
      d2r::cp_async_commit();
    }
    const bf16* as = as_base + slot * BM * kLdA;
    const int8_t* qs = qs_base + slot * BN * kLdQ + (wn * T::kWarpN + g) * kLdQ + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[T::kMT][4];
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
        d2r::ldmatrix_x4(a[mt], as + (wm * T::kWarpM + mt * 16 + lane % 16) * kLdA + kk * 16 +
                                    (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        // B rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9 of column g: two code pairs
        const int8_t* c = qs + nt * 8 * kLdQ + kk * 16;
        const uint32_t b0 = dequant_bf16x2(*reinterpret_cast<const uint16_t*>(c), sc[nt]);
        const uint32_t b1 = dequant_bf16x2(*reinterpret_cast<const uint16_t*>(c + 8), sc[nt]);
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) d2r::mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  d2r::cp_async_wait<0>();

  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put2(out, bias, M, N, m0 + wm * T::kWarpM + mt * 16 + g + h * 8,
               n0 + wn * T::kWarpN + nt * 8 + 2 * t4, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    return;
  }
  __syncthreads();   // the ring's last reads are done: the partial tile takes its memory
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (wm * T::kWarpM + mt * 16 + g + h * 8) * T::kLdP +
                                   wn * T::kWarpN + nt * 8 + 2 * t4) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster_reduce(part, T::kLdP, BM, BN, m0, n0, bias, out, M, N);
}


// ---- bf16 above 256 rows: warpgroup MMA (wgmma) ----
//
// A 128 x BN tile a block of two warpgroups, each 64 rows by wgmma
// m64nBNk16 (both operands read from shared memory by descriptor). One
// thread streams x's tile and the codes of each k-step into a ring of
// four stages by the tensor memory accelerator (TMA, one copy a tile,
// completion counted on an mbarrier a stage; x's tile lands in the
// 128-byte swizzled K-major layout wgmma reads, 16-byte chunk c of row r
// at chunk c ^ (r % 8); rows and columns past the edges arrive as zeros).
// All 256 threads dequantize the codes into one of two swizzled bf16 B
// tiles; the products of step k run asynchronously while the block
// dequantizes step k + 1 into the other. The finished tile is staged in
// shared memory, so each row goes out in 16-byte stores.
constexpr int kWgBM = 128, kWgStages = 4, kWgThreads = 256;
constexpr int kWgTileA = kWgBM * kBK * 2;   // a 128 x 64 bf16 tile, bytes

template <int BN>
struct WgTiling {
  static constexpr int kTileB = BN * kBK * 2;
  static constexpr int kStageQ = BN * kBK;  // the codes, unpadded (a TMA box)
  static constexpr int kLdO = BN + 8;       // the staged bf16 output's row stride
  static constexpr int kLdP = BN + 4;       // the fp32 partial tile's row stride
  static constexpr int kBody = kWgStages * kWgTileA + 2 * kTileB + kWgStages * kStageQ;
  static constexpr int kSmem = 1024 + kBody + kWgStages * 8;   // + an mbarrier a stage
  static_assert(kWgBM * kLdP * 4 <= kBody && kWgBM * kLdO * 2 <= kBody, "staging fits");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(d2r::smem_addr(bar)), "r"(count));
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   d2r::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(d2r::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the (c0 inner, c1 outer) box of `map` into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(d2r::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(d2r::smem_addr(bar))
      : "memory");
}

// byte offset of 16-byte chunk c of row r in a 128-byte swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// a K-major, 128-byte swizzle descriptor: start address, LBO 1 (unused),
// SBO 1,024 bytes (the next 8 rows), layout B128
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128(d, da, db);
  else wgmma_m64n256(d, da, db);
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads)
    w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map, const float* __restrict__ scale,
                       int period, const bf16* __restrict__ bias, bf16* __restrict__ out, int M,
                       int N, int K, int ktiles_per_split) {
  using T = WgTiling<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: tiles start 1,024-aligned
  const uint32_t raw = d2r::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* a_tiles = smem;                                        // kWgStages
  unsigned char* b_tiles = smem + kWgStages * kWgTileA;                 // 2
  int8_t* q_tiles = reinterpret_cast<int8_t*>(b_tiles + 2 * T::kTileB); // kWgStages
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBody);        // kWgStages

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * ktiles_per_split;
  const int kt1 = min(ktiles, kt0 + ktiles_per_split);

  // thread 0: step kt's x tile and codes into ring slot `slot`
  auto load = [&](int slot, int kt) {
    uint64_t* bar = full + slot;
    mbar_expect(bar, kWgTileA + T::kStageQ);
    tma_load_2d(a_tiles + slot * kWgTileA, &x_map, kt * kBK, m0, bar);
    tma_load_2d(q_tiles + slot * T::kStageQ, &q_map, kt * kBK, n0, bar);
  };

  // the weight rows this thread dequantizes (half of each), their scales
  // rounded to bf16
  __nv_bfloat162 sc[BN / 128];
#pragma unroll
  for (int rr = 0; rr < BN / 128; ++rr) {
    const int n = n0 + rr * 128 + tid / 2;
    sc[rr] = __float2bfloat162_rn(n < N ? __ldg(scale + n % period) : 0.f);
  }

  // the codes of step kt into B tile `buf`: 32 codes a row-half
  auto dequant = [&](int kt, int buf) {
    const int8_t* qs = q_tiles + ((kt - kt0) % kWgStages) * T::kStageQ;
    unsigned char* bs = b_tiles + buf * T::kTileB;
#pragma unroll
    for (int rr = 0; rr < BN / 128; ++rr) {
      const int dn = rr * 128 + tid / 2, dh = tid % 2;
      const int4* src = reinterpret_cast<const int4*>(qs + dn * kBK + dh * 32);
      const int4 c2[2] = {src[0], src[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // 16-byte chunk 4 dh + j: 8 codes
        const uint32_t lo = (uint32_t)(j % 2 ? c2[j / 2].z : c2[j / 2].x);
        const uint32_t hi = (uint32_t)(j % 2 ? c2[j / 2].w : c2[j / 2].y);
        *reinterpret_cast<int4*>(bs + swz(dn, 4 * dh + j)) =
            make_int4((int)dequant_bf16x2(lo & 0xFFFFu, sc[rr]),
                      (int)dequant_bf16x2(lo >> 16, sc[rr]),
                      (int)dequant_bf16x2(hi & 0xFFFFu, sc[rr]),
                      (int)dequant_bf16x2(hi >> 16, sc[rr]));
      }
    }
    // the generic-proxy writes (cp.async, the tile above) before wgmma reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kWgStages - 1; ++s)
      if (kt0 + s < kt1) load(s, kt0 + s);
  if (kt0 < kt1) {
    mbar_wait(full, 0);
    dequant(kt0, 0);
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    __syncthreads();   // B tile i % 2 is complete
    const uint32_t a_addr =
        d2r::smem_addr(a_tiles + (i % kWgStages) * kWgTileA) + wg * 64 * 128;
    const uint32_t b_addr = d2r::smem_addr(b_tiles + (i % 2) * T::kTileB);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_step<BN>(d, desc_b128(a_addr) + 2 * kk, desc_b128(b_addr) + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt + 1 < kt1) {
      // step kt - 1's products are done (this warpgroup's; the barrier
      // makes it both), so its slot takes step kt + kWgStages - 1
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      __syncthreads();
      const int next = kt + kWgStages - 1;
      if (tid == 0 && next < kt1) load((next - kt0) % kWgStages, next);
      mbar_wait(full + (i + 1) % kWgStages, ((i + 1) / kWgStages) & 1);
      dequant(kt + 1, (i + 1) % 2);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  __syncthreads();   // every product is done: the staging takes the ring's memory

  // accumulator i: row 16 (warp % 4) + lane / 4 (+ 8 for i % 4 >= 2) of the
  // warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  if (gridDim.z > 1) {
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (row0 + 8 * h) * T::kLdP + 8 * i + col0) =
            make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    cluster_reduce(part, T::kLdP, kWgBM, BN, m0, n0, bias, out, M, N);
    return;
  }
  // the tile plus the bias, rounded, staged; then rows out in 16-byte stores
  bf16* stage = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + col0;
    const float b0 = (bias != nullptr && n0 + col < N) ? to_float(bias[n0 + col]) : 0.f;
    const float b1 = (bias != nullptr && n0 + col + 1 < N) ? to_float(bias[n0 + col + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(stage + (row0 + 8 * h) * T::kLdO + col) =
          __floats2bfloat162_rn(d[4 * i + 2 * h] + b0, d[4 * i + 2 * h + 1] + b1);
  }
  __syncthreads();
  const bool wide = N % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int e = tid; e < kWgBM * (BN / 8); e += kWgThreads) {
    const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const bf16* src = stage + r * T::kLdO + c;
    bf16* dst = out + (long long)row * N + col;
    if (wide) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int j = 0; j < 8 && col + j < N; ++j) dst[j] = src[j];
    }
  }
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
  cluster_reduce(part, kF32LdP, kF32Tile, kF32Tile, m0, n0, bias, out, M, N);
}

// M <= kGemvRows (a product of one row a post at small buckets): a warp an
// output column n, 8 codes a lane at a time (lane l takes k in [8 l, 8 l +
// 8) + 256 i), every row of x against them in fp32; the lanes' sums
// combined by a butterfly, so the order is fixed, the same in the scalar
// body that takes unaligned views.
constexpr int kGemvRows = 8;
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

template <int BM, int BN, int WM, int WN, int STAGES>
int launch_bf16(const bf16* x, long long ldx, const int8_t* q, const float* scale, int period,
                const bf16* bias, bf16* out, int M, int N, int K, int splits,
                int ktiles_per_split, int vec, cudaStream_t stream) {
  using T = Tiling<BM, BN, WM, WN, STAGES>;
  auto kernel = w8a16_bf16_kernel<BM, BN, WM, WN, STAGES>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  return launch(kernel, grid, T::kThreads, T::kSmem, splits, stream, x, ldx, q, scale, period,
                bias, out, M, N, K, ktiles_per_split, vec);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
               int cols, long long row_bytes, int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
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
    case 5: return gemv_rows<T, 5>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    case 6: return gemv_rows<T, 6>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    case 7: return gemv_rows<T, 7>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    case 8: return gemv_rows<T, 8>(x, ldx, q, scale, period, bias, out, N, K, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BN>
int launch_wgmma(const bf16* x, long long ldx, const int8_t* q, const float* scale, int period,
                 const bf16* bias, bf16* out, int M, int N, int K, int splits,
                 int ktiles_per_split, cudaStream_t stream) {
  CUtensorMap x_map, q_map;
  int err = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, ldx * 2, kWgBM, kBK,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, K, BN, kBK,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  auto kernel = w8a16_wgmma_kernel<BN>;
  const int smem = WgTiling<BN>::kSmem;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + kWgBM - 1) / kWgBM, splits);
  return launch(kernel, grid, kWgThreads, smem, splits, stream, x_map, q_map, scale, period,
                bias, out, M, N, K, ktiles_per_split);
}

}  // namespace

// dtype 0 fp32, 1 bf16 (x, bias and out); tile 0 = 64 x 64, 1 = 128 x 128
// on wgmma, 3 = 128 x 256 on wgmma (bf16 only), 2 = a warp an output
// column (M <= 8, no split). K is cut
// into `splits` (at most 8) runs of ktiles_per_split steps (64 in bf16, 16
// in fp32), the splits of a tile one cluster.
extern "C" int d2r_w8a16_linear(int dtype, int tile, const void* x, long long ldx,
                                const void* q, const void* scale, int period,
                                const void* bias, void* out, int M, int N, int K, int splits,
                                int ktiles_per_split, void* stream) {
  if (M < 1 || N < 1 || K < 1 || period < 1 || splits < 1 || splits > kMaxSplits ||
      ktiles_per_split < 1 || ldx < K)
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
    const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile, splits);
    return launch(w8a16_f32_kernel, grid, 256, 0, splits, st, static_cast<const float*>(x), ldx,
                  qc, sc, period, static_cast<const float*>(bias), static_cast<float*>(out), M, N,
                  K, ktiles_per_split);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  // the wgmma bodies load by TMA, which needs 16-byte aligned rows: other
  // views take the 64 x 64 body, unsplit
  if ((tile == 1 || tile == 3) && !vec) tile = 0, splits = 1, ktiles_per_split = (K + 63) / 64;
  if (tile == 0)
    return launch_bf16<64, 64, 2, 2, 4>(xb, ldx, qc, sc, period, bb, ob, M, N, K, splits,
                                        ktiles_per_split, vec, st);
  if (tile == 1) return launch_wgmma<128>(xb, ldx, qc, sc, period, bb, ob, M, N, K, splits,
                                         ktiles_per_split, st);
  if (tile == 3) return launch_wgmma<256>(xb, ldx, qc, sc, period, bb, ob, M, N, K, splits,
                                         ktiles_per_split, st);
  return (int)cudaErrorInvalidValue;
}
