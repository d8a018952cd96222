// Warp-level tensor-core pieces of the bf16 attention kernels (K1, K2, K3):
// 16-byte cp.async with zero fill, ldmatrix, and mma.sync m16n8k16 with
// bf16 operands and fp32 accumulation, plus what the kernels do with them:
// the tile loader, the score product, the scale/bias/mask step, the
// whole-row softmax (K1, K2), the A operand packed from fp32 fragments or
// read transposed from a stored tile (K2), the p.V product and the row
// store.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (row g,   cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B (16 x 8), 2 registers: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, +9)
//   C (16 x 8, fp32), 4 registers: c0, c1 (row g, cols 2t, 2t+1),
//     c2, c3 (row g+8, the same cols)
// So the accumulators of two neighbouring n8 tiles, packed in pairs, are
// the A operand of a k16 step: a score tile feeds the next product
// without passing through shared memory.
//
// Tiles sit in shared memory as rows of bf16 with a stride of the padded
// width + 8 elements: the stride is then an odd number of 16-byte chunks,
// so the 8 row addresses of one ldmatrix matrix fall in 8 different bank
// groups.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace d2r {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with valid false
// nothing is read and the 16 bytes are zeros (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives matrix i in the fragment layout above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: a 16x16 bf16, b 16x8 bf16, c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (nearest even) in one register, x in
// the low half: the element order of every fragment above.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` rows of a (rows, D) bf16 tile whose row r starts at
// src + r * rs into dst (row stride ld). Rows at or past `valid` become
// zeros. vec: every row start is 16-byte aligned and D % 8 == 0, so the
// copy goes by 16-byte cp.async (the caller commits and waits); otherwise
// element by element, synchronously. Columns past D are not touched.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, long long rs,
                                          int rows, int valid, int D, bool vec, int tid,
                                          int nthreads) {
  if (vec) {
    const int chunks = D / 8;
    for (int i = tid; i < rows * chunks; i += nthreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 8;
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < rows * D; i += nthreads) {
      const int r = i / D;
      const int c = i - r * D;
      dst[r * ld + c] = r < valid ? src[r * rs + c] : zero;
    }
  }
}

// Zero columns [D, width) of `rows` rows of stride ld: the padding of the
// product's k or n dimension to a multiple of 16, which no load writes.
__device__ __forceinline__ void zero_pad_columns(__nv_bfloat16* dst, int ld, int rows, int D,
                                                 int width, int tid, int nthreads) {
  const int pad = width - D;
  if (pad <= 0) return;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < rows * pad; i += nthreads) {
    const int r = i / pad;
    dst[r * ld + D + (i - r * pad)] = zero;
  }
}

// Whether a (rows, D) bf16 view with these strides can be staged by
// 16-byte copies: aligned base, and D and every stride a multiple of 8.
inline bool vec_ok(const void* p, int D, long long bs, long long rs) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && D % 8 == 0 && bs % 8 == 0 &&
         rs % 8 == 0;
}

// The pieces of a warp's attention tile that the kernels share. The warp
// owns 16 query rows; a lane holds rows g and g + 8 (g = lane / 4) of the
// fp32 fragments, t4 = lane % 4. NKEY and DMAX are the key count and head
// width the registers are sized for; the loops stop at the nk keys and
// nkd k16 steps present.

// Scores of one k16 step kk over the head: s += a . K^T, a the warp's q
// rows (A fragments), K the tile's rows at kt (row stride ld), 16 keys a
// ldmatrix; keys past the last 16 that hold one of the nk live keys are
// skipped.
template <int NKEY>
__device__ __forceinline__ void score_step(float (&s)[NKEY / 8][4], const uint32_t (&a)[4],
                                           const __nv_bfloat16* kt, int ld, int kk, int nk,
                                           int lane) {
#pragma unroll
  for (int np = 0; np < NKEY / 16; ++np) {
    if (np * 16 >= nk) break;
    uint32_t bk[4];
    ldmatrix_x4(bk, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * ld + kk * 16 +
                        ((lane / 8) % 2) * 8);
    mma_bf16(s[2 * np], a, bk[0], bk[1]);
    mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
  }
}

// The fp32 sums times scale, plus the key bias (bias[j] for key j of the
// tile, or none), in fp32 after the product; keys j >= nk become -inf.
template <int NKEY>
__device__ __forceinline__ void scale_bias_mask(float (&s)[NKEY / 8][4], float scale,
                                                const float* bias, int nk, int t4) {
#pragma unroll
  for (int n = 0; n < NKEY / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = n * 8 + 2 * t4 + e;
      const bool in = j < nk;
      const float bj = (bias != nullptr && in) ? __ldg(bias + j) : 0.f;
      s[n][e] = in ? s[n][e] * scale + bj : -INFINITY;
      s[n][e + 2] = in ? s[n][e + 2] * scale + bj : -INFINITY;
    }
  }
}

// softmax over each full row of the warp's (16, NKEY) tile in place, in
// fp32: rows g (r = 0) and g + 8 (r = 1), max and sum over the 4 lanes that
// hold a row by __shfl_xor_sync, p = e / sum; keys at -inf become 0.
template <int NKEY>
__device__ __forceinline__ void softmax_rows(float (&s)[NKEY / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int n = 0; n < NKEY / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NKEY / 8; ++n) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[n][e] = expf(s[n][e] - m);
        sum += s[n][e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int n = 0; n < NKEY / 8; ++n) {
      s[n][2 * r] /= sum;
      s[n][2 * r + 1] /= sum;
    }
  }
}

// The A operand of k16 step kk from a warp's (16, NKEY) fp32 tile, rounded
// to bf16: a0..a3 are (row g, row g + 8) x (keys 0-7, 8-15) of the step,
// i.e. n8 tiles 2kk and 2kk + 1 of the accumulator layout.
template <int NKEY>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[NKEY / 8][4],
                                       int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = pack_bf16(s[2 * kk + e / 2][2 * (e % 2)], s[2 * kk + e / 2][2 * (e % 2) + 1]);
}

// The A operand of a product over a stored (rows, cols) bf16 tile read
// transposed: A = T^T restricted to the 16 columns at c0 (A's rows) and
// the 16 rows at r0 (A's k16 step), for a tile T at t with row stride ld.
// ldmatrix.trans turns the four 8x8 blocks (r0 + 0/8, c0 + 0/8) into the
// fragment layout above: a0 from (r0, c0), a1 from (r0, c0 + 8), a2 from
// (r0 + 8, c0), a3 from (r0 + 8, c0 + 8).
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                             int r0, int c0, int lane) {
  ldmatrix_x4_trans(a, t + (r0 + (lane / 16) * 8 + lane % 8) * ld + c0 + ((lane / 8) % 2) * 8);
}

// p.V over the 16 keys of k16 step kk: acc += a[i] . V for each of the NA
// A operands in turn (K1: p rounded to bf16; K3: its hi and lo halves),
// V the tile's rows at vt (row stride ld), read transposed by ldmatrix.
// K2 runs its dq, dk and dv products through it too, with K, Q or G in
// V's place (rows are the contracted dimension).
template <int DMAX, int NA>
__device__ __forceinline__ void pv_step(float (&acc)[DMAX / 8][4], const uint32_t (&a)[NA][4],
                                        const __nv_bfloat16* vt, int ld, int kk, int nkd,
                                        int lane) {
#pragma unroll
  for (int dn = 0; dn < DMAX / 16; ++dn) {
    if (dn >= nkd) break;
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + dn * 16 +
                              (lane / 16) * 8);
#pragma unroll
    for (int i = 0; i < NA; ++i) mma_bf16(acc[2 * dn], a[i], bv[0], bv[1]);
#pragma unroll
    for (int i = 0; i < NA; ++i) mma_bf16(acc[2 * dn + 1], a[i], bv[2], bv[3]);
  }
}

// Row g + 8r of the warp's fp32 output tile, each value divided by div and
// rounded once to bf16, into the D columns at orow (pairs of columns at
// once when D is even).
template <int DMAX>
__device__ __forceinline__ void store_row(__nv_bfloat16* orow, const float (&acc)[DMAX / 8][4],
                                          int r, float div, int D, int t4) {
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    const int d = n * 8 + 2 * t4;
    if (d >= D) break;
    const float x0 = acc[n][2 * r] / div, x1 = acc[n][2 * r + 1] / div;
    if ((D & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
    } else {
      orow[d] = __float2bfloat16(x0);
      if (d + 1 < D) orow[d + 1] = __float2bfloat16(x1);
    }
  }
}

}  // namespace d2r
