// Dropout bits of the port's kernels (K1, K2 and the hidden-dropout
// kernel): Philox4x32-10.
//
// Seeds live in device memory. A launch gets a pointer to the step's 64-bit
// seed and a host site index; the kernel derives the site's Philox key as
// site_key(seed, site) = splitmix64(seed + site), so one buffer written
// before a step (or a CUDA-graph replay) reseeds every site of it, and no
// seed is baked into a launch. The same function is
// d2r_tpu_torch/ops/kernels/fused_attention.py::site_key.
//
// Element (b, h, i, j) of the (B, H, L, S) probability tile takes word
// j % 4 of Philox4x32-10 at counter (j / 4, i, h, b) under the key
// (key mod 2^32, key >> 32), b and h being the GLOBAL batch row and head
// (a launch adds its offsets b0 and h0 to its own), so the mask depends on
// no grid, tile size or process mesh: K1 and K2 regenerate the same bits
// without storing them, and
// d2r_tpu_torch/ops/kernels/fused_attention.py::dropout_keep_mask computes
// them in plain tensor ops. An element is kept iff its bits are >= the
// threshold min(int(rate * 2^32), 2^32 - 1), the rule of
// d2r_tpu/ops/kernels/fused_attention.py::_keep_mask. Element e of a
// flat tensor (hidden dropout, dropout.cu) takes word e % 4 at counter
// ((e / 4) mod 2^32, (e / 4) >> 32, 0, 0), e its index in the whole
// step's tensor (dropout.cu's slice layout).
//
// Rounds and key schedule as Random123's philox4x32_R and cuRAND's
// curand_Philox4x32_10; the tests hold the plain version to Random123's
// known-answer vectors.

#pragma once

#include <stdint.h>

namespace d2r {

// splitmix64 (Steele et al., OOPSLA'14), the finaliser of Java's
// SplittableRandom.
__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The Philox key of dropout site `site` of the step whose seed is *seed.
__device__ __forceinline__ unsigned long long site_key(const unsigned long long* seed,
                                                       uint32_t site) {
  return splitmix64(*seed + site);
}

// Philox4x32-10 of counter (c0, c1, c2, c3) under the 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, unsigned long long key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The four words of the call that covers keys 4 (j / 4) .. 4 (j / 4) + 3
// of row i: word w belongs to key 4 (j / 4) + w.
__device__ __forceinline__ uint4 dropout_words(unsigned long long seed, uint32_t b,
                                               uint32_t h, uint32_t i, uint32_t j) {
  return philox4x32_10(j >> 2, i, h, b, seed);
}

// The bits of element (b, h, i, j).
__device__ __forceinline__ uint32_t dropout_bits(unsigned long long seed, uint32_t b,
                                                 uint32_t h, uint32_t i, uint32_t j) {
  const uint4 c = dropout_words(seed, b, h, i, j);
  const uint32_t w = j & 3u;
  return w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
}

// The bits of the four elements that a lane holds of n8 tile n in a warp's
// 16-row mma.m16n8k16 accumulator (mma_bf16.cuh): rows row0 + g and
// row0 + g + 8 (g = lane / 4), keys 8n + 2t and 8n + 2t + 1 (t = lane % 4),
// in the fragment's order c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8,
// 2t+1). Lanes t and t ^ 1 need the same two Philox calls (one counter per
// row and group of four keys): the even lane makes row g's, the odd lane
// row g + 8's, and each sends the other the two words it needs, so one
// call a lane covers its four elements. Every lane of the warp must call
// it with the same n (shuffles).
__device__ __forceinline__ void fragment_dropout_bits(uint32_t (&bits)[4],
                                                      unsigned long long seed, uint32_t b,
                                                      uint32_t h, int row0, int n, int lane) {
  const int g = lane / 4, t4 = lane % 4;
  const bool odd = t4 & 1;
  const uint32_t row = row0 + g + (odd ? 8 : 0);
  const uint4 w = dropout_words(seed, b, h, row, n * 8 + 2 * t4);
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  bits[0] = odd ? got0 : w.x;  // row g
  bits[1] = odd ? got1 : w.y;
  bits[2] = odd ? w.z : got0;  // row g + 8
  bits[3] = odd ? w.w : got1;
}

}  // namespace d2r
