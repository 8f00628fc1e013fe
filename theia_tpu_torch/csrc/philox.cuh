// Philox 4x32-10 draw of one (stream, dim) pair, shared by csrc/philox.cu
// and csrc/sobol.cu (whose dimensions past the direction table draw
// Philox words keyed on the scramble seed).
//
// Bit-exact with theia_tpu/random.py philox_uniform (with philox4x32,
// _umul32wide and uniform_from_bits): draw `dim` of stream `stream` reads
// word dim % 4 of the block keyed by key + stream (64-bit add, the final
// carry rolls into the low word) at counter + 4 * dim (128-bit add, the
// final carry rolls into the lowest word), mapped to
// min(float(bits) * 2^-32, 1 - 2^-24).

#pragma once

#include <cstdint>

namespace theia {

struct PhiloxBase {
  uint32_t k0, k1, c0, c1, c2, c3;
};

// ONE_MINUS_EPSILON = 0x3F7FFFFF, the largest float below 1
__device__ __forceinline__ float uniform_from_bits(uint32_t word) {
  return fminf(__uint2float_rn(word) * 0x1p-32f, __int_as_float(0x3F7FFFFF));
}

__device__ __forceinline__ float philox_draw(const PhiloxBase& b, uint32_t stream,
                                             uint32_t dim) {
  constexpr uint32_t kM0 = 0xD2511F53u;
  constexpr uint32_t kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u;
  constexpr uint32_t kW1 = 0xBB67AE85u;
  // 128-bit counter += 4 * dim, final carry rolls into the lowest word
  const uint32_t inc = dim << 2;
  uint32_t c0 = b.c0 + inc;
  uint32_t carry = c0 < inc;
  uint32_t c1 = b.c1 + carry;
  carry = c1 < carry;
  uint32_t c2 = b.c2 + carry;
  carry = c2 < carry;
  uint32_t c3 = b.c3 + carry;
  carry = c3 < carry;
  c0 += carry;
  // 64-bit key += stream, final carry rolls into the low word
  uint32_t k0 = b.k0 + stream;
  carry = k0 < stream;
  uint32_t k1 = b.k1 + carry;
  carry = k1 < carry;
  k0 += carry;

  uint32_t x = c0, y = c1, z = c2, w = c3;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, x), lo0 = kM0 * x;
    const uint32_t hi1 = __umulhi(kM1, z), lo1 = kM1 * z;
    x = hi1 ^ y ^ k0;
    z = hi0 ^ w ^ k1;
    y = lo1;
    w = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  const uint32_t sel = dim & 3u;
  return uniform_from_bits(sel == 0 ? x : sel == 1 ? y : sel == 2 ? z : w);
}

}  // namespace theia
