// Philox 4x32-10 draw of one (stream, dim) pair, shared by csrc/philox.cu
// and csrc/sobol.cu (whose dimensions past the direction table draw
// Philox words keyed on the scramble seed).
//
// Bit-exact with theia_tpu/random.py philox_uniform (with philox4x32,
// _umul32wide and uniform_from_bits): draw `dim` of stream `stream` reads
// word dim % 4 of the block keyed by key + stream (64-bit add, the final
// carry rolls into the low word) at counter + 4 * dim (128-bit add, the
// final carry rolls into the lowest word), mapped to
// min(float(bits) * 2^-32, 1 - 2^-24). A caller that draws many dims of
// one stream sets its key up once (philox_key) and draws by the counter
// alone (philox_keyed), as csrc/gamma.cu does; philox_draw is the two in one.

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

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// A stream's key, set up once for all of its draws: key + stream (64-bit
// add, the final carry rolls into the low word) and the ten round keys.
struct PhiloxKey {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKey philox_key(const PhiloxBase& b, uint32_t stream) {
  uint32_t k0 = b.k0 + stream;
  uint32_t carry = k0 < stream;
  uint32_t k1 = b.k1 + carry;
  carry = k1 < carry;
  k0 += carry;
  PhiloxKey k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0;
    k.k1[r] = k1;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return k;
}

// draw `dim` of the stream whose key is `k`, by the counter alone
__device__ __forceinline__ float philox_keyed(const PhiloxKey& k, const PhiloxBase& b, uint32_t dim) {
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

  uint32_t x = c0, y = c1, z = c2, w = c3;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, x), lo0 = kPhiloxM0 * x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, z), lo1 = kPhiloxM1 * z;
    x = hi1 ^ y ^ k.k0[r];
    z = hi0 ^ w ^ k.k1[r];
    y = lo1;
    w = lo0;
  }
  const uint32_t sel = dim & 3u;
  return uniform_from_bits(sel == 0 ? x : sel == 1 ? y : sel == 2 ? z : w);
}

__device__ __forceinline__ float philox_draw(const PhiloxBase& b, uint32_t stream, uint32_t dim) {
  return philox_keyed(philox_key(b, stream), b, dim);
}

// One lane's cursor, as random.py RNGState moves it: uniform() draws at the
// lane's dim and advances it by one (uniform2d is two of them), and a
// lane's dim after a block that the reference's control flow takes only on
// some lanes is trace/core.py merge_dim's: the dim after the block where
// it was taken, the dim before it elsewhere (merged). The key is set up
// once a lane.
struct PhiloxLane {
  PhiloxKey key;
  PhiloxBase base;
  uint32_t dim;

  __device__ __forceinline__ PhiloxLane(const PhiloxBase& b, uint32_t stream, uint32_t dim_)
      : key(philox_key(b, stream)), base(b), dim(dim_) {}

  __device__ __forceinline__ float uniform() { return philox_keyed(key, base, dim++); }

  // merge_dim(after, before, taken): keep the draws since `before` only
  // where `taken`
  __device__ __forceinline__ void merged(uint32_t before, bool taken) {
    if (!taken) dim = before;
  }
};

}  // namespace theia
