// Owen-scrambled Sobol draw of one (sample index, dim) pair, shared by
// csrc/sobol.cu and csrc/gamma.cu (whose rejection loop draws from the
// lane's own generator).
//
// Bit-exact with theia_tpu/random.py sobol_owen_uniform (with
// _reverse_bits32, _laine_karras, _nested_uniform_scramble and _hash32):
// the lane's index stream + offset (mod 2^32) is shuffled by a nested
// uniform scramble seeded with hash32(seed ^ 0xA511E9B3) (sobol_index);
// dimension d < dims is the XOR of the direction row d over the shuffled
// index's set bits, folded a byte at a time from the byte tables of
// random._byte_table, then Owen-scrambled with hash32(d ^ hash32(seed));
// dimension d >= dims is the Philox draw of stream = the shuffled index,
// dim = d under key (seed, hash32(seed)) and a zero counter. __brev is
// the same bit reversal as the mask-and-shift form.

#pragma once

#include <cstdint>

#include "philox.cuh"

namespace theia {

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0xD35A2D97u;
  x ^= x >> 15;
  return x;
}

struct SobolArgs {
  const uint32_t* bytes;  // (dims, 4, 256) words: random._byte_table of the direction rows
  uint32_t dims, seed, shuffle_seed, seed_hash, offset;
};

// the lane's shuffled sample index, from its stream (the lane id)
__device__ __forceinline__ uint32_t sobol_index(const SobolArgs& a, uint32_t stream) {
  return nested_uniform_scramble(stream + a.offset, a.shuffle_seed);
}

__device__ __forceinline__ float sobol_draw(const SobolArgs& a, uint32_t idx, uint32_t d) {
  if (d >= a.dims) {
    const PhiloxBase tail{a.seed, a.seed_hash, 0u, 0u, 0u, 0u};
    return philox_draw(tail, idx, d);
  }
  // the fold a byte of the index at a time: four independent lookups
  const uint32_t* t = a.bytes + static_cast<size_t>(d) * 1024;
  const uint32_t v = __ldg(t + (idx & 0xffu)) ^ __ldg(t + 256 + __byte_perm(idx, 0u, 0x4441)) ^
                     __ldg(t + 512 + __byte_perm(idx, 0u, 0x4442)) ^ __ldg(t + 768 + (idx >> 24));
  return uniform_from_bits(nested_uniform_scramble(v, hash32(d ^ a.seed_hash)));
}

}  // namespace theia
