// Owen-scrambled Sobol draws, one thread per lane.
//
// Replaces theia_tpu/random.py sobol_owen_uniform (jnp code that XLA fused
// into the tracers; with _reverse_bits32, _laine_karras,
// _nested_uniform_scramble and _hash32), bit-exact: the lane's sample index
// stream + offset (mod 2^32) is shuffled by a nested uniform scramble
// seeded with hash32(seed ^ 0xA511E9B3); dimension d < dims is the XOR of
// the direction row d over the shuffled index's set bits, Owen-scrambled
// with hash32(d ^ hash32(seed)); dimension d >= dims is the Philox draw of
// stream = the shuffled index, dim = d under key (seed, hash32(seed)) and
// a zero counter (theia::philox_draw, shared with csrc/philox.cu); either
// word becomes a float by uniform_from_bits. __brev is the same bit
// reversal as the mask-and-shift form.
//
// What bounds it on an H100: integer issue. A draw in the table is ~120
// integer operations (the 32-step fold three a step: two shifts build the
// bit's mask, one three-input logic op applies it; the scrambles' four
// multiply-xor steps and the hash), against 8 bytes read and 4 written a
// draw and the 128-byte row, which the read-only cache serves (16 KB at
// 128 dims); so it is far from the memory roofline. Design: one thread per
// lane, the index shuffle once a lane, `width` 2 writes the (dim, dim + 1)
// pair of uniform2d from one launch, the row read as eight 16-byte loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

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
  const uint4* dirs;  // (dims, 32) words, a row as eight uint4
  uint32_t dims, seed, shuffle_seed, seed_hash, offset;
};

__device__ __forceinline__ float sobol_draw(const SobolArgs& a, uint32_t idx, uint32_t d) {
  if (d >= a.dims) {
    const theia::PhiloxBase tail{a.seed, a.seed_hash, 0u, 0u, 0u, 0u};
    return theia::philox_draw(tail, idx, d);
  }
  const uint4* row = a.dirs + static_cast<size_t>(d) * 8;
  uint32_t v = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 w = __ldg(row + q);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = 4 * q + k;
      // all ones where bit b of the index is set
      const uint32_t mask = static_cast<uint32_t>(static_cast<int32_t>(idx << (31 - b)) >> 31);
      v ^= words[k] & mask;
    }
  }
  return theia::uniform_from_bits(nested_uniform_scramble(v, hash32(d ^ a.seed_hash)));
}

__global__ void __launch_bounds__(kThreads) sobol_uniform(
    SobolArgs a, const int* __restrict__ stream, const int* __restrict__ dim, int n,
    int width, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t idx =
      nested_uniform_scramble(static_cast<uint32_t>(stream[i]) + a.offset, a.shuffle_seed);
  const uint32_t d = static_cast<uint32_t>(dim[i]);
  for (int j = 0; j < width; ++j) {
    out[(size_t)i * width + j] = sobol_draw(a, idx, d + j);
  }
}

}  // namespace

extern "C" int theia_sobol_uniform(const void* dirs, int dims, uint32_t seed,
                                   uint32_t shuffle_seed, uint32_t seed_hash,
                                   uint32_t offset, const int* stream, const int* dim,
                                   int n, int width, float* out,
                                   cudaStream_t cuda_stream) {
  if (n > 0) {
    const SobolArgs a{static_cast<const uint4*>(dirs), static_cast<uint32_t>(dims), seed,
                      shuffle_seed, seed_hash, offset};
    sobol_uniform<<<(n + kThreads - 1) / kThreads, kThreads, 0, cuda_stream>>>(
        a, stream, dim, n, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
