// Owen-scrambled Sobol draws, one thread per lane, folded by byte.
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
// What bounds it on an H100. A draw needs 8 bytes read and 4 written and,
// folded by byte, ~21 integer operations (chip_smoke.SOBOL_TABLE_OPS), so
// the bound of a path's call (262,144 lanes, 1-2 draws) is by bytes, ~1 us,
// beside an empty launch's 1.9 us queued. What held the first kernel (a
// thread a lane, the 32-word row folded bit by bit: two shifts make a bit's
// mask, a three-input op applies it; a predicated form compiles to a test,
// a select and an xor) back, measured on the card in turns with builds of
// it (card_measure.py sobol-builds on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6): the fold, 0.0036 of a flagship-brute-sobol
// call's 0.0081 ms queued, where a warp mostly draws one dim (a call draws
// at most 37 distinct dims, no draw past the table); and with the lanes of
// a warp on 32 dims (2^20 random dims) the row's eight 16-byte loads, 32
// L1 wavefronts each, 0.0643 of 0.0726 ms. Design: the fold as four
// independent lookups by the index's bytes in XOR tables of each row
// (random._byte_table, (dims, 4, 256) words, 4 KB a dimension, made once a
// table on the host), ~10 integer operations; the tables of the dims a
// warp draws stay in L1. The index shuffle once a lane, `width` 2 in one
// thread. Rows staged in shared memory (a design measured and dropped) cost the paths'
// short blocks more in barriers than they saved; hashing the scramble seed
// once a call saves nothing measurable.

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
  const uint32_t* bytes;  // (dims, 4, 256) words: random._byte_table of the direction rows
  uint32_t dims, seed, shuffle_seed, seed_hash, offset;
};

__device__ __forceinline__ float sobol_draw(const SobolArgs& a, uint32_t idx, uint32_t d) {
  if (d >= a.dims) {
    const theia::PhiloxBase tail{a.seed, a.seed_hash, 0u, 0u, 0u, 0u};
    return theia::philox_draw(tail, idx, d);
  }
  // the fold a byte of the index at a time: four independent lookups
  const uint32_t* t = a.bytes + static_cast<size_t>(d) * 1024;
  const uint32_t v = __ldg(t + (idx & 0xffu)) ^ __ldg(t + 256 + __byte_perm(idx, 0u, 0x4441)) ^
                     __ldg(t + 512 + __byte_perm(idx, 0u, 0x4442)) ^ __ldg(t + 768 + (idx >> 24));
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

extern "C" int theia_sobol_uniform(const void* bytes, int dims, uint32_t seed,
                                   uint32_t shuffle_seed, uint32_t seed_hash,
                                   uint32_t offset, const int* stream, const int* dim,
                                   int n, int width, float* out,
                                   cudaStream_t cuda_stream) {
  if (n > 0) {
    const SobolArgs a{static_cast<const uint32_t*>(bytes), static_cast<uint32_t>(dims), seed,
                      shuffle_seed, seed_hash, offset};
    sobol_uniform<<<(n + kThreads - 1) / kThreads, kThreads, 0, cuda_stream>>>(
        a, stream, dim, n, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
