// Owen-scrambled Sobol draws, one thread per lane, folded by byte. The
// draw of one (index, dim) pair is theia::sobol_draw in csrc/sobol.cuh,
// which csrc/gamma.cu shares.
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

#include "sobol.cuh"

namespace {

using theia::SobolArgs;
using theia::sobol_draw;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) sobol_uniform(
    SobolArgs a, const int* __restrict__ stream, const int* __restrict__ dim, int n,
    int width, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t idx = theia::sobol_index(a, static_cast<uint32_t>(stream[i]));
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
