// Philox 4x32-10 uniform draws, one thread per lane.
//
// Replaces theia_tpu/random.py philox_uniform (with philox4x32,
// _umul32wide and uniform_from_bits), bit-exact; the draw itself is
// theia::philox_draw in csrc/philox.cuh, which csrc/sobol.cu shares.
//
// What bounds it on an H100: integer issue. Each draw is ten rounds of two
// 32x32->64 multiplies (__umulhi plus a plain multiply) and a few XORs,
// against 8 bytes read and 4 or 8 written per lane, so it is far from the
// memory roofline. Design: one thread per lane, the whole cipher in
// registers; `width` 2 writes the (dim, dim + 1) pair of uniform2d from
// one launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using theia::PhiloxBase;
using theia::philox_draw;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) philox_uniform(
    PhiloxBase base, const int* __restrict__ stream, const int* __restrict__ dim,
    int n, int width, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = static_cast<uint32_t>(stream[i]);
  const uint32_t d = static_cast<uint32_t>(dim[i]);
  for (int j = 0; j < width; ++j) {
    out[(size_t)i * width + j] = philox_draw(base, s, d + j);
  }
}

}  // namespace

extern "C" int theia_philox_uniform(uint32_t k0, uint32_t k1, uint32_t c0,
                                    uint32_t c1, uint32_t c2, uint32_t c3,
                                    const int* stream, const int* dim, int n,
                                    int width, float* out,
                                    cudaStream_t cuda_stream) {
  if (n > 0) {
    const PhiloxBase base{k0, k1, c0, c1, c2, c3};
    philox_uniform<<<(n + kThreads - 1) / kThreads, kThreads, 0, cuda_stream>>>(
        base, stream, dim, n, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
