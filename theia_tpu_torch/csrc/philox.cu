// Philox 4x32-10 uniform draws, one thread per lane.
//
// Replaces theia_tpu/random.py philox_uniform (with philox4x32,
// _umul32wide and uniform_from_bits), bit-exact: draw `dim` of stream
// `stream` reads word dim % 4 of the block keyed by key + stream (64-bit
// add, the final carry rolls into the low word) at counter + 4 * dim
// (128-bit add, the final carry rolls into the lowest word), mapped to
// min(float(bits) * 2^-32, 1 - 2^-24).
//
// What bounds it on an H100: integer issue. Each draw is ten rounds of two
// 32x32->64 multiplies (__umulhi plus a plain multiply) and a few XORs,
// against 8 bytes read and 4 or 8 written per lane, so it is far from the
// memory roofline. Design: one thread per lane, the whole cipher in
// registers; `width` 2 writes the (dim, dim + 1) pair of uniform2d from
// one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

struct Base {
  uint32_t k0, k1, c0, c1, c2, c3;
};

__device__ __forceinline__ float philox_draw(const Base& b, uint32_t stream,
                                             uint32_t dim) {
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
  const uint32_t word = sel == 0 ? x : sel == 1 ? y : sel == 2 ? z : w;
  // ONE_MINUS_EPSILON = 0x3F7FFFFF, the largest float below 1
  return fminf(__uint2float_rn(word) * 0x1p-32f, __int_as_float(0x3F7FFFFF));
}

__global__ void __launch_bounds__(kThreads) philox_uniform(
    Base base, const int* __restrict__ stream, const int* __restrict__ dim,
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
    const Base base{k0, k1, c0, c1, c2, c3};
    philox_uniform<<<(n + kThreads - 1) / kThreads, kThreads, 0, cuda_stream>>>(
        base, stream, dim, n, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
