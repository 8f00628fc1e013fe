// Gamma(alpha, 1) draws by Cheng's GA rejection, one thread per lane.
//
// Replaces theia_tpu/ops/gamma.py sample_gamma (a lax.while_loop that XLA
// fused; no Pallas kernel), bit-exact with the plain version of
// ops/gamma.py on the card: the same float32 operations in the same order
// (-fmad=false, libdevice logf/expf/powf/sqrtf, IEEE division). Per lane:
// u0 at the lane's dim, scale = pow(u0, 1 / max(alpha, 1e-6)) and
// a_eff = alpha + 1 where alpha < 1; then round r (0-based) draws u1, u2
// at dims dim + 1 + 2r and dim + 2 + 2r, clips u1 to [1e-7, 1 - 1e-7],
// v = log(u1 / (1 - u1)) / lam, cand = a_eff exp(v), and accepts where
// b + c v - cand >= log(u1 u1 u2). A lane stops at its first acceptance,
// or after 64 rounds with NaN.
//
// theia_tpu draws for every lane until all lanes accepted, so after the
// call every lane's dim is dim + 1 + 2R, R the rounds of the slowest lane;
// every later draw of the path turns on R. Each lane takes 1 + 2 (its
// rounds) into one device int with atomicMax, and the wrapper adds that
// int to the lanes' dims on the device: no host sync.
//
// The draws are the lane's own generator's, by template: Philox through
// csrc/philox.cuh, Owen-scrambled Sobol (its Philox tail past the table
// too) through csrc/sobol.cuh.
//
// What bounds it on an H100: operations. A lane reads alpha, its stream and
// dim (12 bytes) and writes x (4); a lane sets up its Philox key once (25
// integer operations, PHILOX_KEY_OPS in chip_smoke.py), a round costs two
// draws (36 each, PHILOX_DRAW_OPS; this kernel sets the key up again for
// every draw) and 15 float operations with two logs and an exp
// (GAMMA_ROUND_FLOP); a lane takes 1.16 rounds on average at the 1 TeV EM
// cascade's alpha_long of 6.38 (Cheng's GA accepts with probability > 1/3,
// more at large alpha; counted by the plain version in chip_smoke.py phase
// 3m). Design: one thread a lane, the loop in registers, no shared memory;
// the slow lanes of a warp hold it for the warp's longest rejection run.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "sobol.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRounds = 64;
// float32(log(4)) and the clip bounds 1e-7 and float32(1 - 1e-7)
constexpr float kLog4 = 1.38629436f;
constexpr float kClipLo = 1e-7f;
constexpr float kClipHi = 0x1.fffffcp-1f;

struct PhiloxGen {
  theia::PhiloxBase base;
  __device__ __forceinline__ uint32_t index(uint32_t stream) const { return stream; }
  __device__ __forceinline__ float draw(uint32_t idx, uint32_t d) const {
    return theia::philox_draw(base, idx, d);
  }
};

struct SobolGen {
  theia::SobolArgs args;
  __device__ __forceinline__ uint32_t index(uint32_t stream) const {
    return theia::sobol_index(args, stream);
  }
  __device__ __forceinline__ float draw(uint32_t idx, uint32_t d) const {
    return theia::sobol_draw(args, idx, d);
  }
};

template <class Gen>
__global__ void __launch_bounds__(kThreads) sample_gamma(
    Gen gen, const float* __restrict__ alpha, int alpha_stride, const int* __restrict__ stream,
    const int* __restrict__ dim, int n, float* __restrict__ out, int* __restrict__ advance) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float a = alpha[static_cast<size_t>(i) * alpha_stride];
  const uint32_t idx = gen.index(static_cast<uint32_t>(stream[i]));
  const uint32_t d = static_cast<uint32_t>(dim[i]);
  const float u0 = gen.draw(idx, d);
  const bool small = a < 1.0f;
  // max(alpha, 1e-6): a NaN alpha is not small, so its scale is 1 either way
  const float scale = small ? powf(u0, 1.0f / fmaxf(a, 1e-6f)) : 1.0f;
  const float a_eff = small ? a + 1.0f : a;
  const float lam = sqrtf(2.0f * a_eff - 1.0f);
  const float b = a_eff - kLog4;
  const float c = a_eff + lam;
  float x = __int_as_float(0x7fc00000);  // NaN unless a round accepts
  int rounds = kMaxRounds;
  for (int r = 0; r < kMaxRounds; ++r) {
    float u1 = gen.draw(idx, d + 1u + 2u * r);
    const float u2 = gen.draw(idx, d + 2u + 2u * r);
    u1 = fminf(fmaxf(u1, kClipLo), kClipHi);
    const float v = logf(u1 / (1.0f - u1)) / lam;
    const float cand = a_eff * expf(v);
    if (b + c * v - cand >= logf(u1 * u1 * u2)) {
      x = cand;
      rounds = r + 1;
      break;
    }
  }
  out[i] = scale * x;
  atomicMax(advance, 1 + 2 * rounds);
}

template <class Gen>
int launch(const Gen& gen, const float* alpha, int alpha_stride, const int* stream, const int* dim,
           int n, float* out, int* advance, cudaStream_t cuda_stream) {
  if (n > 0) {
    sample_gamma<Gen><<<(n + kThreads - 1) / kThreads, kThreads, 0, cuda_stream>>>(
        gen, alpha, alpha_stride, stream, dim, n, out, advance);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// advance: one int on the card, 0 before the call, max(1 + 2 rounds) after
extern "C" int theia_gamma_philox(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1, uint32_t c2,
                                  uint32_t c3, const float* alpha, int alpha_stride,
                                  const int* stream, const int* dim, int n, float* out,
                                  int* advance, cudaStream_t cuda_stream) {
  const PhiloxGen gen{theia::PhiloxBase{k0, k1, c0, c1, c2, c3}};
  return launch(gen, alpha, alpha_stride, stream, dim, n, out, advance, cuda_stream);
}

extern "C" int theia_gamma_sobol(const void* bytes, int dims, uint32_t seed, uint32_t shuffle_seed,
                                 uint32_t seed_hash, uint32_t offset, const float* alpha,
                                 int alpha_stride, const int* stream, const int* dim, int n,
                                 float* out, int* advance, cudaStream_t cuda_stream) {
  const SobolGen gen{theia::SobolArgs{static_cast<const uint32_t*>(bytes),
                                      static_cast<uint32_t>(dims), seed, shuffle_seed, seed_hash,
                                      offset}};
  return launch(gen, alpha, alpha_stride, stream, dim, n, out, advance, cuda_stream);
}
