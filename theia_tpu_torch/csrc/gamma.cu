// Gamma(alpha, 1) draws by Cheng's GA rejection, the lanes' new RNG dims
// included, in two launches a call and no host wait.
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
// every later draw of the path turns on R. A block takes its lanes' largest
// 1 + 2 rounds into one atomicMax on a word tagged with the call's number
// (the wrapper's, so the word needs no fill before a call); advance_dims
// then writes dim + 1 + 2R for every lane, launched as the draws'
// programmatic dependent (Hopper's griddepcontrol), so it is scheduled
// while their last blocks run and waits on the card for their end.
//
// The draws are the lane's own generator's, by template: Philox through
// csrc/philox.cuh with the lane's key set up once for all of its draws,
// Owen-scrambled Sobol (its Philox tail past the table too) through
// csrc/sobol.cuh.
//
// What bounds it on an H100: operations. A lane reads alpha, its stream and
// dim (12 bytes) and writes x and its new dim (8); a lane sets up its
// Philox key once (25 integer operations, PHILOX_KEY_OPS in chip_smoke.py),
// a round costs two draws (36 each, PHILOX_DRAW_OPS) and 15 float
// operations with two logs and an exp (GAMMA_ROUND_FLOP); a lane takes
// 1.16 rounds on average at the 1 TeV EM cascade's alpha_long of 6.38
// (Cheng's GA accepts with probability > 1/3, more at large alpha; counted
// by the plain version in chip_smoke.py phase 3m). Design: a thread a lane
// runs round 1 in registers; the lanes it rejects (about 14 % at 6.38, and
// every lane whose alpha never accepts) go to a queue in shared memory,
// which the block's threads drain, each lane at its own round, so a warp
// no longer waits for its slowest of 32 lanes; one atomicMax a block.
// The designs that lost to this one in turns (one cooperative launch with
// a grid-wide barrier, the second launch not dependent, no queue, the
// Philox key set up for every draw) are patches of this file in
// tools/card_measure.py (GAMMA_TRACK_BUILDS).

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
  struct Lane {
    theia::PhiloxKey key;
    theia::PhiloxBase base;
    uint32_t idx;
    __device__ __forceinline__ float draw(uint32_t d) const { return theia::philox_keyed(key, base, d); }
  };
  __device__ __forceinline__ uint32_t index(uint32_t stream) const { return stream; }
  __device__ __forceinline__ Lane lane(uint32_t idx) const { return Lane{theia::philox_key(base, idx), base, idx}; }
};

struct SobolGen {
  theia::SobolArgs args;
  struct Lane {
    theia::SobolArgs args;
    uint32_t idx;
    __device__ __forceinline__ float draw(uint32_t d) const { return theia::sobol_draw(args, idx, d); }
  };
  __device__ __forceinline__ uint32_t index(uint32_t stream) const { return theia::sobol_index(args, stream); }
  __device__ __forceinline__ Lane lane(uint32_t idx) const { return Lane{args, idx}; }
};

// a lane's constants of Cheng's rejection
struct Cheng {
  float a_eff, lam, b, c, scale;
};

// round r of a lane: its candidate in *x, whether it accepts
template <class Lane>
__device__ __forceinline__ bool accepts(const Lane& lane, uint32_t d, int r, const Cheng& k, float* x) {
  float u1 = lane.draw(d + 1u + 2u * r);
  const float u2 = lane.draw(d + 2u + 2u * r);
  u1 = fminf(fmaxf(u1, kClipLo), kClipHi);
  const float v = logf(u1 / (1.0f - u1)) / k.lam;
  *x = k.a_eff * expf(v);
  return k.b + k.c * v - *x >= logf(u1 * u1 * u2);
}

// rounds r, r + 1, ... of a lane to its acceptance; writes x, returns 1 + 2 rounds
template <class Lane>
__device__ __forceinline__ int finish(const Lane& lane, uint32_t d, int r, const Cheng& k, float* out) {
  for (; r < kMaxRounds; ++r) {
    float x;
    if (accepts(lane, d, r, k, &x)) {
      *out = k.scale * x;
      return 3 + 2 * r;
    }
  }
  *out = k.scale * __int_as_float(0x7fc00000);  // NaN: no round accepted
  return 1 + 2 * kMaxRounds;
}

// the lanes of a block that round 1 rejected
struct Queue {
  int count;
  int lane[kThreads];
  uint32_t idx[kThreads], dim[kThreads];
  float a_eff[kThreads], lam[kThreads], b[kThreads], c[kThreads], scale[kThreads];
};

// round 1 of lane i: x where it accepts, else the lane into the block's
// queue; returns 1 + 2 rounds where it accepted, else 0
template <class Gen>
__device__ __forceinline__ int first_round(const Gen& gen, const float* __restrict__ alpha, int alpha_stride,
                                           const int* __restrict__ stream, const int* __restrict__ dim, int i,
                                           float* __restrict__ out, Queue& q) {
  const float a = alpha[static_cast<size_t>(i) * alpha_stride];
  const uint32_t idx = gen.index(static_cast<uint32_t>(stream[i]));
  const uint32_t d = static_cast<uint32_t>(dim[i]);
  const auto lane = gen.lane(idx);
  const float u0 = lane.draw(d);
  const bool small = a < 1.0f;
  Cheng k;
  // max(alpha, 1e-6): a NaN alpha is not small, so its scale is 1 either way
  k.scale = small ? powf(u0, 1.0f / fmaxf(a, 1e-6f)) : 1.0f;
  k.a_eff = small ? a + 1.0f : a;
  k.lam = sqrtf(2.0f * k.a_eff - 1.0f);
  k.b = k.a_eff - kLog4;
  k.c = k.a_eff + k.lam;
  float x;
  if (accepts(lane, d, 0, k, &x)) {
    out[i] = k.scale * x;
    return 3;
  }
  const int s = atomicAdd(&q.count, 1);
  q.lane[s] = i;
  q.idx[s] = idx;
  q.dim[s] = d;
  q.a_eff[s] = k.a_eff;
  q.lam[s] = k.lam;
  q.b[s] = k.b;
  q.c[s] = k.c;
  q.scale[s] = k.scale;
  return 0;
}

// the queue's lanes, a thread each, from round 2 on; returns 1 + 2 rounds
template <class Gen>
__device__ __forceinline__ int drain(const Gen& gen, const Queue& q, float* __restrict__ out) {
  const int s = threadIdx.x;
  if (s >= q.count) return 0;
  const Cheng k{q.a_eff[s], q.lam[s], q.b[s], q.c[s], q.scale[s]};
  return finish(gen.lane(q.idx[s]), q.dim[s], 1, k, out + q.lane[s]);
}

// the block's largest 1 + 2 rounds into *sync, tagged: one atomicMax a block
__device__ __forceinline__ void block_max_into(unsigned long long* sync, unsigned long long tag, int adv,
                                               int* block_max) {
  adv = __reduce_max_sync(0xffffffffu, adv);
  if ((threadIdx.x & 31) == 0) atomicMax(block_max, adv);
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(sync, tag << 32 | static_cast<unsigned>(*block_max));
}

// a block a tile of lanes; sync: the call's tag << 32 | the largest 1 + 2
// rounds, read by advance_dims
template <class Gen>
__global__ void __launch_bounds__(kThreads) sample_gamma(
    Gen gen, const float* __restrict__ alpha, int alpha_stride, const int* __restrict__ stream,
    const int* __restrict__ dim, int n, float* __restrict__ out, unsigned long long* sync,
    unsigned long long tag) {
  __shared__ Queue q;
  __shared__ int block_max;
  asm volatile("griddepcontrol.launch_dependents;");
  if (threadIdx.x == 0) {
    block_max = 0;
    q.count = 0;
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int adv = i < n ? first_round(gen, alpha, alpha_stride, stream, dim, i, out, q) : 0;
  __syncthreads();
  adv = max(adv, drain(gen, q, out));
  block_max_into(sync, tag, adv, &block_max);
}

// the lanes' new dims, after the draws; launched as the draws'
// programmatic dependent, it waits here for their end
__global__ void __launch_bounds__(kThreads) advance_dims(const int* __restrict__ dim, const unsigned long long* sync,
                                                         int n, int* __restrict__ dim_out) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) dim_out[i] = dim[i] + static_cast<int>(*sync & 0xffffffffu);
}

template <class Gen>
int launch(Gen gen, const float* alpha, int alpha_stride, const int* stream, const int* dim, int n, float* out,
           int* dim_out, unsigned long long* sync, unsigned long long tag, cudaStream_t cuda_stream) {
  if (n <= 0) return 0;
  const int tiles = (n + kThreads - 1) / kThreads;
  sample_gamma<Gen><<<tiles, kThreads, 0, cuda_stream>>>(gen, alpha, alpha_stride, stream, dim, n, out, sync, tag);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles);
  config.blockDim = dim3(kThreads);
  config.stream = cuda_stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, advance_dims, dim,
                                             static_cast<const unsigned long long*>(sync), n, dim_out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// dim_out: the lanes' new dims; sync: one word on the card, zero when
// first used, kept by the caller for its later calls on the same stream;
// tag: the call's number on that stream, 1, 2, ... below 2^32, in the
// order of the calls' launches
extern "C" int theia_gamma_philox(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1, uint32_t c2,
                                  uint32_t c3, const float* alpha, int alpha_stride,
                                  const int* stream, const int* dim, int n, float* out, int* dim_out,
                                  unsigned long long* sync, unsigned long long tag,
                                  cudaStream_t cuda_stream) {
  const PhiloxGen gen{theia::PhiloxBase{k0, k1, c0, c1, c2, c3}};
  return launch(gen, alpha, alpha_stride, stream, dim, n, out, dim_out, sync, tag, cuda_stream);
}

extern "C" int theia_gamma_sobol(const void* bytes, int dims, uint32_t seed, uint32_t shuffle_seed,
                                 uint32_t seed_hash, uint32_t offset, const float* alpha,
                                 int alpha_stride, const int* stream, const int* dim, int n,
                                 float* out, int* dim_out, unsigned long long* sync,
                                 unsigned long long tag, cudaStream_t cuda_stream) {
  const SobolGen gen{theia::SobolArgs{static_cast<const uint32_t*>(bytes),
                                      static_cast<uint32_t>(dims), seed, shuffle_seed, seed_hash,
                                      offset}};
  return launch(gen, alpha, alpha_stride, stream, dim, n, out, dim_out, sync, tag, cuda_stream);
}
