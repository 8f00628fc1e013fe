// The kernel histogram (binned KDE) record and its backward.
//
// Replaces theia_tpu/response.py KernelHistogramHitResponse.record
// (l.282-300), a jnp loop of 2 * support + 1 = 9 scatter-adds that XLA
// fuses, and the VJP that JAX derives for it. A lane's centre is c = (t -
// t0) / binSize on the detached time, its base bin floor(c); each bin b of
// base - support .. base + support in [0, nBins) gets value * w_b with w_b
// = exp(-z_b^2 / 2) * binSize / (h sqrt(2 pi)), z_b = (bc_b - t) / h at the
// bin centre bc_b = (b + 1/2) * binSize + t0. Masked lanes, ids out of
// [0, nDetectors) and lanes whose centre is not finite are dropped (the
// last a deliberate divergence: theia_tpu casts such a centre to an
// integer; ops and tests in response.py). The backward takes the state's
// gradient g: d value = sum_b g_b w_b and d t = sum_b g_b value w_b z_b / h
// a lane, d t0 = - sum of d t, d binSize = sum g_b value (w_b / binSize -
// w_b z_b (b + 1/2) / h) and d bandwidth = sum g_b value w_b (z_b^2 - 1) / h
// over lanes and bins.
//
// What bounds them on an H100. A lane reads 9 bytes of mask, time and
// value (13 with ids) and evaluates nine exponentials: some 15 float
// operations and one MUFU exp a bin, ~140 a lane, against 9 to 13 bytes
// (the state, 100 floats, stays on chip). The backward reads the same lanes
// and the state's gradient, writes two floats a lane and three scalars, and
// does some 25 operations a bin. What the record's calls on the paths are
// (card_measure.py kde-builds and chip_smoke.py's kde_call_stats on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6): of a volume gradient
// step's 21 calls of 262,144 lanes, 12 keep no lane and the others up to
// 19 %; of a geometry step's 19 (of 262,144 or 524,288 lanes), seven keep
// 1.8-43 % over 91-101 base bins and the others at most 0.5 %. So a call
// is mostly its launch (1.9 us queued empty) and its reads: the adds are
// 0.0007 ms of a volume call's 0.0048 and 0.0011 of a geometry call's
// 0.0067. A shared float add compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN), which retries whenever lanes of a warp meet at one
// address: with every lane in one bin, 0.126 ms for 524,288 lanes against
// 0.012 without the adds; no path's call looks like that.
//
// Design, after csrc/histogram.cu: a thread a lane in a grid of a few
// blocks an SM with a loop; t0, binSize and the bandwidth are read once a
// thread from device memory (no host sync); the record adds into a
// block-private histogram in shared memory (zeroed at every launch), then
// adds each bin whose sum is not zero to the state with one global atomic;
// states above kSharedMaxFloats add straight to the state. Five other
// designs of the record were timed on the paths' calls in turns with this
// one and lost there (PERF.md section 6): a warp's or a block's list of kept
// lanes for full warps (fewer warps an SM hid less latency, and full warps
// of kept lanes with clustered times meet in the CAS loop), masks read 2 to
// 8 lanes a load, each lane's run of bins started at its rank among the
// lanes on its bins, a warp on one bin summed by shuffles (the match alone
// cost a geometry call 0.0013 ms); they won on dense or one-bin records,
// which no path makes. The backward stages the state's gradient in shared
// memory once a block (a few hundred
// floats on the port's paths; read from device memory past
// kGradStageMaxFloats), writes a lane's two gradients without atomics, and
// sums the three scalars over the block (warp shuffles, then one warp)
// into one atomic a block each. A warp that ran each of its lanes' nine
// bins in the thread that read the lane would run the bin loop whenever one
// of its lanes was kept, and a tracer keeps a share of its lanes; so a
// block lists its kept lanes in shared memory and deals them a round of
// threads at a time (PERF.md section 6 has the measurements), and the three
// gradient terms divided by h take a reciprocal of h
// taken once a thread (an ulp apart from the divisions; z itself is still
// divided, as the record divides it). The arithmetic otherwise repeats the
// plain versions' float32 ops in their order (built with -fmad=false);
// atomics make the order of the state's and the scalars' sums change from
// run to run, so they agree with the plain versions' sequential sums to
// float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSmemPerSm = 227 * 1024;
// the largest state kept in a block's shared memory, in flat bins; equals
// response.SHARED_STATE_MAX and csrc/histogram.cu's kSharedMaxFloats
constexpr int kSharedMaxFloats = (kSmemPerSm - 1024) / 4;
// sqrt(2 pi) rounded to float32, as jnp.sqrt(2.0 * jnp.pi) gives it
constexpr float kSqrt2Pi = 2.5066282749176025f;

struct Lanes {
  const float* value;
  const float* time;
  const unsigned char* mask;
  const int* object_id;  // read only where n_det > 0
  const float* t0;
  const float* bin_size;
  const float* bandwidth;
  int n, n_bins, n_det, support;

  long long state_size() const {
    return static_cast<long long>(n_bins) * (n_det > 0 ? n_det : 1);
  }
};

struct Params {
  float t0, bin_size, h;
};

__device__ __forceinline__ Params params(const Lanes& in) {
  return Params{__ldg(in.t0), __ldg(in.bin_size), __ldg(in.bandwidth)};
}

// a lane's inputs (the backward reads them a round ahead): time and value
// only where unmasked
struct LaneIn {
  bool mask;
  float t, value;
  int id;
};

__device__ __forceinline__ LaneIn lane_in(const Lanes& in, long long i) {
  LaneIn a{false, 0.0f, 0.0f, 0};
  if (i >= in.n || !in.mask[i]) return a;
  a.mask = true;
  a.t = in.time[i];
  a.value = in.value[i];
  if (in.n_det > 0) a.id = in.object_id[i];
  return a;
}

// whether the lane of inputs `a` is kept; then its base bin (as a float)
// and the flat offset of its detector's histogram
__device__ __forceinline__ bool kept(const Lanes& in, const LaneIn& a, const Params& p, float* base,
                                     int* offset) {
  if (!a.mask) return false;
  const float center = __fdiv_rn(a.t - p.t0, p.bin_size);
  if (!isfinite(center)) return false;
  *offset = 0;
  if (in.n_det > 0) {
    if (a.id < 0 || a.id >= in.n_det) return false;
    *offset = a.id * in.n_bins;
  }
  *base = floorf(center);
  return true;
}

// z = (bc - t) / h at the centre of bin bf
__device__ __forceinline__ float z_of(const Params& p, float bf, float t) {
  const float bc = (bf + 0.5f) * p.bin_size + p.t0;
  return __fdiv_rn(bc - t, p.h);
}

__device__ __forceinline__ bool in_range(float bf, int n_bins) {
  return bf >= 0.0f && bf < static_cast<float>(n_bins);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    kde_add(Lanes in, int n_state, float* __restrict__ state) {
  extern __shared__ float hist[];
  float* dst = state;
  if (kShared) {
    for (int k = threadIdx.x; k < n_state; k += kThreads) hist[k] = 0.0f;
    __syncthreads();
    dst = hist;
  }
  const Params p = params(in);
  const float norm = __fdiv_rn(p.bin_size, p.h * kSqrt2Pi);
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < in.n; i += stride) {
    const LaneIn a = lane_in(in, i);
    float base;
    int offset;
    if (!kept(in, a, p, &base, &offset)) continue;
    const float t = a.t, v = a.value;
    for (int o = -in.support; o <= in.support; ++o) {
      const float bf = base + static_cast<float>(o);
      if (!in_range(bf, in.n_bins)) continue;
      const float z = z_of(p, bf, t);
      const float w = expf(-0.5f * (z * z)) * norm;
      const float add = v * w;
      if (add != 0.0f) atomicAdd(dst + offset + static_cast<int>(bf), add);
    }
  }
  if (kShared) {
    // every thread arrives here: the loop has no return
    __syncthreads();
    for (int k = threadIdx.x; k < n_state; k += kThreads) {
      const float sum = hist[k];
      if (sum != 0.0f) atomicAdd(state + k, sum);  // a NaN sum is added too
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// the backward: blocks of kGradThreads, kGradBlocksPerSm an SM; a block's
// list of kept lanes holds two rounds of lanes
constexpr int kGradThreads = 256;
constexpr int kGradBlocksPerSm = 4;
constexpr int kQueue = 2 * kGradThreads;

struct Queue {
  int lane[kQueue], offset[kQueue];
  float t[kQueue], base[kQueue], value[kQueue];
};

// the largest state the backward stages beside its list, in flat bins
constexpr int kGradStageMaxFloats = (kSmemPerSm - static_cast<int>(sizeof(Queue)) - 1024) / 4;

// A kept lane's bins, in the plain version's order: its two gradients
// written, its terms of the three scalars added to the thread's sums. The
// three gradient terms divided by h are taken as products by rh = 1 / h.
__device__ __forceinline__ void kde_lane(const Lanes& in, const float* g_state, const Params& p, float inv,
                                         float norm, float rh, int i, float t, float base, float v,
                                         int offset, float* __restrict__ grad_value,
                                         float* __restrict__ grad_time, float* sums) {
  float dv = 0.0f, dt = 0.0f, dbs = 0.0f, dh = 0.0f;
  for (int o = -in.support; o <= in.support; ++o) {
    const float bf = base + static_cast<float>(o);
    if (!in_range(bf, in.n_bins)) continue;
    const float g = g_state[offset + static_cast<int>(bf)];
    const float z = z_of(p, bf, t);
    const float e = expf(-0.5f * (z * z));
    const float w = e * norm;
    const float gv = g * v;
    dv = dv + g * w;
    dt = dt + gv * w * z * rh;
    dbs = dbs + gv * (e * inv - w * z * (bf + 0.5f) * rh);
    dh = dh + gv * w * (z * z - 1.0f) * rh;
  }
  if (grad_value != nullptr) grad_value[i] = dv;
  if (grad_time != nullptr) grad_time[i] = dt;
  sums[0] += dt, sums[1] += dbs, sums[2] += dh;
}

// The backward. A block takes kGradThreads lanes a round (the next round's
// inputs read before this one's work), writes the dropped lanes' zero
// gradients at once, and appends its kept lanes to a list in shared
// memory (a ballot a warp, the warps' counts summed in warp order); each
// time the list holds a round's worth, every thread takes one of them and
// runs its nine bins, so no thread idles through a bin loop beside a kept
// neighbour. What is left at the end is dealt once more, to the first
// threads.
template <bool kStage>
__global__ void __launch_bounds__(kGradThreads)
    kde_grad(Lanes in, const float* __restrict__ grad_state, int n_state,
             float* __restrict__ grad_value, float* __restrict__ grad_time,
             float* __restrict__ grad_params) {
  extern __shared__ float staged[];
  __shared__ Queue q;
  __shared__ int counts[kGradThreads / 32];
  __shared__ float partial[kGradThreads / 32][3];
  const float* g_state = grad_state;
  if (kStage) {
    for (int k = threadIdx.x; k < n_state; k += kGradThreads) staged[k] = grad_state[k];
    g_state = staged;
  }
  const Params p = params(in);
  const float inv = __fdiv_rn(1.0f, p.h * kSqrt2Pi);
  const float norm = p.bin_size * inv;
  const float rh = __fdiv_rn(1.0f, p.h);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float sums[3] = {0.0f, 0.0f, 0.0f};
  int queued = 0;  // the same in every thread of the block
  const long long step = static_cast<long long>(gridDim.x) * kGradThreads;
  long long i = static_cast<long long>(blockIdx.x) * kGradThreads + threadIdx.x;
  LaneIn next = lane_in(in, i);
  for (; i - threadIdx.x < in.n; i += step) {
    const LaneIn a = next;
    next = lane_in(in, i + step);
    float base = 0.0f;
    int offset = 0;
    const bool ok = kept(in, a, p, &base, &offset);
    if (i < in.n && !ok) {
      if (grad_value != nullptr) grad_value[i] = 0.0f;
      if (grad_time != nullptr) grad_time[i] = 0.0f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();  // also orders the staged state before the first reads
    int at = queued, added = 0;
#pragma unroll
    for (int w = 0; w < kGradThreads / 32; ++w) {
      at += w < warp ? counts[w] : 0;
      added += counts[w];
    }
    if (ok) {
      at += __popc(ballot & ((1u << lane) - 1u));
      q.lane[at] = static_cast<int>(i), q.offset[at] = offset;
      q.t[at] = a.t, q.base[at] = base, q.value[at] = a.value;
    }
    queued += added;
    __syncthreads();
    if (queued >= kGradThreads) {
      const int k = threadIdx.x;
      kde_lane(in, g_state, p, inv, norm, rh, q.lane[k], q.t[k], q.base[k], q.value[k], q.offset[k],
               grad_value, grad_time, sums);
      queued -= kGradThreads;
      __syncthreads();
      if (k < queued) {
        q.lane[k] = q.lane[k + kGradThreads], q.offset[k] = q.offset[k + kGradThreads];
        q.t[k] = q.t[k + kGradThreads], q.base[k] = q.base[k + kGradThreads];
        q.value[k] = q.value[k + kGradThreads];
      }
      __syncthreads();
    }
  }
  if (threadIdx.x < queued) {
    const int k = threadIdx.x;
    kde_lane(in, g_state, p, inv, norm, rh, q.lane[k], q.t[k], q.base[k], q.value[k], q.offset[k],
             grad_value, grad_time, sums);
  }
  if (grad_params == nullptr) return;
  // every thread of the block arrives here
  sums[0] = warp_sum(sums[0]), sums[1] = warp_sum(sums[1]), sums[2] = warp_sum(sums[2]);
  if (lane == 0) {
    partial[warp][0] = sums[0], partial[warp][1] = sums[1], partial[warp][2] = sums[2];
  }
  __syncthreads();
  if (warp == 0) {
    float s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[k] = warp_sum(lane < kGradThreads / 32 ? partial[lane][k] : 0.0f);
    }
    if (lane == 0) {
      atomicAdd(grad_params + 0, -s[0]);  // d t0 = - sum of d t
      atomicAdd(grad_params + 1, s[1]);
      atomicAdd(grad_params + 2, s[2]);
    }
  }
}

int grid_size(int n, int threads, int per_sm, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (*err != cudaSuccess) return 0;
  const long long want = (static_cast<long long>(n) + threads - 1) / threads;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(want < most ? want : most);
}

// dynamic shared memory of `bytes` for kernel k: opted into above 48 KB;
// returns how many such blocks an SM holds, at most kBlocksPerSm
template <class Kernel>
int shared_blocks(Kernel k, int bytes, cudaError_t* err) {
  *err = cudaSuccess;
  if (bytes > 48 * 1024) {
    *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  const int per_sm = kSmemPerSm / (bytes + 1024);
  return per_sm > kBlocksPerSm ? kBlocksPerSm : (per_sm < 1 ? 1 : per_sm);
}

}  // namespace

extern "C" int theia_kde_add(const float* value, const float* time,
                             const unsigned char* mask, const int* object_id,
                             const float* t0, const float* bin_size,
                             const float* bandwidth, int n, int n_bins,
                             int n_det, int support, float* state,
                             cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Lanes in{value, time, mask, object_id, t0, bin_size, bandwidth,
                 n, n_bins, n_det, support};
  const long long n_state = in.state_size();
  cudaError_t err = cudaSuccess;
  if (n_state <= kSharedMaxFloats) {
    const int bytes = static_cast<int>(n_state * sizeof(float));
    const int per_sm = shared_blocks(kde_add<true>, bytes, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = grid_size(n, kThreads, per_sm, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    kde_add<true><<<grid, kThreads, bytes, stream>>>(in, static_cast<int>(n_state), state);
  } else {
    const int grid = grid_size(n, kThreads, kBlocksPerSm, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    kde_add<false><<<grid, kThreads, 0, stream>>>(in, static_cast<int>(n_state), state);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int theia_kde_grad(const float* grad_state, const float* value,
                              const float* time, const unsigned char* mask,
                              const int* object_id, const float* t0,
                              const float* bin_size, const float* bandwidth,
                              int n, int n_bins, int n_det, int support,
                              float* grad_value, float* grad_time,
                              float* grad_params, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Lanes in{value, time, mask, object_id, t0, bin_size, bandwidth,
                 n, n_bins, n_det, support};
  const long long n_state = in.state_size();
  cudaError_t err = cudaSuccess;
  if (n_state <= kGradStageMaxFloats) {
    const int bytes = static_cast<int>(n_state * sizeof(float));
    if (bytes + static_cast<int>(sizeof(Queue)) > 48 * 1024) {
      err = cudaFuncSetAttribute(kde_grad<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int fit = kSmemPerSm / (bytes + static_cast<int>(sizeof(Queue)) + 1024);
    const int grid = grid_size(n, kGradThreads, fit < kGradBlocksPerSm ? (fit < 1 ? 1 : fit) : kGradBlocksPerSm, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    kde_grad<true><<<grid, kGradThreads, bytes, stream>>>(
        in, grad_state, static_cast<int>(n_state), grad_value, grad_time, grad_params);
  } else {
    const int grid = grid_size(n, kGradThreads, kGradBlocksPerSm, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    kde_grad<false><<<grid, kGradThreads, 0, stream>>>(
        in, grad_state, static_cast<int>(n_state), grad_value, grad_time, grad_params);
  }
  return static_cast<int>(cudaGetLastError());
}
