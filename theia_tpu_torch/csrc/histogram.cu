// Time-binned histogram record and its backward, a gather of the state's
// gradient.
//
// Replaces theia_tpu/response.py HistogramHitResponse.record (l.226-242),
// which accumulates by a one-hot matmul on the TPU (a scatter-add above
// 1024 flat bins): bin = floor((t - t0) / binSize) with IEEE division,
// lanes that are masked, out of [0, nBins) or (with a detector axis) carry
// an object id out of [0, nDetectors) are dropped, and the rest add their
// value to state[det * nBins + bin]. The backward replaces the VJP of that
// product, which JAX derives itself: d state[k] / d value[i] is 1 where
// lane i lands in bin k, so grad_value[i] = grad_state[det_i * nBins +
// bin_i] on kept lanes and 0 on dropped ones (time and mask take no
// gradient, as the bins come from a floor of the detached time).
//
// What bounds them on an H100: bytes. A lane is 9 bytes of mask, time and
// value (13 with object ids; the backward reads 5 or 9 and writes 4)
// against some ten float operations; at the tracer's 262,144 to 524,288
// lanes that is a microsecond or two, the order of a launch. Of a
// flagship batch's 19 records the ten of the primary hits keep next to no
// lane, so what must move there is the mask and little else; the nine of
// the guided hits keep 1 to 43 % of their lanes, in 87 to 97 bins.
//
// The record adds in the fixed order of csrc/ordered_sum.cuh, so a light
// curve is the same bits on every run of the same inputs: a warp's span of
// 128 lanes in lane order, the tile's 8 spans, the tiles in 32 groups, the
// groups (response.ordered_bin_sums is its plain twin). Its source here
// reads a span's four rows of 32 lanes (the masks; where one is set, every
// lane's time, ids and value in one round of loads, neighbouring lanes on
// neighbouring addresses), skips a span with no unmasked lane, and hands
// each row's kept lanes to the ordered add; t0 and binSize are read once a
// thread, from device memory so that no host sync is needed. A NaN value
// is added like any other; a NaN time drops its lane. The record's scratch
// (the dense pass's table of tile sums, the sparse pass's lists past one
// range of bins) is allocated by the wrapper.
//
// The backward: a thread takes groups of four neighbouring lanes, reads
// their four mask bytes as one word first and skips every other load of a
// group whose lanes are all masked; time and ids come as 16-byte loads; the
// grid is a few blocks an SM with a loop inside. The host function picks
// the instantiation with 16-byte loads only where every pointer is aligned
// for them (a contiguous view such as x[1:] is not); the other reads lane
// by lane, and only unmasked lanes. Lanes past n read as masked in both, so
// a group never reads out of bounds. It reads grad_state through the
// read-only path (a copy of it staged in shared memory was measured slower:
// the copy and its barrier stand in front of every lane's first load); as
// it sums nothing it is bit-exact against the plain version. Both compute
// the bin with one function.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered_sum.cuh"

namespace {

constexpr int kThreads = 256;
// grid-stride kernels: blocks an SM
constexpr int kBlocksPerSm = 8;

// flat bin of a lane that is not masked, or -1 where the lane is dropped
__device__ __forceinline__ int flat_bin(float time, int det, float t0,
                                        float bin_size, int n_bins,
                                        int n_det) {
  const float bin_f = floorf(__fdiv_rn(time - t0, bin_size));
  // written so that a NaN bin is dropped as well
  if (!(bin_f >= 0.0f && bin_f < static_cast<float>(n_bins))) return -1;
  int bin = static_cast<int>(bin_f);
  if (n_det > 0) {
    if (det < 0 || det >= n_det) return -1;
    bin += det * n_bins;
  }
  return bin;
}

// whether lane j of a group is unmasked, from the group's mask word
__device__ __forceinline__ bool lane_on(unsigned m, int j) {
  return (m >> (8 * j)) & 0xffu;
}

// the mask bytes of lanes 4g .. 4g+3 as one word, byte j for lane 4g+j;
// lanes past n read as 0 (masked)
template <bool kVec>
__device__ __forceinline__ unsigned load_mask(
    const unsigned char* __restrict__ mask, long long g, int n) {
  const long long i = 4 * g;
  if (kVec && i + 4 <= n) {
    return __ldg(reinterpret_cast<const unsigned*>(mask) + g);
  }
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i + j < n) m |= static_cast<unsigned>(mask[i + j]) << (8 * j);
  }
  return m;
}

// p[4g .. 4g+3] into v: one 16-byte load of a whole group, else only the
// lanes that m marks as unmasked (the others keep what v held)
template <bool kVec, typename T, typename T4>
__device__ __forceinline__ void load_group(const T* __restrict__ p,
                                           long long g, int n, unsigned m,
                                           T (&v)[4]) {
  const long long i = 4 * g;
  if (kVec && i + 4 <= n) {
    const T4 q = __ldg(reinterpret_cast<const T4*>(p) + g);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (lane_on(m, j)) v[j] = p[i + j];
  }
}

// what the record and its backward read of a wavefront of n lanes
struct Lanes {
  const float* time;
  const unsigned char* mask;
  const int* object_id;  // read only where n_det > 0
  const float* t0;
  const float* bin_size;
  int n, n_bins, n_det;

  __host__ __device__ long long groups() const {
    return (static_cast<long long>(n) + 3) / 4;
  }
  // flat bins of the state
  __host__ long long state_size() const {
    return static_cast<long long>(n_bins) * (n_det > 0 ? n_det : 1);
  }
};

// the flat bins of group g's four lanes (-1 where dropped), given its
// mask word m != 0
template <bool kVec>
__device__ __forceinline__ void group_bins(const Lanes& in, long long g,
                                           unsigned m, float t0,
                                           float bin_size, int (&bin)[4]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int det[4] = {0, 0, 0, 0};
  load_group<kVec, float, float4>(in.time, g, in.n, m, t);
  if (in.n_det > 0) load_group<kVec, int, int4>(in.object_id, g, in.n, m, det);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bin[j] = lane_on(m, j)
                 ? flat_bin(t[j], det[j], t0, bin_size, in.n_bins, in.n_det)
                 : -1;
  }
}

// the record's items: a kept lane's flat bin and value
struct HistSource {
  const float* value;
  Lanes in;

  template <class Acc>
  __device__ __forceinline__ void span(long long first, const Acc& acc) const {
    constexpr int kRows = ordered::kRowsPerSpan;
    const int lane = threadIdx.x & 31;
    // the rows' masks, then, where one is set, every lane's time, id and
    // value in one round of loads
    bool on[kRows];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + 32 * r + lane;
      on[r] = i < in.n && in.mask[i] != 0;
      any = any || on[r];
    }
    if (!__any_sync(ordered::kAll, any)) return;
    float t[kRows], v[kRows];
    int det[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + 32 * r + lane;
      const bool live = i < in.n;
      t[r] = live ? in.time[i] : 0.0f;
      v[r] = live ? value[i] : 0.0f;
      det[r] = live && in.n_det > 0 ? in.object_id[i] : 0;
    }
    const float t0 = __ldg(in.t0), bin_size = __ldg(in.bin_size);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int bin = on[r] ? flat_bin(t[r], det[r], t0, bin_size, in.n_bins, in.n_det) : -1;
      ordered::add_in_lane_order(acc, bin, v[r]);
    }
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads) histogram_grad(
    const float* __restrict__ grad_state, Lanes in,
    float* __restrict__ grad_value) {
  const float t0 = __ldg(in.t0), bin_size = __ldg(in.bin_size);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < in.groups(); g += stride) {
    const unsigned m = load_mask<kVec>(in.mask, g, in.n);
    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m != 0) {
      int bin[4];
      group_bins<kVec>(in, g, m, t0, bin_size, bin);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (bin[j] >= 0) out[j] = __ldg(grad_state + bin[j]);
      }
    }
    const long long i = 4 * g;
    if (kVec && i + 4 <= in.n) {
      reinterpret_cast<float4*>(grad_value)[g] =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < in.n) grad_value[i + j] = out[j];
      }
    }
  }
}

__global__ void empty_kernel() {}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// whether 16-byte loads are allowed on the lanes' pointers and on `other`,
// the float array that the kernel reads or writes beside them
bool vector_loads(const Lanes& in, const float* other) {
  return aligned(in.time, 16) && aligned(in.mask, 4) && aligned(other, 16) &&
         (in.n_det == 0 || aligned(in.object_id, 16));
}

// blocks of `threads` that the lanes fill at four lanes a thread, at most
// `per_sm` for each SM of the current device; 0 with *err set on failure
int grid_size(const Lanes& in, int threads, int per_sm, cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (*err != cudaSuccess) return 0;
  const long long want = (in.groups() + threads - 1) / threads;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(want < most ? want : most);
}

}  // namespace

// the record; table: scratch of table_floats floats (ordered::batch_bins
// must find a batch in it), counters: ordered::kMaxRanges x
// ordered::kCounters words at 0 (csrc/ordered_sum.cuh)
extern "C" int theia_histogram_add(const float* value, const float* time,
                                   const unsigned char* mask,
                                   const int* object_id, const float* t0,
                                   const float* bin_size, int n, int n_bins,
                                   int n_det, float* table, long long table_floats,
                                   unsigned long long* counters, float* state, cudaStream_t stream) {
  const Lanes in{time, mask, object_id, t0, bin_size, n, n_bins, n_det};
  return static_cast<int>(ordered::record(HistSource{value, in}, n, 1, static_cast<int>(in.state_size()), table,
                                          table_floats, counters, state, stream));
}

extern "C" int theia_histogram_grad(const float* grad_state, const float* time,
                                    const unsigned char* mask,
                                    const int* object_id, const float* t0,
                                    const float* bin_size, int n, int n_bins,
                                    int n_det, float* grad_value,
                                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Lanes in{time, mask, object_id, t0, bin_size, n, n_bins, n_det};
  cudaError_t err = cudaSuccess;
  const int grid = grid_size(in, kThreads, kBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vector_loads(in, grad_value)) {
    histogram_grad<true>
        <<<grid, kThreads, 0, stream>>>(grad_state, in, grad_value);
  } else {
    histogram_grad<false>
        <<<grid, kThreads, 0, stream>>>(grad_state, in, grad_value);
  }
  return static_cast<int>(cudaGetLastError());
}

// a kernel that does nothing, one warp: what a launch alone costs, for the
// scripts that set the kernels' times beside it
extern "C" int theia_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
