// Time-binned histogram record, one thread per hit, atomic accumulation.
//
// Replaces theia_tpu/response.py HistogramHitResponse.record (l.226-242),
// which accumulates by a one-hot matmul on the TPU: bin = floor((t - t0) /
// binSize) with IEEE division, lanes that are masked, out of [0, nBins) or
// (with a detector axis) carry an object id out of [0, nDetectors) are
// dropped, and the rest add their value to state[det * nBins + bin].
//
// What bounds it on an H100: the read of value/time/mask (9 bytes a lane,
// plus 4 for object ids) and, where many lanes hit few bins, the
// serialisation of float atomics on the same L2 lines. Most lanes of a
// tracer segment are masked, so the atomics are sparse. Design: one thread
// per lane with global atomicAdd into the state the wrapper owns; t0 and
// binSize are read from device memory so no host sync is needed. Atomic
// order varies from run to run, so the sums agree with a sequential sum
// only to float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) histogram_add(
    const float* __restrict__ value, const float* __restrict__ time,
    const unsigned char* __restrict__ mask, const int* __restrict__ object_id,
    const float* __restrict__ t0, const float* __restrict__ bin_size, int n,
    int n_bins, int n_det, float* __restrict__ state) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const float bin_f = floorf(__fdiv_rn(time[i] - *t0, *bin_size));
  // written so that a NaN bin is dropped as well
  if (!(bin_f >= 0.0f && bin_f < static_cast<float>(n_bins))) return;
  int bin = static_cast<int>(bin_f);
  if (n_det > 0) {
    const int det = object_id[i];
    if (det < 0 || det >= n_det) return;
    bin += det * n_bins;
  }
  atomicAdd(state + bin, value[i]);
}

}  // namespace

extern "C" int theia_histogram_add(const float* value, const float* time,
                                   const unsigned char* mask,
                                   const int* object_id, const float* t0,
                                   const float* bin_size, int n, int n_bins,
                                   int n_det, float* state,
                                   cudaStream_t stream) {
  if (n > 0) {
    histogram_add<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        value, time, mask, object_id, t0, bin_size, n, n_bins, n_det, state);
  }
  return static_cast<int>(cudaGetLastError());
}
