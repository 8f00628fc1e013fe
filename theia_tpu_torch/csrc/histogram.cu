// Time-binned histogram record, one thread per hit, atomic accumulation,
// and its backward, a gather of the state's gradient.
//
// Replaces theia_tpu/response.py HistogramHitResponse.record (l.226-242),
// which accumulates by a one-hot matmul on the TPU: bin = floor((t - t0) /
// binSize) with IEEE division, lanes that are masked, out of [0, nBins) or
// (with a detector axis) carry an object id out of [0, nDetectors) are
// dropped, and the rest add their value to state[det * nBins + bin]. The
// backward replaces the VJP of that one-hot product, which JAX derives
// itself: d state[k] / d value[i] is 1 where lane i lands in bin k, so
// grad_value[i] = grad_state[det_i * nBins + bin_i] on kept lanes and 0 on
// dropped ones (time and mask take no gradient, as the bins come from a
// floor of the detached time).
//
// What bounds it on an H100: the read of value/time/mask (9 bytes a lane,
// plus 4 for object ids) and, where many lanes hit few bins, the
// serialisation of float atomics on the same L2 lines. Most lanes of a
// tracer segment are masked, so the atomics are sparse. Design: one thread
// per lane with global atomicAdd into the state the wrapper owns; t0 and
// binSize are read from device memory so no host sync is needed. Atomic
// order varies from run to run, so the sums agree with a sequential sum
// only to float32 rounding. The backward reads the same 9-13 bytes a lane
// and writes 4; its gather hits a state of a few hundred floats that stays
// in L1/L2, and as it sums nothing it is bit-exact against the plain
// version. Both kernels compute the bin with one shared function.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// flat bin of lane i, or -1 where the lane is dropped
__device__ __forceinline__ int flat_bin(int i, const float* __restrict__ time,
                                        const unsigned char* __restrict__ mask,
                                        const int* __restrict__ object_id,
                                        float t0, float bin_size, int n_bins,
                                        int n_det) {
  if (!mask[i]) return -1;
  const float bin_f = floorf(__fdiv_rn(time[i] - t0, bin_size));
  // written so that a NaN bin is dropped as well
  if (!(bin_f >= 0.0f && bin_f < static_cast<float>(n_bins))) return -1;
  int bin = static_cast<int>(bin_f);
  if (n_det > 0) {
    const int det = object_id[i];
    if (det < 0 || det >= n_det) return -1;
    bin += det * n_bins;
  }
  return bin;
}

__global__ void __launch_bounds__(kThreads) histogram_add(
    const float* __restrict__ value, const float* __restrict__ time,
    const unsigned char* __restrict__ mask, const int* __restrict__ object_id,
    const float* __restrict__ t0, const float* __restrict__ bin_size, int n,
    int n_bins, int n_det, float* __restrict__ state) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int bin =
      flat_bin(i, time, mask, object_id, *t0, *bin_size, n_bins, n_det);
  if (bin >= 0) atomicAdd(state + bin, value[i]);
}

__global__ void __launch_bounds__(kThreads) histogram_grad(
    const float* __restrict__ grad_state, const float* __restrict__ time,
    const unsigned char* __restrict__ mask, const int* __restrict__ object_id,
    const float* __restrict__ t0, const float* __restrict__ bin_size, int n,
    int n_bins, int n_det, float* __restrict__ grad_value) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int bin =
      flat_bin(i, time, mask, object_id, *t0, *bin_size, n_bins, n_det);
  grad_value[i] = bin >= 0 ? grad_state[bin] : 0.0f;
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

extern "C" int theia_histogram_grad(const float* grad_state, const float* time,
                                    const unsigned char* mask,
                                    const int* object_id, const float* t0,
                                    const float* bin_size, int n, int n_bins,
                                    int n_det, float* grad_value,
                                    cudaStream_t stream) {
  if (n > 0) {
    histogram_grad<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        grad_state, time, mask, object_id, t0, bin_size, n, n_bins, n_det,
        grad_value);
  }
  return static_cast<int>(cudaGetLastError());
}
