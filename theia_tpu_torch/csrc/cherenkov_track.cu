// The backward sample of a Cherenkov track, one thread per lane.
//
// Replaces theia_tpu/light.py CherenkovTrackLightSource.sample_backward
// (jnp code that XLA fused: (N, S, 3) candidates over every lane and
// segment, a cumsum over the segments and a take_along_axis; no Pallas
// kernel), bit-exact with ops/cherenkov_track.py's plain version on the
// card: the same float32 operations in the same order (-fmad=false, IEEE
// sqrt and division), the candidates summed in segment order. Per lane and
// segment: mu = (o - v0) . dir, d_perp = |o - (v0 + mu dir)| (floored at
// 1e-15), mu -= cot d_perp, the emission point v0 + mu dir, the direction
// to the observer, the time t0 (1 - f) + t1 f at f = mu / length, and the
// contribution ft max(cos, 0) / d_perp, zero off the segment (cos = 1 for
// a volume point, whose normal is zero). Pass 1 sums the contributions
// into total; pass 2 runs the sum again and counts the segments whose
// running sum stays below u total: k, capped at S - 1. The lane writes
// total, k and candidate k's position, direction and time.
//
// What bounds it on an H100: operations. A lane reads 36 bytes and writes
// 36; the function needs 32 float32 operations a (lane, segment) pair for a
// volume point and 58 for a lane on a surface (chip_smoke.TRACK_PAIR_FLOP,
// TRACK_SURFACE_FLOP), over every segment once and, in the second pass, up
// to segment k, where the running sum first reaches u total. This kernel
// forms every candidate whole (its point, direction and time) and runs both
// passes over every segment. Design: the segment table (9 floats a segment)
// in shared memory, a tile of kTile segments at a time, every thread of the
// block looping over it; no (N, S) intermediate anywhere.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr int kCols = 9;  // x0, y0, z0, t0, t1, dx, dy, dz, length

struct Lane {
  float ox, oy, oz, nx, ny, nz, ft, cot;
  bool volume;  // zero normal: a volume point
};

struct Candidate {
  float px, py, pz, dx, dy, dz, time, contrib;
};

// max(x, m) that keeps a NaN x, as torch.clamp_min
__device__ __forceinline__ float clamp_min_nan(float x, float m) { return x != x ? x : fmaxf(x, m); }

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ Candidate candidate(const float* s, const Lane& l) {
  Candidate c;
  const float mu0 = dot3(l.ox - s[0], l.oy - s[1], l.oz - s[2], s[5], s[6], s[7]);
  const float ex = l.ox - (s[0] + mu0 * s[5]), ey = l.oy - (s[1] + mu0 * s[6]),
              ez = l.oz - (s[2] + mu0 * s[7]);
  const float d_perp = sqrtf(clamp_min_nan(dot3(ex, ey, ez, ex, ey, ez), 1e-30f));
  const float mu = mu0 - l.cot * d_perp;
  c.px = s[0] + mu * s[5];
  c.py = s[1] + mu * s[6];
  c.pz = s[2] + mu * s[7];
  const float wx = l.ox - c.px, wy = l.oy - c.py, wz = l.oz - c.pz;
  const float w = sqrtf(clamp_min_nan(dot3(wx, wy, wz, wx, wy, wz), 1e-30f));
  c.dx = wx / w;
  c.dy = wy / w;
  c.dz = wz / w;
  const float frac = mu / s[8];
  c.time = s[3] * (1.0f - frac) + s[4] * frac;
  const float cos_nrm = clamp_min_nan(l.volume ? 1.0f : dot3(c.dx, c.dy, c.dz, l.nx, l.ny, l.nz), 0.0f);
  const bool on_seg = (mu >= 0.0f) & (mu <= s[8]);
  c.contrib = l.ft * cos_nrm / d_perp * (on_seg ? 1.0f : 0.0f);
  return c;
}

__global__ void __launch_bounds__(kThreads) track_sample(
    const float* __restrict__ seg, int n_seg, const float* __restrict__ observer,
    const float* __restrict__ normal, const float* __restrict__ ft, const float* __restrict__ cot,
    const float* __restrict__ u, int n, float* __restrict__ total_out, int* __restrict__ k_out,
    float* __restrict__ position, float* __restrict__ direction, float* __restrict__ time) {
  __shared__ float tile[kTile * kCols];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  Lane l{};
  if (live) {
    l.ox = observer[3 * i];
    l.oy = observer[3 * i + 1];
    l.oz = observer[3 * i + 2];
    l.nx = normal[3 * i];
    l.ny = normal[3 * i + 1];
    l.nz = normal[3 * i + 2];
    l.ft = ft[i];
    l.cot = cot[i];
    l.volume = dot3(l.nx, l.ny, l.nz, l.nx, l.ny, l.nz) == 0.0f;
  }
  float total = 0.0f, cum = 0.0f, thresh = 0.0f;
  int k = 0;
  // pass 0 sums the contributions, pass 1 counts the running sums below u total
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && live) thresh = u[i] * total;
    for (int base = 0; base < n_seg; base += kTile) {
      const int count = min(kTile, n_seg - base);
      __syncthreads();
      for (int j = threadIdx.x; j < count * kCols; j += kThreads) tile[j] = seg[base * kCols + j];
      __syncthreads();
      if (!live) continue;
      for (int s = 0; s < count; ++s) {
        const float c = candidate(tile + s * kCols, l).contrib;
        if (pass == 0) {
          total = total + c;
        } else {
          cum = cum + c;
          k += cum < thresh;
        }
      }
    }
  }
  if (!live) return;
  k = min(k, n_seg - 1);
  const Candidate c = candidate(seg + k * kCols, l);
  total_out[i] = total;
  k_out[i] = k;
  position[3 * i] = c.px;
  position[3 * i + 1] = c.py;
  position[3 * i + 2] = c.pz;
  direction[3 * i] = c.dx;
  direction[3 * i + 1] = c.dy;
  direction[3 * i + 2] = c.dz;
  time[i] = c.time;
}

}  // namespace

extern "C" int theia_track_sample(const float* seg, int n_seg, const float* observer,
                                  const float* normal, const float* ft, const float* cot,
                                  const float* u, int n, float* total, int* k, float* position,
                                  float* direction, float* time, cudaStream_t cuda_stream) {
  if (n > 0) {
    track_sample<<<(n + kThreads - 1) / kThreads, kThreads, 0, cuda_stream>>>(
        seg, n_seg, observer, normal, ft, cot, u, n, total, k, position, direction, time);
  }
  return static_cast<int>(cudaGetLastError());
}
