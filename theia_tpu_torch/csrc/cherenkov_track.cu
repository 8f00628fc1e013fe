// The backward sample of a Cherenkov track, one thread per lane, one pass
// over the segments.
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
// a volume point, whose normal is zero). total sums the contributions; k
// counts the segments whose running sum stays below u total, capped at
// S - 1. The lane writes total, k and candidate k's position, direction
// and time.
//
// What bounds it on an H100: operations. A lane reads 36 bytes and writes
// 36; the function needs, a (lane, segment) pair, 29 float32 operations
// off the segment (mu, the perpendicular, its length, the shift, the test)
// and the contribution and the sum on it, with the direction and the
// cosine for a lane on a surface (chip_smoke.track_flop); this kernel's
// pair off the segment also issues the IEEE square root's sequence, the
// clamp's NaN test and two shared loads (its SASS: chip_smoke.py phase 1).
//
// Design. A pair off the segment contributes a zero to a tame lane (the
// row's and the lane's magnitudes bounded, kTame*: ops/cherenkov_track.py
// TAME_*), and adding a zero leaves the running sum's bits as they were
// (it starts at +0 and never becomes -0). So one pass runs the short form
// (mu, d_perp, mu - cot d_perp, the test) over every segment and lists
// the lane's segments on the segment, up to kList of them, in shared
// memory; then the lane forms each listed pair's contribution whole, in
// segment order, for total and the running sums after each, and counts k
// over the runs between listed segments. A lane that is not tame, lists
// more than kList segments or meets a row that is not tame takes the full
// form of every pair in two passes, as its plain version does; its block
// runs those passes only when one of its lanes needs them. The segment
// rows go through shared memory a tile of kTile at a time, as two float4
// a row read as broadcasts; no (N, S) intermediate anywhere. The chosen
// candidate is formed once, whole, from the table in device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // segment rows a tile
constexpr int kList = 16;   // lit segments a lane holds
constexpr int kCols = 9;  // x0, y0, z0, t0, t1, dx, dy, dz, length
// a tame row: |x0|, |y0|, |z0| <= kTamePosition, |dx|, |dy|, |dz| <= kTameDirection;
// a tame lane: |o| <= kTamePosition, |cot| <= kTameCot, |ft|, |n|_1 and
// max(|ft|, 1) max(|n|_1, 1) <= kTameWeight (ops/cherenkov_track.py TAME_*)
constexpr float kTamePosition = 1e15f;
constexpr float kTameDirection = 2.0f;
constexpr float kTameCot = 1e7f;
constexpr float kTameWeight = 1e20f;

struct Lane {
  float ox, oy, oz, nx, ny, nz, ft, cot;
  bool volume;  // zero normal: a volume point
};

struct Candidate {
  float px, py, pz, dx, dy, dz, time;
};

// max(x, m) that keeps a NaN x, as torch.clamp_min
__device__ __forceinline__ float clamp_min_nan(float x, float m) { return x != x ? x : fmaxf(x, m); }

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// the short form of a pair: d_perp and mu after the shift
__device__ __forceinline__ void shifted(const Lane& l, float x0, float y0, float z0, float dx, float dy, float dz,
                                        float* d_perp, float* mu) {
  const float mu0 = dot3(l.ox - x0, l.oy - y0, l.oz - z0, dx, dy, dz);
  const float ex = l.ox - (x0 + mu0 * dx), ey = l.oy - (y0 + mu0 * dy), ez = l.oz - (z0 + mu0 * dz);
  *d_perp = sqrtf(clamp_min_nan(dot3(ex, ey, ez, ex, ey, ez), 1e-30f));
  *mu = mu0 - l.cot * *d_perp;
}

// the emission point v0 + mu dir and the unit direction from it to the observer
__device__ __forceinline__ void aim(const Lane& l, float x0, float y0, float z0, float dx, float dy, float dz, float mu,
                                    Candidate* c) {
  c->px = x0 + mu * dx;
  c->py = y0 + mu * dy;
  c->pz = z0 + mu * dz;
  const float wx = l.ox - c->px, wy = l.oy - c->py, wz = l.oz - c->pz;
  const float w = sqrtf(clamp_min_nan(dot3(wx, wy, wz, wx, wy, wz), 1e-30f));
  c->dx = wx / w;
  c->dy = wy / w;
  c->dz = wz / w;
}

// a pair's contribution, whole; no time, and for a volume point no direction
__device__ __forceinline__ float contribution(const Lane& l, float x0, float y0, float z0, float dx, float dy,
                                              float dz, float length) {
  float d_perp, mu;
  shifted(l, x0, y0, z0, dx, dy, dz, &d_perp, &mu);
  float cos_nrm = 1.0f;
  if (!l.volume) {
    Candidate c;
    aim(l, x0, y0, z0, dx, dy, dz, mu, &c);
    cos_nrm = clamp_min_nan(dot3(c.dx, c.dy, c.dz, l.nx, l.ny, l.nz), 0.0f);
  }
  const bool on_seg = (mu >= 0.0f) & (mu <= length);
  return l.ft * cos_nrm / d_perp * (on_seg ? 1.0f : 0.0f);
}

// the chosen candidate, whole, from its row s
__device__ __forceinline__ Candidate candidate(const float* s, const Lane& l) {
  float d_perp, mu;
  shifted(l, s[0], s[1], s[2], s[5], s[6], s[7], &d_perp, &mu);
  Candidate c;
  aim(l, s[0], s[1], s[2], s[5], s[6], s[7], mu, &c);
  const float frac = mu / s[8];
  c.time = s[3] * (1.0f - frac) + s[4] * frac;
  return c;
}

__device__ __forceinline__ bool tame_lane(const Lane& l) {
  const float n1 = fabsf(l.nx) + fabsf(l.ny) + fabsf(l.nz), f = fabsf(l.ft);
  return (fabsf(l.ox) <= kTamePosition) & (fabsf(l.oy) <= kTamePosition) & (fabsf(l.oz) <= kTamePosition) &
         (fabsf(l.cot) <= kTameCot) & (f <= kTameWeight) & (n1 <= kTameWeight) &
         (fmaxf(f, 1.0f) * fmaxf(n1, 1.0f) <= kTameWeight);
}

// rows base .. base + count - 1 into the tile as (x0, y0, z0, length), (dx, dy, dz, 0); whether one is not tame
__device__ __forceinline__ bool load_tile(const float* __restrict__ seg, int base, int count, float4* tile) {
  bool wild = false;
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const float* s = seg + static_cast<size_t>(base + j) * kCols;
    const float x0 = s[0], y0 = s[1], z0 = s[2], dx = s[5], dy = s[6], dz = s[7];
    tile[2 * j] = make_float4(x0, y0, z0, s[8]);
    tile[2 * j + 1] = make_float4(dx, dy, dz, 0.0f);
    wild |= !((fabsf(x0) <= kTamePosition) & (fabsf(y0) <= kTamePosition) & (fabsf(z0) <= kTamePosition) &
              (fabsf(dx) <= kTameDirection) & (fabsf(dy) <= kTameDirection) & (fabsf(dz) <= kTameDirection));
  }
  return wild;
}

__global__ void __launch_bounds__(kThreads) track_sample(
    const float* __restrict__ seg, int n_seg, const float* __restrict__ observer,
    const float* __restrict__ normal, const float* __restrict__ ft, const float* __restrict__ cot,
    const float* __restrict__ u, int n, float* __restrict__ total_out, int* __restrict__ k_out,
    float* __restrict__ position, float* __restrict__ direction, float* __restrict__ time) {
  __shared__ float4 tile[2 * kTile];
  __shared__ int listed[kList][kThreads];  // a lane's segments on the segment, in order
  __shared__ float running[kList][kThreads];  // the running sum after each
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
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
  const bool tame = live && tame_lane(l);
  int on = 0;  // segments on the segment, listed or not
  bool wild_table = false;
  for (int base = 0; base < n_seg; base += kTile) {
    const int count = min(kTile, n_seg - base);
    __syncthreads();
    wild_table |= __syncthreads_or(load_tile(seg, base, count, tile)) != 0;
    if (!tame) continue;
#pragma unroll 4
    for (int s = 0; s < count; ++s) {
      const float4 p = tile[2 * s], q = tile[2 * s + 1];
      float d_perp, mu;
      shifted(l, p.x, p.y, p.z, q.x, q.y, q.z, &d_perp, &mu);
      if ((mu >= 0.0f) & (mu <= p.w)) {
        if (on < kList) listed[on][t] = base + s;
        ++on;
      }
    }
  }
  const bool slow = live && (!tame || on > kList || wild_table);
  float total = 0.0f;
  int k = 0;
  if (live && !slow) {
    for (int j = 0; j < on; ++j) {
      const float* s = seg + static_cast<size_t>(listed[j][t]) * kCols;
      total = total + contribution(l, s[0], s[1], s[2], s[5], s[6], s[7], s[8]);
      running[j][t] = total;
    }
    const float thresh = u[i] * total;
    float cum = 0.0f;  // the running sum before the first listed segment
    int from = 0;
    for (int j = 0; j < on; ++j) {
      const int e = listed[j][t];
      k += (e - from) * (cum < thresh);
      cum = running[j][t];
      from = e;
    }
    k += (n_seg - from) * (cum < thresh);
  }
  if (__syncthreads_or(slow)) {
    // the full form of every pair: pass 0 sums the contributions, pass 1
    // counts the running sums below u total
    float cum = 0.0f, thresh = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && slow) thresh = u[i] * total;
      for (int base = 0; base < n_seg; base += kTile) {
        const int count = min(kTile, n_seg - base);
        __syncthreads();
        load_tile(seg, base, count, tile);
        __syncthreads();
        if (!slow) continue;
        for (int s = 0; s < count; ++s) {
          const float4 p = tile[2 * s], q = tile[2 * s + 1];
          const float c = contribution(l, p.x, p.y, p.z, q.x, q.y, q.z, p.w);
          if (pass == 0) {
            total = total + c;
          } else {
            cum = cum + c;
            k += cum < thresh;
          }
        }
      }
    }
  }
  if (!live) return;
  k = min(k, n_seg - 1);
  const Candidate c = candidate(seg + static_cast<size_t>(k) * kCols, l);
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
