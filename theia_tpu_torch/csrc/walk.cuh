// What the two walks (csrc/bvh_walk.cu, csrc/instanced_walk.cu) share: the
// clamped reciprocal of a ray's direction, the slab test of a box with
// NaN-propagating minima and maxima, and the exact Moeller-Trumbore test
// of csrc/moller_trumbore.cuh on a triangle given as [v0, e1, e2].
//
// Their plain twins (ops/bvh_traverse.py, ops/instanced.py) take minima and
// maxima with torch.minimum / torch.maximum, which spread a NaN, where
// fminf / fmaxf drop it; nmin / nmax spread it too, so that a lane with a
// NaN in its ray fails the same comparisons in both.

#pragma once

#include "moller_trumbore.cuh"

namespace theia {

constexpr int kWalkThreads = 128;  // a thread a lane

__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// 1 / d, a component below 1e-12 in size clamped to +-1e-12 by its sign (a
// NaN to +1e-12): ops/bvh_traverse.inv_dir
__device__ __forceinline__ float clamped_rcp(float d) {
  const float c = fabsf(d) > 1e-12f ? d : (d < 0.0f ? -1e-12f : 1e-12f);
  return __frcp_rn(c);
}

// where the ray (o, 1/d) enters (tn) and leaves (tf) the box lo/hi
__device__ __forceinline__ void slab(float lox, float loy, float loz, float hix,
                                     float hiy, float hiz, const Ray& r, float ix,
                                     float iy, float iz, float& tn, float& tf) {
  const float t1x = (lox - r.ox) * ix, t2x = (hix - r.ox) * ix;
  const float t1y = (loy - r.oy) * iy, t2y = (hiy - r.oy) * iy;
  const float t1z = (loz - r.oz) * iz, t2z = (hiz - r.oz) * iz;
  tn = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
  tf = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
}

// the exact test of the soup kernels on the triangle row p = [v0, e1, e2]
__device__ __forceinline__ bool exact_row(const Ray& r, const float* __restrict__ p,
                                          float& t) {
  float4 w[5];
  w[2].z = __ldg(p + 8);
  w[3] = make_float4(__ldg(p + 0), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  w[4] = make_float4(__ldg(p + 4), __ldg(p + 5), __ldg(p + 6), __ldg(p + 7));
  return MollerTrumbore::exact(r, w, t);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction, int i) {
  Ray r{};
  r.ox = origin[3 * i], r.oy = origin[3 * i + 1], r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i], r.dy = direction[3 * i + 1], r.dz = direction[3 * i + 2];
  return r;
}

}  // namespace theia
