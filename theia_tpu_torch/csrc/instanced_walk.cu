// The two-level instanced walk over one group (a prototype mesh and its
// instances): nearest hit and any hit.
//
// Replaces theia_tpu/ops/instanced.py nearest_triangle_instanced (l.618)
// and occluded_instanced (l.602): per group, the candidate cursor
// _next_candidate (l.340), the walk _group_query (l.447) and the prototype
// scan theia_tpu/accel.py nearest_in_soup (l.73), which JAX runs as a
// lax.while_loop over the wavefront with a full-width scan of the boxes and
// of the prototype at every step. Eager PyTorch would take that loop as
// thousands of launches with a host sync each; here a thread walks its lane
// through a group to the end, and the wrapper launches once a group, in
// pack order, each launch reading and updating (t_best, idx_best). The
// plain twins are ops/instanced.nearest_triangle_instanced_plain and
// occluded_instanced_plain; kernel and twin agree bit for bit (the same
// float operations in the same order, -fmad=false, csrc/walk.cuh).
//
// Tables of a group (ops/instanced.GroupPack): tri (T, 9) f32 rows [v0, e1,
// e2] of the prototype in scale-normalized object space; w2o (K, 12) f32
// the scale-normalized world-to-object rows; boxes (6 or 10, n_pad) f32:
// the instances' boxes lo xyz, hi xyz (padding inverted, never entered)
// and, with has_sph, their bounding spheres cx, cy, cz, r^2; base (K,) i32
// the tri_data row of each instance's first triangle.
//
// A lane's cursor (tn, k) starts at (-inf, -1). next_candidate() takes the
// box that comes first in (t_entry, k) order strictly after the cursor and
// that the segment enters before the lane's bound (its nearest hit so far;
// -inf in the any-hit once it has a hit), passing over boxes whose sphere
// the segment provably misses (conservative, as theia_tpu's). The ray goes
// into the candidate's object space (o' = ((m0 ox + m1 oy) + m2 oz) + m3,
// d' likewise without m3, not normalized, so t is the world t) and the
// whole prototype is scanned with the exact test of the soup kernels: a hit
// strictly before the bound, the lowest row on ties; across candidates a
// hit replaces the running one only if strictly closer. The lane is done
// when no box is left.
//
// What bounds it on an H100: the float32 work of the triangle tests (~48
// operations a pair, the whole prototype a candidate) and of the box tests
// (~23, ~20 more for the sphere), counted by the plain twin as the bound.
// A simple kernel first: one thread a lane, the prototype and the boxes
// through the read-only cache (a warp's lanes scan the same row at the
// same step, so a row is one broadcast load). Faster forms (a warp
// cooperating on one lane's prototype scan, the boxes in shared memory,
// the lanes sorted by candidate) are later work.

#include <climits>

#include "walk.cuh"

namespace {

using theia::nmax;
using theia::nmin;
using theia::Ray;

struct Group {
  const float* tri;
  int n_tri;
  const float* w2o;
  const float* boxes;
  bool has_sph;
  const int* base;
  int n_box;
  int n_pad;
};

// The candidate after the cursor (tn, k); (inf, -1) when there is none.
// ops/instanced._next_candidate, operation for operation.
__device__ __forceinline__ void next_candidate(const Group& g, const Ray& r,
                                               float ix, float iy, float iz,
                                               float neg_inv_d2, float bound,
                                               float& tn_io, int& k_io) {
  const float last_tn = tn_io;
  const int last_k = k_io;
  float best_tn = CUDART_INF_F;
  int best_k = INT_MAX;
  const float* __restrict__ b = g.boxes;
  const int p = g.n_pad;
  for (int k = 0; k < g.n_box; ++k) {
    const float lox = __ldg(b + k), loy = __ldg(b + p + k), loz = __ldg(b + 2 * p + k);
    const float hix = __ldg(b + 3 * p + k), hiy = __ldg(b + 4 * p + k),
                hiz = __ldg(b + 5 * p + k);
    float tn, tf;
    theia::slab(lox, loy, loz, hix, hiy, hiz, r, ix, iy, iz, tn, tf);
    bool ok = hix >= lox && tf >= nmax(tn, 0.0f) && tn < bound &&
              (tn > last_tn || (tn == last_tn && k > last_k));
    if (ok && g.has_sph) {
      // the segment against the bounding sphere (a NaN only clears ok)
      const float ocx = r.ox - __ldg(b + 6 * p + k), ocy = r.oy - __ldg(b + 7 * p + k),
                  ocz = r.oz - __ldg(b + 8 * p + k);
      const float bb = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
      const float tc = nmin(nmax(bb * neg_inv_d2, 0.0f), bound);
      const float px = ocx + tc * r.dx, py = ocy + tc * r.dy, pz = ocz + tc * r.dz;
      const float s = (px * px + py * py) + pz * pz;
      const float oc2 = (ocx * ocx + ocy * ocy) + ocz * ocz;
      ok = s <= (__ldg(b + 9 * p + k) * 1.003f + oc2 * 1e-5f) + 1e-9f;
    }
    if (ok && (tn < best_tn || (tn == best_tn && k < best_k))) best_tn = tn, best_k = k;
  }
  tn_io = best_tn;
  k_io = isfinite(best_tn) ? best_k : -1;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(theia::kWalkThreads)
    instanced_walk(const float* __restrict__ origin,
                   const float* __restrict__ direction, Group g, int n_rays,
                   float* __restrict__ t_best_io, int* __restrict__ idx_io) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = theia::load_ray(origin, direction, i);
  const float ix = theia::clamped_rcp(r.dx), iy = theia::clamped_rcp(r.dy),
              iz = theia::clamped_rcp(r.dz);
  const float d2 = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  const float neg_inv_d2 = -__frcp_rn(nmax(d2, 1e-30f));
  float t_best = t_best_io[i];
  int idx = idx_io[i];
  float tn = -CUDART_INF_F;
  int k = -1;
  // the any-hit's lane with a hit takes no candidate (theia_tpu's clamp)
  next_candidate(g, r, ix, iy, iz, neg_inv_d2, (kAnyHit && idx >= 0) ? -CUDART_INF_F : t_best,
                 tn, k);
  while (k >= 0) {
    const float* __restrict__ m = g.w2o + 12 * k;
    Ray q{};
    q.ox = ((__ldg(m + 0) * r.ox + __ldg(m + 1) * r.oy) + __ldg(m + 2) * r.oz) + __ldg(m + 3);
    q.oy = ((__ldg(m + 4) * r.ox + __ldg(m + 5) * r.oy) + __ldg(m + 6) * r.oz) + __ldg(m + 7);
    q.oz = ((__ldg(m + 8) * r.ox + __ldg(m + 9) * r.oy) + __ldg(m + 10) * r.oz) + __ldg(m + 11);
    q.dx = (__ldg(m + 0) * r.dx + __ldg(m + 1) * r.dy) + __ldg(m + 2) * r.dz;
    q.dy = (__ldg(m + 4) * r.dx + __ldg(m + 5) * r.dy) + __ldg(m + 6) * r.dz;
    q.dz = (__ldg(m + 8) * r.dx + __ldg(m + 9) * r.dy) + __ldg(m + 10) * r.dz;
    float best = t_best;
    int j_best = -1;
    for (int j = 0; j < g.n_tri; ++j) {
      float t;
      if (theia::exact_row(q, g.tri + 9 * j, t) && t < best) best = t, j_best = j;
    }
    if (j_best >= 0) t_best = best, idx = __ldg(g.base + k) + j_best;
    next_candidate(g, r, ix, iy, iz, neg_inv_d2,
                   (kAnyHit && idx >= 0) ? -CUDART_INF_F : t_best, tn, k);
  }
  t_best_io[i] = t_best;
  idx_io[i] = idx;
}

template <bool kAnyHit>
int launch(const float* origin, const float* direction, const Group& g, int n_rays,
           float* t_best, int* idx, cudaStream_t stream) {
  const int blocks = (n_rays + theia::kWalkThreads - 1) / theia::kWalkThreads;
  if (blocks > 0) {
    instanced_walk<kAnyHit><<<blocks, theia::kWalkThreads, 0, stream>>>(
        origin, direction, g, n_rays, t_best, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// origin, direction: f32 (n_rays, 3); the group's tables as above (boxes
// (6 + 4 has_sph, n_pad), n_box real ones); t_best: f32 (n_rays,), the
// bound on entry (t_max or the earlier groups' nearest hit) and the nearest
// hit's t on exit; idx: i32 (n_rays,), -1 or the earlier groups' winner on
// entry, the winner's tri_data row on exit
extern "C" int theia_instanced_nearest(const float* origin, const float* direction,
                                       const float* tri, int n_tri, const float* w2o,
                                       const float* boxes, int has_sph, const int* base,
                                       int n_box, int n_pad, int n_rays, float* t_best,
                                       int* idx, cudaStream_t stream) {
  const Group g{tri, n_tri, w2o, boxes, has_sph != 0, base, n_box, n_pad};
  return launch<false>(origin, direction, g, n_rays, t_best, idx, stream);
}

// the same, a lane taking no candidate once idx >= 0: occluded = idx >= 0
extern "C" int theia_instanced_occluded(const float* origin, const float* direction,
                                        const float* tri, int n_tri, const float* w2o,
                                        const float* boxes, int has_sph, const int* base,
                                        int n_box, int n_pad, int n_rays, float* t_best,
                                        int* idx, cudaStream_t stream) {
  const Group g{tri, n_tri, w2o, boxes, has_sph != 0, base, n_box, n_pad};
  return launch<true>(origin, direction, g, n_rays, t_best, idx, stream);
}
