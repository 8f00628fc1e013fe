// The two-level instanced walk over one group (a prototype mesh and its
// instances): nearest hit and any hit.
//
// Replaces theia_tpu/ops/instanced.py nearest_triangle_instanced (l.618)
// and occluded_instanced (l.602): per group, the candidate cursor
// _next_candidate (l.340), the walk _group_query (l.447) and the prototype
// scan theia_tpu/accel.py nearest_in_soup (l.73), which JAX runs as a
// lax.while_loop over the wavefront with a full-width scan of the boxes and
// of the prototype at every step. Eager PyTorch would take that loop as
// thousands of launches with a host sync each; here a warp walks its 32
// lanes through a group to the end, and the wrapper launches once a group,
// in pack order, each launch reading and updating (t_best, idx_best). The
// plain twins are ops/instanced.nearest_triangle_instanced_plain and
// occluded_instanced_plain; kernel and twin agree bit for bit (the same
// float operations in the same order, -fmad=false, csrc/walk.cuh).
//
// Tables of a group (ops/instanced.GroupPack): rows (4, T, 4) f32, the
// prototype in scale-normalized object space as four planes of 16-byte
// pieces of its Moeller-Trumbore rows (csrc/moller_trumbore.cuh: n, alpha
// | beta_w, beta, e2 z, 0 | v0, e1 x | e1 yz, e2 xy); w2o (K, 12) f32
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
// A lane meets few candidates (0.1-0.3 a ray on the array's rays), so a
// thread that scanned its own lane's prototype left most of its warp idle
// while one lane scanned 1,280 rows. The design:
// - A block stages the group's boxes, and the prototype's rows where they
//   fit ops/instanced.SHARED_MAX bytes with them, in dynamic shared memory
//   (the launch asks for it); a larger prototype is read from global
//   memory in the same order, lane l reading row l + 32 s, so a warp's
//   loads are contiguous.
// - Rounds of the whole block: every lane that holds a candidate moves its
//   ray into the candidate's object space and puts the (lane, candidate)
//   pair in a queue in shared memory; the block's warps take the pairs in
//   turn, and for each the warp scans the prototype together: thread l
//   tests rows l, l + 32, ... against the pair's ray and bound and keeps
//   its least (t, row), and min_hit() (csrc/walk.cuh) picks the warp's
//   least (t, row), which is the winner of the sequential scan (a strict <
//   keeps the lowest row among equal t's). The holder takes the hit as the
//   sequential walk does. A lane has one pair a round and its candidates
//   keep their (t_entry, k) order, so ties across instances fall as before.
//   The queue evens out the warps of a block, whose lanes hold very
//   unequal numbers of candidates (each warp scanning its own lanes' pairs
//   was 15-33 % slower, PERF.md).
// - The first box scan is each lane's own (every lane needs one); the next
//   candidates of the lanes that held one are found lane by lane by their
//   warp, thread l testing boxes l, l + 32, ... (few lanes hold a
//   candidate: each lane scanning all boxes was up to 30 % slower, and 4 %
//   faster only on random rays' nearest hit).
// - In front of the exact test, the soup kernels' rejection test
//   (MollerTrumbore::reject, which never rejects a pair that exact()
//   accepts; tests/test_torch_intersect_filter.py, and on the prototypes
//   in object space tests/test_torch_instanced.py): a 32-row step whose
//   rows are all rejected costs no exact test, which is most steps (a ray
//   meets one or two of a sphere's 1,280 triangles).
// - The any-hit stops a candidate's scan after the first 32-row step in
//   which a thread found a hit (only occluded = idx >= 0 is compared).

#include <climits>

#include "walk.cuh"

namespace {

using theia::kFullMask;
using theia::ld;
using theia::nmax;
using theia::nmin;
using theia::Ray;

using theia::kSlack;
using theia::kWild;

constexpr int kThreads = 512;

struct Group {
  const float4* rows;
  int n_tri;
  const float* w2o;
  const float* boxes;
  bool has_sph;
  const int* base;
  int n_box;
  int n_pad;
};

// Where the tables are read from, as the wrapper picks it from their sizes
// (ops/instanced.placement): kBoxes staged in shared memory, kRows the
// boxes and the prototype's rows, kGlobal neither.
enum Place { kGlobal = 0, kBoxes = 1, kRows = 2 };

__host__ __device__ __forceinline__ int box_floats(const Group& g) {
  return (g.has_sph ? 10 : 6) * g.n_pad;
}

// Whether box k comes after the cursor (last_tn, last_k), lets the segment
// [0, bound) in and (with spheres) may be reached, with its entry tn:
// ops/instanced._next_candidate, operation for operation.
template <bool kShared>
__device__ __forceinline__ bool box_ok(const Group& g, const float* b, const Ray& r,
                                       float ix, float iy, float iz, float neg_inv_d2,
                                       float bound, float last_tn, int last_k, int k,
                                       float& tn) {
  const int p = g.n_pad;
  const float lox = ld<kShared>(b + k), loy = ld<kShared>(b + p + k),
              loz = ld<kShared>(b + 2 * p + k);
  const float hix = ld<kShared>(b + 3 * p + k), hiy = ld<kShared>(b + 4 * p + k),
              hiz = ld<kShared>(b + 5 * p + k);
  float tf;
  theia::slab(lox, loy, loz, hix, hiy, hiz, r, ix, iy, iz, tn, tf);
  bool ok = hix >= lox && tf >= nmax(tn, 0.0f) && tn < bound &&
            (tn > last_tn || (tn == last_tn && k > last_k));
  if (ok && g.has_sph) {
    // the segment against the bounding sphere (a NaN only clears ok)
    const float ocx = r.ox - ld<kShared>(b + 6 * p + k),
                ocy = r.oy - ld<kShared>(b + 7 * p + k),
                ocz = r.oz - ld<kShared>(b + 8 * p + k);
    const float bb = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
    const float tc = nmin(nmax(bb * neg_inv_d2, 0.0f), bound);
    const float px = ocx + tc * r.dx, py = ocy + tc * r.dy, pz = ocz + tc * r.dz;
    const float s = (px * px + py * py) + pz * pz;
    const float oc2 = (ocx * ocx + ocy * ocy) + ocz * ocz;
    ok = s <= (ld<kShared>(b + 9 * p + k) * 1.003f + oc2 * 1e-5f) + 1e-9f;
  }
  return ok;
}

// The candidate after the cursor (tn, k), one lane alone; (inf, -1) when
// there is none (and -1 where the first box's tn is not finite, as the
// plain twin's isfinite).
template <bool kShared>
__device__ __forceinline__ void next_candidate(const Group& g, const float* b, const Ray& r,
                                               float ix, float iy, float iz,
                                               float neg_inv_d2, float bound,
                                               float& tn_io, int& k_io) {
  float best_tn = CUDART_INF_F;
  int best_k = INT_MAX;
  for (int k = 0; k < g.n_box; ++k) {
    float tn;
    if (box_ok<kShared>(g, b, r, ix, iy, iz, neg_inv_d2, bound, tn_io, k_io, k, tn) &&
        (tn < best_tn || (tn == best_tn && k < best_k)))
      best_tn = tn, best_k = k;
  }
  tn_io = best_tn;
  k_io = isfinite(best_tn) ? best_k : -1;
}

// tn's order as an unsigned key (its bits, negatives flipped; -0 as +0,
// which every comparison of the cursor treats alike) and back
__device__ __forceinline__ unsigned order_key(float tn) {
  const unsigned u = __float_as_uint(tn == 0.0f ? 0.0f : tn);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// The same for lane h, by the whole warp: thread l tests boxes l, l + 32,
// ... and the warp takes the least (tn, k), which is next_candidate's.
template <bool kShared>
__device__ __forceinline__ void next_candidate_warp(const Group& g, const float* b,
                                                    const Ray& r, float ix, float iy,
                                                    float iz, float neg_inv_d2, float bound,
                                                    int h, float& tn_io, int& k_io) {
  const Ray q = theia::shfl_ray(r, h);
  const float qix = __shfl_sync(kFullMask, ix, h), qiy = __shfl_sync(kFullMask, iy, h),
              qiz = __shfl_sync(kFullMask, iz, h);
  const float qn = __shfl_sync(kFullMask, neg_inv_d2, h);
  const float qbound = __shfl_sync(kFullMask, bound, h);
  const float last_tn = __shfl_sync(kFullMask, tn_io, h);
  const int last_k = __shfl_sync(kFullMask, k_io, h);
  unsigned long long key = theia::kNoHit;
  for (int k = threadIdx.x & 31; k < g.n_box; k += 32) {
    float tn;
    if (box_ok<kShared>(g, b, q, qix, qiy, qiz, qn, qbound, last_tn, last_k, k, tn)) {
      const unsigned long long kk =
          (static_cast<unsigned long long>(order_key(tn)) << 32) | static_cast<unsigned>(k);
      key = kk < key ? kk : key;
    }
  }
  key = theia::min_hit(key, 32);
  if ((threadIdx.x & 31) == h) {
    const float tn = key == theia::kNoHit ? CUDART_INF_F : from_order_key(key >> 32);
    tn_io = tn;
    k_io = isfinite(tn) ? static_cast<int>(key & 0xffffffffu) : -1;
  }
}

// the ray in the object space of the world-to-object row m
__device__ __forceinline__ Ray to_object(const float* __restrict__ m, const Ray& r) {
  Ray q{};
  q.ox = ((__ldg(m + 0) * r.ox + __ldg(m + 1) * r.oy) + __ldg(m + 2) * r.oz) + __ldg(m + 3);
  q.oy = ((__ldg(m + 4) * r.ox + __ldg(m + 5) * r.oy) + __ldg(m + 6) * r.oz) + __ldg(m + 7);
  q.oz = ((__ldg(m + 8) * r.ox + __ldg(m + 9) * r.oy) + __ldg(m + 10) * r.oz) + __ldg(m + 11);
  q.dx = (__ldg(m + 0) * r.dx + __ldg(m + 1) * r.dy) + __ldg(m + 2) * r.dz;
  q.dy = (__ldg(m + 4) * r.dx + __ldg(m + 5) * r.dy) + __ldg(m + 6) * r.dz;
  q.dz = (__ldg(m + 8) * r.dx + __ldg(m + 9) * r.dy) + __ldg(m + 10) * r.dz;
  return q;
}

// The prototype scanned for one (lane, candidate) pair by the whole warp:
// thread l tests rows l, l + 32, ... of the ray q (in object space, its
// slack in q.kd) strictly before cap, reject() first and exact() where a
// row of the step survives; the warp's least hit_key (kNoHit on a miss).
// The any-hit stops after the first 32-row step in which a thread hit.
template <bool kAnyHit, bool kShared>
__device__ __forceinline__ unsigned long long scan_prototype(const Group& g,
                                                             const float4* rows,
                                                             const Ray& q, float cap) {
  const int lane = threadIdx.x & 31;
  const int n = g.n_tri;
  float best = cap;
  int j_best = -1;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    float4 w[5];
    bool pass = false;
    if (j < n) {
      w[1] = ld<kShared>(rows + j), w[2] = ld<kShared>(rows + n + j);
      w[3] = ld<kShared>(rows + 2 * n + j), w[4] = ld<kShared>(rows + 3 * n + j);
      pass = !theia::MollerTrumbore::reject(q, w);
    }
    if (__any_sync(kFullMask, pass)) {
      float t;
      if (pass && theia::MollerTrumbore::exact(q, w, t) && t < best) best = t, j_best = j;
    }
    if (kAnyHit && __any_sync(kFullMask, j_best >= 0)) break;
  }
  return theia::min_hit(j_best >= 0 ? theia::hit_key(best, j_best) : theia::kNoHit, 32);
}

// A lane's state through a group's walk, and the tables as placed.
template <bool kAnyHit, int kPlace>
struct Lane {
  static constexpr bool kSharedBoxes = kPlace >= kBoxes;
  Ray r;
  float ix, iy, iz, neg_inv_d2, t_best, tn;
  int idx, k;
  bool valid;

  // a lane past the rays (valid false) takes part in the warp's work but
  // holds no candidate
  __device__ __forceinline__ Lane(const float* origin, const float* direction, int i, int n_rays,
                                  const float* t_best_io, const int* idx_io)
      : valid(i < n_rays) {
    r = valid ? theia::load_ray(origin, direction, i) : Ray{};
    ix = theia::clamped_rcp(r.dx), iy = theia::clamped_rcp(r.dy), iz = theia::clamped_rcp(r.dz);
    const float d2 = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
    neg_inv_d2 = -__frcp_rn(nmax(d2, 1e-30f));
    t_best = valid ? t_best_io[i] : 0.0f;
    idx = valid ? idx_io[i] : -1;
    tn = -CUDART_INF_F, k = -1;
  }

  // the any-hit's lane with a hit takes no candidate (theia_tpu's clamp)
  __device__ __forceinline__ float bound() const {
    return (kAnyHit && idx >= 0) ? -CUDART_INF_F : t_best;
  }

  // the first candidate, each lane its own box scan
  __device__ __forceinline__ void first(const Group& g, const float* boxes) {
    if (valid) next_candidate<kSharedBoxes>(g, boxes, r, ix, iy, iz, neg_inv_d2, bound(), tn, k);
  }

  // the next candidates of the lanes in holders, lane by lane, each box
  // scan split over the warp
  __device__ __forceinline__ void next(const Group& g, const float* boxes, unsigned holders) {
    theia::for_each_holder(holders, [&](int h) {
      next_candidate_warp<kSharedBoxes>(g, boxes, r, ix, iy, iz, neg_inv_d2, bound(), h, tn, k);
    });
  }

  // a hit of this lane's candidate scan (key), taken as the sequential walk does
  __device__ __forceinline__ void take(const Group& g, unsigned long long key) {
    if (key != theia::kNoHit) {
      t_best = __uint_as_float(static_cast<unsigned>(key >> 32));
      idx = __ldg(g.base + k) + static_cast<int>(key & 0xffffffffu);
    }
  }
};

// the block's tables, staged as kPlace says: [rows | boxes] (the rows
// first, 16-byte aligned)
template <int kPlace>
__device__ __forceinline__ void stage_tables(const Group& g, float4* staged, const float*& boxes,
                                             const float4*& rows) {
  boxes = g.boxes, rows = g.rows;
  const int planes = kPlace >= kRows ? 4 * g.n_tri : 0;
  if constexpr (kPlace >= kRows) {
    theia::stage(staged, g.rows, planes);
    rows = staged;
  }
  if constexpr (kPlace >= kBoxes) {
    float* b = reinterpret_cast<float*>(staged + planes);
    theia::stage(b, g.boxes, box_floats(g));
    boxes = b;
    __syncthreads();
  }
}

// the rejection tests' slack of the ray q (MollerTrumbore::reject), as
// the soup kernels set it: kSlack * max(|d|_inf, 1), inf for a wild ray
__device__ __forceinline__ float ray_slack(const Ray& q) {
  const float omax = fmaxf(fmaxf(fabsf(q.ox), fabsf(q.oy)), fabsf(q.oz));
  const float dmax = fmaxf(fmaxf(fabsf(q.dx), fabsf(q.dy)), fabsf(q.dz));
  // fmaxf drops a NaN operand, so test the components themselves
  const bool tame = omax < kWild && dmax < kWild && q.ox == q.ox && q.oy == q.oy &&
                    q.oz == q.oz && q.dx == q.dx && q.dy == q.dy && q.dz == q.dz;
  return tame ? kSlack * fmaxf(dmax, 1.0f) : CUDART_INF_F;
}

// Rounds of the whole block: every lane that holds a candidate moves its
// ray into the candidate's object space and puts the pair in the block's
// queue; the warps take the pairs in turn, each scanning the prototype
// for one (scan_prototype); each holder takes its pair's hit; the lanes
// that held one look for their next candidate.
template <bool kAnyHit, int kPlace>
__global__ void __launch_bounds__(kThreads, 2)
    instanced_walk(const float* __restrict__ origin,
                   const float* __restrict__ direction, Group g, int n_rays,
                   float* __restrict__ t_best_io, int* __restrict__ idx_io) {
  extern __shared__ float4 staged[];
  __shared__ float4 item_o[kThreads], item_d[kThreads];  // o' and cap, d' and kd
  __shared__ unsigned long long item_key[kThreads];
  __shared__ int n_items;
  const float* boxes;
  const float4* rows;
  if (threadIdx.x == 0) n_items = 0;
  stage_tables<kPlace>(g, staged, boxes, rows);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  Lane<kAnyHit, kPlace> L(origin, direction, i, n_rays, t_best_io, idx_io);
  L.first(g, boxes);
  while (__syncthreads_or(L.k >= 0)) {
    int slot = -1;
    if (L.k >= 0) {
      const Ray q = to_object(g.w2o + 12 * L.k, L.r);
      slot = atomicAdd(&n_items, 1);
      item_o[slot] = make_float4(q.ox, q.oy, q.oz, L.t_best);
      item_d[slot] = make_float4(q.dx, q.dy, q.dz, ray_slack(q));
    }
    __syncthreads();
    const int items = n_items;
    for (int it = warp; it < items; it += kThreads / 32) {
      const float4 a = item_o[it], b = item_d[it];
      Ray q{};
      q.ox = a.x, q.oy = a.y, q.oz = a.z, q.dx = b.x, q.dy = b.y, q.dz = b.z, q.kd = b.w;
      const unsigned long long key = scan_prototype<kAnyHit, kPlace >= kRows>(g, rows, q, a.w);
      if ((threadIdx.x & 31) == 0) item_key[it] = key;
    }
    __syncthreads();
    if (threadIdx.x == 0) n_items = 0;
    if (slot >= 0) L.take(g, item_key[slot]);
    L.next(g, boxes, __ballot_sync(kFullMask, slot >= 0));
  }
  if (L.valid) t_best_io[i] = L.t_best, idx_io[i] = L.idx;
}

template <bool kAnyHit, int kPlace>
int launch_placed(const float* origin, const float* direction, const Group& g, int n_rays,
                  float* t_best, int* idx, cudaStream_t stream) {
  constexpr auto kernel = instanced_walk<kAnyHit, kPlace>;
  const int bytes = 4 * ((kPlace >= kBoxes ? box_floats(g) : 0) + (kPlace >= kRows ? 16 * g.n_tri : 0));
  const int err = theia::grant_shared<kernel>(bytes);
  if (err != 0) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, bytes, stream>>>(origin, direction, g, n_rays, t_best, idx);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAnyHit>
int launch(const float* origin, const float* direction, const Group& g, int place,
           int n_rays, float* t_best, int* idx, cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  switch (place) {
    case kRows:
      return launch_placed<kAnyHit, kRows>(origin, direction, g, n_rays, t_best, idx, stream);
    case kBoxes:
      return launch_placed<kAnyHit, kBoxes>(origin, direction, g, n_rays, t_best, idx, stream);
    case kGlobal:
      return launch_placed<kAnyHit, kGlobal>(origin, direction, g, n_rays, t_best, idx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// origin, direction: f32 (n_rays, 3); the group's tables as above (boxes
// (6 + 4 has_sph, n_pad), n_box real ones); place: a Place; t_best: f32
// (n_rays,), the bound on entry (t_max or the earlier groups' nearest hit)
// and the nearest hit's t on exit; idx: i32 (n_rays,), -1 or the earlier
// groups' winner on entry, the winner's tri_data row on exit
extern "C" int theia_instanced_nearest(const float* origin, const float* direction,
                                       const float4* rows, int n_tri, const float* w2o,
                                       const float* boxes, int has_sph, const int* base,
                                       int n_box, int n_pad, int place, int n_rays,
                                       float* t_best, int* idx, cudaStream_t stream) {
  const Group g{rows, n_tri, w2o, boxes, has_sph != 0, base, n_box, n_pad};
  return launch<false>(origin, direction, g, place, n_rays, t_best, idx, stream);
}

// the same, a lane taking no candidate once idx >= 0: occluded = idx >= 0
extern "C" int theia_instanced_occluded(const float* origin, const float* direction,
                                        const float4* rows, int n_tri, const float* w2o,
                                        const float* boxes, int has_sph, const int* base,
                                        int n_box, int n_pad, int place, int n_rays,
                                        float* t_best, int* idx, cudaStream_t stream) {
  const Group g{rows, n_tri, w2o, boxes, has_sph != 0, base, n_box, n_pad};
  return launch<true>(origin, direction, g, place, n_rays, t_best, idx, stream);
}
