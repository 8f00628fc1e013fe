// The stackless threaded-BVH walk: nearest hit and any hit.
//
// Replaces theia_tpu/ops/bvh_traverse.py nearest_triangle_bvh (l.95) and
// occluded_bvh (l.184), which JAX runs as a lax.while_loop over the whole
// wavefront, one node a step, with a gather of each lane's node row and
// leaf triangles. Eager PyTorch would take that loop as thousands of
// launches with a host sync each; here a thread walks its lane to the end.
// The plain twins are ops/bvh_traverse.nearest_triangle_bvh_plain and
// occluded_bvh_plain; kernel and twin agree bit for bit (the same float
// operations in the same order, -fmad=false, csrc/walk.cuh).
//
// Tables (ops/bvh_traverse.pack_bvh): nodes (M, 8) f32 rows [bmin xyz,
// bmax xyz, bits(miss), bits(start << 5 | count)], start = -1 (the field
// negative) for an interior node; tri (T, 9) f32 rows [v0, e1, e2] in leaf
// order; order (T,) i32 the original id of each row. A lane starts at node
// 0; where its segment [0, t_best] enters a node's box it goes on to the
// next node (interior) or tests the leaf's triangles and follows the miss
// link, which it also follows where it misses the box; -1 ends the walk. A
// hit replaces the running one only if strictly closer (the first triangle
// in threaded order wins a tie); the any-hit ends a lane's walk at its
// first hit strictly before t_max.
//
// What bounds it on an H100: neither bytes nor operations, as written. A
// lane's node visits and triangle tests (~23 and ~48 float32 operations)
// are what the bound counts; the walk is a chain of dependent loads (each
// node's row decides the next), and lanes of a warp diverge as soon as
// their rays part. A simple kernel first: one thread a lane, the rows
// through the read-only cache (the tables are small enough for L2), no
// sorting of rays. Faster forms (a warp a ray packet, rays sorted by
// direction, a wavefront per node level) are later work.

#include "walk.cuh"

namespace {

using theia::Ray;

constexpr int kCountBits = 5;  // _COUNT_BITS in ops/bvh_traverse.py

template <bool kAnyHit>
__global__ void __launch_bounds__(theia::kWalkThreads)
    bvh_walk(const float* __restrict__ origin, const float* __restrict__ direction,
             const float* __restrict__ t_max, const float4* __restrict__ nodes,
             const float* __restrict__ tri, const int* __restrict__ order,
             int n_nodes, int n_rays, float* __restrict__ t_out,
             int* __restrict__ idx_out, unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = theia::load_ray(origin, direction, i);
  const float ix = theia::clamped_rcp(r.dx), iy = theia::clamped_rcp(r.dy),
              iz = theia::clamped_rcp(r.dz);
  float t_best = t_max[i];
  int row_best = -1;
  bool found = false;
  int node = n_nodes > 0 ? 0 : -1;
  while (node >= 0) {
    // [bmin xyz, bmax x] and [bmax yz, miss, start << 5 | count]
    const float4 a = __ldg(nodes + 2 * node), b = __ldg(nodes + 2 * node + 1);
    float tn, tf;
    theia::slab(a.x, a.y, a.z, a.w, b.x, b.y, r, ix, iy, iz, tn, tf);
    const bool hit = tf >= theia::nmax(tn, 0.0f) && tn <= t_best;
    const int link = __float_as_int(b.w);
    if (hit && link >= 0) {
      const int start = link >> kCountBits, count = link & ((1 << kCountBits) - 1);
      for (int k = 0; k < count; ++k) {
        float t;
        if (theia::exact_row(r, tri + 9 * (start + k), t) && t < t_best) {
          if (kAnyHit) {
            found = true;
            break;
          }
          t_best = t, row_best = start + k;
        }
      }
      if (kAnyHit && found) break;
    }
    node = (hit && link < 0) ? node + 1 : __float_as_int(b.z);
  }
  if (kAnyHit) {
    occ_out[i] = found;
  } else {
    t_out[i] = row_best >= 0 ? t_best : CUDART_INF_F;
    idx_out[i] = row_best >= 0 ? __ldg(order + row_best) : -1;
  }
}

template <bool kAnyHit>
int launch(const float* origin, const float* direction, const float* t_max,
           const float* nodes, const float* tri, const int* order, int n_nodes,
           int n_rays, float* t_out, int* idx_out, unsigned char* occ_out,
           cudaStream_t stream) {
  const int blocks = (n_rays + theia::kWalkThreads - 1) / theia::kWalkThreads;
  if (blocks > 0) {
    bvh_walk<kAnyHit><<<blocks, theia::kWalkThreads, 0, stream>>>(
        origin, direction, t_max, reinterpret_cast<const float4*>(nodes), tri, order,
        n_nodes, n_rays, t_out, idx_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// origin, direction: f32 (n_rays, 3); t_max: f32 (n_rays,); nodes: f32
// (n_nodes, 8), 16-byte aligned; tri: f32 (T, 9); order: i32 (T,);
// t_out: f32 (n_rays,) (inf on a miss); idx_out: i32 (n_rays,) (-1)
extern "C" int theia_bvh_nearest(const float* origin, const float* direction,
                                 const float* t_max, const float* nodes,
                                 const float* tri, const int* order, int n_nodes,
                                 int n_rays, float* t_out, int* idx_out,
                                 cudaStream_t stream) {
  return launch<false>(origin, direction, t_max, nodes, tri, order, n_nodes, n_rays,
                       t_out, idx_out, nullptr, stream);
}

// occ_out: u8 (n_rays,), 1 where a triangle is hit at 0 < t < t_max
extern "C" int theia_bvh_occluded(const float* origin, const float* direction,
                                  const float* t_max, const float* nodes,
                                  const float* tri, const int* order, int n_nodes,
                                  int n_rays, unsigned char* occ_out,
                                  cudaStream_t stream) {
  return launch<true>(origin, direction, t_max, nodes, tri, order, n_nodes, n_rays,
                      nullptr, nullptr, occ_out, stream);
}
