// The stackless threaded-BVH walk: nearest hit and any hit.
//
// Replaces theia_tpu/ops/bvh_traverse.py nearest_triangle_bvh (l.95) and
// occluded_bvh (l.184), which JAX runs as a lax.while_loop over the whole
// wavefront, one node a step, with a gather of each lane's node row and
// leaf triangles. Eager PyTorch would take that loop as thousands of
// launches with a host sync each; here a warp walks its 32 lanes to the
// end. The plain twins are ops/bvh_traverse.nearest_triangle_bvh_plain and
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
// What bounds it on an H100: a lane's node visits and triangle tests (~23
// and ~48 float32 operations), which the bound counts; the walk itself is
// a chain of dependent loads (each node's row decides the next), and the
// lanes of a warp part as soon as their rays do. A thread that walked its
// own lane and tested each leaf inside the node loop made its warp wait on
// whichever lane was in a leaf. The design ("while-while", Aila and Laine
// 2009):
// - The tables go to dynamic shared memory where they fit: the nodes and
//   the rows (kNodesRows), the nodes alone (kNodes), or neither (kGlobal:
//   the read-only cache), as the wrapper picks from the pack's sizes
//   (ops/bvh_traverse.placement). Blocks are persistent (as many as fit
//   the card at once, one an SM where the tables fill it), so each block
//   stages once, and take runs of 32 rays in turn. A block has
//   1024 threads where that keeps more of them resident than blocks of
//   512 and the rays fill them (the flagship's tables leave room for one
//   block an SM: 32 warps instead of 16; blocks of 512 were 8-27 % slower
//   there, PERF.md), else 512, which spread fewer rays over more SMs.
// - A lane whose walk has ended takes the block's next ray at once (a
//   warp's lanes in one shared atomic), so a warp does not wait on its
//   longest walk with the rest of its lanes idle (B0 in PERF.md: 26-51 %
//   of a thread-a-lane warp's node steps were its lanes'; without the
//   refill the flagship's rays took 3-24 % longer, the 27- and 124-module
//   scenes' 2-4 % less).
// - A lane walks interior and missed nodes until it holds a leaf that its
//   segment enters, or its walk ends. When every live lane of the warp
//   holds a leaf or has ended, or after kNodeCap node steps (8 beat 4 and
//   16 in turns, PERF.md), the warp
//   tests the held leaves together: the (lane, row) pairs are spread over
//   its 32 threads, `slot` threads a leaf (leaf_size rounded up to a power
//   of two), and reduced per leaf to the least (t, row) below the lane's
//   t_best at leaf entry (csrc/walk.cuh min_hit). Each lane still meets its
//   leaves in threaded order, so the winner and every tie stay those of
//   the sequential walk; the any-hit ends a lane at its first hit.

#include "walk.cuh"

namespace {

using theia::kFullMask;
using theia::ld;
using theia::Ray;

constexpr int kCountBits = 5;  // _COUNT_BITS in ops/bvh_traverse.py
// node steps a lane takes before its warp tests the leaves held so far
constexpr int kNodeCap = 8;

// where the tables are read from (ops/bvh_traverse.placement's codes)
enum Place { kGlobal = 0, kNodes = 1, kNodesRows = 2 };

template <bool kAnyHit, int kPlace, int kThreads>
__global__ void __launch_bounds__(kThreads)
    bvh_walk(const float* __restrict__ origin, const float* __restrict__ direction,
             const float* __restrict__ t_max, const float4* __restrict__ nodes_g,
             const float* __restrict__ tri_g, const int* __restrict__ order,
             int n_nodes, int n_tri, int slot, int n_rays, float* __restrict__ t_out,
             int* __restrict__ idx_out, unsigned char* __restrict__ occ_out) {
  constexpr bool kSharedNodes = kPlace >= kNodes, kSharedRows = kPlace >= kNodesRows;
  // dynamic: [nodes | rows] as placed; static: each warp's held leaves'
  // lanes in lane order
  extern __shared__ float4 staged[];
  __shared__ int holder_lane[kThreads / 32][32];
  const float4* nodes = nodes_g;
  const float* tri = tri_g;
  if constexpr (kSharedNodes) {
    theia::stage(staged, nodes_g, 2 * n_nodes);
    nodes = staged;
  }
  if constexpr (kSharedRows) {
    float* rows = reinterpret_cast<float*>(staged + 2 * n_nodes);
    theia::stage(rows, tri_g, 9 * n_tri);
    tri = rows;
  }
  // the block's rays, handed out in order from `cursor`: its k-th run of
  // 32 is the grid's run k * gridDim.x + blockIdx.x (the runs dealt to the
  // blocks in turn, as a grid-stride loop deals them: a batch's lanes with
  // long walks are not all in one block)
  __shared__ int cursor;
  if (threadIdx.x == 0) cursor = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int* const own = holder_lane[threadIdx.x >> 5];
  const int per_step = 32 / slot;  // leaves a step of the leaf tests
  int i = -1;             // the lane's ray, -1 while it holds none
  bool drained = false;   // no ray of the block is left for the lane
  Ray r{};
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, t_best = 0.0f;
  int row_best = -1, node = -1;
  int leaf = -1;  // the held leaf's start << 5 | count
  bool found = false;
  while (true) {
    // lanes without a ray take the block's next ones, a warp's in one atomic
    const bool want = !drained && i < 0;
    const unsigned wants = __ballot_sync(kFullMask, want);
    if (wants != 0) {
      const int leader = __ffs(wants) - 1;
      int got = 0;
      if (lane == leader) got = atomicAdd(&cursor, __popc(wants));
      got = __shfl_sync(kFullMask, got, leader) + __popc(wants & ((1u << lane) - 1u));
      const long ray = ((static_cast<long>(got) >> 5) * gridDim.x + blockIdx.x) * 32 + (got & 31);
      if (want && ray < n_rays) {
        i = static_cast<int>(ray);
        r = theia::load_ray(origin, direction, i);
        ix = theia::clamped_rcp(r.dx), iy = theia::clamped_rcp(r.dy), iz = theia::clamped_rcp(r.dz);
        t_best = t_max[i], row_best = -1, found = false, node = n_nodes > 0 ? 0 : -1;
      } else if (want) {
        drained = true;
      }
    }
    if (__all_sync(kFullMask, i < 0)) break;
    for (int step = 0; leaf < 0 && node >= 0 && step < kNodeCap; ++step) {
      // [bmin xyz, bmax x] and [bmax yz, miss, start << 5 | count]
      const float4 a = ld<kSharedNodes>(nodes + 2 * node), b = ld<kSharedNodes>(nodes + 2 * node + 1);
      float tn, tf;
      theia::slab(a.x, a.y, a.z, a.w, b.x, b.y, r, ix, iy, iz, tn, tf);
      const bool hit = tf >= theia::nmax(tn, 0.0f) && tn <= t_best;
      const int link = __float_as_int(b.w);
      if (hit && link >= 0) leaf = link;
      node = (hit && link < 0) ? node + 1 : __float_as_int(b.z);
    }
    const unsigned holders = __ballot_sync(kFullMask, leaf >= 0);
    if (holders != 0) {
      // the held leaves, per_step of them a step, in lane order
      const int rank = __popc(holders & ((1u << lane) - 1u));
      if (leaf >= 0) own[rank] = lane;
      __syncwarp();
      const int n_held = __popc(holders);
      unsigned long long mine = theia::kNoHit;
      for (int base = 0; base < n_held; base += per_step) {
        const int k = lane / slot, j = lane % slot;
        const int h = base + k < n_held ? own[base + k] : lane;
        const Ray rh = theia::shfl_ray(r, h);
        const float cap = __shfl_sync(kFullMask, t_best, h);
        const int lk = __shfl_sync(kFullMask, leaf, h);
        unsigned long long key = theia::kNoHit;
        const int start = lk >> kCountBits, count = base + k < n_held ? lk & ((1 << kCountBits) - 1) : 0;
        for (int row = start + j; row < start + count; row += slot) {
          float t;
          if (theia::exact_row<kSharedRows>(rh, tri + 9 * row, t) && t < cap) {
            const unsigned long long kk = theia::hit_key(t, row);
            key = kk < key ? kk : key;
          }
        }
        key = theia::min_hit(key, slot);
        const bool taking = leaf >= 0 && rank >= base && rank < base + per_step;
        const unsigned long long won = __shfl_sync(kFullMask, key, taking ? (rank - base) * slot : lane);
        if (taking) mine = won;
      }
      __syncwarp();
      if (leaf >= 0) {
        leaf = -1;
        if (mine != theia::kNoHit) {
          if (kAnyHit) {
            found = true;
            node = -1;
          } else {
            t_best = __uint_as_float(static_cast<unsigned>(mine >> 32));
            row_best = static_cast<int>(mine & 0xffffffffu);
          }
        }
      }
    }
    // a lane whose walk has ended gives its answer and frees itself
    if (i >= 0 && node < 0 && leaf < 0) {
      if (kAnyHit) {
        occ_out[i] = found;
      } else {
        t_out[i] = row_best >= 0 ? t_best : CUDART_INF_F;
        idx_out[i] = row_best >= 0 ? __ldg(order + row_best) : -1;
      }
      i = -1;
    }
  }
}

template <bool kAnyHit, int kPlace>
int launch_placed(const float* origin, const float* direction, const float* t_max,
                  const float* nodes, const float* tri, const int* order, int n_nodes,
                  int n_tri, int slot, int n_rays, float* t_out, int* idx_out,
                  unsigned char* occ_out, cudaStream_t stream) {
  constexpr auto small = bvh_walk<kAnyHit, kPlace, 512>;
  constexpr auto large = bvh_walk<kAnyHit, kPlace, 1024>;
  const long floats = (kPlace >= kNodes ? 8L * n_nodes : 0) + (kPlace >= kNodesRows ? 9L * n_tri : 0);
  const int bytes = static_cast<int>(4 * floats);
  int blocks_small = 1, blocks_large = 1;
  int err = theia::grant_shared<small>(bytes);
  if (err == 0) err = theia::grant_shared<large>(bytes);
  if (err == 0) err = theia::resident_blocks<small>(512, bytes, blocks_small);
  if (err == 0) err = theia::resident_blocks<large>(1024, bytes, blocks_large);
  if (err != 0) return err;
  // blocks of 1024 where they keep more threads resident (tables that
  // leave room for one block an SM) and the rays fill them; else of 512,
  // which spread fewer rays over more SMs
  const bool use_large = 1024L * blocks_large > 512L * blocks_small && n_rays >= 1024L * blocks_large;
  const int threads = use_large ? 1024 : 512;
  const int resident = use_large ? blocks_large : blocks_small;
  const int needed = (n_rays + threads - 1) / threads;
  const int blocks = resident < needed ? resident : needed;
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  if (use_large) {
    large<<<blocks, threads, bytes, stream>>>(origin, direction, t_max, nodes4, tri, order, n_nodes,
                                              n_tri, slot, n_rays, t_out, idx_out, occ_out);
  } else {
    small<<<blocks, threads, bytes, stream>>>(origin, direction, t_max, nodes4, tri, order, n_nodes,
                                              n_tri, slot, n_rays, t_out, idx_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kAnyHit>
int launch(const float* origin, const float* direction, const float* t_max,
           const float* nodes, const float* tri, const int* order, int n_nodes, int n_tri,
           int slot, int place, int n_rays, float* t_out, int* idx_out,
           unsigned char* occ_out, cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  if (slot < 1 || slot > 32 || (slot & (slot - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (place) {
    case kNodesRows:
      return launch_placed<kAnyHit, kNodesRows>(origin, direction, t_max, nodes, tri, order,
                                                n_nodes, n_tri, slot, n_rays, t_out, idx_out,
                                                occ_out, stream);
    case kNodes:
      return launch_placed<kAnyHit, kNodes>(origin, direction, t_max, nodes, tri, order,
                                            n_nodes, n_tri, slot, n_rays, t_out, idx_out,
                                            occ_out, stream);
    case kGlobal:
      return launch_placed<kAnyHit, kGlobal>(origin, direction, t_max, nodes, tri, order,
                                             n_nodes, n_tri, slot, n_rays, t_out, idx_out,
                                             occ_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// origin, direction: f32 (n_rays, 3); t_max: f32 (n_rays,); nodes: f32
// (n_nodes, 8), 16-byte aligned; tri: f32 (T, 9); order: i32 (T,); slot:
// threads a leaf in the leaf tests, a power of two >= the pack's leaf_size;
// place: a Place; t_out: f32 (n_rays,) (inf on a miss); idx_out: i32
// (n_rays,) (-1)
extern "C" int theia_bvh_nearest(const float* origin, const float* direction,
                                 const float* t_max, const float* nodes,
                                 const float* tri, const int* order, int n_nodes, int n_tri,
                                 int slot, int place, int n_rays, float* t_out, int* idx_out,
                                 cudaStream_t stream) {
  return launch<false>(origin, direction, t_max, nodes, tri, order, n_nodes, n_tri, slot,
                       place, n_rays, t_out, idx_out, nullptr, stream);
}

// occ_out: u8 (n_rays,), 1 where a triangle is hit at 0 < t < t_max
extern "C" int theia_bvh_occluded(const float* origin, const float* direction,
                                  const float* t_max, const float* nodes,
                                  const float* tri, const int* order, int n_nodes, int n_tri,
                                  int slot, int place, int n_rays, unsigned char* occ_out,
                                  cudaStream_t stream) {
  return launch<true>(origin, direction, t_max, nodes, tri, order, n_nodes, n_tri, slot,
                      place, n_rays, nullptr, nullptr, occ_out, stream);
}
