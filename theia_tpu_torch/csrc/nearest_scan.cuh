// The one scan of every triangle query of the port: the nearest hit (with
// or without each winner's table row), the any-hit, and the MIS shadow
// pair (nearest hit over some chunks, any-hit over others, in one launch).
// csrc/intersect_soup.cu instantiates it with the Moeller-Trumbore policy
// (csrc/moller_trumbore.cuh), for the brute-force soup and for the MT
// pack, csrc/intersect_woop.cu with the Woop policy. A policy supplies the
// per-pair arithmetic (the guard of the sphere test, a division-free
// reject() and the exact test); everything else is here, once.
//
// The table. Rows of 20 floats (kRowFloat4 float4) in chunks of 256
// (kChunk), each chunk with a widened box (chunk_box) and one box for each
// 32 rows (sub_box, kSub), both from ops/intersect_mt.chunk_boxes; count[c]
// is the real rows of chunk c (the rest is padding, never tested) and the
// row's 12th float (w[2].w) the index that a hit on it reports, as int32
// bits. A query visits a list of chunks: every chunk of an MT or Woop
// pack's table (its index is the row), those of some groups of the soup's
// (each group in Morton order, its index the soup row).
//
// What bounds it on an H100: the FP32 pipes. The (ray, triangle) pairs
// that a ray's segment can reach cost ~30 flop each in the sphere test,
// and reject() and exact() run on what that lets through; rays, rows and
// results are a few bytes a lane, the table a few hundred KB that L2
// holds. Only a masked query with few live lanes (the any-hit) is bound by
// the bytes of its mask and answers.
//
// Design, by what held earlier forms back:
// 1. The loop turned around. One thread a ray, walking every chunk that
//    any ray of its block needed, walked nearly every chunk (rays come in
//    stream order). Here a thread holds ONE row of the chunk (256 threads,
//    256 rows), the block lists in shared memory the rays whose segment
//    [0, best t) enters the chunk's box (the plain versions' chunk rule),
//    and the block works down the list: a ray is read by broadcast and
//    serves many pairs, a row is read once a chunk.
// 2. Sub-boxes. Each warp owns 32 rows of the chunk and their box. It
//    takes the list 32 rays at a time, one a lane, keeps those whose
//    segment [0, bound) enters its sub-box (the bound as the list was
//    made: a snapshot, so that the plain walk, which tests the same
//    sub-boxes with the same float ops, skips exactly the same pairs), and
//    runs the sphere test on its 32 rows for those rays only. On a
//    flagship batch's soup queries a quarter to a third of the chunk
//    rule's pairs remain.
// 3. Reject before testing. A pair first runs the sphere test below (the
//    ray's line against the row's bounding sphere, from where the ray
//    enters the sub-box); its survivors run the policy's division-free
//    reject(), the exact test's inequalities multiplied through by |det|
//    with a slack for the rounding; what that lets through runs exact(),
//    unchanged and in its old operation order. Neither test rejects a pair
//    that exact() accepts (below, and in the policies), so t and idx stay
//    bit-equal to the plain PyTorch versions.
// 4. Survivors are pooled. A surviving pair goes to its warp's pool in
//    shared memory (a ballot gives every lane its place and the warp's
//    running count); after the list the 256 threads share all eight pools
//    out, whichever rows and rays the pairs came from (survivors cluster
//    on the few rays that pass near a chunk). A hit goes into the ray's key
//    (t bits << 32 | index) with an atomic minimum, which keeps the strict
//    t < t_max start and the lowest index on ties in any order.
// 5. Rays that take no part cost nothing. A ray's key starts at (t_max
//    bits << 32), or at 0 for a masked lane or a t_max that is not
//    positive: such a ray is not read and never listed. Before a run of up
//    to 32 chunks each thread tests its rays against their boxes and the
//    block ORs the bits, so a chunk that no ray of the block can reach
//    costs no list and no barrier, and a block whose rays are all out
//    skips the run.
// 6. The shadow pair in one launch (kTarget). After the first list of
//    chunks every ray's key holds its winner; the thread that owns the ray
//    keeps the winner in registers and restarts the key at (t bits << 32)
//    for a ray that found one, 0 for the rest, and the same loop walks the
//    second list with the any-hit's test: a pair that passes exact() with
//    t below the key's bound sets the key to 0 (every writer writes the
//    same word), which also takes the ray out of every later chunk's list.
//    A lane is valid if its key is still nonzero. One exact() for both
//    halves: the winner's own t is not below itself, so it never occludes
//    itself.
// 7. Nothing is staged. A thread loads its row's 48-byte head while the
//    block builds the list; the pool phase reads a survivor's 80-byte row
//    from L1/L2.
//
// The sphere test. A row starts with a centre c, r2 = f R0^2 (R0 the
// largest distance from c to a vertex, in float64 from the float32 table;
// f is 1.7 or 2.8, below), and the policy's "det row" and slack
// coefficients. With w = c - o, the line misses a sphere of radius R iff
// |w|^2 |d|^2 - (w.d)^2 > R^2 |d|^2. A pair is dropped only if (a) the
// computed left side, less 64 unit roundoffs of |w|^2 |d|^2 (the
// computation errs by at most 19, the rounding of T = o - v0 included),
// exceeds R^2 |d|^2, and (b) |det| > g S, where det and S are the policy's
// determinant and the slack of its reject() (for Moeller-Trumbore with
// |T|_1 <= |w|_1 + sqrt(3) R0). Why that is safe: the error E of exact()'s
// own barycentrics against their real values, times |det|, is at most
// 0.175 S (Moeller-Trumbore) or 0.104 S (Woop), so under (b) the real
// barycentrics of the point X where the line meets the triangle's plane
// are within eta = E / (g S) of what exact() tested, hence at least
// -eta - 2e-6 each, the third one too. X is then an affine combination of
// the vertices with absolute weights summing to at most 1 + 6 eta, and the
// line passes within (1 + 6 eta) R0 of c:
//   Moeller-Trumbore  g = 4   eta = 0.0442  (1 + 6 eta)^2 = 1.60 < 1.7
//   Woop              g = 1   eta = 0.105   (1 + 6 eta)^2 = 2.66 < 2.8
// (g trades the sphere's size against the share of grazing pairs that
// fail (b); Woop's exact test is the noisier one, its o' = m o + f
// cancels.) Without (b) a ray lying in a triangle's plane, where exact()
// divides rounding noise by rounding noise and may accept far from the
// triangle, would be dropped. NaN fails (a) or (b), an infinite S (wild
// rays, huge or padding triangles) fails (b): such pairs go on to reject().
//
// From where the ray enters the sub-box. A ray that starts far from the
// triangles (a shadow ray from a scatter vertex tens of metres from the
// detector) made the 64-unit margin of |w|^2 |d|^2 exceed the sphere
// itself, and the MT guard grow with |w|: nearly every pair near the
// detector's silhouette survived. So the test runs from o' = o + s d, s =
// the entry distance of the sub-box's slab test. The line through o' is
// the ray's own line, moved by the rounding e of o' alone (|e_k| <=
// u |o'_k|, one fmaf a component), so
//   |c - o'|^2 |d|^2 - ((c - o').d)^2 > (R + delta)^2 |d|^2,
//   delta = 4u |o'|_1 >= |e|,
// computed as (a) computes it (its margin is now of |c - o'|^2 |d|^2, a
// sub-box's size, not the ray's length), means the line through o misses
// the sphere of radius R = sqrt(r2). (b) keeps S for the real ray: the
// Woop slack does not depend on T, and for Moeller-Trumbore |T|_1 <=
// |c - o'|_1 + |o' - o|_1 + sqrt(3) R0 with |o' - o|_1 <= s |d|_1 + |e|_1
// <= sigma = fmaf(s, |d|_1 (1 + 2^-20), delta), the extra factor covering
// the rounding of |d|_1 and of the fmaf. With both, the argument above
// holds as it stands: a pair that exact() accepts is never dropped. On a
// flagship batch's soup queries 3.3 % of the detector's sub-box pairs
// survive, 0.6 % of the primary queries'.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace theia {

constexpr int kChunk = 256;  // rows per chunk; CHUNK in ops/intersect_mt.py
constexpr int kThreads = kChunk;  // a thread a row of the chunk
constexpr int kRowFloat4 = 5;  // one table row: 20 floats (ROW_AOS in ops/intersect_mt.py)
constexpr int kHeadFloat4 = 3;  // of them read by the sphere test
#ifndef THEIA_RAYS_PER_THREAD
#define THEIA_RAYS_PER_THREAD 2
#endif
constexpr int kR = THEIA_RAYS_PER_THREAD;  // rays a block, in units of its threads
constexpr int kRaysPerBlock = kR * kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpPool = 512;  // surviving pairs a warp pools before it tests them in place
static_assert(kRaysPerBlock <= 1 << 11, "a pool entry is 16 bits: 11 for the ray, 5 for the lane");
constexpr int kSub = 32;  // rows a sub-box, a warp's share of a chunk; SUB in ops/intersect_mt.py
static_assert(kChunk == kSub * kWarps, "a warp a sub-box");
constexpr int kWindow = 32;  // chunks whose boxes a thread tests in one run, a bit each
constexpr int kTableWidth = 32;  // floats per row of the winners' table (tri_data)
// Resident blocks an SM that ptxas must allow for: 4 holds a thread to 64
// registers; the shadow pair's variant with rows took 74 (3 blocks) when
// left free, which cost its detector half a third (PERF.md §6).
constexpr int kMinBlocks = 4;

// slack factor of the rejection tests: 128 float32 unit roundoffs (2^-24)
constexpr float kSlack = 7.62939453125e-06f;  // 2^-17
// rays and triangles with a coordinate at or above this size get an
// infinite slack: reject() lets every such pair through to exact()
constexpr float kWild = 1e9f;

__device__ __forceinline__ float rcp_newton(float v) {
  const float r = __frcp_rn(v);
  return r * (2.0f - v * r);
}

// keep the reciprocal finite, preserving the sign (ops/_intersect_tiles.py:43)
__device__ __forceinline__ float safe(float v) {
  return fabsf(v) < 1e-20f ? (v < 0.0f ? -1e-20f : 1e-20f) : v;
}

// flip the sign of v where sign_bit (0 or 0x80000000) is set
__device__ __forceinline__ float flip(float v, unsigned sign_bit) {
  return __uint_as_float(__float_as_uint(v) ^ sign_bit);
}

// the comparisons both rejection tests end in, on values already given
// the sign of det: bitwise, so that no lane branches
__device__ __forceinline__ bool rejected(float su, float sv, float sw,
                                         float adet, float lo, float s) {
  return (su < -lo) | (sv < -lo) | (su + sv > adet + lo) |
         ((sw < -s) & (adet > s));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float kd;  // kSlack * max(|d|_inf, 1), inf for a wild ray
  float ko;  // kd * |o|_inf, inf for a wild ray (the Woop slack's)
  float dd;  // |d|^2
  float ddk;  // |d|^2 less 64 unit roundoffs
};

// can the segment [0, best_t) of ray (o, 1/d) enter the box lo/hi? tn is
// where the ray enters it (0 if o is inside)
__device__ __forceinline__ bool slab_entry(const float* __restrict__ box,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float best_t, float& tn) {
  const float t1x = (box[0] - ox) * ix, t2x = (box[4] - ox) * ix;
  const float t1y = (box[1] - oy) * iy, t2y = (box[5] - oy) * iy;
  const float t1z = (box[2] - oz) * iz, t2z = (box[6] - oz) * iz;
  tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
             fmaxf(fminf(t1z, t2z), 0.0f));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                         fmaxf(t1z, t2z));
  return tn <= tf && tn < best_t;
}

__device__ __forceinline__ bool slab_hit(const float* __restrict__ box,
                                         const Ray& r, float ix, float iy,
                                         float iz, float best_t) {
  float tn;
  return slab_entry(box, r.ox, r.oy, r.oz, ix, iy, iz, best_t, tn);
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// the key of a hit: the least key is the nearest hit, the lowest index
// among equal t, whatever the order the pairs arrive in
__device__ __forceinline__ unsigned long long hit_key(float t, int index) {
  return static_cast<unsigned long long>(__float_as_uint(t)) << 32 |
         static_cast<unsigned>(index);
}

// The key a ray starts from: (t_max bits << 32), or 0 for a ray that takes
// no part: nothing is closer than a t_max that is not positive (or is NaN),
// and a query's mask (null: every lane) takes lanes out.
__device__ __forceinline__ unsigned long long start_key(
    float tm, const unsigned char* __restrict__ active, int g) {
  const bool on = tm > 0.0f && (active == nullptr || active[g] != 0);
  return on ? static_cast<unsigned long long>(__float_as_uint(tm)) << 32 : 0ull;
}

enum Mode { kNearest, kAnyHit, kTarget };

struct Args {
  const float* origin;
  const float* direction;
  const float* t_max;
  const unsigned char* active;  // null: every lane
  const float4* aos;            // (n_table_chunks * 256, 5 float4)
  const float* chunk_box;       // (n_table_chunks, 8)
  const float* sub_box;         // (n_table_chunks * 8, 8)
  const int* count;             // (n_table_chunks,): real rows of each chunk
  const int* chunks;            // the chunks to visit (the detector's for kTarget)
  int n_visit;
  const int* occluders;         // kTarget: the occluders' chunks
  int n_occluders;
  int n_rays;
  const float* table;           // rows of the winners (kRows)
  float* t_out;
  int* idx_out;
  float* rows_out;
  unsigned char* any_out;
};

// A ray as the lists read it from shared memory.
struct ScanRay {
  float4 o_kd;     // origin, kd of the rejection tests
  float4 d_dd;     // direction, |d|^2
  float4 inv_ddk;  // 1/d as the slab tests take it, |d|^2 less 64 unit roundoffs
};

struct Shared {
  ScanRay ray[kRaysPerBlock];
  unsigned long long key[kRaysPerBlock];
  float2 aux[kRaysPerBlock];  // the bound when the ray was listed, |d|_1 (1 + 2^-20)
  unsigned short list[kRaysPerBlock];  // the rays that can reach the chunk
  unsigned short pool[kWarps][kWarpPool];  // surviving pairs: ray << 5 | lane
  int pooled[kWarps];
  int listed[2];       // listed rays, by the chunk's parity
  unsigned needed[2];  // chunks of a run that some ray can reach, by the run's parity
};

__device__ __forceinline__ Ray ray_of(const ScanRay& s) {
  Ray r;
  r.ox = s.o_kd.x, r.oy = s.o_kd.y, r.oz = s.o_kd.z, r.kd = s.o_kd.w;
  r.dx = s.d_dd.x, r.dy = s.d_dd.y, r.dz = s.d_dd.z, r.dd = s.d_dd.w;
  r.ddk = s.inv_ddk.w;
  // the Woop slack's alone; the Moeller-Trumbore code drops it
  const float omax = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  r.ko = r.kd < CUDART_INF_F ? r.kd * omax : CUDART_INF_F;
  return r;
}

// The sphere test from where ray r enters the sub-box (s its entry
// distance, d1k = |d|_1 (1 + 2^-20)) on the row whose head is h, rad0 =
// sqrt(r2): is the pair dropped?
template <class Policy>
__device__ __forceinline__ bool sphere_miss(const Ray& r, float s, float d1k,
                                            const float4 (&h)[kHeadFloat4], float rad0) {
  const float ox = __fmaf_rn(s, r.dx, r.ox), oy = __fmaf_rn(s, r.dy, r.oy),
              oz = __fmaf_rn(s, r.dz, r.oz);
  const float delta = 2.384185791015625e-07f * (fabsf(ox) + fabsf(oy) + fabsf(oz));  // 2^-22
  const float sigma = __fmaf_rn(s, d1k, delta);
  const float wx = h[0].x - ox, wy = h[0].y - oy, wz = h[0].z - oz;
  const float p = __fmaf_rn(wz, r.dz, __fmaf_rn(wy, r.dy, wx * r.dx));
  const float w2 = __fmaf_rn(wz, wz, __fmaf_rn(wy, wy, wx * wx));
  const float q = __fmaf_rn(w2, r.ddk, -(p * p));
  const float det = __fmaf_rn(r.dz, h[1].z, __fmaf_rn(r.dy, h[1].y, r.dx * h[1].x));
  const float g = Policy::guard(r, h, fabsf(wx) + fabsf(wy) + fabsf(wz) + sigma);
  const float rad = rad0 + delta;
  return (q > rad * rad * r.dd) & (fabsf(det) > g);
}

// reject() and exact() on one surviving pair, the index from the row. The
// nearest hit lowers the ray's key to the hit's (t bits << 32 | index); the
// any-hit sets it to 0 on a hit strictly below its bound.
template <class Policy, bool kAny>
__device__ __forceinline__ void test_row(const Ray& r, const float4* row, unsigned long long* key) {
  float4 w[kRowFloat4];
#pragma unroll
  for (int c = 0; c < kRowFloat4; ++c) w[c] = row[c];
  float t;
  if (!Policy::reject(r, w) && Policy::exact(r, w, t)) {
    if constexpr (kAny) {
      volatile unsigned long long* flag = key;
      if (t < key_t(*flag)) *flag = 0ull;
    } else {
      atomicMin(key, hit_key(t, __float_as_int(w[2].w)));
    }
  }
}

// The rays a thread owns, as the chunk lists test them.
struct Owned {
  Ray ray[kR];
  float ix[kR], iy[kR], iz[kR];
};

// Which of the double-buffered counters of Shared is in use; carried
// across the two walks of the shadow pair.
struct Parity {
  int listed = 0, needed = 0;
};

// Walk `chunks` (n of them) for the block's rays: design notes 1-5.
template <class Policy, bool kAny>
__device__ void walk(Shared& sh, const Args& a, const Owned& own,
                     const int* __restrict__ chunks, int n, Parity& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1;
  for (int w0 = 0; w0 < n; w0 += kWindow) {
    // which chunks of the run can a ray of the block reach?
    const int n_run = min(kWindow, n - w0);
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const float bound = key_t(sh.key[k * kThreads + threadIdx.x]);
      if (!(bound > 0.0f)) continue;  // out, or done
      for (int j = 0; j < n_run; ++j)
        if (slab_hit(a.chunk_box + 8 * chunks[w0 + j], own.ray[k], own.ix[k], own.iy[k],
                     own.iz[k], bound))
          bits |= 1u << j;
    }
    if (bits) atomicOr(&sh.needed[parity.needed], bits);
    if (threadIdx.x == 0) sh.needed[parity.needed ^ 1] = 0u;
    __syncthreads();
    unsigned run = sh.needed[parity.needed];
    parity.needed ^= 1;
    while (run) {  // uniform: every thread reads the same bits
      const int chunk = chunks[w0 + __ffs(run) - 1];
      run &= run - 1;
      const int base = chunk * kChunk;
      // list the rays whose segment [0, bound) can enter the chunk's box
      const float* box = a.chunk_box + 8 * chunk;
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int slot = k * kThreads + threadIdx.x;
        const float bound = key_t(sh.key[slot]);
        if (slab_hit(box, own.ray[k], own.ix[k], own.iy[k], own.iz[k], bound)) {
          sh.list[atomicAdd(&sh.listed[parity.listed], 1)] = static_cast<unsigned short>(slot);
          sh.aux[slot].x = bound;
        }
      }
      if (threadIdx.x == 0) sh.listed[parity.listed ^ 1] = 0;
      // this thread's row (its head) and its warp's sub-box
      const float4* row = a.aos + (size_t)(base + threadIdx.x) * kRowFloat4;
      const float4 h[kHeadFloat4] = {row[0], row[1], row[2]};
      const float rad0 = sqrtf(h[0].w);
      const bool real = threadIdx.x < a.count[chunk];
      const float* sub = a.sub_box + 8 * (chunk * kWarps + warp);
      __syncthreads();
      const int listed = sh.listed[parity.listed];
      parity.listed ^= 1;
      if (listed == 0) continue;  // uniform
      int pooled = 0;
      for (int i0 = 0; i0 < listed; i0 += 32) {
        // a lane a listed ray: does it enter this warp's sub-box?
        int slot = 0;
        float s = 0.0f;
        bool enters = false;
        if (i0 + lane < listed) {
          slot = sh.list[i0 + lane];
          const float4 o = sh.ray[slot].o_kd, inv = sh.ray[slot].inv_ddk;
          enters = slab_entry(sub, o.x, o.y, o.z, inv.x, inv.y, inv.z, sh.aux[slot].x, s);
        }
        unsigned entering = __ballot_sync(0xffffffffu, enters);
        while (entering) {  // uniform within the warp
          const int src = __ffs(entering) - 1;
          entering &= entering - 1;
          const int r_slot = __shfl_sync(0xffffffffu, slot, src);
          const float r_s = __shfl_sync(0xffffffffu, s, src);
          const Ray r = ray_of(sh.ray[r_slot]);
          const bool keep = !sphere_miss<Policy>(r, r_s, sh.aux[r_slot].y, h, rad0) & real;
          const unsigned mask = __ballot_sync(0xffffffffu, keep);
          if (keep) {
            const int at = pooled + __popc(mask & lanes_below);
            if (at < kWarpPool)
              sh.pool[warp][at] = static_cast<unsigned short>(r_slot << 5 | lane);
            else  // the pool is full: test the pair here and now
              test_row<Policy, kAny>(r, row, &sh.key[r_slot]);
          }
          pooled += __popc(mask);
        }
      }
      if (lane == 0) sh.pooled[warp] = min(pooled, kWarpPool);
      __syncthreads();
      // the block's threads share out the pooled pairs, whichever warp's
      int upto[kWarps];  // pairs in the pools of warps 0..w
#pragma unroll
      for (int w = 0; w < kWarps; ++w) upto[w] = sh.pooled[w] + (w ? upto[w - 1] : 0);
      for (int e = threadIdx.x; e < upto[kWarps - 1]; e += kThreads) {
        int w = 0, before = 0;
#pragma unroll
        for (int v = 0; v < kWarps - 1; ++v)
          if (e >= upto[v]) w = v + 1, before = upto[v];
        const unsigned entry = sh.pool[w][e - before];
        const int slot = entry >> 5, j = 32 * w + (entry & 31);
        test_row<Policy, kAny>(ray_of(sh.ray[slot]), a.aos + (size_t)(base + j) * kRowFloat4,
                               &sh.key[slot]);
      }
      __syncthreads();
    }
  }
}

// Policy: static float guard(const Ray&, const float4 (&h)[3], float w1),
// static bool reject(const Ray&, const float4 (&w)[5]) and
// static bool exact(const Ray&, const float4 (&w)[5], float& t).
// kRows: also copy each winner's row of `table`.
template <class Policy, bool kRows, Mode kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan(const Args a) {
  static_assert(!(kRows && kMode == kAnyHit), "an any-hit query has no winner");
  __shared__ Shared sh;
  const int first = blockIdx.x * kRaysPerBlock;
  Owned own;
  unsigned long long start[kR];
  if (threadIdx.x < 2) sh.listed[threadIdx.x] = 0, sh.needed[threadIdx.x] = 0u;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int slot = k * kThreads + threadIdx.x;
    const int g = first + slot;
    // a slot past the last ray, or a masked one, starts at 0: never listed
    start[k] = g < a.n_rays ? start_key(a.t_max[g], a.active, g) : 0ull;
    Ray& r = own.ray[k];
    r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = 0.0f;
    if (start[k]) {  // a ray that takes no part is not read
      r.ox = a.origin[3 * g + 0], r.oy = a.origin[3 * g + 1], r.oz = a.origin[3 * g + 2];
      r.dx = a.direction[3 * g + 0], r.dy = a.direction[3 * g + 1], r.dz = a.direction[3 * g + 2];
    }
    const float omax = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
    const float dmax = fmaxf(fmaxf(fabsf(r.dx), fabsf(r.dy)), fabsf(r.dz));
    // fmaxf drops a NaN operand, so test the components themselves
    const bool tame = omax < kWild && dmax < kWild && r.ox == r.ox && r.oy == r.oy &&
                      r.oz == r.oz && r.dx == r.dx && r.dy == r.dy && r.dz == r.dz;
    r.kd = tame ? kSlack * fmaxf(dmax, 1.0f) : CUDART_INF_F;
    r.ko = 0.0f;  // the lists' slab tests do not read it
    r.dd = __fmaf_rn(r.dz, r.dz, __fmaf_rn(r.dy, r.dy, r.dx * r.dx));
    r.ddk = r.dd * (1.0f - 64.0f * 5.9604644775390625e-08f);
    own.ix[k] = rcp_newton(safe(r.dx));
    own.iy[k] = rcp_newton(safe(r.dy));
    own.iz[k] = rcp_newton(safe(r.dz));
    sh.ray[slot].o_kd = make_float4(r.ox, r.oy, r.oz, r.kd);
    sh.ray[slot].d_dd = make_float4(r.dx, r.dy, r.dz, r.dd);
    sh.ray[slot].inv_ddk = make_float4(own.ix[k], own.iy[k], own.iz[k], r.ddk);
    sh.aux[slot].y = (fabsf(r.dx) + fabsf(r.dy) + fabsf(r.dz)) * (1.0f + 9.5367431640625e-07f);  // 2^-20
    sh.key[slot] = start[k];
  }
  __syncthreads();
  Parity parity;
  walk<Policy, kMode == kAnyHit>(sh, a, own, a.chunks, a.n_visit, parity);
  unsigned long long win[kR];  // kTarget: each owned ray's winner, 0 for none
  if constexpr (kMode == kTarget) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int slot = k * kThreads + threadIdx.x;
      const unsigned long long key = sh.key[slot];
      // a key that left its start took a hit; a start of 0 never leaves
      win[k] = key != start[k] ? key : 0ull;
      // the any-hit's start: the winner's t, strictly; 0 takes the ray out
      sh.key[slot] = win[k] >> 32 << 32;
    }
    __syncthreads();
    walk<Policy, true>(sh, a, own, a.occluders, a.n_occluders, parity);
  }
  int best_i[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int slot = k * kThreads + threadIdx.x;
    const int g = first + slot;
    const unsigned long long key = sh.key[slot];
    best_i[k] = -1;
    if (g >= a.n_rays) continue;
    if constexpr (kMode == kAnyHit) {
      a.any_out[g] = key != start[k];
    } else {
      unsigned long long best = key != start[k] ? key : 0ull;
      if constexpr (kMode == kTarget) best = key != 0ull ? win[k] : 0ull;  // not occluded
      best_i[k] = best ? static_cast<int>(static_cast<unsigned>(best)) : -1;
      a.t_out[g] = best ? key_t(best) : CUDART_INF_F;
      a.idx_out[g] = best_i[k];
    }
  }
  if constexpr (kRows) {
    // the block copies its winners' rows together, 32 threads to a row,
    // so every load and store is one coalesced 128-byte line
    __shared__ int s_row[kRaysPerBlock];
#pragma unroll
    for (int k = 0; k < kR; ++k) s_row[k * kThreads + threadIdx.x] = max(best_i[k], 0);
    __syncthreads();
    const int n_here = min(kRaysPerBlock, a.n_rays - first);
    for (int i = threadIdx.x; i < n_here * kTableWidth; i += kThreads) {
      const int r = i / kTableWidth;
      const int col = i - r * kTableWidth;
      a.rows_out[(size_t)(first + r) * kTableWidth + col] =
          a.table[(size_t)s_row[r] * kTableWidth + col];
    }
  }
}

template <class Policy, bool kRows, Mode kMode>
int launch(const Args& a, cudaStream_t stream) {
  if (a.n_rays > 0) {
    const int blocks = (a.n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    scan<Policy, kRows, kMode><<<blocks, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The arguments every entry point takes: the rays, the mask, the table
// and the chunks to visit.
inline Args args(const float* origin, const float* direction, const float* t_max,
                 const unsigned char* active, const float* aos, const float* chunk_box,
                 const float* sub_box, const int* chunk_count, const int* chunks, int n_visit,
                 int n_rays) {
  Args a{};
  a.origin = origin, a.direction = direction, a.t_max = t_max, a.active = active;
  a.aos = reinterpret_cast<const float4*>(aos);
  a.chunk_box = chunk_box, a.sub_box = sub_box, a.count = chunk_count;
  a.chunks = chunks, a.n_visit = n_visit, a.n_rays = n_rays;
  return a;
}

}  // namespace theia
