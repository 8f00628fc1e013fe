// The nearest-hit scan shared by csrc/intersect_mt.cu and
// csrc/intersect_woop.cu. The two files supply a policy with the per-pair
// arithmetic (two conservative rejection tests and the exact test);
// everything else is here, once.
//
// What bounds the scan on an H100: FP32 issue. Every (ray, triangle) pair
// of a chunk of 256 triangles that the ray's segment can enter has to be
// looked at; the triangle words are shared by all rays and the rays and
// results are a few bytes each, so memory traffic is negligible.
//
// Design, by what held the first kernels (one thread a ray, every thread
// walking every chunk that any ray of its block needed) back:
// 1. Only needed pairs. A ray needs a chunk only if its segment [0, best_t)
//    enters the chunk's widened box, which is the plain versions' rule; on
//    the flagship that is a tenth of all (ray, chunk) pairs, but the rays
//    come in stream order, so nearly every block needed every chunk and
//    every thread walked it. Now the block turns the loop around: a thread
//    holds ONE triangle of the chunk in registers (256 threads, 256
//    triangles), the block lists the rays that need the chunk in shared
//    memory, and every thread runs down that list. A ray is read with
//    three broadcast LDS.128 and serves 256 pairs; a triangle is read once
//    a chunk, straight from the table, and serves every listed ray; no
//    lane idles because its own ray does not need the chunk.
// 2. Reject before testing. The exact test (a correctly rounded
//    reciprocal, a Newton step, ~50 separately rounded operations) ran for
//    every pair, though a ray's line meets a handful of triangles. Now a
//    needed pair first runs only sphere_miss() (~21 instructions in
//    explicit fmaf, which -fmad=false does not touch): the ray's line
//    against the triangle's bounding sphere. Its survivors run the
//    policy's division-free reject(), the exact test's inequalities
//    multiplied through by |det| with a slack for the rounding; what that
//    lets through runs exact(), unchanged and in its old operation order.
//    Neither test rejects a pair that exact() accepts (below, and in the
//    policies), so t and idx stay bit-equal to the plain PyTorch versions.
// 3. Survivors are pooled. A pair that survives sphere_miss() goes to its
//    warp's pool in shared memory (a ballot gives every lane its place and
//    the warp's running count, so the push costs no atomic); after the list
//    the 256 threads share all eight pools out evenly, whichever triangles
//    and rays the pairs came from (survivors cluster on the few rays that
//    pass near a chunk, and far origins leave many: testing them where
//    they arise left most lanes idle). A hit goes into the ray's key
//    (t bits << 32 | index) with an atomic minimum, which keeps the strict
//    t < t_max start and the lowest index on ties in any order.
// 4. Nothing is staged. The first kernels copied each chunk into shared
//    memory between two barriers; here a thread loads its triangle's 48
//    bytes while the block builds the list, so there is no copy to overlap
//    and no double buffer.
// 5. Soup queries (csrc/intersect_soup.cu) visit a list of chunks and a
//    subset of the rays. The brute-force scene keeps its triangles in
//    instance order and asks for the nearest hit over some instances only
//    (the detector of a shadow ray) or for any hit over the others (its
//    occluders), on the lanes that still need an answer. So a launch may
//    name the chunks it visits (Visit::chunks; every instance starts on a
//    chunk boundary of the table, and a chunk says how many of its 256 rows
//    are real and which index its first triangle reports, so a hit's index
//    is its row of the scene's tables, lowest first on ties), and a byte a
//    ray that takes a lane out: its key starts at 0, so it never enters a
//    chunk's list, costs no pair and reports a miss. The any-hit variant
//    (kAny) keeps a flag where the nearest hit keeps a key: a pair that
//    passes exact() with t below the ray's bound sets the key to 0, which
//    leaves the ray out of every later chunk's list, and the launch reports
//    one byte a ray. Both are template flags on the one body, so the scans
//    over a whole table compile as they did.
//
// sphere_miss(). A row starts with a centre c, r2 = f R0^2 (R0 the largest
// distance from c to a vertex, in float64 from the float32 table; f is 1.7
// or 2.8, below), and the policy's "det row" and slack coefficients. With
// w = c - o, the line misses a sphere of radius R iff |w|^2 |d|^2 -
// (w.d)^2 > R^2 |d|^2. A pair is dropped only if (a) the computed left
// side, less 64 unit roundoffs of |w|^2 |d|^2 (the computation errs by at
// most 19, the rounding of T = o - v0 included), exceeds r2 |d|^2, and (b)
// |det| > g S, where det and S are the policy's determinant and the slack
// of its reject() (for Moeller-Trumbore with |T|_1 <= |w|_1 + sqrt(3) R0).
// Why that is safe: the error E of exact()'s own barycentrics against
// their real values, times |det|, is at most 0.175 S (Moeller-Trumbore) or
// 0.104 S (Woop), so under (b) the real barycentrics of the point X where
// the line meets the triangle's plane are within eta = E / (g S) of what
// exact() tested, hence at least -eta - 2e-6 each, the third one too. X is
// then an affine combination of the vertices with absolute weights summing
// to at most 1 + 6 eta, and the line passes within (1 + 6 eta) R0 of c:
//   Moeller-Trumbore  g = 4   eta = 0.0442  (1 + 6 eta)^2 = 1.60 < 1.7
//   Woop              g = 1   eta = 0.105   (1 + 6 eta)^2 = 2.66 < 2.8
// (g trades the sphere's size against the share of grazing pairs that
// fail (b); Woop's exact test is the noisier one, its o' = m o + f
// cancels.) Without (b) a ray lying in a triangle's plane, where exact()
// divides rounding noise by rounding noise and may accept far from the
// triangle, would be dropped. NaN fails (a) or (b), an infinite S (wild
// rays, huge or padding triangles) fails (b): such pairs go on to reject().

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace theia {

constexpr int kChunk = 256;  // triangles per skip chunk; CHUNK in ops/intersect_mt.py
constexpr int kThreads = kChunk;  // a thread a triangle of the chunk
constexpr int kRowFloat4 = 5;  // one table row: 20 floats (ROW_AOS in ops/intersect_mt.py)
constexpr int kHeadFloat4 = 3;  // of them read by sphere_miss()
#ifndef THEIA_RAYS_PER_THREAD
#define THEIA_RAYS_PER_THREAD 2
#endif
constexpr int kR = THEIA_RAYS_PER_THREAD;  // rays a block, in units of its threads
constexpr int kRaysPerBlock = kR * kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpPool = 512;  // surviving pairs a warp pools before it tests them in place
static_assert(kRaysPerBlock <= 1 << 11, "a pool entry is 16 bits: 11 for the ray, 5 for the lane");
constexpr int kTableWidth = 32;  // floats per row of the winners' table (tri_data)

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
  float ko;  // kd * |o|_inf
  float dd;  // |d|^2
  float ddk;  // |d|^2 less 64 unit roundoffs
};

// Stage 0 on the head of a row: h[0] = (c xyz, r2), h[1] = (det row xyz,
// .), h[2] = slack coefficients. Policy::guard(r, h, |w|_1) gives g S.
template <class Policy>
__device__ __forceinline__ bool sphere_miss(const Ray& r,
                                            const float4 (&h)[kHeadFloat4]) {
  const float wx = h[0].x - r.ox, wy = h[0].y - r.oy, wz = h[0].z - r.oz;
  const float p = __fmaf_rn(wz, r.dz, __fmaf_rn(wy, r.dy, wx * r.dx));
  const float w2 = __fmaf_rn(wz, wz, __fmaf_rn(wy, wy, wx * wx));
  const float q = __fmaf_rn(w2, r.ddk, -(p * p));
  const float det = __fmaf_rn(r.dz, h[1].z, __fmaf_rn(r.dy, h[1].y, r.dx * h[1].x));
  const float g = Policy::guard(r, h, fabsf(wx) + fabsf(wy) + fabsf(wz));
  return (q > h[0].w * r.dd) & (fabsf(det) > g);
}

// can the segment [0, best_t) of ray (o, 1/d) enter the box lo/hi?
__device__ __forceinline__ bool slab_hit(const float* __restrict__ box,
                                         const Ray& r, float ix, float iy,
                                         float iz, float best_t) {
  const float t1x = (box[0] - r.ox) * ix, t2x = (box[4] - r.ox) * ix;
  const float t1y = (box[1] - r.oy) * iy, t2y = (box[5] - r.oy) * iy;
  const float t1z = (box[2] - r.oz) * iz, t2z = (box[6] - r.oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                         fmaxf(fminf(t1z, t2z), 0.0f));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                         fmaxf(t1z, t2z));
  return tn <= tf && tn < best_t;
}

// What a soup query visits (design note 5); the scans over a whole table
// (kSoup false) read none of it.
struct Visit {
  const int* chunks = nullptr;  // the chunks to visit, as chunks of the table
  int n_visit = 0;              // how many
  const int* first = nullptr;   // per chunk of the table: the index its first triangle reports
  const int* count = nullptr;   // per chunk of the table: its real triangles
  const unsigned char* active = nullptr;  // per ray, 0 takes it out; null: every ray
};

__device__ __forceinline__ float key_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// reject() and exact() on one surviving pair; a hit goes into the ray's
// key, (t bits << 32 | index): the least key is the nearest hit, the lowest
// index among equal t, whatever the order the pairs arrive in. A key starts
// at (t_max bits << 32), so a hit at t == t_max never gets in. With kAny a
// hit strictly below the key's bound sets the key to 0 (every writer writes
// the same word, so the race is harmless).
template <class Policy, bool kAny>
__device__ __forceinline__ void test_pair(const Ray& r, const float4* row,
                                          unsigned long long* key, int index) {
  float4 w[kRowFloat4];
#pragma unroll
  for (int c = 0; c < kRowFloat4; ++c) w[c] = row[c];
  float t;
  if (!Policy::reject(r, w) && Policy::exact(r, w, t)) {
    if constexpr (kAny) {
      volatile unsigned long long* flag = key;
      if (t < key_t(*flag)) *flag = 0ull;
    } else {
      atomicMin(key, static_cast<unsigned long long>(__float_as_uint(t)) << 32 |
                         static_cast<unsigned>(index));
    }
  }
}

// A ray as the list loop and the pool read it from shared memory.
struct SharedRay {
  float4 o_kd, d_ko, dd_ddk;
  __device__ __forceinline__ Ray load() const {
    Ray r;
    r.ox = o_kd.x, r.oy = o_kd.y, r.oz = o_kd.z, r.kd = o_kd.w;
    r.dx = d_ko.x, r.dy = d_ko.y, r.dz = d_ko.z, r.ko = d_ko.w;
    r.dd = dd_ddk.x, r.ddk = dd_ddk.y;
    return r;
  }
};

// The key a ray starts from: (t_max bits << 32), or 0 for a ray that takes
// no part: nothing is closer than a t_max that is not positive (or is NaN),
// and a soup query's mask takes lanes out.
template <bool kSoup>
__device__ __forceinline__ unsigned long long start_key(
    float tm, const unsigned char* __restrict__ active, int g) {
  bool on = tm > 0.0f;
  if constexpr (kSoup) on = on && (active == nullptr || active[g] != 0);
  return on ? static_cast<unsigned long long>(__float_as_uint(tm)) << 32 : 0ull;
}

// Policy: static float guard(const Ray&, const float4 (&h)[3], float w1),
// static bool reject(const Ray&, const float4 (&w)[5]) and
// static bool exact(const Ray&, const float4 (&w)[5], float& t).
// kRows: also copy each winner's row of `table`. kSoup: visit the chunks
// and rays that `visit` names. kAny: report one byte a ray, whether some
// triangle is hit strictly before t_max, and neither t nor index.
template <class Policy, bool kRows, bool kSoup, bool kAny>
__global__ void __launch_bounds__(kThreads) nearest_scan(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, const float4* __restrict__ aos,
    const float* __restrict__ chunk_box, int n_rays, int n_tri,
    const float* __restrict__ table, float* __restrict__ t_out,
    int* __restrict__ idx_out, float* __restrict__ rows_out,
    unsigned char* __restrict__ any_out, const Visit visit) {
  static_assert(!(kAny && kRows), "an any-hit query has no winner");
  __shared__ SharedRay s_ray[kRaysPerBlock];
  __shared__ unsigned long long s_key[kRaysPerBlock];
  __shared__ unsigned short s_list[kRaysPerBlock];  // the rays that need the chunk
  // a warp's pool of surviving pairs: ray of the block << 5 | lane
  __shared__ unsigned short s_pool[kWarps][kWarpPool];
  __shared__ int s_pooled[kWarps];  // pairs in each warp's pool
  __shared__ int s_listed[2];  // listed rays, by the chunk's parity
  const int first = blockIdx.x * kRaysPerBlock;
  Ray ray[kR];
  float ix[kR], iy[kR], iz[kR];
  if (threadIdx.x < 2) s_listed[threadIdx.x] = 0;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int slot = k * kThreads + threadIdx.x;
    const bool live = first + slot < n_rays;
    const int g = min(first + slot, n_rays - 1);
    Ray& r = ray[k];
    r.ox = origin[3 * g + 0];
    r.oy = origin[3 * g + 1];
    r.oz = origin[3 * g + 2];
    r.dx = direction[3 * g + 0];
    r.dy = direction[3 * g + 1];
    r.dz = direction[3 * g + 2];
    const float omax = fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
    const float dmax = fmaxf(fmaxf(fabsf(r.dx), fabsf(r.dy)), fabsf(r.dz));
    // fmaxf drops a NaN operand, so test the components themselves
    const bool tame = omax < kWild && dmax < kWild && r.ox == r.ox &&
                      r.oy == r.oy && r.oz == r.oz && r.dx == r.dx &&
                      r.dy == r.dy && r.dz == r.dz;
    r.kd = tame ? kSlack * fmaxf(dmax, 1.0f) : CUDART_INF_F;
    r.ko = tame ? r.kd * omax : CUDART_INF_F;
    r.dd = __fmaf_rn(r.dz, r.dz, __fmaf_rn(r.dy, r.dy, r.dx * r.dx));
    r.ddk = r.dd * (1.0f - 64.0f * 5.9604644775390625e-08f);
    ix[k] = rcp_newton(safe(r.dx));
    iy[k] = rcp_newton(safe(r.dy));
    iz[k] = rcp_newton(safe(r.dz));
    s_ray[slot].o_kd = make_float4(r.ox, r.oy, r.oz, r.kd);
    s_ray[slot].d_ko = make_float4(r.dx, r.dy, r.dz, r.ko);
    s_ray[slot].dd_ddk = make_float4(r.dd, r.ddk, 0.0f, 0.0f);
    // a slot past the last ray never asks for a chunk
    s_key[slot] = live ? start_key<kSoup>(t_max[g], visit.active, g) : 0ull;
  }
  __syncthreads();
  const int n_visit = kSoup ? visit.n_visit : (n_tri + kChunk - 1) / kChunk;
  for (int v = 0, parity = 0; v < n_visit; ++v, parity ^= 1) {
    int chunk = v;
    if constexpr (kSoup) chunk = visit.chunks[v];
    const int base = chunk * kChunk;  // the chunk's first row of the table
    int n_real = min(kChunk, n_tri - base), first_index = base;
    if constexpr (kSoup) n_real = visit.count[chunk], first_index = visit.first[chunk];
    // list the rays whose segment [0, best_t) can enter the chunk's box
    const float* box = chunk_box + 8 * chunk;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int slot = k * kThreads + threadIdx.x;
      const float best_t = key_t(s_key[slot]);
      if (slab_hit(box, ray[k], ix[k], iy[k], iz[k], best_t))
        s_list[atomicAdd(&s_listed[parity], 1)] = static_cast<unsigned short>(slot);
    }
    if (threadIdx.x == 0) s_listed[parity ^ 1] = 0;
    // this thread's triangle: the head of its row, for sphere_miss()
    const float4* row = aos + (size_t)(base + threadIdx.x) * kRowFloat4;
    const float4 h[kHeadFloat4] = {row[0], row[1], row[2]};
    __syncthreads();
    const int listed = s_listed[parity];
    if (listed == 0) continue;  // uniform: every thread reads the same count
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lanes_below = (1u << lane) - 1;
    const bool real = threadIdx.x < n_real;
    // pairs in this warp's pool; every lane counts the same ballots, so
    // the count needs no atomic
    int pooled = 0;
#pragma unroll 2
    for (int i = 0; i < listed; ++i) {
      const int slot = s_list[i];
      const Ray r = s_ray[slot].load();
      const bool keep = !sphere_miss<Policy>(r, h) & real;
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (mask) {
        if (keep) {
          const int at = pooled + __popc(mask & lanes_below);
          if (at < kWarpPool)
            s_pool[warp][at] = static_cast<unsigned short>(slot << 5 | lane);
          else  // the pool is full: test the pair here and now
            test_pair<Policy, kAny>(r, row, &s_key[slot], first_index + threadIdx.x);
        }
        pooled += __popc(mask);
      }
    }
    if (lane == 0) s_pooled[warp] = min(pooled, kWarpPool);
    __syncthreads();
    // the block's threads share out the pooled pairs, whichever warp's
    int upto[kWarps];  // pairs in the pools of warps 0..w
#pragma unroll
    for (int w = 0; w < kWarps; ++w) upto[w] = s_pooled[w] + (w ? upto[w - 1] : 0);
    for (int e = threadIdx.x; e < upto[kWarps - 1]; e += kThreads) {
      int w = 0, before = 0;
#pragma unroll
      for (int v = 0; v < kWarps - 1; ++v)
        if (e >= upto[v]) w = v + 1, before = upto[v];
      const unsigned entry = s_pool[w][e - before];
      const int slot = entry >> 5, j = 32 * w + (entry & 31);
      test_pair<Policy, kAny>(s_ray[slot].load(), aos + (size_t)(base + j) * kRowFloat4,
                              &s_key[slot], first_index + j);
    }
    __syncthreads();
  }
  int best_i[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int slot = k * kThreads + threadIdx.x;
    const int g = first + slot;
    const unsigned long long key = s_key[slot];
    best_i[k] = -1;
    if (g < n_rays) {
      // a key that left its start took a hit; a start of 0 never leaves
      const bool hit = key != start_key<kSoup>(t_max[g], visit.active, g);
      if constexpr (kAny) {
        any_out[g] = hit;
      } else {
        best_i[k] = hit ? static_cast<int>(static_cast<unsigned>(key)) : -1;
        t_out[g] = hit ? key_t(key) : CUDART_INF_F;
        idx_out[g] = best_i[k];
      }
    }
  }
  if constexpr (kRows) {
    // the block copies its winners' rows together, 32 threads to a row,
    // so every load and store is one coalesced 128-byte line
    __shared__ int s_row[kRaysPerBlock];
#pragma unroll
    for (int k = 0; k < kR; ++k)
      s_row[k * kThreads + threadIdx.x] = max(best_i[k], 0);
    __syncthreads();
    const int n_here = min(kRaysPerBlock, n_rays - first);
    for (int i = threadIdx.x; i < n_here * kTableWidth; i += kThreads) {
      const int r = i / kTableWidth;
      const int col = i - r * kTableWidth;
      rows_out[(size_t)(first + r) * kTableWidth + col] =
          table[(size_t)s_row[r] * kTableWidth + col];
    }
  }
}

template <class Policy, bool kRows, bool kSoup = false, bool kAny = false>
int launch_scan(const float* origin, const float* direction,
                const float* t_max, const float* aos, const float* chunk_box,
                int n_rays, int n_tri, const float* table, float* t_out,
                int* idx_out, float* rows_out, cudaStream_t stream,
                unsigned char* any_out = nullptr, const Visit& visit = Visit()) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    nearest_scan<Policy, kRows, kSoup, kAny><<<blocks, kThreads, 0, stream>>>(
        origin, direction, t_max, reinterpret_cast<const float4*>(aos),
        chunk_box, n_rays, n_tri, table, t_out, idx_out, rows_out, any_out, visit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace theia
