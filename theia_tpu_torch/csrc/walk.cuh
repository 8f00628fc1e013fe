// What the two walks (csrc/bvh_walk.cu, csrc/instanced_walk.cu) share: the
// clamped reciprocal of a ray's direction, the slab test of a box with
// NaN-propagating minima and maxima, the exact Moeller-Trumbore test of
// csrc/moller_trumbore.cuh on a triangle given as [v0, e1, e2], the tables
// staged in shared memory, and the pieces of a warp that works on one
// lane's triangles together: the loop over the lanes that hold work, and
// the reduction of the threads' hits to the least (t, row).
//
// Their plain twins (ops/bvh_traverse.py, ops/instanced.py) take minima and
// maxima with torch.minimum / torch.maximum, which spread a NaN, where
// fminf / fmaxf drop it; nmin / nmax spread it too, so that a lane with a
// NaN in its ray fails the same comparisons in both.

#pragma once

#include "moller_trumbore.cuh"

namespace theia {

constexpr unsigned kFullMask = 0xffffffffu;
// a thread's "no hit" in the (t, row) reduction
constexpr unsigned long long kNoHit = ~0ull;

// min.NaN / max.NaN (sm_80 on): a NaN if either input is one, in one
// instruction. The results feed comparisons only, where any NaN and either
// zero behave alike (the twins' torch.minimum returns +0 for (+0, -0)).
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// a table read from shared memory (kShared) or through the read-only cache
template <bool kShared, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// the exact test of the soup kernels on the triangle row p = [v0, e1, e2]
template <bool kShared>
__device__ __forceinline__ bool exact_row(const Ray& r, const float* p, float& t) {
  float4 w[5];
  w[2].z = ld<kShared>(p + 8);
  w[3] = make_float4(ld<kShared>(p + 0), ld<kShared>(p + 1), ld<kShared>(p + 2),
                     ld<kShared>(p + 3));
  w[4] = make_float4(ld<kShared>(p + 4), ld<kShared>(p + 5), ld<kShared>(p + 6),
                     ld<kShared>(p + 7));
  return MollerTrumbore::exact(r, w, t);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction, int i) {
  Ray r{};
  r.ox = origin[3 * i], r.oy = origin[3 * i + 1], r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i], r.dy = direction[3 * i + 1], r.dz = direction[3 * i + 2];
  return r;
}

// lane h's ray, to every thread of the warp
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int h) {
  Ray q{};
  q.ox = __shfl_sync(kFullMask, r.ox, h), q.oy = __shfl_sync(kFullMask, r.oy, h);
  q.oz = __shfl_sync(kFullMask, r.oz, h), q.dx = __shfl_sync(kFullMask, r.dx, h);
  q.dy = __shfl_sync(kFullMask, r.dy, h), q.dz = __shfl_sync(kFullMask, r.dz, h);
  return q;
}

// copy n elements of a table into shared memory, the whole block
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// The least hit_key (csrc/nearest_scan.cuh: t's bits, t > 0 and finite,
// above the row) of each aligned group of `width` lanes (a power of two up
// to 32), to every lane of the group. A thread keeps the least (t, row) of
// its own rows, taken in increasing order with a strict <, and the group's
// least key is then the winner of a sequential scan of all its rows with
// a strict <: the least t, the lowest row among equal t's.
__device__ __forceinline__ unsigned long long min_hit(unsigned long long key, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFullMask, key, off);
    key = other < key ? other : key;
  }
  return key;
}

// The pair loop: body(h) for every lane h set in `holders`, in lane order,
// the whole warp together (each call is one lane's work done by all 32
// threads).
template <class Body>
__device__ __forceinline__ void for_each_holder(unsigned holders, Body&& body) {
  while (holders) {
    const int h = __ffs(holders) - 1;
    holders &= holders - 1;
    body(h);
  }
}

// Grants kKernel `bytes` of dynamic shared memory on the current device
// (past 48 KB with its static shared memory a kernel has to ask), once for
// each size it grows to; returns the call's error, 0 on success.
constexpr int kMaxDevices = 64;

template <auto kKernel>
int grant_shared(int bytes) {
  if (bytes <= 0) return 0;
  static int granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && granted[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = bytes;
  return static_cast<int>(err);
}

// The blocks of `threads` threads and `bytes` of dynamic shared memory
// that fill the current device once (all resident together), for a
// persistent launch of kKernel, at least 1; kept for each device and the
// last size asked. Returns the error, 0 on success.
template <auto kKernel>
int resident_blocks(int threads, int bytes, int& blocks) {
  static int asked[kMaxDevices], known[kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && known[dev] > 0 && asked[dev] == bytes) {
    blocks = known[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, threads, bytes);
  blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (err == cudaSuccess && per_sm > 0 && dev < kMaxDevices) asked[dev] = bytes, known[dev] = blocks;
  return static_cast<int>(err);
}

}  // namespace theia
