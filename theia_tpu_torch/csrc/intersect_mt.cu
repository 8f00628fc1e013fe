// Moeller-Trumbore nearest hit over a triangle soup, one thread per ray.
//
// Replaces theia_tpu/ops/intersect_mt_pallas.py (_call -> _kernel, with
// the helpers rcp/safe/select_winner of ops/_intersect_tiles.py): the same
// per-pair test in the same operation order, 1/det as a correctly rounded
// reciprocal plus one Newton step r*(2-v*r), det cutoff 1e-12, barycentric
// tolerance +-1e-6, t > 0, and a strict t < t_running update so a hit must
// be closer than t_max and the lowest index wins ties.
//
// What bounds it on an H100: FP32 ALU issue. Each (ray, triangle) pair is
// ~35 dependent multiplies/adds and one reciprocal; the triangle operands
// are shared by every ray, so memory traffic is negligible. The file is
// built with -fmad=false so the products and sums round exactly like the
// plain PyTorch version's separate ops (bit-equal t and idx); that gives
// up the FMA's 2x issue rate, a trade for exactness that a later kernel
// may revisit.
//
// Design: a block of 256 rays keeps each ray's (t, idx) in registers and
// walks the triangles in chunks of 256 (kChunk, equal to CHUNK in
// ops/intersect_mt.py). A ray tests a chunk only if its segment [0, t)
// enters the chunk's widened box (chunk_box, built on the host side); a
// block loads a chunk into shared memory (9 x 256 floats) only if one of
// its rays needs it, and then every thread reads the same shared word, a
// broadcast without bank conflicts. This is the port's form of the TPU
// kernel's per-(ray block, tile) AABB skip: the box margin is far above
// rounding, so a skip never drops a hit, and the plain version skips with
// the same float32 arithmetic. Padding triangles (index >= n_tri) are not
// visited, as they can never hit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRaysPerBlock = 256;
constexpr int kChunk = 256;  // triangles per skip chunk / shared-memory pass

__device__ __forceinline__ float rcp_newton(float v) {
  const float r = __frcp_rn(v);
  return r * (2.0f - v * r);
}

// keep the reciprocal finite, preserving the sign (ops/_intersect_tiles.py:43)
__device__ __forceinline__ float safe(float v) {
  return fabsf(v) < 1e-20f ? (v < 0.0f ? -1e-20f : 1e-20f) : v;
}

// can the segment [0, best_t) of ray (o, 1/d) enter the box lo/hi?
__device__ __forceinline__ bool slab_hit(const float* __restrict__ box,
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float best_t) {
  const float t1x = (box[0] - ox) * ix, t2x = (box[4] - ox) * ix;
  const float t1y = (box[1] - oy) * iy, t2y = (box[5] - oy) * iy;
  const float t1z = (box[2] - oz) * iz, t2z = (box[6] - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                         fmaxf(fminf(t1z, t2z), 0.0f));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                         fmaxf(t1z, t2z));
  return tn <= tf && tn < best_t;
}

__global__ void __launch_bounds__(kRaysPerBlock) mt_nearest(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, const float* __restrict__ tri,
    const float* __restrict__ chunk_box, int n_rays, int n_tri, int bt,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float s_tri[9][kChunk];
  const int ray = blockIdx.x * kRaysPerBlock + threadIdx.x;
  const bool live = ray < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float best_t = 0.0f;
  int best_i = -1;
  if (live) {
    ox = origin[3 * ray + 0];
    oy = origin[3 * ray + 1];
    oz = origin[3 * ray + 2];
    dx = direction[3 * ray + 0];
    dy = direction[3 * ray + 1];
    dz = direction[3 * ray + 2];
    best_t = t_max[ray];
  }
  const float ix = rcp_newton(safe(dx));
  const float iy = rcp_newton(safe(dy));
  const float iz = rcp_newton(safe(dz));
  for (int base = 0; base < n_tri; base += kChunk) {
    const bool cand = live && slab_hit(chunk_box + 8 * (base / kChunk), ox, oy,
                                       oz, ix, iy, iz, best_t);
    // uniform branch: every thread of the block takes the same way
    if (!__syncthreads_or(cand)) continue;
    const int count = min(kChunk, n_tri - base);
    // tri is (T_tiles, 9, bt): row r of triangle g sits at
    // [(g / bt) * 9 + r] * bt + g % bt
    for (int k = threadIdx.x; k < 9 * kChunk; k += kRaysPerBlock) {
      const int row = k / kChunk;
      const int col = k - row * kChunk;
      if (col < count) {
        const int g = base + col;
        const int tile = g / bt;
        s_tri[row][col] = tri[((size_t)tile * 9 + row) * bt + (g - tile * bt)];
      }
    }
    __syncthreads();
    if (cand) {
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const float v0x = s_tri[0][j], v0y = s_tri[1][j], v0z = s_tri[2][j];
        const float e1x = s_tri[3][j], e1y = s_tri[4][j], e1z = s_tri[5][j];
        const float e2x = s_tri[6][j], e2y = s_tri[7][j], e2z = s_tri[8][j];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv = fabsf(det) > 1e-12f ? rcp_newton(safe(det)) : 0.0f;
        const float tx = ox - v0x;
        const float ty = oy - v0y;
        const float tz = oz - v0z;
        const float b1 = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float b2 = (dx * qx + dy * qy + dz * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        // 1.000001f is float32(1.0 + 1e-6), the bound the JAX kernel uses
        const bool hit = inv != 0.0f && b1 >= -1e-6f && b2 >= -1e-6f &&
                         b1 + b2 <= 1.000001f && t > 0.0f;
        if (hit && t < best_t) {
          best_t = t;
          best_i = base + j;
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    t_out[ray] = best_i < 0 ? CUDART_INF_F : best_t;
    idx_out[ray] = best_i;
  }
}

}  // namespace

extern "C" int theia_mt_nearest(const float* origin, const float* direction,
                                const float* t_max, const float* tri,
                                const float* chunk_box, int n_rays, int n_tri,
                                int bt, float* t_out, int* idx_out,
                                cudaStream_t stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    mt_nearest<<<blocks, kRaysPerBlock, 0, stream>>>(
        origin, direction, t_max, tri, chunk_box, n_rays, n_tri, bt, t_out,
        idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
