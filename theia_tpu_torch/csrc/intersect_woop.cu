// Woop unit-triangle nearest hit over a triangle soup, one thread per ray.
//
// Replaces theia_tpu/ops/intersect_woop.py (_call -> _kernel, with the
// helpers rcp/safe/block_slab_hit/select_winner of ops/_intersect_tiles.py).
// Each triangle carries an affine map M (3x3 linear part m, offset f) into
// its unit-triangle space, so that for a ray o + t d
//   o'_c = m_c . o + f_c,   d'_c = m_c . d        (c = b1, b2, z)
//   t = -o'_z * rcp(d'_z),  b1 = o'_b1 + t d'_b1,  b2 = o'_b2 + t d'_b2
// and the pair hits iff t > 0, b1 >= -1e-6, b2 >= -1e-6 and
// b1 + b2 <= 1 + 1e-6; a hit counts only if strictly closer than the
// running t (which starts at t_max), so the lowest index wins ties.
//
// Summation order, the contract with the plain version
// (nearest_triangle_woop_plain in ops/intersect_woop.py):
//   o'_c = ((o_x * m_c0 + o_y * m_c1) + o_z * m_c2) + f_c
//   d'_c = (d_x * m_c0 + d_y * m_c1) + d_z * m_c2
// The TPU kernel forms the same sums as one [o, 1, d, 0] (8) x B (8, 6*BT)
// product per tile; the terms left out here are the product's structural
// zeros (d against the o' columns, o and 1 against the d' columns, and the
// trailing 0), which add nothing to a finite sum. The plain version leaves
// out the same terms. rcp is __frcp_rn plus one Newton step r*(2-v*r), as
// in kernel 1 (csrc/intersect_mt.cu); the file is built with -fmad=false,
// so every product and sum rounds like the plain version's separate ops
// and t and idx are bit-equal. Padding and degenerate triangles have m = 0
// and f = 3e38: there d'_z = 0, rcp gives inf, the Newton step NaN, and
// t > 0 is false in both versions. Padding past n_tri is not visited.
//
// What bounds it on an H100: FP32 ALU issue, ~25 dependent multiplies and
// adds and one reciprocal per (ray, triangle) pair (against ~35 for
// Moeller-Trumbore); the 12 transform floats of a triangle are shared by
// every ray, so memory traffic is negligible. The TPU kernel puts the
// transform on the MXU at precision "highest" (f32-exact); tensor cores in
// TF32 fall short of that, so this kernel stays on the FP32 pipes.
//
// Design: a block of 256 rays keeps each ray's (t, idx) in registers and
// walks the triangles in chunks of 256 (kChunk, equal to CHUNK in
// ops/intersect_mt.py). A ray tests a chunk only if its segment [0, t)
// enters the chunk's widened box (chunk_box, the same boxes as kernel 1,
// derived from the world triangles); a block stages a chunk's transforms
// (12 x 256 floats) in shared memory only if one of its rays needs it, and
// every thread then reads the same shared word, a broadcast.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRaysPerBlock = 256;
constexpr int kChunk = 256;   // triangles per skip chunk / shared-memory pass
constexpr int kTile = 512;    // triangles per tile of the packed table (BT)
constexpr int kRowsB = 8;     // rows of the packed table per tile
constexpr int kFloats = 12;   // transform floats per triangle

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

// b is (T_tiles, 8, 6 * kTile): for triangle j of a tile, column c * kTile + j
// holds rows (m_c0, m_c1, m_c2, f_c, 0, 0, 0, 0) and column (3 + c) * kTile + j
// rows (0, 0, 0, 0, m_c0, m_c1, m_c2, 0). Shared row 4 * c + k takes row k of
// column c * kTile + j, so s_m[4c..4c+2] = m_c and s_m[4c+3] = f_c.
__global__ void __launch_bounds__(kRaysPerBlock) woop_nearest(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, const float* __restrict__ b,
    const float* __restrict__ chunk_box, int n_rays, int n_tri,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float s_m[kFloats][kChunk];
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
    for (int k = threadIdx.x; k < kFloats * kChunk; k += kRaysPerBlock) {
      const int row = k / kChunk;
      const int col = k - row * kChunk;
      if (col < count) {
        const int g = base + col;
        const int tile = g / kTile;
        const int c = row / 4;
        s_m[row][col] = b[((size_t)tile * kRowsB + (row - 4 * c)) * (6 * kTile) +
                          c * kTile + (g - tile * kTile)];
      }
    }
    __syncthreads();
    if (cand) {
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const float o1 = ((ox * s_m[0][j] + oy * s_m[1][j]) + oz * s_m[2][j]) + s_m[3][j];
        const float o2 = ((ox * s_m[4][j] + oy * s_m[5][j]) + oz * s_m[6][j]) + s_m[7][j];
        const float o3 = ((ox * s_m[8][j] + oy * s_m[9][j]) + oz * s_m[10][j]) + s_m[11][j];
        const float d1 = (dx * s_m[0][j] + dy * s_m[1][j]) + dz * s_m[2][j];
        const float d2 = (dx * s_m[4][j] + dy * s_m[5][j]) + dz * s_m[6][j];
        const float d3 = (dx * s_m[8][j] + dy * s_m[9][j]) + dz * s_m[10][j];
        const float t = -o3 * rcp_newton(d3);
        const float b1 = o1 + t * d1;
        const float b2 = o2 + t * d2;
        // 1.000001f is float32(1.0 + 1e-6), the bound the JAX kernel uses
        const bool hit = t > 0.0f && b1 >= -1e-6f && b2 >= -1e-6f &&
                         b1 + b2 <= 1.000001f;
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

extern "C" int theia_woop_nearest(const float* origin, const float* direction,
                                  const float* t_max, const float* b,
                                  const float* chunk_box, int n_rays,
                                  int n_tri, float* t_out, int* idx_out,
                                  cudaStream_t stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    woop_nearest<<<blocks, kRaysPerBlock, 0, stream>>>(
        origin, direction, t_max, b, chunk_box, n_rays, n_tri, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
