// The Moeller-Trumbore policy of the scan in csrc/nearest_scan.cuh: the
// per-pair arithmetic (guard, reject, exact) of every query that
// csrc/intersect_soup.cu launches, over the MT pack's table and over the
// brute-force soup's. One exact(): the nearest hit over a scene, the
// nearest hit over some groups of the soup and the any-hit all run the
// same operations in the same order, so a shadow ray's winner can never
// occlude itself by an ulp.
//
// The table row (ops/intersect_mt.mt_aos, 20 floats):
//   c xyz, r2 | n xyz, alpha | beta_w, beta, e2 z, index | v0 xyz, e1 x |
//   e1 yz, e2 xy
// (index: the row's index as int32 bits, see csrc/nearest_scan.cuh). c is
// the centroid, r2 = 1.7 R0^2 with R0 the largest distance from c to
// a vertex, n = e1 x e2 (float64, rounded to float32), and
//   alpha = E1 + E2 + E1*E2,  beta = 3*E1*E2 + 1e-30,
//   beta_w = beta + 1.75*R0*alpha,   E1 = max|e1_k|, E2 = max|e2_k|
// (beta = beta_w = inf for a triangle with a coordinate of 1e9 or more).
//
// reject(): exact() accepts only if b1 = U/det, b2 = V/det and t = W/det,
// as it rounds them, satisfy b1, b2 >= -1e-6, b1 + b2 <= 1 + 1e-6, t > 0,
// with T = o - v0 and the triple products
//   U = T.(d x e2) = e2.(T x d)      V = d.(T x e1) = -e1.(T x d)
//   det = e1.(d x e2) = -d.n         W = e2.(T x e1) = T.n.
// reject() forms the right-hand sides (one cross product and four dot
// products in fmaf) and tests the same inequalities multiplied through by
// |det|, with s = sign(det):
//   s*U >= -lo,  s*V >= -lo,  s*(U + V) <= |det| + lo,
//   s*W >= -S unless |det| <= S,       lo = 4e-6*|det| + S.
// The slack S bounds the rounding that separates the two evaluations. Both
// approximate the same real number (T is one rounded subtraction, the
// same in both); a dot of cross products of float32 values carries an
// error of at most 5.1u times the sum of the absolute values of its
// terms (u = 2^-24), the rounded n adds 1u, and those sums are at most
//   2 * |T|_1 * dmax * E   (U with E2, V with E1),   2 * |T|_1 * E1 * E2   (W),
//   6 * dmax * E1 * E2   (det),              dmax = max|d_k|.
// Adding both evaluations: eps_U <= 21u |T|_1 dmax E2, eps_V <= 21u |T|_1
// dmax E1, eps_W <= 19u |T|_1 E1 E2, eps_det <= 56u dmax E1 E2. The
// reciprocal and the products by it add a relative 5u, covered by testing
// against 4e-6 |det| where exact() tests against 1e-6. If the two
// evaluations disagree on sign(det), both |det| are below eps_det, an
// accepted pair has |U|, |V| <= 1.1 eps_det, and the tests hold with
// S >= eps_U + eps_V + 5 eps_det; the W test is skipped there. So
//   S = 2^-17 * max(dmax, 1) * (|T|_1 * alpha + beta)
// (128u, at least twice what the bounds ask) never rejects a pair that
// exact() accepts. The sums of absolute values are bounded through norms
// rather than carried, which costs 4 operations a pair instead of ~12;
// S stays far below |det| except for grazing rays, which is where the
// exact test has to decide anyway. NaN fails every comparison and an
// infinite S (wild rays, huge triangles) passes them all, so both go to
// exact(). Padding rows are not visited (the chunk's count). guard() is 4 S
// with |T|_1 replaced by its bound |w|_1 + sqrt(3) R0 (w = c - o), for
// the bounding-sphere test.

#pragma once

#include "nearest_scan.cuh"

namespace theia {

struct MollerTrumbore {
  static __device__ __forceinline__ float guard(const Ray& r,
                                                const float4 (&h)[3], float w1) {
    return (4.0f * r.kd) * __fmaf_rn(w1, h[1].w, h[2].x);
  }

  static __device__ __forceinline__ bool reject(const Ray& r,
                                                const float4 (&w)[5]) {
    const float e1x = w[3].w, e1y = w[4].x, e1z = w[4].y;
    const float e2x = w[4].z, e2y = w[4].w, e2z = w[2].z;
    const float nx = w[1].x, ny = w[1].y, nz = w[1].z;
    const float tx = r.ox - w[3].x, ty = r.oy - w[3].y, tz = r.oz - w[3].z;
    // c = T x d
    const float cx = __fmaf_rn(ty, r.dz, -(tz * r.dy));
    const float cy = __fmaf_rn(tz, r.dx, -(tx * r.dz));
    const float cz = __fmaf_rn(tx, r.dy, -(ty * r.dx));
    const float u = __fmaf_rn(e2z, cz, __fmaf_rn(e2y, cy, e2x * cx));
    // vn = -V and dn = -det: the signs go into the flips below
    const float vn = __fmaf_rn(e1z, cz, __fmaf_rn(e1y, cy, e1x * cx));
    const float dn = __fmaf_rn(r.dz, nz, __fmaf_rn(r.dy, ny, r.dx * nx));
    const float ww = __fmaf_rn(tz, nz, __fmaf_rn(ty, ny, tx * nx));
    const float t1 = fabsf(tx) + fabsf(ty) + fabsf(tz);
    const float s = r.kd * __fmaf_rn(t1, w[1].w, w[2].y);
    const float adet = fabsf(dn);
    const float lo = __fmaf_rn(adet, 4e-6f, s);
    const unsigned neg = __float_as_uint(dn) & 0x80000000u;  // set where det > 0
    const unsigned pos = neg ^ 0x80000000u;                  // set where det < 0
    const float su = theia::flip(u, pos), sv = theia::flip(vn, neg);
    return theia::rejected(su, sv, theia::flip(ww, pos), adet, lo, s);
  }

  // the test of the first kernel, in its operation order (the contract
  // with nearest_triangle_mt_plain); separate multiplies and adds
  static __device__ __forceinline__ bool exact(const Ray& r,
                                               const float4 (&w)[5], float& t) {
    const float v0x = w[3].x, v0y = w[3].y, v0z = w[3].z;
    const float e1x = w[3].w, e1y = w[4].x, e1z = w[4].y;
    const float e2x = w[4].z, e2y = w[4].w, e2z = w[2].z;
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv =
        fabsf(det) > 1e-12f ? theia::rcp_newton(theia::safe(det)) : 0.0f;
    const float tx = r.ox - v0x;
    const float ty = r.oy - v0y;
    const float tz = r.oz - v0z;
    const float b1 = (tx * px + ty * py + tz * pz) * inv;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float b2 = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    // 1.000001f is float32(1.0 + 1e-6), the bound the JAX kernel uses
    return inv != 0.0f && b1 >= -1e-6f && b2 >= -1e-6f &&
           b1 + b2 <= 1.000001f && t > 0.0f;
  }
};

}  // namespace theia
