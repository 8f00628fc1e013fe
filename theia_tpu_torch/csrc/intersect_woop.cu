// Woop unit-triangle nearest hit over a triangle soup.
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
// Summation order of exact(), the contract with the plain version
// (nearest_triangle_woop_plain in ops/intersect_woop.py):
//   o'_c = ((o_x * m_c0 + o_y * m_c1) + o_z * m_c2) + f_c
//   d'_c = (d_x * m_c0 + d_y * m_c1) + d_z * m_c2
// The TPU kernel forms the same sums as one [o, 1, d, 0] (8) x B (8, 6*BT)
// product per tile; the terms left out here are the product's structural
// zeros (d against the o' columns, o and 1 against the d' columns, and the
// trailing 0), which add nothing to a finite sum. The plain version leaves
// out the same terms. rcp is __frcp_rn plus one Newton step r*(2-v*r), as
// in csrc/moller_trumbore.cuh; the file is built with -fmad=false, so every
// product and sum of exact() rounds like the plain version's separate ops
// and t and idx are bit-equal. Degenerate triangles have m = 0 and f =
// 3e38: there d'_z = 0, rcp gives inf, the Newton step NaN, and t > 0 is
// false in both versions. Padding rows are not visited (the chunk's count).
//
// The query is the scan of csrc/nearest_scan.cuh (which holds the design
// notes, what bounds it on an H100 and the bounding-sphere test that every
// needed pair runs first) over every chunk of the pack's table, with this
// policy; the index of a row is its place in the table.
//
// Set aside: o' and d' on the tensor cores, as the TPU forms them on its
// matrix unit. The product has depth 4 in real terms (8 with the
// structural zeros), TF32 keeps 10 mantissa bits where the TPU kernel
// asks for precision "highest" (float32-exact), and a 3xTF32 split sums in
// another order than the plain version, so it is not bit-equal to it.
//
// The table row (tri_aos of WoopPack, 20 floats):
//   c xyz, r2 | m_z (3), f_z | P, Q, 0, index | m_b1 (3), f_b1 | m_b2 (3), f_b2
// (index: the row's index as int32 bits, see csrc/nearest_scan.cuh)
// The float32 map (m, f) defines the triangle that exact() tests: its
// vertices are the preimages of (0,0), (1,0), (0,1) at z = 0 (float64
// inverse of m); c is their centroid, r2 = 2.8 R0^2 with R0 the largest
// distance from c to one of them, and with M_c = |m_c|_1, F_c = |f_c|
//   P = 2 M_z (M_1 + M_2) + M_z
//   Q = M_z (F_1 + F_2) + F_z (M_1 + M_2) + M_z + F_z + 1e-30
// (Q = inf for padding, degenerate and huge triangles: |m| or |f| >= 1e9).
//
// reject(): exact()'s inequalities multiplied through by |d'_z|, with
// s = sign(d'_z), U = o'_1 d'_z - o'_z d'_1, V = o'_2 d'_z - o'_z d'_2:
//   s*U >= -lo,  s*V >= -lo,  s*(U + V) <= |d'_z| + lo,
//   -s*o'_z >= -S unless |d'_z| <= S,     lo = 4e-6*|d'_z| + S.
// o' and d' are formed in fmaf here and in separate operations in
// exact(); each carries an error of at most 4.1u A_c (o') or 3.1u D_c (d')
// with u = 2^-24, A_c = sum|o_k m_ck| + |f_c| <= omax M_c + F_c and
// D_c = sum|d_k m_ck| <= dmax M_c. Carrying both errors, exact()'s
// reciprocal (relative 5u) and the rounding of U and V through the
// products gives eps_U <= 23u (A_1 D_z + A_z D_1), likewise eps_V,
// eps_o'z <= 8.2u A_z and eps_d'z <= 6.2u D_z; where the two evaluations
// disagree on sign(d'_z), both |d'_z| are below eps_d'z, an accepted pair
// has |U|, |V| below 1.1 eps_d'z + 6.1u A_z D_c, and the o'_z test is
// skipped. All of it is below
//   S = 2^-17 * max(dmax, 1) * (omax * P + Q)
// (128u against the 23u the bounds ask), so reject() never rejects a pair
// that exact() accepts. The bound goes through norms of the ray (omax =
// max|o_k|, dmax = max|d_k|) and of the triangle's rows rather than
// carried absolute sums: 2 instructions a pair. NaN fails every
// comparison and an infinite S passes them all, so both go to exact().
// guard() is S itself, for the bounding-sphere test.

#include "nearest_scan.cuh"

namespace {

using theia::Ray;

struct Woop {
  static __device__ __forceinline__ float guard(const Ray& r,
                                                const float4 (&h)[3], float) {
    return __fmaf_rn(r.ko, h[2].x, r.kd * h[2].y);
  }

  // m(c): row c of the map as (m_c0, m_c1, m_c2, f_c)
  static __device__ __forceinline__ float to_unit(const float4& m, float x,
                                                  float y, float z) {
    return __fmaf_rn(x, m.x, __fmaf_rn(y, m.y, __fmaf_rn(z, m.z, m.w)));
  }
  static __device__ __forceinline__ float turn(const float4& m, float x,
                                               float y, float z) {
    return __fmaf_rn(x, m.x, __fmaf_rn(y, m.y, z * m.z));
  }

  static __device__ __forceinline__ bool reject(const Ray& r,
                                                const float4 (&w)[5]) {
    const float o1 = to_unit(w[3], r.ox, r.oy, r.oz);
    const float o2 = to_unit(w[4], r.ox, r.oy, r.oz);
    const float o3 = to_unit(w[1], r.ox, r.oy, r.oz);
    const float d1 = turn(w[3], r.dx, r.dy, r.dz);
    const float d2 = turn(w[4], r.dx, r.dy, r.dz);
    const float d3 = turn(w[1], r.dx, r.dy, r.dz);
    const float u = __fmaf_rn(o1, d3, -(o3 * d1));
    const float v = __fmaf_rn(o2, d3, -(o3 * d2));
    const float s = __fmaf_rn(r.ko, w[2].x, r.kd * w[2].y);
    const float adet = fabsf(d3);
    const float lo = __fmaf_rn(adet, 4e-6f, s);
    const unsigned sign = __float_as_uint(d3) & 0x80000000u;
    const float su = theia::flip(u, sign), sv = theia::flip(v, sign);
    // W = -o'_z
    return theia::rejected(su, sv, theia::flip(o3, sign ^ 0x80000000u), adet, lo, s);
  }

  // the test of the first kernel, in its operation order; separate
  // multiplies and adds
  static __device__ __forceinline__ bool exact(const Ray& r,
                                               const float4 (&w)[5], float& t) {
    const float4 &m1 = w[3], &m2 = w[4], &m3 = w[1];
    const float o1 = ((r.ox * m1.x + r.oy * m1.y) + r.oz * m1.z) + m1.w;
    const float o2 = ((r.ox * m2.x + r.oy * m2.y) + r.oz * m2.z) + m2.w;
    const float o3 = ((r.ox * m3.x + r.oy * m3.y) + r.oz * m3.z) + m3.w;
    const float d1 = (r.dx * m1.x + r.dy * m1.y) + r.dz * m1.z;
    const float d2 = (r.dx * m2.x + r.dy * m2.y) + r.dz * m2.z;
    const float d3 = (r.dx * m3.x + r.dy * m3.y) + r.dz * m3.z;
    t = -o3 * theia::rcp_newton(d3);
    const float b1 = o1 + t * d1;
    const float b2 = o2 + t * d2;
    // 1.000001f is float32(1.0 + 1e-6), the bound the JAX kernel uses
    return t > 0.0f && b1 >= -1e-6f && b2 >= -1e-6f && b1 + b2 <= 1.000001f;
  }
};

}  // namespace

// aos: f32 (n_chunks * 256, 20), WoopPack.tri_aos; chunk_box: f32
// (n_chunks, 8); sub_box: f32 (n_chunks * 8, 8); chunk_count, chunks: i32
// (n_chunks,)
extern "C" int theia_woop_nearest(const float* origin, const float* direction,
                                  const float* t_max, const float* aos,
                                  const float* chunk_box, const float* sub_box,
                                  const int* chunk_count, const int* chunks,
                                  int n_chunks, int n_rays, float* t_out,
                                  int* idx_out, cudaStream_t stream) {
  theia::Args a = theia::args(origin, direction, t_max, nullptr, aos, chunk_box, sub_box,
                              chunk_count, chunks, n_chunks, n_rays);
  a.t_out = t_out, a.idx_out = idx_out;
  return theia::launch<Woop, false, theia::kNearest>(a, stream);
}
