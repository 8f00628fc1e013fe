// Moeller-Trumbore nearest hit over a triangle soup, optionally with each
// winner's table row.
//
// Replaces theia_tpu/ops/intersect_mt_pallas.py (_call -> _kernel, with
// the helpers rcp/safe/select_winner of ops/_intersect_tiles.py): the same
// per-pair test in the same operation order, 1/det as a correctly rounded
// reciprocal plus one Newton step r*(2-v*r), det cutoff 1e-12, barycentric
// tolerance +-1e-6, t > 0, and a strict t < t_running update so a hit must
// be closer than t_max and the lowest index wins ties. The kRows variant
// also replaces tools/exp_mt_fused.py (_call_rows -> _kernel_rows): after
// the scan it writes table[max(idx, 0)], one 32-float row per ray. kRows
// is a template flag: the scan is one body for both variants.
//
// What bounds it on an H100: FP32 issue (see csrc/nearest_scan.cuh, which
// holds the scan, the design notes and the bounding-sphere test that every
// needed pair runs first). That test costs 27 flop a pair in ~21
// instructions; the 1.03e8 pairs that 262,144 random rays need of the
// flagship's 3840 triangles (a tenth of all pairs) make 0.042 ms at the
// published 67 TFLOP/s. The row copy adds 128 bytes written and read per
// ray, from an L2-resident table.
// The table row and the two rejection tests are described in
// csrc/moller_trumbore.cuh, which holds the per-pair arithmetic.

#include "moller_trumbore.cuh"

using theia::MollerTrumbore;

// aos: f32 (n_chunks * 256, 20), MTPack.tri_aos
extern "C" int theia_mt_nearest(const float* origin, const float* direction,
                                const float* t_max, const float* aos,
                                const float* chunk_box, int n_rays, int n_tri,
                                float* t_out, int* idx_out,
                                cudaStream_t stream) {
  return theia::launch_scan<MollerTrumbore, false>(
      origin, direction, t_max, aos, chunk_box, n_rays, n_tri, nullptr, t_out,
      idx_out, nullptr, stream);
}

// table: f32 (rows >= n_tri, 32); rows_out: f32 (n_rays, 32)
extern "C" int theia_mt_nearest_rows(const float* origin,
                                     const float* direction,
                                     const float* t_max, const float* aos,
                                     const float* chunk_box, int n_rays,
                                     int n_tri, const float* table,
                                     float* t_out, int* idx_out,
                                     float* rows_out, cudaStream_t stream) {
  return theia::launch_scan<MollerTrumbore, true>(
      origin, direction, t_max, aos, chunk_box, n_rays, n_tri, table, t_out,
      idx_out, rows_out, stream);
}
