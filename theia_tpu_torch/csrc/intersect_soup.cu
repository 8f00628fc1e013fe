// Moeller-Trumbore nearest hit, any hit and the MIS shadow pair over the
// chunks of a triangle table: the MT pack's whole table, or some groups of
// the brute-force soup's. Each entry point is one instantiation of the
// scan of csrc/nearest_scan.cuh (which holds the design notes and what
// bounds it on an H100) with the policy of csrc/moller_trumbore.cuh.
//
// Replaces, with the same per-pair test in the same operation order (1/det
// as a correctly rounded reciprocal plus one Newton step, det cutoff
// 1e-12, barycentric tolerance +-1e-6, t > 0, a hit only strictly before
// t_max, the lowest index on ties):
//   theia_soup_nearest       theia_tpu/ops/intersect_mt_pallas.py (_call ->
//                            _kernel, with the helpers of
//                            ops/_intersect_tiles.py) over the MT pack's
//                            every chunk; and theia_tpu/accel.py
//                            nearest_in_soup (l.73: a lax.scan over chunks
//                            of 256 triangles with a lexicographic (t,
//                            index) reduce) with what nearest_culled
//                            (l.372) adds, a set of instances and a lane
//                            mask: t and index of the nearest hit, inf / -1
//                            on a miss or a masked lane;
//   theia_soup_nearest_rows  the same plus each winner's 32-float row of
//                            `table` (row 0 on a miss): tools/exp_mt_fused.py
//                            (_call_rows -> _kernel_rows) on the MT pack,
//                            the primary query's rows on the soup;
//   theia_soup_anyhit        anyhit_in_soup (l.188, a fori_loop that ORs the
//                            chunks' hits) with anyhit_culled's groups and
//                            mask (l.468): one byte a ray, is some triangle
//                            hit at 0 < t < t_max; 0 on a masked lane;
//   theia_soup_target        the split of intersect_target (l.688) whole:
//                            the nearest hit (with rows where `table` is
//                            given) over the detector chunks on the active
//                            lanes, then, in the same blocks, the any-hit
//                            over the occluder chunks from keys that start at
//                            the winners' t, on the lanes that found one;
//                            inf / -1 (row 0) where missed or occluded.
// The index is the row's 12th float (w[2].w, int bits): the MT pack's row,
// or the triangle's row of the scene's tables (tri_data) in the soup,
// whose groups are each in Morton order; `chunks` lists the chunks to
// visit and chunk_count gives the real rows of every chunk.

#include "moller_trumbore.cuh"

using theia::args;
using theia::MollerTrumbore;

// aos: f32 (n_table_chunks * 256, 20); chunk_box: f32 (n_table_chunks, 8);
// sub_box: f32 (n_table_chunks * 8, 8); chunk_count: i32 (n_table_chunks,);
// chunks: i32 (n_visit,); active: u8 (n_rays,) or null
extern "C" int theia_soup_nearest(const float* origin, const float* direction,
                                  const float* t_max, const unsigned char* active,
                                  const float* aos, const float* chunk_box,
                                  const float* sub_box, const int* chunk_count,
                                  const int* chunks, int n_visit, int n_rays,
                                  float* t_out, int* idx_out, cudaStream_t stream) {
  theia::Args a = args(origin, direction, t_max, active, aos, chunk_box, sub_box,
                       chunk_count, chunks, n_visit, n_rays);
  a.t_out = t_out, a.idx_out = idx_out;
  return theia::launch<MollerTrumbore, false, theia::kNearest>(a, stream);
}

// table: f32 (rows, 32) with a row for every index; rows_out: f32 (n_rays, 32)
extern "C" int theia_soup_nearest_rows(
    const float* origin, const float* direction, const float* t_max,
    const unsigned char* active, const float* aos, const float* chunk_box,
    const float* sub_box, const int* chunk_count, const int* chunks, int n_visit,
    int n_rays, const float* table, float* t_out, int* idx_out, float* rows_out,
    cudaStream_t stream) {
  theia::Args a = args(origin, direction, t_max, active, aos, chunk_box, sub_box,
                       chunk_count, chunks, n_visit, n_rays);
  a.table = table, a.t_out = t_out, a.idx_out = idx_out, a.rows_out = rows_out;
  return theia::launch<MollerTrumbore, true, theia::kNearest>(a, stream);
}

// any_out: u8 (n_rays,)
extern "C" int theia_soup_anyhit(const float* origin, const float* direction,
                                 const float* t_max, const unsigned char* active,
                                 const float* aos, const float* chunk_box,
                                 const float* sub_box, const int* chunk_count,
                                 const int* chunks, int n_visit, int n_rays,
                                 unsigned char* any_out, cudaStream_t stream) {
  theia::Args a = args(origin, direction, t_max, active, aos, chunk_box, sub_box,
                       chunk_count, chunks, n_visit, n_rays);
  a.any_out = any_out;
  return theia::launch<MollerTrumbore, false, theia::kAnyHit>(a, stream);
}

// chunks: the detector's chunks; occluders: the rest's (n_occluders may be
// 0); table and rows_out: as theia_soup_nearest_rows, or both null
extern "C" int theia_soup_target(const float* origin, const float* direction,
                                 const float* t_max, const unsigned char* active,
                                 const float* aos, const float* chunk_box,
                                 const float* sub_box, const int* chunk_count,
                                 const int* chunks, int n_visit,
                                 const int* occluders, int n_occluders, int n_rays,
                                 const float* table, float* t_out, int* idx_out,
                                 float* rows_out, cudaStream_t stream) {
  theia::Args a = args(origin, direction, t_max, active, aos, chunk_box, sub_box,
                       chunk_count, chunks, n_visit, n_rays);
  a.occluders = occluders, a.n_occluders = n_occluders;
  a.table = table, a.t_out = t_out, a.idx_out = idx_out, a.rows_out = rows_out;
  if (table != nullptr) return theia::launch<MollerTrumbore, true, theia::kTarget>(a, stream);
  return theia::launch<MollerTrumbore, false, theia::kTarget>(a, stream);
}
