// Nearest hit and any hit over ranges of the brute-force triangle soup.
//
// Replaces two hot loops that theia_tpu leaves to XLA to fuse
// (theia_tpu/accel.py): nearest_in_soup (l.73, a lax.scan over chunks of
// 256 triangles with a lexicographic (t, index) reduce) and anyhit_in_soup
// (l.188, a fori_loop that ORs the chunks' hits), together with what
// nearest_culled / anyhit_culled add to them: a set of instances to scan
// and a mask of the lanes that need an answer. Eager PyTorch cannot fuse a
// chunked scan with its reduction, so both are kernels here, on the scan of
// csrc/nearest_scan.cuh (design note 5 there) with the Moeller-Trumbore
// arithmetic of csrc/moller_trumbore.cuh:
//   theia_soup_nearest       t and index of the nearest hit strictly before
//                            t_max, the lowest index on ties, inf / -1 on a
//                            miss or a masked lane;
//   theia_soup_nearest_rows  the same plus each winner's 32-float row of
//                            `table` (row 0 on a miss), for the primary
//                            query, whose hit is rebuilt from that row;
//   theia_soup_anyhit        one byte a ray: is some triangle hit at
//                            0 < t < t_max; 0 on a masked lane.
// The index is the triangle's row of the scene's tables (tri_data): the
// table `aos` starts every instance on a chunk boundary, and chunk_first /
// chunk_count say which rows a chunk holds. `chunks` lists the chunks to
// visit: those of the instances asked for.
//
// What bounds them on an H100: the FP32 pipes, as for the other scans: the
// pairs of unmasked lanes with chunks their segment can enter, 27 flop a
// pair in sphere_miss(). The any-hit visits fewer: a lane leaves the scan
// at its first hit, and the shadow pair of a scatter vertex asks it only
// for lanes whose detector hit it could block.
//
// Both queries run the one exact() of csrc/moller_trumbore.cuh. That is
// what lets the shadow query split: the occluders' any-hit is bounded by
// the detector hit's t, and a triangle's t comes out the same whichever
// query computes it.

#include "moller_trumbore.cuh"

using theia::MollerTrumbore;
using theia::Visit;

namespace {

Visit visit_of(const int* chunks, int n_visit, const int* chunk_first,
               const int* chunk_count, const unsigned char* active) {
  Visit v;
  v.chunks = chunks;
  v.n_visit = n_visit;
  v.first = chunk_first;
  v.count = chunk_count;
  v.active = active;
  return v;
}

}  // namespace

// aos: f32 (n_table_chunks * 256, 20); chunk_box: f32 (n_table_chunks, 8);
// chunk_first, chunk_count: i32 (n_table_chunks,); chunks: i32 (n_visit,);
// active: u8 (n_rays,) or null
extern "C" int theia_soup_nearest(const float* origin, const float* direction,
                                  const float* t_max,
                                  const unsigned char* active, const float* aos,
                                  const float* chunk_box,
                                  const int* chunk_first,
                                  const int* chunk_count, const int* chunks,
                                  int n_visit, int n_rays, float* t_out,
                                  int* idx_out, cudaStream_t stream) {
  return theia::launch_scan<MollerTrumbore, false, true, false>(
      origin, direction, t_max, aos, chunk_box, n_rays, 0, nullptr, t_out,
      idx_out, nullptr, stream, nullptr,
      visit_of(chunks, n_visit, chunk_first, chunk_count, active));
}

// table: f32 (rows, 32) with a row for every index a chunk reports;
// rows_out: f32 (n_rays, 32)
extern "C" int theia_soup_nearest_rows(
    const float* origin, const float* direction, const float* t_max,
    const unsigned char* active, const float* aos, const float* chunk_box,
    const int* chunk_first, const int* chunk_count, const int* chunks,
    int n_visit, int n_rays, const float* table, float* t_out, int* idx_out,
    float* rows_out, cudaStream_t stream) {
  return theia::launch_scan<MollerTrumbore, true, true, false>(
      origin, direction, t_max, aos, chunk_box, n_rays, 0, table, t_out,
      idx_out, rows_out, stream, nullptr,
      visit_of(chunks, n_visit, chunk_first, chunk_count, active));
}

// any_out: u8 (n_rays,)
extern "C" int theia_soup_anyhit(const float* origin, const float* direction,
                                 const float* t_max,
                                 const unsigned char* active, const float* aos,
                                 const float* chunk_box, const int* chunk_first,
                                 const int* chunk_count, const int* chunks,
                                 int n_visit, int n_rays,
                                 unsigned char* any_out, cudaStream_t stream) {
  return theia::launch_scan<MollerTrumbore, false, true, true>(
      origin, direction, t_max, aos, chunk_box, n_rays, 0, nullptr, nullptr,
      nullptr, nullptr, stream, any_out,
      visit_of(chunks, n_visit, chunk_first, chunk_count, active));
}
