// The kernel histogram (binned KDE) record and its backward.
//
// Replaces theia_tpu/response.py KernelHistogramHitResponse.record
// (l.282-300), a jnp loop of 2 * support + 1 = 9 scatter-adds that XLA
// fuses, and the VJP that JAX derives for it. A lane's centre is c = (t -
// t0) / binSize on the detached time, its base bin floor(c); each bin b of
// base - support .. base + support in [0, nBins) gets value * w_b with w_b
// = exp(-z_b^2 / 2) * binSize / (h sqrt(2 pi)), z_b = (bc_b - t) / h at the
// bin centre bc_b = (b + 1/2) * binSize + t0. Masked lanes, ids out of
// [0, nDetectors) and lanes whose centre is not finite are dropped (the
// last a deliberate divergence: theia_tpu casts such a centre to an
// integer; ops and tests in response.py). The backward takes the state's
// gradient g: d value = sum_b g_b w_b and d t = sum_b g_b value w_b z_b / h
// a lane, d t0 = - sum of d t, d binSize = sum g_b value (w_b / binSize -
// w_b z_b (b + 1/2) / h) and d bandwidth = sum g_b value w_b (z_b^2 - 1) / h
// over lanes and bins.
//
// What bounds them on an H100. A lane reads 9 bytes of mask, time and
// value (13 with ids) and evaluates nine exponentials: some 15 float
// operations a bin and the exponential (the record's, kde_exp, some 20
// float operations; the backward's, expf), against 9 to 13 bytes (the
// state, 100 floats, stays on chip). The backward reads the same lanes and
// the state's gradient, writes two floats a lane and three scalars, and
// does some 25 operations a bin. What the record's calls on the paths are
// (chip_smoke.py's kde_call_stats on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6): of a volume gradient
// step's 21 calls of 262,144 lanes, 12 keep no lane and the others up to
// 19 %; of a geometry step's 19 (of 262,144 or 524,288 lanes), seven keep
// 1.8-43 % over 91-101 base bins and the others at most 0.5 %. So a call
// is mostly its launches (1.9 us queued empty) and its reads.
//
// Design of the record: the fixed order of csrc/ordered_sum.cuh, as the
// histogram's record takes it (a warp's span of 128 lanes, the tile's 8
// spans, the tiles in 32 groups, the groups), so a light curve is the same
// bits on every run; in a span the rows of 32 lanes in order, in a row the
// offsets from -support up, for each the lanes in order. Its source reads a
// span's four rows (the masks; where one is set, every lane's time, value and
// id in one round of loads), skips a span with no unmasked lane and a row
// with no kept lane, finds a row's groups of lanes with the same base bin
// once (they, and only they, share a bin at each offset), and hands each
// (row, offset)'s pairs to the ordered add; t0, binSize and the bandwidth are
// read from device memory (no host sync). A pair's weight takes exp through
// kde_exp, explicit float32 products and sums that response._kde_exp
// repeats op for op, so the weights, and with them the state, equal the
// plain version's on the CPU bit for bit (the card's expf and the CPU's exp
// are an ulp apart on many inputs; the same polynomial in double ops took
// the record's 40 path calls 0.0113 ms a call against this one's 0.0096
// and expf's 0.0088, card_measure.py record-builds).
//
// The backward runs on the same order: a block a tile, a warp a span, each
// lane's nine bins in its own thread (the state's gradient read through the
// read-only cache: a few hundred floats on the port's paths), its two
// gradients written without atomics, and its terms of the three scalars
// handed to the ordered add as three bins, so d t0, d binSize and d bandwidth
// are the same bits on every run and equal the plain version's
// (kernel_histogram_grad_plain, through response.ordered_bin_sums) on the
// card. Its exp is expf, which torch's exp on the card calls too (the
// record's kde_exp is an ulp off exp on some inputs, and d time of a lane
// whose bins' terms cancel then leaves the tests' rtol 1e-5 of JAX's); its
// divisions by h are IEEE divisions, as the plain version's; every other op
// repeats the plain version's float32 ops in their order (built with
// -fmad=false), so the lanes' gradients are bit-equal to it on the card
// too. Where no scalar takes a gradient one launch writes the lanes' two
// (ordered::lanes). The earlier design, which dealt a block's kept lanes to its
// threads from a queue in shared memory and added the scalars with one
// atomic a block, is gone; PERF.md section 6 has both designs' times.

#include <cuda_runtime.h>

#include "ordered_sum.cuh"

namespace {

// sqrt(2 pi) rounded to float32, as jnp.sqrt(2.0 * jnp.pi) gives it
constexpr float kSqrt2Pi = 2.5066282749176025f;

struct Lanes {
  const float* value;
  const float* time;
  const unsigned char* mask;
  const int* object_id;  // read only where n_det > 0
  const float* t0;
  const float* bin_size;
  const float* bandwidth;
  int n, n_bins, n_det, support;

  long long state_size() const {
    return static_cast<long long>(n_bins) * (n_det > 0 ? n_det : 1);
  }
};

struct Params {
  float t0, bin_size, h;
};

__device__ __forceinline__ Params params(const Lanes& in) {
  return Params{__ldg(in.t0), __ldg(in.bin_size), __ldg(in.bandwidth)};
}

// a lane's inputs (the backward reads them a round ahead): time and value
// only where unmasked
struct LaneIn {
  bool mask;
  float t, value;
  int id;
};

__device__ __forceinline__ LaneIn lane_in(const Lanes& in, long long i) {
  LaneIn a{false, 0.0f, 0.0f, 0};
  if (i >= in.n || !in.mask[i]) return a;
  a.mask = true;
  a.t = in.time[i];
  a.value = in.value[i];
  if (in.n_det > 0) a.id = in.object_id[i];
  return a;
}

// whether the lane of inputs `a` is kept; then its base bin (as a float)
// and the flat offset of its detector's histogram
__device__ __forceinline__ bool kept(const Lanes& in, const LaneIn& a, const Params& p, float* base,
                                     int* offset) {
  if (!a.mask) return false;
  const float center = __fdiv_rn(a.t - p.t0, p.bin_size);
  if (!isfinite(center)) return false;
  *offset = 0;
  if (in.n_det > 0) {
    if (a.id < 0 || a.id >= in.n_det) return false;
    *offset = a.id * in.n_bins;
  }
  *base = floorf(center);
  return true;
}

// z = (bc - t) / h at the centre of bin bf
__device__ __forceinline__ float z_of(const Params& p, float bf, float t) {
  const float bc = (bf + 0.5f) * p.bin_size + p.t0;
  return __fdiv_rn(bc - t, p.h);
}

__device__ __forceinline__ bool in_range(float bf, int n_bins) {
  return bf >= 0.0f && bf < static_cast<float>(n_bins);
}

// exp(x) for the record's x = -z^2 / 2 (<= 0, or NaN) in float32 products
// and sums: n = rint(x / ln 2), r = x - n ln 2 in two parts (Cody and
// Waite's; n times the high part is exact), e^r = 1 + r + r^2 p(r) by
// Cephes' expf polynomial, times 2^n as two powers of two made from their
// bits, so that a subnormal result rounds once; 0 below -104, where exp is
// under half the least subnormal. Within an ulp of exp. Built with
// -fmad=false, every product and sum rounds as the plain version's
// separate float32 ops (response._kde_exp) do.
__device__ __forceinline__ float kde_exp(float x) {
  if (x < -104.0f) return 0.0f;
  const float n = rintf(x * 1.44269504088896341f);
  const float r = (x - n * 0.693359375f) - n * -2.12194440e-4f;
  float p = 1.9875691500e-4f;
  p = p * r + 1.3981999507e-3f;
  p = p * r + 8.3334519073e-3f;
  p = p * r + 4.1665795894e-2f;
  p = p * r + 1.6666665459e-1f;
  p = p * r + 5.0000001201e-1f;
  const float y = (p * (r * r) + r) + 1.0f;
  const int e = static_cast<int>(n), half = e / 2;  // a NaN's n converts to 0
  return (y * __int_as_float((half + 127) << 23)) * __int_as_float((e - half + 127) << 23);
}

// the record's items: each kept lane's pairs (flat bin, value * w)
struct KdeSource {
  Lanes in;

  template <class Acc>
  __device__ __forceinline__ void span(long long first, const Acc& acc) const {
    constexpr int kRows = ordered::kRowsPerSpan;
    const int lane = threadIdx.x & 31;
    // the rows' masks, then, where one is set, every lane's time, value and
    // id in one round of loads
    LaneIn a[kRows];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + 32 * r + lane;
      a[r].mask = i < in.n && in.mask[i] != 0;
      any = any || a[r].mask;
    }
    if (!__any_sync(ordered::kAll, any)) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + 32 * r + lane;
      const bool live = i < in.n;
      a[r].t = live ? in.time[i] : 0.0f;
      a[r].value = live ? in.value[i] : 0.0f;
      a[r].id = live && in.n_det > 0 ? in.object_id[i] : 0;
    }
    const Params p = params(in);
    const float norm = __fdiv_rn(p.bin_size, p.h * kSqrt2Pi);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float base = 0.0f;
      int offset = 0;
      const bool ok = kept(in, a[r], p, &base, &offset);
      if (!__any_sync(ordered::kAll, ok)) continue;
      // at one offset two kept lanes share a bin only where they share the
      // base bin and the detector: their peers, found once for the row
      const unsigned long long key =
          ok ? (static_cast<unsigned long long>(offset) << 32) | static_cast<unsigned>(__float2int_rz(base))
             : ~0ull;
      const unsigned peers = __match_any_sync(ordered::kAll, key);
      const int rounds = ordered::rounds_of(peers, ok);
      for (int o = -in.support; o <= in.support; ++o) {
        const float bf = base + static_cast<float>(o);
        int bin = -1;
        float add = 0.0f;
        if (ok && in_range(bf, in.n_bins)) {
          const float z = z_of(p, bf, a[r].t);
          const float w = kde_exp(-0.5f * (z * z)) * norm;
          add = a[r].value * w;
          bin = offset + static_cast<int>(bf);
        }
        ordered::add_ranked(acc.vals, acc.slot(acc.local(bin), peers), add, peers, rounds);
      }
    }
  }
};

// The backward's items (csrc/ordered_sum.cuh): each kept lane's terms of d
// t0 (its - d t), d binSize and d bandwidth as flat bins 0, 1 and 2, where
// `scalars`; its two gradients written where the accumulator owns the lanes
// (0 on a dropped lane). The arithmetic is the plain version's, op for op,
// with expf for its exp (torch's exp on the card).
struct KdeGradSource {
  Lanes in;
  const float* grad_state;
  float* grad_value;
  float* grad_time;
  int scalars;

  template <class Acc>
  __device__ __forceinline__ void span(long long first, const Acc& acc) const {
    const int lane = threadIdx.x & 31;
    const bool owner = acc.owns_lanes();
    const Params p = params(in);
    const float inv = __fdiv_rn(1.0f, p.h * kSqrt2Pi);
    const float norm = p.bin_size * inv;
#pragma unroll 1
    for (int r = 0; r < ordered::kRowsPerSpan; ++r) {
      const long long i = first + 32 * r + lane;
      float dv = 0.0f, dt = 0.0f, dbs = 0.0f, dh = 0.0f;
      bool item = false;
      if (i < in.n) {
        const LaneIn a = lane_in(in, i);
        float base = 0.0f;
        int offset = 0;
        if (kept(in, a, p, &base, &offset)) {
          item = true;
          for (int o = -in.support; o <= in.support; ++o) {
            const float bf = base + static_cast<float>(o);
            if (!in_range(bf, in.n_bins)) continue;
            const float g = __ldg(grad_state + offset + static_cast<int>(bf));
            const float z = z_of(p, bf, a.t);
            const float e = expf(-0.5f * (z * z));
            const float w = e * norm;
            const float gv = g * a.value;
            dv = dv + g * w;
            dt = dt + __fdiv_rn(gv * w * z, p.h);
            dbs = dbs + gv * (e * inv - __fdiv_rn(w * z * (bf + 0.5f), p.h));
            dh = dh + __fdiv_rn(gv * w * (z * z - 1.0f), p.h);
          }
        }
        if (owner && grad_value != nullptr) grad_value[i] = dv;
        if (owner && grad_time != nullptr) grad_time[i] = dt;
      }
      if (!scalars) continue;
      // d t0 = - sum of d t: each lane's term negated (exact), then summed
      const float terms[3] = {-dt, dbs, dh};
#pragma unroll
      for (int b = 0; b < 3; ++b) ordered::add_in_lane_order(acc, item && terms[b] != 0.0f ? b : -1, terms[b]);
    }
  }
};

}  // namespace

// the record; table: scratch of table_floats floats (ordered::batch_bins
// must find a batch in it), counters: ordered::kMaxRanges x
// ordered::kCounters words at 0 (csrc/ordered_sum.cuh)
extern "C" int theia_kde_add(const float* value, const float* time,
                             const unsigned char* mask, const int* object_id,
                             const float* t0, const float* bin_size,
                             const float* bandwidth, int n, int n_bins,
                             int n_det, int support, float* table,
                             long long table_floats,
                             unsigned long long* counters, float* state,
                             cudaStream_t stream) {
  const Lanes in{value, time, mask, object_id, t0, bin_size, bandwidth,
                 n, n_bins, n_det, support};
  return static_cast<int>(ordered::record(KdeSource{in}, n, 2 * support + 1, static_cast<int>(in.state_size()), table,
                                          table_floats, counters, state, stream));
}

// the backward: grad_params (3 floats at 0) gets d t0, d binSize and d
// bandwidth where not null, table and counters as theia_kde_add's
extern "C" int theia_kde_grad(const float* grad_state, const float* value,
                              const float* time, const unsigned char* mask,
                              const int* object_id, const float* t0,
                              const float* bin_size, const float* bandwidth,
                              int n, int n_bins, int n_det, int support,
                              float* grad_value, float* grad_time,
                              float* grad_params, float* table,
                              long long table_floats,
                              unsigned long long* counters, cudaStream_t stream) {
  const Lanes in{value, time, mask, object_id, t0, bin_size, bandwidth,
                 n, n_bins, n_det, support};
  const KdeGradSource src{in, grad_state, grad_value, grad_time, grad_params != nullptr};
  if (grad_params == nullptr) return static_cast<int>(ordered::lanes(src, n, stream));
  return static_cast<int>(ordered::record(src, n, 3, 3, table, table_floats, counters, grad_params, stream));
}
