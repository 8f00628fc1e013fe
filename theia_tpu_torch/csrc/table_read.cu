// The table read: linear interpolation in lookup tables, and its backward.
//
// Replaces the reads that theia_tpu leaves to XLA, with the VJPs that JAX
// derives for them: theia_tpu/lookup.py lookup (l.43: one table of n
// samples over [0, 1], v_lo * (1 - l) + v_hi * l) and theia_tpu/material.py
// lookup_packed (l.355: a medium's row of packed (M, L) tables, v_j + l *
// (v_{j+1} - v_j), the last column's slope 0, null_value where the table
// is null), and what their callers compute around them:
// - up to four tables read at one coordinate in one launch: the phase
//   matrix's four (theia_tpu/trace/scene.py:80-88, polarization.py:94-98),
//   the medium's four constants (material.py:164-172), and the const4 read
//   of packed_medium_constants (material.py:397-441), which stacks the four
//   kinds' packed tables into one (M, pad, 4) table: the kernel applies
//   that rule to the kinds' own tables (n the largest of the four sizes, a
//   null table its null constant across its own width and 0 in the padding
//   beyond, the last column's slope 0), so nothing is stacked;
// - the coordinate, formed from each lane's input x: x itself, a * x + b
//   (the phase reads' 0.5 * (cos_theta + 1), exact as 0.5 * cos_theta +
//   0.5), or the wavelength's (x - lambda_min) / (lambda_max -
//   lambda_min) with the bounds read here (a medium's, by handle, or the
//   one medium's), clipped once or twice as the JAX composition clips.
// The clip to [0, 1] takes jnp.clip's gradient: 1/2 on a bound, where
// JAX's max and min split a tie, so 1/4 where two clips meet a bound.
// A third form reads whole rows, the gathers of theia_tpu/accel.py
// _reconstruct_hit (l.614, 640: a winner's 32-float tri_data row and its
// instance's inst_data row), handing the reconstruction the spans of the
// row that it reads (the nine 3-float pieces of tri_data, the two 3x4
// transforms of inst_data, their integer columns converted), one output a
// span, and adds the spans' gradients back into the table. Eager PyTorch
// runs that backward as a sorting index backward (2.64 s of a 2.78 s
// geometry gradient step on this card, where translate_instance gives both
// tables a graph), and slicing one (N, 32) gather costs, for each piece, a
// zero (N, 32) tensor, a copy and a full-width add in the backward.
//
// What bounds them on an H100. The forward: bytes. A lane reads its
// input (and handle) and writes a value a table, 8 to 24 bytes against
// some ten float operations a table; the tables, 3 KB to 12 KB on the
// port's paths, stay in L1 and L2. Called eagerly, a read costs more on the
// host than on the card: a launch a read site, with the coordinate, the
// bounds' gathers and the stacking in the kernel, is what this design buys.
// The backward writes a lane's gradient of the input (4 bytes) and adds its
// share of each table's gradient to two entries; what limits it is where
// those adds meet. On the flagship's constants tables 262,144 lanes add into
// 3 x 256 floats a kind, and the lanes of one wavelength add into the same
// rows. Eager PyTorch runs this backward as a sort of the indices and a
// segmented sum (indexing_backward_kernel_small_stride): 51 ms of a 168 ms
// polarized gradient step on this card, for work that moves a few
// megabytes.
//
// Design. The forward kernel is elementwise, a thread a lane in a grid of a
// few blocks an SM with a loop, and does the plain versions' float32 ops in
// the same order (built with -fmad=false, IEEE division), so it is
// bit-equal to them: one ulp of an index of refraction, a coefficient or a
// group velocity could flip a Fresnel or scatter decision. It reads x at a
// stride (a column of the RNG's draws needs no copy) and writes table
// k's values to an output row of its own. The
// read's constants (pointers, widths, nulls, the form) travel as one Spec
// by value, built once a table set by the wrapper. The backward adds with
// no float atomics: every table entry's sum over the lanes is a fixed
// function of the lanes' indices, their count and the tables' size, the
// order of the records (csrc/ordered_sum.cuh: a warp's span of 128 lanes in
// lane order, a tile's 8 spans, 32 groups of tiles, the groups), with a
// lane's two shares of each table as its items. So two launches give the
// same bits, and the plain version (the same items through
// response.ordered_bin_sums) equals the kernel bit for bit; a gradient step
// repeats. The records' two passes choose themselves: the dense one up to
// 2^19 tiles x entries (the volume step's 1024-sample table), the sparse one
// past it (the constants tables' four kinds). Shares of 0 add nothing (a
// tile, span or row without a live lane skips its adds; +-0.0 changes no
// sum's bits), and where no table takes a gradient one launch writes the
// input's gradient alone (ordered::lanes). The input's gradient is written
// a lane, and is bit-equal to the plain version's. The atomic design this
// replaces (a copy of the tables in each block's shared memory, flushed
// with an atomic an entry) has its times beside this one's in PERF.md
// section 6.
//
// The row gather is a copy: bytes bound it, 4 bytes a lane's index and 4
// a used column written (read back and added in the backward), against a
// table of 480 KB (tri_data) or 384 bytes (inst_data) that L2 and L1 keep.
// What held its first version back was latency and transactions: a thread
// an element, a 64-bit division and a reread index each, and in the
// backward a scalar atomic an element. Here a block takes a tile of rows
// at a time, 8 threads a row with a float4 each (the row's index read once
// and shuffled to them), staged in shared memory with a row stride of 33
// floats, and every global load and store moves 16 bytes a thread over
// whole lines: the forward writes each span's part of a tile as one
// contiguous run of its output, four elements a thread over all spans'
// runs (the element's row from a float reciprocal: 32-bit arithmetic, no
// division), and starts the next tile's loads, with its indices a tile
// earlier still, before those writes. Rows of another width, or tables not
// 16-byte aligned, take an element a thread. The backward (the gathers'
// section below) sums each (row, column) in the records' order as well: a
// tile of 1024 lanes sorts its live lanes by row in shared memory and sums
// each row's lanes a column a thread, then a block a range of rows adds the
// tiles' sums in order; any width, two launches, no atomics.

#include <cuda_runtime.h>

#include "ordered_sum.cuh"
#include "table_read.cuh"

// The spans of a row that a gather hands out, field for field
// ops/table_read.py _Spans: span k is columns [start[k], start[k] +
// width[k]) of every row, an (N, width[k]) output of its own, float32 or,
// where integer[k], int32 (the float truncated toward zero, as
// .to(torch.int32)). Outside the unnamed namespace, as TheiaTableSpec.
struct TheiaSpans {
  int count;
  int start[16];  // kMaxSpans
  int width[16];
  int integer[16];
};

namespace {

using namespace theia_read;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// a row of N values a table: the forward's outputs, the backward's upstream
// gradients
struct Rows {
  float* p[kMaxTables];
};
struct ConstRows {
  const float* p[kMaxTables];
};

__global__ void __launch_bounds__(kThreads)
    read_tables(Spec s, const int* __restrict__ handle, const float* __restrict__ x,
                int x_stride, int count, Rows out) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count; i += stride) {
    float v[kMaxTables];
    read_lane(s, s.packed ? handle[i] : 0, x[static_cast<long long>(i) * x_stride], v);
#pragma unroll
    for (int k = 0; k < kMaxTables; ++k) {
      if (k >= s.tables) break;
      out.p[k][i] = v[k];
    }
  }
}

// The backward's items (csrc/ordered_sum.cuh): a lane's two shares of each
// table, (flat entry, value), in slots 2 k and 2 k + 1 (the lower entry, then
// the upper), flat entries laid end to end over the K tables from
// offset[k]; a table that takes no gradient (offset -1) and a share of 0
// give no item. The lane's gradient of x is written where the accumulator
// owns the lanes. The arithmetic is the plain version's, op for op.
struct ReadGradSource {
  // the dense pass's bound: none beyond its 256 threads (csrc/ordered_sum.cuh)
  static constexpr int kTileBlocks = 1;
  Spec s;
  const int* handle;
  const float* x;
  int x_stride, count;
  ConstRows grad_out;
  int offset[kMaxTables];
  float* grad_x;

  template <class Acc>
  __device__ __forceinline__ void span(long long first, const Acc& acc) const {
    constexpr int kSlots = 2 * kMaxTables;
    const bool owner = acc.owns_lanes() && grad_x != nullptr;
    const int lane = threadIdx.x & 31;
#pragma unroll 1
    for (int r = 0; r < ordered::kRowsPerSpan; ++r) {
      const long long i = first + 32 * r + lane;
      int flat[kSlots];
      float v[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) flat[q] = -1, v[q] = 0.0f;
      if (i < count) {
        const int h = s.packed ? handle[i] : 0;
        const Coordinate c = coordinate(s, h, x[i * x_stride]);
        const float t = clip01(c.r);
        const float cg = clip_grad(clipped_input(s, c));
        int n = 0, pad = 0;
        if (s.packed && s.shared) shared_extent(s, h, &n, &pad);
        // shared: the tables' products summed, then scaled once; otherwise
        // each table's d t, summed in order
        float du = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxTables; ++k) {
          if (k >= s.tables) break;
          const float go = grad_out.p[k] == nullptr ? 0.0f : grad_out.p[k][i];
          const int at = offset[k];
          if (!s.packed) {
            if (s.len[k] == 0) continue;
            const Single a(s.len[k], t);
            v[2 * k] = go * (1.0f - a.l);
            v[2 * k + 1] = go * a.l;
            flat[2 * k] = at + a.lo;
            flat[2 * k + 1] = at + a.hi;
            const float p = go * __ldg(s.values[k] + a.hi) - go * __ldg(s.values[k] + a.lo);
            du = du + p * a.nm1 * cg;
            continue;
          }
          const int nk = __ldg(s.sizes[k] + h);
          const Cell a(s.shared ? n : nk, s.shared ? pad : s.len[k], t);
          const float g = a.n == 0 ? 0.0f : go;
          const bool last = a.j == a.pad - 1;
          if (a.n != 0 && nk != 0) {
            const int base = at + h * s.len[k];
            if (a.j < s.len[k]) flat[2 * k] = base + a.j, v[2 * k] = last ? g : g - g * a.l;
            if (!last && a.j + 1 < s.len[k]) flat[2 * k + 1] = base + a.j + 1, v[2 * k + 1] = g * a.l;
          }
          const float v0 = column(s, k, h, nk, a.j);
          const float slope = a.j < a.pad - 1 ? column(s, k, h, nk, a.j + 1) - v0 : 0.0f;
          const float p = g * slope;
          du = s.shared ? du + p : du + p * a.scale * cg;
        }
        if (s.packed && s.shared) {
          const Cell a(n, pad, t);
          du = du * a.scale * cg;
        }
        if (owner) grad_x[i] = chain(s, c, du);
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          // a table without a gradient, and a share of 0 (adding +-0.0 changes no sum's bits)
          if (offset[q / 2] < 0 || v[q] == 0.0f) flat[q] = -1;
        }
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (q < 2 * s.tables) ordered::add_in_lane_order(acc, flat[q], v[q]);
      }
    }
  }
};

// ---- whole rows of a table and their spans (the hit reconstruction's
// tri_data and inst_data rows) ----

// the most spans a gather hands out; equals ops/table_read.py MAX_SPANS
constexpr int kMaxSpans = 16;
// the rows of the vector kernels: 32 floats, 8 threads a row with a float4
// each, a tile of kPasses x 32 rows a block at a time, staged in shared
// memory
constexpr int kRowWidth = 32;
constexpr int kLanesPerRow = kRowWidth / 4;
constexpr int kGatherThreads = 256;
constexpr int kRowsPerPass = kGatherThreads / kLanesPerRow;
// a staged row's stride: odd, so that a warp's 8 threads of each of its 4
// rows write 32 distinct banks
constexpr int kTileStride = kRowWidth + 1;
// the passes of 32 rows a tile: 64 rows keep a block's loads and writes
// balanced
constexpr int kPasses = 2;
// the grid: a block takes kForwardTiles tiles (reading one ahead), and the
// hardware overlaps the blocks
constexpr int kForwardTiles = 4;
constexpr int kMostBlocksPerSm = 64;

template <int kP>
struct Tile {
  static constexpr int kRows = kRowsPerPass * kP;
  static constexpr int kFloats = kRows * kTileStride;
  // a full tile's runs are moved four elements a thread at a time (16-byte
  // loads and stores): kRows x width is a multiple of 4 for any width, and
  // so is a run's offset in its output; the most such groups a thread takes
  static constexpr int kGroups = kRows * kRowWidth / 4 / kGatherThreads;
};

// a span as the kernels take it: its output (forward) or upstream gradient
// (backward; null where it takes none), its first column, width, kind
struct Span {
  void* p;
  int start, width, integer;
  float rcp;  // 1 / width: the row of an element of a tile's run
};
struct Spans {
  Span s[kMaxSpans];
  int count;
  int columns;  // the spans' widths summed
  int vector;  // every span's pointer 16-byte aligned: full tiles move float4s
};

// e / width for 0 <= e < 128 * kRowWidth (a tile's elements) and width <=
// kRowWidth: (e + 0.5) / width lies at least 1 / 64 from an integer, and
// the two roundings below move it by less than 4096.5 * 2^-23
__device__ __forceinline__ int row_in_tile(int e, float rcp) {
  return __float2int_rz((static_cast<float>(e) + 0.5f) * rcp);
}

// The indices of the tile at `base`, read once a row by its first thread
// (-1 for the other threads and past the end); shuffled to the row's 8
// threads by take_index, an iteration later where the kernel reads ahead
template <int kP>
__device__ __forceinline__ void read_index(const int* __restrict__ index, int base, int count, int sub,
                                           int slot, int (&row)[kP]) {
#pragma unroll
  for (int u = 0; u < kP; ++u) {
    const int i = base + u * kRowsPerPass + slot;
    row[u] = sub == 0 && i < count ? __ldg(index + i) : -1;
  }
}

template <int kP>
__device__ __forceinline__ void take_index(int (&row)[kP]) {
#pragma unroll
  for (int u = 0; u < kP; ++u) row[u] = __shfl_sync(0xffffffffu, row[u], 0, kLanesPerRow);
}

// The spans' runs of a tile of `rows` rows, laid end to end: element E of
// them is element e of span k's run (rows x width_k, row-major). A thread
// walks its E in increasing order, so k only grows.
struct Runs {
  int k, first, end;

  __device__ Runs(const Spans& s, int rows) : k(0), first(0), end(rows * s.s[0].width) {}

  // span k and e for E; E no smaller than at the last call
  __device__ __forceinline__ int at(const Spans& s, int rows, int E) {
    while (E >= end) {
      first = end;
      end += rows * s.s[++k].width;
    }
    return E - first;
  }
};

// the place in the tile of element e of span sp's run
__device__ __forceinline__ int tile_place(const Span& sp, int e) {
  const int r = row_in_tile(e, sp.rcp);
  return r * kTileStride + sp.start + (e - r * sp.width);
}

// the places of elements e to e + 3 of span sp's run
__device__ __forceinline__ void tile_places(const Span& sp, int e, int (&at)[4]) {
  int r = row_in_tile(e, sp.rcp), c = e - r * sp.width;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    at[j] = r * kTileStride + sp.start + c;
    if (++c == sp.width) {
      c = 0;
      ++r;
    }
  }
}

// out_k[i, :] = table[index[i], start_k : start_k + width_k] for a
// 16-byte aligned table of 32-float rows. A block takes 64 lanes at a
// time: 8 threads a row load it as float4s into shared memory, then the
// block writes the spans' parts of the tile, each one contiguous run of
// its output, over all spans' runs four elements a thread (one a thread
// on a ragged last tile). The loads of the next tile start before
// those writes (and its indices a tile earlier still), so that a block
// keeps loads in flight while it writes.
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows32(const float* __restrict__ table, const int* __restrict__ index, int count,
                  const __grid_constant__ Spans s) {
  using T = Tile<kPasses>;
  __shared__ float tile[T::kFloats];
  const int sub = threadIdx.x % kLanesPerRow, slot = threadIdx.x / kLanesPerRow;
  const int step = gridDim.x * T::kRows;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int base = blockIdx.x * T::kRows;
  int row[kPasses];
  float4 v[kPasses];
  read_index(index, base, count, sub, slot, row);
  take_index(row);
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    v[u] = row[u] < 0 ? zero : __ldg(reinterpret_cast<const float4*>(table + row[u] * kRowWidth) + sub);
  }
  read_index(index, base + step, count, sub, slot, row);
  for (; base < count; base += step) {
    const int rows = min(T::kRows, count - base);
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      float* d = tile + (u * kRowsPerPass + slot) * kTileStride + sub * 4;
      d[0] = v[u].x;
      d[1] = v[u].y;
      d[2] = v[u].z;
      d[3] = v[u].w;
    }
    __syncthreads();
    take_index(row);
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      v[u] = row[u] < 0 ? zero : __ldg(reinterpret_cast<const float4*>(table + row[u] * kRowWidth) + sub);
    }
    read_index(index, base + 2 * step, count, sub, slot, row);
    Runs runs(s, rows);
    if (rows == T::kRows && s.vector) {
      for (int E = 4 * threadIdx.x; E < rows * s.columns; E += 4 * kGatherThreads) {
        const int e = runs.at(s, rows, E);
        const Span& sp = s.s[runs.k];
        int at[4];
        tile_places(sp, e, at);
        const float4 x = make_float4(tile[at[0]], tile[at[1]], tile[at[2]], tile[at[3]]);
        const int out = base * sp.width + e;
        if (sp.integer) {
          *reinterpret_cast<int4*>(static_cast<int*>(sp.p) + out) =
              make_int4(static_cast<int>(x.x), static_cast<int>(x.y), static_cast<int>(x.z), static_cast<int>(x.w));
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(sp.p) + out) = x;
        }
      }
    } else {
      for (int E = threadIdx.x; E < rows * s.columns; E += kGatherThreads) {
        const int e = runs.at(s, rows, E);
        const Span& sp = s.s[runs.k];
        const float x = tile[tile_place(sp, e)];
        const int out = base * sp.width + e;
        if (sp.integer) {
          static_cast<int*>(sp.p)[out] = static_cast<int>(x);
        } else {
          static_cast<float*>(sp.p)[out] = x;
        }
      }
    }
    __syncthreads();
  }
}

// Any other table (another width, or not 16-byte aligned): an element a
// thread over each span's output
__global__ void __launch_bounds__(kThreads)
    gather_rows_any(const float* __restrict__ table, int width, const int* __restrict__ index,
                    int count, const __grid_constant__ Spans s) {
  const int stride = gridDim.x * kThreads;
  for (int k = 0; k < s.count; ++k) {
    const Span& sp = s.s[k];
    const int n = count * sp.width;
    for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
      const int i = e / sp.width;
      const float x = __ldg(table + __ldg(index + i) * width + sp.start + (e - i * sp.width));
      if (sp.integer) {
        static_cast<int*>(sp.p)[e] = static_cast<int>(x);
      } else {
        static_cast<float*>(sp.p)[e] = x;
      }
    }
  }
}

// ---- the gathers' backward: each (row, column) entry of the table's
// gradient summed over the lanes that read the row, in a fixed order of the
// records' kind (csrc/ordered_sum.cuh; items (lane, row x width +
// column)) whose first level is the tile: a tile's 1024 lanes in lane
// order, the tiles in 32 groups of ceil(tiles / 32) in order, the groups in
// order (ops/ordered.ordered_bin_sums with span = the tile is the twin).
// Spans of 128 lanes summed apart, the records' first level, drift from the
// sequential sums of torch's index backward and JAX's scatter-add by more
// than the tests' rtol 1e-6 where a few rows take many lanes (inst_data);
// a tile's lanes in order equal them up to 1024 lanes. Two launches for
// each 32 columns of the row. (1) A block of 1024 threads a tile, a thread
// a lane: its key (its row, its place in the tile), or none where all its
// gradients of the pass are 0 (adding +-0.0 changes no sum's bits; every
// load issued before any is tested); a bitonic sort of the keys (32 bits,
// so fewer than 2^22 rows; a key a thread, shuffles within a warp, 15
// exchanges in shared memory), so that a
// row's lanes lie together in lane order (a run); a thread a (run, column),
// through the run's lanes in order, reading the gradients staged in
// shared memory by the first step; the tile's list of (row, sums), by row,
// and where each range of range_rows rows starts in it. (2) A block a range
// of rows, a warp a row, a thread a column: the tiles whose lists hold the
// row, found in a table of a window of tiles in shared memory and listed in
// order by ballots, their sums loaded 32 at a time and added in tile order,
// a group's sum closed into the total at each group's end. ----

constexpr int kSortLanes = ordered::kTileLanes;
constexpr int kSortThreads = kSortLanes;  // a thread a lane
constexpr int kLaneBits = 10;  // a lane's place in its tile: kSortLanes = 1 << kLaneBits
// a key (row, place) in 32 bits: the rows a table may have
constexpr int kMostRows = 1 << (32 - kLaneBits);
// the columns of one pass (a list entry's sums), staged at an odd stride so
// that a warp's lanes of one column, and its columns of one lane, fall in
// distinct banks
constexpr int kPassColumns = 32;
constexpr int kStageStride = kPassColumns + 1;
constexpr int kStageBytes = kSortLanes * kStageStride * static_cast<int>(sizeof(float));
// a range of the table's rows that a merging block takes: at least
// kMergeRows, and as many as keep the ranges to kMostRanges; equal
// ops/table_read.py GATHER_MERGE_ROWS and GATHER_MOST_RANGES
constexpr int kMergeRows = 8;
constexpr int kMostRanges = 32768;
constexpr int kMergeThreads = 256;
// a merging block's window of tiles (at range_rows = kMergeRows), and the
// most shared memory its rows' state takes
constexpr int kMergeWindow = 256;
constexpr int kMergeMostBytes = 160 * 1024;
// loads in flight a thread: the tile pass's walk through a run (from shared
// memory), the merge's
constexpr int kWalkAhead = 4;
constexpr int kMergeAhead = 32;

// the tiles' lists of one pass: rows (tiles x cap, ascending), their sums
// (tiles x cap x kPassColumns) and where each range of range_rows rows
// starts (tiles x (ranges + 1), the last the list's length)
struct GradLists {
  int* rows;
  float* vals;
  int* starts;
  int cap, ranges, range_rows;
};

struct GradSize {
  int tiles, cap, ranges, range_rows;
  long long words;
};

GradSize grad_size(int rows, int count) {
  GradSize z{};
  z.tiles = (count + kSortLanes - 1) / kSortLanes;
  z.cap = rows < kSortLanes ? rows : kSortLanes;
  const int per = (rows + kMostRanges - 1) / kMostRanges;
  z.range_rows = per > kMergeRows ? per : kMergeRows;
  z.ranges = (rows + z.range_rows - 1) / z.range_rows;
  z.words = static_cast<long long>(z.tiles) * z.cap * (1 + kPassColumns) +
            static_cast<long long>(z.tiles) * (z.ranges + 1);
  return z;
}

__global__ void __launch_bounds__(kSortThreads)
    gather_grad_tiles(const __grid_constant__ Spans s, const int* __restrict__ index, int count, int rows, int c0,
                      int cw, GradLists out) {
  __shared__ unsigned keys[kSortLanes];
  __shared__ unsigned exchange[2][kSortLanes];
  __shared__ int firsts[kSortLanes + 1];
  __shared__ int warp_sums[kSortThreads / 32];
  __shared__ const float* col_ptr[kPassColumns];  // column c0 + c of lane 0's gradient, null where none
  __shared__ int col_stride[kPassColumns];
  extern __shared__ float stage[];  // a lane's gradients of the pass: kSortLanes x kStageStride
  constexpr unsigned kNone = ~0u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kSortLanes;
  if (tid < kPassColumns) {
    const float* ptr = nullptr;
    int stride = 0;
    for (int k = 0; k < s.count; ++k) {
      const Span& sp = s.s[k];
      if (tid < cw && c0 + tid >= sp.start && c0 + tid < sp.start + sp.width) {
        ptr = static_cast<const float*>(sp.p) + (c0 + tid - sp.start) + base * sp.width;
        stride = sp.width;
      }
    }
    col_ptr[tid] = ptr, col_stride[tid] = stride;
  }
  __syncthreads();
  // the lane's gradients of the pass, every load issued before any is
  // used, staged in shared memory (0 in a column no span takes); its key
  {
    unsigned key = kNone;
    if (base + tid < count) {
      const int row = __ldg(index + base + tid);
      bool live = false;
#pragma unroll
      for (int h = 0; h < kPassColumns; h += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float* g = col_ptr[h + u];
          v[u] = g != nullptr ? __ldg(g + static_cast<long long>(tid) * col_stride[h + u]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          live |= v[u] != 0.0f;
          stage[tid * kStageStride + h + u] = v[u];
        }
      }
      if (live && row >= 0 && row < rows) key = (static_cast<unsigned>(row) << kLaneBits) | tid;
    }
    keys[tid] = key;
  }
  __syncthreads();
  // bitonic sort, ascending, a key a thread: the keys are distinct, so a
  // row's lanes end in lane order. Partners within a warp swap by shuffles,
  // others through two buffers in shared memory (a barrier an exchange).
  unsigned key = keys[tid];
  int buffer = 0;
  for (int size = 2; size <= kSortLanes; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned other;
      if (stride < 32) {
        other = __shfl_xor_sync(0xffffffffu, key, stride);
      } else {
        exchange[buffer][tid] = key;
        __syncthreads();
        other = exchange[buffer][tid ^ stride];
        buffer ^= 1;
      }
      const bool lower = (tid & stride) == 0, ascending = (tid & size) == 0;
      key = (lower == ascending) ? min(key, other) : max(key, other);
    }
  }
  keys[tid] = key;
  __syncthreads();
  // the runs: each run's first key, in order (the threads' flags scanned),
  // and the live keys' end
  const bool first = key != kNone && (tid == 0 || (key >> kLaneBits) != (keys[tid - 1] >> kLaneBits));
  const unsigned ballot = __ballot_sync(0xffffffffu, first);
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, runs = 0;
#pragma unroll
  for (int w = 0; w < kSortThreads / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    runs += warp_sums[w];
  }
  if (first) firsts[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
  if (key != kNone && (tid + 1 == kSortLanes || keys[tid + 1] == kNone)) firsts[runs] = tid + 1;
  if (tid == 0 && key == kNone) firsts[0] = 0;
  __syncthreads();
  // a thread a (run, column): the run's lanes in lane order
  const long long t = blockIdx.x;
  for (int p = tid; p < runs * kPassColumns; p += kSortThreads) {
    const int q = p / kPassColumns, c = p - q * kPassColumns;
    const int a = firsts[q], b = firsts[q + 1];
    float tile_sum = 0.0f;
    int e = a;
    for (; e + kWalkAhead <= b; e += kWalkAhead) {
      float v[kWalkAhead];
#pragma unroll
      for (int u = 0; u < kWalkAhead; ++u) v[u] = stage[(keys[e + u] & (kSortLanes - 1)) * kStageStride + c];
#pragma unroll
      for (int u = 0; u < kWalkAhead; ++u) tile_sum += v[u];
    }
    for (; e < b; ++e) tile_sum += stage[(keys[e] & (kSortLanes - 1)) * kStageStride + c];
    out.vals[(t * out.cap + q) * kPassColumns + c] = tile_sum;
    if (c == 0) out.rows[t * out.cap + q] = static_cast<int>(keys[a] >> kLaneBits);
  }
  // where each range of rows starts in the list
  int* starts = out.starts + t * (out.ranges + 1);
  for (int r = tid; r <= out.ranges; r += kSortThreads) {
    const long long lo_row = static_cast<long long>(r) * out.range_rows;
    int lo = 0, hi = runs;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<long long>(keys[firsts[mid]] >> kLaneBits) < lo_row) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    starts[r] = lo;
  }
}

// (2) a block a range of rows, a warp a row, a thread a column: where each
// tile's list holds the row (a table of a window of tiles in shared memory,
// filled a thread a tile), then the tiles that hold it listed in order by
// ballots and their sums loaded kMergeAhead at a time, added in tile order into
// the open group's sum, which is closed into the total at each group's
// end; written to columns c0 .. c0 + cw - 1 of the gradient, every row of
// the range
__global__ void __launch_bounds__(kMergeThreads)
    gather_grad_merge(GradLists in, int tiles, int rows, int width, int c0, int cw, int group,
                      float* __restrict__ grad_table) {
  constexpr int kWarps = kMergeThreads / 32;
  __shared__ int pos[kMergeWindow * kMergeRows];       // a window's tiles x the range's rows (range_rows)
  __shared__ int2 hits[kWarps][kMergeWindow];          // a warp's row: (tile, entry) in tile order
  extern __shared__ float state[];                     // a row and column's total, open sum, open group
  const int per = in.range_rows, r0 = blockIdx.x * per, nr = min(per, rows - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int window = kMergeWindow * kMergeRows / per;
  float* total = state;
  float* open = state + per * 32;
  int* open_group = reinterpret_cast<int*>(open + per * 32);
  for (int p = threadIdx.x; p < per * 32; p += kMergeThreads) total[p] = 0.0f, open[p] = 0.0f, open_group[p] = 0;
  pdl::wait_for_previous();
  for (int t0 = 0; t0 < tiles; t0 += window) {
    const int t1 = min(tiles, t0 + window);
    __syncthreads();
    for (int p = threadIdx.x; p < (t1 - t0) * per; p += kMergeThreads) pos[p] = -1;
    __syncthreads();
    for (int t = t0 + threadIdx.x; t < t1; t += kMergeThreads) {
      const int* st = in.starts + static_cast<long long>(t) * (in.ranges + 1) + blockIdx.x;
      const int a = __ldg(st), b = __ldg(st + 1);
      for (int q = a; q < b; ++q) pos[(t - t0) * per + __ldg(in.rows + static_cast<long long>(t) * in.cap + q) - r0] = q;
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {
      // the window's tiles that hold row r, in order
      int n = 0;
      for (int tb = t0; tb < t1; tb += 32) {
        const int t = tb + lane;
        const int q = t < t1 ? pos[(t - t0) * per + r] : -1;
        const unsigned hit = __ballot_sync(0xffffffffu, q >= 0);
        if (q >= 0) hits[warp][n + __popc(hit & ((1u << lane) - 1u))] = make_int2(t, q);
        n += __popc(hit);
      }
      __syncwarp();
      float tot = total[r * 32 + lane], sum = open[r * 32 + lane];
      int g = open_group[r * 32 + lane];
      for (int h0 = 0; h0 < n; h0 += kMergeAhead) {
        float v[kMergeAhead];
        int tt[kMergeAhead];
#pragma unroll
        for (int u = 0; u < kMergeAhead; ++u) {
          const int2 h = h0 + u < n ? hits[warp][h0 + u] : make_int2(-1, 0);
          tt[u] = h.x;
          v[u] = h.x >= 0 && lane < cw ? __ldg(in.vals + (static_cast<long long>(h.x) * in.cap + h.y) * kPassColumns + lane)
                                       : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kMergeAhead; ++u) {
          if (tt[u] < 0) break;
          if (tt[u] / group != g) {  // a group closed (groups without the row add +0.0: no bits change)
            tot += sum;
            sum = 0.0f;
            g = tt[u] / group;
          }
          sum += v[u];
        }
      }
      total[r * 32 + lane] = tot, open[r * 32 + lane] = sum, open_group[r * 32 + lane] = g;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nr * 32; p += kMergeThreads) {
    const int r = p / 32, c = p - r * 32;
    if (c < cw) grad_table[static_cast<long long>(r0 + r) * width + c0 + c] = total[p] + open[p];
  }
}

int multiprocessors(cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

int grid_for(long long count, int threads, int per_sm, cudaError_t* err) {
  const int sms = multiprocessors(err);
  if (*err != cudaSuccess) return 0;
  const long long want = (count + threads - 1) / threads;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(want < most ? want : most);
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// the kernels' spans from the caller's, with their outputs or, for the
// backward (`grad`), their gradients `p`, of which it keeps the float spans
// that take one (a non-null gradient); false if a span does not fit a row
// of `width` floats, or a row's or an output's offsets overflow 32 bits
bool make_spans(const TheiaSpans* in, void* const* p, int rows, int width, int count, bool grad,
                Spans* out) {
  if (in == nullptr || p == nullptr || in->count < 1 || in->count > kMaxSpans || width < 1 ||
      rows < 1 || count < 0 || static_cast<long long>(rows) * width > 0x7fffffffLL ||
      static_cast<long long>(count) * width > 0x7fffffffLL) {
    return false;
  }
  out->count = out->columns = 0;
  out->vector = 1;
  for (int k = 0; k < in->count; ++k) {
    const int a = in->start[k], w = in->width[k];
    if (a < 0 || w < 1 || a + w > width) return false;
    if (grad && (p[k] == nullptr || in->integer[k])) continue;
    out->s[out->count++] = Span{p[k], a, w, in->integer[k] != 0, 1.0f / static_cast<float>(w)};
    out->columns += w;
    if (!aligned16(p[k])) out->vector = 0;
  }
  return true;
}

bool valid(const Spec* s) {
  return s != nullptr && s->tables >= 1 && s->tables <= kMaxTables && s->form >= kT &&
         s->form <= kWavelength && (s->clips == 1 || s->clips == 2);
}

}  // namespace

extern "C" int theia_table_read(const Spec* spec, const int* handle, const float* x,
                                int x_stride, int count, float* out0, float* out1, float* out2,
                                float* out3, cudaStream_t stream) {
  if (!valid(spec)) return static_cast<int>(cudaErrorInvalidValue);
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  const int grid = grid_for(count, kThreads, kBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  read_tables<<<grid, kThreads, 0, stream>>>(*spec, handle, x, x_stride, count,
                                             Rows{{out0, out1, out2, out3}});
  return static_cast<int>(cudaGetLastError());
}

// the backward: grads, the tables' gradients of those in need (bit k: table
// k) laid end to end, zeroed, a float a table entry; grad_x may be null;
// table and counters the ordered sum's scratch (csrc/ordered_sum.cuh, as
// response._record_table sizes it for 2 x tables items a lane)
extern "C" int theia_table_read_grad(const Spec* spec, const int* handle, const float* x,
                                     int x_stride, const float* grad_out0,
                                     const float* grad_out1, const float* grad_out2,
                                     const float* grad_out3, int count, int need,
                                     float* grads, float* grad_x, float* table,
                                     long long table_floats, unsigned long long* counters,
                                     cudaStream_t stream) {
  if (!valid(spec)) return static_cast<int>(cudaErrorInvalidValue);
  ReadGradSource src{*spec, handle, x, x_stride, count,
                     ConstRows{{grad_out0, grad_out1, grad_out2, grad_out3}}, {-1, -1, -1, -1}, grad_x};
  long long total = 0;
  for (int k = 0; k < spec->tables; ++k) {
    if (!((need >> k) & 1) || spec->len[k] == 0) continue;
    src.offset[k] = static_cast<int>(total);
    total += static_cast<long long>(spec->packed ? spec->media : 1) * spec->len[k];
  }
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  if (total == 0 || grads == nullptr) {
    return grad_x == nullptr ? static_cast<int>(cudaGetLastError()) : static_cast<int>(ordered::lanes(src, count, stream));
  }
  return static_cast<int>(ordered::record(src, count, 2 * spec->tables, static_cast<int>(total), table,
                                          table_floats, counters, grads, stream));
}

// out: the spans' (N, width[k]) outputs, f32 or int32 as the span says
extern "C" int theia_gather_rows(const float* table, int rows, int width, const int* index,
                                 int count, const TheiaSpans* spans, void* const* out,
                                 cudaStream_t stream) {
  Spans s;
  if (!make_spans(spans, out, rows, width, count, false, &s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  if (width == kRowWidth && aligned16(table)) {
    const int grid = grid_for(count, kForwardTiles * Tile<kPasses>::kRows, kMostBlocksPerSm, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_rows32<<<grid, kGatherThreads, 0, stream>>>(table, index, count, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = grid_for(static_cast<long long>(count) * width, kThreads, kBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_any<<<grid, kThreads, 0, stream>>>(table, width, index, count, s);
  return static_cast<int>(cudaGetLastError());
}

// grad_out: the spans' (N, width[k]) f32 gradients, null where a span takes
// none; grad_table: (rows, width), every entry written; scratch: at least
// grad_size's words (ops/table_read.py _gather_scratch_words repeats it)
extern "C" int theia_gather_rows_grad(const TheiaSpans* spans, void* const* grad_out,
                                      const int* index, int count, int rows, int width,
                                      float* grad_table, float* scratch, long long scratch_floats,
                                      cudaStream_t stream) {
  Spans s;
  if (!make_spans(spans, grad_out, rows, width, count, true, &s) || rows >= kMostRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return static_cast<int>(cudaGetLastError());
  const GradSize z = grad_size(rows, count);
  if (scratch_floats < z.words) return static_cast<int>(cudaErrorInvalidValue);
  int* list_rows = reinterpret_cast<int*>(scratch);
  float* vals = scratch + static_cast<size_t>(z.tiles) * z.cap;
  int* starts = reinterpret_cast<int*>(vals + static_cast<size_t>(z.tiles) * z.cap * kPassColumns);
  const GradLists lists{list_rows, vals, starts, z.cap, z.ranges, z.range_rows};
  const int group = (z.tiles + ordered::kGroups - 1) / ordered::kGroups;
  const int state_bytes = 3 * 32 * z.range_rows * static_cast<int>(sizeof(float));
  if (state_bytes > kMergeMostBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gather_grad_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (state_bytes > 16 * 1024) {
    err = cudaFuncSetAttribute(gather_grad_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int c0 = 0; c0 < width; c0 += kPassColumns) {
    const int cw = width - c0 < kPassColumns ? width - c0 : kPassColumns;
    gather_grad_tiles<<<z.tiles, kSortThreads, kStageBytes, stream>>>(s, index, count, rows, c0, cw, lists);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = pdl::launch(gather_grad_merge, dim3(z.ranges), dim3(kMergeThreads), state_bytes, stream, lists, z.tiles,
                      rows, width, c0, cw, group, grad_table);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
