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
// by value, built once a table set by the wrapper. The backward kernel
// keeps a copy of every table's gradient in each block's shared memory
// (zeroed at every launch), adds each lane's share there, and then adds
// each entry that is not zero to its table's gradient with one global
// atomic; table sets above kSharedMaxFloats (what a block can opt into of
// the SM's 227 KB) take the same kernel with the adds going straight to the
// outputs. Few blocks (at most two an SM) take many lanes each, so that a
// block's flush is small against its lanes' adds. The input's gradient is
// written a lane, without atomics, and is bit-equal to the plain version's;
// the tables' sums land in an order that changes from run to run, so they
// agree with the plain version's sequential sums to float32 rounding.
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
// earlier still, before those writes. The backward reads the spans'
// gradients of the next tile (128 rows) into registers before it adds
// this one's, takes a row's four columns a thread, skips the ones that are
// all zero (missed lanes, uncovered columns), merges a warp's lanes of one
// row (__match_any_sync, a shuffle sum) and adds four floats an atomic
// (atomicAdd on float4, red.global.add.v4.f32); tables that fit beside the
// tile (inst_data) are summed in a thread's registers and a block's shared
// copy first. Rows of another width, or tables not 16-byte aligned, take
// an element a thread.

#include <cuda_runtime.h>

// A read's constants, field for field ops/table_read.py _Spec; outside the
// unnamed namespace, so that the C entry points that take it keep external
// linkage.
struct TheiaTableSpec {
  const float* values[4];   // kMaxTables; packed: (M, len[k]); single: (len[k],)
  const int* sizes[4];      // packed: (M,); single: unused
  const float* lambda_min;  // wavelength: (M,) packed, one value single
  const float* lambda_max;
  int len[4];  // packed: a row's width; single: the samples, 0 = null
  float nulls[4];
  int tables;  // K
  int packed;  // 1: material.lookup_packed's read, 0: lookup.lookup's
  int shared;  // packed: the const4 rule across the K tables
  int form;
  int clips;  // the clips to [0, 1] between the formed coordinate and the read
  int media;  // M
  float a, b;  // affine: t = a * x + b
};

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

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kGradThreads = 512;
constexpr int kGradBlocksPerSm = 2;
constexpr int kSmemPerSm = 227 * 1024;
// the largest table gradient that a block sums in shared memory, in floats;
// equals ops/table_read.py SHARED_TABLE_MAX
constexpr int kSharedMaxFloats = (kSmemPerSm - 1024) / 4;
// the most tables a read takes; equals ops/table_read.py MAX_TABLES
constexpr int kMaxTables = 4;
// the coordinate's forms; equal ops/table_read.py T, AFFINE, WAVELENGTH
constexpr int kT = 0, kAffine = 1, kWavelength = 2;

using Spec = TheiaTableSpec;

// jnp.clip(x, 0, 1); a NaN stays NaN
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// d clip01 / dx as JAX takes it: 1 inside, 1/2 on a bound, 0 outside
__device__ __forceinline__ float clip_grad(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

// the row of a float index, clamped into [0, n - 1] (0 for a NaN)
__device__ __forceinline__ int row_of(float f, int n) {
  if (!(f >= 0.0f)) return 0;
  return f < static_cast<float>(n - 1) ? static_cast<int>(f) : n - 1;
}

__device__ __forceinline__ void add(float* acc, long long k, float v) {
  if (v != 0.0f) atomicAdd(acc + k, v);
}

// A lane's coordinate: r as formed from x, before any clip; span the
// wavelength range that divided it (for the chain rule)
struct Coordinate {
  float r, span;
};

__device__ __forceinline__ Coordinate coordinate(const Spec& s, int h, float x) {
  Coordinate c{x, 1.0f};
  if (s.form == kAffine) {
    c.r = s.a * x + s.b;
  } else if (s.form == kWavelength) {
    const int k = s.packed ? h : 0;
    const float lo = __ldg(s.lambda_min + k);
    c.span = __ldg(s.lambda_max + k) - lo;
    c.r = (x - lo) / c.span;
  }
  return c;
}

// d read / d r from the read's d / d t: the clips' gradients (the read's
// own clip was taken at the clipped t when there are two), then the form's
__device__ __forceinline__ float chain(const Spec& s, const Coordinate& c, float du) {
  if (s.clips == 2) du = du * clip_grad(c.r);
  if (s.form == kAffine) return du * s.a;
  if (s.form == kWavelength) return du / c.span;
  return du;
}

// the t at which the read takes its clip's gradient
__device__ __forceinline__ float clipped_input(const Spec& s, const Coordinate& c) {
  return s.clips == 2 ? clip01(c.r) : c.r;
}

// ---- single tables (lookup.lookup): table k of len[k] samples ----
struct Single {
  int lo, hi;
  float l, nm1;

  __device__ Single(int n, float t) {
    nm1 = static_cast<float>(n - 1);
    const float x = t * nm1;
    const float fl = floorf(x);
    l = x - fl;
    lo = row_of(fl, n);
    hi = row_of(ceilf(x), n);
  }
};

// ---- packed tables (material.lookup_packed): a lane's cell in its row ----
struct Cell {
  int n, pad, j;
  float l, scale;

  __device__ Cell(int n_, int pad_, float t) : n(n_), pad(pad_) {
    scale = static_cast<float>(n - 1 > 1 ? n - 1 : 1);
    const float tt = t * scale;
    const float fl = floorf(tt);
    l = tt - fl;
    j = row_of(fl, pad);
  }
};

// column c of table k's row h as the const4 rule reads it: the table's own
// value, its null constant where the table is null (size nk 0), and 0
// beyond its own width
__device__ __forceinline__ float column(const Spec& s, int k, int h, int nk, int c) {
  if (c >= s.len[k]) return 0.0f;
  if (nk == 0) return s.nulls[k];
  return __ldg(s.values[k] + static_cast<long long>(h) * s.len[k] + c);
}

// the largest of the K tables' sizes and widths at handle h (the const4 rule)
__device__ __forceinline__ void shared_extent(const Spec& s, int h, int* n, int* pad) {
  *n = 0;
  *pad = 0;
#pragma unroll
  for (int k = 0; k < kMaxTables; ++k) {
    if (k < s.tables) {
      const int nk = __ldg(s.sizes[k] + h);
      *n = nk > *n ? nk : *n;
      *pad = s.len[k] > *pad ? s.len[k] : *pad;
    }
  }
}

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
    const int h = s.packed ? handle[i] : 0;
    const Coordinate c = coordinate(s, h, x[static_cast<long long>(i) * x_stride]);
    const float t = clip01(c.r);
    int n = 0, pad = 0;
    if (s.packed && s.shared) shared_extent(s, h, &n, &pad);
#pragma unroll
    for (int k = 0; k < kMaxTables; ++k) {
      if (k >= s.tables) break;
      float v = s.nulls[k];
      if (!s.packed) {
        if (s.len[k] > 0) {
          const Single a(s.len[k], t);
          v = __ldg(s.values[k] + a.lo) * (1.0f - a.l) + __ldg(s.values[k] + a.hi) * a.l;
        }
      } else {
        const int nk = __ldg(s.sizes[k] + h);
        const Cell a(s.shared ? n : nk, s.shared ? pad : s.len[k], t);
        if (a.n != 0) {
          const float v0 = column(s, k, h, nk, a.j);
          const float slope = a.j < a.pad - 1 ? column(s, k, h, nk, a.j + 1) - v0 : 0.0f;
          v = v0 + a.l * slope;
        }
      }
      out.p[k][i] = v;
    }
  }
}

// The backward: x strided, grad_out one row a table (a null row is a zero
// gradient); table k's gradient goes to grads[k] (may be null), at
// offset[k] of the block's shared copy with kShared; grad_x may be null.
struct Grads {
  float* table[kMaxTables];
  long long offset[kMaxTables];
};

template <bool kShared>
__global__ void __launch_bounds__(kGradThreads)
    read_tables_grad(Spec s, const int* __restrict__ handle, const float* __restrict__ x,
                     int x_stride, ConstRows grad_out, int count, Grads grads,
                     long long total, float* __restrict__ grad_x) {
  extern __shared__ float sums[];
  if (kShared) {
    for (long long k = threadIdx.x; k < total; k += kGradThreads) sums[k] = 0.0f;
    __syncthreads();
  }
  const int stride = gridDim.x * kGradThreads;
  for (int i = blockIdx.x * kGradThreads + threadIdx.x; i < count; i += stride) {
    const int h = s.packed ? handle[i] : 0;
    const Coordinate c = coordinate(s, h, x[static_cast<long long>(i) * x_stride]);
    const float t = clip01(c.r);
    const float cg = clip_grad(clipped_input(s, c));
    int n = 0, pad = 0;
    if (s.packed && s.shared) shared_extent(s, h, &n, &pad);
    // shared: the tables' products summed, then scaled once; otherwise each
    // table's d t, summed in order
    float du = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxTables; ++k) {
      if (k >= s.tables) break;
      const float go = grad_out.p[k] == nullptr ? 0.0f : grad_out.p[k][i];
      float* acc = grads.table[k] == nullptr
                       ? nullptr
                       : (kShared ? sums + grads.offset[k] : grads.table[k]);
      if (!s.packed) {
        if (s.len[k] == 0) continue;
        const Single a(s.len[k], t);
        if (acc != nullptr) {
          add(acc, a.lo, go * (1.0f - a.l));
          add(acc, a.hi, go * a.l);
        }
        const float p = go * __ldg(s.values[k] + a.hi) - go * __ldg(s.values[k] + a.lo);
        du = du + p * a.nm1 * cg;
        continue;
      }
      const int nk = __ldg(s.sizes[k] + h);
      const Cell a(s.shared ? n : nk, s.shared ? pad : s.len[k], t);
      const float g = a.n == 0 ? 0.0f : go;
      const bool last = a.j == a.pad - 1;
      if (acc != nullptr && a.n != 0 && nk != 0) {
        const long long base = static_cast<long long>(h) * s.len[k];
        if (a.j < s.len[k]) add(acc, base + a.j, last ? g : g - g * a.l);
        if (!last && a.j + 1 < s.len[k]) add(acc, base + a.j + 1, g * a.l);
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
    if (grad_x != nullptr) grad_x[i] = chain(s, c, du);
  }
  if (kShared) {
    // every thread arrives here: the loop has no return
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxTables; ++k) {
      if (k >= s.tables || grads.table[k] == nullptr) continue;
      const long long size = (k + 1 < s.tables ? grads.offset[k + 1] : total) - grads.offset[k];
      for (long long e = threadIdx.x; e < size; e += kGradThreads) {
        const float v = sums[grads.offset[k] + e];
        if (v != 0.0f) atomicAdd(grads.table[k] + e, v);
      }
    }
  }
}

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
constexpr int kWarpRows = 32 / kLanesPerRow;  // a warp's rows: slots 0-3
// a staged row's stride: odd, so that a warp's 8 threads of each of its 4
// rows write 32 distinct banks
constexpr int kTileStride = kRowWidth + 1;
// the passes of 32 rows a tile: the forward's 64 rows keep a block's loads
// and writes balanced; the backward, whose loads are its upstream
// gradients, reads 128 rows ahead
constexpr int kPasses = 2;
constexpr int kGradPasses = 4;
// the grids: a forward block takes kForwardTiles tiles (reading one ahead),
// a backward block on device memory one, and the hardware overlaps the
// blocks (theia_tpu_torch.tools.card_measure gather-builds times both
// against a loop over tiles in 8 blocks an SM, 2048 threads); a backward
// block with the table in shared memory loops over its tiles, so that its
// copy is added to the gradient once for many tiles
constexpr int kForwardTiles = 4;
constexpr int kGatherBlocksPerSm = 8;
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
// the table rows whose gradient a thread sums in registers on the shared
// path (inst_data has one a scene instance: 3 on the flagship)
constexpr int kRegRows = 4;

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
  unsigned covered;  // backward, 32-float rows: bit c where column c takes a gradient
};

// e / width for 0 <= e < 128 * kRowWidth (a tile's elements) and width <=
// kRowWidth: (e + 0.5) / width lies at least 1 / 64 from an integer, and
// the two roundings below move it by less than 4096.5 * 2^-23
__device__ __forceinline__ int row_in_tile(int e, float rcp) {
  return __float2int_rz((static_cast<float>(e) + 0.5f) * rcp);
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

__device__ __forceinline__ float4 shfl4_xor(float4 v, int mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, mask), __shfl_xor_sync(0xffffffffu, v.y, mask),
                     __shfl_xor_sync(0xffffffffu, v.z, mask), __shfl_xor_sync(0xffffffffu, v.w, mask));
}

// four floats added to a 16-byte aligned address of device memory in one
// operation (sm_90's red.global.add.v4.f32)
__device__ __forceinline__ void add4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// each of four floats that is not zero added to shared memory
__device__ __forceinline__ void add4_shared(float* p, float4 v) {
  if (v.x != 0.0f) atomicAdd(p, v.x);
  if (v.y != 0.0f) atomicAdd(p + 1, v.y);
  if (v.z != 0.0f) atomicAdd(p + 2, v.z);
  if (v.w != 0.0f) atomicAdd(p + 3, v.w);
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

// The backward's read of a full tile's gradients at `base`: this thread's
// groups of four elements of the spans' runs, into registers
template <class T>
__device__ __forceinline__ void read_groups(const Spans& s, int base, float4 (&g)[T::kGroups]) {
  Runs runs(s, T::kRows);
#pragma unroll
  for (int i = 0; i < T::kGroups; ++i) {
    const int E = 4 * (threadIdx.x + i * kGatherThreads);
    if (E < T::kRows * s.columns) {
      const int e = runs.at(s, T::kRows, E);
      const Span& sp = s.s[runs.k];
      g[i] = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(sp.p) + base * sp.width + e));
    }
  }
}

// ... and their places in the tile
template <class T>
__device__ __forceinline__ void stage_groups(const Spans& s, const float4 (&g)[T::kGroups], float* tile) {
  Runs runs(s, T::kRows);
#pragma unroll
  for (int i = 0; i < T::kGroups; ++i) {
    const int E = 4 * (threadIdx.x + i * kGatherThreads);
    if (E < T::kRows * s.columns) {
      const int e = runs.at(s, T::kRows, E);
      int at[4];
      tile_places(s.s[runs.k], e, at);
      tile[at[0]] = g[i].x;
      tile[at[1]] = g[i].y;
      tile[at[2]] = g[i].z;
      tile[at[3]] = g[i].w;
    }
  }
}

// Its backward: the table's gradient from the spans' gradients alone (the
// spans here are those that take one). A block stages the spans'
// gradients of a tile into their columns of the tile's rows, over all
// spans' runs four elements a thread (one a thread on a ragged last tile),
// the next full tile's read into registers, and its indices, started
// before this tile's adds. 8 threads a row then take a float4 each, and a thread
// whose four are all zero (a missed lane, a column no span covers) adds
// nothing. Without kShared a warp first merges its lanes of one row
// (__match_any_sync on the row, a sum over the match in slot order), then
// adds four floats an atomic. With kShared (a table that fits beside the
// tile) a thread sums its lanes of the first kRegRows rows in registers
// and adds the others to the block's copy of the table; the four slots of
// a warp merge their registers, and the block adds its copy to the
// gradient at the end, four floats an atomic.
template <bool kShared>
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows32_grad(const __grid_constant__ Spans s, const int* __restrict__ index, int count,
                       float* __restrict__ grad_table, int table_rows) {
  using T = Tile<kGradPasses>;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* sums = tile + T::kFloats;  // kShared: the block's copy of the gradient
  const int sub = threadIdx.x % kLanesPerRow, slot = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % 32;
  const int step = gridDim.x * T::kRows;
  const unsigned mine = (s.covered >> (sub * 4)) & 0xFu;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc[kRegRows];
#pragma unroll
  for (int q = 0; q < kRegRows; ++q) acc[q] = zero;
  if (kShared) {
    // ordered before the first add by the loop's first __syncthreads
    for (int e = threadIdx.x; e < table_rows * kRowWidth; e += kGatherThreads) sums[e] = 0.0f;
  }
  int base = blockIdx.x * T::kRows;
  int row[kGradPasses];
  float4 ahead[T::kGroups];
  read_index(index, base, count, sub, slot, row);
  if (count - base >= T::kRows && s.vector) read_groups<T>(s, base, ahead);
  for (; base < count; base += step) {
    const int rows = min(T::kRows, count - base);
    if (rows == T::kRows && s.vector) {
      stage_groups<T>(s, ahead, tile);
    } else {
      Runs runs(s, rows);
      for (int E = threadIdx.x; E < rows * s.columns; E += kGatherThreads) {
        const int e = runs.at(s, rows, E);
        const Span& sp = s.s[runs.k];
        tile[tile_place(sp, e)] = __ldg(static_cast<const float*>(sp.p) + base * sp.width + e);
      }
    }
    take_index(row);
    __syncthreads();
    int at_row[kGradPasses];
#pragma unroll
    for (int u = 0; u < kGradPasses; ++u) at_row[u] = row[u];
    read_index(index, base + step, count, sub, slot, row);
    if (count - (base + step) >= T::kRows && s.vector) read_groups<T>(s, base + step, ahead);
#pragma unroll
    for (int u = 0; u < kGradPasses; ++u) {
      const float* t = tile + (u * kRowsPerPass + slot) * kTileStride + sub * 4;
      float4 g = make_float4((mine & 1u) ? t[0] : 0.0f, (mine & 2u) ? t[1] : 0.0f,
                             (mine & 4u) ? t[2] : 0.0f, (mine & 8u) ? t[3] : 0.0f);
      const int at = at_row[u];
      const bool live = at >= 0 && nonzero(g);
      if (kShared) {
        if (live) {
          if (at < kRegRows) {
#pragma unroll
            for (int q = 0; q < kRegRows; ++q) {
              if (at == q) acc[q] = plus(acc[q], g);
            }
          } else {
            add4_shared(sums + at * kRowWidth + sub * 4, g);
          }
        }
        continue;
      }
      // the warp's lanes of one row and of this thread's four columns (one
      // thread in each of the warp's 4 rows: lanes sub, sub + 8, ...)
      const unsigned peers = __match_any_sync(0xffffffffu, live ? at : -1) & (0x01010101u << sub);
      if (__any_sync(0xffffffffu, live && __popc(peers) > 1)) {
        float4 sum = zero;
#pragma unroll
        for (int q = 0; q < kWarpRows; ++q) {
          const int src = q * kLanesPerRow + sub;
          const float4 o = shfl4(g, src);
          if ((peers >> src) & 1u) sum = plus(sum, o);
        }
        g = sum;
      }
      if (live && lane == __ffs(peers) - 1) add4(grad_table + at * kRowWidth + sub * 4, g);
    }
    __syncthreads();
  }
  if (kShared) {
#pragma unroll
    for (int q = 0; q < kRegRows; ++q) {
      acc[q] = plus(acc[q], shfl4_xor(acc[q], kLanesPerRow));
      acc[q] = plus(acc[q], shfl4_xor(acc[q], 2 * kLanesPerRow));
      if (lane < kLanesPerRow && q < table_rows) add4_shared(sums + q * kRowWidth + sub * 4, acc[q]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < table_rows * kLanesPerRow; e += kGatherThreads) {
      const float4 v = smem4[T::kFloats / 4 + e];
      if (nonzero(v)) add4(grad_table + e * 4, v);
    }
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

// its backward: an atomic an element that is not zero
__global__ void __launch_bounds__(kThreads)
    gather_rows_any_grad(const __grid_constant__ Spans s, const int* __restrict__ index, int count,
                         float* __restrict__ grad_table, int width) {
  const int stride = gridDim.x * kThreads;
  for (int k = 0; k < s.count; ++k) {
    const Span& sp = s.s[k];
    if (sp.p == nullptr) continue;
    const float* g = static_cast<const float*>(sp.p);
    const int n = count * sp.width;
    for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
      const float v = __ldg(g + e);
      if (v == 0.0f) continue;
      const int i = e / sp.width;
      atomicAdd(grad_table + __ldg(index + i) * width + sp.start + (e - i * sp.width), v);
    }
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

// dynamic shared memory of `bytes` for kernel k, opted into above 48 KB;
// returns how many such blocks an SM takes, at most `most`
template <class Kernel>
int shared_blocks(Kernel k, int bytes, int most, cudaError_t* err) {
  *err = cudaSuccess;
  if (bytes > 48 * 1024) {
    *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  const int per_sm = kSmemPerSm / (bytes + 1024);
  return per_sm > most ? most : (per_sm < 1 ? 1 : per_sm);
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
  out->covered = 0u;
  for (int k = 0; k < in->count; ++k) {
    const int a = in->start[k], w = in->width[k];
    if (a < 0 || w < 1 || a + w > width) return false;
    if (grad && (p[k] == nullptr || in->integer[k])) continue;
    out->s[out->count++] = Span{p[k], a, w, in->integer[k] != 0, 1.0f / static_cast<float>(w)};
    out->columns += w;
    if (!aligned16(p[k])) out->vector = 0;
    if (width == kRowWidth) out->covered |= (w == 32 ? 0xffffffffu : ((1u << w) - 1u)) << a;
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

extern "C" int theia_table_read_grad(const Spec* spec, const int* handle, const float* x,
                                     int x_stride, const float* grad_out0,
                                     const float* grad_out1, const float* grad_out2,
                                     const float* grad_out3, int count, float* grad0,
                                     float* grad1, float* grad2, float* grad3,
                                     float* grad_x, cudaStream_t stream) {
  if (!valid(spec)) return static_cast<int>(cudaErrorInvalidValue);
  Grads grads{{grad0, grad1, grad2, grad3}, {0, 0, 0, 0}};
  const ConstRows grad_out{{grad_out0, grad_out1, grad_out2, grad_out3}};
  bool any = grad_x != nullptr;
  long long total = 0;
  for (int k = 0; k < spec->tables; ++k) {
    grads.offset[k] = total;
    total += static_cast<long long>(spec->packed ? spec->media : 1) * spec->len[k];
    any = any || grads.table[k] != nullptr;
  }
  if (count <= 0 || !any) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  const bool tables = grad0 != nullptr || grad1 != nullptr || grad2 != nullptr || grad3 != nullptr;
  if (!tables || total > kSharedMaxFloats) {
    const int grid = grid_for(count, kGradThreads, 4, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    read_tables_grad<false><<<grid, kGradThreads, 0, stream>>>(
        *spec, handle, x, x_stride, grad_out, count, grads, total, grad_x);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(total * sizeof(float));
  const int per_sm = shared_blocks(read_tables_grad<true>, bytes, kGradBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_for(count, kGradThreads, per_sm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  read_tables_grad<true><<<grid, kGradThreads, bytes, stream>>>(
      *spec, handle, x, x_stride, grad_out, count, grads, total, grad_x);
  return static_cast<int>(cudaGetLastError());
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

// grad_out: the spans' (N, width[k]) f32 gradients, null where a span takes none
extern "C" int theia_gather_rows_grad(const TheiaSpans* spans, void* const* grad_out,
                                      const int* index, int count, int rows, int width,
                                      float* grad_table, cudaStream_t stream) {
  Spans s;
  if (!make_spans(spans, grad_out, rows, width, count, true, &s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0 || s.count == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  if (width != kRowWidth || !aligned16(grad_table)) {
    const int grid = grid_for(static_cast<long long>(count) * width, kThreads, 4, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_rows_any_grad<<<grid, kThreads, 0, stream>>>(s, index, count, grad_table, width);
    return static_cast<int>(cudaGetLastError());
  }
  using T = Tile<kGradPasses>;
  const long long floats = T::kFloats + static_cast<long long>(rows) * kRowWidth;
  if (floats > kSharedMaxFloats) {
    const int bytes = T::kFloats * static_cast<int>(sizeof(float));
    const int grid = grid_for(count, T::kRows, kMostBlocksPerSm, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_rows32_grad<false><<<grid, kGatherThreads, bytes, stream>>>(s, index, count, grad_table, rows);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(floats * sizeof(float));
  const int per_sm = shared_blocks(gather_rows32_grad<true>, bytes, kGatherBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_for(count, T::kRows, per_sm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows32_grad<true><<<grid, kGatherThreads, bytes, stream>>>(s, index, count, grad_table, rows);
  return static_cast<int>(cudaGetLastError());
}
