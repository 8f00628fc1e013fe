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
// instance's inst_data row), and adds their gradient back, which eager
// PyTorch runs as a sorting index backward (2.64 s of a 2.78 s geometry
// gradient step on this card, where translate_instance gives both tables a
// graph) or, through index_select, as index_add_ with an atomic for every
// element, the zero shares of the lanes that missed included, all on row 0.
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

// ---- whole rows of a table (the hit reconstruction's tri_data and
// inst_data rows): out[i, :] = table[index[i], :], element by element ----
__global__ void __launch_bounds__(kThreads)
    gather(const float* __restrict__ table, int width, const int* __restrict__ index,
           long long count, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < count;
       e += stride) {
    const long long i = e / width;
    out[e] = __ldg(table + static_cast<long long>(index[i]) * width + (e - i * width));
  }
}

// its backward: a warp adds one row's 32 neighbouring entries (distinct
// addresses); kShared sums in shared memory first, as read_tables_grad does
template <bool kShared>
__global__ void __launch_bounds__(kGradThreads)
    gather_grad(const float* __restrict__ grad_out, int width,
                const int* __restrict__ index, long long count,
                float* __restrict__ grad_table, long long table_size) {
  extern __shared__ float sums[];
  float* acc = grad_table;
  if (kShared) {
    for (long long k = threadIdx.x; k < table_size; k += kGradThreads) sums[k] = 0.0f;
    __syncthreads();
    acc = sums;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kGradThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kGradThreads + threadIdx.x; e < count;
       e += stride) {
    const long long i = e / width;
    add(acc, static_cast<long long>(index[i]) * width + (e - i * width), grad_out[e]);
  }
  if (kShared) {
    __syncthreads();
    for (long long k = threadIdx.x; k < table_size; k += kGradThreads) {
      const float s = sums[k];
      if (s != 0.0f) atomicAdd(grad_table + k, s);
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
// returns how many such blocks an SM takes, at most kGradBlocksPerSm
template <class Kernel>
int shared_blocks(Kernel k, int bytes, cudaError_t* err) {
  *err = cudaSuccess;
  if (bytes > 48 * 1024) {
    *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  const int per_sm = kSmemPerSm / (bytes + 1024);
  return per_sm > kGradBlocksPerSm ? kGradBlocksPerSm : (per_sm < 1 ? 1 : per_sm);
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
  const int per_sm = shared_blocks(read_tables_grad<true>, bytes, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_for(count, kGradThreads, per_sm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  read_tables_grad<true><<<grid, kGradThreads, bytes, stream>>>(
      *spec, handle, x, x_stride, grad_out, count, grads, total, grad_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int theia_gather_rows(const float* table, int width, const int* index,
                                 int count, float* out, cudaStream_t stream) {
  const long long elements = static_cast<long long>(count) * width;
  if (elements <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  const int grid = grid_for(elements, kThreads, kBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather<<<grid, kThreads, 0, stream>>>(table, width, index, elements, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int theia_gather_rows_grad(const float* grad_out, int width,
                                      const int* index, int count, int rows,
                                      float* grad_table, cudaStream_t stream) {
  const long long elements = static_cast<long long>(count) * width;
  const long long table_size = static_cast<long long>(rows) * width;
  if (elements <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  if (table_size > kSharedMaxFloats) {
    const int grid = grid_for(elements, kGradThreads, 4, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_grad<false><<<grid, kGradThreads, 0, stream>>>(grad_out, width, index, elements,
                                                          grad_table, table_size);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = static_cast<int>(table_size * sizeof(float));
  const int per_sm = shared_blocks(gather_grad<true>, bytes, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_for(elements, kGradThreads, per_sm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_grad<true><<<grid, kGradThreads, bytes, stream>>>(grad_out, width, index, elements,
                                                           grad_table, table_size);
  return static_cast<int>(cudaGetLastError());
}
