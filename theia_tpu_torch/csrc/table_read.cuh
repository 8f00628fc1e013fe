// The table read's constants and its forward for one lane, shared by the
// read kernels (csrc/table_read.cu) and the segment kernels (csrc/segment.cu),
// which read the same packed tables at their lanes' media without a launch
// of their own. The arithmetic is ops/table_read.py's plain version, op for
// op (built with -fmad=false): moving it here changed no bit of the reads.

#pragma once

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

namespace theia_read {

using Spec = TheiaTableSpec;

// the most tables a read takes; equals ops/table_read.py MAX_TABLES
constexpr int kMaxTables = 4;
// the coordinate's forms; equal ops/table_read.py T, AFFINE, WAVELENGTH
constexpr int kT = 0, kAffine = 1, kWavelength = 2;

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

// A lane's values of the K tables at its handle h (packed: its medium's
// row) and input x: the forward read, op for op the plain version's
// (ops/table_read.py _Reader.plain). The read kernel and the segment
// kernels (csrc/segment.cu) both read through it.
__device__ __forceinline__ void read_lane(const Spec& s, int h, float xv, float* out) {
  const Coordinate c = coordinate(s, h, xv);
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
    out[k] = v;
  }
}

}  // namespace theia_read
