// The table read: linear interpolation in lookup tables, and its backward.
//
// Replaces the reads that theia_tpu leaves to XLA, with the VJPs that JAX
// derives for them: theia_tpu/lookup.py lookup (l.43: one table of n
// samples over [0, 1], v_lo * (1 - l) + v_hi * l) and theia_tpu/material.py
// lookup_packed (l.355: a medium's row of packed (M, L) tables, v_j + l *
// (v_{j+1} - v_j), the last column's slope 0, null_value where the table
// is null), which takes C <= 4 tables stacked (M, L, C) for the const4 read
// of packed_medium_constants (l.397: four values and their four slopes a
// row; the slope here is the same float32 difference, taken in the kernel).
// The coordinate is clipped to [0, 1] with jnp.clip's gradient: 1/2 on a
// bound, where JAX's max and min split a tie.
// A third form reads whole rows, the gathers of theia_tpu/accel.py
// _reconstruct_hit (l.614, 640: a winner's 32-float tri_data row and its
// instance's inst_data row), and adds their gradient back, which eager
// PyTorch runs as a sorting index backward (2.64 s of a 2.78 s geometry
// gradient step on this card, where translate_instance gives both tables a
// graph) or, through index_select, as index_add_ with an atomic for every
// element, the zero shares of the lanes that missed included, all on row 0.
//
// What bounds them on an H100. The forward: bytes. A lane reads its
// coordinate (and handle) and writes its value, 8 to 12 bytes against
// some ten float operations a channel; the tables, 3 KB to 12 KB on the
// port's paths, stay in L1 and L2. The backward writes a lane's gradient
// of the coordinate (4 bytes) and adds its share of the table's gradient
// to one to eight table entries; what limits it is where those adds meet.
// On the flagship's const4 tables 262,144 lanes add into 3 x 256 x 4
// floats, and the lanes of one wavelength add into the same rows. Eager
// PyTorch runs this backward as a sort of the indices and a segmented sum
// (indexing_backward_kernel_small_stride): 51 ms of a 168 ms polarized
// gradient step on this card, for work that moves a few megabytes.
//
// Design. The forward kernels are elementwise, a thread a lane in a grid
// of a few blocks an SM with a loop, and do the plain versions' float32
// ops in the same order (built with -fmad=false), so they are bit-equal
// to them: one ulp of an index of refraction, a coefficient or a group
// velocity could flip a Fresnel or scatter decision. The backward kernels
// keep a copy of the whole table's gradient in each block's shared memory
// (zeroed at every launch), add each lane's share there, and then add each
// entry that is not zero to the output with one global atomic; tables
// above kSharedMaxFloats (what a block can opt into of the SM's 227 KB)
// take the same kernel with the adds going straight to the output. Few
// blocks (at most two an SM) take many lanes each, so that a block's flush
// is small against its lanes' adds. The coordinate's gradient is written
// a lane, without atomics, and is bit-equal to the plain version's; the
// table's sums land in an order that changes from run to run, so they
// agree with the plain version's sequential sums to float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kGradThreads = 512;
constexpr int kGradBlocksPerSm = 2;
constexpr int kSmemPerSm = 227 * 1024;
// the largest table gradient that a block sums in shared memory, in floats;
// equals ops/table_read.py SHARED_TABLE_MAX
constexpr int kSharedMaxFloats = (kSmemPerSm - 1024) / 4;

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

// ---- one table (lookup.lookup) ----
struct Single {
  const float* table;
  int n;
  const float* u;

  __device__ float forward(int i) const {
    const float x = clip01(u[i]) * static_cast<float>(n - 1);
    const float fl = floorf(x);
    const float l = x - fl;
    const float lo = __ldg(table + row_of(fl, n));
    const float hi = __ldg(table + row_of(ceilf(x), n));
    return lo * (1.0f - l) + hi * l;
  }

  // adds the lane's share of d table into acc (if any), returns d u
  __device__ float backward(int i, const float* grad_out, float* acc) const {
    const float g = grad_out[i];
    const float ui = u[i];
    const float nm1 = static_cast<float>(n - 1);
    const float x = clip01(ui) * nm1;
    const float fl = floorf(x);
    const float l = x - fl;
    const int lo = row_of(fl, n), hi = row_of(ceilf(x), n);
    if (acc != nullptr) {
      add(acc, lo, g * (1.0f - l));
      add(acc, hi, g * l);
    }
    return (g * __ldg(table + hi) - g * __ldg(table + lo)) * nm1 * clip_grad(ui);
  }
};

// ---- packed tables, C channels a lane (material.lookup_packed and the
// const4 read) ----
constexpr int kMaxChannels = 4;  // equals ops/table_read.py MAX_CHANNELS

struct Nulls {
  float v[kMaxChannels];
};

struct Packed {
  const float* values;  // (M, len, channels)
  int len, channels;
  const int* sizes;
  const int* handle;
  const float* t;

  struct Lane {
    long long row;  // the lane's row j of (M * len) rows
    int n, j;
    float l, scale;
  };

  __device__ Lane locate(int i) const {
    const int h = handle[i];
    Lane a;
    a.n = __ldg(sizes + h);
    a.scale = static_cast<float>(a.n - 1 > 1 ? a.n - 1 : 1);
    const float tt = clip01(t[i]) * a.scale;
    const float fl = floorf(tt);
    a.l = tt - fl;
    a.j = row_of(fl, len);
    a.row = static_cast<long long>(h) * len + a.j;
    return a;
  }

  __device__ float value(const Lane& a, int c) const {
    return __ldg(values + a.row * channels + c);
  }

  __device__ float slope(const Lane& a, int c, float v) const {
    return a.j < len - 1 ? __ldg(values + (a.row + 1) * channels + c) - v : 0.0f;
  }

  __device__ void forward(int i, const Nulls& nulls, float* out) const {
    const Lane a = locate(i);
    float* o = out + static_cast<long long>(i) * channels;
    for (int c = 0; c < channels; ++c) {
      const float v = value(a, c);
      const float res = v + a.l * slope(a, c, v);
      o[c] = a.n == 0 ? nulls.v[c] : res;
    }
  }

  __device__ float backward(int i, const float* grad_out, float* acc) const {
    const Lane a = locate(i);
    if (a.n == 0) return 0.0f;
    const float* go = grad_out + static_cast<long long>(i) * channels;
    float dt = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const float g = go[c];
      const long long k = a.row * channels + c;
      if (acc != nullptr) {
        if (a.j < len - 1) {
          add(acc, k, g - g * a.l);
          add(acc, k + channels, g * a.l);
        } else {
          add(acc, k, g);
        }
      }
      // the channels' products summed in order, as the plain version does
      const float p = g * slope(a, c, value(a, c));
      dt = c == 0 ? p : dt + p;
    }
    return dt * a.scale * clip_grad(t[i]);
  }
};

__global__ void __launch_bounds__(kThreads)
    read_single(Single f, int count, float* __restrict__ out) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count; i += stride) {
    out[i] = f.forward(i);
  }
}

__global__ void __launch_bounds__(kThreads)
    read_packed(Packed f, Nulls nulls, int count, float* __restrict__ out) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count; i += stride) {
    f.forward(i, nulls, out);
  }
}

// the backward: kShared sums the table's gradient in shared memory first;
// grad_table and grad_u may each be null
template <class Form, bool kShared>
__global__ void __launch_bounds__(kGradThreads)
    read_grad(Form f, const float* __restrict__ grad_out, int count,
              float* __restrict__ grad_table, long long table_size,
              float* __restrict__ grad_u) {
  extern __shared__ float sums[];
  float* acc = grad_table;
  if (kShared) {
    for (long long k = threadIdx.x; k < table_size; k += kGradThreads) sums[k] = 0.0f;
    __syncthreads();
    acc = sums;
  }
  const int stride = gridDim.x * kGradThreads;
  for (int i = blockIdx.x * kGradThreads + threadIdx.x; i < count; i += stride) {
    const float du = f.backward(i, grad_out, acc);
    if (grad_u != nullptr) grad_u[i] = du;
  }
  if (kShared) {
    // every thread arrives here: the loop has no return
    __syncthreads();
    for (long long k = threadIdx.x; k < table_size; k += kGradThreads) {
      const float s = sums[k];
      if (s != 0.0f) atomicAdd(grad_table + k, s);
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
// addresses); kShared sums in shared memory first, as read_grad does
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

template <class Form>
cudaError_t launch_grad(const Form& f, const float* grad_out, int count,
                        float* grad_table, long long table_size, float* grad_u,
                        cudaStream_t stream) {
  if (count <= 0 || (grad_table == nullptr && grad_u == nullptr)) {
    return cudaGetLastError();
  }
  cudaError_t err = cudaSuccess;
  const bool shared = grad_table != nullptr && table_size <= kSharedMaxFloats;
  if (!shared) {
    const int grid = grid_for(count, kGradThreads, 4, &err);
    if (err != cudaSuccess) return err;
    read_grad<Form, false><<<grid, kGradThreads, 0, stream>>>(
        f, grad_out, count, grad_table, table_size, grad_u);
    return cudaGetLastError();
  }
  const int bytes = static_cast<int>(table_size * sizeof(float));
  const int per_sm = shared_blocks(read_grad<Form, true>, bytes, &err);
  if (err != cudaSuccess) return err;
  const int grid = grid_for(count, kGradThreads, per_sm, &err);
  if (err != cudaSuccess) return err;
  read_grad<Form, true><<<grid, kGradThreads, bytes, stream>>>(
      f, grad_out, count, grad_table, table_size, grad_u);
  return cudaGetLastError();
}

}  // namespace

extern "C" int theia_table_read(const float* table, int n, const float* u,
                                int count, float* out, cudaStream_t stream) {
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaSuccess;
  const int grid = grid_for(count, kThreads, kBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  read_single<<<grid, kThreads, 0, stream>>>(Single{table, n, u}, count, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int theia_table_read_grad(const float* table, int n, const float* u,
                                     const float* grad_out, int count,
                                     float* grad_table, float* grad_u,
                                     cudaStream_t stream) {
  return static_cast<int>(launch_grad(Single{table, n, u}, grad_out, count,
                                      grad_table, n, grad_u, stream));
}

extern "C" int theia_packed_read(const float* values, int m, int len,
                                 int channels, const int* sizes,
                                 const int* handle, const float* t,
                                 float null0, float null1, float null2,
                                 float null3, int count, float* out,
                                 cudaStream_t stream) {
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  if (channels < 1 || channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  const int grid = grid_for(count, kThreads, kBlocksPerSm, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  read_packed<<<grid, kThreads, 0, stream>>>(
      Packed{values, len, channels, sizes, handle, t}, Nulls{{null0, null1, null2, null3}},
      count, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int theia_packed_read_grad(const float* values, int m, int len,
                                      int channels, const int* sizes,
                                      const int* handle, const float* t,
                                      const float* grad_out, int count,
                                      float* grad_values, float* grad_t,
                                      cudaStream_t stream) {
  if (channels < 1 || channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_grad(Packed{values, len, channels, sizes, handle, t},
                                      grad_out, count, grad_values,
                                      static_cast<long long>(m) * len * channels, grad_t,
                                      stream));
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
