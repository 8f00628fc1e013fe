// Wavefront sort of the binned nearest-hit queries: a stable counting sort
// of the rays by (direction octant, position cell), their permuted copy,
// and, after the query, the scatter of its results back to lane order.
//
// Replaces theia_tpu/ops/_intersect_tiles.py octant_cell_key (l.179) and
// run_binned (l.197): the key, jnp.argsort of it (stable), the gathers of
// o, d and t_max in the sorted order, and after the query the
// .at[order].set of t and idx (and of the winners' rows, where the mt query
// fetches them, tools/exp_mt_fused.py).
//
// The key has 8 x 4^3 = 512 values, so a counting sort does it in three
// passes over the rays where a general radix sort would take several:
//   count_keys    a block of kTile lanes: each lane's key (JAX's float
//                 steps: (o - lo) / span * 4 truncated toward zero with
//                 XLA's saturating cast, NaN -> 0, clipped to [0, 3]) and
//                 the block's count of each key, stored [block][key];
//   scan_counts   one block, a thread a key: the exclusive prefix of a
//                 key's counts over the blocks, then of the keys' totals;
//   scatter_rays  a block's lanes again, each warp a contiguous run of
//                 kTile / kWarps lanes: a warp's count of each key, the
//                 warps' prefix on top of the block's offsets, then rounds
//                 of 32 lanes ranked within a key by __match_any_sync; each
//                 lane writes order[pos] and its ray's copy at pos.
// pos = (lanes of smaller keys) + (lanes of the same key in earlier blocks,
// earlier warps, earlier rounds, lower lanes), so order is what a stable
// argsort of the key gives, bit for bit. scatter_back puts the query's
// outputs back: t[order[i]] = t_s[i], the same for idx, and rows 8 threads
// a row as float4.
//
// What bounds it on an H100: bytes. Per lane the sort reads o, d and
// t_max (28 B) and writes order and the copy (32 B); the scatter reads
// order, t and idx (12 B, 140 with rows) and writes t and idx (8 B, 136).
// The key is 10-20 operations a lane. Design: the key and the counts never
// leave shared memory except as a (blocks x 512) table and a lane's 4-byte
// key, which the third pass reads instead of recomputing. The scan is one
// block whose loads are unrolled eight blocks deep. A simple first design:
// the third pass writes the permuted rays at scattered positions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 4;                              // BIN_CELLS
constexpr int kKeys = 8 * kCells * kCells * kCells;    // BIN_KEYS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                            // SORT_TILE
constexpr int kWarpLanes = kTile / kWarps;
constexpr int kScanUnroll = 8;

struct Bounds {
  float lo[3];
  float span[3];
};

__device__ __forceinline__ int cell(float o, float lo, float span) {
  const float x = ((o - lo) / span) * static_cast<float>(kCells);
  // __float2int_rz saturates and maps NaN to 0, as XLA's convert does
  return min(max(__float2int_rz(x), 0), kCells - 1);
}

__device__ __forceinline__ int octant_cell_key(const float* __restrict__ o,
                                               const float* __restrict__ d,
                                               const Bounds& b, int i) {
  const float* oi = o + 3 * static_cast<size_t>(i);
  const float* di = d + 3 * static_cast<size_t>(i);
  const int oct = (di[0] >= 0.f ? 4 : 0) + (di[1] >= 0.f ? 2 : 0) + (di[2] >= 0.f ? 1 : 0);
  const int c = (cell(oi[0], b.lo[0], b.span[0]) * kCells + cell(oi[1], b.lo[1], b.span[1])) * kCells +
                cell(oi[2], b.lo[2], b.span[2]);
  return oct * (kCells * kCells * kCells) + c;
}

__global__ void __launch_bounds__(kThreads) count_keys(
    const float* __restrict__ o, const float* __restrict__ d, Bounds b, int n,
    int* __restrict__ key, int* __restrict__ counts) {
  __shared__ int hist[kKeys];
  for (int k = threadIdx.x; k < kKeys; k += kThreads) hist[k] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = base + j;
    if (i < n) {
      const int k = octant_cell_key(o, d, b, i);
      key[i] = k;
      atomicAdd(&hist[k], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kKeys; k += kThreads) {
    counts[static_cast<size_t>(blockIdx.x) * kKeys + k] = hist[k];
  }
}

// exclusive prefix sum over the block's threads (one value each)
template <int kBlock>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  constexpr int kBlockWarps = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kBlockWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kBlockWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kKeys) scan_counts(int* __restrict__ counts, int n_tiles,
                                                     int* __restrict__ key_base) {
  __shared__ int warp_sums[kKeys / 32];
  const int k = threadIdx.x;
  int run = 0, t = 0;
  for (; t + kScanUnroll <= n_tiles; t += kScanUnroll) {
    int c[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) c[u] = counts[static_cast<size_t>(t + u) * kKeys + k];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      counts[static_cast<size_t>(t + u) * kKeys + k] = run;
      run += c[u];
    }
  }
  for (; t < n_tiles; ++t) {
    const int c = counts[static_cast<size_t>(t) * kKeys + k];
    counts[static_cast<size_t>(t) * kKeys + k] = run;
    run += c;
  }
  key_base[k] = block_exclusive_scan<kKeys>(run, warp_sums);
}

__global__ void __launch_bounds__(kThreads) scatter_rays(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_max,
    const int* __restrict__ key, const int* __restrict__ counts, const int* __restrict__ key_base,
    int n, int* __restrict__ order, float* __restrict__ o_s, float* __restrict__ d_s,
    float* __restrict__ t_s) {
  __shared__ int next[kWarps][kKeys];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = lane; k < kKeys; k += 32) next[warp][k] = 0;
  __syncwarp();
  const int first = blockIdx.x * kTile + warp * kWarpLanes;
  for (int j = lane; j < kWarpLanes; j += 32) {
    const int i = first + j;
    if (i < n) atomicAdd(&next[warp][key[i]], 1);
  }
  __syncthreads();
  // each key's first position in this block, then in each warp's run
  for (int k = threadIdx.x; k < kKeys; k += kThreads) {
    int pos = key_base[k] + counts[static_cast<size_t>(blockIdx.x) * kKeys + k];
    for (int w = 0; w < kWarps; ++w) {
      const int c = next[w][k];
      next[w][k] = pos;
      pos += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < kWarpLanes; j += 32) {
    const int i = first + j + lane;
    const bool live = i < n;
    const int k = live ? key[i] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, k);
    const int pos = live ? next[warp][k] + __popc(same & below) : 0;
    __syncwarp();
    if (live && (same & below) == 0u) next[warp][k] += __popc(same);
    __syncwarp();
    if (live) {
      order[pos] = i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o_s[3 * static_cast<size_t>(pos) + c] = o[3 * static_cast<size_t>(i) + c];
        d_s[3 * static_cast<size_t>(pos) + c] = d[3 * static_cast<size_t>(i) + c];
      }
      t_s[pos] = t_max[i];
    }
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads) scatter_back(
    const int* __restrict__ order, const float* __restrict__ t_s, const int* __restrict__ idx_s,
    const float4* __restrict__ rows_s, int n, float* __restrict__ t, int* __restrict__ idx,
    float4* __restrict__ rows) {
  constexpr int kPer = kRows ? 8 : 1;  // float4 pieces of a 32-float row
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = g / kPer;
  const int c = static_cast<int>(g % kPer);
  if (i >= n) return;
  const int j = order[i];
  if (c == 0) {
    t[j] = t_s[i];
    idx[j] = idx_s[i];
  }
  if (kRows) rows[static_cast<size_t>(j) * kPer + c] = rows_s[static_cast<size_t>(i) * kPer + c];
}

}  // namespace

// key, counts (n_tiles x 512, n_tiles = ceil(n / kTile)) and key_base (512)
// are scratch of the caller's; key holds each lane's key afterwards
extern "C" int theia_wavefront_sort(const float* origin, const float* direction, const float* t_max,
                                    float lo0, float lo1, float lo2, float span0, float span1,
                                    float span2, int n, int* key, int* counts, int* key_base,
                                    int* order, float* origin_s, float* direction_s, float* t_max_s,
                                    cudaStream_t stream) {
  if (n > 0) {
    const Bounds b{{lo0, lo1, lo2}, {span0, span1, span2}};
    const int n_tiles = (n + kTile - 1) / kTile;
    count_keys<<<n_tiles, kThreads, 0, stream>>>(origin, direction, b, n, key, counts);
    scan_counts<<<1, kKeys, 0, stream>>>(counts, n_tiles, key_base);
    scatter_rays<<<n_tiles, kThreads, 0, stream>>>(origin, direction, t_max, key, counts, key_base, n,
                                                   order, origin_s, direction_s, t_max_s);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows_s and rows: (n, 32) float32, 16-byte aligned, or both null
extern "C" int theia_wavefront_scatter(const int* order, const float* t_s, const int* idx_s,
                                       const float* rows_s, int n, float* t, int* idx, float* rows,
                                       cudaStream_t stream) {
  if (n > 0) {
    const auto* rs = reinterpret_cast<const float4*>(rows_s);
    auto* r = reinterpret_cast<float4*>(rows);
    if (rows_s != nullptr) {
      const long long threads = 8LL * n;
      scatter_back<true><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          order, t_s, idx_s, rs, n, t, idx, r);
    } else {
      scatter_back<false><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(order, t_s, idx_s, rs, n,
                                                                                   t, idx, r);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
