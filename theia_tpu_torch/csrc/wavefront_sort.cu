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
// launches over tiles of kTile = 1024 lanes (256 tiles at 262,144 rays, about
// two an SM):
//   count_keys    a block a tile: each lane's key (JAX's float steps: (o -
//                 lo) / span * 4 truncated toward zero with XLA's
//                 saturating cast, NaN -> 0, clipped to [0, 3]) and the
//                 tile's count of each key, stored [tile][key];
//   scan_columns  a warp a key, over all tiles at once: lane l sums a
//                 32nd of the key's column, the warp scans the 32 sums,
//                 each lane writes its part's exclusive prefix in place,
//                 and the key's total;
//   scatter_rays  a block a tile again: the keys' first positions (each
//                 block scans the 512 totals itself), a warp's count of
//                 each key over its 128 lanes (rounds of 32 lanes grouped
//                 by __match_any_sync, the lowest of a group adding its
//                 count), the warps' prefix, then the same rounds ranked
//                 within a key; each lane's destination and source are
//                 staged in shared memory in the tile's key order, and a
//                 thread a staged entry writes key order's runs: order[pos]
//                 and the ray's copy at pos, neighbouring threads on
//                 neighbouring positions within a run.
// pos = (lanes of smaller keys) + (lanes of the same key in earlier tiles,
// earlier warps, earlier rounds, lower lanes), so order is what a stable
// argsort of the key gives, bit for bit. scatter_back puts the query's
// outputs back: t[order[i]] = t_s[i], the same for idx, and rows 8 threads
// a row as float4. Every kernel is a programmatic dependent (launch.cuh):
// it waits for the kernel before it at its first device-memory access
// rather than behind a launch.
//
// What bounds it on an H100: bytes. Per lane the sort reads o, d and
// t_max (28 B) and writes order, the key and the copy (36 B); the scatter
// reads order, t and idx (12 B, 140 with rows) and writes t and idx (8 B,
// 136), each 4-byte write of t and idx to its own sector. The key is 10-20
// operations a lane; scatter_rays computes it again from the rays it
// copies rather than read it back. The table of counts is (tiles x 512)
// ints, 512 KB at 262,144 rays, read and written once by the scan.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kCells = 4;                              // BIN_CELLS
constexpr int kKeys = 8 * kCells * kCells * kCells;    // BIN_KEYS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                            // SORT_TILE
constexpr int kWarpLanes = kTile / kWarps;
constexpr int kScanWarps = kThreads / 32;              // keys a block of scan_columns

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
    const float* __restrict__ o, const float* __restrict__ d, Bounds b, int n, int* __restrict__ counts) {
  __shared__ int hist[kKeys];
  for (int k = threadIdx.x; k < kKeys; k += kThreads) hist[k] = 0;
  __syncthreads();
  pdl::wait_for_previous();
  const int base = blockIdx.x * kTile;
  // rays of a warp that share a key count once, by the lowest of them: a
  // wavefront's keys cluster (rays from one cell into one octant)
#pragma unroll
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = base + j;
    const int k = i < n ? octant_cell_key(o, d, b, i) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && (threadIdx.x & 31) == __ffs(same) - 1) atomicAdd(&hist[k], __popc(same));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kKeys; k += kThreads) {
    counts[static_cast<size_t>(blockIdx.x) * kKeys + k] = hist[k];
  }
}

// a warp's inclusive prefix sum of one value a lane
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) scan_columns(int* __restrict__ counts, int n_tiles,
                                                         int* __restrict__ totals) {
  pdl::wait_for_previous();
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  const int per = (n_tiles + 31) / 32;
  const int first = min(lane * per, n_tiles), last = min(first + per, n_tiles);
  int* col = counts + k;
  int sum = 0;
  for (int t = first; t < last; ++t) sum += col[static_cast<size_t>(t) * kKeys];
  const int inclusive = warp_inclusive_scan(sum);
  int run = inclusive - sum;
  for (int t = first; t < last; ++t) {
    const int c = col[static_cast<size_t>(t) * kKeys];
    col[static_cast<size_t>(t) * kKeys] = run;
    run += c;
  }
  if (lane == 31) totals[k] = inclusive;
}

// exclusive prefix over the keys of v[k] (kKeys values in shared memory, in
// place), by a block of kThreads threads; returns the sum of all
__device__ __forceinline__ int block_key_scan(int* v, int* warp_sums) {
  constexpr int kPer = kKeys / kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mine[kPer], sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    mine[u] = v[threadIdx.x * kPer + u];
    sum += mine[u];
  }
  const int inclusive = warp_inclusive_scan(sum);
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  int run = before + inclusive - sum;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    v[threadIdx.x * kPer + u] = run;
    run += mine[u];
  }
  __syncthreads();
  return all;
}

__global__ void __launch_bounds__(kThreads) scatter_rays(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_max, Bounds b,
    const int* __restrict__ counts, const int* __restrict__ totals, int n, int* __restrict__ key_out,
    int* __restrict__ order, float* __restrict__ o_s, float* __restrict__ d_s, float* __restrict__ t_s) {
  __shared__ int warp_next[kWarps][kKeys];  // a warp's next rank of each key in the tile
  __shared__ int tile_first[kKeys];         // a key's first place in the tile's key order
  __shared__ int global_first[kKeys];       // ... and in the sorted wavefront
  __shared__ int dst[kTile], src[kTile];
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = lane; k < kKeys; k += 32) warp_next[warp][k] = 0;
  pdl::wait_for_previous();
  // the keys' first positions: the totals' prefix, plus this tile's column prefix
  for (int k = threadIdx.x; k < kKeys; k += kThreads) global_first[k] = totals[k];
  __syncthreads();
  block_key_scan(global_first, warp_sums);
  const int base = blockIdx.x * kTile, first = base + warp * kWarpLanes;
  const unsigned below = (1u << lane) - 1u;
  int key[kWarpLanes / 32];
  unsigned same[kWarpLanes / 32];  // a round's lanes of the same key
#pragma unroll
  for (int r = 0; r < kWarpLanes / 32; ++r) {
    const int i = first + 32 * r + lane;
    key[r] = i < n ? octant_cell_key(o, d, b, i) : -1;
    same[r] = __match_any_sync(0xffffffffu, key[r]);
    if (i < n) {
      key_out[i] = key[r];
      if ((same[r] & below) == 0u) warp_next[warp][key[r]] += __popc(same[r]);  // the warp's own row
    }
    __syncwarp();
  }
  __syncthreads();
  // a key's warps' prefix in the tile, and its count in the tile
  for (int k = threadIdx.x; k < kKeys; k += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_next[w][k];
      warp_next[w][k] = run;
      run += c;
    }
    tile_first[k] = run;
    global_first[k] += counts[static_cast<size_t>(blockIdx.x) * kKeys + k];
  }
  __syncthreads();
  const int in_tile = block_key_scan(tile_first, warp_sums);
#pragma unroll
  for (int r = 0; r < kWarpLanes / 32; ++r) {
    const int i = first + 32 * r + lane, k = key[r];
    if (k >= 0) {
      const int rank = warp_next[warp][k] + __popc(same[r] & below);
      dst[tile_first[k] + rank] = global_first[k] + rank;
      src[tile_first[k] + rank] = i;
    }
    __syncwarp();
    if (k >= 0 && (same[r] & below) == 0u) warp_next[warp][k] += __popc(same[r]);
    __syncwarp();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < in_tile; j += kThreads) {
    const int pos = dst[j], i = src[j];
    order[pos] = i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o_s[3 * static_cast<size_t>(pos) + c] = o[3 * static_cast<size_t>(i) + c];
      d_s[3 * static_cast<size_t>(pos) + c] = d[3 * static_cast<size_t>(i) + c];
    }
    t_s[pos] = t_max[i];
  }
}

// a sorted lane's t and idx to their lane, and with rows its row, 8 threads
// a row as float4 (the first of them moves t and idx)
template <bool kRows>
__global__ void __launch_bounds__(kThreads) scatter_back(
    const int* __restrict__ order, const float* __restrict__ t_s, const int* __restrict__ idx_s,
    const float4* __restrict__ rows_s, int n, float* __restrict__ t, int* __restrict__ idx,
    float4* __restrict__ rows) {
  constexpr int kPer = kRows ? 8 : 1;  // float4 pieces of a 32-float row
  pdl::wait_for_previous();
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

// counts (n_tiles x 512, n_tiles = ceil(n / kTile)) and totals (512) are
// scratch of the caller's; key holds each lane's key afterwards
extern "C" int theia_wavefront_sort(const float* origin, const float* direction, const float* t_max,
                                    float lo0, float lo1, float lo2, float span0, float span1,
                                    float span2, int n, int* key, int* counts, int* totals,
                                    int* order, float* origin_s, float* direction_s, float* t_max_s,
                                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Bounds b{{lo0, lo1, lo2}, {span0, span1, span2}};
  const int n_tiles = (n + kTile - 1) / kTile;
  cudaError_t err = pdl::launch(count_keys, dim3(n_tiles), dim3(kThreads), 0, stream, origin, direction, b, n, counts);
  if (err == cudaSuccess) {
    err = pdl::launch(scan_columns, dim3(kKeys / kScanWarps), dim3(kThreads), 0, stream, counts, n_tiles, totals);
  }
  if (err == cudaSuccess) {
    err = pdl::launch(scatter_rays, dim3(n_tiles), dim3(kThreads), 0, stream, origin, direction, t_max, b,
                      static_cast<const int*>(counts), static_cast<const int*>(totals), n, key, order, origin_s,
                      direction_s, t_max_s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// rows_s and rows: (n, 32) float32, 16-byte aligned, or both null
extern "C" int theia_wavefront_scatter(const int* order, const float* t_s, const int* idx_s,
                                       const float* rows_s, int n, float* t, int* idx, float* rows,
                                       cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto* rs = reinterpret_cast<const float4*>(rows_s);
  auto* r = reinterpret_cast<float4*>(rows);
  const long long threads = (rows_s != nullptr ? 8LL : 1LL) * n;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  const cudaError_t err = pdl::launch(rows_s != nullptr ? scatter_back<true> : scatter_back<false>, grid,
                                      dim3(kThreads), 0, stream, order, t_s, idx_s, rs, n, t, idx, r);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
