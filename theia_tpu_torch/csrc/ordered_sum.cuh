// The order in which the records (csrc/histogram.cu, csrc/kernel_histogram.cu)
// add their items into a state, and the two passes that keep it.
//
// An item is a (lane, flat bin, value) of a record: one a kept lane in the
// histogram, up to 2 * support + 1 in the kernel histogram. The backward
// kernels take the same order for their sums: the table reads' backward
// (csrc/table_read.cu; items a lane's two shares of each table), the kernel
// histogram's (its three scalars as three bins) and the row gathers'
// backward (a tile pass of its own in csrc/table_read.cu, the same order).
// Float adds do not associate, so a sum that adds with atomics in the order
// its blocks arrive gives other bits on every run. Here a bin's sum is a fixed function
// of the lanes' indices, the lane count n and the state's size:
//
//   1. a warp's span of kSpanLanes = 128 lanes (4 rows of 32): the span's
//      items of the bin, one after another from +0.0, rows in order, in a
//      row the source's slots in order (the kernel histogram's offsets from
//      -support up), in a slot the lanes in order;
//   2. a tile of kTileLanes = 1024 lanes (kWarps = 8 spans): the spans'
//      sums in span order;
//   3. a group of G = ceil(tiles / kGroups) tiles: the tiles' sums in order;
//   4. the record: the kGroups = 32 groups' sums in order; a bin whose sum
//      is not 0 then becomes state + sum.
//
// Each level adds from +0.0, so no partial sum is ever -0.0 and adding an
// empty span's, tile's or group's +0.0 changes no bit: the passes below add
// them or skip them alike. response.ordered_bin_sums is the plain twin of
// the order; the records' plain versions go through it.
//
// Two passes keep the order. The dense pass, for a record of up to
// kDenseCells tiles x bins (and past that where the sparse pass's tables do
// not fit): one launch, a block a (tile, range of kRange flat bins), a warp a span.
// The warp keeps its span's sums of the range in a row of shared memory:
// for each (row, slot) the lanes that hold the same bin are found by
// __match_any_sync, and in round r the lane of rank r among them adds onto
// the row's entry (as many rounds as the largest such group); then a
// thread a bin adds the block's 8 rows in warp order and writes the tile's
// sums to a (tiles x bins) table in device memory. The last block of a
// group to finish (a count a group, kept in counters that the caller holds
// at 0 between records) adds the group's tiles in order, and the last group
// the groups into the state; a group whose tiles' sums are all 0, and a
// record whose groups are, adds nothing, so a record that keeps no lane
// reads no table. A state wider than kRange takes several ranges in the
// grid's second dimension (each block reads the lanes of its tile again),
// and a table larger than the caller's scratch several batches of ranges,
// a launch each.
//
// The dense pass costs tiles x bins twice over (the rows in shared memory
// and the table): 38x the float atomics at 64,000 bins. So a record past
// kDenseCells tiles x bins takes the sparse pass, whose work follows the
// items and the groups' sums: three launches. (1) A block a tile, a warp a
// span, as above, but the warp's sums are kept in an open-addressing table
// of the bins its span holds (the lowest lane of a group of peers finds or
// claims the slot; the rounds add onto it as onto a row); the block then
// adds the 8 warps' tables, in warp order, into a table of the tile and
// writes the tile's bins whose sum is not 0 as a list, by range. (2) A
// block a (group, range of kRange bins): the range's part of the group's
// tiles' lists, staged in shared memory, in tile order onto the range there
// (a tile's list holds a bin once, so the threads of one tile never add
// onto the same bin), written as the group's sums. (3) A thread a bin: the groups' sums in order into the state.
// Skipping a tile or a span that holds no item of a bin skips an add of
// +0.0, so both passes give the same bits.
//
// What the dense pass costs against float atomics (PERF.md section 6 has
// the times): the table, written and read once (tiles x bins floats: 256 x
// 100 on a flagship record), the last blocks' sums (16 loads in flight a
// thread, sum_rows), and a match and its rounds a row of a warp. Every
// launch is a programmatic dependent (launch.cuh): its blocks wait for the
// kernel before it at their first device-memory access rather than behind
// a launch.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <type_traits>

#include "launch.cuh"

namespace ordered {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerSpan = 4;
constexpr int kSpanLanes = 32 * kRowsPerSpan;
constexpr int kTileLanes = kWarps * kSpanLanes;
constexpr int kGroups = 32;
// what a block's rows may take of an SM's 227 KB (1 KB a block is the
// system's), in floats, and so the bins a range covers
constexpr int kSmemPerSm = 227 * 1024;
constexpr int kRowFloats = (kSmemPerSm - 1024) / 4;
constexpr int kRange = kRowFloats / kWarps;

// the rounds that add_ranked takes for lanes whose group of peers (lanes
// that hold the same bin) is `peers`: the largest group of a lane with a
// bin; every lane of the warp calls it
__device__ __forceinline__ int rounds_of(unsigned peers, bool has_bin) {
  return static_cast<int>(__reduce_max_sync(kAll, has_bin ? static_cast<unsigned>(__popc(peers)) : 0u));
}

// lanes whose `bin` (in the range's row, -1 for none) is the same, `peers`,
// add their `v` onto row[bin] one after another in lane order: in round r
// the lane of rank r among its peers adds, so lanes of other bins add at
// once; every lane of the warp calls it with the same `rounds`
__device__ __forceinline__ void add_ranked(float* row, int bin, float v, unsigned peers, int rounds) {
  const int rank = __popc(peers & ((1u << (threadIdx.x & 31)) - 1u));
  for (int r = 0; r < rounds; ++r) {
    if (bin >= 0 && rank == r) row[bin] += v;
    __syncwarp();
  }
}

// the bin of `flat` in the range [lo, lo + width), or -1
__device__ __forceinline__ int in_range(int flat, int lo, int width) {
  const int b = flat - lo;
  return (flat >= 0 && b >= 0 && b < width) ? b : -1;
}

// What a Source adds its items onto: a warp's sums, `vals`, and where a
// flat bin's sum is. Each lane asks local(flat) (-1: not this
// accumulator's), then, with its peers (the lanes of the same local),
// slot(at, peers), the index into vals (-1 for none); every lane of the
// warp calls slot.
//
// A source whose lanes also have outputs of their own (a backward's
// gradient of each lane's inputs) writes them where owns_lanes() is true:
// in one block of each tile.
//
// Row: the dense pass's row of the range [lo, lo + width).
struct Row {
  float* vals;
  int lo, width;

  __device__ __forceinline__ int local(int flat) const { return in_range(flat, lo, width); }
  __device__ __forceinline__ int slot(int at, unsigned) const { return at; }
  __device__ __forceinline__ bool owns_lanes() const { return lo == 0; }
};

constexpr int kEmpty = -1;

// the slot of `key` (>= 0) in an open-addressing table of `cap` slots, which
// a thread claims if the key is not there yet (linear probing); the table
// holds fewer keys than slots
__device__ __forceinline__ int probe(int* keys, int cap, int key) {
  int h = static_cast<int>((static_cast<unsigned>(key) * 2654435761u) % static_cast<unsigned>(cap));
  while (true) {
    const int k = *reinterpret_cast<volatile int*>(keys + h);
    if (k == key) return h;
    if (k == kEmpty) {
      const int old = atomicCAS(keys + h, kEmpty, key);
      if (old == kEmpty || old == key) return h;
    }
    h = h + 1 == cap ? 0 : h + 1;
  }
}

// Table: the sparse pass's table of a warp's bins (keys kEmpty, vals +0.0
// at first); the lowest lane of the peers finds the slot for all of them.
struct Table {
  int* keys;
  float* vals;
  int cap;

  __device__ __forceinline__ int local(int flat) const { return flat >= 0 ? flat : -1; }
  __device__ __forceinline__ int slot(int at, unsigned peers) const {
    const int leader = __ffs(peers) - 1;
    int s = -1;
    if (at >= 0 && (threadIdx.x & 31) == leader) s = probe(keys, cap, at);
    return __shfl_sync(kAll, s, leader);
  }
  __device__ __forceinline__ bool owns_lanes() const { return true; }
};

// Nothing: no sums, for a source run for its lanes' own outputs alone
struct Nothing {
  float* vals;

  __device__ __forceinline__ int local(int) const { return -1; }
  __device__ __forceinline__ int slot(int, unsigned) const { return -1; }
  __device__ __forceinline__ bool owns_lanes() const { return true; }
};

// add_ranked for lanes whose peers are found by their local bin; every
// lane of the warp calls it
template <class Acc>
__device__ __forceinline__ void add_in_lane_order(const Acc& acc, int flat, float v) {
  const int at = acc.local(flat);
  if (!__any_sync(kAll, at >= 0)) return;
  const unsigned peers = __match_any_sync(kAll, at);
  add_ranked(acc.vals, acc.slot(at, peers), v, peers, rounds_of(peers, at >= 0));
}

// A batch's scratch: the tiles' sums (tiles x width floats, width the
// batch's bins) and the groups' sums (kGroups x width); and kCounters
// 64-bit counters a range, which are 0 between records (each record's last
// blocks set them back): a group's (its tiles that finished in the low
// half, those of them with a sum not 0 in the high half), then the
// record's (its groups that finished; in the high half a bit a group whose
// sums were written).
constexpr int kCounters = kGroups + 1;
// the most ranges of one launch (the counters the caller keeps)
constexpr int kMaxRanges = 64;

struct Scratch {
  float* tiles;
  float* groups;
  unsigned long long* counters;
};

// a counter's add with device-scope ordering: a release of what the block
// wrote before it and an acquire of what the blocks that added before
// released
__device__ __forceinline__ unsigned long long add_acq_rel(unsigned long long& counter, unsigned long long v) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(counter).fetch_add(
      v, cuda::memory_order_acq_rel);
}

__device__ __forceinline__ void reset(unsigned long long& counter) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(counter).store(0ull, cuda::memory_order_relaxed);
}

// The sums of a block's bins k < bins of `rows` rows of a table of row
// stride `stride` (a column a bin, from `col`), each added in row order from
// +0.0, rows whose bit of `mask` is clear left out (mask: rows up to 32;
// every row where `all`): kBins bins a thread at once, kRows rows of each a
// round (a row left out, or past the end, adds +0.0, which changes no sum's
// bits). out(k, sum) takes each bin's sum.
template <int kBins, int kRows, class Out>
__device__ __forceinline__ void sum_rows_by(const float* col, int rows, size_t stride, unsigned mask, bool all,
                                            int bins, Out out) {
  for (int k0 = threadIdx.x; k0 < bins; k0 += kBins * kThreads) {
    float s[kBins];
#pragma unroll
    for (int u = 0; u < kBins; ++u) s[u] = 0.0f;
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      float v[kBins][kRows];
#pragma unroll
      for (int u = 0; u < kBins; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int k = k0 + u * kThreads, row = r0 + r;
          const bool kept = k < bins && row < rows && (all || ((mask >> row) & 1u));
          v[u][r] = kept ? __ldcg(col + row * stride + k) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBins; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[u] += v[u][r];
      }
    }
#pragma unroll
    for (int u = 0; u < kBins; ++u) {
      if (k0 + u * kThreads < bins) out(k0 + u * kThreads, s[u]);
    }
  }
}

// ... a bin a thread with 16 rows a round where the block's threads cover
// the bins, else four bins a thread with 4 rows a round: a state of a
// thousand bins or more gave each thread several bins whose rounds of
// loads ran one after another (16 loads in flight: 32 raised the records'
// kernels to 128 registers)
template <class Out>
__device__ __forceinline__ void sum_rows(const float* col, int rows, size_t stride, unsigned mask, bool all, int bins,
                                         Out out) {
  if (bins <= kThreads) {
    sum_rows_by<1, 16>(col, rows, stride, mask, all, bins, out);
  } else {
    sum_rows_by<4, 4>(col, rows, stride, mask, all, bins, out);
  }
}

// The dense pass's blocks an SM the compiler keeps registers for (at most
// 51 a thread): the last blocks' sums need more registers than a tile's
// work, and without the bound they took the records' kernels from 40-48
// registers to 72-128 and slowed every record. A source whose own work
// needs more (the table reads' backward spilled under it, and its calls
// ran 5-10 % slower) names its own bound, kTileBlocks.
constexpr int kTileBlocks = 5;

template <class Source, class = void>
struct TileBlocks {
  static constexpr int value = kTileBlocks;
};
template <class Source>
struct TileBlocks<Source, std::void_t<decltype(Source::kTileBlocks)>> {
  static constexpr int value = Source::kTileBlocks;
};

// The dense pass: one record in one launch over (tile, range) blocks.
// Source::span(first, acc) adds the items of the span of lanes first ..
// first + kSpanLanes - 1 onto an accumulator (Row or Table) in the order
// above, through add_in_lane_order or add_ranked; every lane of the warp
// calls it.
// A block writes its tile's sums; the last block of a group to finish adds
// the group's tiles in order (where any of them had a sum not 0) and writes
// the group's sums; the last group to finish adds the written groups in
// order into the state. range0: the batch's first range; width: the
// batch's bins.
template <class Source>
__global__ void __launch_bounds__(kThreads, TileBlocks<Source>::value)
    record_tiles(Source src, int n_state, int range0, int width, int tiles, int group, Scratch scratch,
                 float* __restrict__ state) {
  extern __shared__ float rows[];
  __shared__ int last;
  __shared__ unsigned long long seen;
  const int range = blockIdx.y, lo = (range0 + range) * kRange;
  const int bins = min(kRange, n_state - lo), col = lo - range0 * kRange;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = rows + warp * bins;
  for (int k = lane; k < bins; k += 32) row[k] = 0.0f;
  __syncwarp();
  pdl::wait_for_previous();
  src.span(static_cast<long long>(blockIdx.x) * kTileLanes + warp * kSpanLanes, Row{row, lo, bins});
  __syncthreads();
  // the tile's sums: the spans in order; a group of one tile (a record of
  // up to kGroups tiles) writes them as its group's sums (+0.0 plus a sum,
  // which is never -0.0, is that sum)
  bool nonzero = false;
  float* out = (group == 1 ? scratch.groups : scratch.tiles) + static_cast<size_t>(blockIdx.x) * width + col;
  for (int k = threadIdx.x; k < bins; k += kThreads) {
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += rows[w * bins + k];
    out[k] = x;
    nonzero = nonzero || x != 0.0f;  // a NaN sum counts
  }
  nonzero = __syncthreads_or(nonzero);
  // the block's writes reach the other blocks through thread 0's release
  // (after the barrier) and their last block's acquire (before its barrier)
  unsigned long long* count = scratch.counters + range * kCounters;
  const int g = blockIdx.x / group, first = g * group, in_group = min(group, tiles - first);
  const int n_groups = (tiles + group - 1) / group;
  if (threadIdx.x == 0) {
    const unsigned long long mine = 1ull | (static_cast<unsigned long long>(nonzero) << 32);
    const unsigned long long old = add_acq_rel(count[g], mine);
    last = (old & 0xffffffffull) == static_cast<unsigned long long>(in_group - 1);
    seen = (old + mine) >> 32;
  }
  __syncthreads();
  if (!last) return;
  // the group's last block: its tiles' sums in order, where one was not 0
  const bool written = seen != 0;
  if (threadIdx.x == 0) reset(count[g]);
  if (written && group > 1) {
    float* sums = scratch.groups + static_cast<size_t>(g) * width + col;
    sum_rows(scratch.tiles + static_cast<size_t>(first) * width + col, in_group, width, 0u, true, bins,
             [&](int k, float x) { sums[k] = x; });
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long bit = static_cast<unsigned long long>(written) << (32 + g);
    const unsigned long long old = add_acq_rel(count[kGroups], 1ull | bit);
    last = (old & 0xffffffffull) == static_cast<unsigned long long>(n_groups - 1);
    seen = (old | bit) >> 32;
  }
  __syncthreads();
  if (!last) return;
  // the record's last group: the written groups' sums in order into the state
  const unsigned mask = static_cast<unsigned>(seen);
  if (threadIdx.x == 0) reset(count[kGroups]);
  if (mask == 0u) return;
  sum_rows(scratch.groups + col, kGroups, width, mask, false, bins, [&](int k, float total) {
    if (total != 0.0f) state[lo + k] += total;  // a NaN sum is added too
  });
}

// The sparse pass's scratch: each tile's list (bins and sums, list_cap
// slots a tile) by range of kRange bins, where each range starts in it
// (ranges + 1 a tile, the last its length), and the groups' sums (groups x
// n_state).
struct Lists {
  int* bins;
  float* vals;
  int* starts;
  float* groups;
};

// (1) a block a tile: the warps' tables of their spans, then the tile's
// table, then its list
template <class Source>
__global__ void __launch_bounds__(kThreads)
    sparse_tiles(Source src, int warp_cap, int tile_cap, int list_cap, int ranges, Lists out) {
  extern __shared__ int tables[];
  int* wkeys = tables;
  float* wvals = reinterpret_cast<float*>(wkeys + kWarps * warp_cap);
  int* tkeys = reinterpret_cast<int*>(wvals + kWarps * warp_cap);
  float* tvals = reinterpret_cast<float*>(tkeys + tile_cap);
  int* at = reinterpret_cast<int*>(tvals + tile_cap);  // ranges + 1
  for (int k = threadIdx.x; k < kWarps * warp_cap; k += kThreads) wkeys[k] = kEmpty, wvals[k] = 0.0f;
  for (int k = threadIdx.x; k < tile_cap; k += kThreads) tkeys[k] = kEmpty, tvals[k] = 0.0f;
  for (int r = threadIdx.x; r <= ranges; r += kThreads) at[r] = 0;
  __syncthreads();
  pdl::wait_for_previous();
  const int warp = threadIdx.x >> 5;
  src.span(static_cast<long long>(blockIdx.x) * kTileLanes + warp * kSpanLanes,
           Table{wkeys + warp * warp_cap, wvals + warp * warp_cap, warp_cap});
  __syncthreads();
  // the tile's sums: the spans' in span order (a warp's table holds a bin
  // once, so no two threads of a round add onto one slot)
  for (int w = 0; w < kWarps; ++w) {
    for (int k = threadIdx.x; k < warp_cap; k += kThreads) {
      const int key = wkeys[w * warp_cap + k];
      if (key != kEmpty) tvals[probe(tkeys, tile_cap, key)] += wvals[w * warp_cap + k];
    }
    __syncthreads();
  }
  // the list: the bins whose sum is not 0 (a NaN sum is listed too) by
  // range, in any order within a range. A pass counts the ranges' entries,
  // thread 0 turns the counts into starts, a second pass puts each entry at
  // its range's cursor; a warp's entries of one range take their places
  // with one atomic.
  int* bins = out.bins + static_cast<size_t>(blockIdx.x) * list_cap;
  float* vals = out.vals + static_cast<size_t>(blockIdx.x) * list_cap;
  const int lane = threadIdx.x & 31, rounds = (tile_cap + kThreads - 1) / kThreads;
  for (int pass = 0; pass < 2; ++pass) {
    for (int q = 0; q < rounds; ++q) {
      const int k = q * kThreads + threadIdx.x;
      const bool listed = k < tile_cap && tkeys[k] != kEmpty && !(tvals[k] == 0.0f);
      const int r = listed ? tkeys[k] / kRange : -1;
      const unsigned peers = __match_any_sync(kAll, r);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (listed && lane == leader) base = atomicAdd(at + r + 1 - pass, __popc(peers));
      base = __shfl_sync(kAll, base, leader);
      if (listed && pass == 1) {
        const int i = base + __popc(peers & ((1u << lane) - 1u));
        bins[i] = tkeys[k];
        vals[i] = tvals[k];
      }
    }
    __syncthreads();
    if (pass == 0) {
      if (threadIdx.x == 0) {
        for (int r = 1; r <= ranges; ++r) at[r] += at[r - 1];
      }
      __syncthreads();
      int* starts = out.starts + static_cast<size_t>(blockIdx.x) * (ranges + 1);
      for (int r = threadIdx.x; r <= ranges; r += kThreads) starts[r] = at[r];
      __syncthreads();
    }
  }
}

// (2) a block a (group, range of kRange bins): the range's segments of the
// group's tiles' lists in tile order onto the range, written as the group's
// sums of it. The segments are staged in shared memory a window of kStage
// entries at a time (eight loads in flight a thread), then added a tile at
// a time; so the chain of the group's tiles waits on shared memory, not on
// a load a tile.
// (kernels outside a template are static: every source that includes this
// header has its own)
constexpr int kGroupThreads = 512;
constexpr int kStage = 8192;
constexpr int kStageUnroll = 8;

// the tile of the group whose entries hold entry e: off[0 .. n] are the
// tiles' first entries, ascending, off[n] past e
__device__ __forceinline__ int tile_of(const int* off, int n, int e) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

static __global__ void __launch_bounds__(kGroupThreads)
    sparse_groups(Lists in, int list_cap, int tiles, int group, int n_state) {  // a block a (group, range)
  extern __shared__ int staged[];
  int* sbins = staged;
  float* svals = reinterpret_cast<float*>(sbins + kStage);
  float* acc = svals + kStage;
  int* off = reinterpret_cast<int*>(acc + kRange);  // group + 1
  int* seg = off + group + 1;                        // group
  const int g = blockIdx.x, range = blockIdx.y, lo = range * kRange, width = min(kRange, n_state - lo);
  const int ranges = (n_state + kRange - 1) / kRange;
  const int first = g * group, n_tiles = min(tiles, first + group) - first;
  for (int k = threadIdx.x; k < width; k += kGroupThreads) acc[k] = 0.0f;
  pdl::wait_for_previous();
  // the range's segment of each of the group's lists
  for (int j = threadIdx.x; j < n_tiles; j += kGroupThreads) {
    const int* starts = in.starts + static_cast<size_t>(first + j) * (ranges + 1) + range;
    seg[j] = __ldcg(starts);
    off[j + 1] = __ldcg(starts + 1) - seg[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int j = 0; j < n_tiles; ++j) off[j + 1] += off[j];
  }
  __syncthreads();
  const int total = off[n_tiles];
  for (int w0 = 0; w0 < total; w0 += kStage) {
    const int w1 = min(total, w0 + kStage);
    for (int base = w0 + threadIdx.x; base < w1; base += kGroupThreads * kStageUnroll) {
      int b[kStageUnroll];
      float v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = base + u * kGroupThreads;
        if (e < w1) {
          const int j = tile_of(off, n_tiles, e);
          const size_t at = static_cast<size_t>(first + j) * list_cap + seg[j] + (e - off[j]);
          b[u] = __ldcg(in.bins + at);
          v[u] = __ldcg(in.vals + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = base + u * kGroupThreads;
        if (e < w1) sbins[e - w0] = b[u], svals[e - w0] = v[u];
      }
    }
    __syncthreads();
    // the window's tiles in order (a tile's list holds a bin once)
    for (int j = tile_of(off, n_tiles, w0); j < n_tiles && off[j] < w1; ++j) {
      const int e1 = min(off[j + 1], w1);
      for (int e = max(off[j], w0) + threadIdx.x; e < e1; e += kGroupThreads) {
        const int k = sbins[e - w0] - lo;
        if (k >= 0 && k < width) acc[k] += svals[e - w0];
      }
      __syncthreads();
    }
  }
  float* out = in.groups + static_cast<size_t>(g) * n_state + lo;
  for (int k = threadIdx.x; k < width; k += kGroupThreads) out[k] = acc[k];
}

// (3) a thread a bin: the groups' sums in order into the state
static __global__ void __launch_bounds__(kThreads)
    sparse_state(const float* __restrict__ groups, int n_groups, int n_state, float* __restrict__ state) {
  pdl::wait_for_previous();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_state) return;
  float total = 0.0f;
  for (int g = 0; g < n_groups; ++g) total += __ldcg(groups + static_cast<size_t>(g) * n_state + b);
  if (total != 0.0f) state[b] += total;  // a NaN sum is added too
}

// The sparse pass's sizes for a record of `tiles` tiles whose lanes hold up
// to `slots` items each, on n_state flat bins: a table's slots are its
// most bins and a quarter more; response._record_table repeats them.
struct SparseSize {
  int warp_cap, tile_cap, list_cap, groups, ranges;
  long long smem, group_smem, words;
};

inline SparseSize sparse_size(int tiles, int slots, int n_state) {
  const auto cap = [&](long long items) {
    const long long bins = items < n_state ? items : n_state;
    return static_cast<int>(bins + bins / 4 + 1);
  };
  SparseSize z{};
  z.warp_cap = cap(static_cast<long long>(kSpanLanes) * slots);
  z.tile_cap = cap(static_cast<long long>(kTileLanes) * slots);
  z.list_cap = min(kTileLanes * slots, n_state);
  const int group = (tiles + kGroups - 1) / kGroups;
  z.groups = (tiles + group - 1) / group;
  z.ranges = (n_state + kRange - 1) / kRange;
  z.smem = 8LL * (kWarps * z.warp_cap + z.tile_cap) + 4LL * (z.ranges + 1);
  z.group_smem = 4LL * (2 * kStage + kRange + 2 * group + 1);
  z.words = 2LL * tiles * z.list_cap + static_cast<long long>(tiles) * (z.ranges + 1) +
            static_cast<long long>(z.groups) * n_state;
  return z;
}

// The dense pass's cost follows tiles x bins, the sparse pass's the items
// and groups x bins: measured on 524,288 lanes, the dense pass at 1,000
// bins took less time than the sparse pass's three launches, at 4,000
// more (PERF.md section 6). So a record past kDenseCells tiles x bins takes
// the sparse pass, where its tables fit a block's shared memory.
constexpr long long kDenseCells = 1 << 19;

inline bool sparse(int tiles, int slots, int n_state) {
  const SparseSize z = sparse_size(tiles, slots, n_state);
  return static_cast<long long>(tiles) * n_state > kDenseCells && z.smem <= 4LL * kRowFloats &&
         z.group_smem <= 4LL * kRowFloats;
}

template <class Source>
cudaError_t record_sparse(const Source& src, int tiles, int slots, int n_state, float* table, long long table_floats,
                          float* state, cudaStream_t stream) {
  const SparseSize z = sparse_size(tiles, slots, n_state);
  if (table_floats < z.words) return cudaErrorInvalidValue;
  int* bins = reinterpret_cast<int*>(table);
  float* vals = table + static_cast<size_t>(tiles) * z.list_cap;
  int* starts = reinterpret_cast<int*>(vals + static_cast<size_t>(tiles) * z.list_cap);
  const Lists lists{bins, vals, starts, reinterpret_cast<float*>(starts + static_cast<size_t>(tiles) * (z.ranges + 1))};
  const int smem = static_cast<int>(z.smem);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sparse_tiles<Source>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  err = pdl::launch(sparse_tiles<Source>, dim3(tiles), dim3(kThreads), smem, stream, src, z.warp_cap, z.tile_cap,
                    z.list_cap, z.ranges, lists);
  if (err != cudaSuccess) return err;
  const int group = (tiles + kGroups - 1) / kGroups, group_smem = static_cast<int>(z.group_smem);
  if (group_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sparse_groups, cudaFuncAttributeMaxDynamicSharedMemorySize, group_smem);
    if (err != cudaSuccess) return err;
  }
  err = pdl::launch(sparse_groups, dim3(z.groups, z.ranges), dim3(kGroupThreads), group_smem,
                    stream, lists, z.list_cap, tiles, group, n_state);
  if (err != cudaSuccess) return err;
  err = pdl::launch(sparse_state, dim3((n_state + kThreads - 1) / kThreads), dim3(kThreads), 0, stream,
                    static_cast<const float*>(lists.groups), z.groups, n_state, state);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A source's lanes alone (no sums): a block a tile, a warp a span.
template <class Source>
__global__ void __launch_bounds__(kThreads) lanes_only(Source src) {
  src.span(static_cast<long long>(blockIdx.x) * kTileLanes + (threadIdx.x >> 5) * kSpanLanes, Nothing{nullptr});
}

template <class Source>
cudaError_t lanes(const Source& src, int n, cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
  lanes_only<Source><<<(n + kTileLanes - 1) / kTileLanes, kThreads, 0, stream>>>(src);
  return cudaGetLastError();
}

// The floats of scratch a batch of `width` bins takes with `tiles` tiles.
inline long long scratch_floats(int tiles, int width) {
  return (static_cast<long long>(tiles) + kGroups) * width;
}

// The bins of one batch: all of them, or whole ranges, as many as the
// caller's scratch of table_floats floats and the counters take (0 if not
// one range fits); response._record_batch repeats it.
inline int batch_bins(int tiles, int n_state, long long table_floats) {
  int width = min(n_state, kMaxRanges * kRange);
  while (width > 0 && scratch_floats(tiles, width) > table_floats) {
    width = ((width + kRange - 1) / kRange - 1) * kRange;
  }
  return width;
}

// A record of n lanes, up to `slots` items a lane, on a state of n_state
// flat bins, with the caller's scratch of table_floats floats and its
// kMaxRanges x kCounters counters (which the dense pass keeps).
template <class Source>
cudaError_t record(const Source& src, int n, int slots, int n_state, float* table, long long table_floats,
                   unsigned long long* counters, float* state, cudaStream_t stream) {
  if (n <= 0 || n_state <= 0) return cudaGetLastError();
  const int tiles = (n + kTileLanes - 1) / kTileLanes;
  if (sparse(tiles, slots, n_state)) {
    return record_sparse(src, tiles, slots, n_state, table, table_floats, state, stream);
  }
  const int group = (tiles + kGroups - 1) / kGroups;
  const int batch = batch_bins(tiles, n_state, table_floats);
  if (batch <= 0) return cudaErrorInvalidValue;
  const int smem = kWarps * min(n_state, kRange) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(record_tiles<Source>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  for (int b0 = 0; b0 < n_state; b0 += batch) {
    const int width = min(batch, n_state - b0);
    const Scratch scratch{table, table + static_cast<size_t>(tiles) * width, counters};
    const dim3 grid(tiles, (width + kRange - 1) / kRange);
    const cudaError_t err = pdl::launch(record_tiles<Source>, grid, dim3(kThreads), smem, stream, src, n_state,
                                        b0 / kRange, width, tiles, group, scratch, state);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace ordered
