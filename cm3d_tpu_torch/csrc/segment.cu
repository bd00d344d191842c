// Segment sum (+ max) over SORTED cell ids (sm_90a): pillar voxelization and
// the lift-splat BEV pooling of the training path.
//
// Replaces the TPU kernels cm3d_tpu/kernels/segment_pallas.py
// segment_sum_max_pallas and segment_sum_pallas (_segment_kernel, with and
// without has_max), which computed the per-cell reduction as tiled one-hot
// matmuls `values @ (cell == l)` on the MXU, with a 3-way bf16 split of every
// value inside the kernel, prefetched chunk ranges and 128-aligned padding.
// None of that carries over: here a cell's elements are simply added up.
//
//   sums[r, d, c] = sum of values[r, d, i]  over i with cell[r, i] == c
//   maxs[r, c]    = max of maxvals[r, i]    over the same i   (empty -> -inf)
//
// for c in [0, n_cells). cell[r, :] is NON-DECREASING, so the elements of a
// cell are one contiguous run of its row; ids >= n_cells (the sink) sort to
// the end and match no output column. Empty cells come out as exactly 0 and
// -inf; every output element is written, nothing relies on a zeroed buffer.
//
// The backward of the sum (segment_sum_bwd) is the transpose of a sum over
// fixed cells, a gather: dvalues[r, d, i] = g[r, d, cell[r, i]], and 0 for
// sink ids.
//
// Bound on the H100: memory bytes (an add a word). The work reads the ids and
// the values once and writes the outputs once: 10 MB for a batch-8 pillarize
// (R 8, N 32768, D 5 + max, 16385 cells), 104 MB for the batch-8 camera splat
// (R 8, N 82944, D 32), about 3 us and 31 us at 3.35 TB/s.
//
// Design (right and simple, no float atomics): one thread per (row, cell,
// chunk of 8 channels). The thread finds its cell's run with two binary
// searches over the row's ids (17 steps each at N = 82944, all in L2 after
// the first warps). A run of at most 64 elements it walks alone, in index
// order, once per channel: neighbouring threads own neighbouring cells, whose
// runs are neighbouring spans of each channel's row, so a warp's loads land in
// a few sectors, and its stores to sums[r, d, c .. c + 31] are coalesced. A
// longer run is summed by the whole block: thread t adds elements t, t + 256,
// ... in index order, then the 256 partial sums meet in a fixed tree (warp
// shuffles, then the 8 warps' sums in order). That case is not rare: both
// callers give the sink the id n_cells - 1, a real column that they cut off
// afterwards, and on the splat of a camera ring most rays leave the grid, so
// one column of a row can hold tens of thousands of elements. Every sum has
// one fixed order of additions, which depends on the ids alone, so a run
// replays bit for bit, which atomicAdd on floats would not give (the one
// atomic here counts a block's long runs in shared memory, an integer).
// Weak spots, for later work: a warp waits for its longest short run; each
// channel chunk repeats the searches; the [R, D, N] layout makes a thread's
// D loads D separate streams.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;     // channels summed by one thread
constexpr int kLongRun = 64;  // a longer run is summed by the whole block

// First index i of ids[lo .. n) with ids[i] >= key (ids non-decreasing).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ ids, int lo, int n,
                                           int key) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sum (or maximum) of one value per thread over the block, in a fixed tree;
// every thread of the block calls it and gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, v, offset);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  __syncthreads();  // the previous call's readers are done with scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = scratch[0];
  for (int w = 1; w < kWarps; ++w) total = kMax ? fmaxf(total, scratch[w]) : total + scratch[w];
  return total;
}

template <bool kHasMax>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const int32_t* __restrict__ cell, const float* __restrict__ values,
               const float* __restrict__ maxvals, float* __restrict__ sums,
               float* __restrict__ maxs, int N, int D, int n_cells) {
  __shared__ int s_owner[kThreads], s_start[kThreads], s_end[kThreads];
  __shared__ int s_long;
  __shared__ float s_scratch[kWarps];

  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < n_cells;
  const long long r = blockIdx.z;
  const int32_t* ids = cell + r * N;
  int start = 0, end = 0;
  if (live) {
    start = lower_bound(ids, 0, N, c);
    end = lower_bound(ids, start, N, c + 1);
  }
  if (tid == 0) s_long = 0;
  __syncthreads();
  const bool is_long = end - start > kLongRun;
  if (is_long) {  // the list's order varies from launch to launch; no sum depends on it
    const int k = atomicAdd(&s_long, 1);
    s_owner[k] = tid;
    s_start[k] = start;
    s_end[k] = end;
  }
  __syncthreads();
  const int n_long = s_long;

  const int d0 = blockIdx.y * kChunk;
  const int d1 = d0 + kChunk < D ? d0 + kChunk : D;
  const bool with_max = kHasMax && blockIdx.y == 0;
  if (live && !is_long) {
    for (int d = d0; d < d1; ++d) {
      const float* v = values + (r * D + d) * N;
      float acc = 0.0f;
      for (int i = start; i < end; ++i) acc += v[i];
      sums[(r * D + d) * n_cells + c] = acc;
    }
    if (with_max) {
      const float* mv = maxvals + r * N;
      float m = -CUDART_INF_F;
      for (int i = start; i < end; ++i) m = fmaxf(m, mv[i]);
      maxs[r * n_cells + c] = m;
    }
  }
  for (int k = 0; k < n_long; ++k) {  // n_long is the same in every thread
    const int owner = s_owner[k], lo = s_start[k], hi = s_end[k];
    for (int d = d0; d < d1; ++d) {
      const float* v = values + (r * D + d) * N;
      float acc = 0.0f;
      for (int i = lo + tid; i < hi; i += kThreads) acc += v[i];
      const float total = block_reduce<false>(acc, s_scratch);
      if (tid == owner) sums[(r * D + d) * n_cells + c] = total;
    }
    if (with_max) {
      const float* mv = maxvals + r * N;
      float m = -CUDART_INF_F;
      for (int i = lo + tid; i < hi; i += kThreads) m = fmaxf(m, mv[i]);
      const float total = block_reduce<true>(m, s_scratch);
      if (tid == owner) maxs[r * n_cells + c] = total;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_bwd_kernel(const int32_t* __restrict__ cell, const float* __restrict__ g,
                       float* __restrict__ dvalues, int N, int D, int n_cells) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const long long r = blockIdx.z;
  const int c = cell[r * N + i];
  const bool real = static_cast<unsigned>(c) < static_cast<unsigned>(n_cells);
  const int d0 = blockIdx.y * kChunk;
  const int d1 = d0 + kChunk < D ? d0 + kChunk : D;
  for (int d = d0; d < d1; ++d) {
    dvalues[(r * D + d) * N + i] = real ? g[(r * D + d) * n_cells + c] : 0.0f;
  }
}

dim3 grid_for(int width, int D, int R) {
  return dim3((width + kThreads - 1) / kThreads, (D + kChunk - 1) / kChunk, R);
}

}  // namespace

// cell [R, N] int32 non-decreasing per row, values [R, D, N] f32, maxvals
// [R, N] f32 -> sums [R, D, n_cells] f32, maxs [R, n_cells] f32, all
// contiguous on the device; R and ceil(D / 8) at most 65535. Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int segment_sum_max_launch(const void* cell, const void* values, const void* maxvals,
                                      void* sums, void* maxs, int R, int N, int D, int n_cells,
                                      void* stream) {
  segment_kernel<true><<<grid_for(n_cells, D, R), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), static_cast<const float*>(values),
      static_cast<const float*>(maxvals), static_cast<float*>(sums), static_cast<float*>(maxs),
      N, D, n_cells);
  return static_cast<int>(cudaGetLastError());
}

// The sum-only variant: no max stream is read or written.
extern "C" int segment_sum_launch(const void* cell, const void* values, void* sums, int R, int N,
                                  int D, int n_cells, void* stream) {
  segment_kernel<false><<<grid_for(n_cells, D, R), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), static_cast<const float*>(values), nullptr,
      static_cast<float*>(sums), nullptr, N, D, n_cells);
  return static_cast<int>(cudaGetLastError());
}

// The sum's backward: g [R, D, n_cells] f32 -> dvalues [R, D, N] f32.
extern "C" int segment_sum_bwd_launch(const void* cell, const void* g, void* dvalues, int R,
                                      int N, int D, int n_cells, void* stream) {
  segment_sum_bwd_kernel<<<grid_for(N, D, R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), static_cast<const float*>(g),
      static_cast<float*>(dvalues), N, D, n_cells);
  return static_cast<int>(cudaGetLastError());
}
