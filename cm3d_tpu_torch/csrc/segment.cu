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
// Bound on the H100: memory bytes (an add a word). The forward reads the ids,
// the values of the elements with a real id (the sink's are never read: the
// callers' sink id is h*w = n_cells, and at the training path's identity
// extrinsics the sink holds about 96% of the splat's elements), and writes
// the outputs once. The calls are small (a batch-8 pillarize moves 7 MB), so
// the chain of dependent loads a block waits on decides the time as much as
// the bytes do; and their runs are lopsided: a pillar holds a few points, a
// cell near a camera hundreds of rays, and most cells of a grid can be
// empty (at identity extrinsics the output is the bulk of the bytes).
//
// Design: one kernel, grid (tiles of 256 cells, chunks of 8 channels, rows);
// the last chunk also takes the max.
//   - two warps find the block's elements [lo, hi), the runs of its cells,
//     with 32-way searches (32 probes a step: 4 dependent loads over 82944
//     ids), and the block stages those ids in shared memory, where each
//     thread finds its cell's run by a binary search;
//   - a run of at most 16 elements, or none, is summed by its cell's thread
//     in index order, and neighbouring threads store to neighbouring cells
//     (coalesced; an empty cell gets 0 and -inf);
//   - a longer run goes to a list that the block's warps share: a warp sums
//     it lane-strided in index order, then in a fixed shuffle tree, so a
//     long run takes a warp, not one thread, and 8 go at once.
// Every sum has one order of additions, fixed by the ids alone, and there
// are no float atomics, so a call replays bit for bit (the one atomic lists
// a block's long runs, whose order no sum depends on).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = kThreads;  // cells of a block, one a thread
constexpr int kChan = 8;          // channels of a block
constexpr int kIdsCap = 4096;     // ids a block stages in shared memory
constexpr int kSerial = 16;       // a longer run is summed by a warp
constexpr int kChunk = 8;         // channels a thread of the backward

// First index i of ids[lo .. hi) with ids[i] >= key (ids non-decreasing).
__device__ __forceinline__ int lower_bound(const int32_t* ids, int lo, int hi, int key) {
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

// The same over ids[0 .. n), by the 32 lanes of a warp: 32 probes a step,
// so 82944 ids take 4 dependent loads. Every lane returns the index.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ ids, int n,
                                                int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the index lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const int m = __popc(__ballot_sync(0xffffffffu, q < hi && ids[q] < key));
    if (m == 0) return lo;
    const int next_hi = lo + m * step;
    lo += (m - 1) * step + 1;
    hi = min(hi, next_hi);
  }
  const int q = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, q < hi && ids[q] < key));
}

template <bool kHasMax>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const int32_t* __restrict__ cell, const float* __restrict__ values,
               const float* __restrict__ maxvals, float* __restrict__ sums,
               float* __restrict__ maxs, int N, int D, int n_cells) {
  __shared__ int s_ids[kIdsCap];
  __shared__ int s_start[kCells + 1];
  __shared__ int s_range[2];
  __shared__ int s_long[kCells];  // the block's cells with a long run
  __shared__ int s_n_long;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kCells;
  const int c1 = min(c0 + kCells, n_cells);
  const int d0 = blockIdx.y * kChan;
  const int nch = min(kChan, D - d0);
  const bool with_max = kHasMax && blockIdx.y == gridDim.y - 1;
  const long long r = blockIdx.z;
  const int32_t* ids = cell + r * N;
  const float* v = values + (r * D + d0) * N;
  const float* mv = kHasMax ? maxvals + r * N : nullptr;

  // the block's elements [lo, hi): the runs of cells [c0, c1)
  if (warp < 2) {
    const int at = warp_lower_bound(ids, N, warp ? c1 : c0);
    if (lane == 0) s_range[warp] = at;
  }
  if (tid == 0) s_n_long = 0;
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  const int c = c0 + tid;
  int start;
  if (hi - lo <= kIdsCap) {
    for (int j = tid; j < hi - lo; j += kThreads) s_ids[j] = ids[lo + j];
    __syncthreads();
    start = lo + lower_bound(s_ids, 0, hi - lo, c);
  } else {
    start = lower_bound(ids, lo, hi, c);
  }
  s_start[tid] = start;  // a thread past c1 finds hi
  if (tid == 0) s_start[kCells] = hi;
  __syncthreads();
  const int end = s_start[tid + 1];

  // a short run (or none: 0 and -inf) by its cell's thread, in index order;
  // the threads' stores to neighbouring cells are coalesced
  float* out = sums + (r * D + d0) * n_cells + c;
  if (c < c1 && end - start <= kSerial) {
    float acc[kChan] = {};
    float m = -CUDART_INF_F;
#pragma unroll 4
    for (int i = start; i < end; ++i) {
#pragma unroll
      for (int ch = 0; ch < kChan; ++ch) {
        if (ch < nch) acc[ch] += v[ch * (long long)N + i];
      }
      if (with_max) m = fmaxf(m, mv[i]);
    }
#pragma unroll
    for (int ch = 0; ch < kChan; ++ch) {
      if (ch < nch) out[ch * (long long)n_cells] = acc[ch];
    }
    if (with_max) maxs[r * n_cells + c] = m;
  } else if (c < c1) {  // the list's order varies from launch to launch; no sum depends on it
    s_long[atomicAdd(&s_n_long, 1)] = tid;
  }
  __syncthreads();

  // a long run by a warp: lane-strided in index order, then a fixed tree
  for (int k = warp; k < s_n_long; k += kWarps) {
    const int t = s_long[k];
    float acc[kChan] = {};
    float m = -CUDART_INF_F;
    const int run_end = s_start[t + 1];
#pragma unroll 4
    for (int i = s_start[t] + lane; i < run_end; i += 32) {
#pragma unroll
      for (int ch = 0; ch < kChan; ++ch) {
        if (ch < nch) acc[ch] += v[ch * (long long)N + i];
      }
      if (with_max) m = fmaxf(m, mv[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int ch = 0; ch < kChan; ++ch) acc[ch] += __shfl_xor_sync(0xffffffffu, acc[ch], off);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) {
      float* o = sums + (r * D + d0) * n_cells + c0 + t;
      for (int ch = 0; ch < nch; ++ch) o[ch * (long long)n_cells] = acc[ch];
      if (with_max) maxs[r * n_cells + c0 + t] = m;
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

template <bool kHasMax>
int launch_forward(const void* cell, const void* values, const void* maxvals, void* sums,
                   void* maxs, int R, int N, int D, int n_cells, void* stream) {
  const dim3 grid((n_cells + kCells - 1) / kCells, (D + kChan - 1) / kChan, R);
  segment_kernel<kHasMax><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), static_cast<const float*>(values),
      static_cast<const float*>(maxvals), static_cast<float*>(sums), static_cast<float*>(maxs),
      N, D, n_cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cell [R, N] int32 non-decreasing per row, values [R, D, N] f32, maxvals
// [R, N] f32 -> sums [R, D, n_cells] f32, maxs [R, n_cells] f32, all
// contiguous on the device; D >= 1, R and ceil(D / 8) at most 65535.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int segment_sum_max_launch(const void* cell, const void* values, const void* maxvals,
                                      void* sums, void* maxs, int R, int N, int D, int n_cells,
                                      void* stream) {
  return launch_forward<true>(cell, values, maxvals, sums, maxs, R, N, D, n_cells, stream);
}

// The sum-only variant: no max stream is read or written.
extern "C" int segment_sum_launch(const void* cell, const void* values, void* sums, int R, int N,
                                  int D, int n_cells, void* stream) {
  return launch_forward<false>(cell, values, nullptr, sums, nullptr, R, N, D, n_cells, stream);
}

// The sum's backward: g [R, D, n_cells] f32 -> dvalues [R, D, N] f32; R and
// ceil(D / 8) at most 65535.
extern "C" int segment_sum_bwd_launch(const void* cell, const void* g, void* dvalues, int R,
                                      int N, int D, int n_cells, void* stream) {
  segment_sum_bwd_kernel<<<grid_for(N, D, R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cell), static_cast<const float*>(g),
      static_cast<float*>(dvalues), N, D, n_cells);
  return static_cast<int>(cudaGetLastError());
}
