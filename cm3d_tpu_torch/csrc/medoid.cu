// Masked pairwise-distance sums, the medoid's inner loop (sm_90a).
//
// Replaces the TPU kernel cm3d_tpu/kernels/medoid_pallas.py
// (medoid_distance_sums_rows_pallas / _medoid_sums_kernel):
//
//   out[r, i] = sum_{j < count_r} valid[r, j] * ||p_i - p_j||     (i < K)
//
// with exact per-dimension f32 differences (never |a|^2 + |b|^2 - 2ab,
// which cancels catastrophically at global-frame coordinates ~1e3 m).
// Precondition, as on the TPU: each row's valid points come first
// (count_r = number of valid points); out[r, i] = 0 for i >= count_r, and
// the caller masks those.
//
// Bound on the H100: f32 operations. d(i, j) and d(j, i) are the same bits
// (the differences negate exactly, their squares are equal), so the
// function needs each unordered pair once: 3 sub, 3 mul, 2 add and a sqrt,
// then one add into each of the two sums, over (sum_r count_r^2 -
// count_r) / 2 pairs; the bytes are only 17 per point. The file is compiled
// with -fmad=false and without fast math, so each distance rounds exactly
// like the plain PyTorch version ((dx*dx + dy*dy) + dz*dz, correctly
// rounded sqrtf); only the order of the summation differs.
//
// Design: four kernels behind one launcher call.
//  1. medoid_count_kernel: each row's count of valid points, a warp a row;
//     medoid_plan_kernel (one block): per row nt = ceil(count / 128) tiles
//     and nt (nt + 1) / 2 tile pairs (a <= b); their prefix over the rows.
//  2. medoid_pairs_kernel: a persistent grid (blocks an SM by occupancy)
//     over the live tile pairs of all rows, so no block is launched past a
//     count: a block takes a contiguous range of them and walks it with a
//     cursor (one search for its first pair), loading the next pair's
//     points into registers while it computes the current one. A pair's two
//     tiles sit in shared memory as {x, y, z, weight}
//     (weight 1 for a valid point before the count, else 0); 16 x 16
//     threads each hold 8 points of tile a in registers and read 8 points
//     of tile b as one 16-byte load each: 64 distances a thread, 1/8 of a
//     shared load a pair. Each distance is added to i's row sum and to j's
//     column sum; the row sums are reduced across the 16 threads of a
//     half-warp by a fixed butterfly, the column sums across the half-warps
//     and warps in a fixed order, and written as the partial sums
//     part[r, b, i] and part[r, a, j] (a diagonal pair a == b computes the
//     pairs j > i of its tile and adds a point's two sums into part[r, a, i]).
//     A pair whose tiles hold a zero weight takes the masked loop, which
//     skips the points past the count and multiplies by the weights; the
//     others do neither.
//  3. medoid_reduce_kernel: out[r, i] = sum_s part[r, s, i] over the row's
//     tiles s in order.
// No f32 atomics: every sum has one order, so a call gives the same bits on
// every run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // points a tile
constexpr int kThreads = 256;  // 16 x 16 over a tile pair
constexpr int kPer = 8;        // points of each tile a thread holds
constexpr int kPlanThreads = 1024;

// counts[r] = number of valid points of row r, a warp a row
__global__ void __launch_bounds__(kThreads)
medoid_count_kernel(const uint8_t* __restrict__ valid, int32_t* __restrict__ counts, int R,
                    int K) {
  const int r = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (r >= R) return;
  const uint8_t* v = valid + static_cast<long long>(r) * K;
  int c = 0;
  for (int i = lane; i < K; i += 32) c += v[i] != 0;
  for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
  if (lane == 0) counts[r] = c;
}

// off[r] = sum_{r' < r} nt_r' (nt_r' + 1) / 2, off[R] = the total
__global__ void __launch_bounds__(kPlanThreads)
medoid_plan_kernel(const int32_t* __restrict__ counts, int32_t* __restrict__ off, int R) {
  __shared__ int32_t warp_total[kPlanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int base = 0; base < R; base += kPlanThreads) {
    const int r = base + threadIdx.x;
    const int nt = r < R ? (counts[r] + kTile - 1) / kTile : 0;
    const int own = nt * (nt + 1) / 2;
    int v = own;  // inclusive scan over the warp, then over the warps' totals
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane == 31) warp_total[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = warp_total[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_total[lane] = w;
    }
    __syncthreads();
    const int incl = carry + (warp ? warp_total[warp - 1] : 0) + v;
    if (r < R) off[r] = incl - own;
    __syncthreads();
    if (threadIdx.x == kPlanThreads - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) off[R] = carry;
}

// The 8 x 8 distances of one thread: i = its tile-a points ti + 16 k
// (registers), j = tile b's points tj + 16 l. row[k] += d(i_k, j_l) over l,
// col[l] = sum over k. kMask: weights multiply, points past the count (ni,
// nj in the tiles) skipped. kDiag (a == b): only the pairs with j > i.
template <bool kMask, bool kDiag>
__device__ __forceinline__ void pair_block(const float4* __restrict__ pb, int tj, int ti, int ni,
                                           int nj, const float (&xi)[kPer],
                                           const float (&yi)[kPer], const float (&zi)[kPer],
                                           const float (&wi)[kPer], float (&row)[kPer],
                                           float (&col)[kPer]) {
#pragma unroll
  for (int l = 0; l < kPer; ++l) {
    float c = 0.0f;
    if (!kMask || tj + 16 * l < nj) {
      const float4 pj = pb[tj + 16 * l];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (kDiag && k > l) continue;  // i > j
        if ((!kMask || ti + 16 * k < ni) && (!kDiag || k < l || tj > ti)) {
          const float dx = xi[k] - pj.x;
          const float dy = yi[k] - pj.y;
          const float dz = zi[k] - pj.z;
          const float d = sqrtf(dx * dx + dy * dy + dz * dz);
          row[k] += kMask ? d * pj.w : d;
          c += kMask ? d * wi[k] : d;
        }
      }
    }
    col[l] = c;
  }
}

// A block's place in the tile pairs of all rows: row r (count, nt tiles),
// pair (a, b) with a <= b, numbered b (b + 1) / 2 + a inside the row
struct Cursor {
  int r, count, nt, a, b;
};

__device__ __forceinline__ void set_row(Cursor& c, const int32_t* __restrict__ counts, int r) {
  c.r = r;
  c.count = counts[r];
  c.nt = (c.count + kTile - 1) / kTile;
}

// the next pair: a, then b, then the next row that has points
__device__ __forceinline__ void advance(Cursor& c, const int32_t* __restrict__ counts) {
  if (++c.a <= c.b) return;
  c.a = 0;
  if (++c.b < c.nt) return;
  c.b = 0;
  do set_row(c, counts, c.r + 1);
  while (c.nt == 0);
}

// this thread's point of the pair's tiles as {x, y, z, weight}: tile a for
// threads below kTile, tile b above
__device__ __forceinline__ float4 load_point(const Cursor& c, const float* __restrict__ rows,
                                             const uint8_t* __restrict__ valid, int K) {
  const int pt = (threadIdx.x < kTile ? c.a * kTile : c.b * kTile - kTile) + threadIdx.x;
  if (pt >= c.count) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* X = rows + static_cast<long long>(c.r) * 3 * K + pt;
  return make_float4(X[0], X[K], X[2 * K],
                     valid[static_cast<long long>(c.r) * K + pt] ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads, 3)
medoid_pairs_kernel(const float* __restrict__ rows, const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ counts, const int32_t* __restrict__ off,
                    float* __restrict__ part, int R, int K, int T) {
  __shared__ float4 pa[kTile], pb[kTile];
  __shared__ float cbuf[kThreads / 32][kTile];
  __shared__ float rbuf[kTile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ti = tid >> 4, tj = tid & 15;  // lane = 16 (ti % 2) + tj
  // a contiguous range of the pairs, so a block walks them with a cursor
  const long long total = off[R];
  const int begin = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  Cursor cur;
  {  // the row of `begin`: the last r with off[r] <= begin
    int lo = 0, hi = R - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= begin) lo = mid;
      else hi = mid - 1;
    }
    set_row(cur, counts, lo);
    const int q = begin - off[lo];
    int b = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
    while (b * (b + 1) / 2 > q) --b;
    while ((b + 1) * (b + 2) / 2 <= q) ++b;
    cur.b = b;
    cur.a = q - b * (b + 1) / 2;
  }
  float4 v = load_point(cur, rows, valid, K);
  for (int task = begin; task < end; ++task) {
    const Cursor now = cur;
    const int r = now.r, a = now.a, b = now.b, count = now.count;
    const int i0 = a * kTile, j0 = b * kTile;
    (tid < kTile ? pa : pb)[tid & (kTile - 1)] = v;
    const bool masked = __syncthreads_or(v.w == 0.0f);
    if (task + 1 < end) {  // the next pair's point, in flight during this one
      advance(cur, counts);
      v = load_point(cur, rows, valid, K);
    }

    float xi[kPer], yi[kPer], zi[kPer], wi[kPer], row[kPer], col[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float4 p = pa[ti + 16 * k];
      xi[k] = p.x;
      yi[k] = p.y;
      zi[k] = p.z;
      wi[k] = p.w;
      row[k] = 0.0f;
    }
    const bool diag = a == b;
    if (masked && diag)
      pair_block<true, true>(pb, tj, ti, count - i0, count - j0, xi, yi, zi, wi, row, col);
    else if (masked)
      pair_block<true, false>(pb, tj, ti, count - i0, count - j0, xi, yi, zi, wi, row, col);
    else if (diag)
      pair_block<false, true>(pb, tj, ti, kTile, kTile, xi, yi, zi, wi, row, col);
    else
      pair_block<false, false>(pb, tj, ti, kTile, kTile, xi, yi, zi, wi, row, col);

    // row sums of tile a's points: across the half-warp's 16 tj; lane tj < 8
    // holds point ti + 16 tj's
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int d = 8; d; d >>= 1) row[k] += __shfl_xor_sync(0xffffffffu, row[k], d);
    float mine = row[0];
#pragma unroll
    for (int k = 1; k < kPer; ++k)
      if (tj == k) mine = row[k];
    const int pi = ti + 16 * tj;
    if (tj < kPer) {
      if (diag) rbuf[pi] = mine;
      else if (i0 + pi < count) part[(static_cast<long long>(r) * T + b) * K + i0 + pi] = mine;
    }

    // column sums of tile b's points: the two half-warps, then the warps in
    // order; a diagonal pair adds them to the row sums of the same points
    // (the pairs j > i, then i < j)
#pragma unroll
    for (int l = 0; l < kPer; ++l) col[l] += __shfl_xor_sync(0xffffffffu, col[l], 16);
    if (lane < 16)
#pragma unroll
      for (int l = 0; l < kPer; ++l) cbuf[warp][tj + 16 * l] = col[l];
    __syncthreads();
    if (tid < kTile && j0 + tid < count) {
      float c = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) c += cbuf[w][tid];
      part[(static_cast<long long>(r) * T + a) * K + j0 + tid] = diag ? rbuf[tid] + c : c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
medoid_reduce_kernel(const float* __restrict__ part, const int32_t* __restrict__ counts,
                     float* __restrict__ out, int K, int T) {
  const int r = blockIdx.y, i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= K) return;
  const int count = counts[r];
  float s = 0.0f;
  if (i < count) {
    const float* p = part + static_cast<long long>(r) * T * K + i;
    const int nt = (count + kTile - 1) / kTile;
    for (int t = 0; t < nt; ++t) s += p[static_cast<long long>(t) * K];
  }
  out[static_cast<long long>(r) * K + i] = s;
}

}  // namespace

// rows [R, 3, K] f32, valid [R, K] bytes (0/1), out [R, K] f32, all
// contiguous on the device. Scratch the caller allocates: counts [R] and off
// [R + 1] int32, part [R, ceil(K / 128), K] f32. R * nt (nt + 1) / 2 with
// nt = ceil(K / 128) must fit an int32. Launches on `stream`; returns the
// cudaError_t of the first launch that failed.
extern "C" int medoid_sums_launch(const void* rows, const void* valid, void* counts, void* off,
                                  void* part, void* out, int R, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (K + kTile - 1) / kTile;
  medoid_count_kernel<<<(R + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(counts), R, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  medoid_plan_kernel<<<1, kPlanThreads, 0, s>>>(static_cast<const int32_t*>(counts),
                                                static_cast<int32_t*>(off), R);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, medoid_pairs_kernel, kThreads,
                                                           0)) != cudaSuccess)
    return static_cast<int>(err);
  const long long most = static_cast<long long>(R) * T * (T + 1) / 2;  // every tile pair live
  const int grid = static_cast<int>(most < static_cast<long long>(sms) * per_sm ? most : sms * per_sm);
  if (grid > 0) {
    medoid_pairs_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(rows), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(off),
        static_cast<float*>(part), R, K, T);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  medoid_reduce_kernel<<<dim3((K + kThreads - 1) / kThreads, R), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(counts),
      static_cast<float*>(out), K, T);
  return static_cast<int>(cudaGetLastError());
}
