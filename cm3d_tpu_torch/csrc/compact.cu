// Order-preserving row compaction of 32-bit payloads (sm_90a).
//
// Replaces the TPU kernel cm3d_tpu/kernels/compact_pallas.py
// (compact_rows_pallas / _compact_kernel), which computed the same function
// as tiled one-hot matmuls on the MXU with a 3-way bf16 split of every value.
// Here the payload is moved as raw 32-bit words, so f32 coordinates, int32
// point ids, flat pixel indices and mask words all ride bit-exactly.
//
//   out[r, d, l] = values[r, d, i_l]   for l < min(count_r, L)
//   out[r, d, l] = 0                   for count_r <= l < L
//   where i_l is the position of the l-th nonzero of sel[r] (ascending).
//
// Bound on the H100: memory bytes. The function reads each row's S
// selection bytes once and only the D words of the kept sources, and writes
// D*L words; there is no arithmetic to speak of. Two things keep it off that
// bound. The lift step's calls have few rows and long ones (the camera
// stage: 48 rows of 131072 sources), so a row's work has to be spread over
// many blocks to fill 132 SMs. And the kept sources lie scattered: a kept
// word is read with its 32-byte sector, and at the camera stage 61% of the
// value sectors hold a kept source (19% at the mask stage), so the bytes
// that have to move are about twice the bound's.
//
// Design: each row is cut into tiles of `tile` sources (a multiple of 16;
// the wrapper takes 4096, the fastest tile at all three lift stages), and a
// call launches two kernels over the grid (tiles, rows):
//   1. compact_count_kernel: each thread loads 16 selection bytes as one
//      16-byte vector and counts the nonzero ones; a block reduction writes
//      the tile's count to counts[R, T] (scratch from the wrapper).
//   2. compact_scatter_kernel: a block adds up the counts of its row's
//      earlier tiles (its first output slot) and of all of them (the row's
//      count) while its first selection bytes load, then walks its tile
//      4096 sources at a time: the selection bytes (read again, from L2)
//      become a bitmap in shared memory, a scan of the 32-bit words'
//      popcounts gives each word its first slot, and a warp takes 8 words at
//      a time (their loads in flight together), each lane its source: slot =
//      word's slot + popc(word & lanes below), so a warp's kept sources land
//      on consecutive slots (coalesced stores) and only sectors that hold a
//      kept source are read. Slots >= L are dropped, and a tile whose first
//      slot is >= L scatters nothing. Last, the block zeroes its share of
//      the row's tail [min(count, L), L) (the tail cut into T equal slices),
//      with 16-byte stores where the row is 16-byte aligned.
// The output is a permutation of words plus zeros: bit-exact, and the same
// bits on every call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;  // sources a scatter pass covers (16 a thread)
constexpr int kWords = kChunk / 32;    // bitmap words of a pass
constexpr int kUnroll = 8;             // bitmap words a warp scatters at a time
static_assert(kWords % (kWarps * kUnroll) == 0, "a pass's words split evenly over the warps");

// One bit per nonzero byte of w (bit k for byte k).
__device__ __forceinline__ uint32_t byte_mask4(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// Bitmap of the 16 selection bytes s[0..n) (n <= 16; bytes past n count as 0).
__device__ __forceinline__ uint32_t byte_mask16(const uint8_t* __restrict__ s, int n, bool vec) {
  if (vec && n == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(s);
    return byte_mask4(q.x) | (byte_mask4(q.y) << 4) | (byte_mask4(q.z) << 8) |
           (byte_mask4(q.w) << 12);
  }
  uint32_t m = 0;
  for (int j = 0; j < n; ++j) m |= static_cast<uint32_t>(s[j] != 0) << j;
  return m;
}

// Sums of two ints per thread over the block; every thread gets both totals.
__device__ __forceinline__ int2 block_sum2(int a, int b, int2* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 total = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) total.x += scratch[w].x, total.y += scratch[w].y;
  return total;
}

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const uint8_t* __restrict__ sel, int32_t* __restrict__ counts, int S,
                     int tile, bool vec) {
  __shared__ int2 s_red[kWarps];
  const int k = blockIdx.x;
  const long long r = blockIdx.y;
  const uint8_t* s = sel + r * S;
  const int lo = k * tile;
  const int n = min(tile, S - lo);
  int c = 0;
  for (int i = 16 * threadIdx.x; i < n; i += 16 * kThreads) {
    c += __popc(byte_mask16(s + lo + i, min(16, n - i), vec));
  }
  c = block_sum2(c, 0, s_red).x;
  if (threadIdx.x == 0) counts[r * gridDim.x + k] = c;
}

__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const uint8_t* __restrict__ sel, const int32_t* __restrict__ values,
                       const int32_t* __restrict__ counts, int32_t* __restrict__ out, int S,
                       int D, int L, int tile, bool vec) {
  __shared__ uint32_t s_bits[kWords];
  __shared__ int s_slot[kWords];
  __shared__ int s_red[kWarps];
  __shared__ int2 s_red2[kWarps];
  __shared__ int s_pass;  // sources a pass keeps

  const int k = blockIdx.x, T = gridDim.x;
  const long long r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* s = sel + r * S;
  const int32_t* v = values + r * D * (long long)S;
  int32_t* o = out + r * D * (long long)L;

  // the first pass's selection bytes, loaded before the counts so that the
  // two loads overlap
  const int lo = k * tile;
  const int hi = lo + min(tile, S - lo);
  const int i = 16 * tid;
  int n = min(kChunk, hi - lo);
  uint32_t m16 = i < n ? byte_mask16(s + lo + i, min(16, n - i), vec) : 0u;

  // this tile's first slot, and the row's count
  int before = 0, all = 0;
  for (int j = tid; j < T; j += kThreads) {
    const int c = counts[r * T + j];
    all += c;
    if (j < k) before += c;
  }
  const int2 sums = block_sum2(before, all, s_red2);
  int base = sums.x;
  const int count = sums.y;

  for (int p = lo; p < hi && base < L; p += kChunk) {
    if (p != lo) {
      n = min(kChunk, hi - p);
      m16 = i < n ? byte_mask16(s + p + i, min(16, n - i), vec) : 0u;
    }
    reinterpret_cast<uint16_t*>(s_bits)[tid] = static_cast<uint16_t>(m16);
    __syncthreads();
    if (warp < kWords / 32) {  // exclusive scan of the words' popcounts
      const int x = __popc(s_bits[tid]);
      int incl = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      s_slot[tid] = incl - x;
      if (lane == 31) s_red[warp] = incl;
    }
    __syncthreads();
    if (warp < kWords / 32) {
      int add = 0;
      for (int w = 0; w < warp; ++w) add += s_red[w];
      s_slot[tid] += base + add;
      if (tid == kWords - 1) s_pass = s_slot[tid] - base + __popc(s_bits[tid]);
    }
    __syncthreads();
    // a warp takes kUnroll words at a time, so that their loads are in
    // flight together
    for (int w0 = warp; w0 < kWords; w0 += kWarps * kUnroll) {
      int dest[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = w0 + u * kWarps;
        const uint32_t m = s_bits[w];
        const int at = s_slot[w] + __popc(m & ((1u << lane) - 1u));
        dest[u] = (m >> lane) & 1u && at < L ? at : -1;
      }
      if (s_slot[w0] >= L) break;  // later words start later still
      for (int d = 0; d < D; ++d) {
        int32_t x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (dest[u] >= 0) x[u] = v[(long long)d * S + p + 32 * (w0 + u * kWarps) + lane];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (dest[u] >= 0) o[(long long)d * L + dest[u]] = x[u];
        }
      }
    }
    base += s_pass;
    __syncthreads();  // the bitmap and slots are rewritten by the next pass
  }

  // this tile's slice of the zero tail
  const int filled = min(count, L);
  const long long tail = L - filled;
  const int z0 = filled + static_cast<int>(tail * k / T);
  const int z1 = filled + static_cast<int>(tail * (k + 1) / T);
  if (z0 >= z1) return;
  const bool vec_out = (L & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int a0 = vec_out ? min((z0 + 3) & ~3, z1) : z1;  // 16-byte aligned body [a0, a1)
  const int a1 = vec_out ? max(z1 & ~3, a0) : z1;
  for (int d = 0; d < D; ++d) {
    int32_t* row = o + (long long)d * L;
    for (int j = z0 + tid; j < a0; j += kThreads) row[j] = 0;
    for (int j = a0 + 4 * tid; j < a1; j += 4 * kThreads) {
      *reinterpret_cast<int4*>(row + j) = make_int4(0, 0, 0, 0);
    }
    for (int j = a1 + tid; j < z1; j += kThreads) row[j] = 0;
  }
}

}  // namespace

// sel [R, S] bytes (0/1), values [R, D, S] and out [R, D, L] 32-bit words,
// all contiguous on the device; counts [R, ceil(S / tile)] int32 scratch;
// tile a multiple of 16. Launches the count kernel, then the scatter
// kernel, on `stream` (rows in launches of at most 65535, gridDim.y's
// limit); returns the cudaError_t of the launches.
extern "C" int compact_rows_launch(const void* sel, const void* values, void* out, void* counts,
                                   int R, int S, int D, int L, int tile, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int T = S > 0 ? (S + tile - 1) / tile : 1;  // S == 0: one block zeroes the row
  const bool vec = S % 16 == 0 && (reinterpret_cast<uintptr_t>(sel) & 15) == 0;
  for (int r0 = 0; r0 < R; r0 += 65535) {
    const dim3 grid(T, min(R - r0, 65535));
    const auto* s = static_cast<const uint8_t*>(sel) + (long long)r0 * S;
    auto* c = static_cast<int32_t*>(counts) + (long long)r0 * T;
    compact_count_kernel<<<grid, kThreads, 0, st>>>(s, c, S, tile, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compact_scatter_kernel<<<grid, kThreads, 0, st>>>(
        s, static_cast<const int32_t*>(values) + (long long)r0 * D * S, c,
        static_cast<int32_t*>(out) + (long long)r0 * D * L, S, D, L, tile, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
