// SAM's global-attention blocks (sm_90a): softmax(q k^T * hd^-1/2 + the
// decomposed relative-position bias) v in one flash-style kernel, so the
// [heads, n, n] scores, their f32 copy and the probabilities never reach
// device memory.
//
// Replaces no TPU kernel: the JAX package leaves these blocks
// (cm3d_tpu/models/sam.py Attention with window 0) to XLA, which fuses the
// bias and the softmax into its score chain. Eager PyTorch runs that chain
// as separate kernels (an einsum writing the bf16 scores, two broadcast adds
// of the bias, a copy up to f32, the softmax, a copy down, a second einsum),
// about 32 bytes of device traffic a score: 268 M scores a ViT-H global
// block and camera. Per (query i, key j) of head h:
//
//   s[i, j] = (q_i . k_j) * hd^-1/2 + q_i . Rh[r_i - r_j + kh - 1]
//                                   + q_i . Rw[c_i - c_j + gw - 1]
//   o_i = sum_j softmax_j(s[i, :]) v_j
//
// where (r, c) is a token's row and column in the gh x gw grid (a query's
// row offset by row0: a sequence-sharded block holds rows row0 ... of the
// whole map's kh rows), Rh [2 kh - 1, hd] and Rw [2 gw - 1, hd] the tables
// (resized on the device by the caller where the grid is not the table's).
// q, k, v arrive as the qkv linear gives them, [B, n, heads, hd] with a
// token stride (3 C, or C for gathered keys), and o leaves as [B, qn, C].
//
// Bound on the H100 (ViT-H, 64 x 64 grid, 16 heads, hd 80): 4 n^2 C + 2 n C
// (gh + gw) = 87 GFLOP a block and camera against 42 MB of q, k, v and o:
// operations bind it (88 us at 989 TFLOP/s, 12.5 us of bytes).
//
// Design (bf16, hd 64 or 80, grids up to 64 x 64): a persistent block an SM
// walks (image, head, 128-query) units. Warpgroup 0 is the producer: one
// thread keeps TMA loads in flight, q of the next unit into the second of
// two buffers and k | v tiles of 64 keys into a ring of stages (full / empty
// mbarriers). A tile comes as two boxes: head columns 0-63 in 128-byte rows
// (128B swizzle) and, at hd 80, columns 64-79 in 32-byte rows (32B
// swizzle), which wgmma reads K-major for q and k and, transposed, MN-major
// for v; the map's batch dimension zero-fills rows past the image. (Boxes
// of 16-byte columns in the no-swizzle layout, ten a tile at hd 80, took
// 0.32 ms a call at ViT-H's grid on an H100 against 0.27 for these two.)
// Warpgroups 1 and 2 take 64 queries each:
//  - at a unit's start, the table products q Rh^T and q Rw^T (wgmma
//    m64n128k16 over the tables' 127 rows, padded to 128), scattered by each
//    query's row and column into per-key f32 bias tables in shared memory,
//    premultiplied by log2 e. An f32 (resized) table is split into bf16 hi +
//    lo parts as it loads, and both are multiplied, so its products keep
//    f32's precision;
//  - per key tile: S = q k^T (wgmma m64n64k16, hd / 16 steps), in f32 times
//    hd^-1/2 log2 e plus the bias. Where a key tile is one grid row (gw =
//    64, every shape the pipelines run), the w term of a thread's 32 scores
//    is the same for every tile and stays in registers, and the h term is
//    one shared-memory read a row; other grids read both per score and mask
//    the ragged last tile;
//  - the online softmax in f32 (exp2, the row max across the quad, the
//    running sum kept per thread until the end), p rounded to bf16 straight
//    into the A registers of o += p v (wgmma m64n64k16, and m64n16k16 for
//    the tail, v from shared memory), o normalised in f32 and rounded once;
//  - the products of tile t + 1's scores and tile t's p v are issued
//    together, so the softmax of t + 1 runs while the tensor cores do t's p v
//    (the first tile is peeled off, so no branch separates a product from
//    its wait: a value the compiler moves in between serializes them all).
// On an H100 a ViT-H call takes 0.27-0.28 ms, 32% of its bound.
// Every sum is f32; the scores are never rounded; p and o are bf16, as in
// the plain chain, which rounds the scores, the bias terms and p besides.
// f32 (and shapes outside the above): a plain SIMT kernel, one warp a query,
// exact expf, correct rather than fast.

#include <cmath>

#include "window_attn_common.cuh"

namespace {

using namespace wattn;
using gemm::fence_acc;
using gemm::mbar_arrive;
using gemm::mbar_expect_tx;
using gemm::mbar_init;
using gemm::mbar_wait;
using gemm::smem_u32;

constexpr int kBM = 64;          // queries a consumer warpgroup
constexpr int kBN = 64;          // keys a tile
constexpr int kConsumers = 2;
constexpr int kBlock = 128 * (1 + kConsumers);
constexpr int kMaxGrid = 64;     // rows and columns of the grid
constexpr int kTabRows = 128;    // 2 * 64 - 1 table rows, padded
constexpr int kLDB = kMaxGrid + 1;  // row stride (floats) of a bias table
constexpr int kMaxStages = 4;
constexpr size_t kSmemMax = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// The tensor maps of q, k, v: the main part's boxes and the tail's
struct Maps {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

// tab_f32: bit 0 the h table, bit 1 the w table are f32 (else bf16)
struct Dims {
  int B, heads, qn, kn, gw, kh, row0, rh_rows, rw_rows, tab_f32;
};

__device__ __forceinline__ float table_at(const void* t, bool f32, long long i) {
  return f32 ? static_cast<const float*>(t)[i] : __bfloat162float(static_cast<const bf16*>(t)[i]);
}

// Shared memory (bytes), the same on host and device: two q buffers of 128
// rows, the tables (h, w, and where split their lo parts), each consumer's
// two bias tables, the k | v stages, the mbarriers. Every tile starts on
// 1024 bytes (see Tile).
struct Layout {
  size_t qbuf, tab, stage, off_tab, off_bias, off_stage, off_bar, total;
};

__host__ __device__ inline size_t round1024(size_t v) { return (v + 1023) & ~size_t(1023); }

__host__ __device__ inline Layout layout(int hd, int split, int stages) {
  Layout L;
  L.qbuf = size_t(2 * kBM) * hd * 2;
  L.tab = size_t(kTabRows) * hd * 2;
  L.stage = size_t(2 * kBN) * hd * 2;
  L.off_tab = 2 * L.qbuf;
  L.off_bias = L.off_tab + (split ? 4 : 2) * L.tab;
  L.off_stage = L.off_bias + round1024(size_t(kConsumers) * 2 * kBM * kLDB * sizeof(float));
  L.off_bar = L.off_stage + stages * L.stage;
  L.total = L.off_bar + (4 + 2 * stages) * sizeof(uint64_t) + 1024;  // + alignment
  return L;
}

__host__ inline int stages_that_fit(int hd, int split) {
  for (int s = kMaxStages; s > 1; --s)
    if (layout(hd, split, s).total <= kSmemMax) return s;
  return 1;
}

// A tile of `rows` rows as TMA writes it: the main part (columns 0-63,
// 128-byte rows, 128B swizzle) and, at head dim 80, the tail (columns 64-79,
// 32-byte rows, 32B swizzle) rows * 128 bytes after it. Both start on 1024
// bytes.
struct Tile {
  const bf16* main;
  const bf16* tail;
};
__device__ __forceinline__ Tile tile_rows(const bf16* base, int rows, int row0) {
  return {base + row0 * 64, base + rows * 64 + row0 * 16};
}

// a wgmma descriptor: swizzle type (1: 128B, 3: 32B), the two byte offsets
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t type, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(type) << 62);
}
// 16-column step kk of a tile read K-major (q, k, the tables): 8-row groups
// 1024 (main) or 256 (tail) bytes apart
__device__ __forceinline__ uint64_t desc_k(const Tile& t, int kk) {
  return kk < 4 ? desc_sw(t.main + kk * 16, 1, 16, 1024) : desc_sw(t.tail, 3, 16, 256);
}
// keys 16 kk ... of v read MN-major (N along the row): the main part's 64
// columns or the tail's 16
__device__ __forceinline__ uint64_t desc_v(const Tile& t, bool tail, int kk) {
  const bf16* p = tail ? t.tail + kk * 16 * 16 : t.main + kk * 16 * 64;
  return desc_sw(p, tail ? 3 : 1, 16, tail ? 256 : 1024);
}

// 3D TMA load of the box at (c0, c1, c2) into dst; completes on bar
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keep registers alive (and unmoved) past an asm point: a wgmma reads its
// A registers until wgmma.wait_group says it is done
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// S (+)= A B^T, m64n64k16, both from shared memory (K-major); scale_d 0
// overwrites. d[4 j + e]: row 16 warp + lane / 4 + 8 (e / 2), column 8 j +
// 2 (lane % 4) + e % 2
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V, m64n64k16 (and m64n16k16 for the tail): P from registers (the
// accumulator layout of m64n16, rounded to bf16), V from shared memory
// MN-major (transposed)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// unit -> image, head, 128-query block (blocks fastest: the blocks of one
// head run together and share its k and v in L2)
__device__ __forceinline__ void decode_unit(int unit, int heads, int nqb, int& b, int& h,
                                            int& qb) {
  qb = unit % nqb;
  h = (unit / nqb) % heads;
  b = unit / (nqb * heads);
}

// The table products of one consumer's 64 queries against one table (and
// its lo part), scattered by key row (h) or column (w) into `bias`
// (premultiplied by log2 e). `axis_h`: the h table.
template <int HD>
__device__ __forceinline__ void table_bias(const Tile& q, const bf16* tab, const bf16* tab_lo,
                                           float* bias, bool axis_h, const Dims& d, int q0,
                                           int warp, int lane) {
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  gemm::wgmma_fence();
  const Tile t = tile_rows(tab, kTabRows, 0);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) gemm::wgmma_bf16(acc, desc_k(q, kk), desc_k(t, kk));
  if (tab_lo != nullptr) {
    const Tile tl = tile_rows(tab_lo, kTabRows, 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) gemm::wgmma_bf16(acc, desc_k(q, kk), desc_k(tl, kk));
  }
  gemm::wgmma_commit();
  gemm::wgmma_wait<0>();
  fence_acc(acc);
  const int g = lane >> 2, t4 = lane & 3;
  const int n_keys = axis_h ? d.kh : d.gw;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    const int qi = q0 + r;
    // a query past the image takes the last row: its output is dropped
    const int pos = axis_h ? min(d.row0 + qi / d.gw, d.kh - 1) : qi % d.gw;
    float* dst = bias + r * kLDB;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // entry u of the row holds q . table[u]; it serves the key at
        // pos + n_keys - 1 - u
        const int key = pos + n_keys - 1 - (8 * j + 2 * t4 + e);
        if (key >= 0 && key < n_keys) dst[key] = acc[4 * j + 2 * half + e] * kLog2e;
      }
    }
  }
}

template <int HD, bool kRowTile>
__global__ void __launch_bounds__(kBlock, 1)
global_attn_kernel(const __grid_constant__ Maps maps, const void* __restrict__ rh,
                   const void* __restrict__ rw, bf16* __restrict__ o, Dims d, float scale,
                   int stages) {
  constexpr bool kTail = HD == 80;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const Layout L = layout(HD, d.tab_f32, stages);
  auto qbuf = [&](int i) { return reinterpret_cast<bf16*>(smem + i * L.qbuf); };
  bf16* tab = reinterpret_cast<bf16*>(smem + L.off_tab);  // h, w, h lo, w lo
  float* bias = reinterpret_cast<float*>(smem + L.off_bias);
  auto kst = [&](int s) { return reinterpret_cast<bf16*>(smem + L.off_stage + s * L.stage); };
  auto vst = [&](int s) { return kst(s) + kBN * HD; };
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L.off_bar);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + stages;

  const int nqb = (d.qn + 2 * kBM - 1) / (2 * kBM);
  const int units = d.B * d.heads * nqb;
  const int KT = (d.kn + kBN - 1) / kBN;
  const int C = d.heads * HD;

  // once: the tables in the chunked layout, zero past their rows; where one
  // is f32, both as bf16 hi and lo = round(t - hi)
  for (int e = threadIdx.x; e < 2 * kTabRows * HD; e += kBlock) {
    const int part = e / (kTabRows * HD), rem = e % (kTabRows * HD), u = rem / HD, c = rem % HD;
    const int rows = part ? d.rw_rows : d.rh_rows;
    const float val =
        u < rows ? table_at(part ? rw : rh, (d.tab_f32 >> part) & 1, u * HD + c) : 0.0f;
    const bf16 hi = __float2bfloat16(val);
    // the swizzled place TMA would give (c, u) in a tile of kTabRows rows
    const int at = c < 64 ? u * 64 + (((c >> 3) ^ (u & 7)) << 3) + (c & 7)
                          : kTabRows * 64 + u * 16 + ((((c - 64) >> 3) ^ ((u >> 2) & 1)) << 3) +
                                (c & 7);
    tab[part * kTabRows * HD + at] = hi;
    if (d.tab_f32)
      tab[(2 + part) * kTabRows * HD + at] = __float2bfloat16(val - __bfloat162float(hi));
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, 4 * kConsumers);
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the tables, for wgmma
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  if (wg == 0) {  // producer
    gemm::regs_dealloc<40>();
    if (warp == 0) {
      const uint32_t qbytes = 2 * kBM * HD * 2, kvbytes = 2 * kBN * HD * 2;
      int s = 0;
      uint32_t ph = 0;
      for (int i = 0, unit = blockIdx.x; unit < units; ++i, unit += gridDim.x) {
        int b, h, qb;
        decode_unit(unit, d.heads, nqb, b, h, qb);
        const int qbi = i & 1;
        mbar_wait(qempty + qbi, ((i >> 1) & 1) ^ 1);
        if (lane == 0) mbar_expect_tx(qfull + qbi, qbytes);
        __syncwarp();
        if (lane == 0) {
          tma_load3(qbuf(qbi), &maps.q, qfull + qbi, h * HD, qb * 2 * kBM, b);
          if (kTail)
            tma_load3(qbuf(qbi) + 2 * kBM * 64, &maps.q_tail, qfull + qbi, h * HD + 64,
                      qb * 2 * kBM, b);
        }
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty + s, ph ^ 1);
          if (lane == 0) mbar_expect_tx(full + s, kvbytes);
          __syncwarp();
          if (lane == 0) {
            tma_load3(kst(s), &maps.k, full + s, h * HD, kt * kBN, b);
            tma_load3(vst(s), &maps.v, full + s, h * HD, kt * kBN, b);
            if (kTail) {
              tma_load3(kst(s) + kBN * 64, &maps.k_tail, full + s, h * HD + 64, kt * kBN, b);
              tma_load3(vst(s) + kBN * 64, &maps.v_tail, full + s, h * HD + 64, kt * kBN, b);
            }
          }
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  gemm::regs_alloc<232>();
  const int c = wg - 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0, r0 + 8 of the 64
  float* bH = bias + c * 2 * kBM * kLDB;
  float* bW = bH + kBM * kLDB;
  const bf16* tab_h = tab;
  const bf16* tab_w = tab + kTabRows * HD;
  const bf16* lo_h = d.tab_f32 ? tab + 2 * kTabRows * HD : nullptr;
  const bf16* lo_w = d.tab_f32 ? tab + 3 * kTabRows * HD : nullptr;
  const float sl2 = scale * kLog2e;
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0, unit = blockIdx.x; unit < units; ++i, unit += gridDim.x) {
    int b, h, qb;
    decode_unit(unit, d.heads, nqb, b, h, qb);
    const int q0 = qb * 2 * kBM + c * kBM;
    const int qbi = i & 1;
    mbar_wait(qfull + qbi, (i >> 1) & 1);
    const Tile qt = tile_rows(qbuf(qbi), 2 * kBM, c * kBM);  // this warpgroup's 64 rows

    // the bias tables of the unit's queries (after the last unit's reads)
    gemm::bar_sync(1 + c, 128);
    table_bias<HD>(qt, tab_h, lo_h, bH, true, d, q0, warp, lane);
    table_bias<HD>(qt, tab_w, lo_w, bW, false, d, q0, warp, lane);
    gemm::bar_sync(1 + c, 128);
    float bw[32];  // a row tile's w term, the same for every key tile
    if constexpr (kRowTile) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bw[4 * j + e] = bW[(r0 + 8 * (e >> 1)) * kLDB + 8 * j + 2 * t4 + (e & 1)];
    }

    float acc[32], acc_t[8];  // o's columns 0-63 and (head dim 80) 64-79
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_t[k] = 0.0f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];  // the last tile's p, bf16 A fragments of its four 16-key steps
    float alpha[2];

    // S = q k^T of the tile in stage `st`, overwriting sc
    auto scores = [&](float (&sc)[32], int st) {
      const Tile kt_ = tile_rows(kst(st), kBN, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n64(sc, desc_k(qt, kk), desc_k(kt_, kk), kk);
    };
    // o += p v of the tile in stage `st`
    auto pv = [&](int st) {
      const Tile vt = tile_rows(vst(st), kBN, 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv(acc, pa[kk], desc_v(vt, false, kk));
        if (kTail) wgmma_pv(acc_t, pa[kk], desc_v(vt, true, kk));
      }
    };
    auto fence_o = [&] {
      fence_acc(acc);
      if (kTail) fence_acc(acc_t);
    };
    // tile kt's scores in log2 units (s hd^-1/2 log2e + the bias, log2e
    // already in it), the running max, alpha = 2^(old max - new max), p as
    // bf16 A fragments into pn, the rows' sums of p into psum
    auto softmax = [&](float (&sc)[32], int kt, uint32_t (&pn)[4][4], float (&psum)[2]) {
      float mx[2] = {-INFINITY, -INFINITY};
      if constexpr (kRowTile) {
        const float bh0 = bH[r0 * kLDB + kt], bh1 = bH[(r0 + 8) * kLDB + kt];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          sc[k] = fmaf(sc[k], sl2, ((k & 2) ? bh1 : bh0) + bw[k]);
          mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], sc[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int key = kt * kBN + 8 * (k >> 2) + 2 * t4 + (k & 1);
          const int r = r0 + 8 * ((k >> 1) & 1);
          if (key < d.kn) {
            const int kr = key / d.gw, kc = key - kr * d.gw;
            sc[k] = fmaf(sc[k], sl2, bH[r * kLDB + kr] + bW[r * kLDB + kc]);
          } else {
            sc[k] = -INFINITY;
          }
          mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], sc[k]);
        }
      }
      float nb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mnew = fmaxf(mrow[r], mx[r]);  // finite: every tile has a real key
        alpha[r] = ex2(mrow[r] - mnew);
        mrow[r] = mnew;
        nb[r] = -mnew;
        psum[r] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // f: (row r0 | r0 + 8) x (keys 2 t4 | 8 + 2 t4)
          const int k = 8 * kk + 2 * f, r = f & 1;
          const float p0 = ex2(sc[k] + nb[r]), p1 = ex2(sc[k + 1] + nb[r]);
          psum[r] += p0 + p1;
          pn[kk][f] = pack2(p0, p1);
        }
      }
    };

    // tile 0 alone; then each tile's scores are issued with the last tile's
    // p v, and its softmax runs while the tensor cores do that p v. No
    // branch around a product: a value the compiler moves between a product
    // and its wait stalls every product of the loop
    {
      mbar_wait(full + s, ph);
      float sc[32];
      gemm::wgmma_fence();
      scores(sc, s);
      gemm::wgmma_commit();
      gemm::wgmma_wait<0>();
      fence_acc(sc);
      float psum[2];
      softmax(sc, 0, pa, psum);
      lrow[0] = psum[0];
      lrow[1] = psum[1];
    }
    int sprev = s;
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
    for (int kt = 1; kt < KT; ++kt) {
      mbar_wait(full + s, ph);
      float sc[32];
      gemm::wgmma_fence();
      scores(sc, s);
      gemm::wgmma_commit();
      pv(sprev);
      gemm::wgmma_commit();
      gemm::wgmma_wait<1>();
      fence_acc(sc);
      uint32_t pn[4][4];
      float psum[2];
      softmax(sc, kt, pn, psum);
      gemm::wgmma_wait<0>();
      fence_o();
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty + sprev);
#pragma unroll
      for (int r = 0; r < 2; ++r) lrow[r] = fmaf(lrow[r], alpha[r], psum[r]);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] *= alpha[(k >> 1) & 1];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc_t[k] *= alpha[(k >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) pa[kk][f] = pn[kk][f];
      sprev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    fence_o();
    gemm::wgmma_fence();
    pv(sprev);
    gemm::wgmma_commit();
    gemm::wgmma_wait<0>();
    fence_o();
    fence_regs(pa);
    if (lane == 0) {
      mbar_arrive(empty + sprev);
      mbar_arrive(qempty + qbi);
    }

    // o = acc / sum, rounded once, at [b, q, h * HD + column]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = lrow[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / l;
      const int q = q0 + r0 + 8 * r;
      if (q < d.qn) {
        bf16* dst = o + (static_cast<long long>(b) * d.qn + q) * C + h * HD + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st32(dst + 8 * j, acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (kTail) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            st32(dst + 64 + 8 * j, acc_t[4 * j + 2 * r] * inv, acc_t[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---- the plain SIMT kernel: one warp a query; the table products into
// shared memory, the scores of every key there, exact expf, p v by columns
constexpr int kSimtWarps = 4;

__host__ __device__ inline int simt_floats(int hd, int rh_rows, int rw_rows, int kn) {
  return (hd + rh_rows + rw_rows + kn + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(kSimtWarps * 32)
global_attn_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        long long qs, long long kvs, const void* __restrict__ rh,
                        const void* __restrict__ rw, T* __restrict__ o, Dims d, int hd,
                        float scale) {
  extern __shared__ __align__(16) float sf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kSimtWarps + warp, h = blockIdx.y, b = blockIdx.z;
  if (qi >= d.qn) return;
  float* qv = sf + warp * simt_floats(hd, d.rh_rows, d.rw_rows, d.kn);
  float* ph = qv + hd;
  float* pw = ph + d.rh_rows;
  float* sr = pw + d.rw_rows;
  const T* qrow = q + (static_cast<long long>(b) * d.qn + qi) * qs + h * hd;
  for (int c = lane; c < hd; c += 32) qv[c] = to_f(qrow[c]);
  __syncwarp();
  for (int u = lane; u < d.rh_rows + d.rw_rows; u += 32) {
    const int part = u < d.rh_rows ? 0 : 1;
    const long long row = static_cast<long long>(part ? u - d.rh_rows : u) * hd;
    float dot = 0.0f;
    for (int c = 0; c < hd; ++c)
      dot += qv[c] * table_at(part ? rw : rh, (d.tab_f32 >> part) & 1, row + c);
    ph[u] = dot;  // pw follows ph
  }
  __syncwarp();
  const int qr = d.row0 + qi / d.gw, qc = qi % d.gw;
  const T* kb = k + static_cast<long long>(b) * d.kn * kvs + h * hd;
  const T* vb = v + static_cast<long long>(b) * d.kn * kvs + h * hd;
  float m = -INFINITY;
  for (int j = lane; j < d.kn; j += 32) {
    const T* krow = kb + static_cast<long long>(j) * kvs;
    float dot = 0.0f;
    for (int c = 0; c < hd; ++c) dot += qv[c] * to_f(krow[c]);
    const int kr = j / d.gw, kc = j - kr * d.gw;
    const float sv = dot * scale + ph[qr - kr + d.kh - 1] + pw[qc - kc + d.gw - 1];
    sr[j] = sv;
    m = fmaxf(m, sv);
  }
  for (int x = 16; x; x >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
  float l = 0.0f;
  for (int j = lane; j < d.kn; j += 32) {
    const float e = expf(sr[j] - m);
    sr[j] = e;
    l += e;
  }
  for (int x = 16; x; x >>= 1) l += __shfl_xor_sync(0xffffffffu, l, x);
  __syncwarp();
  T* orow = o + (static_cast<long long>(b) * d.qn + qi) * d.heads * hd + h * hd;
  for (int c = lane; c < hd; c += 32) {
    float a = 0.0f;
    for (int j = 0; j < d.kn; ++j) a += sr[j] * to_f(vb[static_cast<long long>(j) * kvs + c]);
    orow[c] = from_f<T>(a / l);
  }
}

// The tensor map of one of q, k, v: [B, n, C] bf16 with a token stride, in
// boxes of `box_cols` columns (64: 128B swizzle, 16: 32B) x `box_rows`
// tokens of one image; rows past n read as zero
int encode3(CUtensorMap* map, const void* base, int cols, int rows, int batch, long long stride,
            int box_cols, int box_rows) {
  const gemm::EncodeTiled fn = gemm::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(stride) * 2, cuuint64_t(stride) * 2 * rows};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD, bool kRowTile>
int launch_bf16(const Maps& maps, const void* rh, const void* rw, void* o, const Dims& d,
                float scale, cudaStream_t stream) {
  auto kernel = global_attn_kernel<HD, kRowTile>;
  const int stages = stages_that_fit(HD, d.tab_f32);
  const size_t smem = layout(HD, d.tab_f32, stages).total;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem))) != cudaSuccess)
    return static_cast<int>(err);
  const long long units = static_cast<long long>(d.B) * d.heads * ((d.qn + 2 * kBM - 1) / (2 * kBM));
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, kBlock, smem, stream>>>(maps, rh, rw, static_cast<bf16*>(o), d, scale, stages);
  return static_cast<int>(cudaGetLastError());
}

Dims make_dims(int B, int heads, int qh, int gw, int kh, int row0, int tab_f32) {
  Dims d;
  d.B = B;
  d.heads = heads;
  d.qn = qh * gw;
  d.kn = kh * gw;
  d.gw = gw;
  d.kh = kh;
  d.row0 = row0;
  d.rh_rows = 2 * kh - 1;
  d.rw_rows = 2 * gw - 1;
  d.tab_f32 = tab_f32;
  return d;
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, long long qs, long long kvs,
                const void* rh, const void* rw, void* o, const Dims& d, int hd, float scale,
                dim3 grid, size_t smem, cudaStream_t stream) {
  auto kernel = global_attn_simt_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kSimtWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qs, kvs, rh,
      rw, static_cast<T*>(o), d, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 kernel. q, k, v: [B, n, heads, hd] bf16 (q: n = qh gw queries,
// rows row0 ... of the kh-row grid; k, v: n = kh gw keys), a token stride
// of q_stride / kv_stride elements (16-byte multiples, 16-byte aligned
// bases), hd 64 or 80, kh and gw at most 64, 0 <= row0, row0 + qh <= kh;
// rh [2 kh - 1, hd], rw [2 gw - 1, hd] contiguous, bf16 or f32 (tab_f32 bit
// 0: rh, bit 1: rw);
// o [B, qh gw, heads hd] bf16 contiguous. scale = hd^-1/2. Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int sam_global_attn_bf16_launch(const void* q, const void* k, const void* v,
                                           long long q_stride, long long kv_stride,
                                           const void* rh, const void* rw, int tab_f32, void* o,
                                           int B, int heads, int hd, int qh, int gw, int kh,
                                           int row0, float scale, void* stream) {
  if ((hd != 64 && hd != 80) || kh > kMaxGrid || gw > kMaxGrid || kh < 1 || gw < 1 || qh < 1 ||
      row0 < 0 || row0 + qh > kh || q_stride % 8 != 0 || kv_stride % 8 != 0 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, heads, qh, gw, kh, row0, tab_f32);
  const int C = heads * hd;
  Maps m{};
  const int tail = hd == 80 ? 16 : 64;  // at hd 64 the tail maps are not read
  int err = encode3(&m.q, q, C, d.qn, B, q_stride, 64, 2 * kBM);
  if (err == 0) err = encode3(&m.k, k, C, d.kn, B, kv_stride, 64, kBN);
  if (err == 0) err = encode3(&m.v, v, C, d.kn, B, kv_stride, 64, kBN);
  if (err == 0) err = encode3(&m.q_tail, q, C, d.qn, B, q_stride, tail, 2 * kBM);
  if (err == 0) err = encode3(&m.k_tail, k, C, d.kn, B, kv_stride, tail, kBN);
  if (err == 0) err = encode3(&m.v_tail, v, C, d.kn, B, kv_stride, tail, kBN);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool row_tile = gw == kBN;
  if (hd == 80)
    return row_tile ? launch_bf16<80, true>(m, rh, rw, o, d, scale, s)
                    : launch_bf16<80, false>(m, rh, rw, o, d, scale, s);
  return row_tile ? launch_bf16<64, true>(m, rh, rw, o, d, scale, s)
                  : launch_bf16<64, false>(m, rh, rw, o, d, scale, s);
}

// The SIMT kernel: the same arguments with any hd, grid and strides;
// t_bf16: q, k, v, o bf16 (else f32).
extern "C" int sam_global_attn_simt_launch(int t_bf16, const void* q, const void* k,
                                           const void* v, long long q_stride,
                                           long long kv_stride, const void* rh, const void* rw,
                                           int tab_f32, void* o, int B, int heads, int hd,
                                           int qh, int gw, int kh, int row0, float scale,
                                           void* stream) {
  if (hd < 1 || kh < 1 || gw < 1 || qh < 1 || row0 < 0 || row0 + qh > kh)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(B, heads, qh, gw, kh, row0, tab_f32);
  const size_t smem =
      size_t(kSimtWarps) * simt_floats(hd, d.rh_rows, d.rw_rows, d.kn) * sizeof(float);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d.qn + kSimtWarps - 1) / kSimtWarps, heads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return t_bf16 ? launch_simt<bf16>(q, k, v, q_stride, kv_stride, rh, rw, o, d, hd, scale, grid,
                                    smem, s)
                : launch_simt<float>(q, k, v, q_stride, kv_stride, rh, rw, o, d, hd, scale, grid,
                                     smem, s);
}
