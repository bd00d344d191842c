// Fused SAM windowed-block attention (sm_90a): LN + qkv + attention with
// the decomposed relative-position bias, per head, for one ViT block's
// windowed attention branch. The output projection is window_attn.cu's
// window_attn_proj (window order in, image order out), launched after it.
//
// Replaces the TPU kernel cm3d_tpu/kernels/window_attn_pallas.py:520
// fused_window_attn_relpos (_wattn_relpos_kernel), together with the pad and
// crop that models/sam.py _fused_windowed wraps around it:
//
//   pad H, W to multiples of win; per window of n = win^2 tokens: LN (f32,
//   two-pass variance; padding tokens exactly 0 after the LN, so their k and
//   v are the bare bias) -> qkv = LN @ Wqkv^T + bqkv -> per head
//   s[i, j] = (q_i . k_j) * hd^-1/2 + q_i . rel_h[r_i - r_j + win - 1]
//                                   + q_i . rel_w[c_i - c_j + win - 1]
//   (the scale follows the dot; the bias uses the raw q) -> softmax -> o = p v.
//
// Rounding follows the TPU kernel: LN out, qkv, the two bias terms, the
// normalised p and o are rounded to the compute type T (bf16 or f32); every
// sum is f32.
//
// Bound on the H100: 6 C^2 (qkv) + 4 n C (q k^T + p v) + 4 (2 win - 1) C
// (the two table products) operations a real token against a few MB of x,
// weights and o per launch: operations bind the launcher. The attention
// kernel alone reads qkv once and writes o once (50 MB at ViT-H's square
// grid, 15 us of HBM) against 5 us of tensor-core work: bytes bind it. The
// TPU kernel's G-window block-diagonal [T, T] problem, its reversed tables
// with Toeplitz select-sums and its one-hot expansion products only served
// its matrix unit; here each window is its own n x n problem and the bias is
// an indexed read of the [rows, 2 win - 1] products q @ rel^T.
//
// Design. Three kernels behind one launcher:
//  1. bf16: ln_rows_kernel (window_attn_common.cuh): round_bf16(LN(x)) in
//     window order into o (a padding token's row is 0, so its qkv is the
//     bias); f32: ln_stats_kernel, mean and rstd of every real token.
//  2. qkv_gemm_kernel (window_attn_common.cuh, shared with Swin's
//     window_attn.cu, here with shift 0): one GEMM over all windows' tokens
//     in window order, [M, C] x [C, 3C]. bf16: a persistent wgmma kernel
//     fed by TMA; f32: 128 x 64 SIMT tiles that gather and normalise x as
//     they load.
//  3. bf16: relpos_attn_kernel, on mma.sync with the softmax in registers:
//     a persistent block an SM walks (window, head) units (the units of
//     the last round are cut by query tiles over the idle blocks). A
//     producer warp brings k and v of a unit by 2D TMA boxes of 16 rows
//     into one of two buffers (so the next unit lands while this one runs;
//     mbarriers, k by chunks of 32 keys), 194 KB of shared memory in all
//     at ViT-H. Seven pairs of consumer warps take the 16-row query tiles;
//     in a pair each warp holds half the row of keys, so the whole row of
//     scores sits in registers and the function is computed in one pass:
//     q fragments from the pair's q tile (cp.async); the two [16, 32] table
//     products q rel^T (one a warp), rounded and staged by the key's row
//     (h) or column (w) in the window, the rows r and r + 8 of a key in one
//     word; S = q k^T (ldmatrix operands), scale, bias; the row max and sum
//     across the quad and then across the pair through shared memory;
//     p = round_bf16(exp(s - max) / sum) straight into the A operand of o +=
//     p v (v by ldmatrix.trans), exp as 2^(s log2 e - max log2 e); the
//     pair's two partial o added in f32 in a fixed order, rounded, staged
//     and written as 16-byte stores in window order. The mma loops carry no
//     branch: a half short of tiles computes its last tile again, scored
//     -inf, so p = 0.
//     f32: relpos_attn_f32_kernel, one block per (window, head), SIMT, q, k
//     and v in shared memory, 16 query rows at a time.
// Running 1-3 in one block per (window, head) instead makes every head
// re-read and re-normalise its window's x and re-stream its slice of Wqkv
// once per 64 rows: measured at 7.8 ms a call at ViT-H's square grid,
// against 0.93 ms for this cut. Kernel 3 took 0.39 ms a call at that grid
// when it held q, k, v and a 32-row tile of scores and p in 171 KB of shared
// memory (one block an SM, wmma round trips through shared memory for the
// scores, p and o). Why this shape and not a simpler one: one warp a tile
// needs two passes over the keys (the scores again for p v, exp twice);
// the whole row in one warp's registers spills; two half-tile jobs a head
// load k and v twice; chunk loops unrolled over 13 warps at different
// chunks thrash the instruction cache; a branch around each 16-key tile's
// products keeps them from pipelining.

#include <cmath>

#include "window_attn_common.cuh"

namespace {

using namespace wattn;

constexpr int kMaxTokens = 208;  // win^2 <= 196, padded to 16
constexpr int kMaxHd = 80;
constexpr int kRel = 32;  // rows of a rel-pos table, padded (2 win - 1 <= 32)

// ---- 3. bf16 attention on mma.sync: a persistent block an SM
constexpr int kKC = 32;                                // keys a chunk (k lands by chunks)
constexpr int kChunks = (kMaxTokens + kKC - 1) / kKC;  // 7
constexpr int kPairs = 7;         // query tiles a block works on at once, two warps each
constexpr int kHalfNT = 14;       // 8-key tiles of half a row of keys: 7 of 16 keys
constexpr int kAttnThreads = (2 * kPairs + 1) * 32;  // and one producer warp
// A pair's staged bias tables: one 32-bit word of two bf16 (query rows r,
// r + 8: low, high) by key row (h) or column (w) in the window, 17 words a
// row (bank spread); slot kPadKey of the h table is -inf, the row index of
// every padding key
constexpr int kBiasLD = 17;
constexpr int kPadKey = 16;
constexpr float kLog2e = 1.4426950408889634f;

// Block shape and shared-memory layout (bytes), the same on host and device:
// two buffers of k | v, the tables, each key's (row, column); a pair's q
// tile, then its bias tables (later its o tile), the two overlaid at the
// end by the f32 partial o the pair adds, and its row statistics; the
// mbarriers
struct AttnPlan {
  int np;     // tokens padded to 16
  int hdp;    // head dim padded to 16
  int ldh;    // row stride (elements) of k, v, the tables and a q tile
  int tiles;  // 16-row query tiles of a window
  int pairs;  // query tiles a block holds at once
  size_t mat, off_rel, off_tok, off_pair, bias, stats, pair_bytes, off_bar, total;
};

__host__ __device__ inline AttnPlan attn_plan(int n, int hd) {
  AttnPlan p;
  p.np = (n + 15) & ~15;
  p.hdp = (hd + 15) & ~15;
  p.ldh = p.hdp + 8;  // 16 bytes of padding: ldmatrix rows on distinct banks
  p.tiles = p.np / 16;
  p.pairs = p.tiles < kPairs ? p.tiles : kPairs;
  p.mat = round128(size_t(p.np) * p.ldh * sizeof(bf16));
  p.off_rel = 4 * p.mat;
  p.off_tok = p.off_rel + 2 * round128(size_t(kRel) * p.ldh * sizeof(bf16));
  p.off_pair = p.off_tok + round128(size_t(p.np) * sizeof(int));
  p.bias = round128(size_t(16) * p.ldh * sizeof(bf16));
  const size_t bias = size_t(2) * 8 * kBiasLD * sizeof(uint32_t), o = size_t(16) * p.hdp * 2;
  size_t bytes = p.bias + round128(bias > o ? bias : o);
  const size_t partial = round128(size_t(16) * p.hdp * sizeof(float));
  p.stats = bytes > partial ? bytes : partial;
  p.pair_bytes = p.stats + round128(2 * 2 * 16 * sizeof(float));
  p.off_bar = p.off_pair + p.pairs * p.pair_bytes;
  p.total = p.off_bar + (2 * (kChunks + 1) + 2) * sizeof(uint64_t);
  return p;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; a subnormal result flushes to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two warps of pair `id` (named barrier 1 + id; 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + id) : "memory");
}

// A block's work: (window, head) units, unit = block + j grid while every
// block has one; the units left over are cut by query tiles into groups,
// one an idle block, so the last round does not wait on a few blocks that
// each run a whole unit.
struct Work {
  int rounds, rem, groups, items;
};

__device__ __forceinline__ Work block_work(int units, int tiles) {
  Work w;
  w.rounds = units / gridDim.x;
  w.rem = units - w.rounds * gridDim.x;
  w.groups = w.rem ? max(1, min(tiles, int(gridDim.x) / w.rem)) : 1;
  w.items = w.rounds + (w.rem && int(blockIdx.x) < w.rem * w.groups ? 1 : 0);
  return w;
}

// item j of this block: the (window, head) unit and its query tiles [t0, t1)
__device__ __forceinline__ void work_item(const Work& w, int tiles, int j, int& unit, int& t0,
                                          int& t1) {
  if (j < w.rounds) {
    unit = blockIdx.x + j * gridDim.x;
    t0 = 0;
    t1 = tiles;
  } else {
    const int grp = blockIdx.x % w.groups;
    unit = w.rounds * gridDim.x + blockIdx.x / w.groups;
    t0 = grp * tiles / w.groups;
    t1 = (grp + 1) * tiles / w.groups;
  }
}

// 16 rows of q from src (row stride `stride`, `real` rows present) into a
// tile [16, ldh], 0 past `real` and in the columns [hd, hdp), by one warp:
// cp.async where vec, waited for here, else element by element
__device__ __forceinline__ void load_q(bf16* dst, int ldh, const bf16* src, long long stride,
                                       int real, int hd, int hdp, int vec, int lane) {
  if (vec) {
    const int d8 = hdp / 8;
    for (int e = lane; e < 16 * d8; e += 32) {
      const int r = e / d8, d = (e - r * d8) * 8;
      const bool in = r < real && d < hd;
      cp_async16(dst + r * ldh + d, in ? src + r * stride + d : src, in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = lane; e < 16 * hdp; e += 32) {
      const int r = e / hdp, d = e - r * hdp;
      dst[r * ldh + d] = r < real && d < hd ? src[r * stride + d] : __float2bfloat16(0.0f);
    }
  }
}

// kHK: 16-column steps of the head dim (hdp / 16), the q fragments a warp holds
template <int kHK>
__global__ void __launch_bounds__(kAttnThreads, 1)
relpos_attn_kernel(const __grid_constant__ CUtensorMap tqkv, const bf16* __restrict__ qkv,
                   const bf16* __restrict__ rel_h, const bf16* __restrict__ rel_w,
                   bf16* __restrict__ o, Geo g, float scale, int vec) {
  constexpr int kDT = 2 * kHK;  // 8-column tiles of the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = g.n, C = g.C, hd = g.hd, win = g.win, two = 2 * win - 1;
  const AttnPlan L = attn_plan(n, hd);
  const int np = L.np, ldh = L.ldh, hdp = L.hdp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = 3LL * C;
  const Work work = block_work(g.B * g.nwy * g.nwx * g.heads, L.tiles);

  bf16* srh = reinterpret_cast<bf16*>(smem + L.off_rel);
  bf16* srw = srh + kRel * ldh;
  int* stok = reinterpret_cast<int*>(smem + L.off_tok);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.off_bar);  // [2][kChunks + 1]
  uint64_t* empty = full + 2 * (kChunks + 1);                       // [2]
  auto kbuf = [&](int b) { return reinterpret_cast<bf16*>(smem + 2 * b * L.mat); };
  auto vbuf = [&](int b) { return reinterpret_cast<bf16*>(smem + (2 * b + 1) * L.mat); };

  // once: the barriers; where element copies fill the buffers, their
  // padding (rows past n, columns past hd); the tables, zero past
  // 2 win - 1 and hd;
  // each key's row (kPadKey past n) and column
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * (kChunks + 1); ++i) gemm::mbar_init(full + i, 1);
    for (int b = 0; b < 2; ++b) gemm::mbar_init(empty + b, 2 * L.pairs);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; !vec && e < 4 * np; e += blockDim.x) {
    const int r = e % np;
    bf16* row = reinterpret_cast<bf16*>(smem + (e / np) * L.mat) + r * ldh;
    for (int d = r < n ? hd : 0; d < ldh; ++d) row[d] = __float2bfloat16(0.0f);
  }
  for (int e = threadIdx.x; e < kRel * ldh; e += blockDim.x) {
    const int u = e / ldh, d = e % ldh;
    const bool in = u < two && d < hd;
    srh[e] = in ? rel_h[u * hd + d] : __float2bfloat16(0.0f);
    srw[e] = in ? rel_w[u * hd + d] : __float2bfloat16(0.0f);
  }
  for (int t = threadIdx.x; t < np; t += blockDim.x)
    stok[t] = (t < n ? t / win : kPadKey) | (t % win) << 16;
  __syncthreads();

  if (warp == 2 * L.pairs) {
    // producer: k and v of item j into buffer j % 2, k by chunks, once the
    // consumers are done with item j - 2
    for (int j = 0; j < work.items; ++j) {
      const int b = j & 1;
      if (j >= 2) gemm::mbar_wait(empty + b, ((j - 2) >> 1) & 1);
      int unit, t0, t1;
      work_item(work, L.tiles, j, unit, t0, t1);
      const bf16* src = qkv + static_cast<long long>(unit / g.heads) * n * stride +
                        (unit % g.heads) * hd;
      uint64_t* fb = full + b * (kChunks + 1);
      if (vec) {
        // boxes of 16 rows x ldh columns of qkv: rows past n are the next
        // window's (or zero past the end), columns past hd the next head's;
        // neither counts (-inf bias, p = 0, zero q columns, o columns < hd)
        constexpr uint32_t kBox = 16;
        const uint32_t box_bytes = kBox * ldh * 2;
        if (lane == 0) {
          for (int c = 0; c < kChunks; ++c)
            gemm::mbar_expect_tx(fb + c, max(0, min(kKC, np - c * kKC)) / kBox * box_bytes);
          gemm::mbar_expect_tx(fb + kChunks, np / kBox * box_bytes);
        }
        __syncwarp();
        const int row0 = (unit / g.heads) * n, col0 = (unit % g.heads) * hd;
        for (int bx = lane; bx < np / int(kBox); bx += 32) {
          gemm::tma_load(kbuf(b) + bx * kBox * ldh, &tqkv, fb + bx * kBox / kKC, C + col0,
                         row0 + bx * kBox);
          gemm::tma_load(vbuf(b) + bx * kBox * ldh, &tqkv, fb + kChunks, 2 * C + col0,
                         row0 + bx * kBox);
        }
      } else {
        for (int e = lane; e < n * hd; e += 32) {
          const int r = e / hd, d = e - r * hd;
          kbuf(b)[r * ldh + d] = src[C + r * stride + d];
          vbuf(b)[r * ldh + d] = src[2 * C + r * stride + d];
        }
        __syncwarp();
        if (lane == 0)
          for (int c = 0; c <= kChunks; ++c) gemm::mbar_arrive(fb + c);
      }
    }
    return;
  }

  // consumers: pair p (warps 2 p, 2 p + 1) takes query tiles t0 + p, t0 + p
  // + pairs, ... below t1 of each item; half h of the pair the keys of n16
  // tiles [k0, k0 + cnt)
  const int pair = warp >> 1, half = warp & 1;
  unsigned char* pbase = smem + L.off_pair + pair * L.pair_bytes;
  bf16* sq = reinterpret_cast<bf16*>(pbase);                      // q tile [16, ldh]
  uint32_t* sbias = reinterpret_cast<uint32_t*>(pbase + L.bias);  // then the bias tables
  bf16* so = reinterpret_cast<bf16*>(pbase + L.bias);             // then o [16, hdp]
  float* spart = reinterpret_cast<float*>(pbase);                 // f32 partial o [16, hdp]
  float* sstat = reinterpret_cast<float*>(pbase + L.stats);       // [half][max, sum][16 rows]
  const int g8 = lane >> 2, t4 = lane & 3;
  const uint32_t* bh = sbias + g8 * kBiasLD;
  const uint32_t* bw = bh + 8 * kBiasLD;
  const int kn16 = np / 16, half0 = (kn16 + 1) / 2;
  const int k0 = half ? half0 : 0, cnt = half ? kn16 - half0 : half0;
  for (int j = 0; j < work.items; ++j) {
    const int b = j & 1;
    const uint32_t ph = (j >> 1) & 1;
    int unit, t0, t1;
    work_item(work, L.tiles, j, unit, t0, t1);
    const int wglob = unit / g.heads, h = unit % g.heads;
    uint64_t* fb = full + b * (kChunks + 1);
    const bf16* sk = kbuf(b);
    const bf16* sv = vbuf(b);
    // a pair with no tile here waits until the buffer is filled, so an idle
    // warp never runs ahead and arrives for a later item early
    if (t0 + pair >= t1) gemm::mbar_wait(fb + kChunks, ph);
    for (int qt = t0 + pair; qt < t1; qt += L.pairs) {

    // q of the tile (half 1 loads it), its fragments in both warps
    if (half)
      load_q(sq, ldh,
             qkv + (static_cast<long long>(wglob) * n + qt * 16) * stride + h * hd, stride,
             n - qt * 16, hd, hdp, vec, lane);
    pair_sync(pair);
    uint32_t qa[kHK][4];
#pragma unroll
    for (int kk = 0; kk < kHK; ++kk)
      ldsm_x4(qa[kk], sq + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldh + kk * 16 +
                          (lane >> 4) * 8);

    // the table products q rel^T (half 0: rel_h, half 1: rel_w), rounded,
    // staged by the key's row (h) or column (w) in the window; padding rows
    // take a real row's
    {
      const int rq0 = min(qt * 16 + g8, n - 1), rq1 = min(qt * 16 + g8 + 8, n - 1);
      const bf16* rel = half ? srw : srh;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kHK; ++kk) {
#pragma unroll
        for (int up = 0; up < 2; ++up) {  // rows past 2 win - 1 are 0: no branch
          uint32_t bb[4];
          ldsm_x4(bb, rel + (up * 16 + (lane >> 4) * 8 + (lane & 7)) * ldh + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma16816(acc[2 * up], qa[kk], bb[0], bb[1]);
          mma16816(acc[2 * up + 1], qa[kk], bb[2], bb[3]);
        }
      }
      // entry u of row r holds q_r . rel[u]; the key index it serves is
      // (r's row or column in the window) - u + win - 1
      const int a0 = half ? rq0 % win : rq0 / win, a1 = half ? rq1 % win : rq1 / win;
      bf16* dst = reinterpret_cast<bf16*>(sbias + (half * 8 + g8) * kBiasLD);
#pragma unroll
      for (int u8 = 0; u8 < 4; ++u8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = u8 * 8 + 2 * t4 + (e & 1);
          const int key = (e < 2 ? a0 : a1) - u + win - 1;
          if (u < two && key >= 0 && key < win)
            dst[2 * key + (e >> 1)] = __float2bfloat16(acc[u8][e]);
        }
      }
      if (!half && t4 == 0) sbias[g8 * kBiasLD + kPadKey] = 0xff80ff80u;  // two bf16 -inf
    }
    pair_sync(pair);

    // S = q k^T over this half's keys (s[jt][e]: row g8 + 8 (e / 2), key
    // 16 k0 + 8 jt + 2 t4 + (e & 1)), the head-dim steps outermost. Past cnt
    // a half computes its last tile again (scored -inf below, so p = 0):
    // the loops carry no branch, and the products pipeline
    for (int i = 0; i < cnt; ++i) gemm::mbar_wait(fb + (k0 + i) * 16 / kKC, ph);
    int row[kHalfNT / 2];  // the first key of each 16-key tile
#pragma unroll
    for (int i = 0; i < kHalfNT / 2; ++i) row[i] = (cnt > 0 ? k0 + min(i, cnt - 1) : 0) * 16;
    const bf16* kl = sk + ((lane >> 4) * 8 + (lane & 7)) * ldh + ((lane >> 3) & 1) * 8;
    const bf16* vl = sv + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldh + (lane >> 4) * 8;
    float s[kHalfNT][4];
#pragma unroll
    for (int jt = 0; jt < kHalfNT; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kHK; ++kk) {
#pragma unroll
      for (int i = 0; i < kHalfNT / 2; ++i) {
        uint32_t bb[4];
        ldsm_x4(bb, kl + row[i] * ldh + kk * 16);
        mma16816(s[2 * i], qa[kk], bb[0], bb[1]);
        mma16816(s[2 * i + 1], qa[kk], bb[2], bb[3]);
      }
    }
    // scaled, the rounded bias added (stok: each key's row, kPadKey past n,
    // | its column << 16), so -inf past n; this half's max of each row
    float m4[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) m4[r][0] = m4[r][1] = m4[r][2] = m4[r][3] = -INFINITY;
#pragma unroll
    for (int jt = 0; jt < kHalfNT; ++jt) {
      const int col = k0 * 16 + jt * 8 + 2 * t4;
      if (jt < 2 * cnt) {
        const int2 tk = *reinterpret_cast<const int2*>(stok + col);  // keys col, col + 1
        const uint32_t h0 = bh[tk.x & 0xffff], w0 = bw[tk.x >> 16];
        const uint32_t h1 = bh[tk.y & 0xffff], w1 = bw[tk.y >> 16];
        s[jt][0] = fmaf(s[jt][0], scale, __uint_as_float(h0 << 16)) + __uint_as_float(w0 << 16);
        s[jt][1] = fmaf(s[jt][1], scale, __uint_as_float(h1 << 16)) + __uint_as_float(w1 << 16);
        s[jt][2] = fmaf(s[jt][2], scale, __uint_as_float(h0 & 0xffff0000u)) +
                   __uint_as_float(w0 & 0xffff0000u);
        s[jt][3] = fmaf(s[jt][3], scale, __uint_as_float(h1 & 0xffff0000u)) +
                   __uint_as_float(w1 & 0xffff0000u);
      } else {
        s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m4[r][jt & 3] = fmaxf(m4[r][jt & 3], fmaxf(s[jt][2 * r], s[jt][2 * r + 1]));
    }
    float m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(fmaxf(m4[r][0], m4[r][1]), fmaxf(m4[r][2], m4[r][3]));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    if (t4 == 0) {
      sstat[half * 32 + g8] = m[0];
      sstat[half * 32 + g8 + 8] = m[1];
    }
    pair_sync(pair);
    // softmax in f32 over the whole row: e = exp(s - max) = 2^(s log2e - max log2e)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mr = fmaxf(sstat[g8 + 8 * r], sstat[32 + g8 + 8 * r]);  // finite: a real key
      const float nb = -mr * kLog2e;
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jt = 0; jt < kHalfNT; ++jt) {
        s[jt][2 * r] = ex2(fmaf(s[jt][2 * r], kLog2e, nb));
        s[jt][2 * r + 1] = ex2(fmaf(s[jt][2 * r + 1], kLog2e, nb));
        t[jt & 3] += s[jt][2 * r] + s[jt][2 * r + 1];
      }
      float sum = (t[0] + t[1]) + (t[2] + t[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = sum;
    }
    if (t4 == 0) {
      sstat[half * 32 + 16 + g8] = inv[0];
      sstat[half * 32 + 16 + g8 + 8] = inv[1];
    }
    pair_sync(pair);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv[r] = 1.0f / (sstat[16 + g8 + 8 * r] + sstat[48 + g8 + 8 * r]);

    // this half's o = p v, p = round_bf16(e / sum) as the A operand
    gemm::mbar_wait(fb + kChunks, ph);
    float acc[kDT][4];
#pragma unroll
    for (int jd = 0; jd < kDT; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.0f;
#pragma unroll
    for (int i = 0; i < kHalfNT / 2; ++i) {  // past cnt p = 0: no branch
      uint32_t a[4];
      a[0] = pack2(s[2 * i][0] * inv[0], s[2 * i][1] * inv[0]);
      a[1] = pack2(s[2 * i][2] * inv[1], s[2 * i][3] * inv[1]);
      a[2] = pack2(s[2 * i + 1][0] * inv[0], s[2 * i + 1][1] * inv[0]);
      a[3] = pack2(s[2 * i + 1][2] * inv[1], s[2 * i + 1][3] * inv[1]);
#pragma unroll
      for (int dp = 0; dp < kHK; ++dp) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, vl + row[i] * ldh + dp * 16);
        mma16816(acc[2 * dp], a, bb[0], bb[1]);
        mma16816(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }

    // o = half 0's + half 1's partial sums (half 1 hands its over in f32
    // where the q tile and bias were), rounded, staged, written as 16-byte
    // stores in window order by half 0
    if (half) {
#pragma unroll
      for (int jd = 0; jd < kDT; ++jd) {
        *reinterpret_cast<float2*>(spart + g8 * hdp + jd * 8 + 2 * t4) =
            make_float2(acc[jd][0], acc[jd][1]);
        *reinterpret_cast<float2*>(spart + (g8 + 8) * hdp + jd * 8 + 2 * t4) =
            make_float2(acc[jd][2], acc[jd][3]);
      }
    }
    pair_sync(pair);
    if (!half) {
#pragma unroll
      for (int jd = 0; jd < kDT; ++jd) {
        const float2 u = *reinterpret_cast<const float2*>(spart + g8 * hdp + jd * 8 + 2 * t4);
        const float2 v = *reinterpret_cast<const float2*>(spart + (g8 + 8) * hdp + jd * 8 + 2 * t4);
        acc[jd][0] += u.x;
        acc[jd][1] += u.y;
        acc[jd][2] += v.x;
        acc[jd][3] += v.y;
      }
      __syncwarp();
#pragma unroll
      for (int jd = 0; jd < kDT; ++jd) {
        st32(so + g8 * hdp + jd * 8 + 2 * t4, acc[jd][0], acc[jd][1]);
        st32(so + (g8 + 8) * hdp + jd * 8 + 2 * t4, acc[jd][2], acc[jd][3]);
      }
      __syncwarp();
      bf16* dst = o + (static_cast<long long>(wglob) * n + qt * 16) * C + h * hd;
      const int rows = min(16, n - qt * 16);
      if (vec) {
        const int d8 = hd / 8;
        for (int e = lane; e < rows * d8; e += 32) {
          const int r = e / d8, d = (e - r * d8) * 8;
          *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * C + d) =
              *reinterpret_cast<const uint4*>(so + r * hdp + d);
        }
      } else {
        for (int e = lane; e < rows * hd; e += 32) {
          const int r = e / hd, d = e - r * hd;
          dst[static_cast<long long>(r) * C + d] = so[r * hdp + d];
        }
      }
    }
    pair_sync(pair);  // the pair's tiles are free for the next tile
    }
    // done with the buffer: order this warp's reads of it before the TMA
    // writes that refill it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) gemm::mbar_arrive(empty + b);
  }
}

// ---- 3. f32 attention: one block per (window, head), SIMT; q, k, v [n, hd]
// in shared memory (190 KB at hd 80), then 16 query rows at a time: the
// scores and the two table products q rel^T, the bias gathered per (i, j),
// softmax in f32, p v.
constexpr int kQT32 = 16;       // query rows a tile
constexpr int kLDR = kRel + 4;  // row stride of the q @ rel^T products

struct Smem32 {
  int ldh;  // row stride of q, k, v
  int lds;  // row stride of a scores tile
  size_t mat, off_r0, off_ph, off_pw, total;
};

__host__ __device__ inline Smem32 smem32(int n, int hd) {
  Smem32 s;
  s.ldh = hd + 1;
  s.lds = ((n + 15) & ~15) + 4;
  s.mat = round128(size_t(n) * s.ldh * sizeof(float));
  s.off_r0 = 3 * s.mat;
  const size_t scores = round128(size_t(kQT32) * s.lds * 4);
  const size_t rel = round128(size_t(kQT32) * kLDR * 4);
  s.off_ph = s.off_r0 + scores;
  s.off_pw = s.off_ph + rel;
  s.total = s.off_pw + rel;
  return s;
}

__global__ void __launch_bounds__(kThreads)
relpos_attn_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                       const float* __restrict__ rel_w, float* __restrict__ o, Geo g,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = g.n, C = g.C, hd = g.hd, win = g.win;
  const Smem32 L = smem32(n, hd);
  const int LDH = L.ldh, LDS = L.lds;
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + L.off_r0);
  float* s_ph = reinterpret_cast<float*>(smem + L.off_ph);
  float* s_pw = reinterpret_cast<float*>(smem + L.off_pw);
  const int wglob = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int two = 2 * win - 1;
  const int MW = int(L.mat / sizeof(float));  // elements between q, k and v

  // q | k | v of this head
  const float* src = qkv + static_cast<long long>(wglob) * n * 3 * C + h * hd;
  for (int e = tid; e < n * 3 * hd; e += kThreads) {
    const int t = e / (3 * hd), which = (e / hd) % 3, d = e % hd;
    s_q[which * MW + t * LDH + d] = src[static_cast<long long>(t) * 3 * C + which * C + d];
  }
  __syncthreads();
  const float* s_k = s_q + MW;
  const float* s_v = s_q + 2 * MW;

  float* orow = o + static_cast<long long>(wglob) * n * C + h * hd;
  for (int q0 = 0; q0 < n; q0 += kQT32) {
    const int nrow = min(kQT32, n - q0);
    for (int e = tid; e < nrow * 2 * two; e += kThreads) {
      const int i = e / (2 * two), u = e % (2 * two);
      const float* q = s_q + (q0 + i) * LDH;
      const float* rel = (u < two ? rel_h + u * hd : rel_w + (u - two) * hd);
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot += q[d] * rel[d];
      (u < two ? s_ph : s_pw)[i * kLDR + (u < two ? u : u - two)] = dot;
    }
    for (int e = tid; e < nrow * n; e += kThreads) {
      const int i = e / n, j = e % n;
      const float* q = s_q + (q0 + i) * LDH;
      const float* kr = s_k + j * LDH;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot += q[d] * kr[d];
      s_s[i * LDS + j] = dot;
    }
    __syncthreads();

    // scores + bias, softmax in f32, one warp per row; p in place
    for (int i = warp; i < nrow; i += kWarps) {
      float* sr = s_s + i * LDS;
      const float* ph = s_ph + i * kLDR + (q0 + i) / win + win - 1;
      const float* pw = s_pw + i * kLDR + (q0 + i) % win + win - 1;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        const float s = sr[j] * scale + ph[-(j / win)] + pw[-(j % win)];
        sr[j] = s;
        m = fmaxf(m, s);
      }
      for (int d = 16; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float ev = expf(sr[j] - m);
        sr[j] = ev;
        sum += ev;
      }
      for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
      for (int j = lane; j < n; j += 32) sr[j] /= sum;
    }
    __syncthreads();

    // o = p v, this head's columns, window order
    for (int e = tid; e < nrow * hd; e += kThreads) {
      const int i = e / hd, d = e % hd;
      const float* pr = s_s + i * LDS;
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc += pr[j] * s_v[j * LDH + d];
      orow[static_cast<long long>(q0 + i) * C + d] = acc;
    }
    __syncthreads();
  }
}

int launch_attn_bf16(const void* qkv, const void* rel_h, const void* rel_w, void* o, const Geo& g,
                     float scale, cudaStream_t stream) {
  const AttnPlan p = attn_plan(g.n, g.hd);
  // TMA and 16-byte copies need rows and tables that start on 16 bytes
  const int vec = g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(qkv) && aligned16(o) &&
                  aligned16(rel_h) && aligned16(rel_w);
  auto kernel = p.hdp <= 16   ? relpos_attn_kernel<1>
                : p.hdp <= 32 ? relpos_attn_kernel<2>
                : p.hdp <= 48 ? relpos_attn_kernel<3>
                : p.hdp <= 64 ? relpos_attn_kernel<4>
                              : relpos_attn_kernel<5>;
  // qkv [M, 3C] in boxes of 16 rows x ldh columns, no swizzle (rows land
  // ldh apart, as ldmatrix reads them)
  CUtensorMap tqkv{};
  if (vec) {
    const gemm::EncodeTiled fn = gemm::encode_tiled();
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {cuuint64_t(3) * g.C, cuuint64_t(g.B) * g.nwy * g.nwx * g.n};
    const cuuint64_t strides[1] = {cuuint64_t(3) * g.C * 2};
    const cuuint32_t box[2] = {cuuint32_t(p.ldh), 16};
    const cuuint32_t elem[2] = {1, 1};
    if (fn(&tqkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(qkv), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(p.total))) != cudaSuccess)
    return static_cast<int>(err);
  // one block an SM, at most one a query tile of the work
  const long long tiles = static_cast<long long>(g.B) * g.nwy * g.nwx * g.heads * p.tiles;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, (2 * p.pairs + 1) * 32, p.total, stream>>>(
      tqkv, static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<bf16*>(o), g, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_attn_f32(const void* qkv, const void* rel_h, const void* rel_w, void* o, const Geo& g,
                    float scale, cudaStream_t stream) {
  const size_t smem = smem32(g.n, g.hd).total;
  const cudaError_t err = cudaFuncSetAttribute(
      relpos_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_attn_f32_kernel<<<dim3(g.B * g.nwy * g.nwx, g.heads), kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(o), g, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename T>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* wqkv, const void* bqkv,
           const void* rel_h, const void* rel_w, void* stats, void* qkv, void* o, const Geo& g,
           float eps, float scale, cudaStream_t stream) {
  // 1 + 2: the LN pass and the qkv GEMM shared with window_attn.cu
  // bf16: the LN rows go to o, which the attention overwrites once the GEMM has read them
  const int err = launch_ln_qkv<TX, T>(x, ln_g, ln_b, wqkv, bqkv, stats, o, qkv, g, eps, stream);
  if (err != 0) return err;
  return std::is_same<T, bf16>::value ? launch_attn_bf16(qkv, rel_h, rel_w, o, g, scale, stream)
                                      : launch_attn_f32(qkv, rel_h, rel_w, o, g, scale, stream);
}

}  // namespace

// LN + qkv + per-head rel-pos window attention: three kernels, one call.
// x [B, H, W, C] (f32, or bf16 when the compute type is bf16), ln_g / ln_b
// [C] f32, wqkv [3C, C] of the compute type, bqkv [3C] f32, rel_h / rel_w
// [2 win - 1, C / heads] of the compute type, o [B * nW * n, C] of the
// compute type (window order), all contiguous on the device (bf16: 16-byte
// aligned, C % 8 == 0, C <= 2048). Scratch the caller allocates: stats
// [2 * B * H * W] f32 (f32 only), qkv [B * nW * n, 3C] of the compute type.
// compute_bf16 / x_bf16: 0 = f32, 1 = bf16; scale = head_dim^-1/2, applied
// to q . k in f32 after the dot. win <= 14, head_dim <= 80. Launches on
// `stream`; returns the cudaError_t of the first launch that failed.
extern "C" int window_attn_relpos_heads_launch(int compute_bf16, int x_bf16, const void* x,
                                               const void* ln_g, const void* ln_b,
                                               const void* wqkv, const void* bqkv,
                                               const void* rel_h, const void* rel_w,
                                               void* stats, void* qkv, void* o, int B, int H,
                                               int W, int C, int heads, int win, float eps,
                                               float scale, void* stream) {
  const Geo g = make_geo(B, H, W, C, heads, win, 0);
  if (g.n > kMaxTokens || g.hd > kMaxHd || 2 * win - 1 > kRel)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    if (x_bf16)
      return launch<bf16, bf16>(x, ln_g, ln_b, wqkv, bqkv, rel_h, rel_w, stats, qkv, o, g, eps,
                                scale, s);
    return launch<float, bf16>(x, ln_g, ln_b, wqkv, bqkv, rel_h, rel_w, stats, qkv, o, g, eps,
                               scale, s);
  }
  if (x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, float>(x, ln_g, ln_b, wqkv, bqkv, rel_h, rel_w, stats, qkv, o, g, eps,
                              scale, s);
}
