// Fused Swin window attention (sm_90a): the attention branch of a Swin
// block, [B, H, W, C] -> [B, H, W, C] before the residual.
//
// Replaces the TPU kernel cm3d_tpu/kernels/window_attn_pallas.py:303
// fused_window_attn (_wattn_kernel), together with the pad / roll / crop
// that models/swin.py _fused_branch_impl wraps around it:
//
//   pad H, W to multiples of win; roll by -shift; per window of n = win^2
//   tokens: LN (f32, two-pass variance; padding tokens exactly 0 after the
//   LN) -> qkv = LN @ Wqkv^T + bqkv -> per head s = (q k^T) * hd^-1/2 +
//   B_rel[h] (+ the 0 / -100 shifted-window mask) -> softmax -> o = p v
//   -> out = o @ Wproj^T + bproj; roll back by +shift; crop to [H, W].
//
// Rounding follows the TPU kernel: LN out, qkv, p, o and out are rounded to
// the compute type T (bf16 or f32); every sum is taken in f32.
//
// Bound on the H100: 8 C^2 (qkv + proj) + 4 n C (q k^T + p v) operations a
// token, against a few tens of MB of input, weights and output per launch:
// operations bind the first launch, bytes the projection; about 0.9 ms per
// Detic forward over 6 cameras at 1024x576 in all. The TPU's interleaved
// block-diagonal [T, T] attention over G windows (expand_bias_interleaved,
// pick_group) only kept its matrix unit's tiles large and wasted a factor G
// of flops; here every window's n x n problem is computed by itself.
//
// Design. Two launcher calls per block, each its own wrapper and counter:
//  1. window_attn_heads_launch queues three kernels:
//     a. bf16: ln_rows_kernel (window_attn_common.cuh): round_bf16(LN(x))
//        in window order through the shift-aware token_offset (a padding
//        token's row is 0, so its qkv is the bias), into o. f32:
//        ln_stats_kernel, mean and rstd of every real token.
//     b. qkv_gemm_kernel (window_attn_common.cuh): ONE GEMM over all
//        windows' tokens in window order, [M = B Hp Wp, C] x [C, 3C] + bqkv
//        into the scratch qkv [M, 3C] of T; bf16 on wgmma with TMA operand
//        tiles, a persistent warp-specialised kernel (f32: SIMT tiles that
//        gather and normalise x as they load). The same GEMM serves SAM's
//        rel-pos blocks (window_attn_relpos.cu, shift 0).
//     c. window_attn_core_kernel: one block per (window, group of heads),
//        one warp per (head, 16 query rows): q, k and v^T of the group in
//        shared memory from 16-byte loads of qkv; S = q k^T on mma.sync
//        m16n8k16 (n padded to 16, head dim to 16) in f32 registers; scale,
//        the table bias and the shift mask (region ids) added there; softmax
//        in registers across the quad; p rounded to bf16 and fed straight
//        back as the A operand of o = p v (mma.sync again); o rounded, staged
//        in the warp's own q rows and written as 16-byte stores per row.
//        f32: window_attn_core_f32_kernel, one block per (window, head),
//        SIMT, q / k / v and the scores in shared memory.
//     Before this cut one block per (window, head) re-read its window's x,
//     re-took its LN statistics and re-streamed its 96 rows of Wqkv per
//     head (16x at Swin-B's stage 2), on scalar loads, with SIMT scores:
//     54.9 ms per Detic forward at 89x its bound.
//  2. window_attn_proj_launch: proj_gemm_kernel, the same GEMM with A = o
//     (bf16: both operands by TMA) whose epilogue adds the bias, rounds and
//     writes each real token's slice of the tile to its place in
//     [B, H, W, C] (one token_offset per row, 16-byte stores); padding
//     tokens are dropped there. No cap on n or C; SAM uses it with shift 0.
// The pad, roll and crop live in the addressing; the qkv round trip costs
// 6 M C bytes of HBM a block (54 MB at Swin-B's stage 2, about 0.03 ms),
// the bf16 LN rows 4 M C more.
// What bounded it before the GEMM moved onto wgmma (9.3 ms per Detic forward
// against a 0.62 ms bound): the qkv GEMM at about 140 TFLOP/s on mma.sync,
// half of the time, and the attention blocks' load latency (few blocks an
// SM, one barrier between the loads and the products).

#include <cmath>

#include "window_attn_common.cuh"

namespace {

using namespace wattn;

constexpr int kTok = 64;        // tokens a window holds (win^2 <= 64), padded to 16
constexpr int kMaxHd = 64;      // head dim
constexpr int kTab = 225;       // entries of a table column, (2 win - 1)^2 for win <= 8
constexpr int kLDV = kTok + 8;  // row stride of v^T (keys)

// Shared-memory layout of the bf16 attention kernel, the same on host and device
struct CoreSmem {
  int np;      // tokens padded to 16
  int hdp;     // head dim padded to 16
  int ldh;     // row stride of q and k
  int G;       // heads a block
  size_t qk;   // bytes of one of q, k
  size_t head; // bytes of one head's q | k | v^T
  size_t off_heads, total;
};

__host__ __device__ inline CoreSmem core_smem(int n, int hd, int heads) {
  CoreSmem s;
  s.np = (n + 15) & ~15;
  s.hdp = (hd + 15) & ~15;
  s.ldh = s.hdp + 8;
  const int per = kWarps / (s.np / 16);  // one warp per (head, 16 query rows)
  s.G = per < heads ? per : heads;
  s.qk = round128(size_t(s.np) * s.ldh * sizeof(bf16));
  s.head = 2 * s.qk + round128(size_t(s.hdp) * kLDV * sizeof(bf16));
  s.off_heads = 3 * kTok * sizeof(int) + round128(size_t(s.G) * kTab * sizeof(float));
  s.off_heads = round128(s.off_heads);
  s.total = s.off_heads + s.G * s.head;
  return s;
}

// kKT8 / kDT: the most key / head-dim 8-column tiles the instance holds
// (registers scale with them)
template <int kKT8, int kDT>
__global__ void __launch_bounds__(kThreads, 3)
window_attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ table,
                        bf16* __restrict__ o, Geo g, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const CoreSmem L = core_smem(g.n, g.hd, g.heads);
  int* s_ry = reinterpret_cast<int*>(smem);
  int* s_rx = s_ry + kTok;
  int* s_reg = s_rx + kTok;
  float* s_tab = reinterpret_cast<float*>(smem + 3 * kTok * sizeof(int));
  const int n = g.n, C = g.C, hd = g.hd, win = g.win, two = 2 * win - 1;
  const int wglob = blockIdx.x, h0 = blockIdx.y * L.G;
  const int nwin = g.nwy * g.nwx, wl = wglob % nwin;
  const int wy = wl / g.nwx, wx = wl % g.nwx;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldh = L.ldh;
  auto head_q = [&](int gh) {
    return reinterpret_cast<bf16*>(smem + L.off_heads + gh * L.head);
  };

  // token rows / columns in the window and their shift-mask regions
  if (tid < kTok) {
    const int ry = tid / win, rx = tid % win;
    int reg = 0;
    if (g.shift > 0 && tid < n)
      reg = 3 * region(wy * win + ry, g.Hp, win, g.shift) +
            region(wx * win + rx, g.Wp, win, g.shift);
    s_ry[tid] = ry;
    s_rx[tid] = rx;
    s_reg[tid] = reg;
  }
  for (int e = tid; e < L.G * two * two; e += kThreads) {
    const int gh = e / (two * two), idx = e % (two * two), h = h0 + gh;
    s_tab[gh * kTab + idx] = h < g.heads ? table[idx * g.heads + h] : 0.0f;
  }
  // q, k (rows = tokens) and v^T (rows = head dims) of the group's heads;
  // padding rows and columns are 0
  const bf16* src = qkv + static_cast<long long>(wglob) * n * 3 * C;
  if (vec) {
    // 16-byte chunks; row r = 3 t + which of the group (q, k, v of token t)
    // holds a run of the G heads' chunks. A thread walks its chunks with
    // the indices stepped, not divided; four loads in flight before their
    // stores.
    const int D8 = L.hdp / 8, run = L.G * D8, rows = 3 * L.np;
    const int dc = kThreads % run, dr = kThreads / run;
    int c = tid % run, r = tid / run;
    while (r < rows) {
      uint4 v[4];
      int cs[4], rs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cs[u] = c;
        rs[u] = r;
        v[u] = make_uint4(0, 0, 0, 0);
        const int t = r / 3, which = r - 3 * t;
        const int h = h0 + c / D8, d = (c % D8) * 8;
        if (r < rows && h < g.heads && t < n && d < hd)
          v[u] = *reinterpret_cast<const uint4*>(src + static_cast<long long>(t) * 3 * C +
                                                 which * C + h * hd + d);
        c += dc;
        r += dr;
        if (c >= run) {
          c -= run;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (rs[u] >= rows) continue;
        const int t = rs[u] / 3, which = rs[u] - 3 * t;
        const int gh = cs[u] / D8, d = (cs[u] % D8) * 8;
        bf16* base = head_q(gh);
        if (which < 2) {
          *reinterpret_cast<uint4*>(base + (which * L.qk) / sizeof(bf16) + t * ldh + d) = v[u];
        } else {
          bf16* vt = base + (2 * L.qk) / sizeof(bf16);
          const bf16* ve = reinterpret_cast<const bf16*>(&v[u]);
#pragma unroll
          for (int i = 0; i < 8; ++i) vt[(d + i) * kLDV + t] = ve[i];
        }
      }
    }
  } else {
    const int run = L.G * L.hdp;
    for (int e = tid; e < L.np * 3 * run; e += kThreads) {
      const int c = e % run, which = (e / run) % 3, t = e / (3 * run);
      const int gh = c / L.hdp, d = c % L.hdp, h = h0 + gh;
      bf16 v = __float2bfloat16(0.0f);
      if (h < g.heads && t < n && d < hd)
        v = src[static_cast<long long>(t) * 3 * C + which * C + h * hd + d];
      bf16* base = head_q(gh);
      if (which < 2)
        base[(which * L.qk) / sizeof(bf16) + t * ldh + d] = v;
      else
        base[(2 * L.qk) / sizeof(bf16) + d * kLDV + t] = v;
    }
  }
  __syncthreads();

  const int QT = L.np / 16, gh = warp / QT, qt = warp % QT, h = h0 + gh;
  if (gh >= L.G || h >= g.heads) return;
  bf16* sq = head_q(gh);
  const bf16* sk = sq + L.qk / sizeof(bf16);
  const bf16* svt = sq + (2 * L.qk) / sizeof(bf16);
  const float* tab = s_tab + gh * kTab;
  const int KT8 = L.np / 8, HK = L.hdp / 16, DT = L.hdp / 8;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = qt * 16 + g8, r1 = r0 + 8;

  // S = q k^T, rows r0 / r1, key columns 8 j + 2 t4 (+1)
  float s[kKT8][4];
#pragma unroll
  for (int j = 0; j < kKT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kDT / 2; ++kk) {
    if (kk < HK) {
      uint32_t a[4];
      a[0] = ld32(sq + r0 * ldh + kk * 16 + 2 * t4);
      a[1] = ld32(sq + r1 * ldh + kk * 16 + 2 * t4);
      a[2] = ld32(sq + r0 * ldh + kk * 16 + 8 + 2 * t4);
      a[3] = ld32(sq + r1 * ldh + kk * 16 + 8 + 2 * t4);
#pragma unroll
      for (int j = 0; j < kKT8; ++j) {
        if (j < KT8) {
          const bf16* kr = sk + (j * 8 + g8) * ldh + kk * 16 + 2 * t4;
          mma16816(s[j], a, ld32(kr), ld32(kr + 8));
        }
      }
    }
  }

  // scale, table bias, shift mask; softmax over the row (the quad's 4 lanes)
  const int q0 = r0 < n ? r0 : n - 1, q1 = r1 < n ? r1 : n - 1;  // padding rows: any real index
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKT8; ++j) {
    if (j < KT8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? q0 : q1, col = j * 8 + 2 * t4 + (e & 1);
        float v = -INFINITY;
        if (col < n) {
          const int idx = (s_ry[row] - s_ry[col] + win - 1) * two + (s_rx[row] - s_rx[col] + win - 1);
          v = s[j][e] * scale + tab[idx];
          if (g.shift > 0 && s_reg[row] != s_reg[col]) v += -100.0f;
        }
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < kKT8; ++j) {
    if (j < KT8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = expf(s[j][e] - mx[e >> 1]);
        s[j][e] = ev;
        sum[e >> 1] += ev;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }

  // o = p v: p (rounded to bf16) is the A operand as the S tiles hold it
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kKT8 / 2; ++kk) {
    if (kk < L.np / 16) {
      uint32_t a[4];
      a[0] = pack2(s[2 * kk][0] / sum[0], s[2 * kk][1] / sum[0]);
      a[1] = pack2(s[2 * kk][2] / sum[1], s[2 * kk][3] / sum[1]);
      a[2] = pack2(s[2 * kk + 1][0] / sum[0], s[2 * kk + 1][1] / sum[0]);
      a[3] = pack2(s[2 * kk + 1][2] / sum[1], s[2 * kk + 1][3] / sum[1]);
#pragma unroll
      for (int jd = 0; jd < kDT; ++jd) {
        if (jd < DT) {
          const bf16* vr = svt + (jd * 8 + g8) * kLDV + kk * 16 + 2 * t4;
          mma16816(acc[jd], a, ld32(vr), ld32(vr + 8));
        }
      }
    }
  }

  // o rounded, staged in this warp's own q rows, then a row's hd values
  // as 16-byte stores in window order
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < kDT; ++jd) {
    if (jd < DT) {
      st32(sq + r0 * ldh + jd * 8 + 2 * t4, acc[jd][0], acc[jd][1]);
      st32(sq + r1 * ldh + jd * 8 + 2 * t4, acc[jd][2], acc[jd][3]);
    }
  }
  __syncwarp();
  bf16* dst = o + static_cast<long long>(wglob) * n * C + h * hd;
  if (vec) {
    const int D8 = hd / 8;
    for (int c = lane; c < 16 * D8; c += 32) {
      const int row = qt * 16 + c / D8, d = (c % D8) * 8;
      if (row < n)
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(row) * C + d) =
            *reinterpret_cast<const uint4*>(sq + row * ldh + d);
    }
  } else {
    for (int c = lane; c < 16 * hd; c += 32) {
      const int row = qt * 16 + c / hd, d = c % hd;
      if (row < n) dst[static_cast<long long>(row) * C + d] = sq[row * ldh + d];
    }
  }
}

// f32: one block per (window, head), SIMT; q | k | v rows [n, 3 hd] and the
// scores [n, n] in shared memory
__host__ __device__ inline size_t core_f32_smem(int hd) {
  return (size_t(kTok) * (3 * hd + 1) + size_t(kTok) * (kTok + 1)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
window_attn_core_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ table,
                            float* __restrict__ o, Geo g, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = g.n, C = g.C, hd = g.hd, win = g.win, nq = 3 * hd, LQ = nq + 1;
  float* s_qkv = reinterpret_cast<float*>(smem);
  float* s_s = s_qkv + kTok * LQ;
  const int wglob = blockIdx.x, h = blockIdx.y;
  const int nwin = g.nwy * g.nwx, wl = wglob % nwin;
  const int wy = wl / g.nwx, wx = wl % g.nwx;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* src = qkv + static_cast<long long>(wglob) * n * 3 * C + h * hd;
  if (vec) {  // float4 chunks: row r = 3 t + which holds hd / 4 of them
    const int run = hd / 4, rows = 3 * n;
    const int dc = kThreads % run, dr = kThreads / run;
    int c = tid % run, r = tid / run;
    while (r < rows) {
      float4 v[4];
      int cs[4], rs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cs[u] = c;
        rs[u] = r;
        const int t = r / 3, which = r - 3 * t;
        if (r < rows)
          v[u] = *reinterpret_cast<const float4*>(src + static_cast<long long>(t) * 3 * C +
                                                  which * C + 4 * c);
        c += dc;
        r += dr;
        if (c >= run) {
          c -= run;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (rs[u] >= rows) continue;
        const int t = rs[u] / 3, which = rs[u] - 3 * t;
        float* dst = s_qkv + t * LQ + which * hd + 4 * cs[u];
        dst[0] = v[u].x;
        dst[1] = v[u].y;
        dst[2] = v[u].z;
        dst[3] = v[u].w;
      }
    }
  } else {
    for (int e = tid; e < n * nq; e += kThreads) {
      const int t = e / nq, j = e % nq;
      s_qkv[t * LQ + j] = src[static_cast<long long>(t) * 3 * C + (j / hd) * C + j % hd];
    }
  }
  __syncthreads();

  // scores: (q . k) * scale + B_rel[h] (+ shift mask)
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    const float* q = s_qkv + i * LQ;
    const float* kr = s_qkv + j * LQ + hd;
    float dot = 0.0f;
    for (int d = 0; d < hd; ++d) dot += q[d] * kr[d];
    const int yi = i / win, xi = i % win, yj = j / win, xj = j % win;
    const int idx = (yi - yj + win - 1) * (2 * win - 1) + (xi - xj + win - 1);
    float s = dot * scale + table[idx * g.heads + h];
    if (g.shift > 0) {
      const int ri = 3 * region(wy * win + yi, g.Hp, win, g.shift) +
                     region(wx * win + xi, g.Wp, win, g.shift);
      const int rj = 3 * region(wy * win + yj, g.Hp, win, g.shift) +
                     region(wx * win + xj, g.Wp, win, g.shift);
      if (ri != rj) s += -100.0f;
    }
    s_s[i * (kTok + 1) + j] = s;
  }
  __syncthreads();

  // softmax in f32, one warp per row
  for (int i = warp; i < n; i += kWarps) {
    float* sr = s_s + i * (kTok + 1);
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sr[j]);
    for (int d = 16; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float ev = expf(sr[j] - m);
      sr[j] = ev;
      sum += ev;
    }
    for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
    for (int j = lane; j < n; j += 32) sr[j] = sr[j] / sum;
  }
  __syncthreads();

  // o = p v, this head's columns, window order
  float* orow = o + static_cast<long long>(wglob) * n * C + h * hd;
  for (int e = tid; e < n * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    const float* pr = s_s + i * (kTok + 1);
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc += pr[j] * s_qkv[j * LQ + 2 * hd + d];
    orow[static_cast<long long>(i) * C + d] = acc;
  }
}

// The projection: out[row_offset(m)] = o[m] @ Wproj^T + bproj, padding
// rows dropped. bf16: o and Wproj as the tensor maps ta / tw.
template <typename T, int BN = 128>
__global__ void __launch_bounds__(GemmLaunch<T>::kBlock, GemmLaunch<T>::kMinBlocks)
proj_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                 const T* __restrict__ o, const T* __restrict__ wproj,
                 const float* __restrict__ bproj, T* __restrict__ out, Geo g, int M) {
  if constexpr (std::is_same<T, bf16>::value) {
    extern __shared__ __align__(128) unsigned char smem[];
    gemm::gemm_bf16<true, BN>(&ta, &tw, bproj, out, g, M, g.C, g.C, smem);
  } else {
    gemm::tile_f32<false>(o, nullptr, nullptr, nullptr, 0, wproj, bproj, out, g, M, g.C, g.C);
  }
}

template <typename TX, typename T>
int launch_heads(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                 const void* bqkv, const void* table, void* stats, void* qkv, void* o,
                 const Geo& g, float eps, float scale, cudaStream_t stream) {
  // bf16: the LN rows go to o, which the attention overwrites once the GEMM has read them
  int err = launch_ln_qkv<TX, T>(x, ln_g, ln_b, wqkv, bqkv, stats, o, qkv, g, eps, stream);
  if (err != 0) return err;
  const int windows = g.B * g.nwy * g.nwx;
  if constexpr (std::is_same<T, bf16>::value) {
    const CoreSmem L = core_smem(g.n, g.hd, g.heads);
    const int vec = g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(qkv) && aligned16(o);
    // instances by the tiles they hold: keys <= 32 or 64, head dim <= 32 or 64
    auto kernel = L.np <= 32 ? (L.hdp <= 32 ? window_attn_core_kernel<4, 4>
                                            : window_attn_core_kernel<4, 8>)
                             : (L.hdp <= 32 ? window_attn_core_kernel<8, 4>
                                            : window_attn_core_kernel<8, 8>);
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(windows, (g.heads + L.G - 1) / L.G);
    kernel<<<grid, kThreads, L.total, stream>>>(static_cast<const bf16*>(qkv),
                                                static_cast<const float*>(table),
                                                static_cast<bf16*>(o), g, scale, vec);
  } else {
    const size_t smem = core_f32_smem(g.hd);
    cudaError_t e = cudaFuncSetAttribute(window_attn_core_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(windows, g.heads);
    const int vec = g.C % 4 == 0 && g.hd % 4 == 0 && aligned16(qkv);
    window_attn_core_f32_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(table),
        static_cast<float*>(o), g, scale, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_proj_bf16(const gemm::Plan& p, const void* bproj, void* out, const Geo& g, int M,
                     cudaStream_t stream) {
  auto kernel = proj_gemm_kernel<bf16, BN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(gemm::Tile<BN>::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<p.grid, gemm::kWgThreads, gemm::Tile<BN>::kSmem, stream>>>(
      p.ta, p.tw, nullptr, nullptr, static_cast<const float*>(bproj), static_cast<bf16*>(out), g,
      M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_proj(const void* o, const void* wproj, const void* bproj, void* out, const Geo& g,
                cudaStream_t stream) {
  const int M = g.B * g.nwy * g.nwx * g.n;
  if constexpr (std::is_same<T, bf16>::value) {
    if (g.C % 8 != 0 || !aligned16(o) || !aligned16(wproj) || !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    const gemm::Plan p = gemm::plan_bf16(o, wproj, M, g.C, g.C);
    if (p.err != 0) return p.err;
    return p.bn == 256 ? launch_proj_bf16<256>(p, bproj, out, g, M, stream)
                       : launch_proj_bf16<128>(p, bproj, out, g, M, stream);
  } else {
    const dim3 grid((M + gemm::kSBM - 1) / gemm::kSBM, (g.C + gemm::kSBN - 1) / gemm::kSBN);
    proj_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
        CUtensorMap{}, CUtensorMap{}, static_cast<const T*>(o), static_cast<const T*>(wproj),
        static_cast<const float*>(bproj), static_cast<T*>(out), g, M);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// LN + qkv + per-head windowed attention: three kernels, one call. x
// [B, H, W, C] (f32, or bf16 when the compute type is bf16), ln_g / ln_b
// [C] f32, wqkv [3C, C] of the compute type, bqkv [3C] f32, table
// [(2 win - 1)^2, heads] f32, o [B * nW * n, C] of the compute type (window
// order), all contiguous on the device (bf16: 16-byte aligned, C % 8 == 0,
// C <= 2048). Scratch the caller allocates: stats [2 * B * H * W] f32 (f32
// only), qkv [B * nW * n, 3C] of the compute type.
// compute_bf16 / x_bf16: 0 = f32, 1 = bf16; scale = head_dim^-1/2, applied
// to q . k in f32 after the dot. win^2 <= 64, head_dim <= 64. Launches on
// `stream`; returns the cudaError_t of the first launch that failed.
extern "C" int window_attn_heads_launch(int compute_bf16, int x_bf16, const void* x,
                                        const void* ln_g, const void* ln_b, const void* wqkv,
                                        const void* bqkv, const void* table, void* stats,
                                        void* qkv, void* o, int B, int H, int W, int C,
                                        int heads, int win, int shift, float eps, float scale,
                                        void* stream) {
  const Geo g = make_geo(B, H, W, C, heads, win, shift);
  if (g.n > kTok || g.hd > kMaxHd || (2 * win - 1) * (2 * win - 1) > kTab)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    if (x_bf16)
      return launch_heads<bf16, bf16>(x, ln_g, ln_b, wqkv, bqkv, table, stats, qkv, o, g, eps,
                                      scale, s);
    return launch_heads<float, bf16>(x, ln_g, ln_b, wqkv, bqkv, table, stats, qkv, o, g, eps,
                                     scale, s);
  }
  if (x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_heads<float, float>(x, ln_g, ln_b, wqkv, bqkv, table, stats, qkv, o, g, eps,
                                    scale, s);
}

// The heads launcher's qkv product alone (LN, then the GEMM): qkv
// [B * nW * n, 3C] of the compute type in window order. Scratch: stats
// [2 * B * H * W] f32 (f32) or lnx [B * nW * n, C] bf16 (bf16). For tests
// and measurement; the main path runs it inside window_attn_heads_launch.
extern "C" int window_attn_qkv_launch(int compute_bf16, int x_bf16, const void* x,
                                      const void* ln_g, const void* ln_b, const void* wqkv,
                                      const void* bqkv, void* stats, void* lnx, void* qkv, int B,
                                      int H, int W, int C, int win, int shift, float eps,
                                      void* stream) {
  const Geo g = make_geo(B, H, W, C, 1, win, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    if (x_bf16)
      return launch_ln_qkv<bf16, bf16>(x, ln_g, ln_b, wqkv, bqkv, stats, lnx, qkv, g, eps, s);
    return launch_ln_qkv<float, bf16>(x, ln_g, ln_b, wqkv, bqkv, stats, lnx, qkv, g, eps, s);
  }
  if (x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ln_qkv<float, float>(x, ln_g, ln_b, wqkv, bqkv, stats, lnx, qkv, g, eps, s);
}

// Output projection + scatter. o [B * nW * n, C], wproj [C, C] of the
// compute type, bproj [C] f32, out [B, H, W, C] of the compute type.
extern "C" int window_attn_proj_launch(int compute_bf16, const void* o, const void* wproj,
                                       const void* bproj, void* out, int B, int H, int W, int C,
                                       int heads, int win, int shift, void* stream) {
  const Geo g = make_geo(B, H, W, C, heads, win, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) return launch_proj<bf16>(o, wproj, bproj, out, g, s);
  return launch_proj<float>(o, wproj, bproj, out, g, s);
}
