// Pieces shared by the two fused window-attention sources
// (window_attn.cu: Swin's table bias; window_attn_relpos.cu: SAM's
// decomposed relative-position bias): type conversion, the window geometry
// and its addressing, the per-token LayerNorm statistics, and the GEMM that
// both sources run twice per block, once as the qkv product (A gathered from
// x and normalised as it loads, rows in window order) and once as the output
// projection (A = o in window order, rows scattered back to image order).
//
// The GEMM (bf16): 128 x 128 output tiles, K chunks of 32, 8 warps of
// 32 x 64 on mma.sync m16n8k16 (operands by ldmatrix, f32 accumulators). A
// ring of 3 shared-memory stages: the weight tile (and the o tile of the
// projection) arrives by cp.async 16-byte copies two chunks ahead; the x tile of the qkv product is loaded into
// registers one chunk ahead, normalised and stored as bf16 after this chunk's
// products, so one __syncthreads a chunk orders both. The epilogue stages the
// f32 sums through shared memory, adds the bias, rounds, and writes 8 values
// per 16-byte store (one token_offset per row, padding tokens dropped in the
// projection). C % 8 != 0 takes a scalar-load branch. f32: 128 x 64 SIMT
// tiles, 8 x 4 outputs a thread, exact f32 (no TF32).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wattn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__host__ __device__ inline size_t round128(size_t v) { return (v + 127) & ~size_t(127); }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---- window geometry: pad H, W to multiples of win, roll by -shift
struct Geo {
  int B, H, W, C, heads, hd, win, n, shift, Hp, Wp, nwy, nwx;
};

inline Geo make_geo(int B, int H, int W, int C, int heads, int win, int shift) {
  Geo g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.heads = heads;
  g.hd = C / heads;
  g.win = win;
  g.n = win * win;
  g.shift = shift;
  g.Hp = (H + win - 1) / win * win;
  g.Wp = (W + win - 1) / win * win;
  g.nwy = g.Hp / win;
  g.nwx = g.Wp / win;
  return g;
}

// Source element offset of token t of window wl (in image b), or -1 for a
// padding token: window token (r, c) of the rolled, padded grid is x at
// ((r + shift) mod Hp, (c + shift) mod Wp).
__device__ __forceinline__ long long token_offset(const Geo& g, int b, int wl, int t) {
  const int r = (wl / g.nwx) * g.win + t / g.win;
  const int c = (wl % g.nwx) * g.win + t % g.win;
  const int sr = (r + g.shift) % g.Hp;
  const int sc = (c + g.shift) % g.Wp;
  if (sr >= g.H || sc >= g.W) return -1;
  return ((static_cast<long long>(b) * g.H + sr) * g.W + sc) * g.C;
}

// Offset of row m of a window-ordered [B * nW * n, *] matrix's token
__device__ __forceinline__ long long row_offset(const Geo& g, int m) {
  const int nwin = g.nwy * g.nwx;
  const int wglob = m / g.n;
  return token_offset(g, wglob / nwin, wglob % nwin, m % g.n);
}

// Region id of rolled coordinate r along an axis of length len
// (models/swin.py _shift_attn_mask's three slices).
__device__ __forceinline__ int region(int r, int len, int win, int shift) {
  return r < len - win ? 0 : (r < len - shift ? 1 : 2);
}

// 8 consecutive values as f32, by 16-byte loads (p 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  __align__(16) bf16 t[8];
  *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(t[i]);
}

// 16-byte asynchronous copy global -> shared; pred false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b, m16n8k16, bf16 in, f32 sums. a: rows g / g + 8, columns 2 t (+1)
// / 2 t + 8 (+1); b: columns g, rows 2 t (+1) / 2 t + 8 (+1); d: rows g / g + 8,
// columns 2 t (+1), where g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---- LayerNorm statistics of every real token: stats[tok], stats[T + tok]
template <typename TX>
__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const TX* __restrict__ x, float* __restrict__ stats, int tokens, int C,
                float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tok = blockIdx.x * kWarps + warp;
  if (tok >= tokens) return;
  const TX* xr = x + static_cast<long long>(tok) * C;
  float sum = 0.0f;
  for (int k = lane; k < C; k += 32) sum += to_f(xr[k]);
  for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
  const float mu = sum / C;
  float sq = 0.0f;
  for (int k = lane; k < C; k += 32) {
    const float dx = to_f(xr[k]) - mu;
    sq += dx * dx;
  }
  for (int d = 16; d; d >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, d);
  if (lane == 0) {
    stats[tok] = mu;
    stats[tokens + tok] = rsqrtf(sq / C + eps);
  }
}

// ---- the GEMM: out = A @ W^T + bias, A [M, K], W [N, K] (nn.Linear layout)
namespace gemm {

constexpr int kBM = 128, kBN = 128, kKC = 32, kStages = 3;  // bf16 tile and ring
constexpr int kLD = kKC + 8;                                 // operand row stride
constexpr int kLDC = kBN + 4;                                // f32 staging row stride
constexpr int kTile = kBM * kLD;                             // elements of one operand stage
constexpr size_t kRing = size_t(2) * kStages * kTile * sizeof(bf16);
constexpr size_t kStage = size_t(kBM) * kLDC * sizeof(float);
constexpr size_t kSmem = kRing > kStage ? kRing : kStage;  // dynamic, bf16 path
constexpr int kSBM = 128, kSBN = 64, kSKC = 16;            // f32 SIMT tile
static_assert(kBM == kBN && kBM * (kKC / 8) == 2 * kThreads, "two 16-byte copies a thread");

// Per-row facts of the block's kBM rows, set once: kLN (qkv product): the
// source offset of the row's token in x (-1 for padding or m >= M) and its
// LN statistics; else (projection): the destination offset in image order.
template <bool kLN>
__device__ __forceinline__ void row_setup(const Geo& g, const float* __restrict__ stats,
                                          int tokens, int m0, int M, int rows,
                                          long long* s_off, float* s_mu, float* s_rs) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int m = m0 + r;
    long long off = -1;
    float mu = 0.0f, rs = 0.0f;
    if (m < M) {
      off = row_offset(g, m);
      if (kLN && off >= 0) {
        const long long tok = off / g.C;
        mu = stats[tok];
        rs = stats[tokens + tok];
      }
    }
    s_off[r] = off;
    if (kLN) {
      s_mu[r] = mu;
      s_rs[r] = rs;
    }
  }
}

// One K chunk of the warp's 32 x 64 sub-tile on mma.sync: acc[i][j] is the
// m16n8 tile at rows wm * 32 + 16 i, columns wn * 64 + 8 j; operands by
// ldmatrix (A rows m, B rows n, both K-contiguous).
__device__ __forceinline__ void mma_chunk(float (&acc)[2][8][4], const bf16* tA, const bf16* tB,
                                          int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 16) {
    uint32_t a[2][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(a[i], tA + (wm * 32 + i * 16 + (lane & 15)) * kLD + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldsm_x4(b[j], tB + (wn * 64 + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLD + kk +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma16816(acc[i][2 * j], a[i], b[j][0], b[j][1]);
        mma16816(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
      }
  }
}

// The bf16 tile at (blockIdx.x, blockIdx.y). kLN: A is x [tokens, K] (TX),
// gathered by s_off and normalised with ln_g / ln_b; out [M, N] row-major.
// Else: A is o [M, K] (bf16); out row m goes to out + s_off[m - m0].
template <bool kLN, typename TX>
__device__ void tile_bf16(const TX* __restrict__ a, const float* __restrict__ stats,
                          const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                          int tokens, const bf16* __restrict__ w, const float* __restrict__ bias,
                          bf16* __restrict__ out, const Geo& g, int M, int N, int K, int vec,
                          unsigned char* smem) {
  __shared__ long long s_off[kBM];
  __shared__ float s_mu[kLN ? kBM : 1], s_rs[kLN ? kBM : 1];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kTile;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps of 32 x 64
  row_setup<kLN>(g, stats, tokens, m0, M, kBM, s_off, s_mu, s_rs);
  __syncthreads();

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int KT = (K + kKC - 1) / kKC;

  if (vec) {
    // each thread moves 8 columns (16 bytes) of rows lr and lr + 64 of each operand
    const int lr = tid >> 2, lk = (tid & 3) * 8;
    long long aoff[2];
    float amu[2], ars[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      aoff[i] = kLN ? s_off[r] : (m0 + r < M ? static_cast<long long>(m0 + r) * K : -1);
      amu[i] = kLN ? s_mu[r] : 0.0f;
      ars[i] = kLN ? s_rs[r] : 0.0f;
    }
    auto copy_chunk = [&](int kt) {  // cp.async of chunk kt into its ring slot
      const int slot = kt % kStages, k = kt * kKC + lk;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lr + 64 * i, col = n0 + r;
        const bool pb = col < N && k < K;
        cp_async16(sB + slot * kTile + r * kLD + lk,
                   pb ? w + static_cast<long long>(col) * K + k : w, pb);
        if constexpr (!kLN) {
          const bool pa = aoff[i] >= 0 && k < K;
          cp_async16(sA + slot * kTile + r * kLD + lk, pa ? a + aoff[i] + k : a, pa);
        }
      }
    };
    float xa[2][8];  // kLN: the next chunk of x, raw
    auto fetch = [&](int kt) {
      const int k = kt * kKC + lk;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (aoff[i] >= 0 && k < K) {
          load8(a + aoff[i] + k, xa[i]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) xa[i][e] = 0.0f;
        }
      }
    };
    auto store = [&](int kt) {  // normalise, round, store into the chunk's slot
      const int slot = kt % kStages, k = kt * kKC + lk;
      float gv[8], bv[8];
      if (k < K) {
        load8(ln_g + k, gv);
        load8(ln_b + k, bv);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        __align__(16) bf16 v[8];
        const bool real = aoff[i] >= 0 && k < K;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16(real ? ((xa[i][e] - amu[i]) * ars[i]) * gv[e] + bv[e] : 0.0f);
        *reinterpret_cast<uint4*>(sA + slot * kTile + (lr + 64 * i) * kLD + lk) =
            *reinterpret_cast<uint4*>(v);
      }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) copy_chunk(s);
      cp_async_commit();
    }
    if constexpr (kLN) {
      fetch(0);
      store(0);
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();  // chunk kt's copies of this thread have landed
      __syncthreads();               // ... and everyone's; chunk kt - 1 is spent
      if (kt + kStages - 1 < KT) copy_chunk(kt + kStages - 1);
      cp_async_commit();
      if (kLN && kt + 1 < KT) fetch(kt + 1);
      mma_chunk(acc, sA + (kt % kStages) * kTile, sB + (kt % kStages) * kTile, wm, wn, lane);
      if (kLN && kt + 1 < KT) store(kt + 1);
    }
    cp_async_wait<0>();
  } else {  // scalar loads, one stage
    for (int k0 = 0; k0 < K; k0 += kKC) {
      for (int e = tid; e < kBM * kKC; e += kThreads) {
        const int r = e / kKC, kk = e % kKC, k = k0 + kk;
        float v = 0.0f;
        if (kLN) {
          const long long off = s_off[r];
          if (off >= 0 && k < K)
            v = ((to_f(a[off + k]) - s_mu[r]) * s_rs[r]) * ln_g[k] + ln_b[k];
        } else if (m0 + r < M && k < K) {
          v = to_f(a[static_cast<long long>(m0 + r) * K + k]);
        }
        sA[r * kLD + kk] = __float2bfloat16(v);
      }
      for (int e = tid; e < kBN * kKC; e += kThreads) {
        const int j = e / kKC, kk = e % kKC, k = k0 + kk, col = n0 + j;
        sB[j * kLD + kk] =
            (col < N && k < K) ? w[static_cast<long long>(col) * K + k] : __float2bfloat16(0.0f);
      }
      __syncthreads();
      mma_chunk(acc, sA, sB, wm, wn, lane);
      __syncthreads();
    }
  }
  __syncthreads();  // the ring is spent: stage the f32 sums over it

  float* stage = reinterpret_cast<float*>(smem);
  {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* p = stage + (wm * 32 + i * 16 + g8) * kLDC + wn * 64 + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * kLDC) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
  __syncthreads();
  for (int e = tid; e < kBM * (kBN / 8); e += kThreads) {
    const int r = e / (kBN / 8), c8 = (e % (kBN / 8)) * 8;
    const int m = m0 + r, col = n0 + c8;
    if (m >= M || col >= N) continue;
    long long base;
    if (kLN) {
      base = static_cast<long long>(m) * N;
    } else {
      base = s_off[r];
      if (base < 0) continue;  // a padding token: cropped
    }
    const float* sr = stage + r * kLDC + c8;
    if (vec) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(sr[i] + bias[col + i]);
      *reinterpret_cast<uint4*>(out + base + col) = *reinterpret_cast<uint4*>(v);
    } else {
      for (int i = 0; i < 8 && col + i < N; ++i)
        out[base + col + i] = __float2bfloat16(sr[i] + bias[col + i]);
    }
  }
}

// The f32 tile: 128 x 64, K chunks of 16, 8 x 4 outputs a thread (SIMT
// FMA in exact f32). Operands stored K-major (sA[k][m], sB[k][n]) so a
// thread reads its rows and columns as float4; two stages, the next chunk
// held in registers while this one multiplies.
template <bool kLN>
__device__ void tile_f32(const float* __restrict__ a, const float* __restrict__ stats,
                         const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                         int tokens, const float* __restrict__ w, const float* __restrict__ bias,
                         float* __restrict__ out, const Geo& g, int M, int N, int K) {
  constexpr int LA = kSBM + 4, LB = kSBN + 4;
  __shared__ __align__(16) float sA[2][kSKC * LA];
  __shared__ __align__(16) float sB[2][kSKC * LB];
  __shared__ long long s_off[kSBM];
  __shared__ float s_mu[kLN ? kSBM : 1], s_rs[kLN ? kSBM : 1];
  const int m0 = blockIdx.x * kSBM, n0 = blockIdx.y * kSBN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  row_setup<kLN>(g, stats, tokens, m0, M, kSBM, s_off, s_mu, s_rs);
  __syncthreads();

  // loader: A rows lr and lr + 64, B row lr; 4 consecutive k from lk
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  float ra[2][4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + lk + e;
        float v = 0.0f;
        if (kLN) {
          const long long off = s_off[r];
          if (off >= 0 && k < K) v = ((a[off + k] - s_mu[r]) * s_rs[r]) * ln_g[k] + ln_b[k];
        } else if (m0 + r < M && k < K) {
          v = a[static_cast<long long>(m0 + r) * K + k];
        }
        ra[i][e] = v;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + lk + e, col = n0 + lr;
      rb[e] = (col < N && k < K) ? w[static_cast<long long>(col) * K + k] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sA[buf][(lk + e) * LA + lr] = ra[0][e];
      sA[buf][(lk + e) * LA + lr + 64] = ra[1][e];
      sB[buf][(lk + e) * LB + lr] = rb[e];
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int KT = (K + kSKC - 1) / kSKC;
  fetch(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fetch((kt + 1) * kSKC);
    const float* tA = sA[kt & 1];
    const float* tB = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kSKC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(tA + kk * LA + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(tA + kk * LA + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(tB + kk * LB + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    if (kt + 1 < KT) store((kt + 1) & 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3), m = m0 + r;
    if (m >= M) continue;
    const long long base = kLN ? static_cast<long long>(m) * N : s_off[r];
    if (base < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[base + col] = acc[i][j] + bias[col];
    }
  }
}

}  // namespace gemm

// ---- the qkv product: qkv [M, 3C] = LN(x)[window order] @ Wqkv^T + bqkv
template <typename TX, typename T>
__global__ void __launch_bounds__(kThreads, 2)
qkv_gemm_kernel(const TX* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                const T* __restrict__ wqkv, const float* __restrict__ bqkv, T* __restrict__ qkv,
                Geo g, int M, int tokens, int vec) {
  if constexpr (std::is_same<T, bf16>::value) {
    extern __shared__ __align__(128) unsigned char smem[];
    gemm::tile_bf16<true, TX>(x, stats, ln_g, ln_b, tokens, wqkv, bqkv, qkv, g, M, 3 * g.C, g.C,
                              vec, smem);
  } else {
    gemm::tile_f32<true>(x, stats, ln_g, ln_b, tokens, wqkv, bqkv, qkv, g, M, 3 * g.C, g.C);
  }
}

// LN statistics (stats [2 * tokens] f32) then the qkv product (qkv
// [B * nW * n, 3C] of T), queued on `stream`; the cudaError_t of the first
// launch that failed.
template <typename TX, typename T>
int launch_ln_qkv(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                  const void* bqkv, void* stats, void* qkv, const Geo& g, float eps,
                  cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const int tokens = g.B * g.H * g.W;
  const int M = g.B * g.nwy * g.nwx * g.n;
  // 16-byte loads need rows that start on 16 bytes
  const int vec = kBf16 && g.C % 8 == 0 && aligned16(x) && aligned16(ln_g) && aligned16(ln_b) &&
                  aligned16(wqkv) && aligned16(qkv);
  ln_stats_kernel<TX><<<(tokens + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<float*>(stats), tokens, g.C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = qkv_gemm_kernel<TX, T>;
  const int bm = kBf16 ? gemm::kBM : gemm::kSBM, bn = kBf16 ? gemm::kBN : gemm::kSBN;
  const size_t smem = kBf16 ? gemm::kSmem : 0;
  if (kBf16) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((M + bm - 1) / bm, (3 * g.C + bn - 1) / bn);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(wqkv), static_cast<const float*>(bqkv), static_cast<T*>(qkv), g, M,
      tokens, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wattn
