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
// token over the padded grid, against a few tens of MB of input, weights
// and output per launch: operations bind the first launch (bytes at Swin-B's
// stage 0, whose x is f32), bytes bind the projection; about 1 ms per Detic
// forward over 6 cameras at 1024x576 in all. The TPU's interleaved
// block-diagonal [T, T] attention over G windows (expand_bias_interleaved,
// pick_group) only kept its matrix unit's tiles large and wasted a factor G
// of flops; here every window's n x n problem is computed by itself.
//
// Design (a first version: right and simple). Two launches per block:
//  1. window_attn_heads: one thread block per (window, head). The block
//     takes the LN statistics of its window's (up to 64) tokens, then
//     streams K-chunks of x, normalising them as they are loaded, against
//     the head's 3 * hd columns of Wqkv (bf16: wmma 16x16x16 tensor-core
//     tiles with f32 accumulators; f32: SIMT FMA). q, k, v of the head stay
//     in shared memory; scores, softmax and p v run in SIMT f32. The head's
//     slice of o [B * nW * n, C] goes to device memory in window order.
//     One head per block keeps shared memory small at C = 1024 (a whole
//     window's LN(x) in f32 would need 256 KB, over the 227 KB a block may
//     have) and gives 90 windows x 32 heads = 2880 blocks a camera at
//     Swin-B's last stage, where one block per window would leave most SMs
//     idle. The price: every head re-reads its window's x and LN statistics.
//  2. window_attn_proj: a 64 x 64 tiled GEMM o @ Wproj^T (wmma for bf16,
//     SIMT for f32) whose epilogue adds the bias and writes each real token
//     to its place in [B, H, W, C]; padding tokens are dropped there.
// The pad, roll and crop live in the addressing: window token (r, c) of the
// rolled, padded grid reads x at ((r + shift) mod Hp, (c + shift) mod Wp),
// a source row >= H or column >= W is a padding token, and the shift mask
// comes from region ids computed in the kernel. The rel-pos bias is read
// from the [(2 win - 1)^2, heads] table directly.
// Not yet done (later work): cp.async / TMA double buffering of the K
// chunks, wgmma, several heads per block to reuse the x tiles.

#include <cmath>

#include "window_attn_common.cuh"

namespace {

using namespace nvcuda;
using namespace wattn;

constexpr int kRows = 64;      // tokens per window, padded (win * win <= 64)
constexpr int kKC = 32;        // K chunk of both GEMMs
constexpr int kMaxNT = 12;     // 16-column tiles of 3 * hd (hd <= 64)
constexpr int kMaxFrag = 4 * kMaxNT / kWarps;  // wmma accumulators per warp

template <typename T>
__host__ __device__ constexpr int lda() {  // row stride (elements) of the GEMM operand tiles
  return tile_ld<T>(kKC);
}

struct Geo {
  int B, H, W, C, heads, hd, win, n, shift, Hp, Wp, nwy, nwx;
};

// Source element offset of token t of window wl (in one image), or -1 for a
// padding token.
__device__ __forceinline__ long long token_offset(const Geo& g, int b, int wl, int t) {
  const int r = (wl / g.nwx) * g.win + t / g.win;
  const int c = (wl % g.nwx) * g.win + t % g.win;
  const int sr = (r + g.shift) % g.Hp;
  const int sc = (c + g.shift) % g.Wp;
  if (sr >= g.H || sc >= g.W) return -1;
  return ((static_cast<long long>(b) * g.H + sr) * g.W + sc) * g.C;
}

// Region id of rolled coordinate r along an axis of length len
// (models/swin.py _shift_attn_mask's three slices).
__device__ __forceinline__ int region(int r, int len, int win, int shift) {
  return r < len - win ? 0 : (r < len - shift ? 1 : 2);
}

struct HeadsSmem {
  size_t off_qkv, off_r0, total;
};

__host__ __device__ inline HeadsSmem heads_smem(int nq, int tsize, int ld) {
  const int nqp = (nq + 15) & ~15;
  HeadsSmem s;
  s.off_qkv = 1024;  // s_off [64] int64, mu [64], rs [64] f32
  s.off_r0 = s.off_qkv + round128(size_t(kRows) * (nq + 1) * tsize);
  const size_t gemm = round128(size_t(kRows) * ld * tsize) + round128(size_t(nqp) * ld * tsize);
  const size_t stage = size_t(kRows) * (nqp + 4) * 4;
  const size_t scores = size_t(kRows) * (kRows + 1) * 4;
  size_t r0 = gemm > stage ? gemm : stage;
  r0 = r0 > scores ? r0 : scores;
  s.total = s.off_r0 + round128(r0);
  return s;
}

template <typename TX, typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_heads_kernel(const TX* __restrict__ x, const float* __restrict__ ln_g,
                         const float* __restrict__ ln_b, const T* __restrict__ wqkv,
                         const float* __restrict__ bqkv, const float* __restrict__ table,
                         T* __restrict__ o, Geo g, float eps, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDA = lda<T>();
  const int nq = 3 * g.hd;
  const int nqp = (nq + 15) & ~15;
  const int NT = nqp / 16;
  const int LQ = nq + 1;
  const int LDS = nqp + 4;
  const HeadsSmem lay = heads_smem(nq, sizeof(T), LDA);

  long long* s_off = reinterpret_cast<long long*>(smem);
  float* s_mu = reinterpret_cast<float*>(smem + 512);
  float* s_rs = reinterpret_cast<float*>(smem + 768);
  T* s_qkv = reinterpret_cast<T*>(smem + lay.off_qkv);
  unsigned char* r0 = smem + lay.off_r0;
  T* s_a = reinterpret_cast<T*>(r0);
  T* s_b = reinterpret_cast<T*>(r0 + round128(size_t(kRows) * LDA * sizeof(T)));
  float* s_stage = reinterpret_cast<float*>(r0);
  float* s_s = reinterpret_cast<float*>(r0);

  const int nwin = g.nwy * g.nwx;
  const int wglob = blockIdx.x;
  const int b = wglob / nwin, wl = wglob % nwin;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = g.n, C = g.C, hd = g.hd;

  if (tid < kRows) s_off[tid] = tid < n ? token_offset(g, b, wl, tid) : -1;
  __syncthreads();

  // LayerNorm statistics, two-pass, one warp per token
  for (int t = warp; t < n; t += kWarps) {
    const long long off = s_off[t];
    float mu = 0.0f, rs = 0.0f;
    if (off >= 0) {
      const TX* xr = x + off;
      float sum = 0.0f;
      for (int k = lane; k < C; k += 32) sum += to_f(xr[k]);
      for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
      mu = sum / C;
      float sq = 0.0f;
      for (int k = lane; k < C; k += 32) {
        const float dx = to_f(xr[k]) - mu;
        sq += dx * dx;
      }
      for (int d = 16; d; d >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, d);
      rs = rsqrtf(sq / C + eps);
    }
    if (lane == 0) {
      s_mu[t] = mu;
      s_rs[t] = rs;
    }
  }
  __syncthreads();

  // qkv columns of this head: LN(x) [64, C] @ Wqkv[rows of head h]^T
  const int ty = tid >> 4, tx = tid & 15;  // SIMT (f32) output layout
  float acc_s[4][kMaxNT];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_w[kMaxFrag];
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < kMaxFrag; ++i) wmma::fill_fragment(acc_w[i], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) acc_s[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int e = tid; e < kRows * kKC; e += kThreads) {
      const int t = e / kKC, kk = e % kKC, k = k0 + kk;
      float v = 0.0f;
      if (t < n && k < C) {
        const long long off = s_off[t];
        if (off >= 0) v = ((to_f(x[off + k]) - s_mu[t]) * s_rs[t]) * ln_g[k] + ln_b[k];
      }
      s_a[t * LDA + kk] = from_f<T>(v);
    }
    for (int e = tid; e < nqp * kKC; e += kThreads) {
      const int j = e / kKC, kk = e % kKC, k = k0 + kk;
      T v = from_f<T>(0.0f);
      if (j < nq && k < C) {
        const long long row = static_cast<long long>(j / hd) * C + h * hd + j % hd;
        v = wqkv[row * C + k];
      }
      s_b[j * LDA + kk] = v;
    }
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
#pragma unroll
        for (int i = 0; i < kMaxFrag; ++i) {
          const int f = warp + kWarps * i;
          if (f < 4 * NT) {
            const int mt = f & 3, nt = f >> 2;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, s_a + mt * 16 * LDA + kk, LDA);
            wmma::load_matrix_sync(fb, s_b + nt * 16 * LDA + kk, LDA);
            wmma::mma_sync(acc_w[i], fa, fb, acc_w[i]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < kKC; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f(s_a[(ty + 16 * i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (j < NT) {
            const float bv = to_f(s_b[(tx + 16 * j) * LDA + kk]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc_s[i][j] += a[i] * bv;
          }
        }
      }
    }
    __syncthreads();
  }

  // f32 sums -> staging (region 0 is free now)
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < kMaxFrag; ++i) {
      const int f = warp + kWarps * i;
      if (f < 4 * NT) {
        const int mt = f & 3, nt = f >> 2;
        wmma::store_matrix_sync(s_stage + mt * 16 * LDS + nt * 16, acc_w[i], LDS,
                                wmma::mem_row_major);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        if (j < NT) s_stage[(ty + 16 * i) * LDS + tx + 16 * j] = acc_s[i][j];
  }
  __syncthreads();
  for (int e = tid; e < n * nq; e += kThreads) {
    const int t = e / nq, j = e % nq;
    const int col = (j / hd) * C + h * hd + j % hd;
    s_qkv[t * LQ + j] = from_f<T>(s_stage[t * LDS + j] + bqkv[col]);
  }
  __syncthreads();

  // scores: (q . k) * scale + B_rel[h] (+ shift mask), f32
  const int win = g.win;
  const int wy = wl / g.nwx, wx = wl % g.nwx;
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e % n;
    const T* q = s_qkv + i * LQ;
    const T* kr = s_qkv + j * LQ + hd;
    float dot = 0.0f;
    for (int d = 0; d < hd; ++d) dot += to_f(q[d]) * to_f(kr[d]);
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
    s_s[i * (kRows + 1) + j] = s;
  }
  __syncthreads();

  // softmax in f32, one warp per row; p rounded to T
  for (int i = warp; i < n; i += kWarps) {
    float* sr = s_s + i * (kRows + 1);
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
    for (int j = lane; j < n; j += 32) sr[j] = to_f(from_f<T>(sr[j] / sum));
  }
  __syncthreads();

  // o = p v, this head's columns, window order
  T* orow = o + static_cast<long long>(wglob) * n * C + h * hd;
  for (int e = tid; e < n * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    const float* pr = s_s + i * (kRows + 1);
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc += pr[j] * to_f(s_qkv[j * LQ + 2 * hd + d]);
    orow[static_cast<long long>(i) * C + d] = from_f<T>(acc);
  }
}

constexpr int kProjLDS = 64 + 4;
constexpr size_t kProjSmem = 64 * kProjLDS * 4;  // >= both operand tiles of either type
static_assert(2 * 64 * (kKC + 1) * 4 <= kProjSmem, "f32 tiles fit");
static_assert(2 * 64 * (kKC + 8) * 2 <= kProjSmem, "bf16 tiles fit");

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_proj_kernel(const T* __restrict__ o, const T* __restrict__ wproj,
                        const float* __restrict__ bproj, T* __restrict__ out, Geo g, int M) {
  __shared__ __align__(128) unsigned char smem[kProjSmem];
  constexpr int LDA = lda<T>();
  T* s_a = reinterpret_cast<T*>(smem);
  T* s_b = s_a + 64 * LDA;
  float* s_stage = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int C = g.C;

  float acc_s[4][4];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_w[2];
  if constexpr (std::is_same<T, bf16>::value) {
    wmma::fill_fragment(acc_w[0], 0.0f);
    wmma::fill_fragment(acc_w[1], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_s[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int e = tid; e < 64 * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC, k = k0 + kk;
      const int m = m0 + r, col = c0 + r;
      s_a[r * LDA + kk] = (m < M && k < C) ? o[static_cast<long long>(m) * C + k] : from_f<T>(0.0f);
      s_b[r * LDA + kk] = (col < C && k < C) ? wproj[static_cast<long long>(col) * C + k]
                                             : from_f<T>(0.0f);
    }
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int f = warp + kWarps * i;
          const int mt = f & 3, nt = f >> 2;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, s_a + mt * 16 * LDA + kk, LDA);
          wmma::load_matrix_sync(fb, s_b + nt * 16 * LDA + kk, LDA);
          wmma::mma_sync(acc_w[i], fa, fb, acc_w[i]);
        }
      }
    } else {
      for (int kk = 0; kk < kKC; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f(s_a[(ty + 16 * i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f(s_b[(tx + 16 * j) * LDA + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_s[i][j] += a[i] * bv[j];
      }
    }
    __syncthreads();
  }

  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = warp + kWarps * i;
      const int mt = f & 3, nt = f >> 2;
      wmma::store_matrix_sync(s_stage + mt * 16 * kProjLDS + nt * 16, acc_w[i], kProjLDS,
                              wmma::mem_row_major);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_stage[(ty + 16 * i) * kProjLDS + tx + 16 * j] = acc_s[i][j];
  }
  __syncthreads();

  // epilogue: + bias, round, scatter each real token to [B, H, W, C]
  const int nwin = g.nwy * g.nwx;
  for (int e = tid; e < 64 * 64; e += kThreads) {
    const int r = e >> 6, cc = e & 63;
    const int m = m0 + r, col = c0 + cc;
    if (m >= M || col >= C) continue;
    const int wglob = m / g.n, t = m % g.n;
    const long long off = token_offset(g, wglob / nwin, wglob % nwin, t);
    if (off < 0) continue;
    out[off + col] = from_f<T>(s_stage[r * kProjLDS + cc] + bproj[col]);
  }
}

Geo make_geo(int B, int H, int W, int C, int heads, int win, int shift) {
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

template <typename TX, typename T>
int launch_heads(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                 const void* bqkv, const void* table, void* o, const Geo& g, float eps,
                 float scale, cudaStream_t stream) {
  auto kernel = window_attn_heads_kernel<TX, T>;
  const size_t smem = heads_smem(3 * g.hd, sizeof(T), lda<T>()).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.B * g.nwy * g.nwx, g.heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const float*>(table), static_cast<T*>(o), g, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_proj(const void* o, const void* wproj, const void* bproj, void* out, const Geo& g,
                cudaStream_t stream) {
  const int M = g.B * g.nwy * g.nwx * g.n;
  const dim3 grid((M + 63) / 64, (g.C + 63) / 64);
  window_attn_proj_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(wproj), static_cast<const float*>(bproj),
      static_cast<T*>(out), g, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// LN + qkv + per-head windowed attention. x [B, H, W, C] (f32, or bf16 when
// the compute type is bf16), ln_g / ln_b [C] f32, wqkv [3C, C] of the compute
// type, bqkv [3C] f32, table [(2 win - 1)^2, heads] f32, o [B * nW * n, C]
// of the compute type (window order), all contiguous on the device.
// compute_bf16 / x_bf16: 0 = f32, 1 = bf16; scale = head_dim^-1/2, applied
// to q . k in f32 after the dot. Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int window_attn_heads_launch(int compute_bf16, int x_bf16, const void* x,
                                        const void* ln_g, const void* ln_b, const void* wqkv,
                                        const void* bqkv, const void* table, void* o, int B,
                                        int H, int W, int C, int heads, int win, int shift,
                                        float eps, float scale, void* stream) {
  const Geo g = make_geo(B, H, W, C, heads, win, shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    if (x_bf16) return launch_heads<bf16, bf16>(x, ln_g, ln_b, wqkv, bqkv, table, o, g, eps, scale, s);
    return launch_heads<float, bf16>(x, ln_g, ln_b, wqkv, bqkv, table, o, g, eps, scale, s);
  }
  if (x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_heads<float, float>(x, ln_g, ln_b, wqkv, bqkv, table, o, g, eps, scale, s);
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
