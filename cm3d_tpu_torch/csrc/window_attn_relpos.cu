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
// Rounding follows the TPU kernel: LN out, qkv, the two bias terms, p and o
// are rounded to the compute type T (bf16 or f32); every sum is f32.
//
// Bound on the H100: 6 C^2 (qkv) + 4 n C (q k^T + p v) + 4 (2 win - 1) C
// (the two table products) operations a real token against a few MB of x,
// weights and o per launch: operations bind. The TPU kernel's G-window
// block-diagonal [T, T] problem, its reversed tables with Toeplitz
// select-sums and its one-hot expansion products only served its matrix
// unit; here each window is its own n x n problem and the bias is an indexed
// read of the [rows, 2 win - 1] products q @ rel^T.
//
// Design. The TPU kernel keeps qkv in VMEM because its HBM is slow beside
// its matrix unit; on this card qkv of a whole ViT-H grid is 37 MB, 22 us of
// HBM time beside 45 us of tensor-core time, so the branch is cut where the
// data is reused differently, three kernels behind one launcher:
//  1. bf16: ln_rows_kernel (window_attn_common.cuh): round_bf16(LN(x)) in
//     window order into o (a padding token's row is 0, so its qkv is the
//     bias); f32: ln_stats_kernel, mean and rstd of every real token.
//  2. qkv_gemm_kernel (window_attn_common.cuh, shared with Swin's
//     window_attn.cu, here with shift 0): one GEMM over all windows' tokens
//     in window order, [M, C] x [C, 3C]. bf16: a persistent wgmma kernel
//     fed by TMA; f32: 128 x 64 SIMT tiles that gather and normalise x as
//     they load.
//  3. relpos_attn: one block per (window, head); q, k, v [n, hd] of the head
//     in shared memory (110 KB in bf16 at hd 80, 190 KB in f32), so the
//     [196, 196] scores cannot sit beside them: a tile of query rows at a
//     time (32 in bf16, 16 in f32), scores q k^T and the two [rows, 32]
//     table products (bf16: wmma, the 27-row tables zero-padded to 32; f32:
//     SIMT), bias gathered per (i, j), softmax in f32, p v, o written in
//     window order.
// Running 1-3 in one block per (window, head) instead makes every head
// re-read and re-normalise its window's x and re-stream its slice of Wqkv
// once per 64 rows: measured at 7.8 ms a call at ViT-H's square grid,
// against 0.93 ms for this cut.
// Not yet done: the attention kernel on mma.sync with the softmax in
// registers (as window_attn.cu's), key tiling in 3 so that two blocks share
// an SM.

#include <cmath>

#include <mma.h>

#include "window_attn_common.cuh"

namespace {

using namespace nvcuda;
using namespace wattn;

// v rounded to T, carried as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Row stride (elements) of a wmma operand tile of KC columns: 16 bytes of
// padding keep the loads aligned and off the same banks; the SIMT f32 path
// pads by one element.
template <typename T>
__host__ __device__ constexpr int tile_ld(int kc) {
  return std::is_same<T, bf16>::value ? kc + 8 : kc + 1;
}

constexpr int kMaxTokens = 208;  // win^2 <= 196, padded to 16
constexpr int kMaxHd = 80;
constexpr int kRel = 32;       // rows of a rel-pos table, padded (2 win - 1 <= 32)
constexpr int kLDR = kRel + 4;  // row stride of the q @ rel^T products

template <typename T>
struct Cfg {  // bf16: tensor-core tiles; f32: SIMT, shared memory is the limit
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int kQT = kMma ? 32 : 16;  // query rows per attention tile
};

// ---- 3. attention of one (window, head)
// Shared-memory layout, the same on host and device.
struct Smem {
  int np;    // token rows, padded to 16
  int rows;  // rows held of q, k, v (np with wmma, n without)
  int hdp;   // head dim, padded to 16 with wmma
  int ldh;   // row stride of q, k, v and the tables
  int lds;   // row stride of a scores tile (f32)
  int ldp;   // row stride of a p tile (T)
  size_t mat;  // bytes of one of q, k, v
  size_t off_rel, off_r0;
  size_t off_p, off_ph, off_pw;  // inside region 0
  size_t total;
};

template <typename T>
__host__ __device__ inline Smem smem_layout(int n, int hd) {
  using CF = Cfg<T>;
  Smem s;
  s.np = (n + 15) & ~15;
  s.rows = CF::kMma ? s.np : n;
  s.hdp = CF::kMma ? (hd + 15) & ~15 : hd;
  s.ldh = tile_ld<T>(s.hdp);
  s.lds = s.np + 4;
  s.ldp = CF::kMma ? s.np + 8 : s.lds;
  s.mat = round128(size_t(s.rows) * s.ldh * sizeof(T));
  size_t o = 3 * s.mat;
  s.off_rel = o;  // wmma reads the two tables from shared memory
  if (CF::kMma) o += 2 * round128(size_t(kRel) * s.ldh * sizeof(T));
  s.off_r0 = o;
  // region 0: a query tile's scores | p | table products
  const size_t scores = round128(size_t(CF::kQT) * s.lds * 4);
  const size_t p = CF::kMma ? round128(size_t(CF::kQT) * s.ldp * sizeof(T)) : 0;  // f32: in place
  const size_t rel = round128(size_t(CF::kQT) * kLDR * 4);
  s.off_p = scores;
  s.off_ph = scores + p;
  s.off_pw = scores + p + rel;
  s.total = s.off_r0 + scores + p + 2 * rel;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
relpos_attn_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_h,
                   const T* __restrict__ rel_w, T* __restrict__ o, Geo g, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  using CF = Cfg<T>;
  constexpr int QT = CF::kQT;
  const int n = g.n, C = g.C, hd = g.hd, win = g.win;
  const Smem L = smem_layout<T>(n, hd);
  const int LDH = L.ldh, LDS = L.lds, LDP = L.ldp;

  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = reinterpret_cast<T*>(smem + L.mat);
  T* s_v = reinterpret_cast<T*>(smem + 2 * L.mat);
  T* s_relh = reinterpret_cast<T*>(smem + L.off_rel);
  T* s_relw = s_relh + round128(size_t(kRel) * LDH * sizeof(T)) / sizeof(T);
  unsigned char* r0 = smem + L.off_r0;
  float* s_s = reinterpret_cast<float*>(r0);
  T* s_p = CF::kMma ? reinterpret_cast<T*>(r0 + L.off_p) : reinterpret_cast<T*>(r0);
  float* s_ph = reinterpret_cast<float*>(r0 + L.off_ph);
  float* s_pw = reinterpret_cast<float*>(r0 + L.off_pw);

  const int wglob = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int two = 2 * win - 1;
  const int MW = int(L.mat / sizeof(T));  // elements between q, k and v

  // q | k | v of this head; rows past n and columns past hd are 0
  const T* src = qkv + static_cast<long long>(wglob) * n * 3 * C + h * hd;
  if (CF::kMma && vec) {
    const int G = L.hdp / 8;
    for (int gi = tid; gi < L.rows * 3 * G; gi += kThreads) {
      const int t = gi / (3 * G), which = (gi / G) % 3, d = (gi % G) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < n && d < hd)
        v = *reinterpret_cast<const uint4*>(src + static_cast<long long>(t) * 3 * C + which * C + d);
      *reinterpret_cast<uint4*>(s_q + which * MW + t * LDH + d) = v;
    }
  } else {
    for (int e = tid; e < L.rows * 3 * L.hdp; e += kThreads) {
      const int t = e / (3 * L.hdp), which = (e / L.hdp) % 3, d = e % L.hdp;
      T v = from_f<T>(0.0f);
      if (t < n && d < hd) v = src[static_cast<long long>(t) * 3 * C + which * C + d];
      s_q[which * MW + t * LDH + d] = v;
    }
  }
  if constexpr (CF::kMma) {  // the tables, zero-padded to [32, hdp]
    for (int e = tid; e < kRel * LDH; e += kThreads) {
      const int u = e / LDH, d = e % LDH;
      const bool in = u < two && d < hd;
      s_relh[e] = in ? rel_h[u * hd + d] : from_f<T>(0.0f);
      s_relw[e] = in ? rel_w[u * hd + d] : from_f<T>(0.0f);
    }
  }
  __syncthreads();

  // ---- attention, QT query rows at a time
  T* orow = o + static_cast<long long>(wglob) * n * C + h * hd;
  for (int q0 = 0; q0 < n; q0 += QT) {
    const int nrow = min(QT, n - q0);
    if constexpr (CF::kMma) {
      const int MT = min(QT, L.np - q0) / 16, KT = L.np / 16;
      for (int f = warp; f < MT * KT; f += kWarps) {  // q k^T
        const int mt = f % MT, nt = f / MT;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < L.hdp; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, s_q + (q0 + mt * 16) * LDH + kk, LDH);
          wmma::load_matrix_sync(fb, s_k + nt * 16 * LDH + kk, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(s_s + mt * 16 * LDS + nt * 16, acc, LDS, wmma::mem_row_major);
      }
      for (int f = warp; f < MT * 2 * (kRel / 16); f += kWarps) {  // q rel_h^T, q rel_w^T
        const int mt = f % MT, nt = (f / MT) % (kRel / 16), which = f / (MT * (kRel / 16));
        const T* rel = which ? s_relw : s_relh;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < L.hdp; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, s_q + (q0 + mt * 16) * LDH + kk, LDH);
          wmma::load_matrix_sync(fb, rel + nt * 16 * LDH + kk, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync((which ? s_pw : s_ph) + mt * 16 * kLDR + nt * 16, acc, kLDR,
                                wmma::mem_row_major);
      }
    } else {
      for (int e = tid; e < nrow * 2 * two; e += kThreads) {
        const int i = e / (2 * two), u = e % (2 * two);
        const T* q = s_q + (q0 + i) * LDH;
        const T* rel = (u < two ? rel_h + u * hd : rel_w + (u - two) * hd);
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot += to_f(q[d]) * to_f(rel[d]);
        (u < two ? s_ph : s_pw)[i * kLDR + (u < two ? u : u - two)] = dot;
      }
      for (int e = tid; e < nrow * n; e += kThreads) {
        const int i = e / n, j = e % n;
        const T* q = s_q + (q0 + i) * LDH;
        const T* kr = s_k + j * LDH;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot += to_f(q[d]) * to_f(kr[d]);
        s_s[i * LDS + j] = dot;
      }
    }
    __syncthreads();

    // scores + bias, softmax in f32, one warp per row; p rounded to T
    for (int i = warp; i < nrow; i += kWarps) {
      float* sr = s_s + i * LDS;
      const float* ph = s_ph + i * kLDR + (q0 + i) / win + win - 1;
      const float* pw = s_pw + i * kLDR + (q0 + i) % win + win - 1;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        const float s = sr[j] * scale + round_to<T>(ph[-(j / win)]) + round_to<T>(pw[-(j % win)]);
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
      T* pr = s_p + i * LDP;
      for (int j = lane; j < L.np; j += 32) {
        if constexpr (CF::kMma) {
          pr[j] = from_f<T>(j < n ? sr[j] / sum : 0.0f);
        } else {
          if (j < n) pr[j] = sr[j] / sum;
        }
      }
    }
    if constexpr (CF::kMma) {  // rows of the tile past n: p = 0
      for (int e = tid + nrow * LDP; e < QT * LDP; e += kThreads) s_p[e] = from_f<T>(0.0f);
    }
    __syncthreads();

    // o = p v, this head's columns, window order
    if constexpr (CF::kMma) {
      const int MT = min(QT, L.np - q0) / 16, HT = L.hdp / 16, LDO = L.hdp + 4;
      float* s_o = s_s;  // the scores are spent
      for (int f = warp; f < MT * HT; f += kWarps) {
        const int mt = f % MT, nt = f / MT;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < L.np; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, s_p + mt * 16 * LDP + kk, LDP);
          wmma::load_matrix_sync(fb, s_v + kk * LDH + nt * 16, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(s_o + mt * 16 * LDO + nt * 16, acc, LDO, wmma::mem_row_major);
      }
      __syncthreads();
      for (int e = tid; e < nrow * hd; e += kThreads) {
        const int i = e / hd, d = e % hd;
        orow[static_cast<long long>(q0 + i) * C + d] = from_f<T>(s_o[i * LDO + d]);
      }
    } else {
      for (int e = tid; e < nrow * hd; e += kThreads) {
        const int i = e / hd, d = e % hd;
        const T* pr = s_p + i * LDP;
        float acc = 0.0f;
        for (int j = 0; j < n; ++j) acc += to_f(pr[j]) * to_f(s_v[j * LDH + d]);
        orow[static_cast<long long>(q0 + i) * C + d] = from_f<T>(acc);
      }
    }
    __syncthreads();
  }
}


template <typename TX, typename T>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* wqkv, const void* bqkv,
           const void* rel_h, const void* rel_w, void* stats, void* qkv, void* o, const Geo& g,
           float eps, float scale, cudaStream_t stream) {
  using CF = Cfg<T>;
  // 1 + 2: the LN statistics and the qkv GEMM shared with window_attn.cu
  // bf16: the LN rows go to o, which the attention overwrites once the GEMM has read them
  int ierr = launch_ln_qkv<TX, T>(x, ln_g, ln_b, wqkv, bqkv, stats, o, qkv, g, eps, stream);
  if (ierr != 0) return ierr;
  // 16-byte loads need rows that start on 16 bytes
  const int vec = CF::kMma && g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(qkv) && aligned16(o);
  auto kernel = relpos_attn_kernel<T>;
  const size_t smem = smem_layout<T>(g.n, g.hd).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a(g.B * g.nwy * g.nwx, g.heads);
  kernel<<<grid_a, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_h), static_cast<const T*>(rel_w),
      static_cast<T*>(o), g, scale, vec);
  return static_cast<int>(cudaGetLastError());
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
