// Pieces shared by the two fused window-attention sources
// (window_attn.cu: Swin's table bias; window_attn_relpos.cu: SAM's
// decomposed relative-position bias): type conversion, the window geometry
// and its addressing, the LayerNorm in front of the qkv product, and the
// GEMM that both sources run twice per block, once as the qkv product (rows
// in window order) and once as the output projection (A = o in window order,
// rows scattered back to image order).
//
// The GEMM (bf16, sm_90a; the TPU counterparts are window_attn_pallas.py
// _ln_qkv_prologue and _proj_epilogue): operations bind it, 2 M N K of them
// against (M + N) K + M N bf16 values, so it is built for Hopper's tensor
// cores: wgmma on operand tiles that TMA brings into a 5-stage shared-memory
// ring (128B swizzle, full / empty mbarriers), one producer warpgroup and two
// consumer warpgroups of 64 rows, setmaxnreg moving registers to the
// consumers, a persistent grid of one block an SM over the 128 x 128 tiles so
// the last wave does not idle half the card and a tile's epilogue overlaps
// the next tile's loads. TMA cannot gather rows, so the qkv product's A is
// made by a pre-pass, ln_rows_kernel: round_bf16(LN(x)) in window order
// through the shift-aware token_offset (a padding token's row 0, so its qkv
// is the bias), written into the caller's o buffer, which the attention
// overwrites later; the TPU kernel rounds LN(x) to bf16 before the product
// too, so this is the same arithmetic. The epilogue adds the f32 bias,
// rounds once and writes 16-byte stores at each row's place. bf16 needs
// C % 8 == 0 (TMA strides are multiples of 16 bytes). f32: ln_stats_kernel,
// then 128 x 64 SIMT tiles that gather and normalise x as they load, 8 x 4
// outputs a thread, exact f32 (no TF32).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>
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

// ---- mma.sync and its operands, for the two attention kernels (bf16)
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

// two bf16 as one 32-bit register, lower address low
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void st32(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives in r[m] the elements (lane / 4,
// 2 (lane % 4) (+1)) of matrix m: an mma.sync operand fragment. With .trans
// it receives (2 (lane % 4) (+1), lane / 4), the transposed matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// 16 bytes global -> shared without a register round trip; `bytes` (0 or
// 16) are read and the rest of the 16 is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// bf16 (sm_90a): a persistent grid of one block an SM walks the 128 x BN
// output tiles (BN 128 or 256, by shape). Warpgroup 0 is the producer: one
// thread keeps TMA loads of the A and W tiles in flight, K chunks of 64 (one
// 128-byte row, 128B swizzle), into a ring of shared-memory stages guarded
// by full / empty mbarriers. Warpgroups 1 and 2 are the consumers, 64 rows
// each, on wgmma m64nBNk16 (both operands from shared memory through
// descriptors, f32 sums in registers). The epilogue adds the f32 bias,
// rounds once to bf16, stages the consumer's 64 x BN slice in shared memory
// and writes it as 16-byte stores at the row's place, while the producer
// already loads the next tile.
constexpr int kBM = 128, kBK = 64;
constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kWgThreads = 128 * (1 + kConsumers);
constexpr int kTileA = kBM * kBK * 2;             // bytes of a stage's A tile
constexpr size_t kSmemMax = 232448;               // dynamic shared memory a block may have

template <int BN>
struct Tile {
  static constexpr int kTileB = BN * kBK * 2;     // bytes of a stage's W tile
  static constexpr int kLDE = BN + 8;             // epilogue staging row stride (bf16)
  static constexpr size_t kStaging = size_t(kConsumers) * 64 * kLDE * 2;
  // 1 KB to align the ring to 1024 bytes (128B swizzle), the output rows'
  // destinations, the barriers; then as many stages as fit, at most 5
  static constexpr size_t kFixed = 1024 + kStaging + 8 * kBM + 16 * 5;
  static constexpr int kFit = int((kSmemMax - kFixed) / (kTileA + kTileB));
  static constexpr int kStages = kFit < 5 ? kFit : 5;
  static constexpr size_t kSmem = kFixed + size_t(kStages) * (kTileA + kTileB);
};
constexpr int kSBM = 128, kSBN = 64, kSKC = 16;  // f32 SIMT tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// 2D TMA load of the box at (c0 inner, c1 outer) into dst; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// wgmma descriptor of a K-major bf16 tile with 128B swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of the sums across a wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d += A B^T, m64nNk16 (N = 128 or 256: 64 or 128 sums a thread), bf16 in,
// f32 sums. d[4 j + e] sits at row 16 warp + lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The bf16 GEMM over all tiles: out = A @ W^T + bias, A [M, K] and W [N, K]
// through the tensor maps ta / tw (K-contiguous, 128B swizzle, boxes of
// 64 x 128 and 64 x BN, zeros beyond the edges). kScatter: output row m
// goes to out + row_offset(g, m) (padding rows dropped); else to out + m N.
template <bool kScatter, int BN>
__device__ __forceinline__ void gemm_bf16(const CUtensorMap* ta, const CUtensorMap* tw,
                                          const float* __restrict__ bias, bf16* __restrict__ out,
                                          const Geo& g, int M, int N, int K,
                                          unsigned char* smem_raw) {
  using L = Tile<BN>;
  constexpr int kStages = L::kStages, kTileB = L::kTileB, kLDE = L::kLDE;
  unsigned char* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + kStages * kTileA);
  bf16* staging = reinterpret_cast<bf16*>(smem + kStages * (kTileA + kTileB));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * (kTileA + kTileB) + L::kStaging);
  uint64_t* empty = full + kStages;
  long long* dst_rows = reinterpret_cast<long long*>(empty + kStages);  // [kBM]
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int KT = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);                    // the producer's arrival + the bytes
      mbar_init(empty + s, 4 * kConsumers);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dealloc<40>();
    if (t == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty + s, ph ^ 1);  // the consumers are done with the stage
          mbar_expect_tx(full + s, kTileA + kTileB);
          tma_load(sA + s * (kTileA / 2), ta, full + s, kt * kBK, m0);
          tma_load(sB + s * (kTileB / 2), tw, full + s, kt * kBK, n0);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  regs_alloc<232>();
  const int c = wg - 1, warp = t / 32, lane = t % 32;
  bf16* st = staging + c * 64 * kLDE;
  long long* s_dst = dst_rows + c * 64;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(full + s, ph);
      const bf16* a = sA + s * (kTileA / 2) + c * 64 * kBK;
      const bf16* b = sB + s * (kTileB / 2);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes along the swizzled row
        wgmma_bf16(acc, sw128_desc(a + kk * 16), sw128_desc(b + kk * 16));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products have read their stage
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
      prev = s;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + prev);

    // epilogue: + bias (f32), one rounding, staged, 16-byte stores at each
    // row's destination (computed once a row)
    bar_sync(1 + c, 128);  // the last tile's stores have read the staging
    if (t < 64) {
      const int m = m0 + c * 64 + t;
      s_dst[t] = m >= M ? -1 : (kScatter ? row_offset(g, m) : static_cast<long long>(m) * N);
    }
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2, gc = n0 + col;
      const float b0 = gc < N ? bias[gc] : 0.0f, b1 = gc + 1 < N ? bias[gc + 1] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(st + r0 * kLDE + col) =
          __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8) * kLDE + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
    }
    bar_sync(1 + c, 128);
    for (int e = t; e < 64 * (BN / 8); e += 128) {
      const int r = e / (BN / 8), c8 = e % (BN / 8) * 8;
      const long long base = s_dst[r];  // -1: past M, or a padding token (cropped)
      if (base < 0 || n0 + c8 >= N) continue;
      *reinterpret_cast<uint4*>(out + base + n0 + c8) =
          *reinterpret_cast<const uint4*>(st + r * kLDE + c8);
    }
  }
}

// ---- host side of the bf16 GEMM
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 [rows, cols] matrix in boxes of 64 x
// box_rows with 128B swizzle; cudaError_t
inline int encode_sw128(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// What a launch of the bf16 GEMM needs: the tile width, both tensor maps and the grid
struct Plan {
  CUtensorMap ta, tw;
  int bn, grid, tiles, err;
};

// BN 256 where N splits into at least three 256-wide tiles and they still
// make two waves over the SMs: a third less operand traffic per product than
// 128 x 128 tiles, which pays at the qkv widths (768-3840); the projections'
// narrower N (256-1280) keeps 128, for more tiles and five stages in place of
// three (gemm_probe.py --tile 128 / 256 times either width; PERF.md, PR 6)
inline int tile_width(int M, int N, int sms) {
  const int tiles256 = (M + kBM - 1) / kBM * (N / 256);
  return N % 256 == 0 && N >= 3 * 256 && tiles256 >= 2 * sms ? 256 : 128;
}

inline Plan plan_bf16(const void* a, const void* w, int M, int N, int K) {
  Plan p{};
  int dev = 0, sms = 0;
  p.err = static_cast<int>(cudaGetDevice(&dev));
  if (p.err == 0)
    p.err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  p.bn = tile_width(M, N, sms);
  if (p.err == 0) p.err = encode_sw128(&p.ta, a, M, K, kBM);
  if (p.err == 0) p.err = encode_sw128(&p.tw, w, N, K, p.bn);
  p.tiles = (M + kBM - 1) / kBM * ((N + p.bn - 1) / p.bn);
  p.grid = p.tiles < sms ? p.tiles : sms;
  return p;
}

// Per-row facts of the block's rows, set once: kLN (qkv product): the
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

// Block size and occupancy of the two GEMM kernels by compute type
template <typename T>
struct GemmLaunch {
  static constexpr int kBlock = kThreads, kMinBlocks = 2;  // f32: SIMT tiles
};
template <>
struct GemmLaunch<bf16> {
  static constexpr int kBlock = gemm::kWgThreads, kMinBlocks = 1;  // persistent wgmma
};

// ---- bf16: LN(x) rounded to bf16, in window order: a [m] = round(LN(x
// [row_offset(m)])), 0 for a padding token. `lanes` lanes a row (a power of
// two, at most 32), each holding up to kChunks 16-byte chunks of it in
// registers, so x is read once; two-pass variance in f32. Bytes bind it: the
// instances by kChunks keep the registers, and so the loads in flight an
// SM, at what the row needs.
constexpr int kMaxLnC = 32 * 8 * 8;  // 2048 channels: 8 chunks a lane

template <typename TX, int kChunks>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const TX* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, bf16* __restrict__ a, Geo g, int M, int lanes,
               float eps) {
  const int C = g.C, nch = C / 8;
  const int lane = threadIdx.x & 31, sl = lane % lanes;
  const int m = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * (32 / lanes) + lane / lanes;
  const long long off = m < M ? row_offset(g, m) : -1;
  float v[kChunks][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = sl + i * lanes;
    if (off >= 0 && ch < nch) {
      load8(x + off + 8 * ch, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  for (int d = lanes / 2; d; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
  const float mu = sum / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = sl + i * lanes;
    if (off >= 0 && ch < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dx = v[i][e] - mu;
        sq += dx * dx;
      }
    }
  }
  for (int d = lanes / 2; d; d >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, d);
  const float rs = rsqrtf(sq / C + eps);
  if (m >= M) return;
  bf16* dst = a + static_cast<long long>(m) * C;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int ch = sl + i * lanes;
    if (ch < nch) {
      __align__(16) bf16 o[8];
      float gv[8], bv[8];
      load8(ln_g + 8 * ch, gv);
      load8(ln_b + 8 * ch, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = __float2bfloat16(off >= 0 ? ((v[i][e] - mu) * rs) * gv[e] + bv[e] : 0.0f);
      *reinterpret_cast<uint4*>(dst + 8 * ch) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// ---- the qkv product: qkv [M, 3C] = LN(x)[window order] @ Wqkv^T + bqkv.
// bf16: the LN rows come in as the tensor map ta (ln_rows_kernel's output),
// Wqkv as tw; f32: x is gathered and normalised as it loads (SIMT tile).
template <typename TX, typename T, int BN = 128>
__global__ void __launch_bounds__(GemmLaunch<T>::kBlock, GemmLaunch<T>::kMinBlocks)
qkv_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                const TX* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                const T* __restrict__ wqkv, const float* __restrict__ bqkv, T* __restrict__ qkv,
                Geo g, int M, int tokens) {
  if constexpr (std::is_same<T, bf16>::value) {
    extern __shared__ __align__(128) unsigned char smem[];
    gemm::gemm_bf16<false, BN>(&ta, &tw, bqkv, qkv, g, M, 3 * g.C, g.C, smem);
  } else {
    gemm::tile_f32<true>(x, stats, ln_g, ln_b, tokens, wqkv, bqkv, qkv, g, M, 3 * g.C, g.C);
  }
}

template <int BN>
int launch_qkv_bf16(const gemm::Plan& p, const void* bqkv, void* qkv, const Geo& g, int M,
                    int tokens, cudaStream_t stream) {
  auto kernel = qkv_gemm_kernel<bf16, bf16, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(gemm::Tile<BN>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, gemm::kWgThreads, gemm::Tile<BN>::kSmem, stream>>>(
      p.ta, p.tw, nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(bqkv),
      static_cast<bf16*>(qkv), g, M, tokens);
  return static_cast<int>(cudaGetLastError());
}

// The qkv product (qkv [B * nW * n, 3C] of T) and what it needs, queued on
// `stream`: bf16: ln_rows_kernel into lnx [B * nW * n, C] bf16 (16-byte
// aligned, as x, ln_g, ln_b, wqkv and qkv; C % 8 == 0, C <= kMaxLnC), then the wgmma
// GEMM; f32: ln_stats_kernel into stats [2 * tokens] f32, then the SIMT GEMM.
// The cudaError_t of the first launch that failed.
template <typename TX, typename T>
int launch_ln_qkv(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                  const void* bqkv, void* stats, void* lnx, void* qkv, const Geo& g, float eps,
                  cudaStream_t stream) {
  const int tokens = g.B * g.H * g.W;
  const int M = g.B * g.nwy * g.nwx * g.n;
  if constexpr (std::is_same<T, bf16>::value) {
    if (g.C % 8 != 0 || g.C > kMaxLnC || !aligned16(x) || !aligned16(ln_g) || !aligned16(ln_b) ||
        !aligned16(wqkv) || !aligned16(lnx) || !aligned16(qkv))
      return static_cast<int>(cudaErrorInvalidValue);
    // at least two chunks a lane where the row has them: more bytes in flight
    int lanes = 1;
    while (2 * lanes < g.C / 8 && lanes < 32) lanes *= 2;
    const int chunks = (g.C / 8 + lanes - 1) / lanes;  // a lane's, at most 8
    const int rows = kWarps * (32 / lanes);            // a block's
    auto kernel_ln = chunks <= 1   ? ln_rows_kernel<TX, 1>
                     : chunks <= 2 ? ln_rows_kernel<TX, 2>
                     : chunks <= 4 ? ln_rows_kernel<TX, 4>
                     : chunks <= 5 ? ln_rows_kernel<TX, 5>  // ViT-H's 1280 channels
                                   : ln_rows_kernel<TX, 8>;
    kernel_ln<<<(M + rows - 1) / rows, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<bf16*>(lnx), g, M, lanes, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const gemm::Plan p = gemm::plan_bf16(lnx, wqkv, M, 3 * g.C, g.C);
    if (p.err != 0) return p.err;
    return p.bn == 256 ? launch_qkv_bf16<256>(p, bqkv, qkv, g, M, tokens, stream)
                       : launch_qkv_bf16<128>(p, bqkv, qkv, g, M, tokens, stream);
  } else {
    ln_stats_kernel<TX><<<(tokens + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<float*>(stats), tokens, g.C, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((M + gemm::kSBM - 1) / gemm::kSBM, (3 * g.C + gemm::kSBN - 1) / gemm::kSBN);
    qkv_gemm_kernel<TX, T><<<grid, kThreads, 0, stream>>>(
        CUtensorMap{}, CUtensorMap{}, static_cast<const TX*>(x), static_cast<const float*>(stats),
        static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
        static_cast<const T*>(wqkv), static_cast<const float*>(bqkv), static_cast<T*>(qkv), g, M,
        tokens);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wattn
