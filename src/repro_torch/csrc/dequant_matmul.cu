// Weight-only dequant-matmul: out (M, N) = x (M, K) @ dequantize(w), in the
// type of x (bf16 or f32), accumulated in f32.
//
// Replaces the TPU kernels `dequant_matmul_int8_pallas` and
// `dequant_matmul_int4_pallas` (src/repro/kernels/dequant_matmul/
// dequant_matmul.py). What they compute:
//  * int8, w (K, N) int8 with per-column f32 scale (N,): raw integer products
//    accumulate over all of K and `scale[n]` multiplies once at write-out.
//  * int4, w packed (K/2, N) uint8 (row r: input row 2r in the low nibble,
//    2r+1 in the high one, each sign-extended from [-8, 7]) with f32 scales
//    (G, N) over groups of gs = K/G rows: each group's partial sum is
//    multiplied by `scale[g, n]` before it joins the accumulator.
// The int8 kernel is the int4 one with a single group of gs = K rows.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
//  * decode (M = 32 rows for chatglm3-6b's 8 x 4 sequences): bytes. The
//    weight is read once: 57 MB (int8) or 36 MB (int4 with its scales) for a
//    4096 x 13696 layer, 17 us and 11 us at the memory rate, against 2 FLOP
//    per weight and 32 rows.
//  * prefill (M = 2048 or 8192): operations, 2 M K N.
//
// What the design does about it:
//  * A block owns a 64 x 64 output tile and loops over K itself in tiles of
//    64 (the TPU's sequential contraction grid axis becomes this loop). At
//    decode all M <= 64 rows sit in one block, so every weight byte is read
//    from device memory once; m tiles are the fast grid axis, so at prefill
//    the blocks that share a weight tile run together and share it in L2.
//  * Tiles move with cp.async, 16 bytes a thread, four stages in flight,
//    when the rows are 16-byte aligned (N % 16 == 0, K * sizeof(x) % 16 ==
//    0, aligned base pointers); other shapes load element by element, masked
//    at the ragged edges. Nothing is padded or copied on the host.
//  * bf16 x: tensor cores, mma.sync m16n8k16 on bf16 operands with f32
//    accumulation. Every int8 value in [-127, 127] and int4 value in
//    [-8, 7] is exact in bf16, so the products are exact and the scales stay
//    outside them. The int4 B fragment of a thread is two packed bytes: a
//    byte holds the two rows (2t, 2t+1) that a fragment register pairs.
//  * Groups: gs is even but need not divide the 16-row step or the 64-row
//    tile (gs = 24, 8). A group boundary never splits a row pair, so a step
//    that holds rows of several groups runs one mma per group with the A
//    fragment's pairs of other groups zeroed; the group's partial sum is
//    scaled into the accumulator where the group ends, in whichever step or
//    tile that is.
//  * f32 x: scalar f32 FMAs with the same groups (no TF32: the f32 path is
//    held to the plain version at 1e-4).
// These tiled kernels serve what the kernels below do not take: f32 x for
// int8 at every M and for int4 at M > 64, and shapes TMA or 16-byte copies
// cannot stride (int4 also: groups other than 16, 32, 64 at M > 64); they
// do not split K.
//
// M > 64 (prefill), bf16 x: `dequant_matmul_int4_tc_kernel` and
// `dequant_matmul_int8_tc_kernel` (see their notes): x and the quantized
// weight arrive by TMA, the consumers dequantize each stage into a swizzled
// bf16 tile that wgmma reads as B. int4 scales each group's f32 partial into
// the accumulator; int8 has one accumulator over all of K and scales at
// write-out.
//
// M <= 64 (decode): the split-K kernels (`dequant_matmul_int4_splitk_*_kernel`
// and, for bf16 x, `dequant_matmul_int8_splitk_kernel`, the same design
// over one byte a weight with the scale applied once, where a strip is
// written).
// At decode the tiled kernel's time per 64-row k tile was the same at every
// shape, whatever its grid: the serial latency of a block's k loop, not
// bytes, bounded it: a lone block waits on the latency of its own
// instruction stream. So the design cuts instructions per weight byte and
// spreads the loop over more blocks:
//  * The wrapper's planner (kernels/dequant_matmul/split.py) cuts N into
//    strips of 128 columns and K into slices whose lengths are multiples of
//    the 128-row k tile and of gs, so that a group never spans two slices:
//    as many slices as fill a wave of resident blocks, at most eight. A
//    block owns one (slice, strip); the slices of a strip are the fast grid
//    axis.
//  * Each 128-row stage carries the strip's packed weight rows, x's rows
//    of those k and the rows of `scale` the stage's groups need, by 16-byte
//    cp.async from offsets fixed for the whole block; two stages alternate.
//    No scale load sits on the accumulator's critical path.
//  * bf16 x: the operands swap. The dequantized weight is the A operand (16
//    output columns x k16 a warp) and x^T the B operand, so M = 32 rows of x
//    are the N of the product and no warp idles. One packed byte is exactly
//    the (2t, 2t+1) pair of an A register: a byte permute, one three-input
//    logic op and one bf16x2 subtract turn it into two exact bf16 values. A
//    warp owns 32 columns as two 16-row tiles whose rows are columns 4q,
//    4q+1 and 4q+2, 4q+3, so a thread's four A bytes of a k row are one
//    32-bit shared load and its outputs four adjacent columns. The product
//    is mma.sync m16n8k16, B fragments two n8 tiles an ldmatrix.x4. Each
//    group's f32 partial sum is multiplied by its scale, as the tiled kernel
//    and the TPU kernel do; groups that do not fill whole 16-row steps (gs =
//    8, 24) zero the x pairs of other groups, as there. (A wgmma m64nNk16
//    version, weight in registers and a wait at every group's end, ran
//    slower at chatglm's decode on an H100.)
//  * f32 x: one column a thread, scalar f32 FMAs, the same groups.
//  * Merge in the same launch: with more than one slice, each block writes
//    its f32 partial (M x 128) to a workspace the wrapper keeps; the last
//    block of a strip, told by a counter that it resets to 0, sums the
//    slices in slice order and writes x's type. No atomics touch the
//    output, so a call's result is the same bit for bit from call to call.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // input rows (K) per tile
constexpr int STAGES = 4;    // tiles in flight
constexpr int THREADS = 128;
constexpr int WS = BN + 16;  // weight tile row stride in bytes (16 B aligned)

template <typename T, bool INT4>
struct Tile {
  // x tile row stride in elements: rows stay 16 B aligned for cp.async, and
  // the bf16 fragment loads of 8 rows x 4 pairs hit 32 distinct banks
  static constexpr int XS = sizeof(T) == 2 ? BK + 8 : BK + 4;
  static constexpr int WR = INT4 ? BK / 2 : BK;  // weight tile rows (bytes)
  static constexpr int X_BYTES = (int)sizeof(T) * BM * XS;
  static constexpr int STAGE = X_BYTES + WR * WS;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile kt of x (BM x BK) and of the weight (BK rows, or BK/2 packed rows, x
// BN) into one stage of shared memory; zeros outside the matrices.
template <typename T, bool INT4, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* stage, const T* __restrict__ x,
                                          const uint8_t* __restrict__ w, int M, int N, int K,
                                          int m0, int n0, int k0) {
  using TL = Tile<T, INT4>;
  T* xs = reinterpret_cast<T*>(stage);
  uint8_t* ws = stage + TL::X_BYTES;
  const int tid = threadIdx.x;
  const int wr0 = INT4 ? k0 / 2 : k0;
  const int WK = INT4 ? K / 2 : K;
  if (VEC) {
    constexpr int EPC = 16 / (int)sizeof(T);  // x elements per 16 B chunk
    constexpr int XCPR = BK / EPC;            // chunks per x tile row
    for (int c = tid; c < BM * XCPR; c += THREADS) {
      const int r = c / XCPR, kc = (c % XCPR) * EPC;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;  // K % EPC == 0: a chunk is all in or all out
      cp_async16(xs + r * TL::XS + kc, ok ? x + (long long)gm * K + gk : x, ok);
    }
    constexpr int WCPR = BN / 16;
    for (int c = tid; c < TL::WR * WCPR; c += THREADS) {
      const int r = c / WCPR, nc = (c % WCPR) * 16;
      const int gr = wr0 + r, gn = n0 + nc;
      const bool ok = gr < WK && gn < N;  // N % 16 == 0
      cp_async16(ws + r * WS + nc, ok ? w + (long long)gr * N + gn : w, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[r * TL::XS + kk] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : from_f32<T>(0.f);
    }
    for (int i = tid; i < TL::WR * BN; i += THREADS) {
      const int r = i / BN, nn = i % BN;
      const int gr = wr0 + r, gn = n0 + nn;
      ws[r * WS + nn] = (gr < WK && gn < N) ? w[(long long)gr * N + gn] : (uint8_t)0;
    }
  }
}

__device__ __forceinline__ int nibble(unsigned p) { return (int)((p & 0xFu) ^ 8u) - 8; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- bf16 x
// Four warps in a 2 x 2 layout, each owning 32 rows x 32 columns of the
// tile: 2 m16 x 4 n8 mma tiles, an accumulator and a group partial sum each.
template <bool INT4, bool VEC>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ w, const float* __restrict__ scale,
                               __nv_bfloat16* __restrict__ out, int M, int N, int K, int gs) {
  using TL = Tile<__nv_bfloat16, INT4>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, t = lane & 3;
  const bool active = m0 + wm < M;  // warp-uniform: rows of this warp exist

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile<__nv_bfloat16, INT4, VEC>(smem + s * TL::STAGE, x, w, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 fully consumed
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_tile<__nv_bfloat16, INT4, VEC>(smem + (pf % STAGES) * TL::STAGE, x, w, M, N, K, m0, n0,
                                          pf * BK);
    cp_async_commit();
    if (!active) continue;

    const unsigned char* stage = smem + (kt % STAGES) * TL::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage);
    const uint8_t* ws = stage + TL::X_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      const int k0 = kt * BK + ks;
      if (k0 >= K) break;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = xs + (wm + mi * 16 + gq) * TL::XS + ks + 2 * t;
        a[mi][0] = ld32(p);                   // row gq,     k 2t, 2t+1
        a[mi][1] = ld32(p + 8 * TL::XS);      // row gq + 8
        a[mi][2] = ld32(p + 8);               // row gq,     k 2t+8, 2t+9
        a[mi][3] = ld32(p + 8 * TL::XS + 8);  // row gq + 8
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + gq;
        if (INT4) {
          const unsigned p0 = ws[(ks / 2 + t) * WS + n];      // rows 2t, 2t+1
          const unsigned p1 = ws[(ks / 2 + t + 4) * WS + n];  // rows 2t+8, 2t+9
          b[ni][0] = pack_bf16((float)nibble(p0), (float)nibble(p0 >> 4));
          b[ni][1] = pack_bf16((float)nibble(p1), (float)nibble(p1 >> 4));
        } else {
          const int8_t* c = reinterpret_cast<const int8_t*>(ws) + (ks + 2 * t) * WS + n;
          b[ni][0] = pack_bf16((float)c[0], (float)c[WS]);
          b[ni][1] = pack_bf16((float)c[8 * WS], (float)c[9 * WS]);
        }
      }
      const int k_end = min(k0 + 16, K);
      const int g_first = k0 / gs, g_last = (k_end - 1) / gs;
      for (int g = g_first; g <= g_last; ++g) {
        // zero the row pairs of other groups (a pair never straddles two)
        const bool lo = g_first == g_last || (k0 + 2 * t) / gs == g;
        const bool hi = g_first == g_last || (k0 + 2 * t + 8) / gs == g;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint32_t am[4] = {lo ? a[mi][0] : 0u, lo ? a[mi][1] : 0u, hi ? a[mi][2] : 0u,
                                  hi ? a[mi][3] : 0u};
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], am, b[ni]);
        }
        if (min((g + 1) * gs, K) <= k0 + 16) {  // group g ends in this step
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int n = n0 + wn + ni * 8 + 2 * t;
            const float* sg = scale + (long long)g * N;
            const float s0 = n < N ? __ldg(sg + n) : 0.f;
            const float s1 = n + 1 < N ? __ldg(sg + n + 1) : 0.f;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              acc[mi][ni][0] = fmaf(part[mi][ni][0], s0, acc[mi][ni][0]);
              acc[mi][ni][1] = fmaf(part[mi][ni][1], s1, acc[mi][ni][1]);
              acc[mi][ni][2] = fmaf(part[mi][ni][2], s0, acc[mi][ni][2]);
              acc[mi][ni][3] = fmaf(part[mi][ni][3], s1, acc[mi][ni][3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + wm + mi * 16 + gq;
      const int c = n0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r and r + 8
        const int rr = r + 8 * h;
        if (rr >= M) continue;
        __nv_bfloat16* o = out + (long long)rr * N + c;
        if (c < N) o[0] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (c + 1 < N) o[1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
    }
}

// ----------------------------------------------------------------- f32 x
// Thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3.
template <bool INT4, bool VEC>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                              const float* __restrict__ scale, float* __restrict__ out, int M,
                              int N, int K, int gs) {
  using TL = Tile<float, INT4>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[8][4], part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile<float, INT4, VEC>(smem + s * TL::STAGE, x, w, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  int g = 0, g_end = min(gs, K);  // current group and its end row
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_tile<float, INT4, VEC>(smem + (pf % STAGES) * TL::STAGE, x, w, M, N, K, m0, n0, pf * BK);
    cp_async_commit();

    const unsigned char* stage = smem + (kt % STAGES) * TL::STAGE;
    const float* xs = reinterpret_cast<const float*>(stage);
    const uint8_t* ws = stage + TL::X_BYTES;
    const int kmax = min(BK, K - kt * BK);
    for (int kk = 0; kk < kmax; ++kk) {
      float xv[8], wv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = xs[(ty * 8 + i) * TL::XS + kk];
      if (INT4) {
        const uchar4 p = *reinterpret_cast<const uchar4*>(ws + (kk >> 1) * WS + tx * 4);
        const int sh = (kk & 1) * 4;
        wv[0] = (float)nibble(p.x >> sh);
        wv[1] = (float)nibble(p.y >> sh);
        wv[2] = (float)nibble(p.z >> sh);
        wv[3] = (float)nibble(p.w >> sh);
      } else {
        const char4 p = *reinterpret_cast<const char4*>(ws + kk * WS + tx * 4);
        wv[0] = (float)p.x;
        wv[1] = (float)p.y;
        wv[2] = (float)p.z;
        wv[3] = (float)p.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(xv[i], wv[j], part[i][j]);
      if (kt * BK + kk + 1 == g_end) {  // group g ends at this row
        const float* sg = scale + (long long)g * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          const float s = n < N ? __ldg(sg + n) : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = fmaf(part[i][j], s, acc[i][j]);
            part[i][j] = 0.f;
          }
        }
        ++g;
        g_end = min(g_end + gs, K);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 8 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < N) out[(long long)r * N + c] = acc[i][j];
    }
  }
}

template <bool INT4, bool VEC>
int launch_vec(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
               int gs, int is_bf16, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaError_t err;
  if (is_bf16) {
    const int smem = STAGES * Tile<__nv_bfloat16, INT4>::STAGE;
    auto kern = dequant_matmul_bf16_kernel<INT4, VEC>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)scale, (__nv_bfloat16*)out, M,
        N, K, gs);
  } else {
    const int smem = STAGES * Tile<float, INT4>::STAGE;
    auto kern = dequant_matmul_f32_kernel<INT4, VEC>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)w, (const float*)scale, (float*)out, M, N, K, gs);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <bool INT4>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
           int gs, int is_bf16, void* stream) {
  const int x_row_bytes = K * (is_bf16 ? 2 : 4);
  const bool vec = aligned16(x) && aligned16(w) && x_row_bytes % 16 == 0 && N % 16 == 0;
  if (vec) return launch_vec<INT4, true>(x, w, scale, out, M, N, K, gs, is_bf16, stream);
  return launch_vec<INT4, false>(x, w, scale, out, M, N, K, gs, is_bf16, stream);
}

// ----------------------------------------------- int4 at decode: split K

namespace sk {

constexpr int BN = 128;       // output columns of a block: four warps x 32
constexpr int BK = 128;       // input rows (K) a stage
constexpr int WR = BK / 2;    // packed weight rows a stage
constexpr int WST = BN + 32;  // packed row stride in shared memory (bytes): a warp's
                              // A-word loads of four rows hit 32 banks
constexpr int STAGES = 2;
constexpr int THREADS = 128;

// scale rows a stage has room for: every group its BK rows can touch
__host__ __device__ __forceinline__ int scale_rows(int gs) { return (BK - 1) / gs + 2; }
// x's tile in a stage: rows of XS elements, padded so that rows stay 16-byte
// aligned and the eight rows an ldmatrix reads hit distinct banks
template <typename T>
constexpr int XS = BK + (sizeof(T) == 2 ? 8 : 4);
__host__ __device__ __forceinline__ int x_tile_bytes(int elem, int rows) {
  return elem * rows * (elem == 2 ? XS<__nv_bfloat16> : XS<float>);
}
// a stage: the packed weight tile, then x's tile, then the scale rows; every
// part 128-byte aligned
__host__ __device__ __forceinline__ int stage_bytes(int elem, int rows, int gs) {
  return WR * WST + x_tile_bytes(elem, rows) + scale_rows(gs) * BN * (int)sizeof(float);
}
size_t smem_bytes(int elem, int rows, int gs) {
  return 128 + (size_t)STAGES * stage_bytes(elem, rows, gs);
}

// x's rows 0 .. ROWS-1 at columns k0 .. k0+BK-1 into a stage's x tile by
// 16-byte cp.async, from offsets fixed for the block (rows tid / CPR + i
// (128 / CPR)); zeros past M and K (K % (16 / sizeof(T)) == 0: a chunk is
// all in or all out).
template <typename T, int ROWS>
__device__ __forceinline__ void load_x(unsigned char* xt, const T* __restrict__ x, int M, int K,
                                       int k0) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = BK / EPC, RPI = THREADS / CPR;
  const int tid = threadIdx.x;
  const int r = tid / CPR, kc = (tid % CPR) * EPC;
  const bool k_ok = k0 + kc < K;
  const T* src = x + (long long)r * K + k0 + kc;
#pragma unroll
  for (int i = 0; i < ROWS / RPI; ++i) {
    const bool ok = k_ok && r + RPI * i < M;
    cp_async16(xt + ((r + RPI * i) * XS<T> + kc) * sizeof(T), ok ? src + (long long)RPI * i * K : x,
               ok);
  }
}

// Stage k0 .. k0+BK-1 of a block: the strip's packed weight rows k0/2 ..,
// x's rows 0 .. ROWS-1 at columns k0 .., and the scale rows of the groups
// g0 .. g_end-1 the stage touches; zeros outside the matrices. With VEC
// (16-byte aligned rows) every thread issues 16-byte cp.async at offsets
// fixed for the whole block: rows (tid / 8) + 16 i of the weight, rows
// tid / CPR + i (128 / CPR) of x, rows tid / 32 + 4 i of the scales.
template <typename T, int ROWS, bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* st, const T* __restrict__ x,
                                           const uint8_t* __restrict__ w,
                                           const float* __restrict__ scale, int M, int N, int K,
                                           int n0, int k0, int g0, int g_end) {
  uint8_t* ws = st;
  unsigned char* xt = st + WR * WST;
  float* ss = reinterpret_cast<float*>(xt + x_tile_bytes(sizeof(T), ROWS));
  const int tid = threadIdx.x, WK = K / 2, wr0 = k0 / 2, sr = g_end - g0;
  if (VEC) {
    {  // weight: WR rows x BN / 16 chunks, four a thread in one column
      const int r = tid >> 3, nc = (tid & 7) * 16;
      const bool col_ok = n0 + nc < N;
      const uint8_t* src = w + (long long)(wr0 + r) * N + n0 + nc;
#pragma unroll
      for (int i = 0; i < WR * (BN / 16) / THREADS; ++i) {
        const bool ok = col_ok && wr0 + r + 16 * i < WK;
        cp_async16(ws + (r + 16 * i) * WST + nc, ok ? src + (long long)16 * i * N : w, ok);
      }
    }
    load_x<T, ROWS>(xt, x, M, K, k0);
    {  // scales: sr rows x BN / 4 chunks
      const int r = tid >> 5, nc = (tid & 31) * 4;
      const bool col_ok = n0 + nc < N;
      for (int rr = r; rr < sr; rr += THREADS / 32) {
        cp_async16(ss + rr * BN + nc, col_ok ? scale + (long long)(g0 + rr) * N + n0 + nc : scale,
                   col_ok);
      }
    }
  } else {
    for (int i = tid; i < WR * BN; i += THREADS) {
      const int r = i / BN, nn = i % BN;
      const int gr = wr0 + r, gn = n0 + nn;
      ws[r * WST + nn] = (gr < WK && gn < N) ? w[(long long)gr * N + gn] : (uint8_t)0;
    }
    for (int i = tid; i < ROWS * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gk = k0 + kk;
      reinterpret_cast<T*>(xt)[r * XS<T> + kk] =
          (r < M && gk < K) ? x[(long long)r * K + gk] : from_f32<T>(0.f);
    }
    for (int i = tid; i < sr * BN; i += THREADS) {
      const int r = i / BN, nn = i % BN;
      const int gn = n0 + nn;
      ss[r * BN + nn] = gn < N ? scale[(long long)(g0 + r) * N + gn] : 0.f;
    }
  }
}

// k / gs for the k of this kernel (< 2^20): exact, by the f32 reciprocal
// (the quotient's fraction is at least 0.5 / gs from an integer)
__device__ __forceinline__ int group_of(int k, float inv_gs) {
  return __float2int_rz(((float)k + 0.5f) * inv_gs);
}

// Byte J of a packed word as the bf16 pair (low nibble, high nibble): the
// byte permute puts byte J of w in the low half and byte J of w >> 4 in the
// high one; masking the low nibbles, flipping their sign bits and setting
// the exponent of 128 gives 128 + (v + 8) in each half, exactly; subtracting
// 136 leaves v in [-8, 7].
template <int J>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, uint32_t w4) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  uint32_t r = __byte_perm(w, w4, sel);
  // r = (r & 0x000F000F) ^ 0x43084308 in one three-input logic op
  asm("lop3.b32 %0, %0, %1, %2, 0x6a;" : "+r"(r) : "n"(0x000F000F), "r"(0x43084308u));
  const uint32_t bias = 0x43084308u;  // (136, 136) in bf16
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a . b (the accumulator's old value is not read)
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Four adjacent outputs v[0..3] of one row at columns c .. c+3, in T; only
// those below N are written.
template <typename T>
__device__ __forceinline__ void store4(T* row, int c, int N, const float (&v)[4]) {
  if (c + 3 < N && N % 4 == 0) {
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 p[2] = {__floats2bfloat162_rn(v[0], v[1]),
                             __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(row + c) = *reinterpret_cast<uint2*>(p);
    } else {
      *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < N) row[c + e] = from_f32<T>(v[e]);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// After every block of a strip has written its partial (M x BN f32, slice
// order) at ``part``: the last block to arrive sums the slices in slice
// order, writes the strip of ``out`` and resets the strip's counter to 0.
// A thread sums P positions at once, two slices a round, so 2P loads are in
// flight at a time.
// SCALED (int8): the sum is multiplied by the columns' ``scale`` before it is
// written.
template <typename T, bool SCALED>
__device__ void merge_slices(const float* part, int* counter, T* __restrict__ out, int M, int N,
                             int n0, int n_slices, const float* __restrict__ scale) {
  constexpr int P = 4;
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == n_slices - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float4* p = reinterpret_cast<const float4*>(part);
  const int n4 = M * BN / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += P * THREADS) {
    float4 a[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int i = i0 + u * THREADS;
      a[u] = i < n4 ? __ldcg(p + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    int s = 1;
    for (; s + 2 <= n_slices; s += 2) {
      float4 b[2][P];
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int i = i0 + u * THREADS;
          if (i < n4) b[v][u] = __ldcg(p + (long long)(s + v) * n4 + i);
        }
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int u = 0; u < P; ++u)
          if (i0 + u * THREADS < n4) add4(a[u], b[v][u]);
    }
    if (s < n_slices) {
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n4) add4(a[u], __ldcg(p + (long long)s * n4 + i));
      }
    }
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= n4) continue;
      const int m = i / (BN / 4), c = n0 + (i % (BN / 4)) * 4;
      if (SCALED) {
        if (c >= N) continue;
        // N % 16 == 0 (the int8 split kernel's shapes): c + 3 < N too
        const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + c));
        a[u].x *= sc.x;
        a[u].y *= sc.y;
        a[u].z *= sc.z;
        a[u].w *= sc.w;
      }
      const float v[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
      store4<T>(out + (long long)m * N, c, N, v);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// The A fragments of the two m16 tiles of a k16 step from the thread's two
// packed words (k rows 2t, 2t+1 and 2t+8, 2t+9 of its four columns).
__device__ __forceinline__ void dequant_a(uint32_t w0, uint32_t w1, uint32_t (&a)[2][4]) {
  const uint32_t w04 = w0 >> 4, w14 = w1 >> 4;
  a[0][0] = dequant_pair<0>(w0, w04);
  a[0][1] = dequant_pair<1>(w0, w04);
  a[0][2] = dequant_pair<0>(w1, w14);
  a[0][3] = dequant_pair<1>(w1, w14);
  a[1][0] = dequant_pair<2>(w0, w04);
  a[1][1] = dequant_pair<3>(w0, w04);
  a[1][2] = dequant_pair<2>(w1, w14);
  a[1][3] = dequant_pair<3>(w1, w14);
}

// The B fragments of MT n8 tiles of x^T for one k16 step, two tiles an
// ldmatrix.x4; ``xl`` is the lane's row address of the step's first tile.
template <int MT>
__device__ __forceinline__ void load_b(uint32_t (&b)[MT][2], const __nv_bfloat16* xl) {
#pragma unroll
  for (int jp = 0; jp < MT / 2; ++jp) {
    const unsigned addr =
        (unsigned)__cvta_generic_to_shared(xl + 16 * jp * XS<__nv_bfloat16>);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[2 * jp][0]), "=r"(b[2 * jp][1]), "=r"(b[2 * jp + 1][0]),
                   "=r"(b[2 * jp + 1][1])
                 : "r"(addr));
  }
}

// prt[i] (+)= a[i] . b for both m16 tiles i and every n8 tile j (prt[i]'s
// fragments 4j .. 4j+3); FIRST: the group starts here.
template <int MT, bool FIRST>
__device__ __forceinline__ void mma_step(float (&prt)[2][4 * MT], const uint32_t (&a)[2][4],
                                         const uint32_t (&b)[MT][2]) {
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float(&d)[4] = *reinterpret_cast<float(*)[4]>(&prt[i][4 * j]);
      if (FIRST)
        mma_bf16_first(d, a[i], b[j]);
      else
        mma_bf16(d, a[i], b[j]);
    }
}

// acc += prt * the group's scales of the thread's four columns (tile 0:
// columns 4gq, 4gq+1; tile 1: 4gq+2, 4gq+3).
template <int MT>
__device__ __forceinline__ void fold(float (&acc)[2][4 * MT], const float (&prt)[2][4 * MT],
                                     const float* ss) {
  const float4 s = *reinterpret_cast<const float4*>(ss);
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    acc[0][4 * j + 0] = fmaf(prt[0][4 * j + 0], s.x, acc[0][4 * j + 0]);
    acc[0][4 * j + 1] = fmaf(prt[0][4 * j + 1], s.x, acc[0][4 * j + 1]);
    acc[0][4 * j + 2] = fmaf(prt[0][4 * j + 2], s.y, acc[0][4 * j + 2]);
    acc[0][4 * j + 3] = fmaf(prt[0][4 * j + 3], s.y, acc[0][4 * j + 3]);
    acc[1][4 * j + 0] = fmaf(prt[1][4 * j + 0], s.z, acc[1][4 * j + 0]);
    acc[1][4 * j + 1] = fmaf(prt[1][4 * j + 1], s.z, acc[1][4 * j + 1]);
    acc[1][4 * j + 2] = fmaf(prt[1][4 * j + 2], s.w, acc[1][4 * j + 2]);
    acc[1][4 * j + 3] = fmaf(prt[1][4 * j + 3], s.w, acc[1][4 * j + 3]);
  }
}

// The ring's start: stages 0 .. STAGES-2 of the block's slice in flight.
template <typename T, int ROWS, bool VEC>
__device__ __forceinline__ void fill_ring(unsigned char* ring, int sb, const T* x,
                                          const uint8_t* w, const float* scale, int M, int N,
                                          int K, int n0, int kbeg, int kend, int nk,
                                          float inv_gs) {
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      const int k0 = kbeg + s * BK;
      load_stage<T, ROWS, VEC>(ring + s * sb, x, w, scale, M, N, K, n0, k0, group_of(k0, inv_gs),
                               group_of(min(k0 + BK, kend) - 1, inv_gs) + 1);
    }
    cp_async_commit();
  }
}

// Tile kt of the slice landed: issue the load of tile kt + STAGES - 1.
template <typename T, int ROWS, bool VEC>
__device__ __forceinline__ void advance_ring(unsigned char* ring, int sb, int kt, const T* x,
                                             const uint8_t* w, const float* scale, int M, int N,
                                             int K, int n0, int kbeg, int kend, int nk,
                                             float inv_gs) {
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // tile kt landed; tile kt - 1 fully consumed
  const int pf = kt + STAGES - 1;
  if (pf < nk) {
    const int k0 = kbeg + pf * BK;
    load_stage<T, ROWS, VEC>(ring + (pf % STAGES) * sb, x, w, scale, M, N, K, n0, k0,
                             group_of(k0, inv_gs),
                             group_of(min(k0 + BK, kend) - 1, inv_gs) + 1);
  }
  cp_async_commit();
}

// ---------------------------------------------------------------- bf16 x
// MT n8 tiles of x rows (M <= 8 MT); ALIGNED: gs % 16 == 0, one group a
// 16-row step.
template <int MT, bool VEC, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_int4_splitk_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ w,
                                           const float* __restrict__ scale,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ part, int* __restrict__ counters,
                                           int M, int N, int K, int gs, int slice_k) {
  constexpr int ROWS = 8 * MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const int slice = blockIdx.x, n_slices = gridDim.x, strip = blockIdx.y;
  const int n0 = strip * BN;
  const int kbeg = slice * slice_k, kend = min(K, kbeg + slice_k);
  const int nk = (kend - kbeg + BK - 1) / BK;
  const float inv_gs = 1.f / (float)gs;
  const int sb = stage_bytes(2, ROWS, gs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  // the lane's ldmatrix row within a stage's x tile: matrix q = lane / 8 of
  // an x4 holds rows 8 (q / 2) .., k 8 (q % 2) ..
  const int xl_off =
      (8 * (lane >> 4) + (lane & 7)) * XS<__nv_bfloat16> + 8 * ((lane >> 3) & 1);

  fill_ring<__nv_bfloat16, ROWS, VEC>(smem, sb, x, w, scale, M, N, K, n0, kbeg, kend, nk,
                                      inv_gs);

  // acc / prt [m16 tile i][4j + e]: tile i's rows are the columns 4gq + 2i
  // (e = 0, 1) and 4gq + 2i + 1 (e = 2, 3) of this warp's 32; fragment e
  // holds x row 8j + 2t + (e & 1)
  float acc[2][4 * MT], prt[2][4 * MT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4 * MT; ++e) acc[i][e] = prt[i][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    advance_ring<__nv_bfloat16, ROWS, VEC>(smem, sb, kt, x, w, scale, M, N, K, n0, kbeg, kend,
                                           nk, inv_gs);
    const unsigned char* st = smem + (kt % STAGES) * sb;
    const uint8_t* wt = st + warp * 32 + 4 * gq;
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(st + WR * WST);
    const float* ss = reinterpret_cast<const float*>(st + WR * WST + x_tile_bytes(2, ROWS)) +
                      warp * 32 + 4 * gq;
    const int k0 = kbeg + kt * BK;
    const int g0 = group_of(k0, inv_gs);
    if (ALIGNED && k0 + BK <= kend) {
      // a whole tile of whole-step groups: no bound or group arithmetic a step
      int gpos = k0 - g0 * gs;  // rows of group g0 before this tile
      int gi = 0;               // the group's scale row in the stage
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[2][4], b[MT][2];
        dequant_a(*reinterpret_cast<const uint32_t*>(wt + (ks * 8 + t) * WST),
                  *reinterpret_cast<const uint32_t*>(wt + (ks * 8 + t + 4) * WST), a);
        load_b<MT>(b, xt + xl_off + 16 * ks);
        if (gpos == 0)
          mma_step<MT, true>(prt, a, b);
        else
          mma_step<MT, false>(prt, a, b);
        gpos += 16;
        if (gpos == gs) {
          fold<MT>(acc, prt, ss + gi * BN);
          ++gi;
          gpos = 0;
        }
      }
      continue;
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kabs = k0 + ks * 16;
      if (kabs >= kend) break;
      uint32_t a[2][4], b[MT][2];
      dequant_a(*reinterpret_cast<const uint32_t*>(wt + (ks * 8 + t) * WST),
                *reinterpret_cast<const uint32_t*>(wt + (ks * 8 + t + 4) * WST), a);
      load_b<MT>(b, xt + xl_off + 16 * ks);
      const int g_first = group_of(kabs, inv_gs);
      const int g_last = group_of(min(kabs + 16, kend) - 1, inv_gs);
      for (int g = g_first; g <= g_last; ++g) {
        uint32_t bm[MT][2];
        // zero the x pairs of other groups (a pair never straddles two)
        const bool lo = group_of(kabs + 2 * t, inv_gs) == g;
        const bool hi = group_of(kabs + 2 * t + 8, inv_gs) == g;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          bm[j][0] = lo ? b[j][0] : 0u;
          bm[j][1] = hi ? b[j][1] : 0u;
        }
        if (g * gs >= kabs)  // group g starts in this step
          mma_step<MT, true>(prt, a, bm);
        else
          mma_step<MT, false>(prt, a, bm);
        if ((g + 1) * gs <= kabs + 16) fold<MT>(acc, prt, ss + (g - g0) * BN);  // g ends here
      }
    }
  }
  cp_async_wait<0>();

  // this thread's outputs: x rows 8j + 2t + h, columns c .. c+3
  const int c = warp * 32 + 4 * gq;
  if (n_slices == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * j + 2 * t + h;
        const float v[4] = {acc[0][4 * j + h], acc[0][4 * j + 2 + h], acc[1][4 * j + h],
                            acc[1][4 * j + 2 + h]};
        if (m < M) store4<__nv_bfloat16>(out + (long long)m * N, n0 + c, N, v);
      }
    return;
  }
  float* pp = part + (long long)strip * n_slices * M * BN;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * j + 2 * t + h;
      if (m < M)
        *reinterpret_cast<float4*>(pp + ((long long)slice * M + m) * BN + c) =
            make_float4(acc[0][4 * j + h], acc[0][4 * j + 2 + h], acc[1][4 * j + h],
                        acc[1][4 * j + 2 + h]);
    }
  merge_slices<__nv_bfloat16, false>(pp, counters + strip, out, M, N, n0, n_slices, nullptr);
}

// ----------------------------------------------------------------- f32 x
// One output column a thread, x rows 0 .. 8 MT - 1.
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_int4_splitk_f32_kernel(const float* __restrict__ x,
                                          const uint8_t* __restrict__ w,
                                          const float* __restrict__ scale, float* __restrict__ out,
                                          float* __restrict__ part, int* __restrict__ counters,
                                          int M, int N, int K, int gs, int slice_k) {
  constexpr int ROWS = 8 * MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const int slice = blockIdx.x, n_slices = gridDim.x, strip = blockIdx.y;
  const int n0 = strip * BN;
  const int kbeg = slice * slice_k, kend = min(K, kbeg + slice_k);
  const int nk = (kend - kbeg + BK - 1) / BK;
  const float inv_gs = 1.f / (float)gs;
  const int sb = stage_bytes(4, ROWS, gs);

  fill_ring<float, ROWS, VEC>(smem, sb, x, w, scale, M, N, K, n0, kbeg, kend, nk, inv_gs);

  float acc[ROWS], prt[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) acc[m] = prt[m] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    advance_ring<float, ROWS, VEC>(smem, sb, kt, x, w, scale, M, N, K, n0, kbeg, kend, nk,
                                   inv_gs);
    const unsigned char* st = smem + (kt % STAGES) * sb;
    const uint8_t* wt = st + threadIdx.x;
    const float* xs = reinterpret_cast<const float*>(st + WR * WST);
    const float* ss =
        reinterpret_cast<const float*>(st + WR * WST + x_tile_bytes(4, ROWS)) + threadIdx.x;
    const int k0 = kbeg + kt * BK;
    const int g0 = group_of(k0, inv_gs);
    int g_next = (g0 + 1) * gs;  // the end of the current group
    const int pairs = min(BK, kend - k0) / 2;
    for (int p = 0; p < pairs; ++p) {
      const unsigned byte = wt[p * WST];
      const float lo = (float)nibble(byte), hi = (float)nibble(byte >> 4);
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + m * XS<float> + 2 * p);
        prt[m] = fmaf(xv.x, lo, prt[m]);
        prt[m] = fmaf(xv.y, hi, prt[m]);
      }
      if (k0 + 2 * p + 2 == g_next) {  // the group ends at this pair
        const float s = ss[(g_next / gs - 1 - g0) * BN];
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          acc[m] = fmaf(prt[m], s, acc[m]);
          prt[m] = 0.f;
        }
        g_next += gs;
      }
    }
  }
  cp_async_wait<0>();

  if (n_slices == 1) {
    const int col = n0 + threadIdx.x;
    if (col < N) {
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        if (m < M) out[(long long)m * N + col] = acc[m];
    }
    return;
  }
  float* pp = part + (long long)strip * n_slices * M * BN;
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    if (m < M) pp[((long long)slice * M + m) * BN + threadIdx.x] = acc[m];
  merge_slices<float, false>(pp, counters + strip, out, M, N, n0, n_slices, nullptr);
}

template <int MT, bool VEC>
int launch_rows(const void* x, const void* w, const void* scale, void* out, void* part,
                void* counters, int M, int N, int K, int gs, int slice_k, int n_slices,
                int is_bf16, void* stream) {
  const dim3 grid(n_slices, (N + BN - 1) / BN);
  const size_t smem = smem_bytes(is_bf16 ? 2 : 4, 8 * MT, gs);
  cudaError_t err;
  if (is_bf16) {
    auto kern = gs % 16 == 0 ? dequant_matmul_int4_splitk_bf16_kernel<MT, VEC, true>
                             : dequant_matmul_int4_splitk_bf16_kernel<MT, VEC, false>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)scale, (__nv_bfloat16*)out,
        (float*)part, (int*)counters, M, N, K, gs, slice_k);
  } else {
    auto kern = dequant_matmul_int4_splitk_f32_kernel<MT, VEC>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)w, (const float*)scale, (float*)out, (float*)part,
        (int*)counters, M, N, K, gs, slice_k);
  }
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_vec(const void* x, const void* w, const void* scale, void* out, void* part,
               void* counters, int M, int N, int K, int gs, int slice_k, int n_slices,
               int is_bf16, void* stream) {
  if (M <= 16)
    return launch_rows<2, VEC>(x, w, scale, out, part, counters, M, N, K, gs, slice_k,
                               n_slices, is_bf16, stream);
  if (M <= 32)
    return launch_rows<4, VEC>(x, w, scale, out, part, counters, M, N, K, gs, slice_k,
                               n_slices, is_bf16, stream);
  return launch_rows<8, VEC>(x, w, scale, out, part, counters, M, N, K, gs, slice_k, n_slices,
                             is_bf16, stream);
}

template <int MT>
int blocks_per_sm_rows(int is_bf16, int gs) {
  const size_t smem = smem_bytes(is_bf16 ? 2 : 4, 8 * MT, gs);
  int n = 0;
  cudaError_t err;
  if (is_bf16) {
    auto kern = dequant_matmul_int4_splitk_bf16_kernel<MT, true, true>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
  } else {
    auto kern = dequant_matmul_int4_splitk_f32_kernel<MT, true>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
  }
  return err == cudaSuccess ? n : 0;
}


// ---------------------------------------------------------- int8, bf16 x
// The int4 kernel's design over one byte a weight: a stage holds BK rows of
// the strip's int8 weight (row stride WST8, so that a warp's word loads of
// rows 2t, 2t+1, t = 0..3, hit 32 banks) and x's rows of those k, STAGES8
// of them in a ring. There are no groups: one f32 accumulator runs over the
// slice, and the per-column scale multiplies once, where a strip's sum is
// written.

constexpr int WST8 = BN + 16;
// stages of the int8 ring: three (two blocks an SM at 32 rows) took less
// time over a chatglm3-6b layer's seven decode projections than the int4
// kernel's two (four blocks an SM), and four no less, on an H100 80GB HBM3
// at 700 W
constexpr int STAGES8 = 3;
__host__ __device__ __forceinline__ int stage_bytes_int8(int rows) {
  return BK * WST8 + x_tile_bytes(2, rows);  // both parts 128-byte multiples
}
size_t smem_bytes_int8(int rows) { return 128 + (size_t)STAGES8 * stage_bytes_int8(rows); }

// Stage k0 .. k0+BK-1: the strip's weight rows, rows tid / 8 + 16 i a
// thread, and x's rows; zeros outside the matrices.
template <int ROWS>
__device__ __forceinline__ void load_stage_int8(unsigned char* st,
                                                const __nv_bfloat16* __restrict__ x,
                                                const int8_t* __restrict__ w, int M, int N, int K,
                                                int n0, int k0) {
  const int tid = threadIdx.x;
  const int r = tid >> 3, nc = (tid & 7) * 16;
  const bool col_ok = n0 + nc < N;  // N % 16 == 0
  const int8_t* src = w + (long long)(k0 + r) * N + n0 + nc;
#pragma unroll
  for (int i = 0; i < BK * (BN / 16) / THREADS; ++i) {
    const bool ok = col_ok && k0 + r + 16 * i < K;
    cp_async16(st + (r + 16 * i) * WST8 + nc, ok ? src + (long long)16 * i * N : w, ok);
  }
  load_x<__nv_bfloat16, ROWS>(st + BK * WST8, x, M, K, k0);
}

// Byte J of words r0 (k row 2t) and r1 (k row 2t + 1) as an exact bf16 pair:
// the byte permute puts them in the low bytes of the two halves; a half
// then holds 128 + (v & 127) with the exponent of 128 set (0x4300 | v &
// 0x7F), and 128 or 256 by the sign bit (0x4300 | v & 0x80); their
// difference is v in [-128, 127], exactly.
template <int J>
__device__ __forceinline__ uint32_t int8_pair(uint32_t r0, uint32_t r1) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t r = __byte_perm(r0, r1, sel);
  uint32_t a, b;
  // (r & mask) | 0x43004300, one three-input logic op each
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(a) : "r"(r), "n"(0x007F007F), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(b) : "r"(r), "n"(0x00800080), "r"(0x43004300u));
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the two m16 tiles of a k16 step from the thread's four
// words: k rows 2t, 2t+1, 2t+8, 2t+9 of its four columns (tile 0: columns
// 4gq, 4gq+1; tile 1: 4gq+2, 4gq+3, as in `dequant_a`).
__device__ __forceinline__ void int8_a(const uint8_t* wt, uint32_t (&a)[2][4]) {
  const uint32_t r0 = *reinterpret_cast<const uint32_t*>(wt);
  const uint32_t r1 = *reinterpret_cast<const uint32_t*>(wt + WST8);
  const uint32_t r8 = *reinterpret_cast<const uint32_t*>(wt + 8 * WST8);
  const uint32_t r9 = *reinterpret_cast<const uint32_t*>(wt + 9 * WST8);
  a[0][0] = int8_pair<0>(r0, r1);
  a[0][1] = int8_pair<1>(r0, r1);
  a[0][2] = int8_pair<0>(r8, r9);
  a[0][3] = int8_pair<1>(r8, r9);
  a[1][0] = int8_pair<2>(r0, r1);
  a[1][1] = int8_pair<3>(r0, r1);
  a[1][2] = int8_pair<2>(r8, r9);
  a[1][3] = int8_pair<3>(r8, r9);
}

// MT n8 tiles of x rows (M <= 8 MT). x, w and scale 16-byte aligned, K % 8
// == 0 and N % 16 == 0 (the planner's condition).
template <int MT>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_int8_splitk_kernel(const __nv_bfloat16* __restrict__ x,
                                      const int8_t* __restrict__ w,
                                      const float* __restrict__ scale,
                                      __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                                      int* __restrict__ counters, int M, int N, int K,
                                      int slice_k) {
  constexpr int ROWS = 8 * MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const int slice = blockIdx.x, n_slices = gridDim.x, strip = blockIdx.y;
  const int n0 = strip * BN;
  const int kbeg = slice * slice_k, kend = min(K, kbeg + slice_k);
  const int nk = (kend - kbeg + BK - 1) / BK;
  const int sb = stage_bytes_int8(ROWS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int xl_off =
      (8 * (lane >> 4) + (lane & 7)) * XS<__nv_bfloat16> + 8 * ((lane >> 3) & 1);

  for (int s = 0; s < STAGES8 - 1; ++s) {
    if (s < nk) load_stage_int8<ROWS>(smem + s * sb, x, w, M, N, K, n0, kbeg + s * BK);
    cp_async_commit();
  }

  float acc[2][4 * MT];  // as in the int4 kernel
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4 * MT; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES8 - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 fully consumed
    const int pf = kt + STAGES8 - 1;
    if (pf < nk)
      load_stage_int8<ROWS>(smem + (pf % STAGES8) * sb, x, w, M, N, K, n0, kbeg + pf * BK);
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES8) * sb;
    const uint8_t* wt = st + (2 * t) * WST8 + warp * 32 + 4 * gq;
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(st + BK * WST8);
    // rows past K (the last slice's tail) are zeros in both tiles
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4], b[MT][2];
      int8_a(wt + 16 * ks * WST8, a);
      load_b<MT>(b, xt + xl_off + 16 * ks);
      mma_step<MT, false>(acc, a, b);
    }
  }
  cp_async_wait<0>();

  // this thread's outputs: x rows 8j + 2t + h, columns c .. c+3
  const int c = warp * 32 + 4 * gq;
  if (n_slices == 1) {
    if (n0 + c >= N) return;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n0 + c));
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * j + 2 * t + h;
        const float v[4] = {acc[0][4 * j + h] * sc.x, acc[0][4 * j + 2 + h] * sc.y,
                            acc[1][4 * j + h] * sc.z, acc[1][4 * j + 2 + h] * sc.w};
        if (m < M) store4<__nv_bfloat16>(out + (long long)m * N, n0 + c, N, v);
      }
    return;
  }
  float* pp = part + (long long)strip * n_slices * M * BN;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * j + 2 * t + h;
      if (m < M)
        *reinterpret_cast<float4*>(pp + ((long long)slice * M + m) * BN + c) =
            make_float4(acc[0][4 * j + h], acc[0][4 * j + 2 + h], acc[1][4 * j + h],
                        acc[1][4 * j + 2 + h]);
    }
  merge_slices<__nv_bfloat16, true>(pp, counters + strip, out, M, N, n0, n_slices, scale);
}

template <int MT>
int launch_int8_rows(const void* x, const void* w, const void* scale, void* out, void* part,
                     void* counters, int M, int N, int K, int slice_k, int n_slices,
                     void* stream) {
  const dim3 grid(n_slices, (N + BN - 1) / BN);
  const size_t smem = smem_bytes_int8(8 * MT);
  auto kern = dequant_matmul_int8_splitk_kernel<MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (__nv_bfloat16*)out,
      (float*)part, (int*)counters, M, N, K, slice_k);
  return (int)cudaGetLastError();
}

template <int MT>
int blocks_per_sm_int8_rows() {
  const size_t smem = smem_bytes_int8(8 * MT);
  auto kern = dequant_matmul_int8_splitk_kernel<MT>;
  int n = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
  return err == cudaSuccess ? n : 0;
}

}  // namespace sk

// ------------------------------------ int4 at prefill (bf16 x): TMA + wgmma

namespace pf {

constexpr int BM = 128;                 // x rows a block: two consumer warpgroups
constexpr int BN = 128;                 // output columns a block
constexpr int BK = 64;                  // k rows a stage
constexpr int A_BYTES = BM * 128;       // BM rows x BK bf16, 128-byte swizzled
constexpr int P_BYTES = BK / 2 * BN;    // the packed weight tile
constexpr int S_BYTES = 4 * BN * 4;     // up to four scale rows (gs >= 16)
constexpr int STAGE = A_BYTES + P_BYTES + S_BYTES;  // a multiple of 1024
constexpr int B_BYTES = BK * BN * 2;    // one dequantized bf16 B tile
constexpr int CHUNK = 64 * 128;         // 64 k rows x 64 bf16 columns of B
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

size_t smem_bytes() { return 1024 + (size_t)STAGES * STAGE + 2 * B_BYTES + 16 * STAGES; }

// bf16 pair (nibble of byte J0 of w, nibble of byte J1) for the low nibbles;
// the high ones are the same of w >> 4 (the byte permute, mask, exponent and
// subtraction of `sk::dequant_pair`)
template <int J0, int J1>
__device__ __forceinline__ uint32_t dequant_cols(uint32_t w) {
  constexpr uint32_t sel = J0 | (4 << 4) | (J1 << 8) | (4 << 12);
  uint32_t r = __byte_perm(w, 0u, sel);
  asm("lop3.b32 %0, %0, %1, %2, 0x6a;" : "+r"(r) : "n"(0x000F000F), "r"(0x43084308u));
  const uint32_t bias = 0x43084308u;  // (136, 136) in bf16
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&v);
}

// out (M, N) = x (M, K) @ dequantize_int4(packed, scale) for bf16 x, with
// K % 64 == 0, N % 16 == 0 and gs in {16, 32, 64}. A block owns a 128 x 128
// output tile: two consumer warpgroups of 64 rows and a producer warp.
//  * TMA brings each 64-row stage: x's 128 x 64 tile (128-byte swizzled),
//    the strip's 32 packed rows and the stage's 64 / gs scale rows, into a
//    ring with full / empty mbarriers.
//  * The consumers dequantize the packed tile into a bf16 B tile laid out
//    as TMA would have written the (k, n) weight: 64-column chunks of 64 k
//    rows, 128-byte swizzled; two B tiles alternate, so one barrier a stage
//    suffices. wgmma m64n128k16 reads x's tile (A, K-major) and the B tile
//    through the transpose mode, as the MoE kernel reads its weight.
//  * Each group's gs / 16 wgmma steps start from a zero accumulator; the
//    group's f32 partial is scaled into acc at the group's end, as the TPU
//    kernel does.
__global__ void __launch_bounds__(THREADS, 1)
    dequant_matmul_int4_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                                  const __grid_constant__ CUtensorMap pmap,
                                  const __grid_constant__ CUtensorMap smap,
                                  __nv_bfloat16* __restrict__ out, int M, int N, int K, int gs) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = K / BK;
  const int sr = BK / gs;  // groups (scale rows) a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* btile = ring + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(btile + 2 * B_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread issues every copy
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes
        unsigned char* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], A_BYTES + P_BYTES + sr * BN * 4);
        tma_load_2d(st, &xmap, &full[s], i * BK, m0);
        tma_load_2d(st + A_BYTES, &pmap, &full[s], n0, i * BK / 2);
        tma_load_2d(st + A_BYTES + P_BYTES, &smap, &full[s], n0, i * sr);
      }
    }
    return;
  }

  const int tid = threadIdx.x, g = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  float acc[BN / 2], d[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = d[j] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* st = ring + s * STAGE;
    unsigned char* bt = btile + (i & 1) * B_BYTES;
    // dequantize: a task is 8 columns of one packed row, that is those
    // columns of k rows 2p (low nibbles) and 2p + 1 (high), one 16-byte
    // swizzle unit of each
#pragma unroll
    for (int task = tid; task < BK / 2 * BN / 8; task += CONSUMERS) {
      const int p = task >> 4, cg = task & 15;
      const uint2 v = *reinterpret_cast<const uint2*>(st + A_BYTES + p * BN + cg * 8);
      const uint32_t v4x = v.x >> 4, v4y = v.y >> 4;
      const uint4 lo = make_uint4(dequant_cols<0, 1>(v.x), dequant_cols<2, 3>(v.x),
                                  dequant_cols<0, 1>(v.y), dequant_cols<2, 3>(v.y));
      const uint4 hi = make_uint4(dequant_cols<0, 1>(v4x), dequant_cols<2, 3>(v4x),
                                  dequant_cols<0, 1>(v4y), dequant_cols<2, 3>(v4y));
      const int k = 2 * p, c = cg >> 3, u = cg & 7;
      *reinterpret_cast<uint4*>(bt + c * CHUNK + k * 128 + ((u ^ (k & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(bt + c * CHUNK + (k + 1) * 128 + ((u ^ ((k + 1) & 7)) << 4)) =
          hi;
    }
    // the B tile is visible to wgmma's reads (the async proxy) of both
    // warpgroups
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    const unsigned char* as = st + g * 64 * 128;
    const float* ss = reinterpret_cast<const float*>(st + A_BYTES + P_BYTES);
    for (int gi = 0; gi < sr; ++gi) {
      wgmma_fence();
      for (int t = gi * gs / 16; t < (gi + 1) * gs / 16; ++t)
        wgmma_m64n128k16_ss_tb(d, desc(as + t * 32, 16, 1024),
                               desc(bt + t * 16 * 128, CHUNK, 1024), t > gi * gs / 16);
      wgmma_commit();
      wgmma_wait<0>();
      // acc += d * scale: a thread's columns 8j + 2 t4 + {0, 1}
      const float* sg = ss + gi * BN + 2 * t4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(sg + 8 * j);
        acc[4 * j + 0] = fmaf(d[4 * j + 0], sc.x, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(d[4 * j + 1], sc.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(d[4 * j + 2], sc.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(d[4 * j + 3], sc.y, acc[4 * j + 3]);
      }
    }
    mbar_arrive(&empty[s]);
  }

  const int row_a = m0 + g * 64 + warp * 16 + (lane >> 2);
  const int col_t = n0 + 2 * t4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col_t + 8 * j;  // even, and N % 16 == 0: col + 1 < N too
    if (col >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

CUresult encode(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                int cols, int rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch(const void* x, const void* packed, const void* scale, void* out, int M, int N, int K,
           int gs, void* stream) {
  CUtensorMap xmap, pmap, smap;
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 64, BM,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = encode(&pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, N, K / 2, BN, BK / 2,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r == CUDA_SUCCESS)
    r = encode(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale, N, K / gs, BN, BK / gs,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(dequant_matmul_int4_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dequant_matmul_int4_tc_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      xmap, pmap, smap, (__nv_bfloat16*)out, M, N, K, gs);
  return (int)cudaGetLastError();
}


// ------------------------------------ int8 at prefill (bf16 x): TMA + wgmma

constexpr int W8_BYTES = BK * BN;            // the int8 weight tile, 64 x 128
constexpr int STAGE8 = A_BYTES + W8_BYTES;   // a multiple of 1024
constexpr int STAGES8 = 3;                   // two blocks an SM

size_t smem_bytes_int8() { return 1024 + (size_t)STAGES8 * STAGE8 + 2 * B_BYTES + 16 * STAGES8; }

// bf16 pair (byte J0 of w, byte J1 of w), exact: `sk::int8_pair` over one
// word
template <int J0, int J1>
__device__ __forceinline__ uint32_t int8_cols(uint32_t w) {
  constexpr uint32_t sel = J0 | (J0 << 4) | (J1 << 8) | (J1 << 12);
  const uint32_t r = __byte_perm(w, 0u, sel);
  uint32_t a, b;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(a) : "r"(r), "n"(0x007F007F), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(b) : "r"(r), "n"(0x00800080), "r"(0x43004300u));
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&v);
}

// A stage's int8 tile (64 k rows x 128 columns, as TMA wrote it) into a bf16
// B tile laid out as TMA would write the (k, n) weight: 64-column chunks of
// 64 k rows, 128-byte swizzled. A task is 8 columns of one row: one 16-byte
// swizzle unit. All consumer threads.
__device__ __forceinline__ void convert_int8(const unsigned char* wt, unsigned char* bt, int tid) {
#pragma unroll
  for (int task = tid; task < BK * BN / 8; task += CONSUMERS) {
    const int k = task >> 4, cg = task & 15;
    const uint2 v = *reinterpret_cast<const uint2*>(wt + k * BN + cg * 8);
    const uint4 o = make_uint4(int8_cols<0, 1>(v.x), int8_cols<2, 3>(v.x),
                               int8_cols<0, 1>(v.y), int8_cols<2, 3>(v.y));
    const int c = cg >> 3, u = cg & 7;
    *reinterpret_cast<uint4*>(bt + c * CHUNK + k * 128 + ((u ^ (k & 7)) << 4)) = o;
  }
  // the B tile is visible to wgmma's reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// out (M, N) = (x (M, K) @ qw (K, N) int8) * scale (N,) for bf16 x, with
// K % 64 == 0 and N % 16 == 0. A block owns a 128 x 128 output tile: two
// consumer warpgroups of 64 rows and a producer warp. The int4 kernel's
// skeleton with one group of K rows:
//  * TMA brings each 64-row stage (x's 128 x 64 tile, 128-byte swizzled,
//    and the strip's 64 x 128 int8 tile) into a ring with full / empty
//    mbarriers.
//  * The consumers convert a stage's int8 tile into a bf16 B tile (two
//    alternate) while the wgmma of the stage before runs: the products of
//    stage i are issued, then stage i+1 is converted, then the warpgroup
//    waits for its products and both warpgroups meet at one barrier.
//  * One f32 accumulator runs over all of K (wgmma m64n128k16, x as A,
//    the B tile through the transpose mode); the scale multiplies once at
//    write-out.
__global__ void __launch_bounds__(THREADS, 2)
    dequant_matmul_int8_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                                  const __grid_constant__ CUtensorMap wmap,
                                  const float* __restrict__ scale,
                                  __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = K / BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* btile = ring + STAGES8 * STAGE8;
  uint64_t* full = reinterpret_cast<uint64_t*>(btile + 2 * B_BYTES);
  uint64_t* empty = full + STAGES8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES8; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread issues every copy
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES8;
        mbar_wait(&empty[s], ((i / STAGES8) & 1) ^ 1);  // the first round passes
        unsigned char* st = ring + s * STAGE8;
        mbar_expect_tx(&full[s], STAGE8);
        tma_load_2d(st, &xmap, &full[s], i * BK, m0);
        tma_load_2d(st + A_BYTES, &wmap, &full[s], n0, i * BK);
      }
    }
    return;
  }

  const int tid = threadIdx.x, g = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

  mbar_wait(&full[0], 0);
  convert_int8(ring + A_BYTES, btile, tid);
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES8;
    const unsigned char* as = ring + s * STAGE8 + g * 64 * 128;
    const unsigned char* bt = btile + (i & 1) * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      wgmma_m64n128k16_ss_tb(acc, desc(as + t * 32, 16, 1024),
                             desc(bt + t * 16 * 128, CHUNK, 1024), 1);
    wgmma_commit();
    if (i + 1 < nk) {
      // the next B tile: its buffer's last reader, stage i-1's wgmma, ended
      // before both warpgroups passed the last barrier
      const int s1 = (i + 1) % STAGES8;
      mbar_wait(&full[s1], ((i + 1) / STAGES8) & 1);
      convert_int8(ring + s1 * STAGE8 + A_BYTES, btile + ((i + 1) & 1) * B_BYTES, tid);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[s]);  // stage i's x tile read; its int8 tile converted before
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  }

  const int row_a = m0 + g * 64 + warp * 16 + (lane >> 2);
  const int col_t = n0 + 2 * t4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col_t + 8 * j;  // even, and N % 16 == 0: col + 1 < N too
    if (col >= N) continue;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * sc.x, acc[4 * j + 2 * r + 1] * sc.y);
    }
  }
}

int launch_int8(const void* x, const void* qw, const void* scale, void* out, int M, int N, int K,
                void* stream) {
  CUtensorMap xmap, wmap;
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 64, BM,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qw, N, K, BN, BK,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  const size_t smem = smem_bytes_int8();
  cudaError_t err = cudaFuncSetAttribute(dequant_matmul_int8_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dequant_matmul_int8_tc_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      xmap, wmap, (const float*)scale, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace pf

}  // namespace

extern "C" {

// x (M,K) bf16|f32, qw (K,N) int8, scale (N,) f32 -> out (M,N) in x's type:
// the tiled kernel (f32 x, and shapes the two kernels below do not take).
int dequant_matmul_int8_fwd(const void* x, const void* qw, const void* scale, void* out, int M,
                            int N, int K, int is_bf16, void* stream) {
  return launch<false>(x, qw, scale, out, M, N, K, K, is_bf16, stream);
}

// x (M,K) bf16|f32, packed (K/2,N) uint8, scale (K/gs,N) f32 -> out (M,N).
int dequant_matmul_int4_fwd(const void* x, const void* packed, const void* scale, void* out,
                            int M, int N, int K, int gs, int is_bf16, void* stream) {
  return launch<true>(x, packed, scale, out, M, N, K, gs, is_bf16, stream);
}

// The split-K int4 kernel (M <= 64): the same operands, K cut into n_slices
// slices of slice_k rows (a multiple of 128 and of gs; the last ends at K),
// N into strips of 128 columns. With n_slices > 1, ``part`` holds
// ceil(N/128) * n_slices * M * 128 floats and ``counters`` ceil(N/128) ints,
// 0 between launches (each launch leaves them 0).
int dequant_matmul_int4_splitk_fwd(const void* x, const void* packed, const void* scale,
                                   void* out, void* part, void* counters, int M, int N, int K,
                                   int gs, int slice_k, int n_slices, int is_bf16,
                                   void* stream) {
  if (M < 1 || M > 64 || slice_k % sk::BK || n_slices < 1) return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4;
  const bool vec = aligned16(x) && aligned16(packed) && aligned16(scale) &&
                   (K * elem) % 16 == 0 && N % 16 == 0;
  if (vec)
    return sk::launch_vec<true>(x, packed, scale, out, part, counters, M, N, K, gs, slice_k,
                                n_slices, is_bf16, stream);
  return sk::launch_vec<false>(x, packed, scale, out, part, counters, M, N, K, gs, slice_k,
                               n_slices, is_bf16, stream);
}

// The TMA + wgmma int4 kernel (bf16 x, M > 64): x (M,K), packed (K/2,N),
// scale (K/gs,N) with K % 64 == 0, N % 16 == 0, gs in {16, 32, 64} and
// 16-byte aligned bases (the wrapper's planner checks) -> out (M,N) bf16. A
// failed tensor-map encode returns its CUresult.
int dequant_matmul_int4_tc_fwd(const void* x, const void* packed, const void* scale, void* out,
                               int M, int N, int K, int gs, void* stream) {
  return pf::launch(x, packed, scale, out, M, N, K, gs, stream);
}

// The split-K int8 kernel (bf16 x, M <= 64): K cut into n_slices slices of
// slice_k rows (a multiple of 128; the last ends at K), N into strips of 128
// columns; x, qw and scale 16-byte aligned, K % 8 == 0 and N % 16 == 0;
// part and counters as for the int4 split kernel.
int dequant_matmul_int8_splitk_fwd(const void* x, const void* qw, const void* scale, void* out,
                                   void* part, void* counters, int M, int N, int K, int slice_k,
                                   int n_slices, void* stream) {
  if (M < 1 || M > 64 || slice_k % sk::BK || n_slices < 1 || K % 8 || N % 16 ||
      !aligned16(x) || !aligned16(qw) || !aligned16(scale))
    return (int)cudaErrorInvalidValue;
  if (M <= 16)
    return sk::launch_int8_rows<2>(x, qw, scale, out, part, counters, M, N, K, slice_k,
                                   n_slices, stream);
  if (M <= 32)
    return sk::launch_int8_rows<4>(x, qw, scale, out, part, counters, M, N, K, slice_k,
                                   n_slices, stream);
  return sk::launch_int8_rows<8>(x, qw, scale, out, part, counters, M, N, K, slice_k, n_slices,
                                 stream);
}

// Blocks of the int8 split-K kernel for ``rows`` (16, 32 or 64) x rows one
// SM holds (0 if it cannot launch).
int dequant_matmul_int8_splitk_blocks_per_sm(int rows) {
  if (rows <= 16) return sk::blocks_per_sm_int8_rows<2>();
  if (rows <= 32) return sk::blocks_per_sm_int8_rows<4>();
  return sk::blocks_per_sm_int8_rows<8>();
}

// The TMA + wgmma int8 kernel (bf16 x, M > 64): x (M,K), qw (K,N), scale
// (N,) with K % 64 == 0, N % 16 == 0 and 16-byte aligned bases (the
// wrapper's planner checks) -> out (M,N) bf16. A failed tensor-map encode
// returns its CUresult.
int dequant_matmul_int8_tc_fwd(const void* x, const void* qw, const void* scale, void* out,
                               int M, int N, int K, void* stream) {
  return pf::launch_int8(x, qw, scale, out, M, N, K, stream);
}

// Blocks of the split-K kernel for ``rows`` (16, 32 or 64) x rows and groups
// of ``gs`` one SM holds (0 if it cannot launch).
int dequant_matmul_int4_splitk_blocks_per_sm(int is_bf16, int rows, int gs) {
  if (rows <= 16) return sk::blocks_per_sm_rows<2>(is_bf16, gs);
  if (rows <= 32) return sk::blocks_per_sm_rows<4>(is_bf16, gs);
  return sk::blocks_per_sm_rows<8>(is_bf16, gs);
}

}  // extern "C"
