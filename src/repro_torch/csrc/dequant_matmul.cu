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
// Simple first: no wgmma or TMA, no split of K across blocks (a layer with
// N = 256 has four blocks at decode). Those are later work.
#include <cstdint>

#include "common.cuh"

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

}  // namespace

extern "C" {

// x (M,K) bf16|f32, qw (K,N) int8, scale (N,) f32 -> out (M,N) in x's type.
int dequant_matmul_int8_fwd(const void* x, const void* qw, const void* scale, void* out, int M,
                            int N, int K, int is_bf16, void* stream) {
  return launch<false>(x, qw, scale, out, M, N, K, K, is_bf16, stream);
}

// x (M,K) bf16|f32, packed (K/2,N) uint8, scale (K/gs,N) f32 -> out (M,N).
int dequant_matmul_int4_fwd(const void* x, const void* packed, const void* scale, void* out,
                            int M, int N, int K, int gs, int is_bf16, void* stream) {
  return launch<true>(x, packed, scale, out, M, N, K, gs, is_bf16, stream);
}

}  // extern "C"
