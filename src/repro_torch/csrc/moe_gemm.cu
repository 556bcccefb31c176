// Grouped expert GEMM: y[e] = x[e] @ w[e] for every expert e in one launch,
// x (E, C, d), w (E, d, f) -> y (E, C, f), row-major, in the type of x (bf16
// or f32), accumulated in f32.
//
// Replaces the TPU kernel `moe_gemm_pallas` (src/repro/kernels/moe_gemm/
// moe_gemm.py): the gate, up and down products of the capacity-based MoE
// layer (src/repro/models/moe.py), where every expert holds C token rows.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
//  * decode: bytes. The capacity layout gives every expert C rows (C = 8 for
//    granite-moe-3b-a800m at 32 sequences, 6 for deepseek-v2-lite), so every
//    expert's whole weight is read each step: 40 x 1536 x 512 x 2 B = 63 MB
//    for a granite gate, 369 MB for a deepseek gate, at 2 C FLOP a weight.
//  * prefill: operations, 2 E C d f (C = 512 to 2048 rows an expert).
//
// Two kernels; the wrapper's planner (kernels/moe_gemm/plan.py) picks one
// before the launch.
//
// bf16 with d and f multiples of 8 and 16-byte aligned bases: TMA + wgmma
// (`moe_gemm_tc_kernel`).
//  * A block owns a BM x 128 tile of one expert's output: one consumer
//    warpgroup (BM = 64) at decode, two (BM = 128) at prefill, and one
//    producer warp. The TPU's sequential contraction grid axis becomes the
//    consumers' loop over 64-row k tiles; the f32 accumulator stays in
//    registers.
//  * x and w arrive by TMA from 3-D tensor maps over (E, C, d) and (E, d, f),
//    encoded on the host with cuTensorMapEncodeTiled, in 64-column, 128-byte
//    swizzled boxes, into a ring of stages with a full and an empty mbarrier
//    each; no thread issues a load. TMA zero-fills beyond C, d and f, so
//    ragged shapes need no padding or copy on the host; at decode the C < 64
//    rows of an expert fill a 64-row wgmma tile whose other rows are zeros.
//  * Each k16 step is wgmma m64n128k16 with x as the shared A operand and w
//    the B operand in its natural (d, f) layout through the transpose mode
//    (the flash kernel's V operand). One wgmma group stays in flight while
//    the next is issued; a stage is released when the group that read it
//    has completed.
//  * At decode every weight byte moves through TMA once and the tensor cores
//    do 64 / C times the work C needs: about 4 us of a granite launch against
//    its 19 us byte bound. At prefill the grid runs C tiles fastest, so the
//    blocks that share a weight tile run together and share it in L2.
//
// Every other bf16 shape, and f32: `moe_gemm_bf16_kernel` /
// `moe_gemm_f32_kernel`.
//  * A block owns a 64 x 64 tile of one expert's output and loops over d
//    itself in tiles of 64. The grid is (C tiles, f tiles, experts) with the
//    C tiles fastest.
//  * Tiles move with cp.async, 16 bytes a thread, four stages in flight,
//    when rows are 16-byte aligned (d and f times the element size multiples
//    of 16, aligned base pointers); other shapes load element by element.
//    Ragged C, d and f are masked in the kernel.
//  * bf16: mma.sync m16n8k16 with bf16 operands and f32 accumulation. f32:
//    scalar f32 FMAs (no TF32: the f32 path is held to the plain version at
//    1e-4).
// Not done: an expert that received no token is still read whole.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int BM = 64;  // output rows (capacity slots) per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 64;  // contraction (d) per tile
constexpr int STAGES = 4;
constexpr int THREADS = 128;

template <typename T>
struct Tile {
  // row strides in elements: rows stay 16 B aligned for cp.async, and the
  // bf16 fragment loads of 8 rows x 4 column pairs hit 32 distinct banks
  static constexpr int XS = sizeof(T) == 2 ? BK + 8 : BK + 4;
  static constexpr int WS = sizeof(T) == 2 ? BN + 8 : BN + 4;
  static constexpr int X_BYTES = (int)sizeof(T) * BM * XS;
  static constexpr int STAGE = X_BYTES + (int)sizeof(T) * BK * WS;
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

// Tile k0 of one expert's x (BM x BK) and w (BK x BN) into a stage of shared
// memory; zeros outside the matrices. M = C, N = f, K = d.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* stage, const T* __restrict__ x,
                                          const T* __restrict__ w, int M, int N, int K, int m0,
                                          int n0, int k0) {
  using TL = Tile<T>;
  T* xs = reinterpret_cast<T*>(stage);
  T* ws = reinterpret_cast<T*>(stage + TL::X_BYTES);
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16 B chunk
    constexpr int XCPR = BK / EPC;
    for (int c = tid; c < BM * XCPR; c += THREADS) {
      const int r = c / XCPR, kc = (c % XCPR) * EPC;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;  // K % EPC == 0: a chunk is all in or all out
      cp_async16(xs + r * TL::XS + kc, ok ? x + (long long)gm * K + gk : x, ok);
    }
    constexpr int WCPR = BN / EPC;
    for (int c = tid; c < BK * WCPR; c += THREADS) {
      const int r = c / WCPR, nc = (c % WCPR) * EPC;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;  // N % EPC == 0
      cp_async16(ws + r * TL::WS + nc, ok ? w + (long long)gk * N + gn : w, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[r * TL::XS + kk] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : from_f32<T>(0.f);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, nn = i % BN;
      const int gk = k0 + r, gn = n0 + nn;
      ws[r * TL::WS + nn] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of consecutive rows of one column: the low half is the first row
__device__ __forceinline__ uint32_t pair16(const __nv_bfloat16* p, int stride) {
  const unsigned short lo = *reinterpret_cast<const unsigned short*>(p);
  const unsigned short hi = *reinterpret_cast<const unsigned short*>(p + stride);
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- bf16
// Four warps in a 2 x 2 layout, each owning 32 rows x 32 columns of the
// tile: 2 m16 x 4 n8 mma tiles.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    moe_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using TL = Tile<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long e = blockIdx.z;
  x += e * M * K;
  w += e * K * N;
  out += e * M * N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, t = lane & 3;
  const bool active = m0 + wm < M;       // warp-uniform: rows of this warp exist
  const bool active1 = m0 + wm + 16 < M;  // and of its second m16 tile

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile<__nv_bfloat16, VEC>(smem + s * TL::STAGE, x, w, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 fully consumed
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_tile<__nv_bfloat16, VEC>(smem + (pf % STAGES) * TL::STAGE, x, w, M, N, K, m0, n0,
                                    pf * BK);
    cp_async_commit();
    if (!active) continue;

    const unsigned char* stage = smem + (kt % STAGES) * TL::STAGE;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage);
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(stage + TL::X_BYTES);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      if (kt * BK + ks >= K) break;  // the rest of the tile is zeros
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
        const __nv_bfloat16* p = ws + (ks + 2 * t) * TL::WS + wn + ni * 8 + gq;
        b[ni][0] = pair16(p, TL::WS);               // k 2t, 2t+1
        b[ni][1] = pair16(p + 8 * TL::WS, TL::WS);  // k 2t+8, 2t+9
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[0][ni], a[0], b[ni]);
      if (active1) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[1][ni], a[1], b[ni]);
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

// ----------------------------------------------------------------- f32
// Thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ out, int M, int N, int K) {
  using TL = Tile<float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long e = blockIdx.z;
  x += e * M * K;
  w += e * K * N;
  out += e * M * N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile<float, VEC>(smem + s * TL::STAGE, x, w, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_tile<float, VEC>(smem + (pf % STAGES) * TL::STAGE, x, w, M, N, K, m0, n0, pf * BK);
    cp_async_commit();

    const unsigned char* stage = smem + (kt % STAGES) * TL::STAGE;
    const float* xs = reinterpret_cast<const float*>(stage);
    const float* ws = reinterpret_cast<const float*>(stage + TL::X_BYTES);
    const int kmax = min(BK, K - kt * BK);
    for (int kk = 0; kk < kmax; ++kk) {
      float xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = xs[(ty * 8 + i) * TL::XS + kk];
      const float4 wv = *reinterpret_cast<const float4*>(ws + kk * TL::WS + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(xv[i], wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv[i], wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv[i], wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv[i], wv.w, acc[i][3]);
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

template <typename T, bool VEC>
int launch_typed(const void* x, const void* w, void* out, int E, int C, int F, int D,
                 void* stream) {
  const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
  const int smem = STAGES * Tile<T>::STAGE;
  cudaError_t err;
  if (sizeof(T) == 2) {
    auto kern = moe_gemm_bf16_kernel<VEC>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, C, F, D);
  } else {
    auto kern = moe_gemm_f32_kernel<VEC>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                                         (float*)out, C, F, D);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int F, int D, void* stream) {
  const bool vec = aligned16(x) && aligned16(w) && (D * (int)sizeof(T)) % 16 == 0 &&
                   (F * (int)sizeof(T)) % 16 == 0;
  if (vec) return launch_typed<T, true>(x, w, out, E, C, F, D, stream);
  return launch_typed<T, false>(x, w, out, E, C, F, D, stream);
}

// ------------------------------------------------------ bf16, TMA + wgmma

namespace tc {

constexpr int BN = 128;                     // output columns a block: the wgmma N
constexpr int BK = 64;                      // d rows a stage: one 128-byte swizzled row of x
constexpr int CHUNK_BYTES = 64 * 128;       // 64 rows x 64 bf16 columns
constexpr int B_BYTES = BN / 64 * CHUNK_BYTES;  // the BK x BN weight tile: two chunks

template <int WG>  // consumer warpgroups: 64 output rows each
struct Cfg {
  static constexpr int BM = 64 * WG;
  static constexpr int A_BYTES = BM * 128;  // BM rows x BK columns of x
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
};

size_t smem_bytes(int wg, int stages) {
  const size_t stage = wg == 1 ? Cfg<1>::STAGE : Cfg<2>::STAGE;
  return 1024 + stage * stages + 2 * sizeof(uint64_t) * stages;
}

template <int WG>
__global__ void __launch_bounds__(Cfg<WG>::THREADS, 1)
    moe_gemm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                       int M, int N, int K, int stages) {
  using CF = Cfg<WG>;
  const int m0 = blockIdx.x * CF::BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int nk = (K + BK - 1) / BK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * CF::STAGE);
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CF::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CF::CONSUMERS) {
    // producer: one thread issues every copy
    if (threadIdx.x == CF::CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages;
        mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);  // the first round passes
        unsigned char* st = ring + s * CF::STAGE;
        mbar_expect_tx(&full[s], CF::STAGE);
        tma_load_3d(st, &xmap, &full[s], i * BK, m0, e);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_3d(st + CF::A_BYTES + c * CHUNK_BYTES, &wmap, &full[s], n0 + 64 * c, i * BK,
                      e);
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows 64g .. 64g+63 of the tile; within it,
  // warp w rows 16w .. 16w+15, a thread rows r and r + 8 (r = 16w + lane/4),
  // columns 8j + 2(lane%4) + {0,1}
  const int g = threadIdx.x >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const unsigned char* as = ring + s * CF::STAGE + g * 64 * 128;
    const unsigned char* bs = ring + s * CF::STAGE + CF::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      wgmma_m64n128k16_ss_tb(acc, desc(as + t * 32, 16, 1024),
                             desc(bs + t * 16 * 128, CHUNK_BYTES, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the group of stage i - 1 is done: release that stage
    if (i > 0) mbar_arrive(&empty[(i - 1) % stages]);
  }
  wgmma_wait<0>();

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row_a = m0 + g * 64 + warp * 16 + (lane >> 2);
  const int col_t = n0 + 2 * (lane & 3);
  out += (long long)e * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col_t + 8 * j;  // even, and N % 8 == 0: col + 1 < N too
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

// (depth, rows, cols) bf16 as a 3-D tensor map of 64-column x box_rows x 1
// boxes, 128-byte swizzled; out-of-bounds elements read as zeros.
CUresult encode(CUtensorMap* map, const void* ptr, int cols, int rows, int depth, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int WG>
int launch(const void* x, const void* w, void* out, int E, int C, int F, int D, int stages,
           void* stream) {
  CUtensorMap xmap, wmap;
  CUresult r = encode(&xmap, x, D, C, E, Cfg<WG>::BM);
  if (r == CUDA_SUCCESS) r = encode(&wmap, w, F, D, E, BK);
  if (r != CUDA_SUCCESS) return (int)r;
  const size_t smem = smem_bytes(WG, stages);
  auto kern = moe_gemm_tc_kernel<WG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + Cfg<WG>::BM - 1) / Cfg<WG>::BM, (F + BN - 1) / BN, E);
  kern<<<grid, Cfg<WG>::THREADS, smem, (cudaStream_t)stream>>>(xmap, wmap, (__nv_bfloat16*)out,
                                                               C, F, D, stages);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// x (E,C,D), w (E,D,F), both bf16 or both f32 -> out (E,C,F) in their type.
int moe_gemm_fwd(const void* x, const void* w, void* out, int E, int C, int F, int D,
                 int is_bf16, void* stream) {
  if (is_bf16) return launch<__nv_bfloat16>(x, w, out, E, C, F, D, stream);
  return launch<float>(x, w, out, E, C, F, D, stream);
}

// The TMA + wgmma kernel: x (E,C,D), w (E,D,F) bf16 with D and F multiples of
// 8 and 16-byte aligned bases (the wrapper's planner checks) -> out (E,C,F);
// ``consumers`` warpgroups (1: 64-row tiles, 2: 128-row tiles) and a ring of
// ``stages``. A failed tensor-map encode returns its CUresult.
int moe_gemm_tc_fwd(const void* x, const void* w, void* out, int E, int C, int F, int D,
                    int consumers, int stages, void* stream) {
  if (consumers == 1) return tc::launch<1>(x, w, out, E, C, F, D, stages, stream);
  if (consumers == 2) return tc::launch<2>(x, w, out, E, C, F, D, stages, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
