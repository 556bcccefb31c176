// Causal GQA prefill attention with an online softmax (flash attention).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py). q (B,Sq,H,D),
// k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv) -> (B,Sq,H,Dv). Positions are implicit (an
// iota from 0 for both q and k), query head h reads kv head h / group, and an
// optional sliding window keeps k_pos > q_pos - window. Scores and the
// softmax state are f32 whatever the input type.
//
// What bounds it on an H100: operations. Causal prefill does about
// 2 * B * H * (Sq^2 / 2) * (D + Dv) FLOPs on B * (Sq*H*D + Sk*Hkv*(D+Dv)) input
// elements, i.e. O(Sq) FLOPs per byte -- above the ~295 FLOP/byte ridge from a
// few hundred tokens on.
//
// Two kernels, chosen by the input type:
//
// bf16: the tensor cores (`flash_attention_tc_kernel`).
//  * One block per (64-query tile, head, batch): one consumer warpgroup and
//    one producer warp. The TPU's sequential kv grid axis becomes the
//    consumer's loop over 64-key tiles; the query tiles run longest first.
//  * S = Q . K^T is a wgmma (m64n64k16) with Q and K tiles in shared memory;
//    the f32 accumulator is the score tile, and the online softmax runs on
//    it in registers (row max and row sum across the four threads of a row
//    by shuffles; exp2 of scores pre-scaled by log2(e)). P is rounded to
//    bf16 in registers and is the A operand of O += P . V (a register-A
//    wgmma); V is read from shared memory through the transpose mode of
//    16-bit wgmma. O stays in registers across the kv loop. Rounding P to
//    bf16 departs from the TPU kernel's f32 `p @ v` by about 2^-9 relative.
//  * Q, K and V arrive by TMA (4-D tensor maps over the (B, S, heads, D)
//    layout, built on the host with cuTensorMapEncodeTiled from libcuda,
//    linked with -lcuda) in 64-column, 128-byte swizzled tiles. K/V tiles
//    fill a ring of two stages, each with a full and an empty mbarrier: the
//    producer keeps the next tile in flight while the consumers compute.
//  * Ragged Sq and Sk, and head dims that are no multiple of 64, are zero
//    filled by TMA out of bounds (D = 48 is three 16-wide k steps of a
//    zero-padded 64-column tile); nothing is padded or copied on the host.
//  * The causal and window bounds cut the kv loop; only tiles that cross
//    the diagonal, the window's edge or Sk are masked element by element. A
//    row with nothing valid comes out 0 through the TPU kernel's m_safe /
//    alpha / max(l, 1e-20) guard.
//  * Tried and measured no faster at chatglm's prefill (PERF.md):
//    persistent blocks with a double-buffered Q, and running one tile's
//    softmax while the previous tile's P . V is on the tensor cores. Not
//    tried: a second consumer warpgroup (128 query rows a block), packing
//    the query heads of a kv head into one block, 128-key tiles.
//
// f32: scalar f32 FMAs (`flash_attention_kernel<float>`), kept for the f32
// checks that hold the kernel to its plain version at 1e-4: TF32 tensor
// cores keep about three decimal digits.
//  * One block per (64-query tile, head, batch), the running (m, l) per row
//    and the f32 output accumulator in shared memory.
//  * Each thread computes a 4x4 tile of scores and a 4 x (Dv/16) tile of the
//    output from shared memory; K rows are padded to D + 1 floats so the 16
//    keys a warp reads at one depth fall in 16 different banks.
//  * Ragged Sq and Sk are masked in the kernel (k_pos < Sk, q rows >= Sq are
//    not written), and the causal and window bounds cut the kv loop.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

// ------------------------------------------------------------------ f32

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 score tile each

template <typename T>
__global__ void flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                                       int Sk, int H, int Hkv, int D, int Dv, float scale,
                                       int has_window, int window) {
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (tid >> 4) * 4;  // first of this thread's 4 rows
  const int c0 = tid & 15;        // its columns: c0, c0 + 16, ...

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // BQ * (D + 1)
  float* ks = qs + BQ * (D + 1);     // BK * (D + 1)
  float* vs = ks + BK * (D + 1);     // BK * Dv
  float* ss = vs + BK * Dv;          // BQ * (BK + 1): scores, then probabilities
  float* acc = ss + BQ * (BK + 1);   // BQ * Dv
  float* m_s = acc + BQ * Dv;        // BQ
  float* l_s = m_s + BQ;             // BQ
  float* a_s = l_s + BQ;             // BQ

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    qs[r * (D + 1) + d] =
        qi < Sq ? to_f32(q[(((long long)b * Sq + qi) * H + h) * D + d]) : 0.f;
  }
  for (int i = tid; i < BQ * Dv; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  // keys any row of this tile can see
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int k_end = min(Sk, q0 + BQ);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const int kj = k0 + r;
      ks[r * (D + 1) + d] =
          kj < Sk ? to_f32(k[(((long long)b * Sk + kj) * Hkv + kvh) * D + d]) : 0.f;
    }
    for (int i = tid; i < BK * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      const int kj = k0 + r;
      vs[r * Dv + d] =
          kj < Sk ? to_f32(v[(((long long)b * Sk + kj) * Hkv + kvh) * Dv + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(c0 + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c0 + 16 * j;
        bool ok = kpos < Sk && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        ss[(r0 + i) * (BK + 1) + c0 + 16 * j] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, each lane two columns
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = ss + r * (BK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_cur = warp_max(fmaxf(x0, x1));
      float m_new, m_safe, alpha;
      online_update(m_s[r], m_cur, &m_new, &m_safe, &alpha);
      const float p0 = x0 > NEG_INF * 0.5f ? expf(x0 - m_safe) : 0.f;
      const float p1 = x1 > NEG_INF * 0.5f ? expf(x1 - m_safe) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + psum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int dv = c0; dv < Dv; dv += 16) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = acc[(r0 + i) * Dv + dv] * a_s[r0 + i];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float vv = vs[c * Dv + dv];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] += ss[(r0 + i) * (BK + 1) + c] * vv;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[(r0 + i) * Dv + dv] = a[i];
    }
  }
  __syncthreads();

  for (int i = tid; i < BQ * Dv; i += THREADS) {
    const int r = i / Dv, dv = i - r * Dv;
    const int qi = q0 + r;
    if (qi < Sq)
      o[(((long long)b * Sq + qi) * H + h) * Dv + dv] =
          from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-20f));
  }
}

size_t f32_smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * Dv +
                          (size_t)BQ * (BK + 1) + (size_t)BQ * Dv + 3 * (size_t)BQ);
}


// ------------------------------------------------------- bf16, tensor cores

namespace tc {

constexpr int BM = 64;                 // query rows per block: one wgmma M
constexpr int BN = 64;                 // keys per kv tile
constexpr int CHUNK = 64;              // head-dim columns per 128-byte tile row
constexpr int TILE_BYTES = 64 * 128;   // one 64-row, 64-column bf16 tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int CONSUMERS = 128;         // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int NV>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (NV == 64)
    wgmma_m64n64k16_rs(o, a, db);
  else
    wgmma_m64n128k16_rs(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// NV: the width of O's accumulator, Dv rounded up to 64 or 128.
template <int NV>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int Hkv,
                              int D, int Dv, float scale_log2, int has_window, int window) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nD = (D + CHUNK - 1) / CHUNK;
  const int nDv = (Dv + CHUNK - 1) / CHUNK;
  const int stage_bytes = (nD + nDv) * TILE_BYTES;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = qs + nD * TILE_BYTES;  // stage s: nD K tiles, then nDv V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * stage_bytes);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // keys any row of this tile can see
  const int k_begin = has_window ? max(0, q0 - window + 1) / BN * BN : 0;
  const int k_end = min(Sk, min(Sq, q0 + BM));
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one thread issues every copy
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, nD * TILE_BYTES);
      for (int c = 0; c < nD; ++c)
        tma_load(qs + c * TILE_BYTES, &qmap, qbar, c * CHUNK, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes
        unsigned char* st = ring + s * stage_bytes;
        const int k0 = k_begin + i * BN;
        mbar_expect_tx(&full[s], stage_bytes);
        for (int c = 0; c < nD; ++c)
          tma_load(st + c * TILE_BYTES, &kmap, &full[s], c * CHUNK, kvh, k0, b);
        for (int c = 0; c < nDv; ++c)
          tma_load(st + (nD + c) * TILE_BYTES, &vmap, &full[s], c * CHUNK, kvh, k0, b);
      }
    }
    return;
  }

  // consumers: warp w holds rows 16w .. 16w+15 of every accumulator; a thread
  // holds rows r and r + 8 (r = 16w + lane/4), columns 8j + 2(lane%4) + {0,1}
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);

  float oacc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int ksteps = (D + 15) / 16;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* ks = ring + s * stage_bytes;
    const unsigned char* vs = ks + nD * TILE_BYTES;
    const int k0 = k_begin + i * BN;

    float sacc[BN / 2];
    wgmma_fence();
    for (int t = 0; t < ksteps; ++t) {
      const int off = (t >> 2) * TILE_BYTES + (t & 3) * 32;
      wgmma_m64n64k16_ss(sacc, desc(qs + off, 16, 1024), desc(ks + off, 16, 1024), t > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // mask only tiles that cross Sk, the diagonal or the window's edge
    const bool need_mask = !(k0 + BN <= Sk && k0 + BN - 1 <= q0 &&
                             (!has_window || k0 > q0 + BM - 1 - window));
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * scale_log2;
        if (need_mask) {
          const int row = row_a + 8 * (e >> 1);
          const int col = k0 + 8 * j + col_t + (e & 1);
          bool ok = col < Sk && col <= row;
          if (has_window) ok = ok && col > row - window;
          x = ok ? x : NEG_INF;
        }
        sacc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_safe[r] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      alpha[r] = m_run[r] <= NEG_INF * 0.5f ? 0.f : exp2f(m_run[r] - m_safe[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    uint32_t pa[BN / 16][4];  // P as the A fragments of four k16 steps
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sacc[4 * j + e];
        p[e] = x > NEG_INF * 0.5f ? exp2f(x - m_safe[e >> 1]) : 0.f;
        l_run[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      oacc[4 * j + 0] *= alpha[0];
      oacc[4 * j + 1] *= alpha[0];
      oacc[4 * j + 2] *= alpha[1];
      oacc[4 * j + 3] *= alpha[1];
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
      wgmma_pv<NV>(oacc, pa[t], desc(vs + t * 16 * 128, TILE_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-20f);
  }
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int col = 8 * j + col_t;
    if (col >= Dv) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row) * H + h) * Dv + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv[r], oacc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

size_t smem_bytes(int D, int Dv) {
  const size_t nD = (D + CHUNK - 1) / CHUNK, nDv = (Dv + CHUNK - 1) / CHUNK;
  return 1024 + TILE_BYTES * (nD + STAGES * (nD + nDv)) + sizeof(uint64_t) * (2 * STAGES + 1);
}

// (B, S, heads, d) bf16 as a 4-D tensor map of 64 x 1 x 64 x 1 boxes, 128-byte
// swizzled; out-of-bounds elements read as zeros.
CUresult encode(CUtensorMap* map, const void* ptr, int d, int heads, int seq, int batch) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)seq * heads * d * 2};
  const cuuint32_t box[4] = {CHUNK, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int Hkv, int D, int Dv, float scale, int has_window, int window, void* stream) {
  CUtensorMap qmap, kmap, vmap;
  CUresult r = encode(&qmap, q, D, H, Sq, B);
  if (r == CUDA_SUCCESS) r = encode(&kmap, k, D, Hkv, Sk, B);
  if (r == CUDA_SUCCESS) r = encode(&vmap, v, Dv, Hkv, Sk, B);
  if (r != CUDA_SUCCESS) return (int)r;
  const size_t smem = smem_bytes(D, Dv);
  auto kern = Dv <= 64 ? flash_attention_tc_kernel<64> : flash_attention_tc_kernel<128>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(qmap, kmap, vmap, (__nv_bfloat16*)o, Sq,
                                                      Sk, H, Hkv, D, Dv, scale * LOG2E,
                                                      has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int H, int Hkv, int D, int Dv, float scale, int has_window, int window,
               void* stream) {
  const size_t smem = f32_smem_bytes(D, Dv);
  auto kern = flash_attention_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const float*)q, (const float*)k,
                                                      (const float*)v, (float*)o, Sq, Sk, H,
                                                      Hkv, D, Dv, scale, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper refuses shapes above the card's
// 227 KB per block.
size_t flash_attention_smem_bytes(int D, int Dv, int is_bf16) {
  return is_bf16 ? tc::smem_bytes(D, Dv) : f32_smem_bytes(D, Dv);
}

// bf16: the tensor-core kernel, which takes D and Dv multiples of 8 (16-byte
// rows for TMA), Dv <= 128 and 16-byte aligned q, k, v (the wrapper checks);
// a failed tensor-map encode returns its CUresult. f32: the scalar kernel.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int Hkv, int D, int Dv, float scale, int has_window,
                        int window, int is_bf16, void* stream) {
  if (is_bf16)
    return tc::launch(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale, has_window, window, stream);
  return launch_f32(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale, has_window, window, stream);
}

}  // extern "C"
