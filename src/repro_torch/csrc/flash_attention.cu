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
// What the design does about it:
//  * One block per (64-query tile, head, batch); the TPU's sequential kv grid
//    axis becomes a loop inside the block over 64-key tiles, with the running
//    (m, l) per row and the f32 output accumulator in shared memory.
//  * The causal and window bounds cut the loop: tiles wholly above the
//    diagonal or left of the window are never loaded, halving causal work.
//  * Each thread computes a 4x4 tile of scores and a 4 x (Dv/16) tile of the
//    output from shared memory; K rows are padded to D + 1 floats so the 16
//    keys a warp reads at one depth fall in 16 different banks.
//  * Ragged Sq and Sk are masked in the kernel (k_pos < Sk, q rows >= Sq are
//    not written); nothing is padded or copied. A row with nothing valid
//    comes out 0 through the TPU kernel's m_safe / alpha / max(l, 1e-20)
//    guard.
// Simple first: scalar f32 FMAs, not the tensor cores. Moving the two
// products to wgmma on bf16 tiles is the work that makes it fast.
#include "common.cuh"

using namespace repro;

namespace {

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

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * Dv +
                          (size_t)BQ * (BK + 1) + (size_t)BQ * Dv + 3 * (size_t)BQ);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int Hkv, int D, int Dv, float scale, int has_window, int window, void* stream) {
  const size_t smem = smem_bytes(D, Dv);
  auto kern = flash_attention_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                      (T*)o, Sq, Sk, H, Hkv, D, Dv, scale,
                                                      has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper refuses shapes above the card's
// 227 KB per block.
size_t flash_attention_smem_bytes(int D, int Dv) { return smem_bytes(D, Dv); }

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int H, int Hkv, int D, int Dv, float scale, int has_window,
                        int window, int is_bf16, void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale, has_window,
                                 window, stream);
  return launch<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, Dv, scale, has_window, window,
                       stream);
}

}  // extern "C"
