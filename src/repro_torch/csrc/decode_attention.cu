// Single-token decode attention over a KV cache, dense ring or paged pool.
//
// Replaces the TPU kernels `decode_attention_pallas` and
// `paged_decode_attention_pallas` (src/repro/kernels/decode_attention/
// decode_attention.py). One query token per sequence attends over every
// cache slot whose absolute position is valid: 0 <= pos <= q_pos (and, dense
// only, pos > q_pos - window). Softmax state (m, l, acc) is f32.
//
// What bounds it on an H100: bytes. Each step reads the whole K and V of
// every sequence once (2 * slots * Hkv * D * 2 B in bf16) and does about one
// multiply-add per element read, far below the card's ~295 FLOP/byte ridge.
//
// What the design does about it:
//  * One block per (kv head, sequence) serves all `group` query heads of that
//    kv head from one read of each K/V tile. The TPU grid ran (B, H, kv) and
//    re-read every tile once per query head (16x for chatglm3-6b's GQA).
//  * The TPU's sequential kv grid axis becomes a loop inside the block over
//    tiles of 32 slots (one slot per lane), the running (m, l, acc) state
//    kept in shared memory.
//  * The ragged tail (W not a multiple of the tile) is masked in the kernel;
//    nothing is padded or copied. Slots that are masked are never loaded.
//  * Paged: each block reads its own row of `block_table` and addresses the
//    pool blocks directly; the pool is never gathered into a dense copy. A
//    table entry outside [0, n_blocks) reads as an empty block, so a bad
//    table cannot send a load outside the pool.
//  * A row with no valid slot comes out 0, through the same m_safe / alpha /
//    max(l, 1e-20) guard as the TPU kernel.
// Simple first: scalar f32 FMAs, synchronous loads. Splitting the slot axis
// across blocks (more than B * Hkv blocks in flight) is later work.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int TILE = 32;      // cache slots per tile: one per lane
constexpr int THREADS = 128;  // four warps

template <typename T, bool PAGED>
__global__ void decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const int* __restrict__ pos,
                                        const int* __restrict__ block_table,
                                        const int* __restrict__ q_pos, T* __restrict__ out,
                                        int n_slots, int bs, int nb, int n_blocks, int H,
                                        int Hkv, int D, int Dv, float scale, int has_window,
                                        int window) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_off = reinterpret_cast<long long*>(smem_raw);  // TILE: K/V row or -1
  float* qs = reinterpret_cast<float*>(row_off + TILE);         // g * D
  float* ks = qs + g * D;                                        // TILE * (D + 1)
  float* vs = ks + TILE * (D + 1);                               // TILE * Dv
  float* ps = vs + TILE * Dv;                                    // g * TILE
  float* acc = ps + g * TILE;                                    // g * Dv
  float* m_s = acc + g * Dv;                                     // g
  float* l_s = m_s + g;                                          // g
  float* a_s = l_s + g;                                          // g

  const int qp = q_pos[b];
  const T* qb = q + ((long long)b * H + (long long)kvh * g) * D;
  for (int i = tid; i < g * D; i += THREADS) qs[i] = to_f32(qb[i]);
  for (int i = tid; i < g * Dv; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < g; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  for (int t0 = 0; t0 < n_slots; t0 += TILE) {
    __syncthreads();  // previous tile fully consumed
    if (tid < TILE) {
      const int j = t0 + tid;
      long long off = -1;
      if (j < n_slots) {
        long long row = -1;
        if (PAGED) {
          const int blk = block_table[(long long)b * nb + j / bs];
          if (blk >= 0 && blk < n_blocks) row = (long long)blk * bs + j % bs;
        } else {
          row = (long long)b * n_slots + j;
        }
        if (row >= 0) {
          const int p = pos[row];
          bool ok = p >= 0 && p <= qp;
          if (has_window) ok = ok && p > qp - window;
          if (ok) off = row * Hkv + kvh;
        }
      }
      row_off[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < TILE * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const long long off = row_off[r];
      ks[r * (D + 1) + d] = off >= 0 ? to_f32(k[off * D + d]) : 0.f;
    }
    for (int i = tid; i < TILE * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      const long long off = row_off[r];
      vs[r * Dv + d] = off >= 0 ? to_f32(v[off * Dv + d]) : 0.f;
    }
    __syncthreads();

    // scores and the online softmax: warp w owns heads w, w+4, ...; lane = slot
    const bool ok = row_off[lane] >= 0;
    for (int gi = warp; gi < g; gi += THREADS / 32) {
      float s = NEG_INF;
      if (ok) {
        const float* qr = qs + gi * D;
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      const float m_cur = warp_max(s);
      float m_new, m_safe, alpha;
      online_update(m_s[gi], m_cur, &m_new, &m_safe, &alpha);
      const float p = ok ? expf(s - m_safe) : 0.f;
      const float psum = warp_sum(p);
      ps[gi * TILE + lane] = p;
      if (lane == 0) {
        m_s[gi] = m_new;
        l_s[gi] = alpha * l_s[gi] + psum;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * Dv; i += THREADS) {
      const int gi = i / Dv, dv = i - gi * Dv;
      const float* pr = ps + gi * TILE;
      float a = acc[i] * a_s[gi];
#pragma unroll 8
      for (int c = 0; c < TILE; ++c) a += pr[c] * vs[c * Dv + dv];
      acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((long long)b * H + (long long)kvh * g) * Dv;
  for (int i = tid; i < g * Dv; i += THREADS) {
    const int gi = i / Dv;
    ob[i] = from_f32<T>(acc[i] / fmaxf(l_s[gi], 1e-20f));
  }
}

size_t smem_bytes(int g, int D, int Dv) {
  return sizeof(long long) * TILE +
         sizeof(float) * ((size_t)g * D + (size_t)TILE * (D + 1) + (size_t)TILE * Dv +
                          (size_t)g * TILE + (size_t)g * Dv + 3 * (size_t)g);
}

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* table,
           const void* q_pos, void* out, int B, int n_slots, int bs, int nb, int n_blocks,
           int H, int Hkv, int D, int Dv, float scale, int has_window, int window,
           void* stream) {
  const size_t smem = smem_bytes(H / Hkv, D, Dv);
  auto kern = decode_attention_kernel<T, PAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const int*)table,
      (const int*)q_pos, (T*)out, n_slots, bs, nb, n_blocks, H, Hkv, D, Dv, scale, has_window,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper refuses shapes above the card's
// 227 KB per block.
size_t decode_attention_smem_bytes(int group, int D, int Dv) { return smem_bytes(group, D, Dv); }

// q (B,1,H,D), k/v (B,W,Hkv,D|Dv), pos (B,W) i32, q_pos (B,) i32 -> out (B,1,H,Dv).
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                         const void* q_pos, void* out, int B, int W, int H, int Hkv, int D,
                         int Dv, float scale, int has_window, int window, int is_bf16,
                         void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, v, pos, nullptr, q_pos, out, B, W, 1, 1, 0, H,
                                        Hkv, D, Dv, scale, has_window, window, stream);
  return launch<float, false>(q, k, v, pos, nullptr, q_pos, out, B, W, 1, 1, 0, H, Hkv, D, Dv,
                              scale, has_window, window, stream);
}

// q (B,1,H,D), pools (P,bs,Hkv,D|Dv), pos_pool (P,bs) i32, block_table (B,nb) i32,
// q_pos (B,) i32 -> out (B,1,H,Dv).
int paged_decode_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                               const void* pos_pool, const void* block_table,
                               const void* q_pos, void* out, int B, int nb, int bs, int P,
                               int H, int Hkv, int D, int Dv, float scale, int is_bf16,
                               void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16, true>(q, k_pool, v_pool, pos_pool, block_table, q_pos, out, B,
                                       nb * bs, bs, nb, P, H, Hkv, D, Dv, scale, 0, 0, stream);
  return launch<float, true>(q, k_pool, v_pool, pos_pool, block_table, q_pos, out, B, nb * bs,
                             bs, nb, P, H, Hkv, D, Dv, scale, 0, 0, stream);
}

}  // extern "C"
