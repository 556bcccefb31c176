// Single-token decode attention over a KV cache, dense ring or paged pool.
//
// Replaces the TPU kernels `decode_attention_pallas` and
// `paged_decode_attention_pallas` (src/repro/kernels/decode_attention/
// decode_attention.py). One query token per sequence attends over every
// cache slot whose absolute position is valid: 0 <= pos <= q_pos (and, dense
// only, pos > q_pos - window). Softmax state (m, l, acc) is f32.
//
// What bounds it on an H100: bytes in the TPU's accounting. Each step reads
// the whole K and V of every sequence once (2 * slots * Hkv * D * 2 B in
// bf16), far below the card's ~295 FLOP/byte ridge. But every K/V element
// serves all `group` query heads (16 for chatglm3-6b): on the CUDA cores the
// dense kernel issues 16 FMAs and a bf16 conversion an element, and at the
// serve shapes that instruction issue, not the bytes, sets its time
// (PERF.md).
//
// Dense ring (`decode_attention_split_kernel`): the slot axis split across
// blocks (flash-decoding), so that far more than B * Hkv blocks are in
// flight.
//  * The grid is (Hkv x head batches, B, n_split). A block of 256 threads
//    serves up to 16 query heads of one kv head from one read of each K/V
//    tile (the TPU grid ran (B, H, kv) and re-read every tile once per query
//    head) and reduces its range of slots to a partial (m, l, acc) per
//    head. `plan_splits` (kernels/decode_attention/split.py) gives each
//    (sequence, kv head) as many splits as still fit every block in one
//    wave of the card, each split at least one 32-slot tile.
//  * The last block of a (sequence, kv head, head batch) to finish merges
//    the partials into the output in the same launch: it learns it is last
//    from a counter (one atomicAdd a block) and resets the counter to 0
//    itself. A split with no valid slot contributes m = NEG_INF, l = 0,
//    acc = 0; the merge rescales by exp(m_i - m_safe) under the same guard
//    as the TPU kernel, so a row whose splits are all empty comes out 0.
//  * K/V tiles move by cp.async, 16 bytes a thread, double-buffered: the
//    next tile's bytes are in flight during this tile's scores and softmax.
//    The pos check is folded into the copy: a masked slot is zero-filled and
//    never read from device memory.
//  * Scores: the 16-byte chunks of a K row are spread over a row group of
//    up to 8 lanes (16 lanes fetch a D = 128 bf16 row; 8 score it, two
//    chunks each), so one pass covers a 32-slot tile; each lane takes the
//    dot product of its chunks with every query head (q in f32 in shared
//    memory), and shuffles sum the lanes' parts. P . V: a thread holds one
//    16-byte chunk of the output row for 1, 2 or 4 heads (the kernel is
//    instantiated for each, so that small groups use fewer registers and
//    three blocks fit an SM).
//
// Paged pool (`paged_decode_attention_split_kernel`): the same split of the
// logical slot axis (the nb * bs slots of a table row) and the same
// in-launch merge, with the scores and P . V on the tensor cores.
//  * Each block reads its own row of `block_table`: for each 32-slot tile one
//    lane a slot reads its table entry and its position, and the K / V rows
//    move by 16-byte cp.async straight from the pool, double-buffered; the
//    pool is never gathered into a dense copy. A table entry outside [0, P)
//    reads as an empty block, so a bad table cannot send a load outside the
//    pool; a masked slot is zero-filled and never read.
//  * A block of four warps serves up to 16 query heads (the 16 rows of an
//    mma tile: chatglm3-6b's group of 16 fills it, granite's 3 pad it); warp
//    w takes slots 8w .. 8w+7 of every tile and keeps its own online softmax
//    state in registers, in the accumulator layout of its scores (quad
//    shuffles give a row's max and sum). The warps merge in shared memory at
//    the end.
//  * bf16: S = q . K^T by mma.sync m16n8k16 (q as A, the K rows as B, both
//    by ldmatrix; products of bf16 values are exact in f32). P . V by
//    mma.sync m16n8k8 straight from the score accumulator, with P split into
//    a bf16 high part and a bf16 low part (P = hi + lo to about 16 bits, two
//    products into the same f32 accumulator) and V read through
//    ldmatrix.trans: P is not rounded to bf16's 8 bits.
//  * f32: the same structure with the two products on the CUDA cores.
//
// Paged pool, grouped (`paged_decode_attention_prefix_kernel`, then the
// per-row kernel): the k samples of a request are k rows whose tables start
// with the same prompt blocks. Read per row, the prompt streams from memory
// k times. With a group descriptor, one block takes up to 64 query rows (a
// row tile: samples x query heads of one kv head, 20 x 3 for granite, 4 x 16
// for chatglm3-6b), reads each K / V tile of the shared prefix once and
// scores it for all of them (an m16 tile a warp); the prefix's splits fill
// one wave. The per-row kernel then walks each row's own tail and merges
// both kernels' partials, in f32, as splits of the row.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

// ------------------------------------------------------ dense: split slots

namespace split {

constexpr int TILE = 32;     // cache slots per tile: one per lane in the softmax
constexpr int THREADS = 256;
constexpr int HB = 16;       // query heads a block serves at most
constexpr int PV_HEADS = 4;  // heads a thread accumulates at most (Dv rows <= 64 chunks)
constexpr int G_MAX = 8;     // lanes of a K row in the scores

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

__device__ __forceinline__ void unpack(const uint4& u, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Store a 16-byte chunk from f32: 8 bf16 or 4 f32 values.
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void store_chunk(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

// Where element d of a query head lies in its row of qs: chunk c's values
// e = 0..3 at 4c + e, and (bf16) e = 4..7 at 4 NC + 4c + e - 4, so that the
// lanes of a row group read 16 consecutive bytes each.
__device__ __forceinline__ int q_index(int d, int EPC, int NC) {
  const int c = d / EPC, e = d - c * EPC;
  return (e >> 2) * (NC * 4) + c * 4 + (e & 3);
}

// Shared memory of a block: q, then two buffers of [K tile | V tile], the
// slots' valid flags of each buffer, the scores, and the softmax state.
struct Smem {
  float* qs;     // HB x D, f32, as q_index lays it out
  uint4* kv;     // buffer i: K at kv + i * buf, V at kv + i * buf + TILE * NC
  int buf;       // chunks of one buffer: TILE * (NC + NCV)
  int* ok;       // buffer i: ok + i * TILE
  float *ps, *m, *l, *a;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int D, int NC, int NCV) {
  Smem sm;
  sm.qs = reinterpret_cast<float*>(raw);
  sm.kv = reinterpret_cast<uint4*>(sm.qs + HB * D);  // D is a multiple of 4
  sm.buf = TILE * (NC + NCV);
  sm.ok = reinterpret_cast<int*>(sm.kv + 2 * sm.buf);
  sm.ps = reinterpret_cast<float*>(sm.ok + 2 * TILE);  // HB * TILE
  sm.m = sm.ps + HB * TILE;
  sm.l = sm.m + HB;
  sm.a = sm.l + HB;
  return sm;
}

size_t smem_bytes(int D, int Dv, int elem) {
  const size_t NC = (size_t)D * elem / 16, NCV = (size_t)Dv * elem / 16;
  return sizeof(float) * HB * D + 16 * 2 * TILE * (NC + NCV) + sizeof(int) * 2 * TILE +
         sizeof(float) * (HB * TILE + 3 * HB);
}

// The last block of a (sequence, kv head, head batch) merges every split's
// partial into the output: first the (m, l) of every (head, split), all
// loads in flight together; then each head's factors exp(m_i - m_safe) and
// l; then the acc rows, four columns a thread. Partials of head row r
// (= b * H + h) and split s: acc at part + (r * stride + s) * Dv, (m, l) at
// part_ml[r * stride + s], s < n_split <= stride. n_split <= TILE
// (plan_splits), so a head's factors fit a row of ``mf``; ``mf`` and ``lf``
// hold HB x TILE floats, ``ls`` HB. A split with no valid slot has m =
// NEG_INF, l = 0, acc = 0 and factor 0, so a row whose splits are all empty
// comes out 0.
template <typename T, int NT>
__device__ __forceinline__ void merge_splits(const float* part, const float2* part_ml,
                                             long long row0, int nh, int n_split, int stride,
                                             int Dv, T* __restrict__ out, float* mf, float* lf,
                                             float* ls) {
  const int tid = threadIdx.x;
  for (int i = tid; i < nh * n_split; i += NT) {
    const int gi = i / n_split, s = i - gi * n_split;
    const float2 ml = __ldcg(part_ml + (row0 + gi) * stride + s);
    mf[gi * TILE + s] = ml.x;
    lf[gi * TILE + s] = ml.y;
  }
  __syncthreads();
  for (int gi = tid; gi < nh; gi += NT) {
    float m_max = NEG_INF;
    for (int s = 0; s < n_split; ++s) m_max = fmaxf(m_max, mf[gi * TILE + s]);
    const float m_safe = m_max <= NEG_INF * 0.5f ? 0.f : m_max;
    float l_sum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float m_i = mf[gi * TILE + s];
      const float f = m_i <= NEG_INF * 0.5f ? 0.f : expf(m_i - m_safe);
      mf[gi * TILE + s] = f;
      l_sum += f * lf[gi * TILE + s];
    }
    ls[gi] = fmaxf(l_sum, 1e-20f);
  }
  __syncthreads();
  const int nq = Dv / 4;
  for (int i = tid; i < nh * nq; i += NT) {
    const int gi = i / nq, d4 = i - gi * nq;
    const float4* pa = reinterpret_cast<const float4*>(part + (row0 + gi) * stride * Dv) + d4;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float f = mf[gi * TILE + s];
      const float4 x = __ldcg(pa + (long long)s * nq);
      a[0] += f * x.x;
      a[1] += f * x.y;
      a[2] += f * x.z;
      a[3] += f * x.w;
    }
    const float l = ls[gi];
    T* o = out + (row0 + gi) * Dv + 4 * d4;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f32<T>(a[e] / l);
  }
}

// part: f32 partials, acc (B, H, n_split, Dv) then (m, l) (B, H, n_split, 2);
// counters: one int a (sequence, kv head, head batch), 0 between launches.
// PVH: query heads a thread accumulates in P . V, 1, 2 or PV_HEADS (fewer
// registers, more blocks an SM, where the group and Dv allow).
template <typename T, int PVH>
__global__ void __launch_bounds__(THREADS, PVH < PV_HEADS ? 3 : 2)
    decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ q_pos, T* __restrict__ out, float* part,
                        int* counters, int W, int H, int Hkv, int D, int Dv, float scale,
                        int has_window, int window, int n_split, int split_slots, int n_hb) {
  constexpr int EPC = 16 / sizeof(T);  // values in a 16-byte chunk
  const int g = H / Hkv;
  const int kvh = blockIdx.x / n_hb;
  const int hb = blockIdx.x - kvh * n_hb;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int h0 = kvh * g + hb * HB;  // this block's first query head
  const int nh = min(HB, g - hb * HB);
  const int s_begin = sp * split_slots;
  const int s_end = min(W, s_begin + split_slots);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + TILE - 1) / TILE : 0;
  const int NC = D * (int)sizeof(T) / 16;    // 16-byte chunks of a K row
  const int NCV = Dv * (int)sizeof(T) / 16;  // and of a V row
  int G = 1;                                 // lanes of a row group: NC rounded up, <= 8
  while (G < NC && G < G_MAX) G <<= 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qp = q_pos[b];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const Smem sm = carve(smem_raw, D, NC, NCV);

  // copy the K and V rows of tile slots [t0, t0 + TILE) into buffer buf;
  // a slot outside the split or masked by its position is zero-filled
  // (all threads: it synchronises the block between reading the slots'
  // positions and issuing the copies)
  auto issue = [&](int buf, int t0) {
    int* ok_b = sm.ok + buf * TILE;
    if (tid < TILE) {
      const int j = t0 + tid;
      bool ok = j < s_end;
      if (ok) {
        const int p = pos[(long long)b * W + j];
        ok = p >= 0 && p <= qp;
        if (has_window) ok = ok && p > qp - window;
      }
      ok_b[tid] = ok;
    }
    __syncthreads();
    const int nk = TILE * NC;
    for (int i = tid; i < TILE * (NC + NCV); i += THREADS) {
      const bool is_k = i < nk;
      const int nc = is_k ? NC : NCV;
      const int ii = is_k ? i : i - nk;
      const int r = ii / nc, c = ii - r * nc;
      const bool ok = ok_b[r];
      const long long row = ((long long)b * W + t0 + r) * Hkv + kvh;
      const uint4* src = ok ? reinterpret_cast<const uint4*>(is_k ? k + row * D : v + row * Dv) + c
                            : reinterpret_cast<const uint4*>(k);
      cp_async16(sm.kv + buf * sm.buf + (is_k ? 0 : nk) + r * nc + c, src, ok);
    }
    cp_async_commit();
  };

  // P . V: thread = (V chunk cv, heads hl, hl + HL, ...)
  const int HL = THREADS / NCV;
  const int cv = tid % NCV;
  const int hl = tid / NCV;
  const bool pv_active = hl < HL;
  float acc[PVH][EPC];
#pragma unroll
  for (int j = 0; j < PVH; ++j)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[j][e] = 0.f;

  const T* qb = q + ((long long)b * H + h0) * D;
  for (int i = tid; i < nh * D; i += THREADS) {
    const int gi = i / D;
    sm.qs[gi * D + q_index(i - gi * D, EPC, NC)] = to_f32(qb[i]);
  }
  for (int i = tid; i < nh; i += THREADS) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.f;
  }

  if (n_tiles > 0) issue(0, s_begin);
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) {
      issue(cur ^ 1, s_begin + (t + 1) * TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* ks = sm.kv + cur * sm.buf;
    const uint4* vs = ks + TILE * NC;
    const int* ok_t = sm.ok + cur * TILE;

    // scores: the G lanes of row group r take slot r (one pass: THREADS / G
    // >= TILE), each lane chunks lr, lr + G, ... of the K row against every
    // head; shuffles sum the lanes' parts
    const int lr = tid & (G - 1);
    const int r = tid / G;
    if (r < TILE) {  // whole warps
      float dot[HB];
#pragma unroll
      for (int gi = 0; gi < HB; ++gi) dot[gi] = 0.f;
      if (ok_t[r]) {
        for (int c = lr; c < NC; c += G) {
          float kf[EPC];
          unpack(ks[r * NC + c], kf, (const T*)nullptr);
#pragma unroll
          for (int gi = 0; gi < HB; ++gi) {
            if (gi < nh) {
#pragma unroll
              for (int h = 0; h < EPC / 4; ++h) {
                const float4 x =
                    *reinterpret_cast<const float4*>(sm.qs + gi * D + h * NC * 4 + c * 4);
                dot[gi] += x.x * kf[4 * h] + x.y * kf[4 * h + 1] + x.z * kf[4 * h + 2] +
                           x.w * kf[4 * h + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int o = G_MAX / 2; o > 0; o >>= 1) {
        if (o < G) {
#pragma unroll
          for (int gi = 0; gi < HB; ++gi)
            if (gi < nh) dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], o);
        }
      }
#pragma unroll
      for (int gi = 0; gi < HB; ++gi)
        if (gi < nh && (gi & (G - 1)) == lr)
          sm.ps[gi * TILE + r] = ok_t[r] ? dot[gi] * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: warp w owns heads w, w + 4, ...; lane = slot
    for (int gi = warp; gi < nh; gi += THREADS / 32) {
      const float s = sm.ps[gi * TILE + lane];
      const float m_cur = warp_max(s);
      float m_new, m_safe, alpha;
      online_update(sm.m[gi], m_cur, &m_new, &m_safe, &alpha);
      const float p = s > NEG_INF * 0.5f ? expf(s - m_safe) : 0.f;
      const float psum = warp_sum(p);
      sm.ps[gi * TILE + lane] = p;
      if (lane == 0) {
        sm.m[gi] = m_new;
        sm.l[gi] = alpha * sm.l[gi] + psum;
        sm.a[gi] = alpha;
      }
    }
    __syncthreads();

    if (pv_active) {
#pragma unroll
      for (int j = 0; j < PVH; ++j) {
        const int gi = hl + j * HL;
        if (gi < nh) {
          const float al = sm.a[gi];
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[j][e] *= al;
        }
      }
      // masked slots hold zeros and p = 0: no branch
#pragma unroll 4
      for (int c = 0; c < TILE; ++c) {
        float vf[EPC];
        unpack(vs[c * NCV + cv], vf, (const T*)nullptr);
#pragma unroll
        for (int j = 0; j < PVH; ++j) {
          const int gi = hl + j * HL;
          if (gi < nh) {
            const float p = sm.ps[gi * TILE + c];
#pragma unroll
            for (int e = 0; e < EPC; ++e) acc[j][e] += p * vf[e];
          }
        }
      }
    }
    __syncthreads();  // buffer cur and ps are free for the next tile
  }
  __syncthreads();  // the state is visible even when the split held no tile

  if (n_split == 1) {
    if (pv_active) {
#pragma unroll
      for (int j = 0; j < PVH; ++j) {
        const int gi = hl + j * HL;
        if (gi < nh) {
          const float inv = 1.f / fmaxf(sm.l[gi], 1e-20f);
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[j][e] *= inv;
          store_chunk(out + ((long long)b * H + h0 + gi) * Dv + cv * EPC, acc[j]);
        }
      }
    }
    return;
  }

  const long long n_rows = (long long)gridDim.y * H * n_split;  // B * H * n_split
  float2* part_ml = reinterpret_cast<float2*>(part + n_rows * Dv);
  if (pv_active) {
#pragma unroll
    for (int j = 0; j < PVH; ++j) {
      const int gi = hl + j * HL;
      if (gi < nh) {
        float4* pa = reinterpret_cast<float4*>(
            part + (((long long)b * H + h0 + gi) * n_split + sp) * Dv + cv * EPC);
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4)
          pa[e4] = make_float4(acc[j][4 * e4], acc[j][4 * e4 + 1], acc[j][4 * e4 + 2],
                               acc[j][4 * e4 + 3]);
      }
    }
  }
  for (int gi = tid; gi < nh; gi += THREADS)
    part_ml[((long long)b * H + h0 + gi) * n_split + sp] = make_float2(sm.m[gi], sm.l[gi]);
  __threadfence();
  __syncthreads();
  int* counter = counters + ((long long)b * Hkv + kvh) * n_hb + hb;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  merge_splits<T, THREADS>(part, part_ml, (long long)b * H + h0, nh, n_split, n_split, Dv, out,
                           sm.ps, reinterpret_cast<float*>(sm.kv), sm.l);
  if (tid == 0) *counter = 0;
}

template <typename T>
using SplitKernel = void (*)(const T*, const T*, const T*, const int*, const int*, T*, float*,
                             int*, int, int, int, int, int, float, int, int, int, int, int);

// The kernel for a block of nh query heads: the fewest heads a thread.
template <typename T>
SplitKernel<T> kernel_for(int nh, int Dv) {
  const int HL = THREADS / (Dv * (int)sizeof(T) / 16);  // head lanes of P . V
  if (nh <= HL) return decode_attention_split_kernel<T, 1>;
  if (nh <= 2 * HL) return decode_attention_split_kernel<T, 2>;
  return decode_attention_split_kernel<T, PV_HEADS>;
}

template <typename T>
int blocks_per_sm(int g, int D, int Dv) {
  const size_t smem = smem_bytes(D, Dv, sizeof(T));
  auto kern = kernel_for<T>(min(g, HB), Dv);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* q_pos,
           void* out, void* part, void* counters, int B, int W, int H, int Hkv, int D, int Dv,
           float scale, int has_window, int window, int n_split, int split_slots, int n_hb,
           void* stream) {
  const size_t smem = smem_bytes(D, Dv, sizeof(T));
  auto kern = kernel_for<T>(min(H / Hkv, HB), Dv);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv * n_hb, B, n_split);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const int*)q_pos, (T*)out,
      (float*)part, (int*)counters, W, H, Hkv, D, Dv, scale, has_window, window, n_split,
      split_slots, n_hb);
  return (int)cudaGetLastError();
}

}  // namespace split

// ------------------------------------------------------ paged: split slots

namespace paged {

constexpr int TILE = 32;      // slots a block copies at a time: 8 a warp
constexpr int THREADS = 128;  // four warps
constexpr int HB = 16;        // query heads a block: the rows of an mma tile
constexpr int WARPS = THREADS / 32;
constexpr int CH = 8;         // tiles whose table entries one lookup pass reads
constexpr int STAGES = 3;     // K / V tiles in flight or in use: a ring of buffers

// Shared-memory row stride of n values: 16 bytes past the row, so that the
// eight rows an ldmatrix reads lie in distinct banks.
__host__ __device__ __forceinline__ int stride(int n, int elem) { return n * elem + 16; }

// Shared memory of a block: q (HB rows), the slots' pool rows of two
// chunks of CH tiles (2 x CH x TILE ints), then the region of the STAGES
// [K tile | V tile] buffers, which the merges reuse once the tiles are
// consumed.
__host__ __device__ __forceinline__ int region_bytes(int D, int Dv, int elem) {
  const int kv = STAGES * TILE * (stride(D, elem) + stride(Dv, elem));
  // the block merge: every warp's acc (WARPS x HB x Dv), (m, l) of every
  // warp and head, the heads' factors, m and l; the split merge: HB x TILE
  // factors and l, HB sums
  const int blk = (int)sizeof(float) * (WARPS * HB * Dv + 2 * WARPS * HB + WARPS * HB + 2 * HB);
  const int spl = (int)sizeof(float) * (2 * HB * TILE + HB);
  const int merge = blk > spl ? blk : spl;
  return kv > merge ? kv : merge;
}

size_t smem_bytes(int D, int Dv, int elem) {
  return (size_t)HB * stride(D, elem) + sizeof(int) * 2 * CH * TILE +
         region_bytes(D, Dv, elem);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16 x 16) . b (16 x 8), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16 x 8) . b (8 x 8), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// (lo, hi) as a bf16 pair, and what rounding left of each
__device__ __forceinline__ uint32_t split_pair(float lo, float hi, uint32_t* rest) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo - hf.x, hi - hf.y);
  *rest = *reinterpret_cast<const uint32_t*>(&r);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The scores of a warp's 8 slots of the tile against the block's 16 query
// heads, in the mma accumulator layout: s = (head gq, slot 2t), (gq, 2t+1),
// (gq+8, 2t), (gq+8, 2t+1) of the warp's slots. bf16: mma.sync from
// ldmatrix (q as A, K rows as B); products of bf16 values are exact in f32.
__device__ __forceinline__ void scores(float (&s)[4], const unsigned char* qs,
                                       const unsigned char* kt, int D, int SK, int warp,
                                       int lane, const __nv_bfloat16*) {
  const unsigned qa = smem_u32(qs + (lane & 15) * SK + (lane >> 4) * 16);
  const unsigned ka = smem_u32(kt + (warp * 8 + (lane & 7)) * SK + ((lane >> 3) & 1) * 16);
#pragma unroll 4
  for (int k = 0; k < D / 16; ++k) {
    uint32_t a[4], b[2];
    ldmatrix_x4(a, qa + 32 * k);
    ldmatrix_x2(b, ka + 32 * k);
    mma_k16(s, a, b);
  }
}

// f32: the four dot products on the CUDA cores.
__device__ __forceinline__ void scores(float (&s)[4], const unsigned char* qs,
                                       const unsigned char* kt, int D, int SK, int warp,
                                       int lane, const float*) {
  const int gq = lane >> 2, sl = warp * 8 + 2 * (lane & 3);
  const float4* q0 = reinterpret_cast<const float4*>(qs + gq * SK);
  const float4* q1 = reinterpret_cast<const float4*>(qs + (gq + 8) * SK);
  const float4* k0 = reinterpret_cast<const float4*>(kt + sl * SK);
  const float4* k1 = reinterpret_cast<const float4*>(kt + (sl + 1) * SK);
  for (int c = 0; c < D / 4; ++c) {
    const float4 a = q0[c], b = q1[c], x = k0[c], y = k1[c];
    s[0] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
    s[1] += a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
    s[2] += b.x * x.x + b.y * x.y + b.z * x.z + b.w * x.w;
    s[3] += b.x * y.x + b.y * y.y + b.z * y.z + b.w * y.w;
  }
}

// acc (NV n8 tiles of Dv, accumulator layout) += P (the warp's 8 slots,
// accumulator layout p) . V (those 8 rows of the tile). bf16: P split into
// a bf16 high and low part, P = hi + lo to about 16 bits, two m16n8k8 mma
// into the same f32 accumulator; V through ldmatrix.trans.
template <int NV>
__device__ __forceinline__ void pv(float (&acc)[NV][4], const float (&p)[4],
                                   const unsigned char* vt, int Dv, int SV, int warp, int lane,
                                   const __nv_bfloat16*) {
  uint32_t hi[2], lo[2];
  hi[0] = split_pair(p[0], p[1], &lo[0]);
  hi[1] = split_pair(p[2], p[3], &lo[1]);
  const unsigned va = smem_u32(vt + (warp * 8 + (lane & 7)) * SV + (lane >> 3) * 16);
  const int nv8 = Dv / 8;
#pragma unroll
  for (int j = 0; j < NV; j += 4) {
    if (j + 4 <= nv8) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, va + 16 * j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma_k8(acc[j + u], hi, b[u]);
        mma_k8(acc[j + u], lo, b[u]);
      }
    } else if (j + 2 <= nv8) {  // Dv % 32 == 16: the last two tiles
      uint32_t b[2];
      ldmatrix_x2_trans(b, va + 16 * j);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mma_k8(acc[j + u], hi, b[u]);
        mma_k8(acc[j + u], lo, b[u]);
      }
    }
  }
}

// f32: P of the warp's 8 slots gathered from the lane's quad, then FMAs.
template <int NV>
__device__ __forceinline__ void pv(float (&acc)[NV][4], const float (&p)[4],
                                   const unsigned char* vt, int Dv, int SV, int warp, int lane,
                                   const float*) {
  float pa[8], pb[8];  // heads gq and gq + 8, slots 0..7 of the warp
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int src = (lane & ~3) | t;
    pa[2 * t] = __shfl_sync(0xffffffffu, p[0], src);
    pa[2 * t + 1] = __shfl_sync(0xffffffffu, p[1], src);
    pb[2 * t] = __shfl_sync(0xffffffffu, p[2], src);
    pb[2 * t + 1] = __shfl_sync(0xffffffffu, p[3], src);
  }
  const int nv8 = Dv / 8;
  const unsigned char* v0 = vt + warp * 8 * SV + 2 * (lane & 3) * 4;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j < nv8) {
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) {
        const float2 v = *reinterpret_cast<const float2*>(v0 + sl * SV + 32 * j);
        acc[j][0] += pa[sl] * v.x;
        acc[j][1] += pa[sl] * v.y;
        acc[j][2] += pb[sl] * v.x;
        acc[j][3] += pb[sl] * v.y;
      }
    }
  }
}

// The splits of a group's shared prefix of n slots when a (row tile, kv
// head) may take n_ps of them: never more splits than 32-slot tiles, each
// of `prefix_split_tiles` tiles, none empty. The prefix and the per-row
// kernel both compute it, so they agree on a row's partials.
__device__ __forceinline__ int prefix_split_tiles(int n_ps, int n) {
  const int tiles = (n + TILE - 1) / TILE;
  const int k = min(n_ps, tiles);
  return k > 0 ? (tiles + k - 1) / k : 0;
}

__device__ __forceinline__ int prefix_splits(int n_ps, int n) {
  const int per = prefix_split_tiles(n_ps, n);
  return per > 0 ? ((n + TILE - 1) / TILE + per - 1) / per : 0;
}

// One token of each sequence against the pool blocks of its table row.
// Grid (Hkv x head batches, B, n_split) over the nb * bs logical slots of a
// row, cut by `plan_splits` into n_split ranges of split_slots. A block of
// four warps serves up to 16 query heads of one kv head: it copies a tile
// of 32 slots at a time, and warp w takes slots 8w .. 8w+7 of every tile,
// keeping its own online softmax state; the warps merge in shared memory at
// the end, and the block's partial joins the other splits' as in the dense
// kernel. part / counters as there, part_stride partial slots a head row;
// NV: n8 tiles of Dv a lane's accumulator holds (4, 8 or 16: Dv <= 32, 64,
// 128).
//
// With ``groups`` (the grouped path, `paged_decode_attention_prefix_kernel`
// ran first in the stream), a row whose group shares a prefix walks only its
// tail, the slots from the prefix's end on, cut into n_split ranges of
// equal tiles, and the merge takes the prefix kernel's partials of the row
// (slots n_split .. n_split + n_pre of its head rows) with the tail's. A row
// with no group, or whose group shares fewer than min_shared blocks, walks
// its whole row as without ``groups``.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, 4)
    paged_decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                        const T* __restrict__ v_pool,
                                        const int* __restrict__ pos_pool,
                                        const int* __restrict__ table,
                                        const int* __restrict__ groups,
                                        const int* __restrict__ meta,
                                        const int* __restrict__ q_pos, T* __restrict__ out,
                                        float* part, int* counters, int nb, int bs, int P,
                                        int H, int Hkv, int D, int Dv, float scale,
                                        int n_split, int split_slots, int part_stride,
                                        int n_hb, int min_shared) {
  constexpr int E = (int)sizeof(T);
  constexpr int EPC = 16 / E;  // values in a 16-byte chunk
  const int g = H / Hkv;
  const int kvh = blockIdx.x / n_hb;
  const int hb = blockIdx.x - kvh * n_hb;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int h0 = kvh * g + hb * HB;  // this block's first query head
  const int nh = min(HB, g - hb * HB);
  // the row's range of slots: the whole row, or the tail past its group's
  // shared prefix (n_pre of the prefix kernel's partials join the merge)
  int first = 0, span = split_slots, n_pre = 0;
  if (groups != nullptr) {
    const int blocks = groups[2 * b + 1];
    const int shared = blocks >= max(1, min_shared) ? min(blocks, nb) * bs : 0;
    if (shared > 0) {
      first = shared;
      n_pre = prefix_splits(*meta, shared);
      const int tiles = (nb * bs - shared + TILE - 1) / TILE;
      span = max(1, (tiles + n_split - 1) / n_split) * TILE;
    }
  }
  const int s_begin = first + sp * span;
  const int s_end = min(nb * bs, s_begin + span);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + TILE - 1) / TILE : 0;
  const int SK = stride(D, E), SV = stride(Dv, E);
  const int NCK = D / EPC, NCV = Dv / EPC;  // 16-byte chunks of a K and a V row
  const int buf_bytes = TILE * (SK + SV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int qp = q_pos[b];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  unsigned char* qs = smem_raw;                                // HB rows of SK bytes
  int* rows = reinterpret_cast<int*>(qs + HB * SK);            // 2 x CH x TILE
  unsigned char* region = reinterpret_cast<unsigned char*>(rows + 2 * CH * TILE);

  // the block's query heads; rows past nh stay zero
  for (int i = tid; i < HB * NCK; i += THREADS) {
    const int r = i / NCK, c = i - r * NCK;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < nh)
      u = *reinterpret_cast<const uint4*>(q + ((long long)b * H + h0 + r) * D + c * EPC);
    *reinterpret_cast<uint4*>(qs + r * SK + c * 16) = u;
  }

  // The pool rows of the slots of tiles [CH k, CH k + CH) of the split into
  // chunk buffer k & 1, two slots a thread (one pass of dependent loads for
  // CH tiles): a slot reads its table entry and its position; an entry
  // outside [0, P), a slot past the split and a masked position read as -1.
  auto lookup = [&](int k) {
    int* rb = rows + (k & 1) * CH * TILE;
#pragma unroll
    for (int u = 0; u < CH * TILE / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int j = s_begin + k * CH * TILE + i;
      int row = -1;
      if (j < s_end) {
        const int lb = j / bs;
        const int blk = table[(long long)b * nb + lb];
        if (blk >= 0 && blk < P) {
          const int r = blk * bs + (j - lb * bs);
          const int p = pos_pool[r];
          if (p >= 0 && p <= qp) row = r;
        }
      }
      rb[i] = row;
    }
  };
  auto tile_rows = [&](int it) { return rows + ((it / CH) & 1) * CH * TILE + (it % CH) * TILE; };

  // The K and V rows of tile it into buffer buf by cp.async, 16 bytes a
  // thread; a slot at -1 is zero-filled and nothing is read for it.
  auto issue = [&](int buf, int it) {
    const int* rb = tile_rows(it);
    unsigned char* kb = region + buf * buf_bytes;
    unsigned char* vb = kb + TILE * SK;
    const int nk = TILE * NCK;
    for (int i = tid; i < TILE * (NCK + NCV); i += THREADS) {
      const bool is_k = i < nk;
      const int nc = is_k ? NCK : NCV;
      const int ii = is_k ? i : i - nk;
      const int r = ii / nc, c = ii - r * nc;
      const int row = rb[r];
      const bool ok = row >= 0;
      const long long hr = (long long)row * Hkv + kvh;
      const T* src = !ok ? k_pool : is_k ? k_pool + hr * D + c * EPC : v_pool + hr * Dv + c * EPC;
      split::cp_async16((is_k ? kb + r * SK : vb + r * SV) + c * 16, src, ok);
    }
    split::cp_async_commit();
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // a ring of STAGES buffers: tile it + STAGES - 1 is copied while tile it
  // is scored (an empty commit group past the last tile keeps the count)
  if (n_tiles > 0) {
    lookup(0);
    __syncthreads();
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles)
      issue(st, st);
    else
      split::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it % STAGES;
    const int nxt = it + STAGES - 1;
    if (nxt < n_tiles) {
      if (nxt % CH == 0) {  // the next chunk's lookups (the other buffer)
        lookup(nxt / CH);
        __syncthreads();
      }
      issue(nxt % STAGES, nxt);
    } else {
      split::cp_async_commit();
    }
    split::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* kt = region + cur * buf_bytes;
    const unsigned char* vt = kt + TILE * SK;
    const int sl = warp * 8 + 2 * t4;  // this lane's two slots of the tile
    const int* rt = tile_rows(it);
    const bool ok0 = rt[sl] >= 0, ok1 = rt[sl + 1] >= 0;
    // a warp whose 8 slots are all masked leaves its state as it is (the
    // update would scale by 1 and add 0): it skips the tile
    if (__any_sync(0xffffffffu, ok0 || ok1)) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      scores(s, qs, kt, D, SK, warp, lane, (const T*)nullptr);

      // online softmax on the accumulator: rows gq (r = 0) and gq + 8 (r =
      // 1); the quad's four lanes hold a row's 8 slots
      float p[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = ok0 ? s[2 * r] * scale : NEG_INF;
        const float x1 = ok1 ? s[2 * r + 1] * scale : NEG_INF;
        float mc = fmaxf(x0, x1);
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        float m_new, m_safe, alpha;
        online_update(m[r], mc, &m_new, &m_safe, &alpha);
        p[2 * r] = ok0 ? expf(x0 - m_safe) : 0.f;
        p[2 * r + 1] = ok1 ? expf(x1 - m_safe) : 0.f;
        l[r] = alpha * l[r] + p[2 * r] + p[2 * r + 1];
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }
      // masked slots hold zeros and p = 0: no branch
      pv<NV>(acc, p, vt, Dv, SV, warp, lane, (const T*)nullptr);
    }
    __syncthreads();  // buffer cur is free for tile it + STAGES
  }
  __syncthreads();  // the region is free even when the split held no tile

  // the four warps' states into one: a lane's l is its two slots' part
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* accw = reinterpret_cast<float*>(region);  // WARPS x HB x Dv
  float* mw = accw + WARPS * HB * Dv;              // WARPS x HB
  float* lw = mw + WARPS * HB;                     // WARPS x HB
  float* fw = lw + WARPS * HB;                     // HB x WARPS: the warps' factors
  float* mb = fw + WARPS * HB;                     // HB: the block's m and l
  float* lb = mb + HB;
  const int nv8 = Dv / 8;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j < nv8) {
      float* a = accw + (warp * HB + gq) * Dv + 8 * j + 2 * t4;
      a[0] = acc[j][0];
      a[1] = acc[j][1];
      a[8 * Dv] = acc[j][2];
      a[8 * Dv + 1] = acc[j][3];
    }
  }
  if (t4 == 0) {
    mw[warp * HB + gq] = m[0];
    mw[warp * HB + gq + 8] = m[1];
    lw[warp * HB + gq] = l[0];
    lw[warp * HB + gq + 8] = l[1];
  }
  __syncthreads();
  if (tid < HB) {
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mw[w * HB + tid]);
    const float ms = mx <= NEG_INF * 0.5f ? 0.f : mx;
    float ls = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float mi = mw[w * HB + tid];
      const float f = mi <= NEG_INF * 0.5f ? 0.f : expf(mi - ms);
      fw[tid * WARPS + w] = f;
      ls += f * lw[w * HB + tid];
    }
    mb[tid] = mx;
    lb[tid] = ls;
  }
  __syncthreads();

  const long long row0 = (long long)b * H + h0;
  const int n_parts = n_split + n_pre;
  if (n_parts == 1) {
    for (int i = tid; i < nh * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += fw[r * WARPS + w] * accw[(w * HB + r) * Dv + d];
      out[(row0 + r) * Dv + d] = from_f32<T>(a / fmaxf(lb[r], 1e-20f));
    }
    return;
  }

  const long long n_rows = (long long)gridDim.y * H * part_stride;  // B * H * part_stride
  float2* part_ml = reinterpret_cast<float2*>(part + n_rows * Dv);
  for (int i = tid; i < nh * Dv; i += THREADS) {
    const int r = i / Dv, d = i - r * Dv;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += fw[r * WARPS + w] * accw[(w * HB + r) * Dv + d];
    part[((row0 + r) * part_stride + sp) * Dv + d] = a;
  }
  for (int r = tid; r < nh; r += THREADS)
    part_ml[(row0 + r) * part_stride + sp] = make_float2(mb[r], lb[r]);
  __threadfence();
  __syncthreads();
  // the prefix's partials are complete (its kernel ran first): with one
  // tail split this block merges at once
  int* counter = counters + ((long long)b * Hkv + kvh) * n_hb + hb;
  if (n_split > 1) {
    if (tid == 0) is_last = atomicAdd(counter, 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }

  float* mf = reinterpret_cast<float*>(region);  // HB x TILE
  split::merge_splits<T, THREADS>(part, part_ml, row0, nh, n_parts, part_stride, Dv, out, mf,
                                  mf + HB * split::TILE, mf + 2 * HB * split::TILE);
  if (n_split > 1 && tid == 0) *counter = 0;
}

// ------------------------------------------- paged, grouped: shared prefixes

constexpr int MT = WARPS * 16;  // query rows of a prefix block: an m16 tile a warp

// Shared memory of a prefix block: q (MT rows), the slots' positions and
// pool rows of two chunks of CH tiles (4 x CH x TILE ints), the STAGES [K
// tile | V tile] buffers, and the launch's list of row tiles (B ints at
// most).
size_t prefix_smem_bytes(int D, int Dv, int elem, int B) {
  return (size_t)MT * stride(D, elem) + sizeof(int) * 4 * CH * TILE +
         (size_t)STAGES * TILE * (stride(D, elem) + stride(Dv, elem)) + sizeof(int) * B;
}

// The scores of a warp's 16 query rows against the tile's 32 slots, in the
// accumulator layout of four n8 tiles: s[j] = (row gq, slot 8j + 2t), (gq,
// 8j + 2t + 1), (gq + 8, 8j + 2t), (gq + 8, 8j + 2t + 1). bf16: mma.sync from
// ldmatrix (q as A, K rows as B).
__device__ __forceinline__ void scores_rows(float (&s)[4][4], const unsigned char* qs,
                                            const unsigned char* kt, int D, int SK, int warp,
                                            int lane, const __nv_bfloat16*) {
  const unsigned qa = smem_u32(qs + (warp * 16 + (lane & 15)) * SK + (lane >> 4) * 16);
  const unsigned ka = smem_u32(kt + (lane & 7) * SK + ((lane >> 3) & 1) * 16);
#pragma unroll 2
  for (int k = 0; k < D / 16; ++k) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + 32 * k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[2];
      ldmatrix_x2(b, ka + 8 * j * SK + 32 * k);
      mma_k16(s[j], a, b);
    }
  }
}

// f32: the sixteen dot products on the CUDA cores.
__device__ __forceinline__ void scores_rows(float (&s)[4][4], const unsigned char* qs,
                                            const unsigned char* kt, int D, int SK, int warp,
                                            int lane, const float*) {
  const int gq = lane >> 2, t4 = lane & 3;
  const float4* q0 = reinterpret_cast<const float4*>(qs + (warp * 16 + gq) * SK);
  const float4* q1 = reinterpret_cast<const float4*>(qs + (warp * 16 + gq + 8) * SK);
  for (int c = 0; c < D / 4; ++c) {
    const float4 a = q0[c], b = q1[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = reinterpret_cast<const float4*>(kt + (8 * j + 2 * t4) * SK)[c];
      const float4 y = reinterpret_cast<const float4*>(kt + (8 * j + 2 * t4 + 1) * SK)[c];
      s[j][0] += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
      s[j][1] += a.x * y.x + a.y * y.y + a.z * y.z + a.w * y.w;
      s[j][2] += b.x * x.x + b.y * x.y + b.z * x.z + b.w * x.w;
      s[j][3] += b.x * y.x + b.y * y.y + b.z * y.z + b.w * y.w;
    }
  }
}

// acc (NV n8 tiles of Dv) += P (the warp's 16 rows x the tile's 32 slots,
// the layout of `scores_rows`) . V (the tile's 32 rows). bf16: two k16
// steps; the score accumulator is the A operand, P split into a bf16 high
// and low part (two mma into the same f32 accumulator); V through
// ldmatrix.trans, two n8 tiles a load.
template <int NV>
__device__ __forceinline__ void pv_rows(float (&acc)[NV][4], const float (&p)[4][4],
                                        const unsigned char* vt, int Dv, int SV, int lane,
                                        const __nv_bfloat16*) {
  const int nv8 = Dv / 8;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t hi[4], lo[4];
    hi[0] = split_pair(p[2 * s][0], p[2 * s][1], &lo[0]);
    hi[1] = split_pair(p[2 * s][2], p[2 * s][3], &lo[1]);
    hi[2] = split_pair(p[2 * s + 1][0], p[2 * s + 1][1], &lo[2]);
    hi[3] = split_pair(p[2 * s + 1][2], p[2 * s + 1][3], &lo[3]);
    const unsigned va = smem_u32(vt + (16 * s + (lane & 15)) * SV + (lane >> 4) * 16);
#pragma unroll
    for (int j = 0; j < NV; j += 2) {
      if (j + 2 <= nv8) {  // Dv is a multiple of 16
        uint32_t b[4];
        ldmatrix_x4_trans(b, va + 16 * j);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_k16(acc[j], hi, b0);
        mma_k16(acc[j], lo, b0);
        mma_k16(acc[j + 1], hi, b1);
        mma_k16(acc[j + 1], lo, b1);
      }
    }
  }
}

// f32: P of each slot gathered from the lane's quad, then FMAs.
template <int NV>
__device__ __forceinline__ void pv_rows(float (&acc)[NV][4], const float (&p)[4][4],
                                        const unsigned char* vt, int Dv, int SV, int lane,
                                        const float*) {
  const int nv8 = Dv / 8, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int src = (lane & ~3) | t;
      const float a0 = __shfl_sync(0xffffffffu, p[j][0], src);
      const float a1 = __shfl_sync(0xffffffffu, p[j][1], src);
      const float b0 = __shfl_sync(0xffffffffu, p[j][2], src);
      const float b1 = __shfl_sync(0xffffffffu, p[j][3], src);
      const unsigned char* v0 = vt + (8 * j + 2 * t) * SV + 8 * t4;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (n < nv8) {
          const float2 x = *reinterpret_cast<const float2*>(v0 + 32 * n);
          const float2 y = *reinterpret_cast<const float2*>(v0 + SV + 32 * n);
          acc[n][0] += a0 * x.x + a1 * y.x;
          acc[n][1] += a0 * x.y + a1 * y.y;
          acc[n][2] += b0 * x.x + b1 * y.x;
          acc[n][3] += b0 * x.y + b1 * y.y;
        }
      }
    }
  }
}

// The shared prefixes of the grouped path. ``groups`` (B, 2) gives each
// row the first row of its group and the group's shared blocks: the rows of
// a group are consecutive and their tables start with the same entries for
// that many blocks (0: the row has no group; a group of fewer than
// min_shared blocks is taken as none, as in the per-row kernel). A row
// tile is up to MT / g consecutive rows of one group, MT query rows
// (samples x query heads of a kv head); one block serves one (row tile,
// kv head, prefix split) at a time, grid-stride over all of them: it reads
// each K / V tile of the prefix once through the tile's first table row
// and scores it for every query row, warp w taking rows 16w .. 16w + 15 and all 32 slots, with the
// per-row mask pos <= q_pos of the row's own sequence. Every block lists
// the row tiles from ``groups``; the launch's grid (one wave) over the
// (row tile, kv head) pairs sets the splits a pair takes, at most p_cap,
// which block 0 writes to ``meta`` for the per-row kernel. Each split's
// partial (m, l, acc) of a head row goes to slot n_split + split of the
// row's part_stride slots; the per-row kernel merges them with its tail's.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, NV >= 16 ? 3 : 4)
    paged_decode_attention_prefix_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                         const T* __restrict__ v_pool,
                                         const int* __restrict__ pos_pool,
                                         const int* __restrict__ table,
                                         const int* __restrict__ groups,
                                         const int* __restrict__ q_pos, float* part, int* meta,
                                         int B, int nb, int bs, int P, int H, int Hkv, int D,
                                         int Dv, float scale, int n_split, int part_stride,
                                         int p_cap, int min_shared) {
  constexpr int E = (int)sizeof(T);
  constexpr int EPC = 16 / E;
  const int g = H / Hkv;
  const int rt = max(1, MT / g);  // rows of a row tile
  const int SK = stride(D, E), SV = stride(Dv, E);
  const int NCK = D / EPC, NCV = Dv / EPC;
  const int buf_bytes = TILE * (SK + SV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int nv8 = Dv / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wcount[WARPS];
  __shared__ int qp_max_s;
  unsigned char* qs = smem_raw;                             // MT rows of SK bytes
  int* spos = reinterpret_cast<int*>(qs + MT * SK);         // 2 x CH x TILE positions
  int* srow = spos + 2 * CH * TILE;                         // 2 x CH x TILE pool rows
  unsigned char* region = reinterpret_cast<unsigned char*>(srow + 2 * CH * TILE);
  int* tiles = reinterpret_cast<int*>(region + STAGES * buf_bytes);  // each row tile's first row

  // the row tiles: one starts at every rt-th row of a group
  int n_tiles = 0;
  for (int base = 0; base < B; base += THREADS) {
    const int r = base + tid;
    bool start = false;
    if (r < B) {
      const int lead = groups[2 * r];
      start = groups[2 * r + 1] >= max(1, min_shared) && lead >= 0 && lead <= r &&
              (r - lead) % rt == 0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, start);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = n_tiles, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) off += wcount[w];
      total += wcount[w];
    }
    if (start) tiles[off + __popc(bal & ((1u << lane) - 1u))] = r;
    n_tiles += total;
    __syncthreads();
  }
  const int pairs = n_tiles * Hkv;
  const int n_ps = pairs > 0 ? max(1, min(p_cap, (int)gridDim.x / pairs)) : 1;
  if (blockIdx.x == 0 && tid == 0) *meta = n_ps;
  float2* part_ml = reinterpret_cast<float2*>(part + (long long)B * H * part_stride * Dv);

  for (int w = blockIdx.x; w < pairs * n_ps; w += gridDim.x) {
    const int ps = w % n_ps;
    const int kvh = (w / n_ps) % Hkv;
    const int r0 = tiles[w / n_ps / Hkv];
    const int lead = groups[2 * r0];
    const int n_pre = min(groups[2 * r0 + 1], nb) * bs;
    const int per = prefix_split_tiles(n_ps, n_pre);
    if (ps >= prefix_splits(n_ps, n_pre)) continue;  // the same for the whole block
    const int s_begin = ps * per * TILE;
    const int s_end = min(n_pre, s_begin + per * TILE);
    const int n_t = (s_end - s_begin + TILE - 1) / TILE;
    if (tid == 0) qp_max_s = -1;
    // the tile's rows: up to rt of the group from r0 (also the barrier
    // before this item's q overwrites the last one's)
    const int nr = __syncthreads_count(tid < rt && r0 + tid < B &&
                                       groups[2 * (r0 + tid)] == lead);
    const int nq = nr * g;  // query rows
    if (tid < nr) atomicMax(&qp_max_s, q_pos[r0 + tid]);
    for (int i = tid; i < MT * NCK; i += THREADS) {
      const int r = i / NCK, c = i - r * NCK;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < nq)
        u = *reinterpret_cast<const uint4*>(
            q + ((long long)(r0 + r / g) * H + kvh * g + r % g) * D + c * EPC);
      *reinterpret_cast<uint4*>(qs + r * SK + c * 16) = u;
    }
    __syncthreads();
    const int qp_max = qp_max_s;
    // this lane's two query rows and their sequences' positions (-1 masks
    // every slot of a pad row)
    const int i0 = warp * 16 + gq, i1 = i0 + 8;
    const int qp0 = i0 < nq ? q_pos[r0 + i0 / g] : -1;
    const int qp1 = i1 < nq ? q_pos[r0 + i1 / g] : -1;
    const bool active = warp * 16 < nq;

    // the slots of tiles [CH k, CH k + CH) of the split, through row r0's
    // table, into chunk buffer k & 1: a slot is copied when some row of the
    // tile may see it (an entry in [0, P), 0 <= pos <= the tile's largest
    // q_pos), else zero-filled and its position -1
    auto lookup = [&](int k) {
      int* pb = spos + (k & 1) * CH * TILE;
      int* rb = srow + (k & 1) * CH * TILE;
#pragma unroll
      for (int u = 0; u < CH * TILE / THREADS; ++u) {
        const int i = tid + u * THREADS;
        const int j = s_begin + k * CH * TILE + i;
        int row = -1, p = -1;
        if (j < s_end) {
          const int lb = j / bs;
          const int blk = table[(long long)r0 * nb + lb];
          if (blk >= 0 && blk < P) {
            const int r = blk * bs + (j - lb * bs);
            p = pos_pool[r];
            if (p >= 0 && p <= qp_max)
              row = r;
            else
              p = -1;
          }
        }
        pb[i] = p;
        rb[i] = row;
      }
    };
    const int chunk = CH * TILE;
    // the K and V rows of tile it into buffer buf
    auto issue = [&](int buf, int it) {
      const int* rb = srow + ((it / CH) & 1) * chunk + (it % CH) * TILE;
      unsigned char* kb = region + buf * buf_bytes;
      unsigned char* vb = kb + TILE * SK;
      const int nk = TILE * NCK;
      for (int i = tid; i < TILE * (NCK + NCV); i += THREADS) {
        const bool is_k = i < nk;
        const int nc = is_k ? NCK : NCV;
        const int ii = is_k ? i : i - nk;
        const int r = ii / nc, c = ii - r * nc;
        const int row = rb[r];
        const bool ok = row >= 0;
        const long long hr = (long long)row * Hkv + kvh;
        const T* src =
            !ok ? k_pool : is_k ? k_pool + hr * D + c * EPC : v_pool + hr * Dv + c * EPC;
        split::cp_async16((is_k ? kb + r * SK : vb + r * SV) + c * 16, src, ok);
      }
      split::cp_async_commit();
    };

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[NV][4];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    lookup(0);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_t)
        issue(st, st);
      else
        split::cp_async_commit();
    }
    for (int it = 0; it < n_t; ++it) {
      const int cur = it % STAGES;
      const int nxt = it + STAGES - 1;
      if (nxt < n_t) {
        if (nxt % CH == 0) {  // the next chunk's lookups (the other buffer)
          lookup(nxt / CH);
          __syncthreads();
        }
        issue(nxt % STAGES, nxt);
      } else {
        split::cp_async_commit();
      }
      split::cp_async_wait<STAGES - 1>();
      __syncthreads();
      if (active) {
        const unsigned char* kt = region + cur * buf_bytes;
        const unsigned char* vt = kt + TILE * SK;
        const int* pt = spos + ((it / CH) & 1) * chunk + (it % CH) * TILE;
        float s[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        scores_rows(s, qs, kt, D, SK, warp, lane, (const T*)nullptr);
        // online softmax on the accumulator: rows gq (r = 0) and gq + 8
        // (r = 1), each slot masked by the row's own position
        float p[4][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r ? qp1 : qp0;
          unsigned ok = 0u;
          float mc = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int ps_ = pt[8 * j + 2 * t4 + c];
              if (ps_ >= 0 && ps_ <= qp) {
                ok |= 1u << (2 * j + c);
                s[j][2 * r + c] *= scale;
                mc = fmaxf(mc, s[j][2 * r + c]);
              }
            }
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
          float m_new, m_safe, alpha;
          online_update(m[r], mc, &m_new, &m_safe, &alpha);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float x = (ok >> (2 * j + c)) & 1u ? expf(s[j][2 * r + c] - m_safe) : 0.f;
              p[j][2 * r + c] = x;
              sum += x;
            }
          l[r] = alpha * l[r] + sum;
          m[r] = m_new;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            acc[j][2 * r] *= alpha;
            acc[j][2 * r + 1] *= alpha;
          }
        }
        pv_rows<NV>(acc, p, vt, Dv, SV, lane, (const T*)nullptr);
      }
      __syncthreads();  // buffer cur is free for tile it + STAGES
    }

    // the split's partial of each query row: the quad's l summed, acc and
    // (m, l) to its slot
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int i = r ? i1 : i0;
        if (i < nq) {
          const long long hr = (long long)(r0 + i / g) * H + kvh * g + i % g;
          const long long slot = hr * part_stride + n_split + ps;
          float* pa = part + slot * Dv + 2 * t4;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            if (j < nv8)
              *reinterpret_cast<float2*>(pa + 8 * j) =
                  make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
          if (t4 == 0) part_ml[slot] = make_float2(m[r], l[r]);
        }
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, const int*, const int*,
                        const int*, const int*, T*, float*, int*, int, int, int, int, int, int,
                        int, float, int, int, int, int, int);

template <typename T>
using PrefixKernel = void (*)(const T*, const T*, const T*, const int*, const int*, const int*,
                              const int*, float*, int*, int, int, int, int, int, int, int, int,
                              float, int, int, int, int);

template <typename T>
Kernel<T> kernel_for(int Dv) {
  if (Dv <= 32) return paged_decode_attention_split_kernel<T, 4>;
  if (Dv <= 64) return paged_decode_attention_split_kernel<T, 8>;
  return paged_decode_attention_split_kernel<T, 16>;
}

template <typename T>
PrefixKernel<T> prefix_kernel_for(int Dv) {
  if (Dv <= 32) return paged_decode_attention_prefix_kernel<T, 4>;
  if (Dv <= 64) return paged_decode_attention_prefix_kernel<T, 8>;
  return paged_decode_attention_prefix_kernel<T, 16>;
}

template <typename K>
int occupancy(K kern, size_t smem) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

template <typename T>
int blocks_per_sm(int D, int Dv) {
  return occupancy(kernel_for<T>(Dv), smem_bytes(D, Dv, sizeof(T)));
}

template <typename T>
int prefix_blocks_per_sm(int D, int Dv, int B) {
  return occupancy(prefix_kernel_for<T>(Dv), prefix_smem_bytes(D, Dv, sizeof(T), B));
}

// groups == nullptr: the per-row kernel alone. Else the prefix kernel on
// prefix_grid blocks first, then the per-row kernel over the rows' tails,
// part_stride = n_split + p_cap partial slots a head row, and the prefix's
// split count in the int after the partials.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* table,
           const void* groups, const void* q_pos, void* out, void* part, void* counters, int B,
           int nb, int bs, int P, int H, int Hkv, int D, int Dv, float scale, int n_split,
           int split_slots, int n_hb, int prefix_grid, int p_cap, int min_shared,
           void* stream) {
  const int part_stride = groups != nullptr ? n_split + p_cap : n_split;
  int* meta = nullptr;
  cudaError_t err;
  if (groups != nullptr) {
    meta = reinterpret_cast<int*>(static_cast<float*>(part) +
                                  (long long)B * H * part_stride * (Dv + 2));
    const size_t psmem = prefix_smem_bytes(D, Dv, sizeof(T), B);
    auto pk = prefix_kernel_for<T>(Dv);
    err = cudaFuncSetAttribute(pk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)psmem);
    if (err != cudaSuccess) return (int)err;
    pk<<<prefix_grid, THREADS, psmem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const int*)table,
        (const int*)groups, (const int*)q_pos, (float*)part, meta, B, nb, bs, P, H, Hkv, D, Dv,
        scale, n_split, part_stride, p_cap, min_shared);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = smem_bytes(D, Dv, sizeof(T));
  auto kern = kernel_for<T>(Dv);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv * n_hb, B, n_split);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const int*)table,
      (const int*)groups, meta, (const int*)q_pos, (T*)out, (float*)part, (int*)counters, nb,
      bs, P, H, Hkv, D, Dv, scale, n_split, split_slots, part_stride, n_hb, min_shared);
  return (int)cudaGetLastError();
}

}  // namespace paged

}  // namespace

extern "C" {

// Shared memory of one block of the dense split kernel (up to 16 query
// heads a block, whatever the group).
size_t decode_attention_split_smem_bytes(int D, int Dv, int is_bf16) {
  return split::smem_bytes(D, Dv, is_bf16 ? 2 : 4);
}

// Blocks of the dense split kernel that fit on one SM at this group and
// these head dims: the planner's budget of blocks a wave.
int decode_attention_split_blocks_per_sm(int group, int D, int Dv, int is_bf16) {
  return is_bf16 ? split::blocks_per_sm<__nv_bfloat16>(group, D, Dv)
                 : split::blocks_per_sm<float>(group, D, Dv);
}

// q (B,1,H,D), k/v (B,W,Hkv,D|Dv), pos (B,W) i32, q_pos (B,) i32 -> out (B,1,H,Dv).
// The slot axis is cut into n_split ranges of split_slots (a multiple of 32);
// part holds B*H*n_split*(Dv+2) floats (unused when n_split == 1), counters
// B*Hkv*n_hb ints that are 0 and are left 0. D and Dv rows are multiples of 16
// bytes, at most 1024 (the wrapper checks).
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                         const void* q_pos, void* out, void* part, void* counters, int B, int W,
                         int H, int Hkv, int D, int Dv, float scale, int has_window, int window,
                         int n_split, int split_slots, int n_hb, int is_bf16, void* stream) {
  if (is_bf16)
    return split::launch<__nv_bfloat16>(q, k, v, pos, q_pos, out, part, counters, B, W, H, Hkv,
                                        D, Dv, scale, has_window, window, n_split, split_slots,
                                        n_hb, stream);
  return split::launch<float>(q, k, v, pos, q_pos, out, part, counters, B, W, H, Hkv, D, Dv,
                              scale, has_window, window, n_split, split_slots, n_hb, stream);
}

// Shared memory of one block of the paged split kernel; the wrapper refuses
// shapes above the card's 227 KB per block.
size_t paged_decode_attention_smem_bytes(int D, int Dv, int is_bf16) {
  return paged::smem_bytes(D, Dv, is_bf16 ? 2 : 4);
}

// Blocks of the paged split kernel that fit on one SM at these head dims:
// the planner's budget of blocks a wave.
int paged_decode_attention_blocks_per_sm(int D, int Dv, int is_bf16) {
  return is_bf16 ? paged::blocks_per_sm<__nv_bfloat16>(D, Dv)
                 : paged::blocks_per_sm<float>(D, Dv);
}

// Shared memory of one block of the grouped path's prefix kernel at B rows.
size_t paged_decode_attention_prefix_smem_bytes(int D, int Dv, int is_bf16, int B) {
  return paged::prefix_smem_bytes(D, Dv, is_bf16 ? 2 : 4, B);
}

// Blocks of the prefix kernel that fit on one SM: its grid is one wave.
int paged_decode_attention_prefix_blocks_per_sm(int D, int Dv, int is_bf16, int B) {
  return is_bf16 ? paged::prefix_blocks_per_sm<__nv_bfloat16>(D, Dv, B)
                 : paged::prefix_blocks_per_sm<float>(D, Dv, B);
}

// q (B,1,H,D), pools (P,bs,Hkv,D|Dv), pos_pool (P,bs) i32, block_table (B,nb) i32,
// q_pos (B,) i32 -> out (B,1,H,Dv). The nb * bs logical slots of a table row
// are cut into n_split ranges of split_slots (a multiple of 32); part and
// counters as for decode_attention_fwd. D and Dv are multiples of 16, Dv at
// most 128, and q and the pools start on 16-byte boundaries (the wrapper
// checks). groups (B,2) i32 or null: with it, the grouped path (the prefix
// kernel on prefix_grid blocks, then the per-row kernel over the tails),
// taking a group of min_shared blocks or more; part then holds
// B*H*(n_split+p_cap)*(Dv+2) floats and one int more.
int paged_decode_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                               const void* pos_pool, const void* block_table,
                               const void* groups, const void* q_pos, void* out, void* part,
                               void* counters, int B, int nb, int bs, int P, int H, int Hkv,
                               int D, int Dv, float scale, int n_split, int split_slots,
                               int n_hb, int prefix_grid, int p_cap, int min_shared,
                               int is_bf16, void* stream) {
  if (is_bf16)
    return paged::launch<__nv_bfloat16>(q, k_pool, v_pool, pos_pool, block_table, groups, q_pos,
                                        out, part, counters, B, nb, bs, P, H, Hkv, D, Dv, scale,
                                        n_split, split_slots, n_hb, prefix_grid, p_cap,
                                        min_shared, stream);
  return paged::launch<float>(q, k_pool, v_pool, pos_pool, block_table, groups, q_pos, out,
                              part, counters, B, nb, bs, P, H, Hkv, D, Dv, scale, n_split,
                              split_slots, n_hb, prefix_grid, p_cap, min_shared, stream);
}

}  // extern "C"
