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
// (= b * H + h) and split s: acc at part + (r * n_split + s) * Dv, (m, l) at
// part_ml[r * n_split + s]. n_split <= TILE (plan_splits), so a head's
// factors fit a row of ``mf``; ``mf`` and ``lf`` hold HB x TILE floats, ``ls``
// HB. A split with no valid slot has m = NEG_INF, l = 0, acc = 0 and factor
// 0, so a row whose splits are all empty comes out 0.
template <typename T, int NT>
__device__ __forceinline__ void merge_splits(const float* part, const float2* part_ml,
                                             long long row0, int nh, int n_split, int Dv,
                                             T* __restrict__ out, float* mf, float* lf,
                                             float* ls) {
  const int tid = threadIdx.x;
  for (int i = tid; i < nh * n_split; i += NT) {
    const int gi = i / n_split, s = i - gi * n_split;
    const float2 ml = __ldcg(part_ml + (row0 + gi) * n_split + s);
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
    const float4* pa = reinterpret_cast<const float4*>(part + (row0 + gi) * n_split * Dv) + d4;
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

  merge_splits<T, THREADS>(part, part_ml, (long long)b * H + h0, nh, n_split, Dv, out, sm.ps,
                           reinterpret_cast<float*>(sm.kv), sm.l);
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

// Shared-memory row stride of n values: 16 bytes past the row, so that the
// eight rows an ldmatrix reads lie in distinct banks.
__host__ __device__ __forceinline__ int stride(int n, int elem) { return n * elem + 16; }

// Shared memory of a block: q (HB rows), the slots' pool rows of both
// buffers (2 x TILE ints), then the region of the two [K tile | V tile]
// buffers, which the merges reuse once the tiles are consumed.
__host__ __device__ __forceinline__ int region_bytes(int D, int Dv, int elem) {
  const int kv = 2 * TILE * (stride(D, elem) + stride(Dv, elem));
  // the block merge: every warp's acc (WARPS x HB x Dv), (m, l) of every
  // warp and head, the heads' factors, m and l; the split merge: HB x TILE
  // factors and l, HB sums
  const int blk = (int)sizeof(float) * (WARPS * HB * Dv + 2 * WARPS * HB + WARPS * HB + 2 * HB);
  const int spl = (int)sizeof(float) * (2 * HB * TILE + HB);
  const int merge = blk > spl ? blk : spl;
  return kv > merge ? kv : merge;
}

size_t smem_bytes(int D, int Dv, int elem) {
  return (size_t)HB * stride(D, elem) + sizeof(int) * 2 * TILE + region_bytes(D, Dv, elem);
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

// One token of each sequence against the pool blocks of its table row.
// Grid (Hkv x head batches, B, n_split) over the nb * bs logical slots of a
// row, cut by `plan_splits` into n_split ranges of split_slots. A block of
// four warps serves up to 16 query heads of one kv head: it copies a tile
// of 32 slots at a time, and warp w takes slots 8w .. 8w+7 of every tile,
// keeping its own online softmax state; the warps merge in shared memory at
// the end, and the block's partial joins the other splits' as in the dense
// kernel. part / counters as there; NV: n8 tiles of Dv a lane's
// accumulator holds (4, 8 or 16: Dv <= 32, 64, 128).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, 4)
    paged_decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                        const T* __restrict__ v_pool,
                                        const int* __restrict__ pos_pool,
                                        const int* __restrict__ table,
                                        const int* __restrict__ q_pos, T* __restrict__ out,
                                        float* part, int* counters, int nb, int bs, int P,
                                        int H, int Hkv, int D, int Dv, float scale,
                                        int n_split, int split_slots, int n_hb) {
  constexpr int E = (int)sizeof(T);
  constexpr int EPC = 16 / E;  // values in a 16-byte chunk
  const int g = H / Hkv;
  const int kvh = blockIdx.x / n_hb;
  const int hb = blockIdx.x - kvh * n_hb;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int h0 = kvh * g + hb * HB;  // this block's first query head
  const int nh = min(HB, g - hb * HB);
  const int s_begin = sp * split_slots;
  const int s_end = min(nb * bs, s_begin + split_slots);
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
  int* rows = reinterpret_cast<int*>(qs + HB * SK);            // 2 x TILE
  unsigned char* region = reinterpret_cast<unsigned char*>(rows + 2 * TILE);

  // the block's query heads; rows past nh stay zero
  for (int i = tid; i < HB * NCK; i += THREADS) {
    const int r = i / NCK, c = i - r * NCK;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < nh)
      u = *reinterpret_cast<const uint4*>(q + ((long long)b * H + h0 + r) * D + c * EPC);
    *reinterpret_cast<uint4*>(qs + r * SK + c * 16) = u;
  }

  // The pool rows of tile slots [t0, t0 + TILE) into buffer buf: one lane a
  // slot reads its table entry and its position; an entry outside [0, P), a
  // slot past the split and a masked position read as -1. Then the K and V
  // rows by cp.async, 16 bytes a thread; a slot at -1 is zero-filled and
  // nothing is read for it. (All threads: it synchronises the block between
  // the lookups and the copies.)
  auto issue = [&](int buf, int t0) {
    int* rb = rows + buf * TILE;
    if (tid < TILE) {
      const int j = t0 + tid;
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
      rb[tid] = row;
    }
    __syncthreads();
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

  if (n_tiles > 0) issue(0, s_begin);
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      issue(cur ^ 1, s_begin + (it + 1) * TILE);
      split::cp_async_wait<1>();
    } else {
      split::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = region + cur * buf_bytes;
    const unsigned char* vt = kt + TILE * SK;
    const int sl = warp * 8 + 2 * t4;  // this lane's two slots of the tile
    const bool ok0 = rows[cur * TILE + sl] >= 0, ok1 = rows[cur * TILE + sl + 1] >= 0;

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
    __syncthreads();  // buffer cur is free for tile it + 2
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
  if (n_split == 1) {
    for (int i = tid; i < nh * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += fw[r * WARPS + w] * accw[(w * HB + r) * Dv + d];
      out[(row0 + r) * Dv + d] = from_f32<T>(a / fmaxf(lb[r], 1e-20f));
    }
    return;
  }

  const long long n_rows = (long long)gridDim.y * H * n_split;  // B * H * n_split
  float2* part_ml = reinterpret_cast<float2*>(part + n_rows * Dv);
  for (int i = tid; i < nh * Dv; i += THREADS) {
    const int r = i / Dv, d = i - r * Dv;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += fw[r * WARPS + w] * accw[(w * HB + r) * Dv + d];
    part[((row0 + r) * n_split + sp) * Dv + d] = a;
  }
  for (int r = tid; r < nh; r += THREADS)
    part_ml[(row0 + r) * n_split + sp] = make_float2(mb[r], lb[r]);
  __threadfence();
  __syncthreads();
  int* counter = counters + ((long long)b * Hkv + kvh) * n_hb + hb;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  float* mf = reinterpret_cast<float*>(region);  // HB x TILE
  split::merge_splits<T, THREADS>(part, part_ml, row0, nh, n_split, Dv, out, mf,
                                  mf + HB * split::TILE, mf + 2 * HB * split::TILE);
  if (tid == 0) *counter = 0;
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, const int*, const int*, T*,
                        float*, int*, int, int, int, int, int, int, int, float, int, int, int);

template <typename T>
Kernel<T> kernel_for(int Dv) {
  if (Dv <= 32) return paged_decode_attention_split_kernel<T, 4>;
  if (Dv <= 64) return paged_decode_attention_split_kernel<T, 8>;
  return paged_decode_attention_split_kernel<T, 16>;
}

template <typename T>
int blocks_per_sm(int D, int Dv) {
  const size_t smem = smem_bytes(D, Dv, sizeof(T));
  auto kern = kernel_for<T>(Dv);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* table,
           const void* q_pos, void* out, void* part, void* counters, int B, int nb, int bs,
           int P, int H, int Hkv, int D, int Dv, float scale, int n_split, int split_slots,
           int n_hb, void* stream) {
  const size_t smem = smem_bytes(D, Dv, sizeof(T));
  auto kern = kernel_for<T>(Dv);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv * n_hb, B, n_split);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (const int*)table,
      (const int*)q_pos, (T*)out, (float*)part, (int*)counters, nb, bs, P, H, Hkv, D, Dv, scale,
      n_split, split_slots, n_hb);
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

// q (B,1,H,D), pools (P,bs,Hkv,D|Dv), pos_pool (P,bs) i32, block_table (B,nb) i32,
// q_pos (B,) i32 -> out (B,1,H,Dv). The nb * bs logical slots of a table row
// are cut into n_split ranges of split_slots (a multiple of 32); part and
// counters as for decode_attention_fwd. D and Dv are multiples of 16, Dv at
// most 128, and q and the pools start on 16-byte boundaries (the wrapper
// checks).
int paged_decode_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                               const void* pos_pool, const void* block_table,
                               const void* q_pos, void* out, void* part, void* counters, int B,
                               int nb, int bs, int P, int H, int Hkv, int D, int Dv, float scale,
                               int n_split, int split_slots, int n_hb, int is_bf16,
                               void* stream) {
  if (is_bf16)
    return paged::launch<__nv_bfloat16>(q, k_pool, v_pool, pos_pool, block_table, q_pos, out,
                                        part, counters, B, nb, bs, P, H, Hkv, D, Dv, scale,
                                        n_split, split_slots, n_hb, stream);
  return paged::launch<float>(q, k_pool, v_pool, pos_pool, block_table, q_pos, out, part,
                              counters, B, nb, bs, P, H, Hkv, D, Dv, scale, n_split,
                              split_slots, n_hb, stream);
}

}  // extern "C"
