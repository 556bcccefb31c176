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
// Paged pool (`decode_attention_kernel<T, true>`, the first port's kernel,
// unchanged; its `PAGED = false` instantiation, the old dense path, is no
// longer built; its redesign is later work):
//  * One block per (kv head, sequence) serves all `group` query heads of that
//    kv head from one read of each K/V tile.
//  * The TPU's sequential kv grid axis becomes a loop inside the block over
//    tiles of 32 slots (one slot per lane), the running (m, l, acc) state
//    kept in shared memory.
//  * The ragged tail (W not a multiple of the tile) is masked in the kernel;
//    nothing is padded or copied. Slots that are masked are never loaded.
//  * Each block reads its own row of `block_table` and addresses the pool
//    blocks directly; the pool is never gathered into a dense copy. A table
//    entry outside [0, n_blocks) reads as an empty block, so a bad table
//    cannot send a load outside the pool.
//  * A row with no valid slot comes out 0, through the same m_safe / alpha /
//    max(l, 1e-20) guard as the TPU kernel.
#include <cstdint>

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

  // The last block merges every split's partial into the output: first the
  // (m, l) of every (head, split), all loads in flight together; then each
  // head's factors exp(m_i - m_safe) and l; then the acc rows, four columns a
  // thread. n_split <= TILE (plan_splits), so a head's factors fit a row of ps.
  float* mf = sm.ps;                                // HB x TILE: m, then the factors
  float* lf = reinterpret_cast<float*>(sm.kv);      // HB x TILE: l (the K/V buffers are free)
  for (int i = tid; i < nh * n_split; i += THREADS) {
    const int gi = i / n_split, s = i - gi * n_split;
    const float2 ml = __ldcg(part_ml + ((long long)b * H + h0 + gi) * n_split + s);
    mf[gi * TILE + s] = ml.x;
    lf[gi * TILE + s] = ml.y;
  }
  __syncthreads();
  for (int gi = tid; gi < nh; gi += THREADS) {
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
    sm.l[gi] = fmaxf(l_sum, 1e-20f);
  }
  __syncthreads();
  const int nq = Dv / 4;
  for (int i = tid; i < nh * nq; i += THREADS) {
    const int gi = i / nq, d4 = i - gi * nq;
    const float4* pa = reinterpret_cast<const float4*>(
                           part + ((long long)b * H + h0 + gi) * n_split * Dv) + d4;
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
    const float l = sm.l[gi];
    T* o = out + ((long long)b * H + h0 + gi) * Dv + 4 * d4;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f32<T>(a[e] / l);
  }
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

}  // namespace

extern "C" {

// Shared memory one block of the paged kernel needs; the wrappers refuse
// shapes above the card's 227 KB per block.
size_t decode_attention_smem_bytes(int group, int D, int Dv) { return smem_bytes(group, D, Dv); }

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
