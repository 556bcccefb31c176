// Mamba-2 SSD intra-chunk kernels: for every (batch, chunk, head), with cs
// the cumulative sum of dA over the chunk's Q rows,
//   Y_diag[q, p] = sum_{s <= q} (C[q] . B[s]) * exp(cs[q] - cs[s]) * dt[s] * x[s, p]
//   state[p, n]  = sum_q B[q, n] * exp(cs[Q-1] - cs[q]) * dt[q] * x[q, p]
// x, B, C in bf16 or f32 (the model dtype), dt and cs f32; both outputs f32.
//
// Replaces the TPU kernel `ssd_chunk_pallas` (src/repro/kernels/ssd_scan/
// ssd_scan.py), called by the chunked scan of every Mamba layer's prefill
// (src/repro/models/ssm.py `ssd_chunked`). The inter-chunk recurrence stays
// outside, as in the reference. The wrapper's planner
// (kernels/ssd_scan/plan.py) picks one of two kernels before the launch.
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 outside them): bytes, once the contractions run on
// the tensor cores. At mamba2-370m's serve shape (32 sequences x 32 heads,
// Q = 256, P = 64, N = 128) the causal half of the three contractions is
// about 17 GFLOP against about 140 MB of inputs and outputs, most of it the
// f32 outputs.
//
// Both kernels:
//  * mask the decay by select, never by a product: exp(cs[q] - cs[s]) above
//    the diagonal may be inf, and inf * 0 is NaN. The decay is never
//    factored as exp(cs[q]) * exp(-cs[s]): cs falls to about -3000 at
//    jamba's rates, where that product overflows;
//  * read the model layout through strides (batch, chunk, row, head): B and
//    C may broadcast their groups over the heads with a stride-0 head axis
//    and x may be a slice of the conv output; nothing is copied;
//  * never compute the score tiles above the diagonal, and schedule the
//    heaviest row tiles first.
//
// `ssd_scan_chunk_tc_kernel` (bf16; Q a multiple of 64 up to 256, P and N
// multiples of 16 up to 64 and 128, 16-byte aligned rows):
//  * A Y block owns (batch * chunk, 64 query rows, a block of up to 16
//    heads that read one B and C). The heads of a group share their B and C
//    (a stride-0 head axis: every head of mamba2 and jamba), so C . B^T is
//    the same matrix for all of them: the block stages its C rows and the
//    causal key rows of B once by cp.async and builds the raw causal scores
//    C . B^T once, by mma.sync m16n8k16 (products of bf16 values are exact
//    in f32, f32 accumulators). Each of its sixteen warps keeps its part in
//    registers: 16 query rows x one 16-key quarter of every 64-key tile.
//  * Then, for each head, a score is raw[q, s] * exp(cs[q] - cs[s]) * dt[s]
//    in f32 (exp by ex2.approx, about 1e-6 relative where a term matters),
//    split into a bf16 high part and a bf16 low part (score = hi + lo to
//    about 2^-17), and both parts multiply the head's x key rows (bf16,
//    exact) on the tensor cores into f32 Y accumulators, straight from the
//    score registers (the accumulator layout of two n8 tiles is the A
//    operand of one k16 step). A single bf16 rounding, or TF32, would not
//    hold the f32 tolerance. The four warps of a row group sum their key
//    quarters through shared memory (the C and B rows' space, free once the
//    raw scores are built) in a fixed order, so a call's bits repeat. The
//    next head's x rows are in flight (cp.async) while a head computes; cs
//    and dt of all the block's heads are staged once, with the C and B rows.
//  * The chunk state: one more block of each head block computes state[p,
//    n] over all Q rows, with x * w (w = exp(cs[Q-1] - cs[q]) * dt[q]) split
//    into bf16 hi + lo as the A operand and B through ldmatrix.trans.
//  * One block of 16 warps fills an SM (about 190 KB of shared memory at Q
//    = 256): every phase of a head (copies, exp, tensor cores, exchange,
//    stores) waits on the one before it, and that latency, not the bytes,
//    sets its time at the serve shapes (PERF.md).
//
// `ssd_scan_chunk_kernel` (f32, and bf16 shapes the other does not take):
//  * A block owns 64 query rows (and up to 64 columns of P) of one head and
//    walks the 64-wide key tiles up to its diagonal, building each 64 x 64
//    score tile C . B^T in registers, masking and scaling it, and
//    contracting it with x into its Y rows at once. Other blocks of the same
//    launch own a 64 x 64 tile of the P x N chunk state.
//  * All arithmetic after the loads is f32 scalar FMAs from shared memory
//    (4 x 4 outputs a thread, float4 operand loads); the C rows are read
//    again for each key tile and for each head.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int TQ = 64;  // query rows per Y block, key rows per score tile
constexpr int TP = 64;  // columns of P per Y block; rows of P per state block
constexpr int TN = 64;  // columns of N per state block
constexpr int KT = 16;  // contraction rows staged per step
constexpr int LD = 68;  // shared row stride in floats: rows stay 16 B aligned
constexpr int THREADS = 256;

struct Args {
  const void* x;
  const float* dt;  // (batch, nc, Q, H) contiguous
  const float* cs;  // (batch, nc, Q, H) contiguous
  const void* b;
  const void* c;
  float* y;   // (batch, nc, Q, H, P) contiguous
  float* st;  // (batch, nc, H, P, N) contiguous
  int nc, Q, H, P, N;
  long long xs[4], bs[4], cstr[4];  // element strides: batch, chunk, row, head
};

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_chunk_kernel(const Args a) {
  __shared__ __align__(16) float sa[KT][LD];  // Y: C^T (n, q); state: (x * w) (q, p)
  __shared__ __align__(16) float sb[KT][LD];  // Y: B^T (n, s); state: B (q, n)
  __shared__ __align__(16) float ss[TQ][LD];  // Y: masked scores, (s, q)
  __shared__ __align__(16) float sx[TQ][LD];  // Y: x (s, p)
  __shared__ float cs_q[TQ], cs_s[TQ], dt_s[TQ], w_s[KT];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int bi = bc / a.nc, ci = bc % a.nc;
  const int Q = a.Q, H = a.H, P = a.P, N = a.N;
  const T* x = static_cast<const T*>(a.x) + bi * a.xs[0] + ci * a.xs[1] + h * a.xs[3];
  const T* Bm = static_cast<const T*>(a.b) + bi * a.bs[0] + ci * a.bs[1] + h * a.bs[3];
  const T* Cm = static_cast<const T*>(a.c) + bi * a.cstr[0] + ci * a.cstr[1] + h * a.cstr[3];
  const long long xr = a.xs[2], br = a.bs[2], cr = a.cstr[2];
  // row q of dt / cs for this (batch, chunk, head)
  const float* dt = a.dt + (long long)bc * Q * H + h;
  const float* cs = a.cs + (long long)bc * Q * H + h;

  const int nqt = (Q + TQ - 1) / TQ, npt = (P + TP - 1) / TP;
  const int role = blockIdx.x;
  float acc[4][4];

  if (role < nqt * npt) {
    // ---------------------------------------------------------- Y_diag rows
    const int qt = nqt - 1 - role / npt;  // the longest walks first
    const int q0 = qt * TQ, p0 = (role % npt) * TP;
    for (int i = tid; i < TQ; i += THREADS)
      cs_q[i] = q0 + i < Q ? cs[(long long)(q0 + i) * H] : 0.f;
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;

    for (int st = 0; st <= qt; ++st) {
      const int s0 = st * TQ;
      __syncthreads();  // the previous tile's scores and x are consumed
      for (int i = tid; i < TQ; i += THREADS) {
        const bool ok = s0 + i < Q;
        cs_s[i] = ok ? cs[(long long)(s0 + i) * H] : 0.f;
        dt_s[i] = ok ? dt[(long long)(s0 + i) * H] : 0.f;
      }
      for (int e = tid; e < TQ * TP; e += THREADS) {
        const int s = e / TP, p = e % TP;
        sx[s][p] = (s0 + s < Q && p0 + p < P) ? to_f32(x[(s0 + s) * xr + p0 + p]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // scores[q, s] = C[q] . B[s], over N in steps of KT
      for (int n0 = 0; n0 < N; n0 += KT) {
        __syncthreads();  // the previous step's operands are consumed
        for (int e = tid; e < TQ * KT; e += THREADS) {
          const int r = e / KT, k = e % KT;
          const bool kin = n0 + k < N;
          sa[k][r] = (kin && q0 + r < Q) ? to_f32(Cm[(q0 + r) * cr + n0 + k]) : 0.f;
          sb[k][r] = (kin && s0 + r < Q) ? to_f32(Bm[(s0 + r) * br + n0 + k]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KT; ++k) fma4x4(acc, ld4(&sa[k][ty * 4]), ld4(&sb[k][tx * 4]));
      }
      // masked decay (select, not product) and dt; stored as (s, q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = tx * 4 + j, s = s0 + sl;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = ty * 4 + i, q = q0 + ql;
          const float decay = expf(cs_q[ql] - cs_s[sl]);
          v[i] = (s <= q && s < Q) ? acc[i][j] * decay * dt_s[sl] : 0.f;
        }
        *reinterpret_cast<float4*>(&ss[sl][ty * 4]) = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      // Y[q, p] += scores[q, s] x[s, p]
      const int s_end = min(TQ, Q - s0);
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) fma4x4(yacc, ld4(&ss[s][ty * 4]), ld4(&sx[s][tx * 4]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
      if (q >= Q) continue;
      float* yr = a.y + (((long long)bc * Q + q) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx * 4 + j;
        if (p < P) yr[p] = yacc[i][j];
      }
    }
    return;
  }

  // ------------------------------------------------------------ chunk state
  const int nnt = (N + TN - 1) / TN;
  const int r = role - nqt * npt;
  const int p0 = (r / nnt) * TP, n0 = (r % nnt) * TN;
  const float cs_last = cs[(long long)(Q - 1) * H];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Q; k0 += KT) {
    __syncthreads();  // the previous step's operands are consumed
    if (tid < KT) {
      const int q = k0 + tid;
      w_s[tid] = q < Q ? expf(cs_last - cs[(long long)q * H]) * dt[(long long)q * H] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < KT * TP; e += THREADS) {
      const int k = e / TP, c = e % TP;
      const int q = k0 + k;
      sa[k][c] = (q < Q && p0 + c < P) ? to_f32(x[q * xr + p0 + c]) * w_s[k] : 0.f;
      sb[k][c] = (q < Q && n0 + c < N) ? to_f32(Bm[q * br + n0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KT; ++k) fma4x4(acc, ld4(&sa[k][ty * 4]), ld4(&sb[k][tx * 4]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
    float* sr = a.st + (((long long)bc * H + h) * P + p) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) sr[n] = acc[i][j];
    }
  }
}

// ------------------------------------------------- tensor cores (bf16 only)

namespace tc {

constexpr int THREADS = 512;  // sixteen warps
constexpr int TQ = 64;        // query rows of a Y block; key rows of a key tile
constexpr int MAX_KT = 4;     // key tiles of a chunk: Q <= 256
constexpr int MAX_PT = 4;     // 16-column tiles of P: P <= 64
constexpr int MAX_N = 128;    // N <= 128
// the exchange of the Y partial sums: 16 warps x 8 n8 tiles x 32 lanes, float4
constexpr int EX_BYTES = 16 * 2 * MAX_PT * 32 * 16;
constexpr int NBUF = 2;  // x buffers: the next head's rows in flight while one computes
constexpr int MAX_HB = 16;  // heads a block: their cs and dt stay in shared memory

struct Args {
  const __nv_bfloat16* x;
  const float* dt;  // (batch, nc, Q, H) contiguous
  const float* cs;  // (batch, nc, Q, H) contiguous
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  float* y;   // (batch, nc, Q, H, P) contiguous
  float* st;  // (batch, nc, H, P, N) contiguous
  int nc, Q, H, P, N;
  int hb;  // heads a block: consecutive heads that read one B and C
  long long xs[4], bs[4], cstr[4];  // element strides: batch, chunk, row, head
};

// Shared row stride of n bf16 values in bytes: 16 past the row (an odd
// number of 16-byte units), so that the eight rows an ldmatrix reads lie in
// distinct banks.
__host__ __device__ __forceinline__ int row_bytes(int n) { return 2 * n + 16; }

// Byte offsets in shared memory: the block's C rows and the B rows, which a
// Y block's exchange of partial sums reuses once its raw scores are built;
// NBUF x buffers (this head's and the next one's); cs and dt of the block's
// hb heads, one row of Q a head; the state weights w.
struct Layout {
  int c, b, ex, x, cs, dt, w, total;
};

__host__ __device__ __forceinline__ Layout layout(int Q, int P, int N, int hb) {
  Layout l;
  l.c = 0;
  l.b = l.c + TQ * row_bytes(N);
  l.ex = 0;
  const int cb = (TQ + Q) * row_bytes(N);
  l.x = cb > EX_BYTES ? cb : EX_BYTES;
  l.cs = l.x + NBUF * Q * row_bytes(P);
  l.dt = l.cs + hb * Q * 4;
  l.w = l.dt + hb * Q * 4;
  l.total = l.w + Q * 4;
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16) . (b0, b1) (16 x 8), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) as a bf16 pair, and what rounding left of each as another
__device__ __forceinline__ uint32_t split_pair(float lo, float hi, uint32_t* rest) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo - hf.x, hi - hf.y);
  *rest = *reinterpret_cast<const uint32_t*>(&r);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// rows [0, rows) of a bf16 matrix of `width` columns and row stride `rs`
// (elements) into shared rows of `sbytes`, 16 bytes a cp.async
__device__ __forceinline__ void stage(unsigned char* dst, const __nv_bfloat16* src, long long rs,
                                      int rows, int width, int sbytes) {
  const int cpr = width >> 3;
  for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, k = e - r * cpr;
    cp_async16(dst + r * sbytes + k * 16, src + r * rs + k * 8);
  }
}

// head h's x rows [0, rows) into buffer `buf`, as one cp.async group (an
// empty group past the block's last head, so that every iteration commits
// one)
__device__ __forceinline__ void stage_head(const Args& a, unsigned char* sm, const Layout& L,
                                           int buf, int h, int h1, int rows,
                                           const __nv_bfloat16* xg) {
  if (h < h1)
    stage(sm + L.x + buf * a.Q * row_bytes(a.P), xg + h * a.xs[3], a.xs[2], rows, a.P,
          row_bytes(a.P));
  cp_async_commit();
}

// The raw causal scores C . B^T of a warp's 16 query rows (16 wq ..) against
// its 16-key quarter (16 wk ..) of every key tile up to the diagonal tile
// qt, in the mma accumulator layout: raw[kt][j] is the n8 tile of keys
// 64 kt + 16 wk + 8 j .. + 7. C as A (ldmatrix), the B rows as B.
__device__ __forceinline__ void raw_scores(float (&raw)[MAX_KT][2][4], const unsigned char* sc,
                                           const unsigned char* sb, int N, int qt, int wq,
                                           int wk, int lane, bool skip_diag) {
  const int SN = row_bytes(N);
  const unsigned ca = smem_u32(sc + (16 * wq + (lane & 15)) * SN + (lane >> 4) * 16);
  const unsigned ba =
      smem_u32(sb + (16 * wk + (lane & 7) + ((lane >> 4) << 3)) * SN + ((lane >> 3) & 1) * 16);
  for (int k = 0; k < N / 16; ++k) {
    uint32_t af[4];
    ldmatrix_x4(af, ca + 32 * k);
#pragma unroll
    for (int kt = 0; kt < MAX_KT; ++kt) {
      if (kt > qt || (kt == qt && skip_diag)) continue;
      uint32_t bf[4];
      ldmatrix_x4(bf, ba + kt * TQ * SN + 32 * k);
      mma_k16(raw[kt][0], af, bf[0], bf[1]);
      mma_k16(raw[kt][1], af, bf[2], bf[3]);
    }
  }
}

// Y rows 64 qt .. 64 qt + 63 of head h: the masked, decayed scores as bf16
// hi + lo times x on the tensor cores; the four key quarters of a row group
// summed through shared memory in a fixed order (one __syncthreads) and
// written in f32.
__device__ __forceinline__ void y_rows(const Args& a, const float (&raw)[MAX_KT][2][4],
                                       const unsigned char* xs, const float* scs,
                                       const float* sdt, float4* ex, int bc, int h, int qt,
                                       int wq, int wk, int lane, bool skip_diag) {
  const int g = lane >> 2, t = lane & 3, SP = row_bytes(a.P);
  const int np = a.P >> 3;  // n8 tiles of P; warp wk writes the tiles j with j % 4 == wk
  const int qa = qt * TQ + 16 * wq + g, qb = qa + 8;
  const float csa = scs[qa], csb = scs[qb];
  float acc[2 * MAX_PT][4];
#pragma unroll
  for (int j = 0; j < 2 * MAX_PT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  const unsigned xa =
      smem_u32(xs + (16 * wk + (lane & 7) + ((lane >> 3) & 1) * 8) * SP + (lane >> 4) * 16);
#pragma unroll
  for (int kt = 0; kt < MAX_KT; ++kt) {
    if (kt > qt || (kt == qt && skip_diag)) continue;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = kt * TQ + 16 * wk + 8 * j + 2 * t;
      const float2 c2 = *reinterpret_cast<const float2*>(scs + s);
      const float2 d2 = *reinterpret_cast<const float2*>(sdt + s);
      float v0 = raw[kt][j][0] * __expf(csa - c2.x) * d2.x;
      float v1 = raw[kt][j][1] * __expf(csa - c2.y) * d2.y;
      float v2 = raw[kt][j][2] * __expf(csb - c2.x) * d2.x;
      float v3 = raw[kt][j][3] * __expf(csb - c2.y) * d2.y;
      if (kt == qt) {  // the diagonal tile: select, never a product
        v0 = s <= qa ? v0 : 0.f;
        v1 = s + 1 <= qa ? v1 : 0.f;
        v2 = s <= qb ? v2 : 0.f;
        v3 = s + 1 <= qb ? v3 : 0.f;
      }
      hi[2 * j] = split_pair(v0, v1, &lo[2 * j]);
      hi[2 * j + 1] = split_pair(v2, v3, &lo[2 * j + 1]);
    }
    const unsigned xk = xa + kt * TQ * SP;
#pragma unroll
    for (int pt = 0; pt < MAX_PT; ++pt) {
      if (16 * pt >= a.P) continue;
      uint32_t b[4];
      ldmatrix_x4_trans(b, xk + 32 * pt);
      mma_k16(acc[2 * pt], hi, b[0], b[1]);
      mma_k16(acc[2 * pt], lo, b[0], b[1]);
      mma_k16(acc[2 * pt + 1], hi, b[2], b[3]);
      mma_k16(acc[2 * pt + 1], lo, b[2], b[3]);
    }
  }
  // every thread of the row group's four warps holds the same elements: each
  // hands the tiles it does not write to their writer
#pragma unroll
  for (int j = 0; j < 2 * MAX_PT; ++j) {
    if (j >= np || (j & 3) == wk) continue;
    ex[((wk * 4 + wq) * 2 * MAX_PT + j) * 32 + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  float* ya = a.y + (((long long)bc * a.Q + qa) * a.H + h) * a.P;
  float* yb = ya + 8LL * a.H * a.P;
#pragma unroll
  for (int j = 0; j < 2 * MAX_PT; ++j) {
    if (j >= np || (j & 3) != wk) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // key quarters in order: the bits repeat
      const float4 o = w == wk ? make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3])
                               : ex[((w * 4 + wq) * 2 * MAX_PT + j) * 32 + lane];
      s.x += o.x;
      s.y += o.y;
      s.z += o.z;
      s.w += o.w;
    }
    *reinterpret_cast<float2*>(ya + 8 * j + 2 * t) = make_float2(s.x, s.y);
    *reinterpret_cast<float2*>(yb + 8 * j + 2 * t) = make_float2(s.z, s.w);
  }
}

// state[p, :] of head h over all Q rows: x * w split into bf16 hi + lo as A
// (x through ldmatrix.trans), the B rows as B (ldmatrix.trans). Warp
// (wp, wn) owns rows 16 wp .. of P and the 16-column groups wn, wn + 4 of N.
__device__ __forceinline__ void state_cols(const Args& a, const unsigned char* xs,
                                           const unsigned char* sb, const float* sw, int bc,
                                           int h, int warp, int lane) {
  const int wp = warp & 3, wn = warp >> 2;
  const int ng = a.N >> 4;
  if (16 * wp >= a.P || wn >= ng) return;
  const int g = lane >> 2, t = lane & 3, SP = row_bytes(a.P), SN = row_bytes(a.N);
  float acc[2][2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][n][r] = 0.f;
  const unsigned xa =
      smem_u32(xs + ((lane & 7) + ((lane >> 4) << 3)) * SP + (16 * wp + ((lane >> 3) & 1) * 8) * 2);
  const unsigned ba = smem_u32(sb + ((lane & 7) + ((lane >> 3) & 1) * 8) * SN + (lane >> 4) * 16);
  for (int k = 0; k < a.Q / 16; ++k) {
    uint32_t xf[4], hi[4], lo[4];
    ldmatrix_x4_trans(xf, xa + 16 * k * SP);  // (p g | g + 8, q 2t | 2t + 8 of the step)
    const float2 w0 = *reinterpret_cast<const float2*>(sw + 16 * k + 2 * t);
    const float2 w1 = *reinterpret_cast<const float2*>(sw + 16 * k + 2 * t + 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 v = unpack(xf[r]);
      const float2 w = r < 2 ? w0 : w1;
      hi[r] = split_pair(v.x * w.x, v.y * w.y, &lo[r]);
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = wn + 4 * cc;
      if (c >= ng) continue;
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, ba + 16 * k * SN + 32 * c);
      mma_k16(acc[cc][0], hi, bf[0], bf[1]);
      mma_k16(acc[cc][0], lo, bf[0], bf[1]);
      mma_k16(acc[cc][1], hi, bf[2], bf[3]);
      mma_k16(acc[cc][1], lo, bf[2], bf[3]);
    }
  }
  float* sp = a.st + (((long long)bc * a.H + h) * a.P + 16 * wp + g) * a.N;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int c = wn + 4 * cc;
    if (c >= ng) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = 16 * c + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(sp + n) = make_float2(acc[cc][nt][0], acc[cc][nt][1]);
      *reinterpret_cast<float2*>(sp + 8LL * a.N + n) = make_float2(acc[cc][nt][2], acc[cc][nt][3]);
    }
  }
}

// Grid (1 + Q / 64 roles, head blocks, batch * nc). Role 0: the state block
// (the heaviest); role r > 0: the Y block of query tile Q / 64 - r, the
// longest walks first.
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_chunk_tc_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int Q = a.Q, H = a.H, N = a.N;
  const Layout L = layout(Q, a.P, N, a.hb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bc = blockIdx.z, bi = bc / a.nc, ci = bc - bi * a.nc;
  const int h0 = blockIdx.y * a.hb, h1 = min(H, h0 + a.hb);
  const bool y_block = blockIdx.x > 0;
  const int qt = Q / TQ - (int)blockIdx.x;
  const int rows = y_block ? TQ * (qt + 1) : Q;  // rows of B and of x staged
  const __nv_bfloat16* xg = a.x + bi * a.xs[0] + ci * a.xs[1];
  const __nv_bfloat16* bg = a.b + bi * a.bs[0] + ci * a.bs[1] + h0 * a.bs[3];
  const __nv_bfloat16* cg = a.c + bi * a.cstr[0] + ci * a.cstr[1] + h0 * a.cstr[3];
  const float* csg = a.cs + (long long)bc * Q * H;
  const float* dtg = a.dt + (long long)bc * Q * H;

  if (y_block) stage(sm + L.c, cg + (long long)qt * TQ * a.cstr[2], a.cstr[2], TQ, N, row_bytes(N));
  stage(sm + L.b, bg, a.bs[2], rows, N, row_bytes(N));
  // cs and dt of the block's heads, [head][row]: a row's heads are adjacent
  // in device memory, so a warp's 4-byte copies share their sectors
  const int nh = h1 - h0;
  float* cs_all = reinterpret_cast<float*>(sm + L.cs);
  float* dt_all = reinterpret_cast<float*>(sm + L.dt);
  for (int e = tid; e < rows * nh; e += THREADS) {
    const int q = e / nh, j = e - q * nh;
    cp_async4(cs_all + j * Q + q, csg + (long long)q * H + h0 + j);
    cp_async4(dt_all + j * Q + q, dtg + (long long)q * H + h0 + j);
  }
  cp_async_commit();
  for (int i = 0; i < NBUF - 1; ++i) stage_head(a, sm, L, i, h0 + i, h1, rows, xg);

  const int wq = warp & 3, wk = warp >> 2;
  const bool skip_diag = wk > wq;  // the warp's keys of the diagonal tile lie above its rows
  float raw[MAX_KT][2][4];
#pragma unroll
  for (int kt = 0; kt < MAX_KT; ++kt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) raw[kt][j][r] = 0.f;
  if (y_block) {
    cp_async_wait<NBUF - 1>();  // C, B, cs and dt; the first heads' x may still be in flight
    __syncthreads();
    raw_scores(raw, sm + L.c, sm + L.b, N, qt, wq, wk, lane, skip_diag);
  }
  float* sw = reinterpret_cast<float*>(sm + L.w);
  float4* ex = reinterpret_cast<float4*>(sm + L.ex);
  for (int h = h0, buf = 0; h < h1; ++h, buf = buf == NBUF - 1 ? 0 : buf + 1) {
    cp_async_wait<NBUF - 2>();
    // head h landed; every warp is done with head h - 1's buffers (and, in
    // a Y block, with the C and B rows the exchange reuses)
    __syncthreads();
    stage_head(a, sm, L, (buf + NBUF - 1) % NBUF, h + NBUF - 1, h1, rows, xg);
    const unsigned char* xs = sm + L.x + buf * Q * row_bytes(a.P);
    const float* scs = cs_all + (h - h0) * Q;
    const float* sdt = dt_all + (h - h0) * Q;
    if (y_block) {
      y_rows(a, raw, xs, scs, sdt, ex, bc, h, qt, wq, wk, lane, skip_diag);
    } else {
      const float last = scs[Q - 1];
      for (int q = tid; q < Q; q += THREADS) sw[q] = expf(last - scs[q]) * sdt[q];
      __syncthreads();
      state_cols(a, xs, sm + L.b, sw, bc, h, warp, lane);
    }
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// x, b, c: bf16 (is_bf16) or f32, read through the element strides given
// (batch, chunk, row, head; the last axis contiguous); dt, cs: f32
// (batch, nc, Q, H) contiguous. y (batch, nc, Q, H, P) and st
// (batch, nc, H, P, N) f32, written in full. Returns cudaGetLastError().
int ssd_scan_fwd(const void* x, const void* dt, const void* cs, const void* b, const void* c,
                 void* y, void* st, int batch, int nc, int Q, int H, int P, int N,
                 long long xs0, long long xs1, long long xs2, long long xs3, long long bs0,
                 long long bs1, long long bs2, long long bs3, long long cs0, long long cs1,
                 long long cs2, long long cs3, int is_bf16, void* stream) {
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.cs = static_cast<const float*>(cs);
  a.b = b;
  a.c = c;
  a.y = static_cast<float*>(y);
  a.st = static_cast<float*>(st);
  a.nc = nc;
  a.Q = Q;
  a.H = H;
  a.P = P;
  a.N = N;
  const long long xs[4] = {xs0, xs1, xs2, xs3}, bs[4] = {bs0, bs1, bs2, bs3},
                  cstr[4] = {cs0, cs1, cs2, cs3};
  for (int i = 0; i < 4; ++i) {
    a.xs[i] = xs[i];
    a.bs[i] = bs[i];
    a.cstr[i] = cstr[i];
  }
  const int nqt = (Q + TQ - 1) / TQ, npt = (P + TP - 1) / TP, nnt = (N + TN - 1) / TN;
  const dim3 grid(nqt * npt + npt * nnt, H, batch * nc);
  if (is_bf16)
    ssd_scan_chunk_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    ssd_scan_chunk_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The tensor-core kernel: bf16 x, b, c as for ssd_scan_fwd, with Q a
// multiple of 64 up to 256, P a multiple of 16 up to 64, N a multiple of 16
// up to 128, and 16-byte aligned base pointers and strides; `hb` heads a
// block (1 unless b and c have a stride-0 head axis). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take.
int ssd_scan_tc_fwd(const void* x, const void* dt, const void* cs, const void* b, const void* c,
                    void* y, void* st, int batch, int nc, int Q, int H, int P, int N,
                    long long xs0, long long xs1, long long xs2, long long xs3, long long bs0,
                    long long bs1, long long bs2, long long bs3, long long cs0, long long cs1,
                    long long cs2, long long cs3, int hb, void* stream) {
  if (Q < tc::TQ || Q % tc::TQ || Q > tc::TQ * tc::MAX_KT || P < 16 || P % 16 ||
      P > 16 * tc::MAX_PT || N < 16 || N % 16 || N > tc::MAX_N || hb < 1 || hb > tc::MAX_HB ||
      ((bs3 || cs3) && hb != 1))
    return (int)cudaErrorInvalidValue;
  tc::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.cs = static_cast<const float*>(cs);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.c = static_cast<const __nv_bfloat16*>(c);
  a.y = static_cast<float*>(y);
  a.st = static_cast<float*>(st);
  a.nc = nc;
  a.Q = Q;
  a.H = H;
  a.P = P;
  a.N = N;
  a.hb = hb;
  const long long xs[4] = {xs0, xs1, xs2, xs3}, bs[4] = {bs0, bs1, bs2, bs3},
                  cstr[4] = {cs0, cs1, cs2, cs3};
  for (int i = 0; i < 4; ++i) {
    a.xs[i] = xs[i];
    a.bs[i] = bs[i];
    a.cstr[i] = cstr[i];
  }
  const int smem = tc::layout(Q, P, N, hb).total;
  cudaError_t err = cudaFuncSetAttribute(tc::ssd_scan_chunk_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(1 + Q / tc::TQ, (H + hb - 1) / hb, batch * nc);
  tc::ssd_scan_chunk_tc_kernel<<<grid, tc::THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
