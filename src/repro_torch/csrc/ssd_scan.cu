// Mamba-2 SSD intra-chunk kernel: for every (batch, chunk, head), with cs the
// cumulative sum of dA over the chunk's Q rows,
//   Y_diag[q, p] = sum_{s <= q} (C[q] . B[s]) * exp(cs[q] - cs[s]) * dt[s] * x[s, p]
//   state[p, n]  = sum_q B[q, n] * exp(cs[Q-1] - cs[q]) * dt[q] * x[q, p]
// x, B, C in bf16 or f32 (the model dtype), dt and cs f32; both outputs f32.
//
// Replaces the TPU kernel `ssd_chunk_pallas` (src/repro/kernels/ssd_scan/
// ssd_scan.py), called by the chunked scan of every Mamba layer's prefill
// (src/repro/models/ssm.py `ssd_chunked`). The inter-chunk recurrence stays
// outside, as in the reference.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores): operations. At mamba2-370m's serve shape (32 sequences x 32 heads,
// Q = 256, P = 64, N = 128) the causal half of the three contractions is
// about 17 GFLOP against about 140 MB of inputs and outputs.
//
// What the design does about it:
//  * The TPU kernel holds one whole Q x Q score tile per (head, chunk): at
//    Q = 256 that is 256 KB of f32, more than a block's 227 KB of shared
//    memory. Here a block owns 64 query rows (and up to 64 columns of P) and
//    walks the 64-wide key tiles s up to its diagonal, building each 64 x 64
//    score tile C . B^T in registers, masking and scaling it, and
//    contracting it with x into its Y rows at once; tiles above the
//    diagonal are never computed. Other blocks of the same launch own a
//    64 x 64 tile of the P x N chunk state, a contraction over all Q rows.
//    The heaviest row tiles are scheduled first.
//  * The decay is masked by select, never by a product: exp(cs[q] - cs[s])
//    above the diagonal may be inf, and inf * 0 is NaN.
//  * All arithmetic after the loads is f32 (scalar FMAs from shared memory,
//    4 x 4 outputs a thread, float4 operand loads), so bf16 and f32 inputs
//    both stay within the f32 tolerance of the plain version: the products
//    of bf16 inputs are exact in f32, and no score is rounded to bf16.
//  * The model layout is read through strides (batch, chunk, row, head):
//    B and C may broadcast their groups over the heads with a stride-0 head
//    axis and x may be a slice of the conv output; nothing is copied.
// Simple first: no tensor cores (mma.sync / wgmma for C . B^T), no cp.async
// or TMA, and the C rows are read again for each key tile. Later work.
#include <cstdint>

#include "common.cuh"

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

}  // extern "C"
