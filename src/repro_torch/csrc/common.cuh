// Shared helpers for the attention kernels: element loads to f32, stores from
// f32, and the masked-row guard constants of the online softmax.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Scores of masked slots; a running max at or below NEG_INF / 2 means "no
// valid slot seen yet" (the guard of the TPU kernels, ported as is).
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One online-softmax update for a row whose new tile max is ``m_cur``:
// returns the new running max and writes the rescale factor of the old state.
// ``m_safe`` (0 for a row with nothing valid yet) is the exponent shift.
__device__ __forceinline__ void online_update(float m_prev, float m_cur, float* m_new,
                                              float* m_safe, float* alpha) {
  float m = fmaxf(m_prev, m_cur);
  float ms = (m <= NEG_INF * 0.5f) ? 0.f : m;
  *m_new = m;
  *m_safe = ms;
  *alpha = (m_prev <= NEG_INF * 0.5f) ? 0.f : expf(m_prev - ms);
}

}  // namespace repro
