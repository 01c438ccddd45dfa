// The pieces the decode and ragged kernels share: the key tile and the
// warp reductions (kernel 3, flash_decode_attention_plane.cu), and the
// rope, the new rows' quantizer and the soft cap of the split-KV decode
// body (kernels 2, 4 and 5, split_kv_layer.cuh) and of the ragged prefill
// kernel's appends (kernel 6, ragged_prefill_attention.cu).
//
// Every multiply-add is spelled with an explicit rounding intrinsic, so the
// compiler cannot contract it differently from one build to the next.  The
// rope and the quantizer are what the cache's writers must agree on bit for
// bit: a verify burst appends the same cache bytes and scales as T decode
// steps, and either appends the plain version's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace decode_tile {

constexpr int BS = 64;                      // keys per tile
constexpr float NEG_INF = -0.7f * FLT_MAX;  // ops/attention.py _NEG_INF

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Rotate-half rope of one element pair (x1 = x[dd], x2 = x[dd + D/2]) in
// fp32: x1*cos - x2*sin, x2*cos + x1*sin, each op rounded once (no FMA can
// move a value that the quantizer then rounds).
__device__ __forceinline__ float2 rope_f32(float x1, float x2, float sn,
                                           float cs) {
  return make_float2(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)),
                     __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn)));
}

// The shared symmetric quantizer: scale = max(amax, 1e-8) / qmax by IEEE
// division, value = rint(x / scale) (half to even) clipped to +-qmax.
__device__ __forceinline__ float quant_scale(float amax, float qmax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), qmax);
}

__device__ __forceinline__ float quant_value(float x, float scale, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

// quant_value's result without its IEEE division in all but a few cases:
// x * (1 / scale) lies within 3e-5 of x / scale (|x / scale| <= 128, both
// rounded to fp32), so rounding it gives rint(x / scale) whenever x / scale
// is farther than 1e-3 from a half-integer; nearer, the division decides.
__device__ __forceinline__ float quant_value_fast(float x, float scale,
                                                  float inv, float qmax) {
  const float q = __fmul_rn(x, inv);
  float n = rintf(q);
  if (fabsf(fabsf(__fsub_rn(q, n)) - 0.5f) < 1e-3f) n = rintf(__fdiv_rn(x, scale));
  return fminf(fmaxf(n, -qmax), qmax);
}

__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap > 0.f ? __fmul_rn(cap, tanhf(__fdiv_rn(s, cap))) : s;
}

}  // namespace decode_tile
