// The per-tile arithmetic of the fused decode layer (kernel 4,
// fused_decode_layer.cu): one lane's share of a query-key dot product, the
// online-softmax update of one query row over a 64-key tile, the P.V
// accumulation and the fold of a row's own new key; and the pieces the
// fused verify layer (kernel 5, fused_spec_decode_layer.cu) shares with it:
// the warp reductions, rope, the new row's quantizer and the soft cap.
//
// Every multiply-add is spelled with an explicit rounding intrinsic, so the
// compiler cannot contract it differently from one build to the next.  The
// rope and the quantizer are what the two kernels must agree on bit for
// bit: a verify burst appends the same cache bytes and scales as T decode
// steps.  Kernel 5's attention sums in its own order (split-KV, tensor
// cores) and agrees with kernel 4's within a tolerance.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace decode_tile {

constexpr int BS = 64;                      // keys per tile (two per lane)
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

// One lane's running share of q . k over its element pairs (d, d + 1):
// two fused multiply-adds, element d first.
__device__ __forceinline__ float pair_dot(float part, float q0, float q1,
                                          float2 k) {
  return __fmaf_rn(q1, k.y, __fmaf_rn(q0, k.x, part));
}

__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap > 0.f ? __fmul_rn(cap, tanhf(__fdiv_rn(s, cap))) : s;
}

// Online-softmax update of one query row from its BS scores (one warp; lane
// owns keys lane and lane + 32): the scores become probabilities in place,
// lane 0 stores the row's new max, sum and the accumulator's correction.
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* corr, int lane) {
  const float s0 = sc[lane];
  const float s1 = sc[lane + 32];
  const float mx = warp_max(fmaxf(s0, s1));
  const float m_old = *m;
  const float m_new = fmaxf(m_old, mx);
  const float c = (m_old == NEG_INF) ? 0.f : expf(__fsub_rn(m_old, m_new));
  const float p0 = (s0 == NEG_INF) ? 0.f : expf(__fsub_rn(s0, m_new));
  const float p1 = (s1 == NEG_INF) ? 0.f : expf(__fsub_rn(s1, m_new));
  sc[lane] = p0;
  sc[lane + 32] = p1;
  const float psum = warp_sum(__fadd_rn(p0, p1));
  if (lane == 0) {
    *m = m_new;
    *l = __fmaf_rn(*l, c, psum);
    *corr = c;
  }
}

// acc * corr + sum_j p[j] * v[j * pitch] for one accumulator element.
__device__ __forceinline__ float pv(float acc, float corr, const float* p,
                                    const float* v, int pitch) {
  float a = __fmul_rn(acc, corr);
#pragma unroll 8
  for (int j = 0; j < BS; ++j) a = __fmaf_rn(p[j], v[j * pitch], a);
  return a;
}

// The row's own new key and value, folded last, and the normalised output
// (one warp per query row): out = (acc * c + p * vd) / (l * c + p).
template <int D>
__device__ __forceinline__ void fold_emit(const float* q, const float* kd,
                                          const float* vd, const float* acc,
                                          float m_old, float l_old, float cap,
                                          int lane, __nv_bfloat16* out) {
  float part = 0.f;
  for (int d = lane; d < D; d += 32) part = __fmaf_rn(q[d], kd[d], part);
  const float s = soft_cap(warp_sum(part), cap);
  const float m_new = fmaxf(m_old, s);
  const float c = (m_old == NEG_INF) ? 0.f : expf(__fsub_rn(m_old, m_new));
  const float p = expf(__fsub_rn(s, m_new));
  const float l = fmaxf(__fmaf_rn(l_old, c, p), 1e-30f);
  for (int d = lane; d < D; d += 32)
    out[d] = __float2bfloat16(
        __fdiv_rn(__fmaf_rn(acc[d], c, __fmul_rn(p, vd[d])), l));
}

}  // namespace decode_tile
