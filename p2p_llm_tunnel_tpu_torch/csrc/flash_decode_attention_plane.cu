// The legacy whole-plane slot-decode attention on Hopper (sm_90a): one query
// token per slot against its raw bf16 KV cache, fp32 softmax and
// accumulation.  A cross-check of kernel 2's online softmax only: no
// serving path calls it, in this port or in the JAX package.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// flash_decode_attention_plane (:179, pallas_call :219, kernel body
// _decode_kernel :105).  Same function: q [B,1,H,D], k/v cache [B,S,K,D]
// raw (any slot stride), positions [B] -> out [B,1,H,D]; q is multiplied by
// the softmax scale in fp32 first, key j is attended iff j <= pos (the query
// token's own row included, unlike kernel 4's < pos) and pos - j < window
// ("no window" is INT32_MAX); parked rows (pos >= S) attend the whole plane.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s): HBM bytes — each slot's K/V plane up to its frontier read once
// at 2 bytes per element — at ~G FLOPs per cache element, far below the
// ~295 FLOP/byte ridge.
//
// Design: one block per (KV head, slot) holding the G query rows, as the
// Pallas grid (slot, kv head).  The Pallas body stages the whole [S, D]
// plane and walks 128-key blocks from key 0 to the frontier; here the block
// walks the same 128-key tiles from key 0 (no window-floor skip: the plane
// body has none) up to min(pos, S - 1) and never loads a tile past it.  A
// warp per key for the scores (lanes over element pairs), a warp per query
// row for the online softmax (four keys per lane), the V tile staged in
// shared memory as fp32 for the P.V accumulation.
//
// C ABI (loaded with ctypes): flash_decode_attention_plane_launch returns
// the cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_tile.cuh"

namespace {

constexpr int BK = 128;            // keys per tile (the Pallas BLOCK_K)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;

using decode_tile::NEG_INF;
using decode_tile::warp_max;
using decode_tile::warp_sum;

__host__ __device__ constexpr size_t smem_floats(int D, int G) {
  // q [G,D] + acc [G,D] + scores [G,BK] + V tile [BK,D] + m, l, corr [G]
  return size_t(2) * G * D + size_t(G) * BK + size_t(BK) * D + 3 * size_t(G);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
plane_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int S, int H, int KH,
                    long long slot_stride, float scale, float softcap,
                    int window) {
  extern __shared__ __align__(16) float sm[];
  const int G = H / KH;
  float* qf = sm;                 // [G, D] pre-scaled queries
  float* acc = qf + G * D;        // [G, D]
  float* sc = acc + G * D;        // [G, BK] scores, then probabilities
  float* vt = sc + G * BK;        // [BK, D]
  float* ms = vt + BK * D;        // [G]
  float* ls = ms + G;             // [G]
  float* cs = ls + G;             // [G]

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[b];
  const size_t q_off = (size_t(b) * H + size_t(kh) * G) * D;
  const size_t pitch = size_t(KH) * D;
  const __nv_bfloat16* kb = k + size_t(b) * slot_stride + size_t(kh) * D;
  const __nv_bfloat16* vb = v + size_t(b) * slot_stride + size_t(kh) * D;

  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    qf[i] = __bfloat162float(q[q_off + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int last = min(pos, S - 1);
  for (int k0 = 0; k0 <= last; k0 += BK) {
    for (int j = warp; j < BK; j += WARPS) {
      const int kp = k0 + j;
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      if (kp <= last) {
#pragma unroll
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 kv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(kb + size_t(kp) * pitch + d));
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) part[g] += qf[g * D + d] * kv.x + qf[g * D + d + 1] * kv.y;
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part[g] = warp_sum(part[g]);
      if (lane == 0) {
        const bool ok = kp <= last && (pos - kp) < window;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            float s = part[g];
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            sc[g * BK + j] = ok ? s : NEG_INF;
          }
        }
      }
    }
    for (int i = threadIdx.x; i < BK * (D / 2); i += THREADS) {
      const int j = i / (D / 2);
      const int c = 2 * (i - j * (D / 2));
      const int kp = k0 + j;
      float2 val = make_float2(0.f, 0.f);
      if (kp <= last)
        val = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vb + size_t(kp) * pitch + c));
      vt[j * D + c] = val.x;
      vt[j * D + c + 1] = val.y;
    }
    __syncthreads();

    // Online softmax: warp per query row, lane owns keys lane + 32i.
    for (int g = warp; g < G; g += WARPS) {
      float s[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        s[i] = sc[g * BK + lane + 32 * i];
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float corr = (m_old == NEG_INF) ? 0.f : expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const float p = (s[i] == NEG_INF) ? 0.f : expf(s[i] - m_new);
        sc[g * BK + lane + 32 * i] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * corr + psum;
        cs[g] = corr;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = sc + g * BK;
      float a = acc[i] * cs[g];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a += pr[j] * vt[j * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G * D; i += THREADS)
    out[q_off + i] = __float2bfloat16(acc[i] / fmaxf(ls[i / D], 1e-30f));
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* positions, void* out, int B, int S, int H,
                   int KH, long long slot_stride, float scale, float softcap,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_floats(D, H / KH) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        plane_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KH, B);
  plane_decode_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), S, H, KH, slot_stride, scale, softcap,
      window);
  return cudaGetLastError();
}

}  // namespace

// S is the plane's token count (a multiple of 128, as the Pallas wrapper
// requires); slot_stride is in bf16 elements.
extern "C" int flash_decode_attention_plane_launch(
    const void* q, const void* k, const void* v, const void* positions,
    void* out, int B, int S, int H, int KH, int D, long long slot_stride,
    float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || S % BK != 0 || KH <= 0 || H % KH != 0 ||
      H / KH > MAX_G || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define PLANE_CASE(DD)                                                       \
  case DD:                                                                   \
    return static_cast<int>(launch<DD>(q, k, v, positions, out, B, S, H, KH, \
                                       slot_stride, scale, softcap, window,  \
                                       s));
    PLANE_CASE(16)
    PLANE_CASE(32)
    PLANE_CASE(64)
    PLANE_CASE(128)
    PLANE_CASE(256)
#undef PLANE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_decode_attention_plane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
