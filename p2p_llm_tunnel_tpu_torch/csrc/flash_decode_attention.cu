// Slot-decode attention on Hopper (sm_90a): one query token per slot against
// that slot's raw bf16 KV cache, fp32 softmax and accumulation.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// flash_decode_attention_sgrid, raw-KV form (body _decode_kernel_sgrid).
// Same function: q [B,1,H,D], k/v cache [B,S,K,D] (any slot stride — the
// model passes a strided [:, :view] window of the [L,B,S_max,K,D] cache, so
// no copy), positions [B] -> out [B,1,H,D]; key j is attended iff
// j <= pos and pos - j < window, scores optionally soft-capped; parked rows
// (pos >= S) attend the whole view and never read out of bounds.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s): decode reads the live K/V prefix once — B * (frontier+1) *
// K * D * 2 bytes * 2 — for ~G FLOPs per byte read, far below the card's
// ~295 FLOP/byte ridge: HBM bandwidth bounds it (PERF.md has the measured
// times, which sit far above that bound in this first version).
//
// Design: one block per (KV head, slot) carries all G = H/K query rows of
// that head, so each K/V element is loaded from HBM once per step (the
// point of the TPU kernel's [G, D] query group).  The block walks 64-key
// tiles only from the window floor up to the slot's frontier
// min(pos, S-1): tiles past it are never loaded (the TPU kernel's
// index-map clamp).  Scores: one warp per key, lanes reading contiguous
// bf16 pairs (coalesced 256-byte rows at D 128) and shuffle-reducing the G
// dot products; V tiles are staged in shared memory as fp32 for the PV
// accumulation.  First version: no split over S, no async copies.
//
// C ABI (loaded with ctypes): flash_decode_attention_bf16 returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BS = 64;             // keys per tile (two per lane in softmax)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;           // query rows per KV head
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
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int D, int G) {
  // q [G,D] + acc [G,D] + scores [G,BS] + V tile [BS,D] + m, l, corr [G]
  return size_t(2) * G * D + size_t(G) * BS + size_t(BS) * D + 3 * size_t(G);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out,
                    int S, int H, int KH, int G, long long slot_stride,
                    float scale, float softcap, int window) {
  extern __shared__ __align__(16) float sm[];
  float* qf = sm;                 // [G, D]
  float* acc = qf + G * D;        // [G, D]
  float* sc = acc + G * D;        // [G, BS] scores, then probabilities
  float* vt = sc + G * BS;        // [BS, D]
  float* ms = vt + BS * D;        // [G]
  float* ls = ms + G;             // [G]
  float* cs = ls + G;             // [G]

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[b];

  const size_t q_off = (size_t(b) * H + size_t(kh) * G) * D;
  const __nv_bfloat16* kb = k + size_t(b) * slot_stride + size_t(kh) * D;
  const __nv_bfloat16* vb = v + size_t(b) * slot_stride + size_t(kh) * D;
  const size_t pitch = size_t(KH) * D;  // between consecutive positions

  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    qf[i] = __bfloat162float(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  __syncthreads();

  // Frontier: the last key this slot can attend (parked rows: whole view);
  // window floor: the first.  Tiles outside [first, last] are never read.
  const int last = min(pos, S - 1);
  const long long first_ll = (long long)pos - (long long)window + 1;
  const int first = first_ll < 0 ? 0 : (first_ll > S ? S : (int)first_ll);

  for (int k0 = (first / BS) * BS; k0 <= last; k0 += BS) {
    // Scores: warp per key, lanes over D in bf16 pairs.
    for (int j = warp; j < BS; j += WARPS) {
      const int kp = k0 + j;
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      if (kp <= last) {
        const __nv_bfloat16* kr = kb + size_t(kp) * pitch;
#pragma unroll
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 kv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + d));
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
            float s = part[g] * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            sc[g * BS + j] = ok ? s : NEG_INF;
          }
        }
      }
    }
    // V tile -> shared fp32 (zeros past the frontier).
    for (int i = threadIdx.x; i < BS * (D / 2); i += THREADS) {
      const int j = i / (D / 2);
      const int c = 2 * (i - j * (D / 2));
      const int kp = k0 + j;
      float2 val = make_float2(0.f, 0.f);
      if (kp <= last)
        val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vb + size_t(kp) * pitch + c));
      vt[j * D + c] = val.x;
      vt[j * D + c + 1] = val.y;
    }
    __syncthreads();

    // Online softmax: warp per query row, lane owns keys lane, lane+32.
    for (int g = warp; g < G; g += WARPS) {
      const float s0 = sc[g * BS + lane];
      const float s1 = sc[g * BS + lane + 32];
      const float mx = warp_max(fmaxf(s0, s1));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float corr = (m_old == NEG_INF) ? 0.f : expf(m_old - m_new);
      const float p0 = (s0 == NEG_INF) ? 0.f : expf(s0 - m_new);
      const float p1 = (s1 == NEG_INF) ? 0.f : expf(s1 - m_new);
      sc[g * BS + lane] = p0;
      sc[g * BS + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * corr + psum;
        cs[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = sc + g * BS;
      float a = acc[i] * cs[g];
#pragma unroll 8
      for (int j = 0; j < BS; ++j) a += pr[j] * vt[j * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D;
    out[q_off + i] = __float2bfloat16(acc[i] / fmaxf(ls[g], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* positions, void* out, int B, int S, int H,
                   int KH, long long slot_stride, float scale, float softcap,
                   int window, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = smem_floats(D, G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KH, B);
  flash_decode_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), S, H, KH, G, slot_stride, scale,
      softcap, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* positions,
    void* out, int B, int S, int H, int KH, int D, long long slot_stride,
    float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAX_G ||
      window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, positions, out, B, S, H, KH,
                                         slot_stride, scale, softcap, window, s));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, positions, out, B, S, H, KH,
                                         slot_stride, scale, softcap, window, s));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, positions, out, B, S, H, KH,
                                         slot_stride, scale, softcap, window, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, positions, out, B, S, H, KH,
                                          slot_stride, scale, softcap, window, s));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, positions, out, B, S, H, KH,
                                          slot_stride, scale, softcap, window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
