// Slot-decode attention on Hopper (sm_90a): one query token per slot against
// that slot's KV cache — raw bf16, int8, or packed int4 — with fp32 softmax
// and accumulation.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// flash_decode_attention_sgrid and its _int8 / _int4 entries (one body,
// _decode_kernel_sgrid, for the three cache forms).  Same function: q
// [B,1,H,D], k/v cache [B,S,K,D] (any slot stride — the model passes a
// strided [:, :view] window of the [L,B,S_max,K,D] cache, so no copy),
// positions [B] -> out [B,1,H,D]; key j is attended iff j <= pos and
// pos - j < window, scores optionally soft-capped; parked rows (pos >= S)
// attend the whole view and never read out of bounds.  Quantized forms read
// int8 values [B,S,K,D] or packed int4 bytes [B,S/2,K,D] (token 2i in the
// low nibble of byte i, 2i+1 in the high) plus f32 per-(token, head) scales
// [B,S,K], and dequantize in fp32 (value x scale, never rounded to bf16, as
// the Pallas body does after its DMA).
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s): decode reads the live K/V prefix once — B * (frontier+1) *
// K * D * (2 bytes bf16 | 1 byte int8 | 0.5 byte int4) * 2, plus 4-byte
// scales per (token, head) when quantized — for ~G FLOPs per cache element,
// far below the card's ~295 FLOP/byte ridge: HBM bandwidth bounds it
// (PERF.md has the measured times, which sit far above that bound in this
// first version).
//
// Design: one block per (KV head, slot) carries all G = H/K query rows of
// that head, so each K/V element is loaded from HBM once per step (the
// point of the TPU kernel's [G, D] query group).  The block walks 64-key
// tiles only from the window floor up to the slot's frontier
// min(pos, S-1): tiles past it are never loaded (the TPU kernel's
// index-map clamp).  Scores: one warp per key, lanes reading contiguous
// element pairs (coalesced rows) and shuffle-reducing the G dot products;
// V tiles are staged in shared memory as fp32 for the PV accumulation.  The
// cache form is a template parameter of the pair loader, so the softmax,
// masking and frontier logic is one body for all three forms (the Pallas
// kernel's own rule).  First version: no split over S, no async copies.
//
// C ABI (loaded with ctypes): flash_decode_attention_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "kv_forms.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;           // query rows per KV head

using decode_tile::BS;             // keys per tile (two per lane in softmax)
using decode_tile::NEG_INF;
using decode_tile::warp_max;
using decode_tile::warp_sum;
using namespace kv_forms;

__host__ __device__ constexpr size_t smem_floats(int D, int G) {
  // q [G,D] + acc [G,D] + scores [G,BS] + V tile [BS,D] + m, l, corr [G]
  return size_t(2) * G * D + size_t(G) * BS + size_t(BS) * D + 3 * size_t(G);
}

template <int D, int FORM>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k, const void* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out,
                    int S, int H, int KH, int G, long long slot_stride,
                    long long scale_slot_stride, float scale, float softcap,
                    int window) {
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
  const size_t ebytes = FORM == RAW ? 2 : 1;
  const size_t head_off = (size_t(b) * slot_stride + size_t(kh) * D) * ebytes;
  const void* kb = static_cast<const char*>(k) + head_off;
  const void* vb = static_cast<const char*>(v) + head_off;
  const size_t pitch = size_t(KH) * D;  // between consecutive cache rows
  const size_t scale_off = size_t(b) * scale_slot_stride + kh;
  const float* ksb = FORM == RAW ? nullptr : k_scale + scale_off;
  const float* vsb = FORM == RAW ? nullptr : v_scale + scale_off;

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
    // Scores: warp per key, lanes over D in element pairs.
    for (int j = warp; j < BS; j += WARPS) {
      const int kp = k0 + j;
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      if (kp <= last) {
        const float ksc = FORM == RAW ? 1.f : ksb[size_t(kp) * KH];
#pragma unroll
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 kv = load_pair<FORM>(kb, kp, pitch, d, ksc);
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
      if (kp <= last) {
        const float vsc = FORM == RAW ? 1.f : vsb[size_t(kp) * KH];
        val = load_pair<FORM>(vb, kp, pitch, c, vsc);
      }
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

template <int D, int FORM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* positions, void* out, int B, int S, int H,
                   int KH, long long slot_stride, long long scale_slot_stride,
                   float scale, float softcap, int window, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = smem_floats(D, G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<D, FORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KH, B);
  flash_decode_kernel<D, FORM><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), S,
      H, KH, G, slot_stride, scale_slot_stride, scale, softcap, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(int form, const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const void* positions, void* out, int B, int S, int H,
                        int KH, long long slot_stride,
                        long long scale_slot_stride, float scale,
                        float softcap, int window, cudaStream_t stream) {
  switch (form) {
    case RAW:
      return launch<D, RAW>(q, k, v, k_scale, v_scale, positions, out, B, S, H,
                            KH, slot_stride, scale_slot_stride, scale, softcap,
                            window, stream);
    case INT8:
      return launch<D, INT8>(q, k, v, k_scale, v_scale, positions, out, B, S,
                             H, KH, slot_stride, scale_slot_stride, scale,
                             softcap, window, stream);
    case INT4:
      return launch<D, INT4>(q, k, v, k_scale, v_scale, positions, out, B, S,
                             H, KH, slot_stride, scale_slot_stride, scale,
                             softcap, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// S is the view's token count (for int4 the byte planes hold S/2 rows);
// slot_stride is in cache elements (bf16 for raw, bytes for int8/int4),
// scale_slot_stride in floats; form 0 raw, 1 int8, 2 int4.
extern "C" int flash_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, void* out, int B, int S,
    int H, int KH, int D, long long slot_stride, long long scale_slot_stride,
    int form, float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAX_G ||
      window <= 0 || form < RAW || form > INT4 || (form == INT4 && S % 2) ||
      (form != RAW && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDA_CASE(DD)                                                           \
  case DD:                                                                     \
    return static_cast<int>(launch_form<DD>(                                   \
        form, q, k, v, k_scale, v_scale, positions, out, B, S, H, KH,          \
        slot_stride, scale_slot_stride, scale, softcap, window, s));
  switch (D) {
    FDA_CASE(16)
    FDA_CASE(32)
    FDA_CASE(64)
    FDA_CASE(128)
    FDA_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FDA_CASE
}

extern "C" const char* flash_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
