// The fused decode layer on Hopper (sm_90a): one launch per layer does the
// whole decode attention sub-block for every slot — rope of q and of the
// new key row, the new row's quantization to the cache's form, its in-place
// append, and attention over the cache's keys below the slot's position plus
// the new row's own term.  bf16 activations, fp32 math.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// fused_decode_layer (:728, kernel body _fused_decode_layer_kernel) in its
// raw, int8 and int4 KV forms.  Same function: q [B,H,D] and the new rows
// k/v [B,K,D] PRE-rope, the full stacked cache [L,B,S,K,D] (raw bf16 or
// int8) or [L,B,S/2,K,D] (packed int4: token 2i in the low nibble of byte
// i, 2i+1 in the high) with f32 scales [L,B,S,K], a layer index and the
// positions [B] -> attention [B,H,D].  Per slot, as the Pallas body:
// - q and the new key are roped in fp32 from the wrapper's sin/cos rows
//   (ops/rope.rope_table) and q is multiplied by the softmax scale in fp32;
//   rotate-half is written with __fmul_rn / __fsub_rn / __fadd_rn so no FMA
//   contraction can move a value that the quantizer then rounds (the tile
//   arithmetic is decode_tile.cuh's, shared with kernel 5, whose burst rows
//   are bit for bit this kernel's);
// - the new row is quantized from those fp32 values: scale = max(amax,
//   1e-8) / qmax by IEEE division, q = rint(x / scale) (half to even)
//   clipped to +-127 (int8) or +-7 (int4);
// - cache keys are attended strictly below pos (and within the window);
// - the new row's term is folded last from its dequantized fp32 values (raw:
//   the unrounded fp32 row; the cache stores it rounded to bf16);
// - rows at pos >= view are parked: nothing is stored, the output is junk.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s): like kernel 2, HBM bytes — each slot's live cache prefix
// (pos keys x K x D at 2, 1 or 0.5 bytes, plus 4-byte scales per (token,
// head) when quantized) read once, q / new rows / output once, one cache
// row written — at ~G FLOPs per cache element, far below the ~295 FLOP/byte
// ridge.  What the fusion removes is launches: the unfused step issues the
// rope of q and k, the quantization and 2-4 gather/where/scatter writes as
// separate kernels per layer.
//
// Design: one block per (KV head, slot) holding that head's G query rows,
// as kernel 2.  It walks 64-key tiles from the window floor to the frontier
// min(pos, view) - 1, so nothing carries between blocks.  The same block
// owns the append of its (slot, head) row, so the int4 byte shared with the
// neighbouring token is read, merged and stored by exactly one thread: no
// race, no atomics.  Attention reads only keys below pos, and the merge
// keeps the neighbour's nibble, so a read of that byte sees the same
// neighbour value before or after the store.
//
// C ABI (loaded with ctypes): fused_decode_layer_launch returns the
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

using namespace decode_tile;
using namespace kv_forms;

struct Args {
  const __nv_bfloat16* q;      // [B, H, D] pre-rope
  const __nv_bfloat16* k_new;  // [B, K, D] pre-rope
  const __nv_bfloat16* v_new;  // [B, K, D]
  void* k_cache;               // [L, B, S(/2), K, D]
  void* v_cache;
  float* k_scale;              // [L, B, S, K] (quantized forms)
  float* v_scale;
  const float* sin_t;          // [B, D/2]
  const float* cos_t;
  const int* positions;        // [B]
  __nv_bfloat16* out;          // [B, H, D]
  int B, S, H, KH, layer, view;
  float scale, softcap;
  int window;
};

__host__ __device__ constexpr size_t smem_floats(int D, int G) {
  // q [G,D] + acc [G,D] + scores [G,BS] + V tile [BS,D] + m, l, corr [G]
  // + new k, new v, their dequantized copies [D] each + reductions
  return size_t(2) * G * D + size_t(G) * BS + size_t(BS) * D + 3 * size_t(G) +
         4 * size_t(D) + 2 * WARPS + 2;
}

template <int D, int FORM>
__global__ void __launch_bounds__(THREADS)
fused_decode_kernel(const Args a) {
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) float sm[];
  const int G = a.H / a.KH;
  float* qf = sm;                 // [G, D] roped, pre-scaled queries
  float* acc = qf + G * D;        // [G, D]
  float* sc = acc + G * D;        // [G, BS] scores, then probabilities
  float* vt = sc + G * BS;        // [BS, D]
  float* ms = vt + BS * D;        // [G]
  float* ls = ms + G;             // [G]
  float* cs = ls + G;             // [G]
  float* kn = cs + G;             // [D] roped new key, then its int values
  float* vn = kn + D;             // [D] new value, then its int values
  float* kd = vn + D;             // [D] new key as attended (dequantized)
  float* vd = kd + D;             // [D]
  float* red = vd + D;            // [2 * WARPS] partial maxima, then 2 scales

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos = a.positions[b];
  const bool parked = pos >= a.view;
  const float* sn = a.sin_t + size_t(b) * HALF;
  const float* cn = a.cos_t + size_t(b) * HALF;

  // Queries of this head group, roped and pre-scaled; the new K/V row.
  for (int i = tid; i < G * HALF; i += THREADS) {
    const int g = i / HALF;
    const int dd = i - g * HALF;
    const __nv_bfloat16* qr = a.q + (size_t(b) * a.H + size_t(kh) * G + g) * D;
    const float2 r = rope_f32(__bfloat162float(qr[dd]),
                              __bfloat162float(qr[dd + HALF]), sn[dd], cn[dd]);
    qf[g * D + dd] = __fmul_rn(r.x, a.scale);
    qf[g * D + dd + HALF] = __fmul_rn(r.y, a.scale);
  }
  for (int i = tid; i < G * D; i += THREADS) acc[i] = 0.f;
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  const size_t new_off = (size_t(b) * a.KH + kh) * D;
  for (int dd = tid; dd < HALF; dd += THREADS) {
    const float2 r = rope_f32(__bfloat162float(a.k_new[new_off + dd]),
                              __bfloat162float(a.k_new[new_off + dd + HALF]),
                              sn[dd], cn[dd]);
    kn[dd] = r.x;
    kn[dd + HALF] = r.y;
  }
  for (int d = tid; d < D; d += THREADS) vn[d] = __bfloat162float(a.v_new[new_off + d]);
  __syncthreads();

  // Quantize the new row (per (token, head) scale over D).
  if constexpr (FORM != RAW) {
    constexpr float QMAX = FORM == INT4 ? 7.f : 127.f;
    float mk = 0.f, mv = 0.f;
    for (int d = tid; d < D; d += THREADS) {
      mk = fmaxf(mk, fabsf(kn[d]));
      mv = fmaxf(mv, fabsf(vn[d]));
    }
    mk = warp_max(mk);
    mv = warp_max(mv);
    if (lane == 0) {
      red[warp] = mk;
      red[WARPS + warp] = mv;
    }
    __syncthreads();
    if (tid == 0) {
      float xk = red[0], xv = red[WARPS];
      for (int w = 1; w < WARPS; ++w) {
        xk = fmaxf(xk, red[w]);
        xv = fmaxf(xv, red[WARPS + w]);
      }
      red[2 * WARPS] = quant_scale(xk, QMAX);
      red[2 * WARPS + 1] = quant_scale(xv, QMAX);
    }
    __syncthreads();
    const float ks = red[2 * WARPS];
    const float vs = red[2 * WARPS + 1];
    for (int d = tid; d < D; d += THREADS) {
      const float kq = quant_value(kn[d], ks, QMAX);
      const float vq = quant_value(vn[d], vs, QMAX);
      kn[d] = kq;
      vn[d] = vq;
      kd[d] = __fmul_rn(kq, ks);
      vd[d] = __fmul_rn(vq, vs);
    }
  } else {
    for (int d = tid; d < D; d += THREADS) {
      kd[d] = kn[d];
      vd[d] = vn[d];
    }
  }
  __syncthreads();

  // Attention over the cache: keys [first, last], last = min(pos, view) - 1.
  const size_t rows = FORM == INT4 ? size_t(a.S / 2) : size_t(a.S);
  const size_t pitch = size_t(a.KH) * D;  // between consecutive cache rows
  const size_t slot = size_t(a.layer) * a.B + b;
  const size_t ebytes = FORM == RAW ? 2 : 1;
  const size_t head_off = (slot * rows * pitch + size_t(kh) * D) * ebytes;
  const void* kb = static_cast<const char*>(a.k_cache) + head_off;
  const void* vb = static_cast<const char*>(a.v_cache) + head_off;
  const size_t scale_row0 = slot * a.S * a.KH + kh;  // + pos * KH
  const int last = min(pos, a.view) - 1;
  const long long first_ll = (long long)pos - (long long)a.window + 1;
  const int first = first_ll < 0 ? 0 : (first_ll > a.view ? a.view : (int)first_ll);

  for (int k0 = (first / BS) * BS; k0 <= last; k0 += BS) {
    for (int j = warp; j < BS; j += WARPS) {
      const int kp = k0 + j;
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      if (kp <= last) {
        const float ksc = FORM == RAW ? 1.f : a.k_scale[scale_row0 + size_t(kp) * a.KH];
#pragma unroll
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 kv = load_pair<FORM>(kb, kp, pitch, d, ksc);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) part[g] = pair_dot(part[g], qf[g * D + d], qf[g * D + d + 1], kv);
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part[g] = warp_sum(part[g]);
      if (lane == 0) {
        const bool ok = kp <= last && kp >= first && (pos - kp) < a.window;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) sc[g * BS + j] = ok ? soft_cap(part[g], a.softcap) : NEG_INF;
        }
      }
    }
    for (int i = tid; i < BS * (D / 2); i += THREADS) {
      const int j = i / (D / 2);
      const int c = 2 * (i - j * (D / 2));
      const int kp = k0 + j;
      float2 val = make_float2(0.f, 0.f);
      if (kp <= last) {
        const float vsc = FORM == RAW ? 1.f : a.v_scale[scale_row0 + size_t(kp) * a.KH];
        val = load_pair<FORM>(vb, kp, pitch, c, vsc);
      }
      vt[j * D + c] = val.x;
      vt[j * D + c + 1] = val.y;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS)
      softmax_tile(sc + g * BS, ms + g, ls + g, cs + g, lane);
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      acc[i] = pv(acc[i], cs[g], sc + g * BS, vt + (i - g * D), D);
    }
    __syncthreads();
  }

  // The new row's own term, folded last; warp per query row.
  for (int g = warp; g < G; g += WARPS)
    fold_emit<D>(qf + g * D, kd, vd, acc + g * D, ms[g], ls[g], a.softcap,
                 lane, a.out + (size_t(b) * a.H + size_t(kh) * G + g) * D);

  // The append of this (slot, head) row; parked rows store nothing.
  if (parked) return;
  if constexpr (FORM == RAW) {
    __nv_bfloat16* kc = static_cast<__nv_bfloat16*>(a.k_cache);
    __nv_bfloat16* vc = static_cast<__nv_bfloat16*>(a.v_cache);
    const size_t row = (slot * rows + pos) * pitch + size_t(kh) * D;
    for (int d = tid; d < D; d += THREADS) {
      kc[row + d] = __float2bfloat16(kn[d]);
      vc[row + d] = a.v_new[new_off + d];
    }
  } else {
    int8_t* kc = static_cast<int8_t*>(a.k_cache);
    int8_t* vc = static_cast<int8_t*>(a.v_cache);
    const size_t r = FORM == INT4 ? size_t(pos >> 1) : size_t(pos);
    const size_t row = (slot * rows + r) * pitch + size_t(kh) * D;
    for (int d = tid; d < D; d += THREADS) {
      const int kq = static_cast<int>(kn[d]);
      const int vq = static_cast<int>(vn[d]);
      if constexpr (FORM == INT8) {
        kc[row + d] = static_cast<int8_t>(kq);
        vc[row + d] = static_cast<int8_t>(vq);
      } else {
        // Read-modify-write of the byte shared with the neighbour token:
        // even positions own the low nibble, odd ones the high.
        const int ok = static_cast<uint8_t>(kc[row + d]);
        const int ov = static_cast<uint8_t>(vc[row + d]);
        const int nk = (pos & 1) ? (((kq & 0x0F) << 4) | (ok & 0x0F))
                                 : ((ok & 0xF0) | (kq & 0x0F));
        const int nv = (pos & 1) ? (((vq & 0x0F) << 4) | (ov & 0x0F))
                                 : ((ov & 0xF0) | (vq & 0x0F));
        kc[row + d] = static_cast<int8_t>(static_cast<uint8_t>(nk));
        vc[row + d] = static_cast<int8_t>(static_cast<uint8_t>(nv));
      }
    }
    if (tid == 0) {
      a.k_scale[scale_row0 + size_t(pos) * a.KH] = red[2 * WARPS];
      a.v_scale[scale_row0 + size_t(pos) * a.KH] = red[2 * WARPS + 1];
    }
  }
}

template <int D, int FORM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KH;
  const size_t smem = smem_floats(D, G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_decode_kernel<D, FORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.KH, a.B);
  fused_decode_kernel<D, FORM><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(int form, const Args& a, cudaStream_t stream) {
  switch (form) {
    case RAW: return launch<D, RAW>(a, stream);
    case INT8: return launch<D, INT8>(a, stream);
    case INT4: return launch<D, INT4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// S is the cache's token count per slot (int4 planes hold S/2 byte rows);
// view <= S bounds the attended keys and parks rows at pos >= view; form 0
// raw, 1 int8, 2 int4.
extern "C" int fused_decode_layer_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* sin_t,
    const void* cos_t, const void* positions, void* out, int B, int S, int H,
    int KH, int D, int L, int layer, int view, int form, float scale,
    float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAX_G ||
      layer < 0 || layer >= L || view <= 0 || view > S || window <= 0 ||
      form < RAW || form > INT4 || (form == INT4 && S % 2) ||
      (form != RAW && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.sin_t = static_cast<const float*>(sin_t);
  a.cos_t = static_cast<const float*>(cos_t);
  a.positions = static_cast<const int*>(positions);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.S = S;
  a.H = H;
  a.KH = KH;
  a.layer = layer;
  a.view = view;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_form<16>(form, a, s));
    case 32: return static_cast<int>(launch_form<32>(form, a, s));
    case 64: return static_cast<int>(launch_form<64>(form, a, s));
    case 128: return static_cast<int>(launch_form<128>(form, a, s));
    case 256: return static_cast<int>(launch_form<256>(form, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_decode_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
