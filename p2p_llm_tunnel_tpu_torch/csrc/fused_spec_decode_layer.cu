// The fused K-token speculative verify layer on Hopper (sm_90a): kernel 4
// (fused_decode_layer.cu) for T = K + 1 new rows per slot in one launch per
// layer — rope of the T query rows and new keys at positions pos + t, the
// quantization of the T new K/V rows to the cache's form, their in-place
// appends, and for each row t attention over the cache's keys below pos + t
// with the burst's earlier rows substituted where they land and row t's own
// term folded last.  bf16 activations, fp32 math.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// fused_spec_decode_layer (:1198, pallas_call :1365, kernel body
// _fused_spec_decode_layer_kernel :902) in its raw, int8 and int4 KV forms.
// Same function: q [B,T,H,D] and the new rows k/v [B,T,K,D] PRE-rope, the
// stacked cache [L,B,S,K,D] (raw bf16 or int8) or [L,B,S/2,K,D] (packed
// int4) with f32 scales [L,B,S,K], a layer index and the positions of burst
// row 0 [B] -> attention [B,T,H,D].  Per slot and row t, as the Pallas body:
// - q and the new key are roped in fp32 at pos + t from the wrapper's
//   [B,T,D/2] sin/cos table; q is pre-scaled; the new rows are quantized
//   from the unrounded fp32 values (decode_tile.cuh's quantizer);
// - query t attends cache keys < pos + t within the window; an earlier burst
//   row t' < t is substituted at pos + t' as the cache will store it (raw:
//   the roped key rounded to bf16, the value as given; quantized: the
//   dequantized values — Pallas _deq_row(..., stored=True));
// - row t's own term is folded last from the unrounded fp32 key (raw) or the
//   dequantized row (Pallas _emit);
// - rows with pos + t >= view are parked per token: nothing is stored, the
//   output is junk the engine discards.
// Each query walks the same 64-key tiles with decode_tile.cuh's per-tile
// arithmetic as kernel 4, and a tile whose keys are all masked for a row
// leaves that row untouched, so row t's output is bit for bit kernel 4's at
// position pos + t after the t earlier appends.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s, 989 TFLOP/s bf16): HBM bytes — each slot's live cache prefix
// read once (2, 1 or 0.5 bytes per element plus 4-byte scales per (token,
// head)), q / new rows / output once, T rows written — at ~T*G FLOPs per
// cache element, still far below the ~295 FLOP/byte ridge.  A verify burst
// reads the prefix once for all T rows where T decode steps read it T times.
//
// Design (a simple, correct first version): one block per (KV head, slot)
// holds all T*G query rows (<= 72: spec_k_max 8 at G = 8) and walks 64-key
// tiles aligned at multiples of 64 from the lowest window floor of the
// burst up to min(pos + T - 1, view) - 1; nothing carries between blocks.
// Scores: one warp per key, the lane's element pairs of the key held in
// registers (the burst's rows from shared memory, the cache's through
// kv_forms.cuh), then one dot product and shuffle reduction per query row.
// The same block owns all T appends of its (slot, head): for int4 the bytes
// the burst shares with itself and with the neighbouring committed token
// are merged in registers and stored whole by one thread — no atomics (the
// Pallas kernel keeps its 1-row output block resident for the same end).
// Attention reads happen before the appends, and no other block touches
// this (slot, head).  Shared memory is sized for the T*G rows; the wrapper
// refuses geometries over MAX_ROWS or the card's 227 KB.
//
// C ABI (loaded with ctypes): fused_spec_decode_layer_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "kv_forms.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 72;          // T * G query rows per block
constexpr size_t MAX_SMEM = 232448;   // bytes a block may use on an H100

using namespace decode_tile;
using namespace kv_forms;

struct Args {
  const __nv_bfloat16* q;      // [B, T, H, D] pre-rope
  const __nv_bfloat16* k_new;  // [B, T, K, D] pre-rope
  const __nv_bfloat16* v_new;  // [B, T, K, D]
  void* k_cache;               // [L, B, S(/2), K, D]
  void* v_cache;
  float* k_scale;              // [L, B, S, K] (quantized forms)
  float* v_scale;
  const float* sin_t;          // [B, T, D/2]
  const float* cos_t;
  const int* positions;        // [B] position of burst row 0
  __nv_bfloat16* out;          // [B, T, H, D]
  int B, T, S, H, KH, layer, view;
  float scale, softcap;
  int window;
};

__host__ __device__ constexpr size_t smem_floats(int D, int T, int G) {
  // q, acc [R,D] + scores [R,BS] + V tile [BS,D] + m, l, corr [R]
  // + new k, new v, attended k, attended v, stored k [T,D] + scales [T] x 2
  return size_t(2) * T * G * D + size_t(T) * G * BS + size_t(BS) * D +
         3 * size_t(T) * G + 5 * size_t(T) * D + 2 * size_t(T);
}

__device__ __forceinline__ int clamp_floor(long long x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : static_cast<int>(x));
}

template <int D, int FORM>
__global__ void __launch_bounds__(THREADS)
fused_spec_kernel(const Args a) {
  constexpr int HALF = D / 2;
  constexpr int NP = (D + 63) / 64;  // element pairs of a key row per lane
  extern __shared__ __align__(16) float sm[];
  const int T = a.T;
  const int G = a.H / a.KH;
  const int R = T * G;
  float* qf = sm;               // [R, D] roped, pre-scaled; row r = t*G + g
  float* acc = qf + R * D;      // [R, D]
  float* sc = acc + R * D;      // [R, BS] scores, then probabilities
  float* vt = sc + R * BS;      // [BS, D]
  float* ms = vt + BS * D;      // [R]
  float* ls = ms + R;           // [R]
  float* cs = ls + R;           // [R]
  float* kn = cs + R;           // [T, D] roped new keys, then their int values
  float* vn = kn + T * D;       // [T, D] new values, then their int values
  float* kd = vn + T * D;       // [T, D] key of a row's own term
  float* vd = kd + T * D;       // [T, D] value as attended and as stored
  float* kst = vd + T * D;      // [T, D] key as the cache stores it
  float* ksc = kst + T * D;     // [T] scales of the new rows
  float* vsc = ksc + T;         // [T]

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos = a.positions[b];

  // Queries roped at pos + t and pre-scaled; the new K/V rows.
  for (int i = tid; i < R * HALF; i += THREADS) {
    const int r = i / HALF;
    const int dd = i - r * HALF;
    const int t = r / G;
    const int g = r - t * G;
    const __nv_bfloat16* qr =
        a.q + ((size_t(b) * T + t) * a.H + size_t(kh) * G + g) * D;
    const size_t tab = (size_t(b) * T + t) * HALF + dd;
    const float2 v = rope_f32(__bfloat162float(qr[dd]),
                              __bfloat162float(qr[dd + HALF]), a.sin_t[tab],
                              a.cos_t[tab]);
    qf[r * D + dd] = __fmul_rn(v.x, a.scale);
    qf[r * D + dd + HALF] = __fmul_rn(v.y, a.scale);
  }
  for (int i = tid; i < R * D; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < R; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }
  for (int i = tid; i < T * HALF; i += THREADS) {
    const int t = i / HALF;
    const int dd = i - t * HALF;
    const size_t off = ((size_t(b) * T + t) * a.KH + kh) * D;
    const size_t tab = (size_t(b) * T + t) * HALF + dd;
    const float2 v = rope_f32(__bfloat162float(a.k_new[off + dd]),
                              __bfloat162float(a.k_new[off + dd + HALF]),
                              a.sin_t[tab], a.cos_t[tab]);
    kn[t * D + dd] = v.x;
    kn[t * D + dd + HALF] = v.y;
  }
  for (int i = tid; i < T * D; i += THREADS) {
    const int t = i / D;
    vn[i] = __bfloat162float(
        a.v_new[((size_t(b) * T + t) * a.KH + kh) * D + (i - t * D)]);
  }
  __syncthreads();

  // Quantize each new row (per (token, head) scale over D); warp per token.
  if constexpr (FORM != RAW) {
    constexpr float QMAX = FORM == INT4 ? 7.f : 127.f;
    for (int t = warp; t < T; t += WARPS) {
      float mk = 0.f, mv = 0.f;
      for (int d = lane; d < D; d += 32) {
        mk = fmaxf(mk, fabsf(kn[t * D + d]));
        mv = fmaxf(mv, fabsf(vn[t * D + d]));
      }
      const float ks = quant_scale(warp_max(mk), QMAX);
      const float vs = quant_scale(warp_max(mv), QMAX);
      for (int d = lane; d < D; d += 32) {
        const int i = t * D + d;
        const float kq = quant_value(kn[i], ks, QMAX);
        const float vq = quant_value(vn[i], vs, QMAX);
        kn[i] = kq;
        vn[i] = vq;
        kd[i] = __fmul_rn(kq, ks);
        vd[i] = __fmul_rn(vq, vs);
        kst[i] = kd[i];
      }
      if (lane == 0) {
        ksc[t] = ks;
        vsc[t] = vs;
      }
    }
  } else {
    for (int i = tid; i < T * D; i += THREADS) {
      kd[i] = kn[i];
      vd[i] = vn[i];
      kst[i] = __bfloat162float(__float2bfloat16(kn[i]));
    }
  }
  __syncthreads();

  // Tiles from the burst's lowest window floor to its last attended key.
  const size_t rows = FORM == INT4 ? size_t(a.S / 2) : size_t(a.S);
  const size_t pitch = size_t(a.KH) * D;  // between consecutive cache rows
  const size_t slot = size_t(a.layer) * a.B + b;
  const size_t ebytes = FORM == RAW ? 2 : 1;
  const size_t head_off = (slot * rows * pitch + size_t(kh) * D) * ebytes;
  const void* kb = static_cast<const char*>(a.k_cache) + head_off;
  const void* vb = static_cast<const char*>(a.v_cache) + head_off;
  const size_t scale_row0 = slot * a.S * a.KH + kh;  // + position * KH
  const int last_all = min(pos + T - 1, a.view) - 1;
  const int first0 = clamp_floor((long long)pos - a.window + 1, a.view);

  for (int k0 = (first0 / BS) * BS; k0 <= last_all; k0 += BS) {
    for (int j = warp; j < BS; j += WARPS) {
      const int kp = k0 + j;
      const int tt = kp - pos;  // the burst row at this key when >= 0
      float2 kreg[NP];
      float ksv = 1.f;
      if (FORM != RAW && kp <= last_all && tt < 0)
        ksv = a.k_scale[scale_row0 + size_t(kp) * a.KH];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 2 * lane + 64 * i;
        kreg[i] = make_float2(0.f, 0.f);
        if (d < D && kp <= last_all)
          kreg[i] = tt >= 0
                        ? make_float2(kst[tt * D + d], kst[tt * D + d + 1])
                        : load_pair<FORM>(kb, kp, pitch, d, ksv);
      }
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int d = 2 * lane + 64 * i;
          if (d < D) part = pair_dot(part, qf[r * D + d], qf[r * D + d + 1], kreg[i]);
        }
        part = warp_sum(part);
        if (lane == 0) {
          // Row r's query sits at p = pos + t: kernel 4's mask at p.
          const int p = pos + r / G;
          const int last = min(p, a.view) - 1;
          const int first = clamp_floor((long long)p - a.window + 1, a.view);
          const bool ok = kp <= last && kp >= first && (p - kp) < a.window;
          sc[r * BS + j] = ok ? soft_cap(part, a.softcap) : NEG_INF;
        }
      }
    }
    for (int i = tid; i < BS * (D / 2); i += THREADS) {
      const int j = i / (D / 2);
      const int c = 2 * (i - j * (D / 2));
      const int kp = k0 + j;
      const int tt = kp - pos;
      float2 val = make_float2(0.f, 0.f);
      if (kp <= last_all) {
        if (tt >= 0) {
          val = make_float2(vd[tt * D + c], vd[tt * D + c + 1]);
        } else {
          const float vsv =
              FORM == RAW ? 1.f : a.v_scale[scale_row0 + size_t(kp) * a.KH];
          val = load_pair<FORM>(vb, kp, pitch, c, vsv);
        }
      }
      vt[j * D + c] = val.x;
      vt[j * D + c + 1] = val.y;
    }
    __syncthreads();

    for (int r = warp; r < R; r += WARPS)
      softmax_tile(sc + r * BS, ms + r, ls + r, cs + r, lane);
    __syncthreads();

    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D;
      acc[i] = pv(acc[i], cs[r], sc + r * BS, vt + (i - r * D), D);
    }
    __syncthreads();
  }

  // Each row's own term, folded last; warp per query row.
  for (int r = warp; r < R; r += WARPS) {
    const int t = r / G;
    const int g = r - t * G;
    fold_emit<D>(qf + r * D, kd + t * D, vd + t * D, acc + r * D, ms[r],
                 ls[r], a.softcap, lane,
                 a.out + ((size_t(b) * T + t) * a.H + size_t(kh) * G + g) * D);
  }

  // The appends of this (slot, head): tokens pos .. pos + n_live - 1.
  const int n_live = max(0, min(T, a.view - pos));
  if (n_live == 0) return;
  if constexpr (FORM == RAW) {
    __nv_bfloat16* kc = static_cast<__nv_bfloat16*>(a.k_cache);
    __nv_bfloat16* vc = static_cast<__nv_bfloat16*>(a.v_cache);
    for (int i = tid; i < n_live * D; i += THREADS) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t row = (slot * rows + pos + t) * pitch + size_t(kh) * D;
      kc[row + d] = __float2bfloat16(kn[i]);
      vc[row + d] = a.v_new[((size_t(b) * T + t) * a.KH + kh) * D + d];
    }
  } else if constexpr (FORM == INT8) {
    int8_t* kc = static_cast<int8_t*>(a.k_cache);
    int8_t* vc = static_cast<int8_t*>(a.v_cache);
    for (int i = tid; i < n_live * D; i += THREADS) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t row = (slot * rows + pos + t) * pitch + size_t(kh) * D;
      kc[row + d] = static_cast<int8_t>(static_cast<int>(kn[i]));
      vc[row + d] = static_cast<int8_t>(static_cast<int>(vn[i]));
    }
  } else {
    // Whole bytes: each byte the burst touches is read, its burst nibbles
    // merged (even tokens own the low nibble, odd ones the high), and
    // stored once; a nibble of a token outside the burst keeps its value.
    int8_t* kc = static_cast<int8_t*>(a.k_cache);
    int8_t* vc = static_cast<int8_t*>(a.v_cache);
    const int b0 = pos >> 1;
    const int nbytes = ((pos + n_live - 1) >> 1) - b0 + 1;
    for (int i = tid; i < nbytes * D; i += THREADS) {
      const int bi = b0 + i / D;
      const int d = i % D;
      const size_t at = (slot * rows + bi) * pitch + size_t(kh) * D + d;
      int ok = static_cast<uint8_t>(kc[at]);
      int ov = static_cast<uint8_t>(vc[at]);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int t = 2 * bi + hi - pos;
        if (t < 0 || t >= n_live) continue;
        const int kq = static_cast<int>(kn[t * D + d]);
        const int vq = static_cast<int>(vn[t * D + d]);
        ok = hi ? (((kq & 0x0F) << 4) | (ok & 0x0F)) : ((ok & 0xF0) | (kq & 0x0F));
        ov = hi ? (((vq & 0x0F) << 4) | (ov & 0x0F)) : ((ov & 0xF0) | (vq & 0x0F));
      }
      kc[at] = static_cast<int8_t>(static_cast<uint8_t>(ok));
      vc[at] = static_cast<int8_t>(static_cast<uint8_t>(ov));
    }
  }
  if constexpr (FORM != RAW) {
    for (int t = tid; t < n_live; t += THREADS) {
      a.k_scale[scale_row0 + size_t(pos + t) * a.KH] = ksc[t];
      a.v_scale[scale_row0 + size_t(pos + t) * a.KH] = vsc[t];
    }
  }
}

template <int D, int FORM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(D, a.T, a.H / a.KH) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_spec_kernel<D, FORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.KH, a.B);
  fused_spec_kernel<D, FORM><<<grid, THREADS, smem, stream>>>(a);
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

// T is the burst width (rows per slot); S the cache's token count per slot
// (int4 planes hold S/2 byte rows); view <= S bounds the attended keys and
// parks tokens at pos + t >= view; form 0 raw, 1 int8, 2 int4.
extern "C" int fused_spec_decode_layer_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* sin_t,
    const void* cos_t, const void* positions, void* out, int B, int T, int S,
    int H, int KH, int D, int L, int layer, int view, int form, float scale,
    float softcap, int window, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
      T * (H / KH) > MAX_ROWS || layer < 0 || layer >= L || view <= 0 ||
      view > S || window <= 0 || form < RAW || form > INT4 ||
      (form == INT4 && S % 2) ||
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
  a.T = T;
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

extern "C" const char* fused_spec_decode_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
