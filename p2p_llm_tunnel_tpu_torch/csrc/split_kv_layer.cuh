// The split-KV decode layer body on Hopper (sm_90a), shared by the fused
// decode layer (kernel 4, fused_decode_layer.cu: one new row per slot), the
// fused K-token verify layer (kernel 5, fused_spec_decode_layer.cu: T =
// K + 1 rows per slot) and, in its attention-only mode, the slot-decode
// kernel (kernel 2, flash_decode_attention.cu).  One launch per layer does,
// for T new rows per slot, the rope of the T query rows and new keys at
// positions pos + t, the quantization of the T new K/V rows to the cache's
// form, their in-place appends, and for each row t attention over the
// committed keys below pos, the burst's earlier rows and row t's own term.
// bf16 activations, fp32 softmax.  Kernel 4 is this function at T = 1,
// instantiated with T fixed at compile time under its own kernel name.
//
// The function, per slot and row t, as the Pallas bodies
// (_fused_decode_layer_kernel, _fused_spec_decode_layer_kernel):
// - q and the new key are roped in fp32 at pos + t from the wrapper's
//   [B,T,D/2] sin/cos table; q is pre-scaled; the new rows are quantized
//   from the unrounded fp32 values (decode_tile.cuh's rope and quantizer,
//   so the appended bytes and scales are the same bit for bit whichever
//   kernel appends them);
// - query t attends the committed keys below pos within its window, then the
//   earlier burst rows t' < t at pos + t' as the cache stores them (raw: the
//   roped key rounded to bf16, the value as given; quantized: dequantized),
//   then its own term from the unrounded fp32 key (raw) or the dequantized
//   row, last;
// - rows with pos + t >= view are parked per token: nothing is stored, the
//   output is junk the engine discards.
// The output is held to the plain versions within a tolerance, not bitwise:
// the products below sum in another order and round q and P to bf16.
//
// Design.
// - Split-KV.  The grid is (KV head, slot, split); split s attends the
//   committed keys [max(floor, s*C), min(pos, view, (s+1)*C)) in 64-key
//   tiles, C a whole number of tiles picked by the wrapper
//   (ops/fused_decode.kv_splits) so that the serving shape (B 17, 8 KV
//   heads) runs several blocks per SM.  A split with no key still reports
//   (m = -inf, l = 0).
// - Tensor cores.  The T*G query rows of a (slot, head) are padded to a
//   multiple of 16 (4 -> 16 at T 1, G 4; 20 -> 32 at T 5; 72 -> 80) and
//   held in shared memory as bf16, roped in fp32, pre-scaled and rounded
//   once.  Each warp owns 16 rows and a slice of the tile's keys (all 64
//   keys at 3-5 row tiles, 32 at 2, 16 at 1) with its own online-softmax
//   state, and runs mma.sync m16n8k16 bf16 -> f32 for S = Q K^T and
//   O += P V; P stays in registers between the two products.  K and V
//   tiles come in with cp.async, 16 bytes a thread, double-buffered.  The
//   quantized forms feed their integer values to the products (exact in
//   bf16: |v| <= 128); the key scale multiplies the score column after the
//   product and the value scale is folded into P before P is rounded to
//   bf16, so no fp32 dequantization pass runs.  wgmma and TMA are not used:
//   a block holds at most 80 rows, and a tile is 8-32 KB, which cp.async
//   moves as well.
// - In-launch merge.  Each warp writes its partial (m, l, acc[rows, D]) in
//   f32 to a workspace, then the block bumps a per-(slot, head) arrival
//   counter.  The last block to arrive resets the counter to 0 (no memset
//   per call; the launch can be replayed, and the next launch on the same
//   stream finds every counter at 0), merges the partials in split order
//   (the same output run to run), folds the burst's own rows with CUDA-core
//   code, writes the bf16 output and then does the appends.
// - The appends run after every split of the (slot, head) has read its
//   keys, so the int4 byte shared by token pos - 1 and pos is merged after
//   all reads of it; the bytes the burst shares with itself and with its
//   neighbours are merged in registers and stored whole by one thread.
// - Attention only (ATTN, kernel 2, T = 1): the query comes roped and is
//   used as given, the scale multiplies the scores; the keys are the cache
//   view's [window floor, min(pos, view - 1)] inclusive (the model has
//   written the step's row already), read from any slot stride; the last
//   block merges and writes the output, with no rope, quantization, own
//   term or append.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "kv_forms.cuh"
#include "tensor_tile.cuh"

namespace split_kv {

using namespace decode_tile;
using namespace kv_forms;
using namespace tensor_tile;

constexpr int MAX_ROWS = 72;          // T * G query rows per (slot, head)
constexpr int MAX_THREADS = 160;      // 5 row tiles x 1 key slice
constexpr size_t MAX_SMEM = 232448;   // bytes a block may use on an H100
constexpr int PAD = 8;                // bf16 row padding: conflict-free fragments

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
  const int* positions;        // [B] position of row 0
  __nv_bfloat16* out;          // [B, T, H, D]
  float* part_acc;             // [B*K, NP, R, D] partial accumulators
  float* part_ml;              // [B*K, NP, R, 2] partial (m, l)
  int* arrivals;               // [B*K] zero between launches
  int B, T, S, H, KH, layer, view, nsplit, split_keys;
  float scale, softcap;
  int window;
  // Attention only: each slot's cache view starts slot_stride elements
  // (bf16 or bytes) after the previous one, its scales scale_slot_stride
  // floats after.
  long long slot_stride, scale_slot_stride;
};

// Warps share a 64-key tile by key slices when the rows make few tiles.
__host__ __device__ constexpr int key_slices(int mt) {
  return mt == 1 ? 4 : (mt == 2 ? 2 : 1);
}

// Dynamic shared memory: the attention phase (q [RP, D+PAD] bf16, two
// stages of K and V tiles [64, D+PAD] bf16 — the quantized forms' byte
// stages, converted tiles and scales take no more) or the merge phase (the
// burst's five [T, D] fp32 planes and two scales per token), the larger.
__host__ __device__ constexpr size_t smem_bytes(int D, int T, int G) {
  const size_t rp = (size_t(T) * G + 15) / 16 * 16;
  const size_t attn = rp * (D + PAD) * 2 + size_t(2) * 2 * BS * (D + PAD) * 2;
  const size_t merge = (size_t(5) * T * D + 2 * size_t(T)) * 4;
  return attn > merge ? attn : merge;
}

__device__ __forceinline__ int clamp_floor(long long x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : static_cast<int>(x));
}

// The layer for one (KV head, slot, split) block.  TC is the number of new
// rows per slot when fixed at compile time (kernel 4: 1), or 0 to read it
// from a.T (kernel 5); ATTN selects the attention-only mode (kernel 2, TC
// 1).
template <int D, int FORM, int TC, bool ATTN = false>
__device__ __forceinline__ void layer(const Args a) {
  constexpr int HALF = D / 2;
  constexpr int QP = D + PAD;   // bf16 row pitch of q and the tiles
  constexpr int NT = D / 8;     // n-tiles of the output row
  constexpr int NE = (D + 31) / 32;  // elements of a row per lane (merge)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int T = TC > 0 ? TC : a.T;
  const int G = a.H / a.KH;
  const int R = T * G;
  const int MT = (R + 15) / 16;
  const int KW = key_slices(MT);
  const int NP = a.nsplit * KW;  // partials per (slot, head)
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int bk = b * a.KH + kh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;   // mma group: row (A, C) or column (B)
  const int tig = lane & 3;    // thread in group
  const int pos = a.positions[b];

  const size_t rows = FORM == INT4 ? size_t(a.S / 2) : size_t(a.S);
  const size_t pitch = size_t(a.KH) * D;  // between consecutive cache rows
  const size_t slot = size_t(a.layer) * a.B + b;
  const size_t ebytes = FORM == RAW ? 2 : 1;
  const size_t head_off =
      ATTN ? (size_t(b) * a.slot_stride + size_t(kh) * D) * ebytes
           : (slot * rows * pitch + size_t(kh) * D) * ebytes;
  const char* kb = static_cast<const char*>(a.k_cache) + head_off;
  const char* vb = static_cast<const char*>(a.v_cache) + head_off;
  const size_t scale_row0 = ATTN ? size_t(b) * a.scale_slot_stride + kh
                                 : slot * a.S * a.KH + kh;  // + position * KH

  // This split's committed keys (attention only: through pos itself).
  const int first0 = clamp_floor((long long)pos - a.window + 1, a.view);
  const int lo = max(first0, split * a.split_keys);
  const int hi = min(min(ATTN ? pos + 1 : pos, a.view), (split + 1) * a.split_keys);
  const int t_begin = (lo / BS) * BS;
  const int n_tiles = lo < hi ? (hi - t_begin + BS - 1) / BS : 0;

  // ---- attention over the split's committed keys (tensor cores) ----
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [RP, QP]
  __nv_bfloat16* stage = qs + MT * 16 * QP;  // 2 x {K, V} x [64, QP]
  // Quantized forms: the byte stages (2 x {K, V} x [64, D] bytes), the
  // converted bf16 K and V tiles, and 2 x {k, v} x [64] scales share the
  // raw form's two stages.
  unsigned char* qstage = reinterpret_cast<unsigned char*>(stage);
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(qstage + 4 * BS * D);
  float* scl = reinterpret_cast<float*>(conv + 2 * BS * QP);

  const int mt = warp % MT;      // this warp's 16-row tile
  const int kw = warp / MT;      // and key slice
  const int slice = BS / KW;     // keys per slice: 64, 32 or 16
  const int nnt = slice / 8;     // score n-tiles of the slice
  const int rA = mt * 16 + gid;  // the two rows this lane holds
  const int rB = rA + 8;
  const int firstA = clamp_floor((long long)pos + rA / G - a.window + 1, a.view);
  const int firstB = clamp_floor((long long)pos + rB / G - a.window + 1, a.view);
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  auto load_tile = [&](int k0, int buf) {
    if constexpr (FORM == RAW) {
      constexpr int CH = D / 8;  // 16-byte chunks per key row
      __nv_bfloat16* kt = stage + (buf * 2) * BS * QP;
      __nv_bfloat16* vt = kt + BS * QP;
      for (int i = tid; i < BS * CH; i += nthreads) {
        const int j = i / CH;
        const int c = (i - j * CH) * 8;
        const int kp = k0 + j;
        const bool ok = kp >= lo && kp < hi;
        const size_t off = (size_t(ok ? kp : lo) * pitch + c) * 2;
        cp_async16(kt + j * QP + c, kb + off, ok ? 16 : 0);
        cp_async16(vt + j * QP + c, vb + off, ok ? 16 : 0);
      }
    } else {
      constexpr int CH = D / 16;
      constexpr int KR = FORM == INT4 ? BS / 2 : BS;  // byte rows per tile
      unsigned char* ks = qstage + (buf * 2) * BS * D;
      unsigned char* vs = ks + BS * D;
      for (int i = tid; i < KR * CH; i += nthreads) {
        const int j = i / CH;
        const int c = (i - j * CH) * 16;
        // A byte row holds keys (FORM == INT4 ? 2j, 2j + 1 : j) of the tile.
        const int kp0 = k0 + (FORM == INT4 ? 2 * j : j);
        const int kp1 = FORM == INT4 ? kp0 + 1 : kp0;
        const bool ok = kp1 >= lo && kp0 < hi;
        const int row = FORM == INT4 ? (ok ? kp0 : lo) >> 1 : (ok ? kp0 : lo);
        const size_t off = size_t(row) * pitch + c;
        cp_async16(ks + j * D + c, kb + off, ok ? 16 : 0);
        cp_async16(vs + j * D + c, vb + off, ok ? 16 : 0);
      }
      float* ksc = scl + buf * 2 * BS;
      float* vsc = ksc + BS;
      for (int j = tid; j < BS; j += nthreads) {
        const int kp = k0 + j;
        const bool ok = kp >= lo && kp < hi;
        const size_t at = scale_row0 + size_t(ok ? kp : lo) * a.KH;
        cp_async4(ksc + j, a.k_scale + at, ok ? 4 : 0);
        cp_async4(vsc + j, a.v_scale + at, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) {
    load_tile(t_begin, 0);
    // Queries roped at pos + t, pre-scaled and rounded to bf16 once (as
    // given, attention only); the padding rows are 0.
    for (int i = tid; i < MT * 16 * HALF; i += nthreads) {
      const int r = i / HALF;
      const int dd = i - r * HALF;
      float2 v = make_float2(0.f, 0.f);
      if (r < R) {
        const int t = r / G;
        const int g = r - t * G;
        const __nv_bfloat16* qr =
            a.q + ((size_t(b) * T + t) * a.H + size_t(kh) * G + g) * D;
        if constexpr (ATTN) {
          v = make_float2(__bfloat162float(qr[dd]), __bfloat162float(qr[dd + HALF]));
        } else {
          const size_t tab = (size_t(b) * T + t) * HALF + dd;
          v = rope_f32(__bfloat162float(qr[dd]), __bfloat162float(qr[dd + HALF]),
                       a.sin_t[tab], a.cos_t[tab]);
          v.x = __fmul_rn(v.x, a.scale);
          v.y = __fmul_rn(v.y, a.scale);
        }
      }
      qs[r * QP + dd] = __float2bfloat16(v.x);
      qs[r * QP + dd + HALF] = __float2bfloat16(v.y);
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = t_begin + it * BS;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(k0 + BS, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (FORM == RAW) {
      kt = stage + (buf * 2) * BS * QP;
      vt = kt + BS * QP;
    } else {
      // Integer values to bf16 (exact), 8 elements a thread.
      const unsigned char* ks = qstage + (buf * 2) * BS * D;
      const unsigned char* vs = ks + BS * D;
      __nv_bfloat16* kc = conv;
      __nv_bfloat16* vc = conv + BS * QP;
      constexpr int C8 = D / 8;
      for (int i = tid; i < BS * C8; i += nthreads) {
        const int j = i / C8;
        const int c = (i - j * C8) * 8;
        const int src = FORM == INT4 ? (j >> 1) * D + c : j * D + c;
        const uint2 kx = *reinterpret_cast<const uint2*>(ks + src);
        const uint2 vx = *reinterpret_cast<const uint2*>(vs + src);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&kx);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&vx);
        uint32_t ko[4], vo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int k_lo = k8[2 * e], k_hi = k8[2 * e + 1];
          int v_lo = v8[2 * e], v_hi = v8[2 * e + 1];
          if constexpr (FORM == INT4) {
            k_lo = nibble(k8[2 * e], j & 1);
            k_hi = nibble(k8[2 * e + 1], j & 1);
            v_lo = nibble(v8[2 * e], j & 1);
            v_hi = nibble(v8[2 * e + 1], j & 1);
          }
          ko[e] = pack_bf16(float(k_lo), float(k_hi));
          vo[e] = pack_bf16(float(v_lo), float(v_hi));
        }
        *reinterpret_cast<uint4*>(kc + j * QP + c) = make_uint4(ko[0], ko[1], ko[2], ko[3]);
        *reinterpret_cast<uint4*>(vc + j * QP + c) = make_uint4(vo[0], vo[1], vo[2], vo[3]);
      }
      kt = kc;
      vt = vc;
      ksc = scl + buf * 2 * BS;
      vsc = ksc + BS;
      __syncthreads();
    }

    // S = Q K^T over this warp's key slice: rows mt*16.., keys kw*slice...
    const int key0 = kw * slice;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = qs + (mt * 16 + gid) * QP + kk * 16 + 2 * tig;
      const uint32_t af[4] = {ld_u32(qa), ld_u32(qa + 8 * QP), ld_u32(qa + 8),
                              ld_u32(qa + 8 * QP + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nnt) {
          const __nv_bfloat16* kr = kt + (key0 + j * 8 + gid) * QP + kk * 16 + 2 * tig;
          mma_bf16(s[j], af, ld_u32(kr), ld_u32(kr + 8));
        }
      }
    }

    // Scale, cap and mask the scores; online softmax per row (a row's
    // scores sit on the four lanes of a quad).
    float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nnt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + j * 8 + 2 * tig + (e & 1);
          const int kp = k0 + col;
          float x = s[j][e];
          if constexpr (FORM != RAW) x *= ksc[col];
          if constexpr (ATTN) x *= a.scale;
          x = soft_cap(x, a.softcap);
          const bool ok = kp >= lo && kp < hi &&
                          (e < 2 ? (rA < R && kp >= firstA) : (rB < R && kp >= firstB));
          x = ok ? x : NEG_INF;
          s[j][e] = x;
          if (e < 2) mxA = fmaxf(mxA, x); else mxB = fmaxf(mxB, x);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mA_new = fmaxf(mA, mxA);
    const float mB_new = fmaxf(mB, mxB);
    const float cA = mA == NEG_INF ? 0.f : expf(mA - mA_new);
    const float cB = mB == NEG_INF ? 0.f : expf(mB - mB_new);
    mA = mA_new;
    mB = mB_new;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nnt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = e < 2 ? mA : mB;
          const float p = s[j][e] == NEG_INF ? 0.f : expf(s[j][e] - m);
          if (e < 2) sumA += p; else sumB += p;
          // The value scale rides in P, before P is rounded to bf16.
          if constexpr (FORM != RAW) {
            s[j][e] = p * vsc[key0 + j * 8 + 2 * tig + (e & 1)];
          } else {
            s[j][e] = p;
          }
        }
      }
    }
    lA = lA * cA + sumA;
    lB = lB * cB + sumB;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= cA;
      acc[n][1] *= cA;
      acc[n][2] *= cB;
      acc[n][3] *= cB;
    }

    // O += P V: P from the score registers (16 keys per k-step).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk < nnt) {
        const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const __nv_bfloat16* v0 = vt + (key0 + kk * 16 + 2 * tig) * QP + gid;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* vp = v0 + n * 8;
          mma_bf16(acc[n], pf, pack_bits(vp[0], vp[QP]),
                   pack_bits(vp[8 * QP], vp[9 * QP]));
        }
      }
    }
    __syncthreads();  // the stages are refilled next iteration
  }

  // This warp's partial: rows rA, rB of slice (split, kw).
  {
    lA += __shfl_xor_sync(0xffffffffu, lA, 1);
    lA += __shfl_xor_sync(0xffffffffu, lA, 2);
    lB += __shfl_xor_sync(0xffffffffu, lB, 1);
    lB += __shfl_xor_sync(0xffffffffu, lB, 2);
    const size_t part = size_t(bk) * NP + size_t(split) * KW + kw;
    if (rA < R) {
      if (tig == 0)
        *reinterpret_cast<float2*>(a.part_ml + (part * R + rA) * 2) = make_float2(mA, lA);
      if (mA != NEG_INF) {
        float* dst = a.part_acc + (part * R + rA) * D + 2 * tig;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc[n][0], acc[n][1]);
      }
    }
    if (rB < R) {
      if (tig == 0)
        *reinterpret_cast<float2*>(a.part_ml + (part * R + rB) * 2) = make_float2(mB, lB);
      if (mB != NEG_INF) {
        float* dst = a.part_acc + (part * R + rB) * D + 2 * tig;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc[n][2], acc[n][3]);
      }
    }
  }

  // ---- arrival: the last block of this (slot, head) merges ----
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(a.arrivals + bk, 1);
    is_last = prev == a.nsplit - 1;
    if (is_last) a.arrivals[bk] = 0;  // every split has arrived
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  float* kn = reinterpret_cast<float*>(smem);  // [T, D] roped new keys, then ints
  float* vn = kn + T * D;       // [T, D] new values, then their int values
  float* kd = vn + T * D;       // [T, D] key of a row's own term
  float* vd = kd + T * D;       // [T, D] value as attended and as stored
  float* kst = vd + T * D;      // [T, D] key as the cache stores it
  float* ksn = kst + T * D;     // [T] scales of the new rows
  float* vsn = ksn + T;         // [T]

  // The new rows in fp32, quantized (not in the attention-only mode).
  if constexpr (!ATTN) {
    for (int i = tid; i < T * HALF; i += nthreads) {
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
    for (int i = tid; i < T * D; i += nthreads) {
      const int t = i / D;
      vn[i] = __bfloat162float(
          a.v_new[((size_t(b) * T + t) * a.KH + kh) * D + (i - t * D)]);
    }
    __syncthreads();

    // Quantize each new row (per (token, head) scale over D); warp per token.
    if constexpr (FORM != RAW) {
      constexpr float QMAX = FORM == INT4 ? 7.f : 127.f;
      for (int t = warp; t < T; t += nwarps) {
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
          ksn[t] = ks;
          vsn[t] = vs;
        }
      }
    } else {
      for (int i = tid; i < T * D; i += nthreads) {
        kd[i] = kn[i];
        vd[i] = vn[i];
        kst[i] = __bfloat162float(__float2bfloat16(kn[i]));
      }
    }
    __syncthreads();
  }

  // Merge, fold the burst, emit: warp per query row.
  for (int r = warp; r < R; r += nwarps) {
    const int t = r / G;
    const int g = r - t * G;
    const size_t part0 = size_t(bk) * NP;
    float m = NEG_INF;
    for (int p = 0; p < NP; ++p)
      m = fmaxf(m, __ldcg(a.part_ml + ((part0 + p) * R + r) * 2));
    float l = 0.f;
    float o[NE];
#pragma unroll
    for (int i = 0; i < NE; ++i) o[i] = 0.f;
    for (int p = 0; p < NP; ++p) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          a.part_ml + ((part0 + p) * R + r) * 2));
      if (ml.x == NEG_INF) continue;
      const float w = expf(ml.x - m);
      l += ml.y * w;
      const float* src = a.part_acc + ((part0 + p) * R + r) * D;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o[i] += w * __ldcg(src + d);
      }
    }
    if constexpr (!ATTN) {
      // The row's query in fp32 (roped, pre-scaled; unrounded).
      float qv[NE];
      const __nv_bfloat16* qr =
          a.q + ((size_t(b) * T + t) * a.H + size_t(kh) * G + g) * D;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int d = lane + 32 * i;
        qv[i] = 0.f;
        if (d < D) {
          const int dd = d < HALF ? d : d - HALF;
          const size_t tab = (size_t(b) * T + t) * HALF + dd;
          const float2 v = rope_f32(__bfloat162float(qr[dd]),
                                    __bfloat162float(qr[dd + HALF]), a.sin_t[tab],
                                    a.cos_t[tab]);
          qv[i] = __fmul_rn(d < HALF ? v.x : v.y, a.scale);
        }
      }
      auto fold = [&](const float* key, const float* val) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int d = lane + 32 * i;
          if (d < D) part = fmaf(qv[i], key[d], part);
        }
        const float sc = soft_cap(warp_sum(part), a.softcap);
        const float m_new = fmaxf(m, sc);
        const float c = m == NEG_INF ? 0.f : expf(m - m_new);
        const float pr = expf(sc - m_new);
        l = l * c + pr;
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          const int d = lane + 32 * i;
          if (d < D) o[i] = o[i] * c + pr * val[d];
        }
        m = m_new;
      };
      // The burst's earlier rows as the cache stores them, then row t's own.
      const int p_row = pos + t;
      const int last = min(p_row, a.view) - 1;
      const int first = clamp_floor((long long)p_row - a.window + 1, a.view);
      for (int u = 0; u < t; ++u) {
        const int kp = pos + u;
        if (kp <= last && kp >= first && (p_row - kp) < a.window)
          fold(kst + u * D, vd + u * D);
      }
      fold(kd + t * D, vd + t * D);
    }
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* dst =
        a.out + ((size_t(b) * T + t) * a.H + size_t(kh) * G + g) * D;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dst[d] = __float2bfloat16(o[i] * inv_l);
    }
  }

  if constexpr (ATTN) return;

  // The appends of this (slot, head): tokens pos .. pos + n_live - 1.
  const int n_live = max(0, min(T, a.view - pos));
  if (n_live == 0) return;
  if constexpr (FORM == RAW) {
    __nv_bfloat16* kc = static_cast<__nv_bfloat16*>(a.k_cache);
    __nv_bfloat16* vc = static_cast<__nv_bfloat16*>(a.v_cache);
    for (int i = tid; i < n_live * D; i += nthreads) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t row = (slot * rows + pos + t) * pitch + size_t(kh) * D;
      kc[row + d] = __float2bfloat16(kn[i]);
      vc[row + d] = a.v_new[((size_t(b) * T + t) * a.KH + kh) * D + d];
    }
  } else if constexpr (FORM == INT8) {
    int8_t* kc = static_cast<int8_t*>(a.k_cache);
    int8_t* vc = static_cast<int8_t*>(a.v_cache);
    for (int i = tid; i < n_live * D; i += nthreads) {
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
    for (int i = tid; i < nbytes * D; i += nthreads) {
      const int bi = b0 + i / D;
      const int d = i % D;
      const size_t at = (slot * rows + bi) * pitch + size_t(kh) * D + d;
      int ok = static_cast<uint8_t>(kc[at]);
      int ov = static_cast<uint8_t>(vc[at]);
#pragma unroll
      for (int hi_nib = 0; hi_nib < 2; ++hi_nib) {
        const int t = 2 * bi + hi_nib - pos;
        if (t < 0 || t >= n_live) continue;
        const int kq = static_cast<int>(kn[t * D + d]);
        const int vq = static_cast<int>(vn[t * D + d]);
        ok = hi_nib ? (((kq & 0x0F) << 4) | (ok & 0x0F)) : ((ok & 0xF0) | (kq & 0x0F));
        ov = hi_nib ? (((vq & 0x0F) << 4) | (ov & 0x0F)) : ((ov & 0xF0) | (vq & 0x0F));
      }
      kc[at] = static_cast<int8_t>(static_cast<uint8_t>(ok));
      vc[at] = static_cast<int8_t>(static_cast<uint8_t>(ov));
    }
  }
  if constexpr (FORM != RAW) {
    for (int t = tid; t < n_live; t += nthreads) {
      a.k_scale[scale_row0 + size_t(pos + t) * a.KH] = ksn[t];
      a.v_scale[scale_row0 + size_t(pos + t) * a.KH] = vsn[t];
    }
  }
}

// One launch of `kernel` (an instance of layer<D, FORM, ...>).
template <typename Kernel>
cudaError_t launch(Kernel kernel, int D, const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KH;
  const size_t smem = smem_bytes(D, a.T, G);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int mt = (a.T * G + 15) / 16;
  dim3 grid(a.KH, a.B, a.nsplit);
  kernel<<<grid, mt * key_slices(mt) * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance of K::kernel<D, FORM> for a runtime head dim and form.
template <class K>
cudaError_t dispatch(int D, int form, const Args& a, cudaStream_t s) {
#define SPLIT_KV_FORMS(DD)                                                   \
  case DD:                                                                   \
    switch (form) {                                                          \
      case RAW: return launch(K::template kernel<DD, RAW>(), DD, a, s);     \
      case INT8: return launch(K::template kernel<DD, INT8>(), DD, a, s);   \
      case INT4: return launch(K::template kernel<DD, INT4>(), DD, a, s);   \
      default: return cudaErrorInvalidValue;                                 \
    }
  switch (D) {
    SPLIT_KV_FORMS(16)
    SPLIT_KV_FORMS(32)
    SPLIT_KV_FORMS(64)
    SPLIT_KV_FORMS(128)
    SPLIT_KV_FORMS(256)
    default: return cudaErrorInvalidValue;
  }
#undef SPLIT_KV_FORMS
}

// The C ABIs' launch: check the arguments (T is the number of new rows per
// slot; S the cache's token count per slot, int4 planes holding S/2 byte
// rows; view <= S bounds the attended keys and parks tokens at pos + t >=
// view; form 0 raw, 1 int8, 2 int4; nsplit splits of split_keys keys, a
// multiple of 64, cover [0, view); the arrival counters [B*K] are 0 on
// entry and on exit), then launch K's instance.  Returns the cudaError_t.
template <class K>
int run(const void* q, const void* k_new, const void* v_new, void* k_cache,
        void* v_cache, void* k_scale, void* v_scale, const void* sin_t,
        const void* cos_t, const void* positions, void* out, void* part_acc,
        void* part_ml, void* arrivals, int B, int T, int S, int H, int KH,
        int D, int L, int layer, int view, int form, int nsplit,
        int split_keys, float scale, float softcap, int window,
        void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
      T * (H / KH) > MAX_ROWS || layer < 0 || layer >= L || view <= 0 ||
      view > S || window <= 0 || form < RAW || form > INT4 ||
      (form == INT4 && S % 2) || nsplit <= 0 || split_keys <= 0 ||
      split_keys % BS || static_cast<long long>(nsplit) * split_keys < view ||
      part_acc == nullptr || part_ml == nullptr || arrivals == nullptr ||
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
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.arrivals = static_cast<int*>(arrivals);
  a.B = B;
  a.T = T;
  a.S = S;
  a.H = H;
  a.KH = KH;
  a.layer = layer;
  a.view = view;
  a.nsplit = nsplit;
  a.split_keys = split_keys;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  a.slot_stride = a.scale_slot_stride = 0;
  return static_cast<int>(
      dispatch<K>(D, form, a, static_cast<cudaStream_t>(stream)));
}

}  // namespace split_kv
