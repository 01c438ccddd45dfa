// Ragged grouped prefill attention on Hopper (sm_90a), one launch per layer
// for a whole admission group; bf16 in / bf16 out, fp32 softmax and
// accumulation; raw bf16, int8 or packed int4 KV cache.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_prefill_attention.py
// ragged_prefill_attention (:387, pallas_call :563, kernel body
// _ragged_prefill_kernel :151) in its raw, int8 and int4 KV forms.  Same
// function: the group's variable-length tails are flat-packed along one
// token axis, q [TOT,H,D] and new k/v [TOT,K,D] PRE-rope, the cache
// [L,B,S,K,D] written in place, and each block_q-token q-block carries
// (slot, start, qoff, base) descriptors: its row's cache slot, history
// length, offset inside the row's tail, and the row's first q-block.  Per
// q-block: rope q and the tail K at global positions start + qoff + i (fp32
// from the wrapper's rope table, rounded to bf16 as ops/rope.apply_rope
// rounds), append the block's own roped K and V rows into cache[layer, slot]
// at [start+qoff, start+qoff+block_q), and attend each query to the row's
// cache history [0, start) plus the row's own tail causally.  Scores are
// scaled, soft-capped, then masked by causality and the sliding window, in
// the order of the Pallas kernel.
//
// Quantized forms (int8 [L,B,S,K,D], or packed int4 [L,B,S/2,K,D] with token
// 2i in the low nibble of byte i; f32 scales [L,B,S,K]).  The appended bytes
// and scales follow the Pallas body's rounding points bit for bit: the
// tail's keys are roped in fp32 and NOT rounded before they are quantized
// (values: v_new), scale = max(amax, 1e-8) / qmax by IEEE division, q =
// rint(x / scale) (half to even) clipped to +-127 or +-7, int4 appends
// written as whole bytes (every start and block_q are even).  The attention
// takes another order than the Pallas body's "dequantize in fp32, round to
// bf16, then multiply": history and tail alike feed their integer values
// to the bf16 products (exact: |v| <= 127), the key scale multiplies the
// score column after the product and the value scale rides in P before P
// is rounded to bf16, as the split-KV decode body does (split_kv_layer.cuh).
// The plain version keeps the Pallas order; the two agree within the
// kernels' tolerance, not bitwise.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit:
// 989 TFLOP/s bf16, 3.35 TB/s): a group moves q, k_new, v_new, the output
// and the appended K/V once, plus the history each row reads (start x K x D
// x 2 x 2 bytes per row), and does 4 x H x D FLOPs per attended (query,
// key) pair.  At the serving shape (8 rows, TOT 1024, llama3-8b heads) it is
// bound by HBM bytes (chip_smoke.py computes both terms from the run's
// descriptors; PERF.md has the measured times).  What bounds a launch in
// practice is the chain of tiles one block walks and how often a row's
// history is read again.
//
// Design (kernel 1's tile loop, flash_causal_attention.cu, over the history
// and then the tail):
// - A block's query tile spans qpt consecutive q-blocks of one row (qpt =
//   rows / (block_q x G): 2 at llama3-8b's G 4 and block_q 16), so a row's
//   history is read once per (query tile, KV head), not once per q-block.
//   The grid stays (q-block, KV head, row chunk), computable from the
//   launch's shape alone (no copy of the descriptors to the host): the
//   block of a tile's first q-block (qoff / block_q a multiple of qpt) runs
//   the tile, taking the following q-blocks with the same base; the others
//   return at once.  Pad blocks (the planner's scratch-slot blocks) are
//   one-block rows of their own and append into the scratch slot, as the
//   Pallas kernel's do.
// - 128 query rows per block (64 at D 256, for shared memory), 16 per warp:
//   row r is token r / G of the tile under head kh * G + r % G, so the G
//   heads of a KV head share every K/V tile.  S, P and O stay in registers:
//   mma.sync m16n8k16 bf16 -> fp32 with ldmatrix fragments, P repacked from
//   the S accumulators, softmax in log2 units (exp2f).
// - One barrier per tile, K/V double-buffered.  History tiles come from the
//   cache by cp.async, 16 bytes a thread (quantized: the bytes and scales,
//   the integers converted to bf16 by the thread that copied them, before
//   the barrier).  Tail tiles are built from the flat k_new / v_new streams
//   in the tile's shared stage (K roped, quantized forms quantized; raw V
//   by cp.async), never read back from the cache: other blocks of the same
//   row append to it during this launch.  The next tile's load starts
//   right after the barrier and overlaps this tile's products.
// - Masks only where needed: a history tile pays the compares when it
//   reaches the row's start (the history -> tail seam) or crosses the
//   window's edge, a tail tile on the causal diagonal or the window's edge;
//   the soft cap (tanhf) runs only when it is set.  Rows that see no key
//   (padding rows past the tile's tokens) emit 0.
// - The append (row chunk 0 only): the tile's own roped K and V rows, in the
//   cache's form, before the loop (the first tile's copy is in flight).
//   wgmma and TMA are not used: at these shapes a block walks 1-10 tiles and
//   is bound by latency and bytes, not the tensor cores.
//
// C ABI (loaded with ctypes): ragged_prefill_attention_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "kv_forms.cuh"
#include "tensor_tile.cuh"

namespace {

using namespace kv_forms;
using namespace tensor_tile;
using decode_tile::NEG_INF;

constexpr int BK = 64;             // keys per tile
constexpr int PAD = 8;             // bf16 row padding: conflict-free ldmatrix
constexpr float LOG2E = 1.4426950408889634f;

// Query rows per block: 8 warps of 16 rows; 4 warps at D 256, where two K/V
// stages of 64 x 264 bf16 take 132 KB.
__host__ __device__ constexpr int block_rows(int D) { return D > 128 ? 64 : 128; }

template <int D>
struct Layout {
  static constexpr int BR = block_rows(D);
  static constexpr int WARPS = BR / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int P = D + PAD;  // bf16 pitch of the q/K/V tiles
  static constexpr size_t TILE = size_t(BK) * P * 2;
  // Byte offsets; every region starts on a 16-byte boundary.
  static constexpr size_t Q = 0;
  static constexpr size_t KV = Q + size_t(BR) * P * 2;  // 2 stages x {K, V}
  static constexpr size_t SC = KV + 4 * TILE;           // 2 stages x {k, v} x BK f32
  static constexpr size_t BYTES = SC + 4 * BK * 4;      // quantized: a K and V byte tile
  // Bytes per block: the byte stage holds BK rows of D bytes per plane for
  // int8, BK/2 for int4 (so at D 128 raw and int4 blocks fit two per SM).
  static constexpr size_t smem(int form) {
    return BYTES + (form == RAW ? 0 : 2 * size_t(form == INT4 ? BK / 2 : BK) * D);
  }
};

struct Args {
  const __nv_bfloat16* q;        // [TOT, H, D]
  const __nv_bfloat16* k_new;    // [TOT, K, D]
  const __nv_bfloat16* v_new;    // [TOT, K, D]
  void* k_cache;                 // [L, B, S, K, D] bf16/int8 | [L,B,S/2,K,D]
  void* v_cache;
  float* k_scale;                // [L, B, S, K] (quantized forms)
  float* v_scale;
  const float* sin_t;            // [S, D/2]
  const float* cos_t;            // [S, D/2]
  const int* slot_of;            // [NQB]
  const int* start_of;
  const int* qoff_of;
  const int* base_of;
  __nv_bfloat16* out;            // [TOT, H, D]
  int nqb, H, KH, BQ, B, S, layer, qpt;
  float scale, softcap;
  int window;
};

// Rows of new tokens, D/16 neighbouring lanes per row: lane c of a row
// holds its elements [8c, 8c + 8) and their rope partners [D/2 + 8c,
// D/2 + 8c + 8) in x[0..8) and x[8..16), as fp32 (with `rope`, roped at
// `pos` by decode_tile.cuh's rotate-half rope, the expression of
// ops/rope.apply_rope op for op, not rounded), loaded 16 bytes at a time so
// that a pass over the rows waits for one load latency.
template <int D>
__device__ __forceinline__ void load16(const __nv_bfloat16* row, int c,
                                       bool rope, int pos, const Args& a,
                                       float (&x)[16]) {
  constexpr int HALF = D / 2;
  const uint4 lo = *reinterpret_cast<const uint4*>(row + 8 * c);
  const uint4 hi = *reinterpret_cast<const uint4*>(row + HALF + 8 * c);
  const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fl = __bfloat1622float2(l2[e]);
    const float2 fh = __bfloat1622float2(h2[e]);
    x[2 * e] = fl.x;
    x[2 * e + 1] = fl.y;
    x[8 + 2 * e] = fh.x;
    x[8 + 2 * e + 1] = fh.y;
  }
  if (rope) {
    const size_t t = size_t(min(pos, a.S - 1)) * HALF + 8 * c;
    const float4* sn = reinterpret_cast<const float4*>(a.sin_t + t);
    const float4* cs = reinterpret_cast<const float4*>(a.cos_t + t);
    const float4 s4[2] = {sn[0], sn[1]};
    const float4 c4[2] = {cs[0], cs[1]};
    const float* sv = reinterpret_cast<const float*>(s4);
    const float* cv = reinterpret_cast<const float*>(c4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float2 r = decode_tile::rope_f32(x[e], x[8 + e], sv[e], cv[e]);
      x[e] = r.x;
      x[8 + e] = r.y;
    }
  }
}

// x[0..8) and x[8..16) rounded to bf16 (apply_rope's .to(x.dtype)) into
// elements [8c, 8c + 8) and [D/2 + 8c, D/2 + 8c + 8) of `row`.
template <int D>
__device__ __forceinline__ void store16(__nv_bfloat16* row, int c, const float* x) {
  constexpr int HALF = D / 2;
  *reinterpret_cast<uint4*>(row + 8 * c) =
      make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                 pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  *reinterpret_cast<uint4*>(row + HALF + 8 * c) =
      make_uint4(pack_bf16(x[8], x[9]), pack_bf16(x[10], x[11]),
                 pack_bf16(x[12], x[13]), pack_bf16(x[14], x[15]));
}

// The row's scale from its amax over its D/16 lanes, and x quantized in
// place (integers in fp32): decode_tile.cuh's quantizer (its exact fast
// path), the plain version's bit for bit.  Every lane of the warp must call
// it.
template <int D, int FORM>
__device__ __forceinline__ float quant16(float (&x)[16]) {
  constexpr float QMAX = FORM == INT4 ? 7.f : 127.f;
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(x[e]));
#pragma unroll
  for (int off = 1; off < D / 16; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = decode_tile::quant_scale(m, QMAX);
  const float inv = __frcp_rn(sc);
#pragma unroll
  for (int e = 0; e < 16; ++e) x[e] = decode_tile::quant_value_fast(x[e], sc, inv, QMAX);
  return sc;
}

// 8 integer values (|v| <= 127) as 8 bytes, or as the low (odd = 0) or high
// nibbles of 8 bytes.
__device__ __forceinline__ uint2 pack8(const float* v) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e >> 2] |= (static_cast<uint32_t>(static_cast<int>(v[e])) & 0xFFu) << (8 * (e & 3));
  return make_uint2(w[0], w[1]);
}

template <int D, int FORM>
__global__ void __launch_bounds__(Layout<D>::THREADS)
ragged_prefill_kernel(const Args a) {
  using LY = Layout<D>;
  constexpr int BR = LY::BR;
  constexpr int THREADS = LY::THREADS;
  constexpr int P = LY::P;
  constexpr int HALF = D / 2;
  constexpr int NT = D / 8;          // n-tiles of an output row
  constexpr int CH = D / 8;          // 16-byte bf16 chunks per row
  constexpr bool QUANT = FORM != RAW;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + LY::Q);
  __nv_bfloat16* kvs = reinterpret_cast<__nv_bfloat16*>(smem + LY::KV);
  float* scs = reinterpret_cast<float*>(smem + LY::SC);
  unsigned char* bys = smem + LY::BYTES;

  const int qb = blockIdx.x;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.z * BR;
  const int qoff = a.qoff_of[qb];
  // Only a tile's first q-block runs it: the tile is that q-block and the
  // following ones of the same row (same base), at most qpt of them.
  if ((qoff / a.BQ) % a.qpt != 0) return;
  const int base = a.base_of[qb];
  int nq = 1;
  while (nq < a.qpt && qb + nq < a.nqb && a.base_of[qb + nq] == base) ++nq;
  const int G = a.H / a.KH;
  const int n_tok = nq * a.BQ;   // the tile's tokens
  const int R = n_tok * G;       // and its query rows
  if (row0 >= R) return;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // mma group: row (A, C) or column (B)
  const int tig = lane & 3;   // thread in group
  constexpr int TPR = D / 16;  // lanes per new row (load16)
  const int tc = tid % TPR;   // this lane's 8-element column chunk of a row

  const int slot = a.slot_of[qb];
  const int start = a.start_of[qb];
  const int qpos0 = start + qoff;         // position of the tile's first token
  const int tok0 = qb * a.BQ;             // its flat index
  const int row_tok0 = base * a.BQ;       // flat index of the row's first tail token
  const size_t kv_pitch = size_t(a.KH) * D;
  const __nv_bfloat16* kn = a.k_new + size_t(kh) * D;
  const __nv_bfloat16* vn = a.v_new + size_t(kh) * D;
  // This (slot, head)'s cache row 0, in elements (bf16 or bytes): the int4
  // planes hold S/2 byte rows per slot.
  const size_t rows = FORM == INT4 ? size_t(a.S / 2) : size_t(a.S);
  const size_t slot_idx = size_t(a.layer) * a.B + slot;
  const size_t cache_row = slot_idx * rows * kv_pitch + size_t(kh) * D;
  const size_t scale_row = slot_idx * a.S * a.KH + kh;  // + pos * KH

  // The chunk's first and last query tokens (relative to the tile), the
  // window floor no row of it reaches below, and the tiles: history keys
  // [floor, start) from the cache, then tail offsets [0, tail_end) from the
  // flat streams (keys past the chunk's last query are never attended).
  const int i_first = row0 / G;
  const int i_last = (min(R, row0 + BR) - 1) / G;
  const int q_first = qpos0 + i_first;
  const int q_last = qpos0 + i_last;
  const int floor_key = max(0, q_first - a.window + 1);
  const int hist_begin = (min(floor_key, start) / BK) * BK;
  const int n_hist = floor_key < start ? (start - hist_begin + BK - 1) / BK : 0;
  const int tail_end = qoff + i_last + 1;
  const int tail_begin = (max(0, floor_key - start) / BK) * BK;
  const int n_tiles = n_hist + (tail_end - tail_begin + BK - 1) / BK;

  // ---- loaders: tile `it` into stage `buf` ----
  auto start_tile = [&](int it, int buf) {
    __nv_bfloat16* kt = kvs + (buf * 2) * BK * P;
    __nv_bfloat16* vt = kt + BK * P;
    float* ksc = scs + buf * 2 * BK;
    float* vsc = ksc + BK;
    if (it < n_hist) {
      const int k0 = hist_begin + it * BK;
      if constexpr (FORM == RAW) {
        const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(a.k_cache) + cache_row;
        const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(a.v_cache) + cache_row;
        for (int c = tid; c < BK * CH; c += THREADS) {
          const int r = c / CH;
          const int cc = (c - r * CH) * 8;
          const bool ok = k0 + r < start;
          const size_t off = size_t(ok ? k0 + r : 0) * kv_pitch + cc;
          cp_async16(kt + r * P + cc, kc + off, ok ? 16 : 0);
          cp_async16(vt + r * P + cc, vc + off, ok ? 16 : 0);
        }
      } else {
        // Bytes into the byte stage (converted by the same thread at the
        // top of the tile's iteration), scales into the stage.
        constexpr int C16 = D / 16;
        constexpr int KR = FORM == INT4 ? BK / 2 : BK;  // byte rows per tile
        const int8_t* kc = static_cast<const int8_t*>(a.k_cache) + cache_row;
        const int8_t* vc = static_cast<const int8_t*>(a.v_cache) + cache_row;
        for (int c = tid; c < KR * C16; c += THREADS) {
          const int j = c / C16;
          const int cc = (c - j * C16) * 16;
          // Byte row j holds keys k0 + 2j, k0 + 2j + 1 (int4; start is even)
          // or key k0 + j.
          const int kp = k0 + (FORM == INT4 ? 2 * j : j);
          const bool ok = kp < start;
          const size_t off = size_t(ok ? (FORM == INT4 ? kp >> 1 : kp) : 0) * kv_pitch + cc;
          cp_async16(bys + j * D + cc, kc + off, ok ? 16 : 0);
          cp_async16(bys + (KR + j) * D + cc, vc + off, ok ? 16 : 0);
        }
        for (int j = tid; j < BK; j += THREADS) {
          const bool ok = k0 + j < start;
          const size_t at = scale_row + size_t(ok ? k0 + j : 0) * a.KH;
          cp_async4(ksc + j, a.k_scale + at, ok ? 4 : 0);
          cp_async4(vsc + j, a.v_scale + at, ok ? 4 : 0);
        }
      }
      cp_async_commit();
      return;
    }
    // A tail tile: offsets j0 + c of the row's tail, flat tokens row_tok0 +
    // j0 + c, positions start + j0 + c; rows at or past tail_end are 0.
    const int j0 = tail_begin + (it - n_hist) * BK;
    if constexpr (FORM == RAW) {
      // Keys roped and rounded to bf16, D/16 lanes per row; values by
      // cp.async.
#pragma unroll
      for (int r0 = 0; r0 < BK; r0 += THREADS / TPR) {
        const int r = r0 + tid / TPR;
        if (r >= BK) break;
        float x[16] = {};
        if (j0 + r < tail_end)
          load16<D>(kn + size_t(row_tok0 + j0 + r) * kv_pitch, tc, true,
                    start + j0 + r, a, x);
        store16<D>(kt + r * P, tc, x);
      }
      for (int c = tid; c < BK * CH; c += THREADS) {
        const int r = c / CH;
        const int cc = (c - r * CH) * 8;
        const bool ok = j0 + r < tail_end;
        cp_async16(vt + r * P + cc,
                   vn + size_t(row_tok0 + (ok ? j0 + r : 0)) * kv_pitch + cc,
                   ok ? 16 : 0);
      }
      cp_async_commit();
    } else {
      // D/16 lanes per row: the rows' quantized integers (as bf16) and
      // scales, the values the append stores.  Every lane runs every pass
      // (the quantizer's shuffles).
#pragma unroll
      for (int r0 = 0; r0 < BK; r0 += THREADS / TPR) {
        const int r = r0 + tid / TPR;
        const bool live = r < BK;
        float kx[16], vx[16];
        if (live && j0 + r < tail_end) {
          const size_t tok = size_t(row_tok0 + j0 + r) * kv_pitch;
          load16<D>(kn + tok, tc, true, start + j0 + r, a, kx);
          load16<D>(vn + tok, tc, false, 0, a, vx);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) kx[e] = vx[e] = 0.f;
        }
        const float ks = quant16<D, FORM>(kx);
        const float vs = quant16<D, FORM>(vx);
        if (!live) continue;
        store16<D>(kt + r * P, tc, kx);
        store16<D>(vt + r * P, tc, vx);
        if (tc == 0) {
          ksc[r] = ks;
          vsc[r] = vs;
        }
      }
    }
  };

  // The integers of this thread's own history chunks to bf16 (exact), into
  // stage `buf`: after its copies landed, before the tile's barrier.
  auto convert_tile = [&](int buf) {
    if constexpr (QUANT) {
      constexpr int C16 = D / 16;
      constexpr int KR = FORM == INT4 ? BK / 2 : BK;
      __nv_bfloat16* kt = kvs + (buf * 2) * BK * P;
      for (int c = tid; c < KR * C16; c += THREADS) {
        const int j = c / C16;
        const int cc = (c - j * C16) * 16;
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          const uint4 raw = *reinterpret_cast<const uint4*>(bys + (plane * KR + j) * D + cc);
          const int8_t* by = reinterpret_cast<const int8_t*>(&raw);
          __nv_bfloat16* dst = kt + plane * BK * P;
#pragma unroll
          for (int half = 0; half < (FORM == INT4 ? 2 : 1); ++half) {
            uint32_t w[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              int x0 = by[2 * e], x1 = by[2 * e + 1];
              if constexpr (FORM == INT4) {
                x0 = nibble(by[2 * e], half);
                x1 = nibble(by[2 * e + 1], half);
              }
              w[e] = pack_bf16(float(x0), float(x1));
            }
            const int r = FORM == INT4 ? 2 * j + half : j;
            uint4* o = reinterpret_cast<uint4*>(dst + r * P + cc);
            o[0] = make_uint4(w[0], w[1], w[2], w[3]);
            o[1] = make_uint4(w[4], w[5], w[6], w[7]);
          }
        }
      }
    }
  };

  start_tile(0, 0);

  // The APPEND (row chunk 0 only): the tile's own roped K and V rows into
  // cache[layer, slot] at [qpos0, qpos0 + n_tok) for this KV head.
  // Positions past the row's real length land junk that decode overwrites
  // before it is attendable; nothing in this launch reads them back.
  if (blockIdx.z == 0) {
    if constexpr (FORM == RAW) {
      __nv_bfloat16* kcache = static_cast<__nv_bfloat16*>(a.k_cache);
      __nv_bfloat16* vcache = static_cast<__nv_bfloat16*>(a.v_cache);
      for (int r0 = 0; r0 < n_tok; r0 += THREADS / TPR) {
        const int i = r0 + tid / TPR;
        const int pos = qpos0 + i;
        if (i >= n_tok || pos >= a.S) continue;
        float x[16];
        load16<D>(kn + size_t(tok0 + i) * kv_pitch, tc, true, pos, a, x);
        store16<D>(kcache + cache_row + size_t(pos) * kv_pitch, tc, x);
      }
      for (int c = tid; c < n_tok * CH; c += THREADS) {
        const int i = c / CH;
        const int cc = c - i * CH;
        const int pos = qpos0 + i;
        if (pos >= a.S) continue;
        *reinterpret_cast<int4*>(vcache + cache_row + size_t(pos) * kv_pitch + cc * 8) =
            *reinterpret_cast<const int4*>(vn + size_t(tok0 + i) * kv_pitch + cc * 8);
      }
    } else {
      // D/16 lanes per row, every lane in every pass (the shuffles); int4:
      // the odd row's nibbles come from the lanes one row up (the same
      // warp), and the even row's lanes store the whole bytes.  Rows at
      // positions >= S are skipped (S is even).
      int8_t* caches[2] = {static_cast<int8_t*>(a.k_cache) + cache_row,
                           static_cast<int8_t*>(a.v_cache) + cache_row};
      float* scales[2] = {a.k_scale + scale_row, a.v_scale + scale_row};
      for (int r0 = 0; r0 < n_tok; r0 += THREADS / TPR) {
        const int r = r0 + tid / TPR;
        const int pos = qpos0 + r;
        float x[2][16];
        if (r < n_tok) {
          load16<D>(kn + size_t(tok0 + r) * kv_pitch, tc, true, pos, a, x[0]);
          load16<D>(vn + size_t(tok0 + r) * kv_pitch, tc, false, 0, a, x[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) x[0][e] = x[1][e] = 0.f;
        }
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          const float sc = quant16<D, FORM>(x[plane]);
          uint2 lo = pack8(x[plane]);
          uint2 hi = pack8(x[plane] + 8);
          if constexpr (FORM == INT4) {
            // Nibbles: this row's low, the next row's high (even rows).
            const uint2 nlo = make_uint2(__shfl_down_sync(0xffffffffu, lo.x, TPR),
                                         __shfl_down_sync(0xffffffffu, lo.y, TPR));
            const uint2 nhi = make_uint2(__shfl_down_sync(0xffffffffu, hi.x, TPR),
                                         __shfl_down_sync(0xffffffffu, hi.y, TPR));
            lo = make_uint2((lo.x & 0x0F0F0F0Fu) | ((nlo.x & 0x0F0F0F0Fu) << 4),
                            (lo.y & 0x0F0F0F0Fu) | ((nlo.y & 0x0F0F0F0Fu) << 4));
            hi = make_uint2((hi.x & 0x0F0F0F0Fu) | ((nhi.x & 0x0F0F0F0Fu) << 4),
                            (hi.y & 0x0F0F0F0Fu) | ((nhi.y & 0x0F0F0F0Fu) << 4));
          }
          if (r >= n_tok || pos >= a.S) continue;
          if (tc == 0) scales[plane][size_t(pos) * a.KH] = sc;
          if (FORM == INT4 && (r & 1)) continue;
          int8_t* dst = caches[plane] + size_t(FORM == INT4 ? pos >> 1 : pos) * kv_pitch;
          *reinterpret_cast<uint2*>(dst + 8 * tc) = lo;
          *reinterpret_cast<uint2*>(dst + HALF + 8 * tc) = hi;
        }
      }
    }
  }

  // Q tile: row r is token (row0 + r) / G of the tile under head kh * G +
  // (row0 + r) % G, roped at its global position and rounded to bf16; rows
  // past the tile are 0.
#pragma unroll
  for (int r0 = 0; r0 < BR; r0 += THREADS / TPR) {
    const int r = r0 + tid / TPR;
    if (r >= BR) break;
    const int grow = row0 + r;
    float x[16] = {};
    if (grow < R) {
      const int i = grow / G;
      const int h = kh * G + (grow - i * G);
      load16<D>(a.q + (size_t(tok0 + i) * a.H + h) * D, tc, true, qpos0 + i, a, x);
    }
    store16<D>(qs + r * P, tc, x);
  }

  const int rA = row0 + warp * 16 + gid;  // the two rows this lane holds
  const int rB = rA + 8;
  const int qposA = qpos0 + rA / G;
  const int qposB = qpos0 + rB / G;
  const float sl2 = a.scale * LOG2E;
  const float cap_in = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
  const float cap_l2 = a.softcap * LOG2E;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;  // log2 units
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool hist = it < n_hist;
    cp_async_wait<0>();
    if (hist) convert_tile(buf);
    // The one barrier of the tile: its K/V (and q) in place for every
    // thread, every warp done with the other stage.
    __syncthreads();
    if (it + 1 < n_tiles) start_tile(it + 1, buf ^ 1);
    const __nv_bfloat16* kt = kvs + (buf * 2) * BK * P;
    const __nv_bfloat16* vt = kt + BK * P;
    const float* ksc = scs + buf * 2 * BK;
    const float* vsc = ksc + BK;
    // Key positions of the tile, the keys below `klimit` only.
    const int kp0 = hist ? hist_begin + it * BK
                         : start + tail_begin + (it - n_hist) * BK;
    const int klimit = hist ? start : 0x7fffffff;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, qs + (warp * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], af, bf[0], bf[1]);
        mma_bf16(s[2 * j2 + 1], af, bf[2], bf[3]);
      }
    }

    // Key scales (quantized), then scale (and cap) into log2 units; mask
    // only the tiles that need it.
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= ksc[j * 8 + 2 * tig + (e & 1)];
    }
    if (a.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = cap_l2 * tanhf(s[j][e] * cap_in);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    }
    const bool need_mask = kp0 + BK > klimit || kp0 + BK - 1 > q_first ||
                           q_last - kp0 >= a.window;
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kp0 + j * 8 + 2 * tig + (e & 1);
          const int qp = e < 2 ? qposA : qposB;
          if (!(kp < klimit && kp <= qp && qp - kp < a.window)) s[j][e] = NEG_INF;
        }
      }
    }

    // Online softmax; a row that has seen no key keeps m = NEG_INF and
    // takes its exponentials from base 0, which sends the sentinel to 0.
    float mxA = NEG_INF, mxB = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mxA = fmaxf(mxA, fmaxf(s[j][0], s[j][1]));
      mxB = fmaxf(mxB, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mA_new = fmaxf(mA, mxA);
    const float mB_new = fmaxf(mB, mxB);
    const float baseA = mA_new == NEG_INF ? 0.f : mA_new;
    const float baseB = mB_new == NEG_INF ? 0.f : mB_new;
    const float cA = exp2f(mA - baseA);
    const float cB = exp2f(mB - baseB);
    mA = mA_new;
    mB = mB_new;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - baseA);
      s[j][1] = exp2f(s[j][1] - baseA);
      s[j][2] = exp2f(s[j][2] - baseB);
      s[j][3] = exp2f(s[j][3] - baseB);
      sumA += s[j][0] + s[j][1];
      sumB += s[j][2] + s[j][3];
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
    // The value scale rides in P (quantized), before P is rounded to bf16.
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vsc[j * 8 + 2 * tig + (e & 1)];
    }

    // O += P V: P from the score registers, 16 keys per k-step; V's
    // fragments through ldmatrix.trans, two n-tiles per load.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 15)) * P + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pf, bv[2], bv[3]);
      }
    }
  }

  // Normalise; rows that saw no key have acc = 0 and l = 0 and emit 0.
  // (n_tiles >= 1: the tail tile of the chunk's first query always runs,
  // so every copy, q's too, was waited for behind a barrier.)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float iA = 1.f / fmaxf(lA, 1e-30f);
  const float iB = 1.f / fmaxf(lB, 1e-30f);
  // The output leaves through this warp's own q rows (no other warp reads
  // them), as 16-byte stores.
  __syncwarp();
  __nv_bfloat16* os = qs + warp * 16 * P;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(os + gid * P + n * 8 + 2 * tig) =
        pack_bf16(acc[n][0] * iA, acc[n][1] * iA);
    *reinterpret_cast<uint32_t*>(os + (gid + 8) * P + n * 8 + 2 * tig) =
        pack_bf16(acc[n][2] * iB, acc[n][3] * iB);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const int grow = row0 + warp * 16 + r;
    if (grow < R) {
      const int t = grow / G;
      const int h = kh * G + (grow - t * G);
      *reinterpret_cast<int4*>(a.out + (size_t(tok0 + t) * a.H + h) * D + c) =
          *reinterpret_cast<const int4*>(os + r * P + c);
    }
  }
}

template <int D, int FORM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(Layout<D>::smem(FORM));
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ragged_prefill_kernel<D, FORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int tile_rows = a.qpt * a.BQ * (a.H / a.KH);
  dim3 grid(a.nqb, a.KH, (tile_rows + Layout<D>::BR - 1) / Layout<D>::BR);
  ragged_prefill_kernel<D, FORM><<<grid, Layout<D>::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(int form, Args a, cudaStream_t stream) {
  // q-blocks per query tile: as many as fill the block's rows.
  a.qpt = max(1, Layout<D>::BR / (a.BQ * (a.H / a.KH)));
  switch (form) {
    case RAW: return launch<D, RAW>(a, stream);
    case INT8: return launch<D, INT8>(a, stream);
    case INT4: return launch<D, INT4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// S is the cache's token count per slot (int4 planes hold S/2 byte rows);
// form 0 raw, 1 int8, 2 int4.
extern "C" int ragged_prefill_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* sin_t,
    const void* cos_t, const void* slot_of, const void* start_of,
    const void* qoff_of, const void* base_of, void* out, int nqb, int H,
    int KH, int D, int BQ, int B, int S, int layer, int form, float scale,
    float softcap, int window, void* stream) {
  if (nqb <= 0 || KH <= 0 || H % KH != 0 || BQ <= 0 || B <= 0 || S <= 0 ||
      S % BQ != 0 || window <= 0 || layer < 0 || form < RAW || form > INT4 ||
      nqb > 2147483647 / BQ || KH > 65535 ||
      (form == INT4 && (BQ % 2 || S % 2)) ||
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
  a.slot_of = static_cast<const int*>(slot_of);
  a.start_of = static_cast<const int*>(start_of);
  a.qoff_of = static_cast<const int*>(qoff_of);
  a.base_of = static_cast<const int*>(base_of);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.nqb = nqb;
  a.H = H;
  a.KH = KH;
  a.BQ = BQ;
  a.B = B;
  a.S = S;
  a.layer = layer;
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

extern "C" const char* ragged_prefill_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
