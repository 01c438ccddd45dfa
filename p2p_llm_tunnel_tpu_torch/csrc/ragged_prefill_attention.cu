// Ragged grouped prefill attention on Hopper (sm_90a), one launch per layer
// for a whole admission group; bf16 in / bf16 out, fp32 softmax and
// accumulation; raw bf16, int8 or packed int4 KV cache.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_prefill_attention.py
// ragged_prefill_attention (:387, kernel body _ragged_prefill_kernel) in
// its raw, int8 and int4 KV forms.  Same function: the group's variable-length tails are flat-packed
// along one token axis, q [TOT,H,D] and new k/v [TOT,K,D] PRE-rope, the
// cache [L,B,S,K,D] written in place, and each block_q-token q-block carries
// (slot, start, qoff, base) descriptors: its row's cache slot, history
// length, offset inside the row's tail, and the row's first q-block.  Per
// q-block: rope q and the tail K at global positions start + qoff + i (fp32
// from the wrapper's rope table, rounded to bf16 as ops/rope.apply_rope
// rounds), append the block's own roped K and V rows into cache[layer, slot]
// at [start+qoff, start+qoff+block_q), and attend each query to the row's
// cache history [0, start) plus the row's own tail causally.  Scores are
// scaled, soft-capped, then masked by causality, the sliding window and row
// validity, in the order of the Pallas kernel.
//
// Quantized forms (int8 [L,B,S,K,D], or packed int4 [L,B,S/2,K,D] with token
// 2i in the low nibble of byte i; f32 scales [L,B,S,K]) follow the Pallas
// body's rounding points: history is dequantized in fp32 (value x scale) and
// rounded to bf16; the tail's keys are roped in fp32 and NOT rounded before
// they are quantized (values: v_new), scale = max(amax, 1e-8) / qmax by IEEE
// division, q = rint(x / scale) clipped to +-127 or +-7, and attention reads
// the tail's quantize -> dequantize roundtrip rounded to bf16; the append
// writes the quantized bytes (int4: whole bytes, since every start and
// block_q are even) with the scales beside them.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit:
// 989 TFLOP/s bf16, 3.35 TB/s): a group moves q, k_new, v_new, the output
// and the appended K/V once, plus the history each row reads (start x K x D
// x 2 x 2 bytes per row), and does 4 x H x D FLOPs per attended (query,
// key) pair.  At the serving shape (8 rows, TOT 1024, llama3-8b heads) it is
// bound by HBM bytes (chip_smoke.py computes both terms from the run's
// descriptors; PERF.md has the measured times).
//
// Design: the TPU kernel walks a sequential grid and carries its online
// softmax in VMEM scratch across it; blocks here run in parallel, so the
// carried state lives in one block's shared memory.  One block per
// (q-block, KV head, 64-row chunk of the q-block's G x block_q query rows):
// at block_q 16 and G 4 that is one 64-row chunk, four warps of 16 rows each
// (kernel 1's layout), so a llama3-8b group of TOT 1024 launches 64 x 8 = 512
// blocks.  History is read from the cache in 64-key tiles from the window
// floor up to the frontier `start` only (tiles at or past it are never
// loaded).  The tail is read from the flat k_new / v_new streams, roped and
// rounded to bf16 in shared memory, never from the cache: other blocks of
// the same row append to the cache during this launch, so reading the tail
// back would race (on the TPU the grid was sequential, so there it was
// safe).  Scores use bf16 wmma 16x16x16 MMAs with fp32 accumulate; P is
// rounded to bf16 for the PV product.  Pad blocks (the planner's scratch-slot
// blocks) run as one-block rows at start 0: their appends land in the
// scratch slot, as the Pallas kernel's do.  Quantized tails are quantized
// one warp per row (the amax is a warp reduction over D); only the block
// that owns the append in the raw form (the first row chunk of a q-block)
// writes it, recomputing the same quantizer, so its bytes equal the values
// its tail tile attends.  This is the simple first version: synchronous
// loads, no wgmma/TMA pipeline.
//
// C ABI (loaded with ctypes): ragged_prefill_attention_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <float.h>
#include <stdint.h>

#include "kv_forms.cuh"

using namespace nvcuda;

namespace {

constexpr int BR = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int WARPS = 4;           // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -0.7f * FLT_MAX;  // ops/attention.py _NEG_INF

using namespace kv_forms;

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 pitch of the Q/K/V tiles
  static constexpr int LDS = BK + 4;  // fp32 pitch of the score tile
  static constexpr int LDP = BK + 8;  // bf16 pitch of the probability tile
  static constexpr int LDO = D + 4;   // fp32 pitch of the output accumulator
  // Byte offsets; every region starts on a 32-byte boundary (wmma needs it).
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + size_t(BR) * LDH * 2;
  static constexpr size_t V = K + size_t(BK) * LDH * 2;
  static constexpr size_t S = V + size_t(BK) * LDH * 2;
  static constexpr size_t P = S + size_t(BR) * LDS * 4;
  static constexpr size_t O = P + size_t(BR) * LDP * 2;
  static constexpr size_t M = O + size_t(BR) * LDO * 4;
  static constexpr size_t L = M + size_t(BR) * 4;
  static constexpr size_t BYTES = L + size_t(BR) * 4;
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
  int H, KH, BQ, B, S, layer;
  float scale, softcap;
  int window;
};

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

// Rotate-half RoPE of lanes (d, d+1) and (d+D/2, d+D/2+1), the expression of
// ops/rope.apply_rope op for op (rx1 = x1*cos - x2*sin, rx2 = x2*cos +
// x1*sin, each product and sum rounded in fp32, no contraction), rounded to
// bf16 at the end as apply_rope's .to(x.dtype).
__device__ __forceinline__ void rope_pair(__nv_bfloat162& lo, __nv_bfloat162& hi,
                                          const float* sn, const float* cs) {
  const float2 x1 = __bfloat1622float2(lo);
  const float2 x2 = __bfloat1622float2(hi);
  const float r1a = __fsub_rn(__fmul_rn(x1.x, cs[0]), __fmul_rn(x2.x, sn[0]));
  const float r1b = __fsub_rn(__fmul_rn(x1.y, cs[1]), __fmul_rn(x2.y, sn[1]));
  const float r2a = __fadd_rn(__fmul_rn(x2.x, cs[0]), __fmul_rn(x1.x, sn[0]));
  const float r2b = __fadd_rn(__fmul_rn(x2.y, cs[1]), __fmul_rn(x1.y, sn[1]));
  lo = __floats2bfloat162_rn(r1a, r1b);
  hi = __floats2bfloat162_rn(r2a, r2b);
}

// Copy rows [row0, row0+64) of a [rows, pitch] plane into a shared tile;
// rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int limit, size_t pitch) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH;
    const int cc = c - r * CH;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const int4*>(src + size_t(row0 + r) * pitch + cc * 8);
    *reinterpret_cast<int4*>(dst + r * Layout<D>::LDH + cc * 8) = val;
  }
}

// Copy `n` rows of a [rows, pitch] plane starting at row0 into a shared tile
// with RoPE at positions pos0 + r (rows past n zero-filled).
template <int D>
__device__ __forceinline__ void load_rows_roped(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n, size_t pitch,
                                                int pos0, const Args& a) {
  constexpr int HALF = D / 2;
  constexpr int NP = HALF / 2;  // bf16 pairs per half
  for (int c = threadIdx.x; c < 64 * NP; c += THREADS) {
    const int r = c / NP;
    const int d = 2 * (c - r * NP);
    __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f);
    __nv_bfloat162 hi = lo;
    if (r < n) {
      const __nv_bfloat16* row = src + size_t(row0 + r) * pitch;
      lo = *reinterpret_cast<const __nv_bfloat162*>(row + d);
      hi = *reinterpret_cast<const __nv_bfloat162*>(row + d + HALF);
      const size_t t = size_t(min(pos0 + r, a.S - 1)) * HALF + d;
      rope_pair(lo, hi, a.sin_t + t, a.cos_t + t);
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + r * Layout<D>::LDH + d) = lo;
    *reinterpret_cast<__nv_bfloat162*>(dst + r * Layout<D>::LDH + d + HALF) = hi;
  }
}

// Quantized history rows [row0, row0+64) of one (slot, head) into a bf16
// tile: value x scale in fp32, rounded to bf16 (rows at or past `limit`
// zero-filled).  `base` points at the slot's byte row 0 for this head,
// `scales` at its scale of position 0; `pitch` is bytes between byte rows.
template <int D, int FORM>
__device__ __forceinline__ void load_rows_deq(__nv_bfloat16* dst,
                                              const int8_t* base,
                                              const float* scales, int row0,
                                              int limit, size_t pitch, int KH) {
  constexpr int CH = D / 8;  // 8-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH;
    const int cc = c - r * CH;
    const int pos = row0 + r;
    __align__(16) __nv_bfloat16 vals[8];
    if (pos < limit) {
      const float sc = scales[size_t(pos) * KH];
      const size_t row = FORM == INT4 ? size_t(pos >> 1) : size_t(pos);
      const int2 raw = *reinterpret_cast<const int2*>(base + row * pitch + cc * 8);
      const int8_t* by = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int x = FORM == INT4 ? nibble(by[e], pos & 1) : int(by[e]);
        vals[e] = __float2bfloat16(__fmul_rn(float(x), sc));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(0.f);
    }
    *reinterpret_cast<int4*>(dst + r * Layout<D>::LDH + cc * 8) =
        *reinterpret_cast<const int4*>(vals);
  }
}

// The cache quantizer on one new row, one warp: elements (dd, dd + D/2) for
// dd = lane + 32 i sit in v[2i], v[2i+1]; with `rope` they are roped in fp32
// at `pos` first (not rounded).  On return v holds the quantized values
// (integers in fp32) and the row's scale.
template <int D, int FORM>
__device__ __forceinline__ float quant_row(const __nv_bfloat16* src, bool rope,
                                           int pos, const Args& a,
                                           float (&v)[2 * ((D / 2 + 31) / 32)]) {
  constexpr int HALF = D / 2;
  constexpr int PER = (HALF + 31) / 32;
  constexpr float QMAX = FORM == INT4 ? 7.f : 127.f;
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int dd = lane + 32 * i;
    float x1 = 0.f, x2 = 0.f;
    if (dd < HALF) {
      x1 = __bfloat162float(src[dd]);
      x2 = __bfloat162float(src[dd + HALF]);
      if (rope) {
        const size_t t = size_t(min(pos, a.S - 1)) * HALF + dd;
        const float sn = a.sin_t[t], cs = a.cos_t[t];
        const float r1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
        const float r2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
        x1 = r1;
        x2 = r2;
      }
    }
    v[2 * i] = x1;
    v[2 * i + 1] = x2;
    amax = fmaxf(amax, fmaxf(fabsf(x1), fabsf(x2)));
  }
  amax = warp_max(amax);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), QMAX);
#pragma unroll
  for (int e = 0; e < 2 * PER; ++e)
    v[e] = fminf(fmaxf(rintf(__fdiv_rn(v[e], sc)), -QMAX), QMAX);
  return sc;
}

// `n` new rows starting at flat token row0 into a bf16 tile as their
// quantize -> dequantize roundtrip rounded to bf16 (rows past n
// zero-filled); keys roped at positions pos0 + r.  One warp per row.
template <int D, int FORM>
__device__ __forceinline__ void load_rows_quant(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n, size_t pitch,
                                                int pos0, bool rope,
                                                const Args& a) {
  constexpr int HALF = D / 2;
  constexpr int PER = (HALF + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < 64; r += WARPS) {
    __nv_bfloat16* out = dst + r * Layout<D>::LDH;
    if (r >= n) {
      for (int d = lane; d < D; d += 32) out[d] = __float2bfloat16(0.f);
      continue;
    }
    float v[2 * PER];
    const float sc = quant_row<D, FORM>(src + size_t(row0 + r) * pitch, rope,
                                        pos0 + r, a, v);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int dd = lane + 32 * i;
      if (dd < HALF) {
        out[dd] = __float2bfloat16(__fmul_rn(v[2 * i], sc));
        out[dd + HALF] = __float2bfloat16(__fmul_rn(v[2 * i + 1], sc));
      }
    }
  }
}

// The quantized APPEND of a q-block's rows [0, BQ) for one KV head: int8
// one warp per row; int4 one warp per even/odd row pair, whose nibbles make
// whole bytes.  Rows at positions >= S are skipped.
template <int D, int FORM>
__device__ __forceinline__ void append_quant(const __nv_bfloat16* src,
                                             int8_t* cache, float* scales,
                                             int tok0, int qpos0, size_t pitch,
                                             bool rope, const Args& a) {
  constexpr int HALF = D / 2;
  constexpr int PER = (HALF + 31) / 32;
  constexpr int STEP = FORM == INT4 ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp * STEP; i < a.BQ; i += WARPS * STEP) {
    const int pos = qpos0 + i;
    if (pos >= a.S) continue;
    float v0[2 * PER], v1[2 * PER];
    const float s0 = quant_row<D, FORM>(src + size_t(tok0 + i) * pitch, rope,
                                        pos, a, v0);
    float s1 = 0.f;
    if constexpr (FORM == INT4)
      s1 = quant_row<D, FORM>(src + size_t(tok0 + i + 1) * pitch, rope,
                              pos + 1, a, v1);
    const size_t row = FORM == INT4 ? size_t(pos >> 1) : size_t(pos);
    int8_t* dst = cache + row * pitch;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int dd = lane + 32 * k;
      if (dd >= HALF) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lo = static_cast<int>(v0[2 * k + hh]);
        int byte = lo;
        if constexpr (FORM == INT4)
          byte = ((static_cast<int>(v1[2 * k + hh]) & 0x0F) << 4) | (lo & 0x0F);
        dst[dd + hh * HALF] = static_cast<int8_t>(static_cast<uint8_t>(byte & 0xFF));
      }
    }
    if (lane == 0) {
      scales[size_t(pos) * a.KH] = s0;
      if constexpr (FORM == INT4) scales[size_t(pos + 1) * a.KH] = s1;
    }
  }
}

// One 64-key tile of the online softmax for this warp's 16 query rows.
// Keys sit at positions kpos0 + c; those at or past `klimit`, after a
// row's own position (causal tiles), outside the window, or seen by a row
// past the q-block's G x block_q rows are masked.
template <int D>
__device__ __forceinline__ void attend_tile(unsigned char* smem, int kpos0,
                                            int klimit, bool causal, int row0,
                                            int R, int G, int qpos0,
                                            const Args& a) {
  using LY = Layout<D>;
  const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(smem + LY::Q);
  const __nv_bfloat16* Ks = reinterpret_cast<const __nv_bfloat16*>(smem + LY::K);
  const __nv_bfloat16* Vs = reinterpret_cast<const __nv_bfloat16*>(smem + LY::V);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + LY::P);
  float* Os = reinterpret_cast<float*>(smem + LY::O);
  float* Ms = reinterpret_cast<float*>(smem + LY::M);
  float* Ls = reinterpret_cast<float*>(smem + LY::L);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // S = Q K^T for this warp's 16 rows x 64 keys.
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, Qs + warp * 16 * LY::LDH + d0, LY::LDH);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        // K stored [key][d] row-major is K^T in column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + n * 16 * LY::LDH + d0, LY::LDH);
        wmma::mma_sync(acc[n], qa, kb, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n)
      wmma::store_matrix_sync(Ss + warp * 16 * LY::LDS + n * 16, acc[n],
                              LY::LDS, wmma::mem_row_major);
  }
  __syncwarp();

  // Online softmax over this tile, row by row; lane owns keys lane, lane+32.
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int grow = row0 + r;
    const bool live = grow < R;
    const int qpos = qpos0 + grow / G;
    float sv[2];
    float mx = NEG_INF;
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      const int c = lane + 32 * c2;
      const int kpos = kpos0 + c;
      float s = Ss[r * LY::LDS + c] * a.scale;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      const bool ok = live && kpos < klimit && (!causal || kpos <= qpos) &&
                      (qpos - kpos) < a.window;
      s = ok ? s : NEG_INF;
      sv[c2] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    const float m_old = Ms[r];
    const float m_new = fmaxf(m_old, mx);
    // rows that have seen nothing stay at NEG_INF (corr 0, p 0)
    const float corr = (m_old == NEG_INF) ? 0.f : expf(m_old - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      const float p = (sv[c2] == NEG_INF) ? 0.f : expf(sv[c2] - m_new);
      psum += p;
      Ps[r * LY::LDP + lane + 32 * c2] = __float2bfloat16(p);
    }
    psum = warp_sum(psum);
    for (int c = lane; c < D; c += 32) Os[r * LY::LDO + c] *= corr;
    if (lane == 0) {
      Ms[r] = m_new;
      Ls[r] = Ls[r] * corr + psum;
    }
  }
  __syncwarp();

  // O += P V for this warp's 16 rows.
#pragma unroll
  for (int n0 = 0; n0 < D; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, Os + warp * 16 * LY::LDO + n0, LY::LDO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Ps + warp * 16 * LY::LDP + kk, LY::LDP);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, Vs + kk * LY::LDH + n0, LY::LDH);
      wmma::mma_sync(o, pa, vb, o);
    }
    wmma::store_matrix_sync(Os + warp * 16 * LY::LDO + n0, o, LY::LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

template <int D, int FORM>
__global__ void __launch_bounds__(THREADS)
ragged_prefill_kernel(const Args a) {
  using LY = Layout<D>;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + LY::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + LY::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + LY::V);
  float* Os = reinterpret_cast<float*>(smem + LY::O);
  float* Ms = reinterpret_cast<float*>(smem + LY::M);
  float* Ls = reinterpret_cast<float*>(smem + LY::L);

  const int qb = blockIdx.x;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.z * BR;
  const int G = a.H / a.KH;
  const int R = G * a.BQ;  // query rows of this (q-block, KV head)
  const int slot = a.slot_of[qb];
  const int start = a.start_of[qb];
  const int qoff = a.qoff_of[qb];
  const int base = a.base_of[qb];
  const int qpos0 = start + qoff;  // position of the q-block's first token
  const size_t kv_pitch = size_t(a.KH) * D;
  const __nv_bfloat16* kn = a.k_new + size_t(kh) * D;
  const __nv_bfloat16* vn = a.v_new + size_t(kh) * D;
  // This (slot, head)'s cache row 0, in elements (bf16 or bytes): the int4
  // planes hold S/2 byte rows per slot.
  const size_t rows = FORM == INT4 ? size_t(a.S / 2) : size_t(a.S);
  const size_t slot_idx = size_t(a.layer) * a.B + slot;
  const size_t cache_row = slot_idx * rows * kv_pitch + size_t(kh) * D;
  const size_t scale_row = slot_idx * a.S * a.KH + kh;  // + pos * KH

  // The APPEND (first row chunk only): the block's own roped K and V rows
  // into cache[layer, slot] at [qpos0, qpos0 + block_q) for this KV head.
  // Positions past the row's real length land junk that decode overwrites
  // before it is attendable; nothing in this launch reads them back.
  if (blockIdx.z == 0) {
    if constexpr (FORM == RAW) {
      __nv_bfloat16* kcache = static_cast<__nv_bfloat16*>(a.k_cache);
      __nv_bfloat16* vcache = static_cast<__nv_bfloat16*>(a.v_cache);
      constexpr int NP = HALF / 2;
      for (int c = threadIdx.x; c < a.BQ * NP; c += THREADS) {
        const int i = c / NP;
        const int d = 2 * (c - i * NP);
        const int pos = qpos0 + i;
        if (pos >= a.S) continue;
        const __nv_bfloat16* src = kn + size_t(qb * a.BQ + i) * kv_pitch;
        __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(src + d);
        __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(src + d + HALF);
        const size_t t = size_t(pos) * HALF + d;
        rope_pair(lo, hi, a.sin_t + t, a.cos_t + t);
        __nv_bfloat16* dst = kcache + cache_row + size_t(pos) * kv_pitch;
        *reinterpret_cast<__nv_bfloat162*>(dst + d) = lo;
        *reinterpret_cast<__nv_bfloat162*>(dst + d + HALF) = hi;
      }
      constexpr int CH = D / 8;
      for (int c = threadIdx.x; c < a.BQ * CH; c += THREADS) {
        const int i = c / CH;
        const int cc = c - i * CH;
        const int pos = qpos0 + i;
        if (pos >= a.S) continue;
        *reinterpret_cast<int4*>(vcache + cache_row + size_t(pos) * kv_pitch + cc * 8) =
            *reinterpret_cast<const int4*>(vn + size_t(qb * a.BQ + i) * kv_pitch + cc * 8);
      }
    } else {
      int8_t* kcache = static_cast<int8_t*>(a.k_cache) + cache_row;
      int8_t* vcache = static_cast<int8_t*>(a.v_cache) + cache_row;
      append_quant<D, FORM>(kn, kcache, a.k_scale + scale_row, qb * a.BQ,
                            qpos0, kv_pitch, true, a);
      append_quant<D, FORM>(vn, vcache, a.v_scale + scale_row, qb * a.BQ,
                            qpos0, kv_pitch, false, a);
    }
  }

  // Q tile: row r is query token (row0 + r) / G of the q-block under head
  // kh * G + (row0 + r) % G, roped at its global position.
  {
    constexpr int NP = HALF / 2;
    for (int c = threadIdx.x; c < BR * NP; c += THREADS) {
      const int r = c / NP;
      const int d = 2 * (c - r * NP);
      const int grow = row0 + r;
      __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f);
      __nv_bfloat162 hi = lo;
      if (grow < R) {
        const int i = grow / G;
        const int h = kh * G + (grow - i * G);
        const __nv_bfloat16* src = a.q + (size_t(qb * a.BQ + i) * a.H + h) * D;
        lo = *reinterpret_cast<const __nv_bfloat162*>(src + d);
        hi = *reinterpret_cast<const __nv_bfloat162*>(src + d + HALF);
        const size_t t = size_t(min(qpos0 + i, a.S - 1)) * HALF + d;
        rope_pair(lo, hi, a.sin_t + t, a.cos_t + t);
      }
      *reinterpret_cast<__nv_bfloat162*>(Qs + r * LY::LDH + d) = lo;
      *reinterpret_cast<__nv_bfloat162*>(Qs + r * LY::LDH + d + HALF) = hi;
    }
  }
  for (int i = threadIdx.x; i < BR * LY::LDO; i += THREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BR; i += THREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.f;
  }

  // Window floor: no row of this chunk attends a key before it.
  const int first_q = qpos0 + row0 / G;
  const int floor_key = max(0, first_q - a.window + 1);

  // History: cache keys [floor_key, start), 64-key tiles, frontier-clamped.
  for (int k0 = (floor_key / BK) * BK; k0 < start; k0 += BK) {
    __syncthreads();  // Q/O initialised; previous tile's K/V reads done
    if constexpr (FORM == RAW) {
      const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(a.k_cache) + cache_row;
      const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(a.v_cache) + cache_row;
      load_rows<D>(Ks, kc, k0, start, kv_pitch);
      load_rows<D>(Vs, vc, k0, start, kv_pitch);
    } else {
      const int8_t* kc = static_cast<const int8_t*>(a.k_cache) + cache_row;
      const int8_t* vc = static_cast<const int8_t*>(a.v_cache) + cache_row;
      load_rows_deq<D, FORM>(Ks, kc, a.k_scale + scale_row, k0, start, kv_pitch, a.KH);
      load_rows_deq<D, FORM>(Vs, vc, a.v_scale + scale_row, k0, start, kv_pitch, a.KH);
    }
    __syncthreads();
    attend_tile<D>(smem, k0, start, false, row0, R, G, qpos0, a);
  }

  // Tail: the row's own new K/V, flat tokens [base * BQ, (qb + 1) * BQ),
  // at positions start + j, roped (and quantized) here; causal.
  const int tail_tok0 = base * a.BQ;
  const int tail_len = (qb + 1) * a.BQ - tail_tok0;
  for (int j0 = 0; j0 < tail_len; j0 += BK) {
    if (start + j0 + BK - 1 < floor_key) continue;
    const int n = min(BK, tail_len - j0);
    __syncthreads();
    if constexpr (FORM == RAW) {
      load_rows_roped<D>(Ks, kn, tail_tok0 + j0, n, kv_pitch, start + j0, a);
      load_rows<D>(Vs, vn, tail_tok0 + j0, tail_tok0 + j0 + n, kv_pitch);
    } else {
      load_rows_quant<D, FORM>(Ks, kn, tail_tok0 + j0, n, kv_pitch, start + j0, true, a);
      load_rows_quant<D, FORM>(Vs, vn, tail_tok0 + j0, n, kv_pitch, start + j0, false, a);
    }
    __syncthreads();
    attend_tile<D>(smem, start + j0, start + tail_len, true, row0, R, G,
                   qpos0, a);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BR * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int grow = row0 + r;
    if (grow < R) {
      const int i = grow / G;
      const int h = kh * G + (grow - i * G);
      const float val = Os[r * LY::LDO + c] / fmaxf(Ls[r], 1e-30f);
      a.out[(size_t(qb * a.BQ + i) * a.H + h) * D + c] = __float2bfloat16(val);
    }
  }
}

template <int D, int FORM>
cudaError_t launch(const Args& a, int nqb, cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(Layout<D>::BYTES);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ragged_prefill_kernel<D, FORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int rows = (a.H / a.KH) * a.BQ;
  dim3 grid(nqb, a.KH, (rows + BR - 1) / BR);
  ragged_prefill_kernel<D, FORM><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_form(int form, const Args& a, int nqb, cudaStream_t stream) {
  switch (form) {
    case RAW: return launch<D, RAW>(a, nqb, stream);
    case INT8: return launch<D, INT8>(a, nqb, stream);
    case INT4: return launch<D, INT4>(a, nqb, stream);
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
    case 16: return static_cast<int>(launch_form<16>(form, a, nqb, s));
    case 32: return static_cast<int>(launch_form<32>(form, a, nqb, s));
    case 64: return static_cast<int>(launch_form<64>(form, a, nqb, s));
    case 128: return static_cast<int>(launch_form<128>(form, a, nqb, s));
    case 256: return static_cast<int>(launch_form<256>(form, a, nqb, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ragged_prefill_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
