// Dequant-fused weight matmul on Hopper (sm_90a): y [M,N] = x [M,K] @ W,
// W quantized — int8 with one f32 scale per output channel (weight-only or
// W8A8), or packed int4 with one f32 scale per (group, output channel).
//
// Stands for: no pallas_call.  It is the card's counterpart of what XLA fuses
// on the TPU in p2p_llm_tunnel_tpu/models/quant.py: `mm` (:298), with
// `_dequant4` (:246) in the operand for int4 and the scale after the dot for
// int8, `_int8_dot` (:283) for W8A8, and `head_matmul` (:336).  Dequantizing
// into a bf16 copy and calling a library GEMM would write and re-read that
// copy (3x the packed bytes); here only the packed bytes and scales cross
// HBM.  Each form rounds where the reference rounds (the plain version,
// ops/quant_matmul.plain, follows its expression op for op):
// - INT8:  y = bf16(sum_k x*q) in f32;  out = bf16(y * bf16(scale[n]))
// - INT4:  w = bf16(f32(nibble) * scale[group, n]) BEFORE the product;
//          out = bf16(sum_k x*w) in f32
// - W8A8:  x arrives quantized per token (int8 + f32 scale [M]);
//          acc = sum_k xq*q in int32 (exact);
//          out = bf16(f32(acc) * xs[m] * scale[n]), each product rounded in f32
// Layouts: KN, W [K, N] (int8) or [Kp/2, N] bytes (int4, byte i holds k = 2i
// in the low nibble and 2i+1 in the high) with scales [N] / [G, N] — the
// block projections and an untied lm_head; NK, W [N, K] or [N, Kp/2] with
// scales [N] / [N, G] — a tied head over the [V, dm] embedding.  Contracted
// positions past K (int4 padding, ragged slabs) meet zero activations.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit:
// 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8): the packed weight bytes and
// scales plus x and y, against 2*M*N*K operations.  At decode (M 17) every
// projection is far below the ridge — the weight stream bounds it (llama3-8b
// int4 g128: w_gate ~31 MB, 9.3 us; lm_head ~279 MB, 83 us); at M 1024 the
// tensor cores do.
//
// Design (simple and right first; split-K, wgmma and TMA are later work):
// - One block of 4 warps per (M tile, N tile); the M tile index is the
//   grid's fastest, so the M tiles of one N tile run side by side and read
//   its weights from HBM about once.  Two plans (ops/quant_matmul.
//   launch_plan): SMALL, 32 x 64 tiles for decode and verify bursts (M <=
//   160), the 4 warps splitting each 128-deep slab's k-steps and reducing
//   through shared memory in warp order at the end; LARGE, 64 x 128 tiles
//   for prefill, each warp 64 rows x 32 columns of 64-deep slabs.
// - Per slab, cp.async (16 bytes a thread) brings the activation tile, the
//   packed weight bytes and, for int4, each 16-deep k-step's scales into a
//   ring of 4 (SMALL) or 3 (LARGE) stages; one barrier a slab.
// - Activation fragments come from shared memory by ldmatrix; each weight
//   fragment is dequantized from the stage's bytes straight into mma
//   registers with the rounding above (an int4 byte is exactly the k pair
//   one bf16 B register holds; a group spans whole 16-deep k-steps, hence
//   group sizes that are multiples of 16), so no bf16 copy of a weight
//   exists in HBM or shared memory.  Products: mma.sync m16n8k16 bf16 ->
//   f32 (INT8, INT4) or m16n8k32 s8 -> s32 (W8A8); a 32-byte k-step has
//   the same fragment byte layout in both, so one loader serves them.
// - Dequantizing is the kernel's instruction budget, so it is lean: in the
//   KN layout a warp's columns are permuted (n-tile nt's column j sits at
//   j * NT + nt), so one 8-byte shared load gives a thread its byte of a k
//   row for all its n-tiles, and byte permutes pair them; int8 becomes bf16
//   by two masks and one exact bf16 subtraction, a nibble f32 by a mask
//   and one exact subtraction (no int-to-float conversions, which run at a
//   quarter of the ALU rate); the epilogue undoes the permutation.
//
// C ABI (loaded with ctypes): quant_matmul_launch returns the cudaError_t of
// the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_tile.cuh"

namespace {

constexpr int INT8 = 0, W8A8 = 1, INT4 = 2;  // forms
constexpr int KN = 0, NK = 1;                // weight layouts
constexpr int THREADS = 128;

struct Args {
  const uint8_t* x;   // [M, K] bf16, or int8 (W8A8)
  const float* xs;    // [M] activation scales (W8A8)
  const uint8_t* w;   // weight bytes
  const float* ws;    // weight scales
  __nv_bfloat16* out; // [M, N]
  int M, N, K;        // K: contracted length (x's width)
  int wrows;          // contracted bytes of a weight row/column: K or Kp/2
  int groups, gs;     // int4 scale groups, group size
  int x_aligned, w_aligned;  // 16-byte row alignment of x and W
};

template <int FORM, int LAYOUT, int BM, int BN, int BK>
struct Smem {
  static constexpr int ES = FORM == W8A8 ? 1 : 2;   // activation bytes
  static constexpr int KSTEP = FORM == W8A8 ? 32 : 16;
  static constexpr int A_ROW = BK * ES + 16;
  static constexpr int A_BYTES = BM * A_ROW;
  static constexpr int WK = FORM == INT4 ? BK / 2 : BK;  // bytes of k a slab
  static constexpr int W_ROW = LAYOUT == KN ? BN + 16 : WK + 16;
  static constexpr int W_ROWS = LAYOUT == KN ? WK : BN;
  static constexpr int W_BYTES = W_ROWS * W_ROW;
  static constexpr int S_BYTES = FORM == INT4 ? (BK / 16) * BN * 4 : 0;
  static constexpr int STAGE = A_BYTES + W_BYTES + S_BYTES;
};

// 16 bytes of a row into shared memory: cp.async when the row is 16-byte
// aligned (a short tail zero-filled by the copy), bytewise otherwise, zeros
// past the row or for an invalid row.
__device__ __forceinline__ void load16(uint8_t* dst, const uint8_t* row,
                                       bool valid, long long off,
                                       long long rowbytes, bool aligned) {
  if (!valid || off >= rowbytes) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    return;
  }
  const long long left = rowbytes - off;
  const int n = left < 16 ? static_cast<int>(left) : 16;
  if (aligned) {
    tensor_tile::cp_async16(dst, row + off, n);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = i < n ? row[off + i] : 0;
}

template <int FORM, int LAYOUT, int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* st,
                                           int m0, int n0, int slab) {
  using SM = Smem<FORM, LAYOUT, BM, BN, BK>;
  const int tid = threadIdx.x;
  const int k0 = slab * BK;
  // Activations: BM rows x BK elements.
  {
    constexpr int CPR = BK * SM::ES / 16;
    const long long rowbytes = static_cast<long long>(a.K) * SM::ES;
    for (int i = tid; i < BM * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const int m = m0 + r;
      const uint8_t* row = a.x + (m < a.M ? m : 0) * rowbytes;
      load16(st + r * SM::A_ROW + c * 16, row, m < a.M,
             static_cast<long long>(k0) * SM::ES + c * 16, rowbytes,
             a.x_aligned);
    }
  }
  // Weight bytes.
  uint8_t* ws = st + SM::A_BYTES;
  const int kb0 = FORM == INT4 ? k0 / 2 : k0;  // first contracted byte
  if (LAYOUT == KN) {
    constexpr int CPR = BN / 16;
    for (int i = tid; i < SM::W_ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const int gr = kb0 + r;
      const uint8_t* row =
          a.w + static_cast<long long>(gr < a.wrows ? gr : 0) * a.N;
      load16(ws + r * SM::W_ROW + c * 16, row, gr < a.wrows, n0 + c * 16, a.N,
             a.w_aligned);
    }
  } else {
    constexpr int CPR = SM::WK / 16;
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const int n = n0 + r;
      const uint8_t* row =
          a.w + static_cast<long long>(n < a.N ? n : 0) * a.wrows;
      load16(ws + r * SM::W_ROW + c * 16, row, n < a.N, kb0 + c * 16, a.wrows,
             a.w_aligned);
    }
  }
  // int4: the group scale of each 16-deep k-step, per column.
  if (FORM == INT4) {
    float* ss = reinterpret_cast<float*>(ws + SM::W_BYTES);
    for (int i = tid; i < (BK / 16) * BN; i += THREADS) {
      const int s = i / BN, j = i % BN;
      const int g = (k0 + 16 * s) / a.gs;
      const int n = n0 + j;
      const bool ok = g < a.groups && n < a.N;
      const float* src =
          ok ? (LAYOUT == KN ? a.ws + static_cast<long long>(g) * a.N + n
                             : a.ws + static_cast<long long>(n) * a.groups + g)
             : a.ws;
      tensor_tile::cp_async4(ss + i, src, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 values, in bytes 0 and 2 of w, as an exact bf16 pair: x = (x &
// 0x7f) - (x & 0x80), each term a bf16 of exponent 2^7 (128 + m, and 128 or
// 256), subtracted exactly — no int-to-float conversion.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w) {
  const uint32_t hi = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// A 4-bit field (bits 0-3 of u) as its signed value in f32, exactly: the
// field xor 8 in the mantissa of 2^23, less 2^23 + 8.
__device__ __forceinline__ float nib_f32(uint32_t u) {
  return __uint_as_float(((u & 0xfu) ^ 8u) | 0x4b000000u) - 8388616.0f;
}

// The dequantized bf16 pair of one packed int4 byte (bits 0-7 of b): low
// nibble (even k) in the low half, each value times its f32 scale and
// rounded once.
__device__ __forceinline__ uint32_t i4x2_bf16(uint32_t b, float s) {
  return tensor_tile::pack_bf16(__fmul_rn(nib_f32(b), s),
                                __fmul_rn(nib_f32(b >> 4), s));
}

// Weight columns within a warp's slice: the mma's n index j of n-tile nt
// sits at column j * NT + nt in the KN layout, so a thread's bytes of one
// k row for all its NT n-tiles are NT contiguous bytes (one shared load);
// NK keeps column nt * 8 + j (each row is contiguous along k already).
template <int LAYOUT, int NT>
__device__ __forceinline__ int col_of(int nt, int j) {
  return LAYOUT == KN ? j * NT + nt : nt * 8 + j;
}

// NT contiguous bytes at p (NT is 8 or 4) as two words, the second 0 when
// NT is 4.
template <int NT>
__device__ __forceinline__ uint2 row_bytes(const uint8_t* p) {
  if constexpr (NT == 8) {
    return *reinterpret_cast<const uint2*>(p);
  } else {
    return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0u);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}

// The B fragments of k-step `ks` for all NT n-tiles of a warp whose slice
// starts at block column `wcol`, for lane (g, c): b[nt][0..1], the two
// registers of one mma (bf16 pairs, or four int8 values along k).
template <int FORM, int LAYOUT, int BM, int BN, int BK, int NT>
__device__ __forceinline__ void b_frags(const uint8_t* ws, const float* ss,
                                        int ks, int wcol, int g, int c,
                                        uint32_t (&b)[NT][2]) {
  using SM = Smem<FORM, LAYOUT, BM, BN, BK>;
  constexpr int R = SM::W_ROW;
  if constexpr (LAYOUT == KN) {
    const uint8_t* base = ws + wcol + g * NT;
    if constexpr (FORM == INT4) {
      // Byte row 8ks + c holds k = 16ks + 2c, 2c+1; row + 4 holds k + 8.
      const uint2 r0 = row_bytes<NT>(base + (ks * 8 + c) * R);
      const uint2 r1 = row_bytes<NT>(base + (ks * 8 + c + 4) * R);
      const float* sp = ss + ks * BN + wcol + g * NT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int sh = 8 * (nt & 3);
        const float s = sp[nt];
        b[nt][0] = i4x2_bf16(word_of(r0, nt >> 2) >> sh, s);
        b[nt][1] = i4x2_bf16(word_of(r1, nt >> 2) >> sh, s);
      }
    } else if constexpr (FORM == INT8) {
      const int k = ks * 16 + 2 * c;
      const uint2 r0 = row_bytes<NT>(base + k * R);
      const uint2 r1 = row_bytes<NT>(base + (k + 1) * R);
      const uint2 r8 = row_bytes<NT>(base + (k + 8) * R);
      const uint2 r9 = row_bytes<NT>(base + (k + 9) * R);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int i = nt >> 2, j = nt & 3;
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        b[nt][0] = i8x2_bf16(__byte_perm(word_of(r0, i), word_of(r1, i), sel));
        b[nt][1] = i8x2_bf16(__byte_perm(word_of(r8, i), word_of(r9, i), sel));
      }
    } else {  // W8A8: a 4 x 4 byte transpose of rows 4c..4c+3 (and + 16)
      const int k = ks * 32 + 4 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 q0 = row_bytes<NT>(base + (k + 16 * h) * R);
        const uint2 q1 = row_bytes<NT>(base + (k + 16 * h + 1) * R);
        const uint2 q2 = row_bytes<NT>(base + (k + 16 * h + 2) * R);
        const uint2 q3 = row_bytes<NT>(base + (k + 16 * h + 3) * R);
#pragma unroll
        for (int i = 0; i < NT / 4; ++i) {
          const uint32_t a0 = word_of(q0, i), a1 = word_of(q1, i);
          const uint32_t a2 = word_of(q2, i), a3 = word_of(q3, i);
          const uint32_t t0 = __byte_perm(a0, a1, 0x5140);
          const uint32_t t1 = __byte_perm(a2, a3, 0x5140);
          const uint32_t t2 = __byte_perm(a0, a1, 0x7362);
          const uint32_t t3 = __byte_perm(a2, a3, 0x7362);
          b[4 * i + 0][h] = __byte_perm(t0, t1, 0x5410);
          b[4 * i + 1][h] = __byte_perm(t0, t1, 0x7632);
          b[4 * i + 2][h] = __byte_perm(t2, t3, 0x5410);
          b[4 * i + 3][h] = __byte_perm(t2, t3, 0x7632);
        }
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wcol + col_of<NK, NT>(nt, g);
      const uint8_t* row = ws + col * R;
      if constexpr (FORM == INT4) {
        const float s = ss[ks * BN + col];
        b[nt][0] = i4x2_bf16(row[ks * 8 + c], s);
        b[nt][1] = i4x2_bf16(row[ks * 8 + c + 4], s);
      } else if constexpr (FORM == INT8) {
        const int k = ks * 16 + 2 * c;
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(row + k);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(row + k + 8);
        b[nt][0] = i8x2_bf16(__byte_perm(w0, 0u, 0x1100));
        b[nt][1] = i8x2_bf16(__byte_perm(w1, 0u, 0x1100));
      } else {
        const int k = ks * 32 + 4 * c;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(row + k);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(row + k + 16);
      }
    }
  }
}

template <int FORM, int LAYOUT, int BM, int BN, int BK, int WARPS_K, int STAGES>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const Args a) {
  using SM = Smem<FORM, LAYOUT, BM, BN, BK>;
  constexpr int WARPS_N = 4 / WARPS_K;
  constexpr int WN = BN / WARPS_N;
  constexpr int NT = WN / 8;
  constexpr int MT = BM / 16;
  constexpr int KS = BK / SM::KSTEP;
  constexpr int ACC = MT * NT * 4;
  using Acc = typename std::conditional<FORM == W8A8, int, float>::type;
  static_assert(KS % WARPS_K == 0, "k-steps split evenly over the warps");
  static_assert((WARPS_K - 1) * 32 * ACC * 4 <= SM::STAGE * STAGES,
                "the warps' partial sums fit the stage ring");

  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_k = warp % WARPS_K, warp_n = warp / WARPS_K;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nslabs = (a.K + BK - 1) / BK;

  Acc acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslabs)
      load_stage<FORM, LAYOUT, BM, BN, BK>(a, smem + s * SM::STAGE, m0, n0, s);
    tensor_tile::cp_async_commit();
  }
  for (int t = 0; t < nslabs; ++t) {
    tensor_tile::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = t + STAGES - 1;
    if (nxt < nslabs)
      load_stage<FORM, LAYOUT, BM, BN, BK>(
          a, smem + (nxt % STAGES) * SM::STAGE, m0, n0, nxt);
    tensor_tile::cp_async_commit();

    const uint8_t* st = smem + (t % STAGES) * SM::STAGE;
    const uint8_t* ws = st + SM::A_BYTES;
    const float* ss = reinterpret_cast<const float*>(ws + SM::W_BYTES);
#pragma unroll
    for (int kk = 0; kk < KS / WARPS_K; ++kk) {
      const int ks = kk * WARPS_K + warp_k;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        tensor_tile::ldmatrix_x4(af[mt],
                                 st + r * SM::A_ROW + ks * 32 + (lane >> 4) * 16);
      }
      uint32_t bf[NT][2];
      b_frags<FORM, LAYOUT, BM, BN, BK, NT>(ws, ss, ks, warp_n * WN, g, c, bf);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Acc* cc = acc + (mt * NT + nt) * 4;
          if constexpr (FORM == W8A8) {
            mma_s8(cc, af[mt], bf[nt][0], bf[nt][1]);
          } else {
            tensor_tile::mma_bf16(cc, af[mt], bf[nt][0], bf[nt][1]);
          }
        }
    }
  }
  tensor_tile::cp_async_wait<0>();

  if (WARPS_K > 1) {
    // The warps' partial sums of the same tile, added in warp order.
    __syncthreads();
    Acc* red = reinterpret_cast<Acc*>(smem);
    if (warp_k > 0) {
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        red[((warp_k - 1) * ACC + i) * 32 + lane] = acc[i];
    }
    __syncthreads();
    if (warp_k > 0) return;
#pragma unroll
    for (int w = 1; w < WARPS_K; ++w)
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += red[((w - 1) * ACC + i) * 32 + lane];
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + mt * 16 + g + (i >= 2 ? 8 : 0);
        const int n = n0 + warp_n * WN + col_of<LAYOUT, NT>(nt, 2 * c + (i & 1));
        if (m >= a.M || n >= a.N) continue;
        const Acc v = acc[(mt * NT + nt) * 4 + i];
        float y;
        if constexpr (FORM == INT8) {
          const float yb = __bfloat162float(__float2bfloat16_rn(v));
          const float sb = __bfloat162float(__float2bfloat16_rn(a.ws[n]));
          y = __fmul_rn(yb, sb);
        } else if constexpr (FORM == W8A8) {
          y = __fmul_rn(__fmul_rn(__int2float_rn(v), a.xs[m]), a.ws[n]);
        } else {
          y = v;
        }
        a.out[static_cast<long long>(m) * a.N + n] = __float2bfloat16_rn(y);
      }
}

template <int FORM, int LAYOUT, int BM, int BN, int BK, int WARPS_K, int STAGES>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using SM = Smem<FORM, LAYOUT, BM, BN, BK>;
  auto kernel = quant_matmul_kernel<FORM, LAYOUT, BM, BN, BK, WARPS_K, STAGES>;
  constexpr int smem = SM::STAGE * STAGES;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// plan 0 SMALL (decode, verify): 32 x 64 tiles, 128-deep slabs split over
// the 4 warps, 4 stages; plan 1 LARGE (prefill): 64 x 128 tiles, 64-deep
// slabs, each warp 32 columns, 3 stages.
template <int FORM, int LAYOUT>
cudaError_t dispatch_plan(const Args& a, int plan, cudaStream_t s) {
  if (plan == 0) return launch<FORM, LAYOUT, 32, 64, 128, 4, 4>(a, s);
  return launch<FORM, LAYOUT, 64, 128, 64, 1, 3>(a, s);
}

template <int FORM>
cudaError_t dispatch_layout(const Args& a, int layout, int plan,
                            cudaStream_t s) {
  if (layout == KN) return dispatch_plan<FORM, KN>(a, plan, s);
  return dispatch_plan<FORM, NK>(a, plan, s);
}

}  // namespace

// x: [M, K] bf16 (forms 0 INT8 and 2 INT4) or int8 (form 1 W8A8, with xs
// [M] f32); w: int8 bytes, layout 0 KN ([wrows, N]) or 1 NK ([N, wrows]),
// wrows = K (int8) or groups * gs / 2 (int4); ws: f32 [N] (int8) or
// [groups, N] / [N, groups] (int4); out: [M, N] bf16.
extern "C" int quant_matmul_launch(const void* x, const void* xs,
                                   const void* w, const void* ws, void* out,
                                   int M, int N, int K, int wrows, int groups,
                                   int gs, int form, int layout, int plan,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || form < INT8 || form > INT4 ||
      (layout != KN && layout != NK) || (plan != 0 && plan != 1) ||
      (N + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == INT4) {
    if (gs <= 0 || gs % 16 || groups <= 0 ||
        static_cast<long long>(groups) * gs != 2LL * wrows ||
        K > 2LL * wrows)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (wrows != K || (form == W8A8 && xs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.xs = static_cast<const float*>(xs);
  a.w = static_cast<const uint8_t*>(w);
  a.ws = static_cast<const float*>(ws);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.wrows = wrows;
  a.groups = groups;
  a.gs = gs;
  const int es = form == W8A8 ? 1 : 2;
  a.x_aligned = (static_cast<long long>(K) * es) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.w_aligned = (layout == KN ? N : wrows) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (form == INT8)
    e = dispatch_layout<INT8>(a, layout, plan, s);
  else if (form == W8A8)
    e = dispatch_layout<W8A8>(a, layout, plan, s);
  else
    e = dispatch_layout<INT4>(a, layout, plan, s);
  return static_cast<int>(e);
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
