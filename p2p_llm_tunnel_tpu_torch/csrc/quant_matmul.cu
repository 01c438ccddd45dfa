// Dequant-fused weight matmul on Hopper (sm_90a): y [M,N] = x [M,K] @ W,
// W quantized — int8 with one f32 scale per output channel (weight-only or
// W8A8), or packed int4 with one f32 scale per (group, output channel).
//
// Stands for: no pallas_call.  It is the card's counterpart of what XLA fuses
// on the TPU in p2p_llm_tunnel_tpu/models/quant.py: `mm` (:298), with
// `_dequant4` (:246) in the operand for int4 and the scale after the dot for
// int8, `_int8_dot` (:283) for W8A8 with its activation quantizer
// `_quantize_act` (:275), and `head_matmul` (:336).  Dequantizing into a
// bf16 copy and calling a library GEMM would write and re-read that copy
// (3x the packed bytes); here only the packed bytes and scales cross HBM.
//
// Rounding sits where the reference rounds (ops/quant_matmul.plain follows
// its expression op for op), so every plan and split gives the plain
// version's operands and differs from it only in summation order:
// - INT8:  y = bf16(sum_k x*q) in f32;  out = bf16(y * bf16(scale[n])) — the
//          reference scales after the dot, in x's dtype;
// - INT4:  w = bf16(f32(nibble) * scale[group, n]) BEFORE the product (the
//          reference dequantizes in f32 and casts the operand); out =
//          bf16(sum_k x*w) in f32;
// - W8A8:  x is quantized per token here, bit for bit as quantize_sym:
//          xs = max(amax, 1e-8) / 127 and q = clip(rint(x / xs), +-127), both
//          IEEE divisions (__fdiv_rn), ties to even; acc = sum_k xq*q in int32
//          (exact, so any order gives the plain version's bits);
//          out = bf16(f32(acc) * xs[m] * scale[n]), each product rounded in f32.
// Layouts: KN, W [K, N] (int8) or [Kp/2, N] bytes (int4, byte i holds k = 2i
// in the low nibble and 2i+1 in the high) with scales [N] / [G, N] — the
// block projections and an untied lm_head; NK, W [N, K] or [N, Kp/2] with
// scales [N] / [N, G] — a tied head over the [V, dm] embedding.
// Any shape the reference serves: weight rows (and int4 KN scale rows) are
// stored padded to whole 16-byte pieces (models/quant.kernel_layout; the
// tensor maps keep the logical N, so TMA zero-fills past it and the
// epilogue stores only columns below N); a contracted length that is no
// multiple of 16 is zero-padded in x by the wrapper, and TMA zero-fills the
// weights' rows past it; an int4 group may be any even size — the scale
// is looked up per packed byte row (its two k share a group), one lookup a
// 16-deep k-step where the group size is a multiple of 16.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit:
// 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8): the packed weight bytes
// and scales plus x and y, against 2*M*N*K operations.  At decode (M 17)
// every projection is far below the ridge — the weight stream bounds it
// (llama3-8b int4 g128: w_gate ~29.8 MB, 8.9 us); at M 1024 the tensor
// cores do.  int4 has a second floor at decode: each weight value costs
// about 3.5 ALU instructions (nibble to f32 by a mask and an exact
// subtraction, the f32 scale product, half a bf16 pair conversion), so at
// the full HBM rate an SM would spend ~80% of its issue slots on them.
//
// Two plans, chosen by ops/quant_matmul.launch_plan with their splits,
// activation pieces, scale rows and ring depth (this file recomputes only
// the shared memory, as smem_bytes there), both warp-specialized: 8
// consumer warps (two warpgroups) and 2 producer warps per block.  The
// producers fill rings of shared-memory stages by TMA: tensor maps of x,
// of the KN weight bytes and of int4's KN scales (encoded on the host per
// launch; one cp.async.bulk.tensor a tile, completing on the stage's full
// mbarrier with its byte count; out-of-bounds rows and k zero-filled);
// the NK weights of a tied head go by 16-byte cp.async, which the
// producers' cp.async.mbarrier.arrive tracks.  The consumers release a
// stage through its empty mbarrier.  (Two producer designs were tried
// first: one cp.async.bulk a 128-byte row, held back by the copy engine's
// cost per request, and a warp of 16-byte cp.async copies, held back by
// its instructions.)  x and the KN weights lie in shared memory in TMA's
// 128-byte swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)), which
// wgmma reads for x and which keeps the consumers' loads of weight bytes
// free of bank conflicts.  Both plans run on wgmma (sm_90a).
//
// DECODE (M <= 160: decode steps, verify bursts), weight-stream bound.
// - Operands swapped: A = 64 weight columns a warpgroup, dequantized from
//   the stage's bytes straight into registers in the mma A layout (an int4
//   byte is exactly the k pair one bf16 register holds; stage column wcol
//   + 2g + h is A-row g + 8h, so one 2-byte load gives a thread its byte of
//   a k row for both its columns); B = the tile's x rows, K-major from
//   shared memory; D = [64 columns x NR rows].  NR is wgmma's N: 24 for a
//   decode step (17 rows: 7 padding rows, against 15 in a 32-row mma.sync
//   tile), 32 for verify bursts (M tiles of 32 rows).  Rows past M read
//   whatever the slot holds; their outputs are never stored.
// - Each warpgroup takes its 64 columns through every k-step of a slab, in
//   two batches: the A registers of half a slab's k-steps are built, then
//   one wgmma.fence and their wgmmas, the other half's registers built
//   while those run (a wait keeps one batch in flight).
// - Tiles NR x 128 columns; the M tiles of one column tile are the grid's
//   fastest index, so they share its weight bytes through L2.
// - Split-K: grid.z = splits.  A split is whole units of lcm(slab, group
//   size) slabs, so it spans whole slabs and whole int4 groups; the most
//   splits (at most 16, at most one a unit, a divisor of the units where
//   one fits) that keep M tiles x column tiles x splits within one wave of
//   264 blocks, two an SM (measured: one full wave beats a wave and a
//   part).  llama3-8b at M 17: wk/wv 8 x 16, wq/wo and w_down 32 x 8,
//   w_gate 112 x 2, lm_head 1002 x 1.
// - Stage = weight bytes, plus int4 group scales: a slab of 128 weight byte
//   rows (256 k of int4, 128 k of int8) x 128 columns (16 KB; NK: rows of
//   k padded 16 bytes), then the scale rows of the groups the slab
//   touches, 128 f32 each (two rows at group 128: 1 KB, so 94% of a stage's
//   copied bytes are weights; 16 rows at group 16), 1 KB aligned.  4
//   stages a block (3 or 2 when big scale rows leave no room for the
//   activations), two blocks an SM.
// - Activations: the tile's real rows of the split's K range, in pieces of
//   `xpiece` k (as many as fit the rest of the block's ~113 KB), in a
//   2-slot ring the producers fill ahead of the weights: each piece is
//   loaded once, not per slab, and carries no padding row.
// DEQUANT ONCE, THEN TENSOR CORES (PREFILL, M > 160), tensor-core bound.
// - Tiles 128 x 256 (a wide N tile halves the x bytes each weight column
//   costs through L2); a slab is one 128-byte row of x (64 bf16 k, or 128
//   k of W8A8's int8).  The stage holds the x tile (swizzled) and the
//   packed weight slab (two TMA boxes of 128 columns); the 256 consumer
//   threads dequantize the slab once into a shared [256 columns][128
//   bytes] tile in the same swizzle (bf16; W8A8: the int8 bytes
//   transposed; a thread takes 4 adjacent columns, one 4-byte load a k
//   row, and transposes in registers), one barrier a slab, 3 tiles so a
//   tile is rewritten only after every warpgroup has waited for the
//   products that read it; then each warpgroup runs wgmma m64n256 (k16
//   bf16 -> f32, k32 s8 -> s32) for its 64 rows, both operands from
//   shared memory.  Up to 4 stages, as shared memory allows.
// - Split-K as above with one wave of one block an SM (132).
// Merge (both plans, splits > 1): each block writes its f32 (W8A8: int32)
// partial of its real rows to a workspace [splits][M][N] from the caching
// allocator, then takes a ticket on its output tile's arrival counter
// (persistent, zeroed once); the block that arrives last gathers the
// splits' partials 16 bytes at a time (all of an item's splits in flight
// together), adds them in split order 0, 1, ..., rounds once as above and
// resets the counter to 0 for the next launch on the stream.  One launch
// per product (W8A8: the quantizer kernel before it), bitwise from one
// launch to the next in every form.
//
// C ABI (loaded with ctypes): quant_matmul_launch returns the cudaError_t of
// the launches (0 = launched).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_tile.cuh"

namespace {

constexpr int INT8 = 0, W8A8 = 1, INT4 = 2;  // forms
constexpr int KN = 0, NK = 1;                // weight layouts
constexpr int DECODE = 0, PREFILL = 1;       // plans
constexpr int CONSUMERS = 256;               // 8 consumer warps
constexpr int PRODUCERS = 64;                // the producer warps
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int WBOX = 128;                    // columns of one weight TMA box

struct Args {
  // The x tile's tensor map (TMA): boxes of 128 bytes of k x the plan's
  // rows, in the 128-byte swizzle, rows past M and k past K zero-filled.
  CUtensorMap xmap;
  // KN: the weight slab's map (128 columns x the slab's byte rows, 128-byte
  // swizzle) and int4's scale rows (128 columns x srows groups).
  CUtensorMap wmap, smap;
  const uint8_t* x;    // [M, K] bf16, or the quantized int8 rows (W8A8)
  const float* xs;     // [M] activation scales (W8A8)
  const uint8_t* w;    // weight bytes
  const float* ws;     // weight scales
  __nv_bfloat16* out;  // [M, N]
  void* part;          // [splits, M, N] f32 / int32 partials (splits > 1)
  int* arrivals;       // one counter per output tile, 0 between launches
  int M, N, K;         // K: contracted length (x's width)
  int wrows;           // contracted bytes of a weight row/column: K or Kp/2
  int groups, gs;      // int4 scale groups, group size
  unsigned gmagic;     // ceil(2^32 / (gs / 2)): byte row -> group by umulhi
  int gfine;           // int4 groups narrower than a 16-deep k-step (gs % 16):
                       // selects the kernels' FINE instances
  // Row strides: x (elements; 16-byte multiples, zero past K), weight rows
  // (bytes; KN rows past N, NK rows past wrows rounded to 16, are padding),
  // int4 scale rows (elements), and the merge workspace's rows (N rounded
  // to 4, so a partial row is whole 16-byte pieces).
  int ldx, ldw, lds, ldp;
  int splits, unit_slabs;
  int xpiece;          // decode: k columns of one activation piece
  int srows;           // int4: scale rows a stage holds
  int stages;          // ring stages: as many as shared memory holds
  int stage_bytes;     // bytes of one ring stage
};

// The fixed geometry of a (plan, form, layout).
template <int PLAN, int FORM, int LAYOUT>
struct Geo {
  static constexpr int ES = FORM == W8A8 ? 1 : 2;  // activation bytes
  static constexpr int KSTEP = FORM == W8A8 ? 32 : 16;
  static constexpr int BM = 128;  // prefill rows (decode: NR, 24 or 32)
  static constexpr int BN = PLAN == DECODE ? 128 : 256;  // columns of a tile
  // A slab: decode 16 KB of weights; prefill 128-byte rows of x (64 bf16,
  // or 128 int8 k for W8A8), one wgmma swizzle span.
  static constexpr int BK = PLAN == DECODE ? (FORM == INT4 ? 256 : 128)
                                           : (FORM == W8A8 ? 128 : 64);
  static constexpr int KS = BK / KSTEP;             // k-steps a slab
  static constexpr int WK = FORM == INT4 ? BK / 2 : BK;  // weight bytes of k
  // KN: TMA boxes of 128 columns, each WK swizzled rows of 128 bytes; NK:
  // BN rows of k, padded 16 bytes.
  static constexpr int W_ROW = LAYOUT == KN ? WBOX : WK + 16;
  static constexpr int W_ROWS = LAYOUT == KN ? WK * (BN / WBOX) : BN;
  static constexpr int W_BYTES = W_ROWS * W_ROW;
  static constexpr int X_ROW = 128;                 // prefill: swizzled rows
  static constexpr int X_BYTES = PLAN == PREFILL ? BM * X_ROW : 0;

  // Prefill: the dequantized tile, [BN][BK k] bf16 (W8A8: bytes) in
  // 128-byte swizzled rows, 3 buffers.
  static constexpr int T_ROW = 128;
  static constexpr int T_BYTES = PLAN == PREFILL ? BN * T_ROW : 0;
  static constexpr int ALIGN = 1024;  // stage rounding: TMA's swizzle atom
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive once the calling thread's earlier cp.async copies have landed
// (at once when it issued none); the arrival is counted at init.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of `parity` to complete.  A wait past ~10 s of
// clocks traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  const long long t0 = clock64();
  for (unsigned spins = 0; !done; ++spins) {
    if ((spins & 0xffffu) == 0xffffu && clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A tile of up to ROWS rows of CPR 16-byte chunks from global rows
// `sstride` bytes apart into shared rows `dstride` bytes apart, one
// cp.async (L2 only) a chunk, the chunks dealt to the producer threads
// in order: the first `rows` rows, the first `chunks` chunks of each.  The
// geometry is fixed at compile time, so a lane's copies are independent
// address computations (no division), issued back to back.
template <int ROWS, int CPR>
__device__ __forceinline__ void copy_tile(uint8_t* dst, int dstride,
                                          const uint8_t* src, long long sstride,
                                          int rows, int chunks, int lane) {
#pragma unroll 4
  for (int j = 0; j < (ROWS * CPR + PRODUCERS - 1) / PRODUCERS; ++j) {
    const int i = lane + PRODUCERS * j;
    const int r = i / CPR, c = i % CPR;
    if (i < ROWS * CPR && r < rows && c < chunks)
      tensor_tile::cp_async16(dst + r * dstride + c * 16, src + r * sstride + c * 16,
                              16);
  }
}

// One 2-D tile of a tensor map (inner coordinate c0, row c1) into shared
// memory at dst (1 KB aligned for the 128-byte swizzle), completing on
// `bar`'s transaction count.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int c0,
                                         int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The 256 consumer threads only (the producer warps take no part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
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

// The group of packed byte row j (k = 2j and 2j + 1; the group size is
// even, so both lie in one group): j / (gs / 2) by one multiply-high with
// gmagic = ceil(2^32 / (gs / 2)), exact for j * (gs / 2) <= 2^32 (the
// wrapper's shape_fence); gmagic 0 stands for gs 2 (a group per byte row).
__device__ __forceinline__ int group_of(int j, unsigned gmagic) {
  return gmagic ? static_cast<int>(__umulhi(static_cast<unsigned>(j), gmagic)) : j;
}

// Output element (m, n) from its (merged) sum, rounded as the form's
// reference rounds.
template <int FORM, typename Acc>
__device__ __forceinline__ void store_out(const Args& a, int m, int n, Acc v) {
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

// The split's slab range [s0, s1) of the contracted axis: whole units of
// `unit_slabs` slabs, the units shared out evenly in split order.
__device__ __forceinline__ void split_range(const Args& a, int bk, int split,
                                            int& s0, int& s1) {
  const int nslabs = (a.K + bk - 1) / bk;
  const int units = (nslabs + a.unit_slabs - 1) / a.unit_slabs;
  const int u0 = static_cast<int>(static_cast<long long>(split) * units / a.splits);
  const int u1 =
      static_cast<int>(static_cast<long long>(split + 1) * units / a.splits);
  s0 = min(u0 * a.unit_slabs, nslabs);
  s1 = min(u1 * a.unit_slabs, nslabs);
}

// The producer's copies of one weight slab (its bytes and, for int4, the
// scale rows of the groups it touches) into stage `st`: every lane issues
// its share and arrives on `full` once its copies have landed (the
// barrier counts the 32 lanes).
template <int PLAN, int FORM, int LAYOUT>
__device__ __forceinline__ void load_weights(const Args& a, uint8_t* st,
                                             uint64_t* full, int n0, int slab,
                                             int lane) {
  using G = Geo<PLAN, FORM, LAYOUT>;
  const int kb0 = slab * G::WK;  // first contracted byte of the slab
  const int kbytes = min(G::WK, a.wrows - kb0);
  const int cols = min(G::BN, a.N - n0);
  uint8_t* wdst = st + G::X_BYTES;
  float* sdst = reinterpret_cast<float*>(wdst + G::W_BYTES);
  int g0 = 0;
  if constexpr (FORM == INT4) g0 = group_of(kb0, a.gmagic);
  if constexpr (LAYOUT == KN) {
    // Two TMA copies: the slab's bytes and (int4) its scale rows.
    if (lane == 0) {
      mbar_expect_tx(full, G::W_BYTES + (FORM == INT4 ? a.srows * G::BN * 4 : 0));
#pragma unroll
      for (int h = 0; h < G::BN / WBOX; ++h)
        tma_tile(wdst + h * G::WK * WBOX, &a.wmap, n0 + h * WBOX, kb0, full);
      if constexpr (FORM == INT4) tma_tile(sdst, &a.smap, n0, g0, full);
    }
    (void)kbytes;
    (void)cols;
  } else {
    // Whole 16-byte pieces: a row's last piece reads into its padding
    // (k past K meets zero activations).
    copy_tile<G::BN, G::WK / 16>(wdst, G::W_ROW,
                              a.w + static_cast<long long>(n0) * a.ldw + kb0,
                              a.ldw, cols, (kbytes + 15) / 16, lane);
    if constexpr (FORM == INT4) {
      // Every staged scale row, those past the last group repeating it: a
      // k-step past K reads a finite scale (zero activations; stale shared
      // memory could hold a NaN).
      for (int r = 0; r < a.srows; ++r) {
        const int g = min(g0 + r, a.groups - 1);
        for (int j = lane; j < cols; j += PRODUCERS)
          tensor_tile::cp_async4(sdst + r * G::BN + j,
                                 a.ws + static_cast<long long>(n0 + j) * a.lds + g, 4);
      }
    }
  }
  mbar_arrive_cp_async(full);
}

// The merge's gather: items of 4 output columns of the tile, IG at a time
// per thread, each item's partials of all (at most S) splits loaded before
// any is added.
template <int FORM, int BN, int IG, int S>
__device__ __forceinline__ void merge_items(const Args& a, int m0, int n0, int rows,
                                            int cols, long long plane, int ctid) {
  using Acc = typename std::conditional<FORM == W8A8, int, float>::type;
  using Vec = typename std::conditional<FORM == W8A8, int4, float4>::type;
  const Vec* part = static_cast<const Vec*>(a.part);
  const int items = rows * (BN / 4);
  for (int base = ctid; base < items; base += CONSUMERS * IG) {
    Vec t[IG][S];
#pragma unroll
    for (int g = 0; g < IG; ++g) {
      const int it = base + g * CONSUMERS;
      const int r = it / (BN / 4), c4 = it % (BN / 4);
      const long long off = (static_cast<long long>(m0 + r) * a.ldp + n0) / 4 + c4;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (it < items && 4 * c4 < cols && s < a.splits)
          t[g][s] = __ldcg(part + s * (plane / 4) + off);
    }
#pragma unroll
    for (int g = 0; g < IG; ++g) {
      const int it = base + g * CONSUMERS;
      const int r = it / (BN / 4), c4 = it % (BN / 4);
      if (it >= items || 4 * c4 >= cols) continue;
      Acc v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s < a.splits) {
          v[0] += t[g][s].x;
          v[1] += t[g][s].y;
          v[2] += t[g][s].z;
          v[3] += t[g][s].w;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)  // the last item of a row may pass N
        if (4 * c4 + e < cols) store_out<FORM>(a, m0 + r, n0 + 4 * c4 + e, v[e]);
    }
  }
}

// Split-K's last step, after every consumer thread has written its partial:
// a ticket on the tile's counter; the last block of the tile adds the
// splits' partials in split order (read from L2: other SMs wrote them),
// rounds once and resets the counter.
template <int FORM, int BM, int BN>
__device__ __forceinline__ void merge_splits(const Args& a, int m0, int n0,
                                             int tile, int ctid) {
  __shared__ int last;
  __threadfence();
  consumer_sync();
  if (ctid == 0) {
    const int prev = atomicAdd(a.arrivals + tile, 1);
    last = prev == a.splits - 1;
    if (last) a.arrivals[tile] = 0;  // every split has arrived
  }
  consumer_sync();
  if (!last) return;
  __threadfence();
  // Items of 4 columns (16-byte loads); a thread gathers IG items of
  // every split before it adds, so IG * splits loads are in flight at
  // once (IG 4 up to 4 splits, else 1; at most 16 splits), and the sums
  // run in split order.
  const int rows = min(BM, a.M - m0), cols = min(BN, a.N - n0);
  const long long plane = static_cast<long long>(a.M) * a.ldp;
  if (a.splits <= 4)
    merge_items<FORM, BN, 4, 4>(a, m0, n0, rows, cols, plane, ctid);
  else
    merge_items<FORM, BN, 1, 16>(a, m0, n0, rows, cols, plane, ctid);
}

// One element's sum: the output when there is one split, else its partial.
template <int FORM, typename Acc>
__device__ __forceinline__ void emit(const Args& a, int split, int m, int n,
                                     Acc v) {
  if (m >= a.M || n >= a.N) return;
  if (a.splits == 1) {
    store_out<FORM>(a, m, n, v);
  } else {
    const long long off =
        (static_cast<long long>(split) * a.M + m) * a.ldp + n;
    static_cast<Acc*>(a.part)[off] = v;
  }
}

// Barriers at the head of shared memory, initialised by thread 0.
__device__ __forceinline__ void init_barriers(uint8_t* smem, int stages,
                                              bool xring) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar + s, PRODUCERS);           // full: the producer's lanes
      mbar_init(bar + stages + s, CONSUMERS / 32);  // empty: consumer warps
    }
    if (xring) {
      for (int s = 0; s < 2; ++s) {
        mbar_init(bar + 2 * stages + s, PRODUCERS);          // x full
        mbar_init(bar + 2 * stages + 2 + s, CONSUMERS / 32);  // x empty
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// wgmma (sm_90a): the K-major shared-memory descriptor of a tile of
// 128-byte rows in the 128-byte swizzle (8-row atoms 1024 bytes apart),
// starting at `p` (the atom 1024-byte aligned; + 32 bytes per k-step).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte `b` of row `r` of a 128-byte-row tile in the 128-byte swizzle: its
// 16-byte chunk index xor the row's index mod 8.
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep values in their registers until this point (an in-flight wgmma
// reads its register operands and writes its accumulators).
template <typename T, int N>
__device__ __forceinline__ void hold(T (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 4 && std::is_same<T, float>::value)
      asm volatile("" : "+f"(v[i])::"memory");
    else
      asm volatile("" : "+r"(v[i])::"memory");
  }
}

// D [64 x 256] += A [64 x 16] B [16 x 256], bf16 -> f32, both from shared
// memory (K-major).
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D [64 x 256] += A [64 x 32] B [32 x 256], s8 -> s32 (exact).
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Prefill: one weight slab dequantized once into the shared tile tb [BN
// columns][128 bytes] (64 bf16 k; W8A8: 128 int8 k, transposed), in the
// swizzle wgmma reads.  KN: unit (4 columns, kq) of one thread: the 16 k
// (W8A8: 32) of kq for 4 adjacent columns, read a k row (4 bytes, one
// load) at a time from the slab's TMA box and transposed in registers;
// each column's 32 bytes are two 16-byte stores.  NK: unit (column, kq),
// the column's bytes contiguous already.
template <int FORM, int LAYOUT, bool FINE>
__device__ __forceinline__ void dequant_tile(const Args& a, const uint8_t* wst,
                                             const float* sst, uint8_t* tb,
                                             int k0, int ctid) {
  using G = Geo<PREFILL, FORM, LAYOUT>;
  constexpr int R = G::W_ROW;
  constexpr int BN = G::BN;
  // int4: the scale row of a byte row of the slab (byte rows k0/2 + i);
  // one row a k-step unless groups are narrower than one (FINE).
  const int gbase = FORM == INT4 ? group_of(k0 / 2, a.gmagic) : 0;
  auto srow_of = [&](int i) { return (group_of(k0 / 2 + i, a.gmagic) - gbase) * BN; };
  if constexpr (LAYOUT == KN) {
#pragma unroll
    for (int u = ctid; u < BN; u += CONSUMERS) {  // BN / 4 groups x 4 kq
      const int n = (u % (BN / 4)) * 4, kq = u / (BN / 4);
      const uint8_t* box = wst + (n / WBOX) * (G::WK * WBOX);
      const int nb = n & (WBOX - 1);
      uint32_t o[4][8];  // [column][register]
      if constexpr (FORM == INT4) {
        float4 s4 = *reinterpret_cast<const float4*>(sst + srow_of(kq * 8) + n);
#pragma unroll
        for (int r = 0; r < 8; ++r) {  // byte row kq * 8 + r: k pair 2r
          if (FINE && r > 0)
            s4 = *reinterpret_cast<const float4*>(sst + srow_of(kq * 8 + r) + n);
          const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
          const uint32_t w = *reinterpret_cast<const uint32_t*>(box + swz(kq * 8 + r, nb));
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e][r] = i4x2_bf16(w >> (8 * e), sc[e]);
        }
      } else if constexpr (FORM == INT8) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {  // rows kq * 16 + 2r, + 1: k pair 2r
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(box + swz(kq * 16 + 2 * r, nb));
          const uint32_t w1 =
              *reinterpret_cast<const uint32_t*>(box + swz(kq * 16 + 2 * r + 1, nb));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e][r] = i8x2_bf16(__byte_perm(w0, w1, e | (e << 4) | ((4 + e) << 8) |
                                                          ((4 + e) << 12)));
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) {  // rows kq * 32 + 4r .. + 3: a 4 x 4 transpose
          const int k = kq * 32 + 4 * r;
          const uint32_t q0 = *reinterpret_cast<const uint32_t*>(box + swz(k, nb));
          const uint32_t q1 = *reinterpret_cast<const uint32_t*>(box + swz(k + 1, nb));
          const uint32_t q2 = *reinterpret_cast<const uint32_t*>(box + swz(k + 2, nb));
          const uint32_t q3 = *reinterpret_cast<const uint32_t*>(box + swz(k + 3, nb));
          const uint32_t t0 = __byte_perm(q0, q1, 0x5140);
          const uint32_t t1 = __byte_perm(q2, q3, 0x5140);
          const uint32_t t2 = __byte_perm(q0, q1, 0x7362);
          const uint32_t t3 = __byte_perm(q2, q3, 0x7362);
          o[0][r] = __byte_perm(t0, t1, 0x5410);
          o[1][r] = __byte_perm(t0, t1, 0x7632);
          o[2][r] = __byte_perm(t2, t3, 0x5410);
          o[3][r] = __byte_perm(t2, t3, 0x7632);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<uint4*>(tb + swz(n + e, kq * 32)) =
            make_uint4(o[e][0], o[e][1], o[e][2], o[e][3]);
        *reinterpret_cast<uint4*>(tb + swz(n + e, kq * 32 + 16)) =
            make_uint4(o[e][4], o[e][5], o[e][6], o[e][7]);
      }
    }
  } else {
#pragma unroll
    for (int it = ctid; it < BN * 4; it += CONSUMERS) {
      const int n = it % BN, kq = it / BN;
      uint32_t o[8];
      if constexpr (FORM == INT4) {
        float s = sst[srow_of(kq * 8) + n];
        uint8_t b[8];
        *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(wst + n * R + kq * 8);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (FINE && r > 0) s = sst[srow_of(kq * 8 + r) + n];
          o[r] = i4x2_bf16(b[r], s);
        }
      } else if constexpr (FORM == INT8) {
        const uint4 v = *reinterpret_cast<const uint4*>(wst + n * R + kq * 16);
        const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)  // bytes 2r, 2r + 1 -> bytes 0 and 2
          o[r] = i8x2_bf16(__byte_perm(wv[r >> 1], 0u, (r & 1) ? 0x3322 : 0x1100));
      } else {
        const uint4 v0 = *reinterpret_cast<const uint4*>(wst + n * R + kq * 32);
        const uint4 v1 = *reinterpret_cast<const uint4*>(wst + n * R + kq * 32 + 16);
        o[0] = v0.x; o[1] = v0.y; o[2] = v0.z; o[3] = v0.w;
        o[4] = v1.x; o[5] = v1.y; o[6] = v1.z; o[7] = v1.w;
      }
      *reinterpret_cast<uint4*>(tb + swz(n, kq * 32)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(tb + swz(n, kq * 32 + 16)) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
}

template <int FORM, int LAYOUT, bool FINE>
__global__ void __launch_bounds__(THREADS, 1)
quant_matmul_prefill_kernel(const __grid_constant__ Args a) {
  using G = Geo<PREFILL, FORM, LAYOUT>;
  constexpr int BM = G::BM, BK = G::BK;
  const int STAGES = a.stages;
  using Acc = typename std::conditional<FORM == W8A8, int, float>::type;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  // Tiles 1 KB aligned: the header at the first 1 KB boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * G::BN, split = blockIdx.z;
  int s0, s1;
  split_range(a, BK, split, s0, s1);
  const int nsl = s1 - s0;
  uint8_t* tiles = smem + 1024;
  uint8_t* ring = tiles + 3 * G::T_BYTES;
  init_barriers(smem, STAGES, false);

  if (warp >= CONSUMERS / 32) {  // the producer: x rows into swizzled rows
    const int pl = threadIdx.x - CONSUMERS;
    for (int t = 0; t < nsl; ++t) {
      const int st = t % STAGES;
      uint8_t* stage = ring + st * a.stage_bytes;
      mbar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
      if (pl == 0) {  // the x tile, one TMA copy
        mbar_expect_tx(full + st, G::X_BYTES);
        tma_tile(stage, &a.xmap, (s0 + t) * BK, m0, full + st);
      }
      load_weights<PREFILL, FORM, LAYOUT>(a, stage, full + st, n0, s0 + t, pl);
    }
    return;
  }

  // Warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile, all 256 columns.
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, c = lane & 3;
  Acc d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;

  for (int t = 0; t < nsl; ++t) {
    const int st = t % STAGES;
    mbar_wait(full + st, (t / STAGES) & 1);
    const uint8_t* stage = ring + st * a.stage_bytes;
    const uint8_t* wst = stage + G::X_BYTES;
    const int k0 = (s0 + t) * BK;
    // Tile t % 3 was last read by slab t - 3's products, which every
    // warpgroup waited for before the barrier of slab t - 1.
    uint8_t* tb = tiles + (t % 3) * G::T_BYTES;
    dequant_tile<FORM, LAYOUT, FINE>(a, wst, reinterpret_cast<const float*>(wst + G::W_BYTES),
                               tb, k0, threadIdx.x);
    // The tile's generic writes and the producer's cp.async rows, before
    // the async proxy (wgmma) reads them.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    const int nks = min(G::KS, (a.K - k0 + G::KSTEP - 1) / G::KSTEP);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < G::KS; ++ks) {
      if (ks < nks) {
        const uint64_t da = wgmma_desc(stage + wg * 64 * G::X_ROW + ks * 32);
        const uint64_t db = wgmma_desc(tb + ks * 32);
        if constexpr (FORM == W8A8) {
          wgmma_s8(d, da, db);
        } else {
          wgmma_bf16(d, da, db);
        }
      }
    }
    wgmma_commit();
    // Slab t - 1's products are done: its stage goes back to the producer.
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % STAGES);
  }
  wgmma_wait<0>();
  hold(d);
  if (nsl > 0 && lane == 0) mbar_arrive(empty + (nsl - 1) % STAGES);

#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      emit<FORM>(a, split, m0 + wg * 64 + w4 * 16 + g + (i >= 2 ? 8 : 0),
                 n0 + 8 * j + 2 * c + (i & 1), d[4 * j + i]);
  if (a.splits > 1)
    merge_splits<FORM, BM, G::BN>(a, m0, n0, blockIdx.y * gridDim.x + blockIdx.x,
                                  threadIdx.x);
}

// Decode: wgmma with the operands swapped.  A = 64 of the block's weight
// columns (dequantized into registers, the mma.sync A layout), B = the
// tile's NR rows of x (K-major from shared memory, 128-byte swizzle), D =
// [64 columns x NR rows] in f32 (W8A8: s32).  One instruction per m-tile
// and k-step; rows past M read whatever the slot holds and their outputs
// are never stored.
template <int N> struct BF16 {};
template <int N> struct S8 {};

__device__ __forceinline__ void wgmma_rs(BF16<24>, float (&d)[12], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(S8<24>, int (&d)[12], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, %16, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(BF16<32>, float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(S8<32>, int (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The A fragment of k-step `ks` for a warp whose 16 stage columns start at
// `wcol`, for lane (g, c): stage column wcol + 2g + h is A-row g + 8h, so
// in the KN layout one 2-byte load gives a thread its byte of a k row for
// both its columns.  a[0..3]: rows (g, g+8) x k (2c, 2c+1 | 2c+8, 2c+9) as
// bf16 pairs (W8A8: k 4c..4c+3 | 16+4c..16+4c+3 as int8).  `s0`, `s1`:
// the int4 scale rows of the thread's two byte rows (k 2c and 2c + 8 of the
// k-step); `fine` when they may differ (groups narrower than a k-step),
// else s1 is not read.
template <int FORM, int LAYOUT, int R>
__device__ __forceinline__ void a_frags(const uint8_t* ws, const float* s0,
                                        const float* s1, bool fine, int ks, int wcol,
                                        int g, int c, uint32_t (&a)[4]) {
  if constexpr (LAYOUT == KN) {
    // The slab as TMA wrote it: row r's 16-byte chunk j at chunk j ^ (r % 8).
    const int col = wcol + 2 * g;
    auto at = [&](int r) { return ws + swz(r, col); };
    if constexpr (FORM == INT4) {
      // Byte row 8ks + c holds k = 16ks + 2c, 2c+1; row + 4 holds k + 8.
      const uint32_t r0 = ld16(at(ks * 8 + c));
      const uint32_t r1 = ld16(at(ks * 8 + c + 4));
      const float2 t0 = *reinterpret_cast<const float2*>(s0 + wcol + 2 * g);
      const float2 t1 = fine ? *reinterpret_cast<const float2*>(s1 + wcol + 2 * g) : t0;
      a[0] = i4x2_bf16(r0, t0.x);
      a[1] = i4x2_bf16(r0 >> 8, t0.y);
      a[2] = i4x2_bf16(r1, t1.x);
      a[3] = i4x2_bf16(r1 >> 8, t1.y);
    } else if constexpr (FORM == INT8) {
      const int k = ks * 16 + 2 * c;
      const uint32_t r0 = ld16(at(k)), r1 = ld16(at(k + 1));
      const uint32_t r8 = ld16(at(k + 8)), r9 = ld16(at(k + 9));
      // Column h's bytes of rows k and k + 1 at bytes 0 and 2.
      a[0] = i8x2_bf16(__byte_perm(r0, r1, 0x4400));
      a[1] = i8x2_bf16(__byte_perm(r0, r1, 0x5511));
      a[2] = i8x2_bf16(__byte_perm(r8, r9, 0x4400));
      a[3] = i8x2_bf16(__byte_perm(r8, r9, 0x5511));
    } else {  // W8A8: rows 4c..4c+3 (and + 16), column h's four bytes
      const int k = ks * 32 + 4 * c;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t q01 = __byte_perm(ld16(at(k + 16 * hh)),
                                         ld16(at(k + 16 * hh + 1)), 0x5410);
        const uint32_t q23 = __byte_perm(ld16(at(k + 16 * hh + 2)),
                                         ld16(at(k + 16 * hh + 3)), 0x5410);
        a[2 * hh] = __byte_perm(q01, q23, 0x6420);
        a[2 * hh + 1] = __byte_perm(q01, q23, 0x7531);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = wcol + 2 * g + h;
      const uint8_t* row = ws + col * R;
      if constexpr (FORM == INT4) {
        const float t0 = s0[col];
        a[h] = i4x2_bf16(row[ks * 8 + c], t0);
        a[2 + h] = i4x2_bf16(row[ks * 8 + c + 4], fine ? s1[col] : t0);
      } else if constexpr (FORM == INT8) {
        const int k = ks * 16 + 2 * c;
        a[h] = i8x2_bf16(__byte_perm(ld16(row + k), 0u, 0x1100));
        a[2 + h] = i8x2_bf16(__byte_perm(ld16(row + k + 8), 0u, 0x1100));
      } else {
        const int k = ks * 32 + 4 * c;
        a[h] = ld32(row + k);
        a[2 + h] = ld32(row + k + 16);
      }
    }
  }
}

template <int FORM, int LAYOUT, int NR, bool FINE>
__global__ void __launch_bounds__(THREADS, 2)
quant_matmul_decode_kernel(const __grid_constant__ Args a) {
  using G = Geo<DECODE, FORM, LAYOUT>;
  constexpr int BK = G::BK, KS = G::KS, ES = G::ES;
  constexpr int KB = 128 / ES;   // k of one 128-byte x block
  constexpr int XBLK = NR * 128;  // bytes of one x block: the tile's rows
  constexpr int ACC = NR / 2;     // accumulators of one m64 x NR wgmma
  // k-steps a batch: their A registers are built, then one fence and
  // their wgmmas; two batches in flight, an even number a slab.
  constexpr int GROUP = KS / 2;
  using Acc = typename std::conditional<FORM == W8A8, int, float>::type;
  using Op = typename std::conditional<FORM == W8A8, S8<NR>, BF16<NR>>::type;
  static_assert(KS % (2 * GROUP) == 0, "a slab holds whole pairs of batches");

  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int STAGES = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;
  uint64_t* xempty = xfull + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int BN = G::BN;
  const int m0 = blockIdx.x * NR, n0 = blockIdx.y * BN, split = blockIdx.z;
  int s0, s1;
  split_range(a, BK, split, s0, s1);
  const int nsl = s1 - s0;
  const int ps = a.xpiece / BK;  // slabs of one activation piece
  const int xslot = a.xpiece * ES / 128 * XBLK;
  uint8_t* xring = smem + 1024;
  uint8_t* ring = xring + 2 * xslot;
  init_barriers(smem, STAGES, true);

  if (warp >= CONSUMERS / 32) {  // the producers
    const int pl = threadIdx.x - CONSUMERS;
    for (int t = 0; t < nsl; ++t) {
      if (t % ps == 0) {
        // The tile's rows of the next activation piece, into 128-byte x
        // blocks of NR swizzled rows.
        const int q = t / ps, slot = q & 1;
        mbar_wait(xempty + slot, ((q >> 1) & 1) ^ 1);
        // One TMA copy a 128-byte block of k: NR rows, the piece's blocks
        // side by side.
        const int k0 = (s0 + t) * BK;
        const int blocks = (min(min(ps, nsl - t) * BK, a.K - k0) + KB - 1) / KB;
        if (pl == 0) {
          mbar_expect_tx(xfull + slot, blocks * XBLK);
          for (int b = 0; b < blocks; ++b)
            tma_tile(xring + slot * xslot + b * XBLK, &a.xmap, k0 + b * KB, m0,
                     xfull + slot);
        }
        mbar_arrive_cp_async(xfull + slot);
      }
      const int st = t % STAGES;
      mbar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
      load_weights<DECODE, FORM, LAYOUT>(a, ring + st * a.stage_bytes, full + st,
                                         n0, s0 + t, pl);
    }
    return;
  }

  // Warpgroup wg: stage columns 64 wg .. 64 wg + 63 (one wgmma M), every
  // k-step; warp w4 of it A-rows 16 w4 .. 16 w4 + 15.
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, c = lane & 3;
  const int wcol = 64 * wg + 16 * w4;
  Acc d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0;
  uint32_t af[2][GROUP][4];  // A registers of the two batches in flight

  for (int t = 0; t < nsl; ++t) {
    const int q = t / ps, slot = q & 1, tp = t - q * ps;
    if (tp == 0) mbar_wait(xfull + slot, (q >> 1) & 1);
    const int st = t % STAGES;
    mbar_wait(full + st, (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint8_t* wst = ring + st * a.stage_bytes;
    const float* sst = reinterpret_cast<const float*>(wst + G::W_BYTES);
    const uint8_t* xb = xring + slot * xslot;
    const int k0 = (s0 + t) * BK;
    const int nks = min(KS, (a.K - k0 + G::KSTEP - 1) / G::KSTEP);
    const int gbase = FORM == INT4 ? group_of(k0 / 2, a.gmagic) : 0;
#pragma unroll
    for (int gi = 0; gi < KS / GROUP; ++gi) {
      const int b = gi & 1;
      if (gi * GROUP < nks) {
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const int ks = gi * GROUP + j;
          const float *s0 = sst, *s1 = sst;
          if constexpr (FORM == INT4) {
            // Byte rows k0/2 + 8 ks + c and + 4 (k 2c and 2c + 8 of the step).
            const int j0 = k0 / 2 + ks * 8;
            if constexpr (FINE) {
              s0 = sst + (group_of(j0 + c, a.gmagic) - gbase) * BN;
              s1 = sst + (group_of(j0 + c + 4, a.gmagic) - gbase) * BN;
            } else {
              s0 = s1 = sst + (group_of(j0, a.gmagic) - gbase) * BN;
            }
          }
          a_frags<FORM, LAYOUT, G::W_ROW>(wst, s0, s1, FINE, ks, wcol, g, c, af[b][j]);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const int ks = gi * GROUP + j;
          const int kx = tp * BK + ks * G::KSTEP;  // k within the piece
          if (ks < nks)
            wgmma_rs(Op{}, d, af[b][j],
                     wgmma_desc(xb + (kx / KB) * XBLK + (kx % KB) * ES));
        }
        wgmma_commit();
        // The batch before is done: its registers may be rewritten.
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < GROUP; ++j) hold(af[b ^ 1][j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // the weights were read by loads
    if (tp == ps - 1 || t == nsl - 1) {
      wgmma_wait<0>();  // the piece's rows are read by the products
      hold(d);
      if (lane == 0) mbar_arrive(xempty + slot);
    }
  }
  wgmma_wait<0>();
  hold(d);
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    hold(af[0][i]);
    hold(af[1][i]);
  }

  // D element i: n8 chunk i / 4; A-row g + 8 ((i >> 1) & 1); x row
  // 8 (i / 4) + 2c + (i & 1).
#pragma unroll
  for (int i = 0; i < ACC; ++i)
    emit<FORM>(a, split, m0 + 8 * (i >> 2) + 2 * c + (i & 1),
               n0 + wcol + 2 * g + ((i >> 1) & 1), d[i]);
  if (a.splits > 1)
    merge_splits<FORM, NR, BN>(a, m0, n0, blockIdx.y * gridDim.x + blockIdx.x,
                           threadIdx.x);
}

// W8A8's activation quantizer, one block per row, bit for bit as
// models/quant.quantize_sym(x, 127): xs = max(amax, 1e-8) / 127, q =
// clip(rint(x / xs), -127, 127), both divisions IEEE (__fdiv_rn), rint ties
// to even.  Rows of K elements, K % 8 == 0 and 16-byte aligned (the
// entry point passes the padded row width ldx).
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const __nv_bfloat16* x, int8_t* xq, float* xs, int K) {
  __shared__ float wmax[8];
  const long long base = static_cast<long long>(blockIdx.x) * K;
  float amax = 0.f;
  for (int i = threadIdx.x * 8; i < K; i += 256 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + base + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = wmax[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) amax = fmaxf(amax, wmax[w]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  for (int i = threadIdx.x * 8; i < K; i += 256 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + base + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      const float q0 = fminf(fmaxf(rintf(__fdiv_rn(f.x, s)), -127.f), 127.f);
      const float q1 = fminf(fmaxf(rintf(__fdiv_rn(f.y, s)), -127.f), 127.f);
      const uint32_t b = (static_cast<uint32_t>(static_cast<int>(q0)) & 0xffu) |
                         ((static_cast<uint32_t>(static_cast<int>(q1)) & 0xffu) << 8);
      packed[j >> 1] |= b << (16 * (j & 1));
    }
    *reinterpret_cast<uint2*>(xq + base + i) = make_uint2(packed[0], packed[1]);
  }
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

// Shared memory of a launch, as ops/quant_matmul.smem_bytes computes it.
template <int PLAN, int FORM, int LAYOUT>
int stage_bytes(int srows) {
  using G = Geo<PLAN, FORM, LAYOUT>;
  const int b = G::X_BYTES + G::W_BYTES + (FORM == INT4 ? srows * G::BN * 4 : 0);
  return (b + G::ALIGN - 1) / G::ALIGN * G::ALIGN;
}

// A 2-D tensor map: [outer][inner] elements of `es` bytes, rows `ld`
// elements apart (16-byte multiples), boxes of box_inner x box_outer, zero
// fill out of bounds (columns past `inner` too, so a padded row's padding
// is never read), the 128-byte swizzle or none.
// cuTensorMapEncodeTiled is the driver's; it is reached through the
// runtime's entry-point query, so the library links no driver stub.
cudaError_t encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                      int es, long long inner, long long outer, long long ld,
                      int box_inner, int box_outer, bool swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr)
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The decode plan's rows a tile (wgmma's N): 24 for a decode step, else 32.
int decode_rows(int m) { return m <= 24 ? 24 : 32; }

template <int PLAN, int FORM, int LAYOUT>
int smem_bytes(const Args& a) {
  using G = Geo<PLAN, FORM, LAYOUT>;
  const int ring = a.stages * stage_bytes<PLAN, FORM, LAYOUT>(a.srows);
  // 1 KB of slack to align the tiles to 1 KB (wgmma's swizzle atom), the
  // 1 KB header, then (decode) two activation slots of NR-row x blocks, or
  // (prefill) three dequantized tiles, then the ring.
  if (PLAN == DECODE)
    return 2048 + 2 * (a.xpiece * G::ES / 128) * decode_rows(a.M) * 128 + ring;
  return 2048 + 3 * G::T_BYTES + ring;
}

template <int PLAN, int FORM, int LAYOUT, int NR, bool FINE>
cudaError_t launch(Args a, cudaStream_t stream) {
  using G = Geo<PLAN, FORM, LAYOUT>;
  void (*kernel)(const Args);  // the __grid_constant__ qualifier is no type
  if constexpr (PLAN == DECODE)
    kernel = quant_matmul_decode_kernel<FORM, LAYOUT, NR, FINE>;
  else
    kernel = quant_matmul_prefill_kernel<FORM, LAYOUT, FINE>;
  const int bm = PLAN == DECODE ? NR : G::BM;
  if (PLAN == DECODE && (a.xpiece <= 0 || a.xpiece % G::BK))
    return cudaErrorInvalidValue;
  a.stage_bytes = stage_bytes<PLAN, FORM, LAYOUT>(a.srows);
  // x: boxes of 128 bytes of k x the plan's rows; KN weights: 128 columns
  // x the slab's byte rows; int4 KN scales: 128 columns x srows groups.
  cudaError_t ex = encode_2d(
      &a.xmap, a.x, G::ES == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      G::ES, a.K, a.M, a.ldx, 128 / G::ES, bm, true);
  if (ex == cudaSuccess && LAYOUT == KN)
    ex = encode_2d(&a.wmap, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.N, a.wrows, a.ldw,
                   WBOX, G::WK, true);
  if (ex == cudaSuccess && LAYOUT == KN && FORM == INT4)
    ex = encode_2d(&a.smap, a.ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.N, a.groups,
                   a.lds, G::BN, a.srows, false);
  if (ex != cudaSuccess) return ex;
  const int smem = smem_bytes<PLAN, FORM, LAYOUT>(a);
  // The opt-in grows to the largest launch seen (the card refuses more
  // than its 227 KB less the kernel's static shared memory).
  // The carveout is set to all shared memory, so two decode blocks fit an
  // SM beside the L1 that remains.
  static int configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid((a.M + bm - 1) / bm, (a.N + G::BN - 1) / G::BN, a.splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int FORM, bool FINE>
cudaError_t dispatch_plan(const Args& a, int layout, int plan, cudaStream_t s) {
  if (plan == DECODE && decode_rows(a.M) == 24)
    return layout == KN ? launch<DECODE, FORM, KN, 24, FINE>(a, s)
                        : launch<DECODE, FORM, NK, 24, FINE>(a, s);
  if (plan == DECODE)
    return layout == KN ? launch<DECODE, FORM, KN, 32, FINE>(a, s)
                        : launch<DECODE, FORM, NK, 32, FINE>(a, s);
  return layout == KN ? launch<PREFILL, FORM, KN, 0, FINE>(a, s)
                      : launch<PREFILL, FORM, NK, 0, FINE>(a, s);
}

// int4 groups narrower than a k-step get their own instances (a scale
// lookup per byte row); every other launch keeps one lookup a k-step.
template <int FORM>
cudaError_t dispatch(const Args& a, int layout, int plan, cudaStream_t s) {
  if constexpr (FORM == INT4)
    if (a.gfine) return dispatch_plan<FORM, true>(a, layout, plan, s);
  return dispatch_plan<FORM, false>(a, layout, plan, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: [M, K] bf16 in rows of ldx elements (ldx % 16 == 0; the wrapper
// zero-pads a K tail); w: int8 bytes, layout 0 KN ([wrows, N]) or 1 NK ([N,
// wrows]), in rows of ldw bytes (ldw % 16 == 0; KN ldw >= N, NK ldw >=
// wrows); wrows = K (int8) or groups * gs / 2 (int4); ws: f32 [N] (int8) or
// [groups, N] / [N, groups] (int4) in rows of lds elements (KN: lds % 4 ==
// 0); out: [M, N] bf16.  Form 1 (W8A8) also takes xq [M, ldx] int8 and xs
// [M] f32, which its quantizer fills first.  part: [splits, M, ldp] f32 /
// int32 (ldp = N rounded up to 4) and arrivals (one zeroed int per output
// tile) when splits > 1.  geo: the 17 integers below, plan 0 DECODE / 1
// PREFILL; splits, unit_slabs, xpiece, srows and stages as
// ops/quant_matmul.launch_plan gives them (one array, so a call converts
// ten arguments).  int4 groups are even (a packed byte's two k share a
// scale); x, xq, w and ws are 16-byte aligned.
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* ws,
                                   void* out, void* xq, void* xs, void* part,
                                   void* arrivals, const int* geo, void* stream) {
  // geo: M, N, K, wrows, groups, gs, form, layout, plan, splits,
  // unit_slabs, xpiece, srows, stages, ldx, ldw, lds.
  const int M = geo[0], N = geo[1], K = geo[2], wrows = geo[3], groups = geo[4];
  const int gs = geo[5], form = geo[6], layout = geo[7], plan = geo[8];
  const int splits = geo[9], unit_slabs = geo[10], xpiece = geo[11];
  const int srows = geo[12], stages = geo[13];
  const int ldx = geo[14], ldw = geo[15], lds = geo[16];
  if (M <= 0 || N <= 0 || K <= 0 || form < INT8 || form > INT4 ||
      (layout != KN && layout != NK) || (plan != DECODE && plan != PREFILL) ||
      splits <= 0 || splits > 16 || unit_slabs <= 0 || ldx < K || ldx % 16 ||
      ldw % 16 || ldw < (layout == KN ? N : wrows) ||
      !aligned16(x) || !aligned16(w) || !aligned16(ws) ||
      (splits > 1 && (part == nullptr || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == INT4) {
    if (gs <= 0 || gs % 2 || groups <= 0 || srows <= 0 || srows > 256 ||
        static_cast<long long>(groups) * gs != 2LL * wrows || K > 2LL * wrows ||
        lds < (layout == KN ? N : groups) || (layout == KN && lds % 4) ||
        (static_cast<long long>(wrows) + 256) * (gs / 2) > 0x100000000LL)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (wrows != K ||
             (form == W8A8 && (xq == nullptr || xs == nullptr || !aligned16(xq)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.xs = static_cast<const float*>(xs);
  a.w = static_cast<const uint8_t*>(w);
  a.ws = static_cast<const float*>(ws);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = part;
  a.arrivals = static_cast<int*>(arrivals);
  a.M = M;
  a.N = N;
  a.K = K;
  a.wrows = wrows;
  a.groups = groups;
  a.gs = gs;
  a.gmagic = form == INT4 && gs > 2
                 ? static_cast<unsigned>((0x100000000ULL + gs / 2 - 1) / (gs / 2))
                 : 0u;
  a.gfine = form == INT4 && gs % 16 != 0;
  a.ldx = ldx;
  a.ldw = ldw;
  a.lds = lds;
  a.ldp = (N + 3) / 4 * 4;
  a.splits = splits;
  a.unit_slabs = unit_slabs;
  a.xpiece = xpiece;
  a.srows = srows;
  a.stages = stages;
  if (stages < 2 || stages > 8) return static_cast<int>(cudaErrorInvalidValue);
  a.stage_bytes = 0;
  if (form == W8A8) {
    // Over the padded row: its zeros change no amax and quantize to 0.
    quantize_rows_kernel<<<M, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                           static_cast<int8_t*>(xq),
                                           static_cast<float*>(xs), ldx);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    a.x = static_cast<const uint8_t*>(xq);
  }
  cudaError_t e;
  if (form == INT8)
    e = dispatch<INT8>(a, layout, plan, s);
  else if (form == W8A8)
    e = dispatch<W8A8>(a, layout, plan, s);
  else
    e = dispatch<INT4>(a, layout, plan, s);
  return static_cast<int>(e);
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
