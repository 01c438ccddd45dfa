// The legacy whole-plane slot-decode attention on Hopper (sm_90a): one query
// token per slot against its raw bf16 KV cache, fp32 softmax and
// accumulation.  A cross-check of kernel 2's online softmax only: no
// serving path calls it, in this port or in the JAX package.  It shares no
// code with kernels 2, 4 and 5 (their split-KV body, its launch plan,
// workspace and arrival counters), so it is a second opinion on their
// split-and-merge.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// flash_decode_attention_plane (:179, pallas_call :219, kernel body
// _decode_kernel :105).  Same function: q [B,1,H,D], k/v cache [B,S,K,D]
// raw (any slot stride), positions [B] -> out [B,1,H,D]; the scores are
// q.k times the softmax scale in fp32, key j is attended iff j <= pos (the
// query token's own row included, unlike kernel 4's < pos) and pos - j <
// window ("no window" is INT32_MAX); parked rows (pos >= S) attend the
// whole plane.  S % 128 == 0 (the reference's block), head_dim 16-256, G =
// H / K <= 8.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit):
// HBM bytes — each slot's K/V plane up to its frontier read once at 2
// bytes per element, 3.35 TB/s — at ~2G FLOPs per cache element, far below
// the ~295 FLOP/byte ridge.  So the design is about bytes in flight.
//
// Design: a thread-block cluster per (slot, KV head), split along S.
// - Grid (rank, KV head, slot), clusters of C = 1, 2, 4 or 8 CTAs along the
//   rank axis (cudaLaunchKernelEx).  C, the 64-key tiles of each CTA and
//   the ring depth come from ops/decode_attention.plane_plan, which aims at
//   two CTAs an SM: each CTA pays a fixed cost (first tile's latency,
//   barriers, merges; ~11 us of life at B 17, view 512) that more CTAs
//   do not hide, and clusters of 4 no longer fit one wave.  Rank r walks its own contiguous tiles
//   from key 0 upward, cut at min(pos, S - 1): it never loads a tile past
//   the frontier (a CTA whose range starts there loads nothing and reports
//   an empty partial).  There is no window-floor skip, as in the plane
//   body, so kernel 2's floor logic is checked from outside.
// - K and V tiles stay bf16 in a 2-stage ring of shared memory (1 stage
//   when a CTA holds one tile), fed by
//   TMA (cp.async.bulk.tensor over the cache seen as [B, S, K*D] with its
//   slot stride, boxes of 64 keys x 64 elements in the 128-byte swizzle;
//   D < 64: one unswizzled box), issued by one thread of a producer warp,
//   completing on the stage's full mbarrier; consumers free a stage
//   through its empty mbarrier.
// - Four consumer warps, 16 keys of each tile a warp, both products on
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate): scores
//   S^T [16 keys x 8 rows] = K Q^T (keys the 16-row side, the G <= 8 query
//   rows the 8-wide side, q unrounded bf16 in registers), the online
//   softmax in fp32 per warp, P rounded once to bf16 and transposed in
//   registers (movmatrix) into the B operand of O^T [D x 8] += V^T P^T, V
//   read transposed by ldmatrix.trans.
// - Merge through distributed shared memory, never global memory: each
//   warp leaves (m, l, acc) in f32 in shared memory, the CTA merges its
//   four warps in order, then every CTA waits at a cluster barrier; rank 0
//   reads each rank's partial through map_shared_rank, merges them in rank
//   order (bitwise the same from run to run) and writes the bf16 output.
//   Both merges take each row's factors once (one expf a partial and row),
//   then rescale and add the accumulators element by element; a
//   second cluster barrier keeps every CTA resident until rank 0 has read
//   it.  No workspace, no counter, no memset: a launch can be replayed in a
//   CUDA graph.
//
// C ABI (loaded with ctypes): flash_decode_attention_plane_launch returns
// the cudaError_t of the launch (0 = launched); a cluster the card refuses
// or shared memory past its 227 KB comes back as an error, never as a
// smaller launch.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tile.cuh"
#include "tensor_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BLOCK = 128;         // the reference's key block: S % BLOCK == 0
constexpr int TILE = 64;           // keys per ring tile (two per block)
constexpr int CONSUMERS = 4;       // consumer warps, 16 keys of a tile each
constexpr int THREADS = (CONSUMERS + 1) * 32;  // + the producer warp
constexpr int MAX_G = 8;
constexpr int MAX_STAGES = 2;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int HEADER = 1024;       // mbarriers, merge factors; the ring 1 KB on
constexpr int SLACK = 1024;        // aligning the dynamic base to 1 KB
constexpr int MAX_SMEM = 232448;   // the H100's opt-in per block

using decode_tile::NEG_INF;

template <int D>
struct Geo {
  static constexpr int BOX = D >= 64 ? 64 : D;  // elements of a box row
  static constexpr bool SWIZZLE = D >= 64;      // 128-byte rows, swizzled
  static constexpr int NBOX = D / BOX;
  static constexpr int BOX_BYTES = TILE * BOX * 2;
  static constexpr int TILE_BYTES = TILE * D * 2;      // K or V
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // K, then V
};

// One partial of the softmax: each query row's running max and sum, and
// its [G, D] f32 accumulator.
template <int D>
struct Partial {
  float m[MAX_G];
  float l[MAX_G];
  float acc[MAX_G * D];
};

// Shared memory a launch needs: slack, header and ring.  The four warp
// partials and the CTA's partial reuse the ring once it is drained.
constexpr int smem_bytes(int D, int stages) {
  return SLACK + HEADER + stages * 2 * TILE * D * 2;
}
static_assert(5 * sizeof(Partial<16>) <= Geo<16>::STAGE_BYTES, "partials fit a stage");

// Byte offset of (key r, element c) in one K or V tile: NBOX boxes of 64
// rows; in the 128-byte swizzle a row's 16-byte chunks are permuted by the
// row's index mod 8 (the ring is 1 KB aligned, so TMA's pattern is this).
template <int D>
__device__ __forceinline__ int tile_off(int r, int c) {
  using G = Geo<D>;
  const int box = c / G::BOX;
  const int b = (c % G::BOX) * 2;
  if constexpr (G::SWIZZLE)
    return box * G::BOX_BYTES + r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
  else
    return box * G::BOX_BYTES + r * (G::BOX * 2) + b;
}

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

// The producer's arrival on a full barrier, with the bytes its copies bring.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete.  A wait past ~10 s of clocks
// traps (a launch error) instead of hanging the card.
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

// One box of a 3-D tensor map (element c0, key c1, slot c2) into shared
// memory at dst, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0,
                                        int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// An 8x8 b16 matrix, one row of two values a quad of lanes, transposed
// across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Row g of `count` partials merged in order: m the max of their maxima,
// f[c * MAX_G + g] the factor that rescales partial c to it (0 for a
// partial that saw no key), l their sums rescaled and added in order.
template <int D>
__device__ __forceinline__ void row_factors(const Partial<D>* const* src, int count,
                                            int g, float* f, float& m, float& l) {
  m = NEG_INF;
#pragma unroll
  for (int c = 0; c < MAX_CLUSTER; ++c)
    if (c < count) m = fmaxf(m, src[c]->m[g]);
  l = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CLUSTER; ++c) {
    if (c < count) {
      const float mc = src[c]->m[g];
      const float fc = mc == NEG_INF ? 0.f : expf(mc - m);
      f[c * MAX_G + g] = fc;
      l = __fadd_rn(l, __fmul_rn(src[c]->l[g], fc));
    }
  }
}

// Element i = g * D + d of the accumulators of `count` partials, rescaled
// by their row factors and added in order.
template <int D>
__device__ __forceinline__ float merged_acc(const Partial<D>* const* src, int count,
                                            const float* f, int g, int i) {
  float a[MAX_CLUSTER];
#pragma unroll
  for (int c = 0; c < MAX_CLUSTER; ++c) a[c] = c < count ? src[c]->acc[i] : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_CLUSTER; ++c)
    if (c < count) sum = __fadd_rn(sum, __fmul_rn(a[c], f[c * MAX_G + g]));
  return sum;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
plane_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __nv_bfloat16* __restrict__ q,
                    const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int S, int H, int KH,
                    int tiles_per_cta, int stages, float scale, float softcap,
                    int window) {
  using G = Geo<D>;
  constexpr int KS = D / 16;  // 16-wide steps along D
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SLACK - 1) & ~uintptr_t(SLACK - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + MAX_STAGES;
  float* fac = reinterpret_cast<float*>(sm + 64);  // [MAX_CLUSTER][MAX_G] merge factors
  float* fsum = fac + MAX_CLUSTER * MAX_G;         // [MAX_G] merged sums
  uint8_t* ring = sm + HEADER;
  Partial<D>* parts = reinterpret_cast<Partial<D>*>(ring);  // after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = H / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[b];
  const int last = min(pos, S - 1);
  const int t0 = rank * tiles_per_cta;
  const int n = max(min(t0 + tiles_per_cta, last / TILE + 1) - t0, 0);

  const bool producer = warp == CONSUMERS && lane == 0;
  if (producer) {
    // The tensor maps' descriptors are fetched while the block sets up.
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap))
                 : "memory");
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // The producer: one thread keeps the ring full, tile after tile.
    if (producer) {
      for (int i = 0; i < n; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + s, (i / stages - 1) & 1);
        mbar_arrive_expect_tx(full + s, G::STAGE_BYTES);
        uint8_t* kt = ring + s * G::STAGE_BYTES;
        const int key0 = (t0 + i) * TILE;
#pragma unroll
        for (int x = 0; x < G::NBOX; ++x) {
          tma_box(kt + x * G::BOX_BYTES, &kmap, kh * D + x * G::BOX, key0, b, full + s);
          tma_box(kt + G::TILE_BYTES + x * G::BOX_BYTES, &vmap, kh * D + x * G::BOX,
                  key0, b, full + s);
        }
      }
    }
  } else {
    // Q^T as mma's B operand, unrounded bf16: b0 = Q[g][16ks + 2(lane%4)
    // + {0,1}] for g = lane/4, b1 the same 8 elements on; rows past G are 0.
    const int gq = lane >> 2;
    uint32_t qf[KS][2];
    const __nv_bfloat16* qrow = q + (size_t(b) * H + size_t(kh) * grp + gq) * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = qf[ks][1] = 0u;
      if (gq < grp) {
        qf[ks][0] = tensor_tile::ld_u32(qrow + ks * 16 + 2 * (lane & 3));
        qf[ks][1] = tensor_tile::ld_u32(qrow + ks * 16 + 2 * (lane & 3) + 8);
      }
    }
    // O^T [D x 8]: acc[dc][0..1] at d = 16dc + lane/4, acc[dc][2..3] at d +
    // 8, rows g = 2(lane%4) + {0,1}; m, l of those two rows (l a partial
    // sum over this lane's keys until the end).
    float acc[KS][4];
#pragma unroll
    for (int dc = 0; dc < KS; ++dc) acc[dc][0] = acc[dc][1] = acc[dc][2] = acc[dc][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    for (int i = 0; i < n; ++i) {
      const int s = i % stages;
      mbar_wait(full + s, (i / stages) & 1);
      const uint8_t* kt = ring + s * G::STAGE_BYTES;
      uint8_t* vt = ring + s * G::STAGE_BYTES + G::TILE_BYTES;
      const int r0 = 16 * warp;                  // this warp's rows of the tile
      const int key0 = (t0 + i) * TILE + r0;

      // S^T = K Q^T: sc[0..1] key key0 + lane/4, sc[2..3] key + 8, rows
      // g = 2(lane%4) + {0,1}.
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        tensor_tile::ldmatrix_x4(
            a, kt + tile_off<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                ks * 16 + (lane >> 4) * 8));
        tensor_tile::mma_bf16(sc, a, qf[ks][0], qf[ks][1]);
      }

      // Online softmax in fp32, per warp.
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = key0 + (lane >> 2) + (e >> 1) * 8;
        const float v = decode_tile::soft_cap(__fmul_rn(sc[e], scale), softcap);
        sc[e] = (kp <= last && pos - kp < window) ? v : NEG_INF;
        mx[e & 1] = fmaxf(mx[e & 1], sc[e]);
      }
      float corr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
        const float m_new = fmaxf(m[j], mx[j]);
        corr[j] = m[j] == NEG_INF ? 0.f : expf(m[j] - m_new);
        m[j] = m_new;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = sc[e] == NEG_INF ? 0.f : expf(sc[e] - m[e & 1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        l[j] = __fadd_rn(__fmul_rn(l[j], corr[j]), __fadd_rn(p[j], p[j + 2]));
#pragma unroll
      for (int dc = 0; dc < KS; ++dc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dc][e] = __fmul_rn(acc[dc][e], corr[e & 1]);

      // Rows past the frontier hold whatever the cache holds there: P is 0
      // on them, but 0 * NaN is not 0, so they are zeroed (only the CTA's
      // last tile has such rows; no copy lands in the ring after it).
      if (key0 + 15 > last) {
        constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
        for (int c = lane; c < 16 * CHUNKS; c += 32) {
          const int r = c / CHUNKS, ch = c % CHUNKS;
          if (key0 + r > last)
            *reinterpret_cast<uint4*>(vt + (ch / (G::BOX / 8)) * G::BOX_BYTES +
                                      (r0 + r) * (G::BOX * 2) +
                                      (ch % (G::BOX / 8)) * 16) = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }

      // P^T as the B operand: P [keys x rows] rounded to bf16 once, each
      // 8x8 half transposed in registers.
      const uint32_t b0 = transpose8x8(tensor_tile::pack_bf16(p[0], p[1]));
      const uint32_t b1 = transpose8x8(tensor_tile::pack_bf16(p[2], p[3]));
      // O^T += V^T P^T, V^T's fragments read transposed from the V tile.
#pragma unroll
      for (int dc = 0; dc < KS; ++dc) {
        uint32_t a[4];
        tensor_tile::ldmatrix_x4_trans(
            a, vt + tile_off<D>(r0 + (lane & 7) + (lane >> 4) * 8,
                                dc * 16 + ((lane >> 3) & 1) * 8));
        tensor_tile::mma_bf16(acc[dc], a, b0, b1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // The warp's partial: l summed over the lanes of each row, written
    // over the ring once every consumer warp is done reading it (every
    // copy has landed: each consumer waited on every full barrier).
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[j] = __fadd_rn(l[j], __shfl_xor_sync(0xffffffffu, l[j], off));
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 32) : "memory");
    Partial<D>& wp = parts[warp];
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wp.m[2 * lane + j] = m[j];
        wp.l[2 * lane + j] = l[j];
      }
    }
#pragma unroll
    for (int dc = 0; dc < KS; ++dc) {
      const int d = dc * 16 + (lane >> 2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wp.acc[(2 * (lane & 3) + (e & 1)) * D + d + (e >> 1) * 8] = acc[dc][e];
    }
  }
  __syncthreads();

  // The CTA's partial: its four warps merged in order, each row's factors
  // computed once.
  Partial<D>& cp = parts[CONSUMERS];
  {
    const Partial<D>* src[MAX_CLUSTER] = {parts, parts + 1, parts + 2, parts + 3};
    if (threadIdx.x < grp) row_factors<D>(src, CONSUMERS, threadIdx.x, fac,
                                          cp.m[threadIdx.x], cp.l[threadIdx.x]);
    __syncthreads();
    for (int i = threadIdx.x; i < grp * D; i += THREADS)
      cp.acc[i] = merged_acc<D>(src, CONSUMERS, fac, i / D, i);
  }
  cluster.sync();  // every rank's partial is written

  // Rank 0 reads every rank's partial from its shared memory and merges
  // them in rank order.
  if (rank == 0) {
    const Partial<D>* src[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      src[r] = r < nrank ? cluster.map_shared_rank(&cp, r) : &cp;
    if (threadIdx.x < grp) {
      float mm;
      row_factors<D>(src, nrank, threadIdx.x, fac, mm, fsum[threadIdx.x]);
    }
    __syncthreads();
    __nv_bfloat16* o = out + (size_t(b) * H + size_t(kh) * grp) * D;
    for (int i = threadIdx.x; i < grp * D; i += THREADS) {
      const int g = i / D;
      o[i] = __float2bfloat16(
          __fdiv_rn(merged_acc<D>(src, nrank, fac, g, i), fmaxf(fsum[g], 1e-30f)));
    }
  }
  cluster.sync();  // every rank stays resident until rank 0 has read it
}

// A 3-D tensor map over a raw cache [B, S, KH*D] bf16 with its slot stride
// (elements): boxes of BOX elements x 64 keys x 1 slot, the 128-byte
// swizzle where a box row is 128 bytes.  cuTensorMapEncodeTiled is the
// driver's, reached through the runtime's entry-point query (no driver
// stub linked).
template <int D>
cudaError_t encode(CUtensorMap* map, const void* base, int B, int S, int KH,
                   long long slot_stride) {
  using G = Geo<D>;
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult qr;
    void* p = nullptr;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr);
    if (e != cudaSuccess || qr != cudaDriverEntryPointSuccess || p == nullptr)
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(KH) * D,
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(KH) * D * 2,
                                 static_cast<cuuint64_t>(slot_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::BOX), TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        G::SWIZZLE ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* positions,
                   void* out, int B, int S, int H, int KH, long long slot_stride,
                   float scale, float softcap, int window, int cluster, int tiles,
                   int stages, int smem, cudaStream_t stream) {
  if (smem < smem_bytes(D, stages)) return cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  cudaError_t e = encode<D>(&kmap, k, B, S, KH, slot_stride);
  if (e == cudaSuccess) e = encode<D>(&vmap, v, B, S, KH, slot_stride);
  if (e != cudaSuccess) return e;
  // The opt-in grows to the largest launch seen.
  static int configured = 0;
  if (smem > configured) {
    e = cudaFuncSetAttribute(plane_decode_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KH, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const int* pp = static_cast<const int*>(positions);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  void* args[] = {&kmap, &vmap, &qp, &pp, &op, &S, &H, &KH, &tiles, &stages,
                  &scale, &softcap, &window};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(plane_decode_kernel<D>),
                          args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// S is the plane's token count (a multiple of 128, as the Pallas wrapper
// requires); slot_stride is in bf16 elements (16-byte aligned, as is each
// cache's base).  cluster, tiles_per_cta, stages and smem_bytes are the
// plan of ops/decode_attention.plane_plan: the cluster's tiles must cover
// the plane, and smem_bytes hold the ring.
extern "C" int flash_decode_attention_plane_launch(
    const void* q, const void* k, const void* v, const void* positions,
    void* out, int B, int S, int H, int KH, int D, long long slot_stride,
    float scale, float softcap, int window, int cluster, int tiles_per_cta,
    int stages, int smem, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S % BLOCK != 0 || KH <= 0 || KH > 65535 ||
      H % KH != 0 || H / KH > MAX_G || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      tiles_per_cta <= 0 || static_cast<long long>(cluster) * tiles_per_cta * TILE < S ||
      stages < 1 || stages > MAX_STAGES || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define PLANE_CASE(DD)                                                          \
  case DD:                                                                      \
    return static_cast<int>(launch<DD>(q, k, v, positions, out, B, S, H, KH,    \
                                       slot_stride, scale, softcap, window,     \
                                       cluster, tiles_per_cta, stages, smem, s));
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
