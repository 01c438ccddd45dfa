// Causal flash attention for prefill on Hopper (sm_90a), bf16 in / bf16 out,
// fp32 softmax and accumulation.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_attention.py flash_causal_attention
// (:136, body _flash_kernel :36).  Same function: q [B,T,H,D], k/v [B,T,K,D]
// bf16, valid [B,T] bool -> out [B,T,H,D]; query head h reads KV head
// h / (H/K); scores are scaled, soft-capped, then masked by causality, the
// sliding window and the valid mask (in _flash_kernel's order); rows that
// see no key return 0.  Unlike the TPU kernel there is no T % 128 gate: the
// ragged edge is zero-filled on load and masked, so every prefill bucket
// runs here.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit:
// 989 TFLOP/s bf16, 3.35 TB/s): at the serving shapes (B 8, T 128..1024,
// H 32, K 8, D 128) the causal half of QK^T and PV is 2*B*H*T*T*D FLOPs
// against B*T*(2H+2K)*D*2 bytes in and out, an intensity of 0.4*T
// FLOP/byte: HBM bounds it below T ~ 740, the tensor cores above
// (chip_smoke.py computes both per shape; PERF.md has the measured times).
//
// Design (FlashAttention-2 on mma.sync):
// - One block per (head, batch row, 64-row q tile); 4 warps, each owning 16
//   query rows.  The q tiles run last-first (the grid's slowest index walks
//   them backwards), so the causal triangle's heaviest blocks start first.
//   The G query heads of a KV head are neighbouring blocks, so their K/V
//   tiles are read from HBM about once and from L2 after (the G heads are
//   not packed into one block).
// - S, P and O stay in registers.  S = Q K^T and O += P V are mma.sync
//   m16n8k16 bf16 -> fp32 products whose fragments come from shared memory
//   with ldmatrix (V transposed on the way); P goes from the S accumulators
//   straight into A fragments.  A row's scores sit on the four lanes of a
//   quad, so its max and sum reduce over 2 shuffles; its sum is reduced
//   once, after the last tile.  Scores are carried in log2 units (log2(e)
//   folded into the scale) for exp2f.
// - K and V tiles come in with cp.async, 16 bytes a thread, double-buffered:
//   the next tile's copy is issued right after the one barrier per tile and
//   overlaps this tile's products.  Each tile's valid bytes are read one
//   tile ahead into registers and published to shared memory at the
//   barrier, which (__syncthreads_and) also tells every warp whether the
//   whole tile is valid.
// - Masks only where needed: a tile pays for the causal, window and valid
//   compares only when it is the diagonal tile, crosses the window's edge,
//   reaches past T or holds an invalid key; the soft cap (tanhf) runs only
//   when it is set.
// - Shared memory: q [64, D+8] and two stages of K and V [64, D+8] bf16
//   (87 KB at D 128, two blocks per SM; 169 KB at D 256); the output leaves
//   through each warp's own q rows as 16-byte stores.  wgmma and TMA are not
//   used: at these T the kernel is bound by HBM bytes and latency, and 64-row
//   tiles keep 4-16 tiles of work per block.
//
// C ABI (loaded with ctypes): flash_causal_attention_bf16 returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "tensor_tile.cuh"

namespace {

using namespace tensor_tile;

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile (== BQ: one diagonal tile)
constexpr int WARPS = 4;           // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;             // bf16 row padding: conflict-free ldmatrix
constexpr float NEG_INF = -0.7f * FLT_MAX;  // ops/attention.py _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int P = D + PAD;  // bf16 pitch of the q/K/V tiles
  static constexpr size_t TILE = size_t(BK) * P * 2;
  // Byte offsets; every region starts on a 16-byte boundary.
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + size_t(BQ) * P * 2;  // two stages
  static constexpr size_t V = K + 2 * TILE;            // two stages
  static constexpr size_t VALID = V + 2 * TILE;        // two stages of BK bytes
  static constexpr size_t BYTES = VALID + 2 * BK;
};

// Copy rows [row0, row0+64) of one head's [T, D] plane (row pitch `pitch`
// elements) into a shared tile with cp.async; rows at or past T are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int T, size_t pitch) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH;
    const int cc = c - r * CH;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * Layout<D>::P + cc * 8,
               src + size_t(ok ? row0 + r : 0) * pitch + cc * 8, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_causal_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    __nv_bfloat16* __restrict__ out,
                    int T, int H, int KH, float scale, float softcap,
                    int window) {
  using LY = Layout<D>;
  constexpr int P = LY::P;
  constexpr int NT = D / 8;  // n-tiles of an output row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + LY::Q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + LY::K);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + LY::V);
  unsigned char* vm = smem + LY::VALID;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest q tiles first
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // mma group: row (A, C) or column (B)
  const int tig = lane & 3;   // thread in group

  const size_t q_pitch = size_t(H) * D;
  const size_t kv_pitch = size_t(KH) * D;
  const __nv_bfloat16* qb = q + size_t(b) * T * q_pitch + size_t(h) * D;
  const __nv_bfloat16* kb = k + size_t(b) * T * kv_pitch + size_t(kh) * D;
  const __nv_bfloat16* vb = v + size_t(b) * T * kv_pitch + size_t(kh) * D;
  const unsigned char* vrow = valid + size_t(b) * T;

  // Causal frontier: key tile j matters only while j <= this q tile (BQ ==
  // BK).  Window floor: no row of the tile attends a key before
  // q0 - window + 1, so tiles wholly before it are skipped too.
  const int tile_end = min(qt + 1, (T + BK - 1) / BK);
  const int first_key = max(0, q0 - window + 1);
  const int tile_begin = min(first_key / BK, tile_end);
  const int n_tiles = tile_end - tile_begin;

  load_tile<D>(qs, qb, q0, T, q_pitch);
  if (n_tiles > 0) {
    load_tile<D>(ks, kb, tile_begin * BK, T, kv_pitch);
    load_tile<D>(vs, vb, tile_begin * BK, T, kv_pitch);
  }
  cp_async_commit();
  // Thread j < BK holds key j's valid flag of the tile to come (keys at or
  // past T are invalid); the other threads hold 1.
  int vflag = 1;
  if (n_tiles > 0 && tid < BK) {
    const int kp = tile_begin * BK + tid;
    vflag = kp < T && vrow[kp] != 0;
  }

  const int rA = q0 + warp * 16 + gid;  // the two rows this lane holds
  const int rB = rA + 8;
  const float sl2 = scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_l2 = softcap * LOG2E;
  float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;  // log2 units
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (tile_begin + it) * BK;
    const int buf = it & 1;
    if (tid < BK) vm[buf * BK + tid] = static_cast<unsigned char>(vflag);
    cp_async_wait<0>();
    // The one barrier of the tile: its K/V (and q) landed for every thread,
    // every warp is done with the other stage, its valid flags are in
    // place — and whether all of them are set.
    const bool all_valid = __syncthreads_and(vflag) != 0;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (buf ^ 1) * BK * P, kb, k0 + BK, T, kv_pitch);
      load_tile<D>(vs + (buf ^ 1) * BK * P, vb, k0 + BK, T, kv_pitch);
      cp_async_commit();
      if (tid < BK) {
        const int kp = k0 + BK + tid;
        vflag = kp < T && vrow[kp] != 0;
      }
    }
    const __nv_bfloat16* kt = ks + buf * BK * P;
    const __nv_bfloat16* vt = vs + buf * BK * P;

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

    // Scale (and cap) into log2 units; mask only the tiles that need it.
    if (softcap > 0.f) {
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
    const bool need_mask = !all_valid || k0 + BK - 1 > q0 ||
                           (q0 + BQ - 1) - k0 >= window;
    if (need_mask) {
      const unsigned char* vmb = vm + buf * BK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * tig + (e & 1);
          const int kp = k0 + c;
          const int r = e < 2 ? rA : rB;
          if (!(vmb[c] && kp <= r && r - kp < window)) s[j][e] = NEG_INF;
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
  // (n_tiles >= 1: the diagonal tile always runs, so every copy, q's too,
  // was waited for behind a barrier.)
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
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < T)
      *reinterpret_cast<int4*>(out + (size_t(b) * T + qpos) * q_pitch + size_t(h) * D + c) =
          *reinterpret_cast<const int4*>(os + r * P + c);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, int B, int T, int H, int KH,
                   float scale, float softcap, int window,
                   cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(Layout<D>::BYTES);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_causal_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(H, B, (T + BQ - 1) / BQ);
  flash_causal_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const unsigned char*>(valid),
      static_cast<__nv_bfloat16*>(out), T, H, KH, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_causal_attention_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int T, int H, int KH, int D, float scale, float softcap,
    int window, void* stream) {
  if (B <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || window <= 0 ||
      B > 65535 || (T + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, valid, out, B, T, H, KH,
                                         scale, softcap, window, s));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, valid, out, B, T, H, KH,
                                         scale, softcap, window, s));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, valid, out, B, T, H, KH,
                                         scale, softcap, window, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, valid, out, B, T, H, KH,
                                          scale, softcap, window, s));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, valid, out, B, T, H, KH,
                                          scale, softcap, window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_causal_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
