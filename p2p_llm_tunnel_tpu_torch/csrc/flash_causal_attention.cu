// Causal flash attention for prefill on Hopper (sm_90a), bf16 in / bf16 out,
// fp32 softmax and accumulation.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_attention.py flash_causal_attention
// (body _flash_kernel).  Same function: q [B,T,H,D], k/v [B,T,K,D] bf16,
// valid [B,T] bool -> out [B,T,H,D]; query head h reads KV head h / (H/K);
// scores are scaled, soft-capped, then masked by causality, the sliding
// window and the valid mask (in _flash_kernel's order); rows that see no key
// return 0.  Unlike the TPU kernel there is no T % 128 gate: the ragged edge
// is zero-filled on load and masked, so every prefill bucket runs here.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit:
// 989 TFLOP/s bf16, 3.35 TB/s): at the serving shapes (B 8, T 16..1024,
// H 32, K 8, D 128) the causal half of QK^T and PV is 2*B*H*T*T*D FLOPs
// against B*T*(2H+2K)*D*2 bytes in and out, an intensity of 0.4*T
// FLOP/byte: HBM bounds it below T ~ 740, the tensor cores above
// (chip_smoke.py computes both per shape; PERF.md has the measured times).
//
// Design: one block per (q-tile of 64 rows, head, batch row); 4 warps, each
// owning 16 query rows for the whole kernel, so the per-row online softmax
// needs no block barrier.  For each 64-key tile up to the causal frontier
// (tiles wholly past the last query row, or wholly before the first row's
// window, are never loaded) the block stages K and V in shared memory, the
// warps compute S = Q K^T with bf16 tensor-core MMAs (wmma 16x16x16, fp32
// accumulate), update m / l / the fp32 O accumulator in shared memory, and
// accumulate P V with a second MMA (P rounded to bf16).  This is the simple
// first version: synchronous loads, no wgmma/TMA pipeline, ~110 KB of shared
// memory per block at D 128, so two blocks share one H100 SM (228 KB).
//
// C ABI (loaded with ctypes): flash_causal_attention_bf16 returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <float.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int WARPS = 4;           // 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -0.7f * FLT_MAX;  // ops/attention.py _NEG_INF

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 pitch of the Q/K/V tiles
  static constexpr int LDS = BK + 4;  // fp32 pitch of the score tile
  static constexpr int LDP = BK + 8;  // bf16 pitch of the probability tile
  static constexpr int LDO = D + 4;   // fp32 pitch of the output accumulator
  // Byte offsets; every region starts on a 32-byte boundary (wmma needs it).
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + size_t(BQ) * LDH * 2;
  static constexpr size_t V = K + size_t(BK) * LDH * 2;
  static constexpr size_t S = V + size_t(BK) * LDH * 2;
  static constexpr size_t P = S + size_t(BQ) * LDS * 4;
  static constexpr size_t O = P + size_t(BQ) * LDP * 2;
  static constexpr size_t M = O + size_t(BQ) * LDO * 4;
  static constexpr size_t L = M + size_t(BQ) * 4;
  static constexpr size_t BYTES = L + size_t(BQ) * 4;
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

// Copy rows [row0, row0+64) of one head's [T, D] plane (row pitch `pitch`
// elements) into a shared tile; rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int T, size_t pitch) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH;
    const int cc = c - r * CH;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < T)
      val = *reinterpret_cast<const int4*>(src + size_t(row0 + r) * pitch + cc * 8);
    *reinterpret_cast<int4*>(dst + r * Layout<D>::LDH + cc * 8) = val;
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
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + LY::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + LY::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + LY::V);
  float* Ss = reinterpret_cast<float*>(smem + LY::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + LY::P);
  float* Os = reinterpret_cast<float*>(smem + LY::O);
  float* Ms = reinterpret_cast<float*>(smem + LY::M);
  float* Ls = reinterpret_cast<float*>(smem + LY::L);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const size_t q_pitch = size_t(H) * D;
  const size_t kv_pitch = size_t(KH) * D;
  const __nv_bfloat16* qb = q + size_t(b) * T * q_pitch + size_t(h) * D;
  const __nv_bfloat16* kb = k + size_t(b) * T * kv_pitch + size_t(kh) * D;
  const __nv_bfloat16* vb = v + size_t(b) * T * kv_pitch + size_t(kh) * D;
  const unsigned char* vrow = valid + size_t(b) * T;

  load_tile<D>(Qs, qb, q0, T, q_pitch);
  for (int i = threadIdx.x; i < BQ * LY::LDO; i += THREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.f;
  }

  // Causal frontier: key tile j matters only while j <= this q tile (BQ ==
  // BK).  Window floor: no row of the tile attends a key before
  // q0 - window + 1, so tiles wholly before it are skipped too.
  const int n_tiles = (T + BK - 1) / BK;
  const int tile_end = min(qt + 1, n_tiles);
  const int first_key = max(0, q0 - window + 1);
  const int tile_begin = min(first_key / BK, tile_end);

  for (int kt = tile_begin; kt < tile_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q/O initialised; previous tile's K/V reads done
    load_tile<D>(Ks, kb, k0, T, kv_pitch);
    load_tile<D>(Vs, vb, k0, T, kv_pitch);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LY::LDH + d0, LY::LDH);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // K stored [key][d] row-major is K^T in column-major.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + n * 16 * LY::LDH + d0, LY::LDH);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
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
      const int qpos = q0 + r;
      float sv[2];
      float mx = NEG_INF;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2;
        const int kpos = k0 + c;
        float s = Ss[r * LY::LDS + c] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const bool ok = kpos < T && kpos <= qpos && (qpos - kpos) < window &&
                        vrow[kpos] != 0;
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * LY::LDP + kk, LY::LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * LY::LDH + n0, LY::LDH);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(Os + warp * 16 * LY::LDO + n0, o, LY::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int c = i - r * D;
    const int qpos = q0 + r;
    if (qpos < T) {
      const float val = Os[r * LY::LDO + c] / fmaxf(Ls[r], 1e-30f);
      out[(size_t(b) * T + qpos) * q_pitch + size_t(h) * D + c] =
          __float2bfloat16(val);
    }
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
  dim3 grid((T + BQ - 1) / BQ, H, B);
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
  if (B <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || window <= 0)
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
