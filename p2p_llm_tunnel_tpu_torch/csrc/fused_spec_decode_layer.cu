// The fused K-token speculative verify layer on Hopper (sm_90a): one launch
// per layer does, for T = K + 1 new rows per slot, the rope of the T query
// rows and new keys at positions pos + t, the quantization of the T new K/V
// rows to the cache's form, their in-place appends, and for each row t
// attention over the committed keys below pos, the burst's earlier rows and
// row t's own term.  bf16 activations, fp32 softmax.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// fused_spec_decode_layer (:1198, pallas_call :1365, kernel body
// _fused_spec_decode_layer_kernel :902) in its raw, int8 and int4 KV forms.
// Same function: q [B,T,H,D] and the new rows k/v [B,T,K,D] PRE-rope, the
// stacked cache [L,B,S,K,D] (raw bf16 or int8) or [L,B,S/2,K,D] (packed
// int4) with f32 scales [L,B,S,K], a layer index and the positions of burst
// row 0 [B] -> attention [B,T,H,D].  The output is held to the plain
// version and to T sequential kernel-4 launches within a tolerance, its
// appended bytes and scales bit for bit.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s, 989 TFLOP/s bf16): HBM bytes — each slot's committed prefix
// read once (2, 1 or 0.5 bytes per element plus 4-byte scales per (token,
// head)), q / new rows / output once, T rows written — at ~T*G FLOPs per
// cache element, far below the ~295 FLOP/byte ridge.  A verify burst reads
// the prefix once for all T rows where T decode steps read it T times.
//
// Design: split_kv_layer.cuh (split-KV grid, mma.sync products over the
// T*G rows padded to 16, cp.async double-buffered tiles, in-launch merge by
// the last block to arrive, appends after every read), with T read from the
// launch; kernel 4 (fused_decode_layer.cu) is the same body at T = 1.
//
// C ABI (loaded with ctypes): fused_spec_decode_layer_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>

#include "split_kv_layer.cuh"

namespace {

template <int D, int FORM>
__global__ void __launch_bounds__(split_kv::MAX_THREADS)
fused_spec_kernel(const split_kv::Args a) {
  split_kv::layer<D, FORM, 0>(a);
}

struct Spec {
  template <int D, int FORM>
  static auto kernel() { return &fused_spec_kernel<D, FORM>; }
};

}  // namespace

// T is the burst width (rows per slot); the rest as split_kv::run.
extern "C" int fused_spec_decode_layer_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* sin_t,
    const void* cos_t, const void* positions, void* out, void* part_acc,
    void* part_ml, void* arrivals, int B, int T, int S, int H, int KH, int D,
    int L, int layer, int view, int form, int nsplit, int split_keys,
    float scale, float softcap, int window, void* stream) {
  return split_kv::run<Spec>(q, k_new, v_new, k_cache, v_cache, k_scale,
                             v_scale, sin_t, cos_t, positions, out, part_acc,
                             part_ml, arrivals, B, T, S, H, KH, D, L, layer,
                             view, form, nsplit, split_keys, scale, softcap,
                             window, stream);
}

extern "C" const char* fused_spec_decode_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
