// The fused decode layer on Hopper (sm_90a): one launch per layer does the
// whole decode attention sub-block for every slot — rope of q and of the
// new key row, the new row's quantization to the cache's form, its in-place
// append, and attention over the cache's keys below the slot's position plus
// the new row's own term.  bf16 activations, fp32 softmax.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// fused_decode_layer (:728, pallas_call :877, kernel body
// _fused_decode_layer_kernel :510) in its raw, int8 and int4 KV forms.
// Same function: q [B,H,D] and the new rows k/v [B,K,D] PRE-rope, the full
// stacked cache [L,B,S,K,D] (raw bf16 or int8) or [L,B,S/2,K,D] (packed
// int4: token 2i in the low nibble of byte i, 2i+1 in the high) with f32
// scales [L,B,S,K], a layer index and the positions [B] -> attention
// [B,H,D].  Per slot, as the Pallas body: q and the new key roped in fp32
// (q pre-scaled), the new row quantized from those fp32 values (scale =
// max(amax, 1e-8) / qmax by IEEE division, rint half to even, clipped to
// +-127 or +-7), cache keys attended strictly below pos within the window,
// the new row's own term folded last from its dequantized fp32 values (raw:
// the unrounded fp32 row; the cache stores it rounded to bf16), rows at
// pos >= view parked (nothing stored, the output is junk).  Its appended
// bytes and scales are bit for bit the plain version's; its attention is
// held to the plain version within a tolerance (bf16 q and P in the
// products, another summation order).
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s): HBM bytes — each slot's live cache prefix (pos keys x K x D
// at 2, 1 or 0.5 bytes, plus 4-byte scales per (token, head) when
// quantized) read once, q / new rows / output once, one cache row written —
// at ~G FLOPs per cache element, far below the ~295 FLOP/byte ridge.  At
// the serving shape (B 17, K 8, view 512) that is 1-4 us of bytes, so what
// bounds a launch in practice is latency: the chain of loads, products and
// the merge of one block.
//
// Design: the split-KV body of the fused verify layer (split_kv_layer.cuh),
// instantiated with one row per slot fixed at compile time under its own
// kernel name.  The grid is (KV head, slot, split) — 4 splits of 128 keys
// and 544 blocks at the serving shape, where one block per (KV head, slot)
// gave 136 blocks on 132 SMs; the G query rows are padded to one 16-row
// mma.sync tile and four warps share each 64-key tile by 16-key slices;
// K/V tiles come in by cp.async, double-buffered, 16 bytes a thread; the
// quantized forms feed their integers to the products with the scales on
// the score column and on P (no fp32 dequantization pass); the last block
// of each (slot, head) to arrive merges the partials, folds the new row,
// writes the output and then appends (after every read of the int4 byte
// the append shares with token pos - 1).
//
// C ABI (loaded with ctypes): fused_decode_layer_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>

#include "split_kv_layer.cuh"

namespace {

template <int D, int FORM>
__global__ void __launch_bounds__(split_kv::MAX_THREADS)
fused_decode_layer_kernel(const split_kv::Args a) {
  split_kv::layer<D, FORM, 1>(a);
}

struct Decode {
  template <int D, int FORM>
  static auto kernel() { return &fused_decode_layer_kernel<D, FORM>; }
};

}  // namespace

// One new row per slot (split_kv::run at T = 1): sin/cos are the [B, D/2]
// rope rows at the slots' positions, and the workspace holds nsplit *
// key_slices partials per (slot, head).
extern "C" int fused_decode_layer_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* sin_t,
    const void* cos_t, const void* positions, void* out, void* part_acc,
    void* part_ml, void* arrivals, int B, int S, int H, int KH, int D, int L,
    int layer, int view, int form, int nsplit, int split_keys, float scale,
    float softcap, int window, void* stream) {
  return split_kv::run<Decode>(q, k_new, v_new, k_cache, v_cache, k_scale,
                               v_scale, sin_t, cos_t, positions, out,
                               part_acc, part_ml, arrivals, B, 1, S, H, KH, D,
                               L, layer, view, form, nsplit, split_keys,
                               scale, softcap, window, stream);
}

extern "C" const char* fused_decode_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
