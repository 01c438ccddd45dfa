// Slot-decode attention on Hopper (sm_90a): one query token per slot against
// that slot's KV cache — raw bf16, int8, or packed int4 — with fp32 softmax
// and accumulation.
//
// Replaces: p2p_llm_tunnel_tpu/ops/pallas_decode_attention.py
// flash_decode_attention_sgrid (pallas_call :446) and its _int8 / _int4
// entries (:468, :484): one body, _decode_kernel_sgrid, for the three cache
// forms.  Same function: q [B,1,H,D] (roped), k/v cache [B,S,K,D] (any slot
// stride — the model passes a strided [:, :view] window of the
// [L,B,S_max,K,D] cache, so no copy), positions [B] -> out [B,1,H,D]; key j
// is attended iff j <= pos and pos - j < window, scores scaled then
// optionally soft-capped; parked rows (pos >= S) attend the whole view and
// never read out of bounds; rows that see no key emit 0.  Quantized forms
// read int8 values [B,S,K,D] or packed int4 bytes [B,S/2,K,D] (token 2i in
// the low nibble of byte i, 2i+1 in the high) plus f32 per-(token, head)
// scales [B,S,K].  The Pallas body dequantizes in fp32 (value x scale);
// here the integers feed the bf16 products (exact) and the scales ride on
// the score column and on P, so the output is held to the plain version
// within a tolerance, not bitwise.
//
// Bound on the card (published peaks of an H100 SXM at its 700 W limit,
// 3.35 TB/s): decode reads the live K/V prefix once — B * (frontier+1) *
// K * D * (2 bytes bf16 | 1 byte int8 | 0.5 byte int4) * 2, plus 4-byte
// scales per (token, head) when quantized — for ~G FLOPs per cache element,
// far below the card's ~295 FLOP/byte ridge: HBM bandwidth bounds it.  At
// the serving shape (B 17, K 8, S 512) that is 1-4 us of bytes, so what
// bounds a launch in practice is latency: the chain of tile loads and
// products one block walks, and the merge.
//
// Design: the split-KV body of the fused decode layers (split_kv_layer.cuh,
// kernels 4 and 5) in its attention-only mode, under its own kernel name.
// The grid is (KV head, slot, split), the splits from the wrapper
// (ops/fused_decode.kv_splits: 4 of 128 keys and 544 blocks at the serving
// shape, where one block per (KV head, slot) walking the whole frontier gave
// 136 blocks on 132 SMs); the G query rows are padded to one 16-row
// mma.sync tile and the warps share each 64-key tile by key slices, with S,
// P and O in registers; K/V tiles come in by cp.async, double-buffered, 16
// bytes a thread; the last block of each (slot, head) to arrive merges the
// splits' partials in split order (the same output run to run) and resets
// its arrival counter.
//
// C ABI (loaded with ctypes): flash_decode_attention_launch returns the
// cudaError_t of the launch (0 = launched).

#include <cuda_runtime.h>

#include "split_kv_layer.cuh"

namespace {

template <int D, int FORM>
__global__ void __launch_bounds__(split_kv::MAX_THREADS)
flash_decode_kernel(const split_kv::Args a) {
  split_kv::layer<D, FORM, 1, true>(a);
}

struct SlotDecode {
  template <int D, int FORM>
  static auto kernel() { return &flash_decode_kernel<D, FORM>; }
};

}  // namespace

// S is the view's token count (for int4 the byte planes hold S/2 rows);
// slot_stride is in cache elements (bf16 for raw, bytes for int8/int4),
// scale_slot_stride in floats; form 0 raw, 1 int8, 2 int4; nsplit splits of
// split_keys keys (a multiple of 64) cover [0, S); the workspace holds
// nsplit * key_slices partials per (slot, head) and the arrival counters
// [B*K] are 0 on entry and on exit.
extern "C" int flash_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, void* out, void* part_acc,
    void* part_ml, void* arrivals, int B, int S, int H, int KH, int D,
    long long slot_stride, long long scale_slot_stride, int form, int nsplit,
    int split_keys, float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
      H / KH > split_kv::MAX_ROWS || window <= 0 || form < kv_forms::RAW ||
      form > kv_forms::INT4 || (form == kv_forms::INT4 && S % 2) ||
      nsplit <= 0 || split_keys <= 0 || split_keys % decode_tile::BS ||
      static_cast<long long>(nsplit) * split_keys < S || part_acc == nullptr ||
      part_ml == nullptr || arrivals == nullptr ||
      (form != kv_forms::RAW && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  split_kv::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_cache = const_cast<void*>(k);
  a.v_cache = const_cast<void*>(v);
  a.k_scale = static_cast<float*>(const_cast<void*>(k_scale));
  a.v_scale = static_cast<float*>(const_cast<void*>(v_scale));
  a.positions = static_cast<const int*>(positions);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.arrivals = static_cast<int*>(arrivals);
  a.B = B;
  a.T = 1;
  a.S = S;
  a.H = H;
  a.KH = KH;
  a.layer = 0;
  a.view = S;
  a.nsplit = nsplit;
  a.split_keys = split_keys;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  a.slot_stride = slot_stride;
  a.scale_slot_stride = scale_slot_stride;
  return static_cast<int>(split_kv::dispatch<SlotDecode>(
      D, form, a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
