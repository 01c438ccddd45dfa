// The KV cache forms the kernels read: raw bf16, int8 values, or packed
// int4 (token 2i in the low nibble of byte i, 2i+1 in the high; the layout
// of models/quant.pack_int4 along the sequence axis), the quantized forms
// with one f32 scale per (token, head).  Dequantization is value x scale in
// fp32, one rounding, never rounded further here (the Pallas bodies' rule
// for attention over the cache).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace kv_forms {

enum Form { RAW = 0, INT8 = 1, INT4 = 2 };

// Sign-extended nibble of a packed byte: the low one for even tokens, the
// high one for odd (models/quant.unpack_int4).
__device__ __forceinline__ int nibble(int8_t b, int odd) {
  const int u = static_cast<uint8_t>(b);
  const int n = odd ? (u >> 4) : (u & 0x0F);
  return (n ^ 8) - 8;
}

// Elements (d, d+1) of cache row `kp` of one (slot, head) as fp32.  `base`
// points at the slot's row 0 for this head; `pitch` is the element (bf16)
// or byte (int8/int4) distance between consecutive cache rows; `sc` is the
// row's scale (ignored for raw).
template <int FORM>
__device__ __forceinline__ float2 load_pair(const void* base, int kp,
                                            size_t pitch, int d, float sc) {
  if constexpr (FORM == RAW) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base);
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + size_t(kp) * pitch + d));
  } else {
    const int8_t* p = static_cast<const int8_t*>(base);
    const size_t row = FORM == INT4 ? size_t(kp >> 1) : size_t(kp);
    const char2 c = *reinterpret_cast<const char2*>(p + row * pitch + d);
    int x = c.x, y = c.y;
    if constexpr (FORM == INT4) {
      x = nibble(c.x, kp & 1);
      y = nibble(c.y, kp & 1);
    }
    return make_float2(__fmul_rn(float(x), sc), __fmul_rn(float(y), sc));
  }
}

}  // namespace kv_forms
