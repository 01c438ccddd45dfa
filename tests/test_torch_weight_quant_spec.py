"""Int4 weights composed with the port's other decode features, against
the JAX engine on the CPU: packed int4 weights (group 32) with the packed
int4 KV cache, the fused decode layer and prompt-lookup speculation on
(kernels 4, 5 and 7's plain versions) give greedy streams byte-identical
to the JAX engine's plain loop at the same weight and KV forms (weight
seed 3).  The JAX package pins fused ≡ unfused and speculation on ≡ off
for greedy streams (tests/test_fused_decode_layer.py,
tests/test_spec_decode.py), so its plain loop is the reference."""

from test_torch_weight_quant import jax_streams, port_streams

QUANT = dict(quant="int4", quant_group_size=32, kv_quant="int4")


def test_int4_weights_int4_kv_fused_spec_streams_byte_identical_to_jax():
    want, params = jax_streams(QUANT)
    got, engine = port_streams(params, **QUANT, fused_decode_layer=True,
                               spec_ngram=2, spec_k=3)
    assert got == want
    assert engine.mcfg.fused_decode_layer and engine.ecfg.spec_ngram == 2
    assert engine.params["blocks"]["wq"].group_size == 32
