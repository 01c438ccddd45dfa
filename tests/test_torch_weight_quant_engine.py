"""The port's engine with activation-quantized products against the JAX
engine, on the CPU: greedy streams byte-identical at ``--quant w8a8`` and
at ``--quant int8 --prefill-act-quant`` (prefill W8A8, decode weight-only),
on the plain loop and on the serve defaults with ragged prefill — so the
prefill config reaches the ragged dispatches too.

Both engines run the tiny model with bf16 activations (a quantized
embedding gathers into bf16, as in the reference) on the same JAX
``init_params`` weights, quantized by each engine.  Per-token int8
activations turn a one-ulp bf16 difference anywhere upstream into a whole
int8 level, so W8A8 logits meet at bf16 near-ties more often than the
weight-only forms', and the JAX engine's jitted program itself differs
from the JAX functions run eagerly there (XLA computes ``amax / 127`` as
``amax * (1 / 127)``; tests/test_torch_kv_quant.py): at weight seed 4
the jitted program picks token 130 first on prompt 4 where its eager
functions and the port pick 62 (bf16 logits 1.9375 and 1.9609 / 1.9219),
and at seed 3 one of these streams parts at its ninth token.  The W8A8
stream uses weight seed 5, where no stream meets such a tie; the int8 +
prefill-act-quant stream keeps seed 3.
"""

import pytest

from test_torch_weight_quant import MUX_RAGGED, jax_streams, port_streams

CASES = {"w8a8": (dict(quant="w8a8"), 5),
         "int8-prefill-act-quant": (dict(quant="int8", prefill_act_quant=True), 3)}
_JAX = {}


@pytest.mark.parametrize("path", ["plain", "mux-ragged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_act_quant_streams_byte_identical_to_jax(case, path):
    kw, seed = CASES[case]
    if case not in _JAX:
        _JAX[case] = jax_streams(kw, seed)
    want, params = _JAX[case]
    got, engine = port_streams(params, **kw, **(MUX_RAGGED if path != "plain" else {}))
    assert got == want
    assert engine._prefill_mcfg.act_quant
    assert engine.mcfg.act_quant == (case == "w8a8")
