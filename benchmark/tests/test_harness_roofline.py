"""The operation and byte counts against hand counts."""

import pytest

from benchmark.arch import mistral
from benchmark.arch.mistral import Shape

MISTRAL = Shape(32000, 4096, 14336, 32, 32, 8, 128, 1e4, 1e-5, 4096, 0, 0)
MIXTRAL16 = Shape(32000, 4096, 14336, 16, 32, 8, 128, 1e6, 1e-5, None, 8, 2)


def test_matmul_flops_dense():
    # q 4096x4096, k and v 4096x1024, o 4096x4096, MLP 3 x 4096x14336
    per_layer = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert mistral.matmul_flops_per_token(MISTRAL) == 2 * 32 * per_layer
    # ~7.0e9 parameters outside the embedding and head: 2 flops each
    assert 13.9e9 < mistral.matmul_flops_per_token(MISTRAL) < 14.0e9


def test_matmul_flops_routed_experts_only():
    attn = 4096 * 4096 * 2 + 2 * 4096 * 1024
    mlp = 2 * 3 * 4096 * 14336 + 4096 * 8  # two experts and the router
    assert mistral.matmul_flops_per_token(MIXTRAL16) == 2 * 16 * (attn + mlp)


def test_attention_flops_and_window():
    assert mistral.attention_flops(MISTRAL, 10) == 4 * 32 * 32 * 128 * 10
    assert mistral.attention_flops(MISTRAL, 5000) \
        == mistral.attention_flops(MISTRAL, 4096)
    assert mistral.attention_flops(MIXTRAL16, 5000) == 4 * 16 * 32 * 128 * 5000


@pytest.mark.parametrize("start,stop", [(0, 1), (0, 100), (37, 512), (4000, 4200), (5000, 5001)])
def test_prefill_flops_sums_every_position(start, stop):
    want = ((stop - start) * mistral.matmul_flops_per_token(MISTRAL)
            + mistral.head_flops(MISTRAL)
            + sum(mistral.attention_flops(MISTRAL, p + 1)
                  for p in range(start, stop)))
    assert mistral.prefill_flops(MISTRAL, start, stop) == pytest.approx(want, rel=1e-12)
    assert mistral.prefill_flops(MISTRAL, 5, 5) == 0.0


def test_decode_flops():
    assert mistral.decode_flops(MISTRAL, 99) == (
        mistral.matmul_flops_per_token(MISTRAL) + 2 * 4096 * 32000
        + 4 * 32 * 32 * 128 * 100)


def test_decode_attention_bytes_by_hand():
    kv_row = 8 * 128 * 2  # one position's k (or v) of one layer, bf16
    q_row = 32 * 128 * 2
    # position 0: no cache; q, k, v in, k and v out, attention out
    assert mistral.decode_attention_bytes(MISTRAL, 0) == 2 * q_row + 4 * kv_row
    assert mistral.decode_attention_bytes(MISTRAL, 1000) \
        == 2 * kv_row * 1000 + 2 * q_row + 4 * kv_row
    # the window caps what is read
    assert mistral.decode_attention_bytes(MISTRAL, 9000) \
        == mistral.decode_attention_bytes(MISTRAL, 4095)
    assert mistral.burst_bytes(MISTRAL, [(10, 2), (0, 1)]) == (
        mistral.decode_attention_bytes(MISTRAL, 10)
        + mistral.decode_attention_bytes(MISTRAL, 11)
        + mistral.decode_attention_bytes(MISTRAL, 0))
