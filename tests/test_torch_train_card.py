"""Kernel 1 under autograd on the card (``cuda`` marker; skips without a
card): the ``torch.autograd.Function`` the wrapper enters where grad is
enabled.  No JAX here: on the card the reference is the plain version
(``ops/attention.causal_attention``); tests/test_torch_train.py holds the
Function against JAX on the CPU, and ``chip_smoke.py`` phase 14a at the
training path's shapes.
"""

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.ops import flash_attention as fa
from p2p_llm_tunnel_tpu_torch.ops.attention import causal_attention


@pytest.mark.cuda
def test_kernel1_function_on_the_card():
    """On the card (chip_smoke.py phase 14a holds every shape): the
    Function's forward is bitwise a direct launch, its gradients within
    1e-2 * max|g| of the plain version's on the same bf16 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 1 is CUDA C++ and has no "
                    "interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device="cuda").requires_grad_(True)
               for s in ((2, 128, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    valid = torch.arange(128, device="cuda")[None, :] < torch.tensor(
        [[128], [77]], device="cuda")
    out = fa.flash_causal_attention(q, k, v, valid)
    direct = fa.flash_causal_attention(*(x.detach().bfloat16() for x in (q, k, v)),
                                       valid)
    assert torch.equal(out, direct.float())
    out.sum().backward()
    leaves = [x.detach().bfloat16().float().requires_grad_(True) for x in (q, k, v)]
    causal_attention(*leaves, valid).sum().backward()
    for got, ref in zip((q.grad, k.grad, v.grad), leaves):
        assert (got - ref.grad).abs().max() <= 1e-2 * ref.grad.abs().max()
