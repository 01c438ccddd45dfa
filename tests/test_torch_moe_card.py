"""The MoE block at mixtral-8x7b's widths on the card (``cuda`` marker;
skips without a card): Dm 4096, F 14336, 8 experts, top 2, bf16, one
layer.  The expert products read the stored ``[E, Dm, F]`` weights in
place: no copy in the block moves 1 GB, where the einsum formulation
(``einsum_moe``, the control) copies each 0.94 GB gate and up weight.
No JAX here: the einsum formulation is the reference, and
tests/test_torch_moe.py holds ``moe_mlp`` against JAX on the CPU.

Run on the card with ``python -m pytest --noconftest -m cuda -s
tests/test_torch_moe_card.py``: each case prints one JSON line with the
device ms of both forms (median of CUDA-event timings), the card's name
and its power limit.
"""

import json
import statistics
import subprocess

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from p2p_llm_tunnel_tpu_torch.models import moe as tmoe
from p2p_llm_tunnel_tpu_torch.models.config import get_config

COPY_FUNCS = (torch.ops.aten.copy_.default, torch.ops.aten.clone.default,
              torch.ops.aten._to_copy.default)
BF16_REL = 0.025  # tests/test_torch_moe.py's bf16 bound
TIMED = 5


def einsum_moe(cfg, blk, h, act_fn):
    """The token-major formulation: each product contracts the middle axis
    of the ``[E, Dm, F]`` weight in one einsum, which re-lays the whole
    weight out before its matrix product."""
    weights = tmoe.route(cfg, blk["router"], h)
    gate = torch.einsum("btd,edf->btef", h, blk["moe_gate"])
    up = torch.einsum("btd,edf->btef", h, blk["moe_up"])
    down = torch.einsum("btef,efd->bted", act_fn(gate) * up, blk["moe_down"])
    return torch.einsum("bted,bte->btd", down.float(), weights).to(h.dtype)


class LargestCopy(TorchDispatchMode):
    """The bytes the largest copying op reads and writes, from its real
    tensors (each such op is one device copy kernel): ``copy_`` reads its
    source and writes its destination, ``clone`` and ``_to_copy`` read
    their input and write their output."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in COPY_FUNCS:
            moved = args[1] if func is torch.ops.aten.copy_.default else out
            self.bytes = max(self.bytes, sum(t.numel() * t.element_size()
                                             for t in (args[0], moved)))
        return out


def _device_ms(fn):
    """Median device ms of ``TIMED`` calls, each between two CUDA events."""
    times = []
    for _ in range(TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _card():
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False)
    return query.stdout.strip() or torch.cuda.get_device_name(0)


@pytest.fixture(scope="module")
def mixtral_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the layer is sized for the card's "
                    "memory and the test reads device copy kernels")
    cfg = get_config("mixtral-8x7b")
    g = torch.Generator(device="cuda").manual_seed(0)
    dm, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=g, device="cuda") * fan_in ** -0.5
        return w.to(torch.bfloat16)

    blk = {"router": dense((dm, e), dm), "moe_gate": dense((e, dm, f), dm),
           "moe_up": dense((e, dm, f), dm), "moe_down": dense((e, f, dm), f)}
    return cfg, blk, g


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(64, 1), (8, 512)], ids=["decode-64", "prefill-8x512"])
def test_mixtral_moe_copies_no_weight_on_the_card(mixtral_layer, rows):
    """64 decode rows, then a prefill of 8 x 512: no copy moves 1 GB in
    ``moe_mlp`` (the einsum formulation's does, on the same profile), and
    the output lies within the bf16 bound of the einsum formulation's."""
    cfg, blk, g = mixtral_layer
    h = torch.randn(rows + (cfg.dim,), generator=g, device="cuda").to(torch.bfloat16)
    act = torch.nn.functional.silu
    forms = {"expert_major": lambda: tmoe.moe_mlp(cfg, blk, h, act),
             "einsum": lambda: einsum_moe(cfg, blk, h, act)}
    copies, copy_ms, outs = {}, {}, {}
    with torch.no_grad():
        for name, fn in forms.items():
            outs[name] = fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]) as prof, \
                    LargestCopy() as largest:
                fn()
                torch.cuda.synchronize()
            copies[name] = largest.bytes
            copy_ms[name] = sum(ev.device_time_total for ev in prof.key_averages()
                                if "copy" in ev.key and ev.device_time_total > 0
                                and not ev.key.startswith("aten::")) / 1e3
        device_ms = {name: _device_ms(fn) for name, fn in forms.items()}
    print(json.dumps({"rows": list(rows), "device_ms": device_ms,
                      "copy_kernel_ms": copy_ms, "largest_copy_bytes": copies,
                      "card": _card()}))
    assert copies["expert_major"] < 1e9
    assert copies["einsum"] >= 1e9
    got, want = outs["expert_major"].float(), outs["einsum"].float()
    assert got.shape == h.shape and outs["expert_major"].dtype == h.dtype
    diff, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert diff < BF16_REL * scale, (diff, scale)
