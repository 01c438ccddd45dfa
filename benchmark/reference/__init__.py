"""The benchmark's plain reference: a float32 PyTorch forward pass written
from the models' published descriptions, independent of the served
program (it imports nothing of it)."""

from benchmark.reference.model import Shape, logits_at

__all__ = ["Shape", "logits_at"]
