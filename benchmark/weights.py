"""The fingerprint of a weight tree.

The tree itself is drawn by the configuration's architecture
(``benchmark/arch/<name>.py`` ``draw``) on the device from ``--seed``.
"""

from __future__ import annotations

import torch


def digest(tree) -> torch.Tensor:
    """One float64 sum per leaf, on the device: a fingerprint that shows
    whether anyone wrote into the weights between two reads."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            leaves.append(torch.stack([c.double().sum() for c in
                                       t.reshape(-1).split(2**26)]).sum())

    walk(tree)
    return torch.stack(leaves)
