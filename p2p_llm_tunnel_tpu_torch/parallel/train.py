"""Sharded training step (port of p2p_llm_tunnel_tpu/parallel/train.py):
forward (the prefill path), the masked mean cross-entropy, gradients and
an AdamW update, with the parameters and their moments sharded as the
serving mesh shards them (tp, ep) and the batch split over dp.

Where the reference's GSPMD inserts the collectives, the port's forward
carries them (``models/transformer``: the tp psums and their mirrors, the
vocab-parallel lookup and logits gather; ``models/moe``: the ep sum), all
differentiable (``parallel/collectives``), with kernel 1 under autograd
(``ops/flash_attention``).  The dp gradient all-reduce is written here.
The reference's train step runs no sequence parallelism (its ``loss_fn``
passes no mesh to ``prefill``); an sp mesh raises.

Usage, on every rank of a joined world (``parallel/distributed``):

    mesh = make_mesh(tp=2, dp=2)
    init_fn, step_fn = make_train_step(cfg, mesh, lr=1e-3)
    params, opt = init_fn(0)
    params, opt, loss = step_fn(params, opt, tokens, targets, valid)
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.models.transformer import (
    check_training_mesh,
    init_params,
    nll_sum,
    prefill,
    resolve_device,
)


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a params tree, depth first in the tree's order."""
    if isinstance(params, dict):
        return [leaf for v in params.values() for leaf in param_leaves(v)]
    return [params]


def make_optimizer(params, lr: float = 1e-3) -> torch.optim.AdamW:
    """AdamW over every leaf of ``params``, as the reference's
    ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)`` (eps 1e-8, no
    decay mask).  Optax's update ``p - lr * (m_hat / (sqrt(v_hat) + eps) +
    wd * p)`` is torch's decoupled form: ``p * (1 - lr * wd)``, then ``-
    lr * m_hat / (sqrt(v_hat) + eps)``, whose second term does not read
    ``p``.  The moments live beside their tensor (``opt.state[p]``), each
    at its shard's shape: the reference's path-keyed rule."""
    return torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=0.1)


def make_train_step(cfg: ModelConfig, mesh=None, lr: float = 1e-3,
                    device=None) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)``, the reference's pair.

    - ``init_fn(seed) -> (params, opt)``: fp32 parameters drawn as this
      rank's shard of the seed's tree (``init_params(..., mesh=mesh)``:
      no rank holds the whole model), and their optimizer.
    - ``step_fn(params, opt, tokens, targets, valid) -> (params, opt,
      loss)``: one optimization step on the whole batch ``[B, T]``; this
      rank computes rows ``[d*B/dp, (d+1)*B/dp)`` of dp coordinate ``d``.
      The loss is the whole batch's masked mean, ``sum(nll * valid) /
      max(sum(valid), 1)``: each dp rank divides its own rows' sum by the
      whole batch's count, and the gradients are SUMMED over dp (a mean
      of per-rank means differs wherever the ranks' counts do).  The
      returned loss (a detached 0-d tensor) is the same on every rank;
      the step's gradients stay in each leaf's ``.grad`` until the next.

    ``device``: the card unless the caller passes the CPU."""
    check_training_mesh(mesh)
    dev = resolve_device(device)
    dp = 1 if mesh is None else mesh.dp

    def init_fn(seed: int = 0):
        params = init_params(cfg, seed, torch.float32, dev, mesh=mesh)
        for leaf in param_leaves(params):
            leaf.requires_grad_(True)
        return params, make_optimizer(params, lr)

    def step_fn(params, opt, tokens, targets, valid):
        b = tokens.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} does not split over dp={dp}")
        tokens, targets, valid = (torch.as_tensor(x, device=dev)
                                  for x in (tokens, targets, valid))
        valid = valid.to(torch.bool)
        # Every rank holds the whole batch, so the whole count is local.
        count = valid.sum().clamp(min=1)
        lo = (0 if mesh is None else mesh.dp_rank) * (b // dp)
        rows = slice(lo, lo + b // dp)
        opt.zero_grad(set_to_none=True)
        logits = prefill(cfg, params, tokens[rows], valid[rows], mesh)[0]
        loss = nll_sum(logits, targets[rows], valid[rows]) / count
        loss.backward()
        loss = loss.detach()
        if dp > 1:
            import torch.distributed as dist

            for leaf in param_leaves(params):
                if leaf.grad is None:
                    leaf.grad = torch.zeros_like(leaf)
                dist.all_reduce(leaf.grad, group=mesh.dp_group)
            dist.all_reduce(loss, group=mesh.dp_group)
        opt.step()
        return params, opt, loss

    return init_fn, step_fn
