"""Pipeline parallelism: GPipe microbatching over a one-axis ``pp`` mesh
(port of p2p_llm_tunnel_tpu/parallel/pipeline.py).

Layout, as the reference's: the stacked ``[L, ...]`` block leaves shard
their LAYER axis over ``pp`` — stage s holds layers ``[s*L/S, (s+1)*L/S)``
and no other — while embed, final_norm and lm_head are replicated.  Each
rank is one stage; activations pass stage to stage with the one-hop
``ring_shift`` (the reference's ``ppermute``) of ``parallel/collectives``,
microbatches filling the pipeline in ``n_micro + S - 1`` ticks.

Every rank builds the same autograd graph and runs the same collectives
in the same order, forward and backward: which stage takes the embedded
microbatch and which stage's outputs count are chosen by ``torch.where``
on tensors, never by Python branches on the stage, so a stage whose value
is unused still carries a zero cotangent through its exchange.  The
backward is the mirrored pipeline (the ring shift's backward is the
reverse shift).

Replicated leaves and their gradients: only stage 0's lookup reaches the
loss, so the embedded activations pass through ``copy_to_group`` (every
stage's embedding receives stage 0's lookup gradient); the final norm and
the head run on every stage on the same broadcast activations, so each
stage's gradient of them is already the whole one and is not summed.
Every stage's gradient of a replicated leaf equals the unsharded one, and
the replicas stay equal under a replicated optimizer.

Forward semantics are pinned to the plain ``prefill`` by
tests/test_torch_pipeline.py, gradients to the unsharded ``loss_fn``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from p2p_llm_tunnel_tpu_torch.models.config import ModelConfig
from p2p_llm_tunnel_tpu_torch.models.transformer import (
    Params,
    apply_blocks,
    embed_tokens,
    final_logits,
    masked_mean,
    nll_sum,
)
from p2p_llm_tunnel_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_group,
    ring_shift,
)


@dataclass(frozen=True)
class PipelineMesh:
    """A one-axis ``pp`` mesh: its size, this rank's stage and the process
    group of the stages (None at pp 1, or on a mesh built only to slice a
    stage's weights).  Separate from the four-axis serving mesh, as the
    reference's ``make_pp_mesh`` is."""

    pp: int = 1
    rank: int = 0
    group: Any = field(default=None, compare=False)


def make_pp_mesh(pp: int, rank=None) -> PipelineMesh:
    """One-axis pipeline mesh over the first ``pp`` ranks of the joined
    ``torch.distributed`` world (every rank of the world calls it: the
    group's creation is collective; a rank beyond the first ``pp`` raises
    after it).  An explicit ``rank`` builds the value without a world
    (slicing a stage's weights)."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if rank is not None:
        if not 0 <= rank < pp:
            raise ValueError(f"rank {rank} is outside a pp={pp} mesh")
        return PipelineMesh(pp=pp, rank=rank)
    import torch.distributed as dist

    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if world < pp:
        raise ValueError(f"pp={pp} needs {pp} ranks, have {world} (join them "
                         "first: parallel.distributed.init_distributed)")
    me = dist.get_rank() if joined else 0
    group = None
    if pp > 1:
        group = dist.group.WORLD if pp == world else dist.new_group(list(range(pp)))
    if me >= pp:
        raise ValueError(f"rank {me} is outside the pp={pp} mesh of ranks "
                         f"0..{pp - 1}")
    return PipelineMesh(pp=pp, rank=me, group=group)


def shard_params_pp(params: Params, mesh: PipelineMesh) -> Params:
    """This stage's tree, as the reference's ``pp_param_shardings`` lays it
    out: its ``L/pp`` layers of every block leaf (fresh tensors: the whole
    tree can be dropped) and the replicated leaves as they are."""
    layers = params["blocks"]["attn_norm"].shape[0]
    if layers % mesh.pp:
        raise ValueError(f"{layers} layers not divisible by pp={mesh.pp}")
    per = layers // mesh.pp
    lo = mesh.rank * per
    return dict(params, blocks={k: v[lo:lo + per].clone()
                                for k, v in params["blocks"].items()})


def pipeline_prefill(
    cfg: ModelConfig,
    params: Params,  # this stage's tree (shard_params_pp)
    tokens: torch.Tensor,  # [B, T]
    valid: torch.Tensor,  # [B, T] bool
    mesh: PipelineMesh,
    n_micro: int,
) -> torch.Tensor:
    """Full-prompt forward with the layers pipelined over ``mesh``'s stages.

    Returns logits ``[B, T, V]`` (fp32, the same on every stage).  ``B %
    n_micro == 0`` and ``cfg.n_layers % pp == 0`` required.  Schedule, as
    the reference's: microbatch m enters stage 0 at tick m; stage s runs
    microbatch ``tick - s`` (clipped: ticks outside compute values never
    collected); the last stage emits microbatch m at tick ``m + S - 1``.
    Each stage runs ``apply_blocks`` on its layer chunk at its
    ``layer_offset`` (kernel 1 on the card), then ring-shifts its output
    to its successor.  The last stage's outputs reach every stage through
    one ``all_reduce_sum`` of the masked ``[B, T, Dm]`` activations, and
    each stage runs the replicated final norm and head."""
    pp = mesh.pp
    b, t = tokens.shape
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    if cfg.n_layers % pp != 0:
        raise ValueError(f"{cfg.n_layers} layers not divisible by pp={pp}")
    per_stage = cfg.n_layers // pp
    blocks = params["blocks"]
    if blocks["attn_norm"].shape[0] != per_stage:
        raise ValueError(f"params hold {blocks['attn_norm'].shape[0]} layers, not "
                         f"this stage's {per_stage}: pass shard_params_pp's tree")
    mb, stage = b // n_micro, mesh.rank
    x_all = embed_tokens(cfg, params, tokens)
    if pp > 1:
        x_all = copy_to_group(x_all, mesh.group)
    micro_x = x_all.reshape(n_micro, mb, t, -1)
    micro_valid = valid.reshape(n_micro, mb, t)
    first = torch.tensor(stage == 0, device=x_all.device)
    buf = torch.zeros_like(micro_x[0])
    outs = []
    ticks = n_micro + pp - 1
    for i in range(ticks):
        m = min(max(i - stage, 0), n_micro - 1)
        x_in = torch.where(first, micro_x[m], buf)
        y, _, _ = apply_blocks(cfg, blocks, x_in, micro_valid[m],
                               store_kv=lambda idx, k, v: None,
                               layer_offset=stage * per_stage)
        if i >= pp - 1:  # the last stage's microbatch i - (S - 1)
            outs.append(y)
        if pp > 1 and i < ticks - 1:
            buf = ring_shift(y, mesh.group)
    out = torch.stack(outs)
    if pp > 1:
        last = torch.tensor(stage == pp - 1, device=out.device)
        out = all_reduce_sum(torch.where(last, out, torch.zeros_like(out)),
                             mesh.group)
    return final_logits(cfg, params, out.reshape(b, t, -1))


def pipeline_loss_fn(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    valid: torch.Tensor,
    mesh: PipelineMesh,
    n_micro: int,
) -> torch.Tensor:
    """The training objective through the pipelined forward (mirrors
    ``transformer.loss_fn``); ``.backward()`` runs the mirrored pipeline,
    and each stage's gradients are those of its own layers and of the
    replicated leaves, each equal to the unsharded gradient."""
    logits = pipeline_prefill(cfg, params, tokens, valid, mesh, n_micro)
    return masked_mean(nll_sum(logits, targets, valid), valid)
