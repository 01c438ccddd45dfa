"""Rank-tier parallelism: rank meshes, tensor-parallel shardings, the
multi-process join and SPMD serving (port of p2p_llm_tunnel_tpu/parallel,
its serving core).

Where the reference annotates arrays with NamedShardings and lets GSPMD
insert the collectives, the port runs one process per rank and writes the
collectives into the model (``models/transformer``: an ``all_reduce``
after each row-parallel product, a vocab-parallel embedding lookup, the
vocab-sharded logits gathered before sampling; sequence parallelism's
ring shift, all-to-all and gathers in ``parallel/collectives``), over
``torch.distributed`` (NCCL between cards, gloo where ranks share one or
run on the CPU).

Axes convention (the reference's): ``dp`` data parallel, ``ep`` expert
parallel, ``tp`` tensor parallel (megatron column/row split of attention
and MLP), ``sp`` sequence parallel (prefill over sequence blocks: ring or
Ulysses attention).  Every axis is ported (the ep sum lives in
``models/moe``, the dp split of the engine's slots in
``parallel/data_parallel``).

Training, as the reference's: ``parallel/train`` (``make_optimizer``,
``make_train_step``: the dp x tp (x ep) AdamW step, gradients through
kernel 1 and through every collective of the forward) and
``parallel/pipeline`` (``make_pp_mesh``, ``shard_params_pp``,
``pipeline_prefill``, ``pipeline_loss_fn``: GPipe over a one-axis pp
mesh of its own).
"""

from p2p_llm_tunnel_tpu_torch.parallel.mesh import best_mesh, make_mesh
from p2p_llm_tunnel_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipeline_loss_fn,
    pipeline_prefill,
    shard_params_pp,
)
from p2p_llm_tunnel_tpu_torch.parallel.sharding import (
    kv_cache_pspecs,
    param_pspecs,
    shard_kv_cache,
    shard_params,
)
from p2p_llm_tunnel_tpu_torch.parallel.train import make_optimizer, make_train_step

__all__ = [
    "make_mesh",
    "best_mesh",
    "param_pspecs",
    "kv_cache_pspecs",
    "shard_params",
    "shard_kv_cache",
    "make_optimizer",
    "make_train_step",
    "make_pp_mesh",
    "shard_params_pp",
    "pipeline_prefill",
    "pipeline_loss_fn",
]
