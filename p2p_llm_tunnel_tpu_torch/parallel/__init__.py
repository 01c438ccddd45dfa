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
``parallel/data_parallel``); the pipeline
(``make_pp_mesh``, ``pipeline_prefill``, ``pipeline_loss_fn``,
``shard_params_pp``) comes with a later slice (ROADMAP.md item 18e).
"""

from p2p_llm_tunnel_tpu_torch.parallel.mesh import best_mesh, make_mesh
from p2p_llm_tunnel_tpu_torch.parallel.sharding import (
    kv_cache_pspecs,
    param_pspecs,
    shard_kv_cache,
    shard_params,
)

__all__ = [
    "make_mesh",
    "best_mesh",
    "param_pspecs",
    "kv_cache_pspecs",
    "shard_params",
    "shard_kv_cache",
]
