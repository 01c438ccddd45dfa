"""Joining a multi-process run and launching the local follower ranks
(port of p2p_llm_tunnel_tpu/parallel/distributed.py).

A JAX multi-host run is N identical processes that each call
``jax.distributed.initialize`` and then see the global device set.  The
port runs one process per rank for EVERY tensor-, sequence-, expert- or
data-parallel run — ``serve --tp N --sp M --ep E`` on one host as much as
``--coordinator`` across hosts — joined by ``torch.distributed``: rank 0
owns the tunnel and the scheduler, every other rank replays rank 0's
dispatches (``parallel/spmd_serve``), the tp collectives, the sp exchanges
(``parallel/collectives``) and the ep sum run in the model, and the dp
ranks each serve their own slots (``parallel/data_parallel``).

The backend rule, printed at every join: ``nccl`` when every rank of this
host has a card of its own (``cuda:(local_rank % device_count)``),
``gloo`` when ranks share a card (NCCL refuses two ranks on one GPU) and
``gloo`` on the CPU.  A failed NCCL init raises; nothing retries on gloo.
A rank whose device is the card and that cannot reach one raises — no
rank moves to the CPU unless the caller asked for it.

Usage (same command on every host; rank 0 serves the tunnel):

    tunnel-gpu serve --backend gpu --model llama3-8b --tp 2 \\
        --coordinator host0:8476 --num-processes 2 --process-id $RANK

On one host, ``tunnel-gpu serve --backend gpu --tp 2 --sp 2 --ep 2`` needs
no more flags: ``launch_local_followers`` starts ranks 1..tp*sp*ep-1 as
processes of this host before rank 0 joins.  ``--dp-dcn D`` takes
``--coordinator`` with ``--num-processes D*ep*tp*sp``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch

from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh, make_mesh
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Default seconds a collective (and a follower's wait for rank 0's next
#: dispatch) may block before it raises; an idle rank 0 sends a heartbeat
#: well inside it (``spmd_serve.HEARTBEAT_S``).
DEFAULT_TIMEOUT_S = 600.0

#: The joined run's collective timeout (``init_distributed``): the process
#: group is process-wide state in torch.distributed, and so is this.
_RUN = {"timeout_s": DEFAULT_TIMEOUT_S}


def run_timeout_s() -> float:
    """The collective timeout the run was joined with."""
    return _RUN["timeout_s"]


def init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a ``tcp://`` or ``file://``
    URL is taken as it is (tests rendezvous through a file)."""
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: the CPU only when the caller asked for it,
    else the card ``cuda:(local_rank % device_count)``; raises when there
    is no card."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a rank runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {local_rank} has no CUDA device: the PyTorch engine runs "
            "on the card; pass device='cpu' (CLI: --device cpu) to run every "
            "rank on the CPU"
        )
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """``nccl`` when each of this host's ``local_world_size`` ranks has a
    card of its own, else ``gloo`` (ranks sharing a card, or the CPU)."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device=None, local_world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the multi-process run; returns the backend.  Idempotent per
    process, as the reference's: a second call with the same world is a
    no-op (a router building several engines may call it freely), another
    world raises; a real join failure raises.

    ``device`` is this rank's device (default: ``rank_device`` of the
    card, which raises where there is none); ``local_world_size`` the
    ranks on this host (default: all of them)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_world_size() != num_processes
                or dist.get_rank() != process_id):
            raise RuntimeError(
                f"torch.distributed already joined as rank "
                f"{dist.get_rank()}/{dist.get_world_size()}, not "
                f"{process_id}/{num_processes}"
            )
        log.debug("torch.distributed already initialized")
        return dist.get_backend()
    dev = (torch.device(device) if device is not None
           else rank_device(None, process_id))
    local = num_processes if local_world_size is None else local_world_size
    backend = choose_backend(dev, local)
    why = ("every rank has a card of its own" if backend == "nccl" else
           "ranks share a card" if dev.type == "cuda" else "ranks on the CPU")
    log.info("joining torch.distributed: coordinator=%s rank=%d/%d "
             "device=%s backend=%s (%s)", coordinator, process_id,
             num_processes, dev, backend, why)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method(coordinator),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    _RUN["timeout_s"] = timeout_s
    return backend


def shutdown_distributed() -> None:
    """Leave the run (idempotent); a process that joins again afterwards
    starts a new world.  Unreachable engines (and the process groups they
    hold) are collected first, so no group is left to be destroyed during
    the interpreter's exit."""
    import gc

    import torch.distributed as dist

    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


def make_hybrid_mesh(tp: int = 1, dp_dcn: int = 1, sp: int = 1,
                     ep: int = 1) -> Mesh:
    """The reference's DCN-aware mesh of the joined world: ``dp_dcn`` across
    hosts, ``ep x sp x tp`` inside one.  Processes are dp-outermost, as
    ``create_hybrid_device_mesh`` lays hosts out, so the ranks of one
    ``ep x sp x tp`` block are consecutive — one host's processes when each
    host runs that many — and only the dp gather of sampled rows crosses
    hosts."""
    return make_mesh(tp=tp, dp=dp_dcn, sp=sp, ep=ep)


@dataclass
class FollowerSpec:
    """Everything a follower rank needs to build the engine rank 0 builds
    (weights from the seed or ``ckpt_path``, as rank 0's): the run's
    rendezvous, its rank, the requested device (the follower resolves its
    own card), the engine config and the tokenizer (an object, or an HF
    tokenizer's path)."""

    coordinator: str
    world: int
    rank: int
    device: Optional[str]
    engine_cfg: Any
    tokenizer: Any = None
    timeout_s: float = DEFAULT_TIMEOUT_S


def run_follower(spec: FollowerSpec) -> int:
    """A follower rank's process body: join, build the engine (sharded by
    the engine itself, as on rank 0), replay rank 0's dispatches until it
    stops, leave.  Returns the number of ops replayed."""
    from p2p_llm_tunnel_tpu_torch.engine.engine import InferenceEngine

    dev = rank_device(spec.device, spec.rank)
    init_distributed(spec.coordinator, spec.world, spec.rank, device=dev,
                     timeout_s=spec.timeout_s)
    try:
        tokenizer = spec.tokenizer
        if isinstance(tokenizer, str):  # an HF tokenizer's path
            from p2p_llm_tunnel_tpu_torch.engine.tokenizer import HFTokenizer

            tokenizer = HFTokenizer(tokenizer)
        engine = InferenceEngine(engine_cfg=spec.engine_cfg,
                                 tokenizer=tokenizer, device=dev)
        ops = engine.spmd_follower_loop()
        del engine
        return ops
    finally:
        shutdown_distributed()


class LocalFollowers:
    """Ranks 1..N-1 of a one-host run as processes of this host (``spawn``
    start method: a fresh interpreter each).  ``close`` joins them with a
    timeout and kills what is left, so no rank outlives its leader holding
    a port and a card."""

    def __init__(self, procs: List[multiprocessing.Process]):
        self.procs = procs

    def alive(self) -> bool:
        return any(p.is_alive() for p in self.procs)

    def failed(self) -> List[int]:
        """Exit codes of followers that ended with an error."""
        return [p.exitcode for p in self.procs
                if p.exitcode not in (None, 0)]

    def close(self, timeout_s: float = 30.0) -> None:
        for p in self.procs:
            p.join(timeout_s)
        for p in self.procs:
            if p.is_alive():
                log.warning("follower pid %d still alive after %.0f s: "
                            "killing it", p.pid, timeout_s)
                p.kill()
                p.join(10.0)


def launch_local_followers(n: int, make_spec: Callable[[int], FollowerSpec]
                           ) -> LocalFollowers:
    """Start ranks ``1..n-1`` of a one-host run: ``run_follower(make_spec(r))``
    in a spawned process each.  On the card, build every kernel first
    (``build_before_launch``), so no two ranks run ``nvcc`` into the build
    directory at once."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for r in range(1, n):
        p = ctx.Process(target=run_follower, args=(make_spec(r),),
                        name=f"mesh-rank-{r}", daemon=True)
        p.start()
        procs.append(p)
    return LocalFollowers(procs)


def build_before_launch(device) -> None:
    """Rank 0's kernel build before any follower exists (the card only)."""
    if torch.device(device if device is not None else "cuda").type == "cuda":
        from p2p_llm_tunnel_tpu_torch.ops import kernel_build

        kernel_build.build()


def local_rendezvous() -> str:
    """A fresh ``localhost:<port>`` coordinator for a one-host run (a port
    the OS found free)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"localhost:{s.getsockname()[1]}"


def env_local_world_size() -> Optional[int]:
    """``LOCAL_WORLD_SIZE`` (torchrun's name) when set: ranks per host of a
    ``--coordinator`` run, which picks the backend."""
    v = os.environ.get("LOCAL_WORLD_SIZE")
    return int(v) if v else None
