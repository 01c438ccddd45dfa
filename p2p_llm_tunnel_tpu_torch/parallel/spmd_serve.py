"""SPMD serving: rank 0 broadcasts each dispatch's host inputs, the other
ranks replay them (port of p2p_llm_tunnel_tpu/parallel/spmd_serve.py).

A tensor- or sequence-parallel forward pass is a sequence of collectives
that every rank must enter in the same order.  Serving breaks the symmetry: only
rank 0 owns the tunnel endpoint, the scheduler and the consumers of the
sampled tokens.  The reference's leader/follower split restores it:

- rank 0 runs the full engine loop; before every device dispatch it
  broadcasts ``(op, host_inputs)`` — a length header, then the pickled
  payload, as the reference's ``_bcast_bytes``;
- every other rank — tp and sp ranks alike — runs
  ``InferenceEngine.spmd_follower_loop()``: it receives each op and
  replays it into the same engine method on its own device state (its
  shard of the params, its kv heads of the cache and pool, its copy of the
  decode carry and the logit-bias plane); a prefill wave arrives whole and
  each sp rank computes its own sequence block of it.

Device state stays in lockstep because every dispatch is a deterministic
function of (carried state, broadcast host inputs): the tp all-reduces
and the sp gathers leave every rank with the same activations, the same
cache rows and the same full-width logits, and every rank seeds and
consumes its sampling generator the same way, so even unseeded draws
agree.

The broadcast runs on a group of its own on the ``gloo`` backend over the
host (a control plane of kilobytes per dispatch: token ids, positions,
sampling controls), so the data plane — the model's collectives — can be
NCCL.  Host inputs are numpy arrays and Python scalars; each rank turns
them into device tensors itself, as rank 0 does.  Every wait has a
timeout (the group's): a follower that hears nothing raises instead of
hanging, and an idle rank 0 sends a ``ping`` every ``HEARTBEAT_S``.
"""

from __future__ import annotations

import datetime
import pickle
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from p2p_llm_tunnel_tpu_torch.parallel.mesh import Mesh
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Seconds an idle rank 0 lets pass before it sends a heartbeat op (well
#: inside any collective timeout a run would be joined with).
HEARTBEAT_S = 15.0


def _to_host(x):
    """Tensor leaves -> numpy (picklable, process-local); numpy arrays,
    Python scalars and other values pass unchanged."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class SpmdCoordinator:
    """Host-input broadcast channel for one engine's dispatch stream.

    Every op rank 0 sends originates on the engine's single executor
    thread, so the stream has a total order; followers replay it in that
    order, which keeps every collective of the model matched across
    ranks."""

    def __init__(self, mesh: Mesh, timeout_s: Optional[float] = None):
        import torch.distributed as dist

        from p2p_llm_tunnel_tpu_torch.parallel.distributed import run_timeout_s

        self.mesh = mesh
        self.rank = dist.get_rank()
        self.timeout_s = run_timeout_s() if timeout_s is None else timeout_s
        # Every rank creates the group in the same order (the engine's
        # constructor), as new_group requires.
        self._group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=self.timeout_s))
        self.last_send = time.monotonic()
        self.ops_sent = 0

    @classmethod
    def maybe(cls, mesh: Optional[Mesh],
              timeout_s: Optional[float] = None) -> Optional["SpmdCoordinator"]:
        """A coordinator iff this is a real multi-process run with a mesh."""
        import torch.distributed as dist

        if mesh is None or not dist.is_initialized() or dist.get_world_size() == 1:
            return None
        return cls(mesh, timeout_s)

    # -- wire format ------------------------------------------------------

    def _bcast_bytes(self, data: Optional[bytes]) -> bytes:
        import torch.distributed as dist

        if self.rank == 0:
            if data is None:
                raise ValueError("rank 0 broadcasts a payload")
            n = torch.tensor([len(data)], dtype=torch.int64)
            dist.broadcast(n, 0, group=self._group)
            buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
            dist.broadcast(buf, 0, group=self._group)
            return data
        n = torch.zeros((1,), dtype=torch.int64)
        dist.broadcast(n, 0, group=self._group)
        buf = torch.empty((int(n[0]),), dtype=torch.uint8)
        dist.broadcast(buf, 0, group=self._group)
        return buf.numpy().tobytes()

    def send(self, op: str, host_args: Tuple[Any, ...]) -> None:
        """Rank 0: publish one dispatch's host inputs to every follower."""
        payload = tuple(_to_host(a) for a in host_args)
        self._bcast_bytes(pickle.dumps((op, payload)))
        self.last_send = time.monotonic()
        self.ops_sent += 1

    def recv(self) -> Tuple[str, Tuple[Any, ...]]:
        """Followers: block (up to the group's timeout) for the next op.
        The bytes come from rank 0 of this run over the control group."""
        op, payload = pickle.loads(self._bcast_bytes(None))
        return op, payload

    def send_stop(self) -> None:
        self.send("stop", ())

    def heartbeat_due(self) -> bool:
        return time.monotonic() - self.last_send >= HEARTBEAT_S

    # -- dispatch wrapping ------------------------------------------------

    def wrap(self, op: str, fn: Callable, n_carry: int) -> Callable:
        """Wrap a dispatch: ``args[:n_carry]`` are device-side carries (the
        cache, the pool — each rank passes its own, never broadcast); the
        rest are host inputs, broadcast by rank 0 before the call.  Every
        rank then calls ``fn`` with the same host inputs."""

        def wrapped(*args):
            carries, host = args[:n_carry], args[n_carry:]
            if self.rank == 0:
                self.send(op, host)
            return fn(*carries, *host)

        wrapped.op_name = op
        wrapped.inner = fn
        return wrapped
