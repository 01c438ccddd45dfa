"""The exchanges sequence parallelism runs over a mesh's sp group: the
one-hop ring shift (the reference's ``jax.lax.ppermute``), the tiled
sequence <-> head swap (``jax.lax.all_to_all(..., tiled=True)``) and the
sequence gather (the all-gather GSPMD inserts where a sequence-sharded
array meets a replicated one); tp's logits gather is the sequence gather
over the tp group.

Each exchange is one ``all_reduce`` of a zeroed buffer with a slot per
rank, each rank writing only its own slots.  That is the one collective
every backend takes on every device: gloo has no send/recv, all_to_all or
all_gather on CUDA tensors (ranks that share a card, where NCCL refuses
two ranks on one GPU).  ``chip_smoke.py --sp-nccl`` times each exchange
against NCCL's own collective for it (PERF.md).  The buffer is summed as
bytes (``uint8``), so every slot arrives bit for bit: one rank adds its
bytes to zeros (a float sum would turn ``-0.0`` into ``0.0``).
A failed collective raises.  ``exchanges`` counts the calls by exchange.

Training differentiates through them (``parallel/train``,
``parallel/pipeline``), so each exchange a gradient crosses has a
backward, and the psum of a row-parallel product and its mirror are here
too.  The loss downstream is computed identically on every rank of the
group, so each rank's cotangent of a replicated value is already the
whole one:

- ``all_reduce_sum`` (the psum): forward the sum, backward the identity
  (every rank's partial fed the same sum);
- ``copy_to_group`` (Megatron's "f", before a column-parallel or
  expert-parallel product of a replicated input): forward the identity,
  backward the sum over the group (each rank's cotangent is the share of
  its own columns or experts);
- ``all_gather``: backward this rank's slice (nothing is summed);
- ``ring_shift``: backward the reverse shift, the transpose of
  ``ppermute``.

With grad disabled, or on inputs that need none, each runs exactly the
forward serving ran before (``all_reduce_sum`` in place, as the psum
always has); ``all_to_all`` has no backward (sp never trains: the
reference's ``loss_fn`` passes no mesh).  Every rank builds the same graph
and so runs the same backward collectives in the same order.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

#: Calls since the last ``clear()``, by exchange.
exchanges: Counter = Counter()


def _setup(name: str, group):
    """(group size, this rank's place in the group); counts the call."""
    exchanges[name] += 1
    return dist.get_world_size(group), dist.get_rank(group)


def _slot_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """All-reduce ``buf`` (contiguous; each slot written by one rank, zeros
    elsewhere) as bytes, IN PLACE: every slot arrives exactly."""
    dist.all_reduce(buf.view(torch.uint8), group=group)
    return buf


def _grad_mode(*xs) -> bool:
    """True where autograd must see the exchange."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n, r = _setup("ring_shift", group)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[(r + step) % n] = x
    return _slot_sum(buf, group)[r]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x.detach(), group, step)

    @staticmethod
    def backward(ctx, dy):
        return _shift(dy.contiguous(), ctx.group, -ctx.step), None, None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` one hop around the ring (group rank i to i + 1 mod n) and
    return the block rank i - 1 sent.  Its backward is the shift the other
    way."""
    if _grad_mode(x):
        return _RingShift.apply(x, group, 1)
    return _shift(x, group, 1)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The float sum over ``group``, in place (the psum serving runs)."""
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _reduce(dy.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``x`` summed (float addition), on every rank.
    Without grad it sums ``x`` IN PLACE and returns it; under autograd it
    sums a copy, and its backward is the identity."""
    if _grad_mode(x):
        return _AllReduceSum.apply(x, group)
    return _reduce(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself (replicated on the group); under autograd its backward
    sums the cotangent over the group."""
    if _grad_mode(x):
        return _CopyToGroup.apply(x, group)
    return x


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into n equal pieces along ``split_axis``,
    piece j to group rank j; the pieces received, in rank order,
    concatenated along ``concat_axis``."""
    n, r = _setup("all_to_all", group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.tensor_split(n, dim=split_axis))  # [n, ...] piece per peer
    buf = send.new_zeros((n,) + tuple(send.shape))  # [from, to, ...]
    buf[r] = send
    recv = _slot_sum(buf, group)[:, r]
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    n, r = _setup("all_gather", group)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[r] = x
    _slot_sum(out, group)
    return torch.cat(out.unbind(0), dim=axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.width = axis, x.shape[axis]
        ctx.r = dist.get_rank(group)
        return _gather(x.detach(), axis, group)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.axis, ctx.r * ctx.width, ctx.width), None, None


def all_gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every group rank's ``x``, concatenated in rank order along ``axis``.
    Its backward takes this rank's slice of the cotangent."""
    if _grad_mode(x):
        return _AllGather.apply(x, axis, group)
    return _gather(x, axis, group)
