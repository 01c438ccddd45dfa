"""Launch counts of eager PyTorch calls: the port's form of the
reference's launch proxies (``p2p_llm_tunnel_tpu/utils/hlo.py``).

The reference counts the ops of the lowered TPU program, where a decode
burst is one module and the layer scan appears once.  Eager PyTorch has
no program to lower: what a call dispatches is what it launches.
:class:`LaunchCount` is a ``TorchDispatchMode`` that tallies, over the
calls made while it is active on this thread,

- ``ops``: ATen ops that do device work — views, allocations, metadata
  reads and copies between devices (host transfers, not kernels) are
  left out;
- ``major``: the subset that roots a kernel of its own (``MAJOR_OPS``:
  products, scatters and gathers, sorts), as ``hlo.MAJOR_OPS`` there;
- ``kernels``: calls of the port's hand-written kernels.

A wrapper marked with :func:`kernel_entry` counts as ONE op, one major
op and one kernel, whatever its device, and nothing it runs inside is
counted: neither its plain version on the CPU nor its workspace setup on
the card.  So the same call counts the same on the CPU and on the card,
as the reference's counts of the TPU lowering come out the same on any
host.  Nothing here profiles the device: the counts read what was
dispatched, and need no profiler window.
"""

from __future__ import annotations

import functools
import threading

from torch.utils._python_dispatch import TorchDispatchMode

#: Ops that root a kernel of their own (by ATen op name): products,
#: scatters/gathers (``index`` is advanced indexing, a gather) and sorts.
MAJOR_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "convolution",
    "index_put_", "index_put", "_index_put_impl_",
    "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_",
    "gather", "index_select", "index", "embedding",
    "sort",
})

#: Ops that launch no device work: allocations and metadata.
_NO_WORK = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "lift_fresh_copy", "alias", "_unsafe_view",
    "_reshape_alias", "set_", "resize_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "record_stream",
})

_COPIES = frozenset({"_to_copy", "copy_"})

_ACTIVE = threading.local()


def _devices(x, out: set) -> None:
    if hasattr(x, "device") and hasattr(x, "dtype"):
        out.add(x.device.type)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _devices(y, out)


def launches_work(func, args, out) -> bool:
    """Whether one dispatched op does device work (module docstring)."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _NO_WORK:
        return False
    if name in _COPIES:
        seen: set = set()
        _devices(args, seen)
        _devices(out, seen)
        return len(seen) == 1
    return True


class LaunchCount(TorchDispatchMode):
    """Counts (module docstring) of what runs on this thread inside
    ``with LaunchCount() as c:``; one may be active per thread."""

    def __init__(self):
        super().__init__()
        self.ops = self.major = self.kernels = 0
        self._inside = False

    def __enter__(self):
        if getattr(_ACTIVE, "counter", None) is not None:
            raise RuntimeError("a LaunchCount is already active on this thread")
        _ACTIVE.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.counter = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._inside and launches_work(func, args, out):
            self.ops += 1
            if func.overloadpacket.__name__ in MAJOR_OPS:
                self.major += 1
        return out

    def counts(self) -> dict:
        return {"ops": self.ops, "major": self.major, "kernels": self.kernels}


def kernel_entry(fn):
    """Mark ``fn`` as a hand-written kernel's wrapper: under a
    :class:`LaunchCount` one call is one launch (module docstring)."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        counter = getattr(_ACTIVE, "counter", None)
        if counter is None or counter._inside:
            return fn(*args, **kwargs)
        counter.ops += 1
        counter.major += 1
        counter.kernels += 1
        counter._inside = True
        try:
            return fn(*args, **kwargs)
        finally:
            counter._inside = False

    return entry
