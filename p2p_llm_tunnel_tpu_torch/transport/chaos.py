"""Deterministic fault-injection wrapper over any :class:`Channel`.

The robustness counterpart of ``loopback_pair``: chaos composes over a real
transport and perturbs the *message* plane — drop, duplicate, reorder,
corrupt, stall, partition — from a seeded schedule, so every failure path the
endpoints claim to survive can be exercised reproducibly (tests/test_chaos.py)
and in live runs via the ``TUNNEL_CHAOS`` env spec.

Determinism contract: faults are a pure function of (seed, send sequence).
Two runs that send the same message sequence through the same spec draw the
same fault schedule — stall *durations* are wall-clock, but which messages
are dropped/duplicated/corrupted/held is identical.  The partition window is
counted in messages, not seconds, for the same reason.

Spec grammar (comma-separated ``key=value``):

    TUNNEL_CHAOS="seed=42,drop=0.05,dup=0.02,reorder=0.05,corrupt=0.01,
                  stall=0.1:0.5,partition=20:5"

- ``drop=P``        — silently discard a message with probability P
- ``dup=P``         — deliver a message twice with probability P
- ``reorder=P``     — hold a message and emit it after the next send
- ``corrupt=P``     — flip one byte of the payload with probability P
- ``stall=P:SECS``  — delay delivery SECS seconds with probability P
- ``partition=N:K`` — after N messages, drop the next K outright
- ``bw=BYTES``      — bandwidth cap: pace sends to BYTES per second (the
                      slow-reader/bandwidth-cap fault: a WAN
                      client draining at modem speed; exercises FLOW-credit
                      backpressure without losing a single frame)
- ``kill=N``        — peer death: after N messages, CLOSE the channel (both
                      directions, like a process kill — the fabric's per-peer
                      failover fault; deterministic in message count like
                      partition, so a seeded multi-peer run murders the
                      same peer at the same frame every time)
- ``seed=N``        — RNG seed for the schedule (default 0)

Faults apply on the SEND side only; ``recv``/lifecycle delegate to the
wrapped channel, so a ``ChaosChannel`` drops anywhere a ``Channel`` does.
"""

from __future__ import annotations

import asyncio
import os
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from p2p_llm_tunnel_tpu_torch.transport.base import Channel, ChannelClosed
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_VAR = "TUNNEL_CHAOS"


class ChaosSpecError(ValueError):
    """Malformed TUNNEL_CHAOS spec string."""


@dataclass(frozen=True)
class ChaosSpec:
    """One seeded fault schedule (see module docstring for the grammar)."""

    seed: int = 0
    drop: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    stall_p: float = 0.0
    stall_s: float = 0.0
    partition_after: int = 0  # messages before the partition opens (0 = off)
    partition_len: int = 0  # messages dropped while partitioned
    #: Bandwidth cap in bytes/second (0 = off).  Deterministic like
    #: partition — every send pays len(data)/bw of pacing delay, no RNG
    #: draw — so the schedule part of the determinism contract holds (the
    #: DELAY is wall-clock, like stall durations).
    bw_bytes_per_s: float = 0.0
    #: Kill the channel outright after this many messages (0 = off).  The
    #: send that would be message N closes the channel instead — the
    #: ChannelClosed every layer above must survive (failover).
    kill_after: int = 0

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        """Parse the ``TUNNEL_CHAOS`` grammar; raises ChaosSpecError."""
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep:
                raise ChaosSpecError(f"expected key=value, got {part!r}")
            try:
                if key == "seed":
                    kw["seed"] = int(val)
                elif key in ("drop", "dup", "reorder", "corrupt"):
                    kw[key] = float(val)
                elif key == "stall":
                    p, _, secs = val.partition(":")
                    kw["stall_p"] = float(p)
                    kw["stall_s"] = float(secs) if secs else 0.1
                elif key == "partition":
                    after, _, length = val.partition(":")
                    kw["partition_after"] = int(after)
                    kw["partition_len"] = int(length) if length else 1
                elif key == "bw":
                    kw["bw_bytes_per_s"] = float(val)
                    if kw["bw_bytes_per_s"] <= 0:
                        raise ChaosSpecError(
                            f"bw must be > 0 bytes/s, got {val!r}"
                        )
                elif key == "kill":
                    kw["kill_after"] = int(val)
                    if kw["kill_after"] <= 0:
                        raise ChaosSpecError(
                            f"kill must be > 0 messages, got {val!r}"
                        )
                else:
                    raise ChaosSpecError(f"unknown chaos key {key!r}")
            except (TypeError, ValueError) as e:
                if isinstance(e, ChaosSpecError):
                    raise
                raise ChaosSpecError(f"bad value for {key!r}: {val!r}") from e
        for name in ("drop", "dup", "reorder", "corrupt", "stall_p"):
            p = kw.get(name, 0.0)
            if not 0.0 <= p <= 1.0:
                raise ChaosSpecError(f"{name} probability {p} not in [0, 1]")
        return cls(**kw)


class ChaosChannel(Channel):
    """A Channel that injects ``spec``'s faults into everything it sends.

    Wraps (does not subclass) the inner transport: ``recv``, lifecycle
    events, and ``close`` delegate, so endpoints see the wrapped channel's
    connectivity unchanged.  ``faults`` records every injected fault as
    ``(send_index, kind)`` — the determinism oracle the tests compare
    across runs.
    """

    def __init__(self, inner: Channel, spec: ChaosSpec):
        super().__init__()
        self.inner = inner
        self.spec = spec
        # Mirror the inner channel's lifecycle events instead of keeping a
        # second, never-set pair: endpoints select on these.
        self.connected = inner.connected
        self.disconnected = inner.disconnected
        self._rng = random.Random(spec.seed)
        self._sent = 0
        self._held: Optional[bytes] = None  # reorder buffer (one message)
        #: Bandwidth-cap pacing horizon: the monotonic instant the link is
        #: next free.  Cumulative, so burst sends pay the full serialized
        #: transfer time rather than each waiting only its own share.
        self._bw_free_at = 0.0
        self.faults: List[Tuple[int, str]] = []

    # -- fault schedule ----------------------------------------------------

    def _partitioned(self, idx: int) -> bool:
        a, k = self.spec.partition_after, self.spec.partition_len
        return bool(a and k) and a <= idx < a + k

    async def send(self, data: bytes) -> None:
        idx = self._sent
        self._sent += 1
        spec = self.spec
        if spec.kill_after and idx >= spec.kill_after:
            # Peer death: the channel closes under the sender (both
            # directions — close() cascades to the inner transport, which
            # a loopback pair propagates to the peer).  Checked BEFORE the
            # RNG draws: no message after the kill exists to schedule.
            self.faults.append((idx, "kill"))
            self.close()
            raise ChannelClosed("chaos kill schedule fired")
        # One RNG draw per independent fault, ALWAYS consumed in the same
        # order regardless of which faults fire — the schedule for message
        # n never depends on what happened to messages < n.
        r_drop = self._rng.random()
        r_dup = self._rng.random()
        r_reorder = self._rng.random()
        r_corrupt = self._rng.random()
        r_stall = self._rng.random()
        corrupt_pos = self._rng.randrange(1 << 30)

        if self._partitioned(idx):
            self.faults.append((idx, "partition"))
            return
        if spec.drop and r_drop < spec.drop:
            self.faults.append((idx, "drop"))
            return
        if spec.corrupt and r_corrupt < spec.corrupt and data:
            buf = bytearray(data)
            buf[corrupt_pos % len(buf)] ^= 0xFF
            data = bytes(buf)
            self.faults.append((idx, "corrupt"))
        if spec.stall_p and r_stall < spec.stall_p:
            self.faults.append((idx, "stall"))
            await asyncio.sleep(spec.stall_s)
        if spec.bw_bytes_per_s > 0:
            # Slow-reader/bandwidth-cap fault: pace every
            # surviving message through a link that serializes at bw
            # bytes/s.  The fault RECORD is a pure function of the send
            # sequence (every paced message logs, whether or not it had to
            # wait this time) so the determinism oracle holds; the pacing
            # itself is wall-clock, like stall durations.
            self.faults.append((idx, "bw"))
            now = asyncio.get_running_loop().time()
            start = max(now, self._bw_free_at)
            self._bw_free_at = start + len(data) / spec.bw_bytes_per_s
            wait = self._bw_free_at - now
            if wait > 0:
                await asyncio.sleep(wait)
        if spec.reorder and r_reorder < spec.reorder and self._held is None:
            # Hold this message; it rides out behind the NEXT send.
            self.faults.append((idx, "reorder"))
            self._held = data
            return
        await self.inner.send(data)
        if spec.dup and r_dup < spec.dup:
            self.faults.append((idx, "dup"))
            await self.inner.send(data)
        if self._held is not None:
            held, self._held = self._held, None
            await self.inner.send(held)

    # -- delegation --------------------------------------------------------

    async def recv(self) -> bytes:
        return await self.inner.recv()

    def close(self) -> None:
        if self._held is not None:
            # A message held for reordering with no later send to ride
            # behind is lost at close — like a trailing packet on a dying
            # link.  Record it so the fault log tells the truth.
            self.faults.append((self._sent, "reorder-lost"))
            self._held = None
        self.inner.close()

    @property
    def is_closed(self) -> bool:
        return self.inner.is_closed


def maybe_chaos(channel: Channel, spec: Optional[str] = None) -> Channel:
    """Wrap ``channel`` when a chaos spec is configured; else pass through.

    ``spec`` defaults to the ``TUNNEL_CHAOS`` env var.  A malformed spec
    refuses loudly rather than silently serving without the faults the
    operator asked for.
    """
    raw = os.environ.get(ENV_VAR, "") if spec is None else spec
    if not raw.strip():
        return channel
    parsed = ChaosSpec.parse(raw)
    log.warning("chaos injection enabled: %s", parsed)
    return ChaosChannel(channel, parsed)


SPILL_ENV_VAR = "TUNNEL_SPILL_CHAOS"


class SpillChaos:
    """Seeded fault schedule for the KV spill tier's I/O path.

    The message-plane determinism contract, transplanted to tier I/O: one
    RNG draw per independent fault per I/O operation, ALWAYS consumed in
    the same order regardless of which faults fire, so two runs that issue
    the same page-out/page-in sequence under the same spec record the same
    schedule.  ``faults`` is the two-run oracle, ``(op_index, op, kind)``.

    Reuses the :class:`ChaosSpec` grammar with spill semantics —
    ``drop=P`` fails the I/O outright (a failed page-out drops the page, a
    failed page-in falls back to tail re-prefill), ``stall=P:SECS`` sleeps
    the EXECUTOR thread mid-copy (the event loop keeps serving — exactly
    the overlap the drain design claims), ``corrupt=P`` flips one payload
    byte so the page-in checksum must catch it.  Message-plane-only keys
    (dup/reorder/partition/bw/kill) are ignored here.
    """

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self._rng = random.Random(spec.seed)
        self._ops = 0
        self.faults: List[Tuple[int, str, str]] = []

    def draw(self, op: str) -> Tuple[Optional[str], float, int]:
        """Schedule one tier I/O op: returns (fault kind or None,
        stall seconds, corrupt byte position).  ``op`` labels the record
        ("pageout"/"pagein"); precedence fail > corrupt > stall mirrors
        the channel's drop > corrupt > stall."""
        idx = self._ops
        self._ops += 1
        spec = self.spec
        r_fail = self._rng.random()
        r_corrupt = self._rng.random()
        r_stall = self._rng.random()
        corrupt_pos = self._rng.randrange(1 << 30)
        if spec.drop and r_fail < spec.drop:
            self.faults.append((idx, op, "fail"))
            return "fail", 0.0, corrupt_pos
        if spec.corrupt and r_corrupt < spec.corrupt:
            self.faults.append((idx, op, "corrupt"))
            return "corrupt", 0.0, corrupt_pos
        if spec.stall_p and r_stall < spec.stall_p:
            self.faults.append((idx, op, "stall"))
            return "stall", spec.stall_s, corrupt_pos
        return None, 0.0, corrupt_pos


def maybe_spill_chaos(spec: Optional[str] = None) -> Optional[SpillChaos]:
    """A :class:`SpillChaos` when ``TUNNEL_SPILL_CHAOS`` (or ``spec``) is
    set; else None.  Malformed specs refuse loudly, like the message
    plane's."""
    raw = os.environ.get(SPILL_ENV_VAR, "") if spec is None else spec
    if not raw.strip():
        return None
    parsed = ChaosSpec.parse(raw)
    log.warning("spill-tier chaos injection enabled: %s", parsed)
    return SpillChaos(parsed)
