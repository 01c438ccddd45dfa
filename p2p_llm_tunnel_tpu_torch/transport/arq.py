"""ARQ / congestion-control core: the sender-side state machine of the
reliable-UDP transport, extracted behind a swappable interface.

Two implementations with IDENTICAL semantics:
- ``PyArq`` — the reference (this file), pure Python, always available;
- ``NativeArq`` — ctypes over the C++ core (native/tunnel_arq.cc), used
  automatically when built.  The reference's equivalent of this machinery
  is native too (SCTP inside the webrtc crate, Cargo.toml:14); this is the
  rebuild's native runtime for the WAN datapath's per-packet bookkeeping.

The state machine owns ONLY bookkeeping — sequence numbers, send times,
retry counts, RTT estimation (Jacobson/Karels with Karn's rule), AIMD
congestion window, retransmit scheduling with per-retry exponential
backoff, once-per-RTT multiplicative decrease, and cwnd-paced oldest-first
retransmit budgets.  Packet BYTES stay with the caller (UdpChannel keeps
seq -> sealed datagram); ``due()`` returns which seqs to resend.

Equivalence is pinned by tests/test_arq.py: randomized send/ack/time
schedules must produce identical decisions from both implementations.
"""

from __future__ import annotations

import ctypes
import os
from collections import deque
from typing import Deque, List, Optional

#: Shared constants (mirrored in native/tunnel_arq.cc; the oracle test
#: would catch drift).
RTO_MIN = 0.15
RTO_MAX = 2.0
CWND_INIT = 32
CWND_MIN = 4
MAX_BACKOFF_EXP = 4  # per-retry RTO backoff caps at 2^4


def _seq_lt(a: int, b: int) -> bool:
    """a < b in mod-2^32 sequence space."""
    return ((a - b) & 0xFFFFFFFF) > 0x7FFFFFFF


class PyArq:
    """Reference implementation.  All times are caller-supplied monotonic
    seconds — the core never reads a clock (determinism for the oracle)."""

    def __init__(self, cwnd_cap: float = 512.0):
        # in-flight, in send (== seq) order: [seq, sent_at, tries]
        self._inflight: Deque[list] = deque()  # tunnelcheck: disable=TC10  bounded by the congestion window: can_send() refuses past cwnd (<= cwnd_cap), so at most cwnd entries are ever in flight
        self._srtt: Optional[float] = None
        self._rttvar = 0.0
        self._rto = RTO_MAX / 2
        self._cwnd = float(CWND_INIT)
        self._ssthresh = float(cwnd_cap)
        self._cwnd_cap = float(cwnd_cap)
        self._last_backoff = 0.0
        self.retransmits = 0

    # -- caller interface --------------------------------------------------

    def set_cwnd_cap(self, cap: float) -> None:
        self._cwnd_cap = float(cap)
        self._ssthresh = min(self._ssthresh, self._cwnd_cap)

    def on_send(self, seq: int, now: float) -> None:
        """Register a FRESH packet (seqs must be registered in order)."""
        self._inflight.append([seq, now, 0])

    def on_ack(self, cum: int, now: float) -> List[int]:
        """Cumulative ACK: everything strictly below ``cum`` is delivered.
        Returns the newly-acked seqs (caller drops its packet bytes)."""
        acked: List[int] = []
        while self._inflight and _seq_lt(self._inflight[0][0], cum):
            seq, sent_at, tries = self._inflight.popleft()
            acked.append(seq)
            if tries == 0:
                # Karn's rule: only never-retransmitted packets give an
                # unambiguous RTT sample.
                self._rtt_sample(now - sent_at)
        if acked:
            # AIMD growth: slow start doubles per RTT (+1 per acked
            # packet), congestion avoidance adds ~1 packet per RTT.
            n = len(acked)
            if self._cwnd < self._ssthresh:
                self._cwnd = min(self._cwnd_cap, self._cwnd + n)
            else:
                self._cwnd = min(self._cwnd_cap, self._cwnd + n / self._cwnd)
        return acked

    def due(self, now: float) -> List[int]:
        """Seqs to retransmit this tick: expired (per-retry exponentially
        backed-off RTO), oldest-first, paced by a cwnd-sized budget.  Bumps
        tries/sent_at and applies the once-per-RTT multiplicative decrease
        internally."""
        budget = max(CWND_MIN, int(min(self._cwnd, self._cwnd_cap)))
        out: List[int] = []
        for ent in self._inflight:
            if len(out) >= budget:
                break
            seq, sent_at, tries = ent
            rto = min(RTO_MAX, self._rto * (2 ** min(tries, MAX_BACKOFF_EXP)))
            if now - sent_at >= rto:
                self._on_timeout_loss(now)
                ent[1] = now
                ent[2] = tries + 1
                self.retransmits += 1
                out.append(seq)
        return out

    def can_send(self) -> bool:
        return len(self._inflight) < int(min(self._cwnd_cap, self._cwnd))

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    @property
    def srtt(self) -> Optional[float]:
        return self._srtt

    @property
    def rttvar(self) -> float:
        return self._rttvar

    @property
    def rto(self) -> float:
        return self._rto

    @property
    def cwnd(self) -> float:
        return self._cwnd

    @property
    def ssthresh(self) -> float:
        return self._ssthresh

    # -- internals ---------------------------------------------------------

    def _rtt_sample(self, rtt: float) -> None:
        """Jacobson/Karels estimator: rto = srtt + 4*rttvar, clamped."""
        if self._srtt is None:
            self._srtt = rtt
            self._rttvar = rtt / 2
        else:
            self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - rtt)
            self._srtt = 0.875 * self._srtt + 0.125 * rtt
        self._rto = min(RTO_MAX, max(RTO_MIN, self._srtt + 4 * self._rttvar))

    def _on_timeout_loss(self, now: float) -> None:
        """Multiplicative decrease, at most once per RTT."""
        if now - self._last_backoff < (self._srtt or self._rto):
            return
        self._last_backoff = now
        self._ssthresh = max(float(CWND_MIN), self._cwnd / 2)
        self._cwnd = self._ssthresh


_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "build", "libtunnelarq.so",
)


def _load_lib():
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.arq_new.restype = ctypes.c_void_p
    lib.arq_new.argtypes = [ctypes.c_double]
    lib.arq_free.argtypes = [ctypes.c_void_p]
    lib.arq_set_cwnd_cap.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.arq_on_send.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_double
    ]
    lib.arq_on_ack.restype = ctypes.c_int32
    lib.arq_on_ack.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
    ]
    lib.arq_due.restype = ctypes.c_int32
    lib.arq_due.argtypes = [
        ctypes.c_void_p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
    ]
    lib.arq_can_send.restype = ctypes.c_int32
    lib.arq_can_send.argtypes = [ctypes.c_void_p]
    lib.arq_in_flight.restype = ctypes.c_int32
    lib.arq_in_flight.argtypes = [ctypes.c_void_p]
    for name in ("arq_srtt", "arq_rttvar", "arq_rto", "arq_cwnd",
                 "arq_ssthresh"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.c_void_p]
    lib.arq_retransmits.restype = ctypes.c_uint64
    lib.arq_retransmits.argtypes = [ctypes.c_void_p]
    return lib


_LIB = _load_lib()


def native_available() -> bool:
    return _LIB is not None


class NativeArq:
    """ctypes facade over the C++ core; same API as PyArq."""

    def __init__(self, cwnd_cap: float = 512.0):
        if _LIB is None:
            raise RuntimeError("native ARQ library not built")
        self._lib = _LIB
        self._h = ctypes.c_void_p(self._lib.arq_new(float(cwnd_cap)))
        # Result buffer must hold a whole window acked/expired at once —
        # sized from the cap so PyArq equivalence can't silently truncate
        # for callers raising WINDOW above the default.
        self._buf_cap = max(1024, 2 * int(cwnd_cap))
        self._buf = (ctypes.c_uint32 * self._buf_cap)()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.arq_free(h)
            self._h = None

    def set_cwnd_cap(self, cap: float) -> None:
        self._lib.arq_set_cwnd_cap(self._h, float(cap))

    def on_send(self, seq: int, now: float) -> None:
        self._lib.arq_on_send(self._h, seq & 0xFFFFFFFF, now)

    def on_ack(self, cum: int, now: float) -> List[int]:
        n = self._lib.arq_on_ack(
            self._h, cum & 0xFFFFFFFF, now, self._buf, self._buf_cap
        )
        return list(self._buf[:n])

    def due(self, now: float) -> List[int]:
        n = self._lib.arq_due(self._h, now, self._buf, self._buf_cap)
        return list(self._buf[:n])

    def can_send(self) -> bool:
        return bool(self._lib.arq_can_send(self._h))

    @property
    def in_flight(self) -> int:
        return int(self._lib.arq_in_flight(self._h))

    @property
    def srtt(self) -> Optional[float]:
        v = self._lib.arq_srtt(self._h)
        return None if v < 0 else v

    @property
    def rttvar(self) -> float:
        return self._lib.arq_rttvar(self._h)

    @property
    def rto(self) -> float:
        return self._lib.arq_rto(self._h)

    @property
    def cwnd(self) -> float:
        return self._lib.arq_cwnd(self._h)

    @property
    def ssthresh(self) -> float:
        return self._lib.arq_ssthresh(self._h)

    @property
    def retransmits(self) -> int:
        return int(self._lib.arq_retransmits(self._h))


def make_arq(cwnd_cap: float = 512.0):
    """The transport's factory: native when built, Python otherwise."""
    if _LIB is not None:
        return NativeArq(cwnd_cap)
    return PyArq(cwnd_cap)
