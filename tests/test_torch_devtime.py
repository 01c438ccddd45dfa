"""Device-timed units of the port's flight recorder
(``p2p_llm_tunnel_tpu_torch/utils/flight.py``, ``FlightRecorder.unit``).

On the CPU: with the span journal off no timing event is made and no
``dev_*`` / ``exec_cpu_ms`` field is written; on stub events the drain
sums by kind, chains gaps over top-level units only, carries units still
in flight to a later record in order, drops past its bound with a count,
and keeps two engines' units apart on their two threads; a tiny MoE engine on the serve defaults times every kind of unit,
and its units and gaps tile the span from the first start to the last
end.  On the card (``cuda`` marker, no JAX import: ``python -m pytest
--noconftest -m cuda tests/test_torch_devtime.py``): a known idle gap, a
back-to-back pair and the tiling, on CUDA events.
"""

import asyncio
import threading
import time

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.engine.engine import EngineConfig, InferenceEngine
from p2p_llm_tunnel_tpu_torch.utils.flight import (
    FlightRecorder,
    UnitQueue,
    global_flight,
)
from p2p_llm_tunnel_tpu_torch.utils.tracing import global_tracer

DEV_FIELDS = ("dev_decode_ms", "dev_prefill_ms", "dev_pool_ms", "dev_moe_ms",
              "dev_gap_ms", "exec_cpu_ms", "dev_units_dropped")
#: tiny-moe on the serve CLI's defaults + ragged prefill: decode bursts,
#: ragged segments, pool copy-ins and inserts, MoE blocks in each.
ENGINE = dict(model="tiny-moe", num_slots=4, max_seq=256, dtype="float32",
              decode_steps=4, mux=True, prefix_cache=True, conv_cache=True,
              prefill_chunk=32, ragged_prefill=True)
PROMPT = list(range(3, 83))  # 80 tokens: three segments, whole pool pages
EMPTY = {"dev_decode_ms": 0.0, "dev_prefill_ms": 0.0, "dev_pool_ms": 0.0,
         "dev_gap_ms": 0.0, "exec_cpu_ms": 0.0, "dev_units_dropped": 0}


class Clock(threading.local):
    """A settable clock in ms, one a thread, that stub events read."""

    now = 0.0


CLOCK = Clock()


class StubEvent:
    """A timing event on ``CLOCK`` (or the host's clock when ``host``):
    complete unless ``done`` is cleared."""

    host = False

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.done = True

    def record(self, stream=None):
        self.t = time.perf_counter() * 1e3 if self.host else CLOCK.now

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done, "elapsed_time of an incomplete event"
        return other.t - self.t


class HostEvent(StubEvent):
    host = True


def _cuda_stubs(monkeypatch, event):
    """Timing events of class ``event`` on a CPU build's 'cuda' queues."""
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)


def _refuse(*a, **kw):
    raise AssertionError("a timing event was made with timing off")


@pytest.fixture
def tracing():
    was = global_tracer.enabled
    global_tracer.configure(enabled=True)
    try:
        yield
    finally:
        global_tracer.configure(enabled=was)
        global_tracer.clear()


@pytest.fixture
def flight():
    global_flight.reset()
    yield global_flight
    global_flight.reset()


@pytest.fixture
def stub(monkeypatch):
    """A fresh recorder and a 'cuda' unit queue on stub events."""
    _cuda_stubs(monkeypatch, StubEvent)
    CLOCK.now = 0.0
    return FlightRecorder(capacity=16), UnitQueue("cuda")


def _unit(rec, q, kind, t0, t1, inner=None):
    """One unit from ``t0`` to ``t1`` ms on the stub clock into queue
    ``q`` (a nested kind takes none); ``inner`` runs inside it."""
    CLOCK.now = t0
    with rec.unit(kind, None if kind == "moe" else q) as u:
        if inner is not None:
            inner()
        CLOCK.now = t1
    return u


def _serve(engine, prompts, max_new=12):
    """Drive ``prompts`` in waves (each wave concurrently) through a CPU
    engine; returns every wave's token ids."""
    async def one(p):
        return [ev.token_id async for ev in
                engine.generate(p, max_new_tokens=max_new)]

    async def go():
        await engine.start()
        try:
            return [await asyncio.gather(*[one(p) for p in wave])
                    for wave in prompts]
        finally:
            await engine.stop()

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# the drain, on stub events
# ---------------------------------------------------------------------------


def test_drain_sums_by_kind_and_chains_top_level_gaps(tracing, stub):
    rec, q = stub

    def moe():
        _unit(rec, q, "moe", 1.0, 3.0)

    _unit(rec, q, "decode", 0.0, 4.0, inner=moe)
    _unit(rec, q, "prefill", 6.0, 7.0,
          inner=lambda: _unit(rec, q, "moe", 6.2, 6.7))
    _unit(rec, q, "pool", 7.5, 8.0)
    f = q.drain()
    assert f["dev_decode_ms"] == pytest.approx(4.0)
    assert f["dev_prefill_ms"] == pytest.approx(1.0)
    assert f["dev_pool_ms"] == pytest.approx(0.5)
    assert f["dev_moe_ms"] == pytest.approx(2.5)
    # decode end 4 -> prefill start 6, prefill end 7 -> pool start 7.5;
    # the nested MoE units bound no gap.
    assert f["dev_gap_ms"] == pytest.approx(2.5)
    assert f["exec_cpu_ms"] >= 0.0
    assert f["dev_units_dropped"] == 0
    assert q.drain() == EMPTY


def test_unit_inside_an_open_unit_is_part_of_it(tracing, stub):
    rec, q = stub

    def inner():
        # a prefill op inside a prefill wave, a pool copy inside a burst
        # and a second MoE level: none is timed apart
        _unit(rec, q, "prefill", 1.0, 2.0)
        _unit(rec, q, "pool", 2.0, 3.0)
        _unit(rec, q, "moe", 3.0, 5.0,
              inner=lambda: _unit(rec, q, "moe", 3.5, 4.0))

    _unit(rec, q, "prefill", 0.0, 6.0, inner=inner)
    f = q.drain()
    assert (f["dev_prefill_ms"], f["dev_pool_ms"], f["dev_moe_ms"]) == (
        pytest.approx(6.0), 0.0, pytest.approx(2.0))


def test_nested_unit_outside_an_engine_unit_is_not_timed(tracing, stub):
    """Training under ``--trace`` runs MoE blocks in no engine unit: no
    event is made and no queue grows."""
    rec, q = stub
    with rec.unit("moe"):
        pass
    assert q.drain() == EMPTY


def test_gap_chain_crosses_records(tracing, stub):
    rec, q = stub
    _unit(rec, q, "decode", 0.0, 1.0)
    _unit(rec, q, "decode", 3.0, 4.0)
    assert q.drain()["dev_gap_ms"] == pytest.approx(2.0)
    _unit(rec, q, "prefill", 9.0, 10.0)
    f = q.drain()
    assert (f["dev_prefill_ms"], f["dev_gap_ms"]) == (pytest.approx(1.0),
                                                      pytest.approx(5.0))


def test_units_in_flight_carry_to_a_later_record_in_order(tracing, stub):
    rec, q = stub
    _unit(rec, q, "decode", 0.0, 1.0)
    b = _unit(rec, q, "pool", 2.0, 4.0)
    _unit(rec, q, "prefill", 4.5, 5.0)  # complete, but queued behind b
    b.end.done = False
    f = q.drain()
    assert (f["dev_decode_ms"], f["dev_pool_ms"], f["dev_prefill_ms"]) == (
        pytest.approx(1.0), 0.0, 0.0)
    assert q.drain()["dev_pool_ms"] == 0.0  # still in flight
    b.end.done = True
    f = q.drain()
    assert (f["dev_pool_ms"], f["dev_prefill_ms"]) == (pytest.approx(2.0),
                                                       pytest.approx(0.5))
    assert f["dev_gap_ms"] == pytest.approx(1.0 + 0.5)  # 1 -> 2, 4 -> 4.5


def test_bound_drops_and_counts_and_breaks_the_chain(tracing, stub,
                                                     monkeypatch):
    rec, q = stub
    monkeypatch.setattr(UnitQueue, "CAP", 2)
    for i in range(5):  # nothing drains: two kept, three dropped
        _unit(rec, q, "decode", 10.0 * i, 10.0 * i + 1.0)
    assert q.dropped == 3
    f = q.drain()
    assert (f["dev_decode_ms"], f["dev_gap_ms"], f["dev_units_dropped"]) == (
        pytest.approx(2.0), pytest.approx(9.0), 3)
    _unit(rec, q, "decode", 100.0, 101.0)  # follows a hole: no gap back to 11
    _unit(rec, q, "decode", 102.0, 103.0)
    f = q.drain()
    assert (f["dev_decode_ms"], f["dev_gap_ms"], f["dev_units_dropped"]) == (
        pytest.approx(2.0), pytest.approx(1.0), 0)
    assert q.dropped == 3


def test_engines_on_two_threads_keep_their_own_units(tracing, stub):
    """Two engines in one process (``serve --replicas``, a disaggregated
    pair): each executor thread's units, the MoE units nested in them
    included, reach only its own engine's queue, interleaved as they
    are."""
    rec, _ = stub
    queues = {"a": UnitQueue("cuda:0"), "b": UnitQueue("cuda:1")}
    turn = threading.Barrier(2)

    def executor(name, base):
        q = queues[name]
        for i in range(3):
            CLOCK.now = base + 10.0 * i
            with rec.unit("decode", q):
                turn.wait()  # the other thread opens and nests meanwhile
                _unit(rec, None, "moe", base + 10.0 * i + 1.0,
                      base + 10.0 * i + 2.0)
                turn.wait()
                CLOCK.now = base + 10.0 * i + 4.0

    threads = [threading.Thread(target=executor, args=(n, b))
               for n, b in (("a", 0.0), ("b", 1000.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in ("a", "b"):
        f = queues[name].drain()
        # 3 bursts of 4 ms, 3 MoE blocks of 1 ms, 6 ms between bursts: a
        # unit of the other thread would add ms or a gap 1000 ms wide
        assert (f["dev_decode_ms"], f["dev_moe_ms"], f["dev_gap_ms"]) == (
            pytest.approx(12.0), pytest.approx(3.0), pytest.approx(12.0))
        assert queues[name].drain() == EMPTY


def test_off_makes_no_event_and_writes_no_field(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", _refuse)
    rec, q = FlightRecorder(capacity=4), UnitQueue("cuda")
    assert not global_tracer.enabled
    with rec.unit("decode", q):
        with rec.unit("moe"):
            pass
    assert q.drain() == {}


def test_on_but_not_a_cuda_device_times_nothing(tracing, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    rec, q = FlightRecorder(capacity=4), UnitQueue(torch.device("cpu"))
    with rec.unit("decode", q):
        with rec.unit("moe"):
            pass
    assert q.drain() == {}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_with_tracing_off_makes_no_event(flight, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", _refuse)
    assert not global_tracer.enabled
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE), device="cpu")
    # a queue timed as on the card: only the off-check keeps events out
    engine._units = UnitQueue("cuda")
    outs = _serve(engine, [[PROMPT, PROMPT[:40]], [PROMPT]])
    assert all(len(o) == 12 for wave in outs for o in wave)
    recs = flight.records()
    assert len(recs) >= 3
    assert not [f for r in recs for f in DEV_FIELDS if f in r]


def test_engine_times_every_kind_and_tiles_its_span(tracing, flight,
                                                    monkeypatch):
    """Host-clock stub events on a CPU engine whose queue is timed as on
    the card: every kind of unit is opened by the engine's entries, each
    record carries the fields, and the top-level units with their gaps
    cover first start -> last end."""
    _cuda_stubs(monkeypatch, HostEvent)
    engine = InferenceEngine(engine_cfg=EngineConfig(**ENGINE), device="cpu")
    q = engine._units = UnitQueue("cuda")
    units = []
    enqueue = q._enqueue

    def keep(u):
        units.append(u)
        enqueue(u)

    monkeypatch.setattr(q, "_enqueue", keep)
    # Wave 2 repeats wave 1's prompt: its pages come from the pool.
    _serve(engine, [[PROMPT, PROMPT[:40]], [PROMPT]])
    recs = flight.records()
    assert recs and all(
        all(f in r for f in DEV_FIELDS if f != "dev_moe_ms") for r in recs)
    tail = q.drain()  # units after the last record
    rows = recs + [tail]
    total = {f: sum(r.get(f, 0.0) for r in rows) for f in DEV_FIELDS}
    assert all(total[f] > 0.0 for f in DEV_FIELDS
               if f != "dev_units_dropped"), total
    assert total["dev_units_dropped"] == 0
    kinds = {u.kind for u in units}
    assert kinds == {"decode", "prefill", "pool", "moe"}
    # tiny-moe: 2 layers, one MoE block each per model call
    assert total["dev_moe_ms"] < total["dev_decode_ms"] + total["dev_prefill_ms"]
    top = [u for u in units if u.kind != "moe"]
    span = top[-1].end.t - top[0].start.t
    covered = (total["dev_decode_ms"] + total["dev_prefill_ms"]
               + total["dev_pool_ms"] + total["dev_gap_ms"])
    assert covered == pytest.approx(span, rel=1e-6, abs=1e-3)
    assert sum(u.cpu for u in top) == pytest.approx(total["exec_cpu_ms"],
                                                    abs=1e-2)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_gaps_on_the_card(tracing):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the units time CUDA events")
    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, device=dev)

    def work():
        for _ in range(8):
            x @ x

    work()
    torch.cuda.synchronize()
    rec, q = FlightRecorder(capacity=16), UnitQueue(dev)
    sleep_ms = 20.0
    with rec.unit("decode", q) as a:
        work()
    torch.cuda.synchronize()
    q.drain()
    time.sleep(sleep_ms / 1e3)  # the stream stands empty
    with rec.unit("prefill", q) as b:
        work()
    torch.cuda.synchronize()
    f = q.drain()
    assert f["dev_gap_ms"] >= sleep_ms - 0.5
    assert f["dev_prefill_ms"] > 0.0

    back = UnitQueue(dev)
    units = []
    for kind in ("decode", "prefill", "pool", "decode"):
        with rec.unit(kind, back) as u:
            work()
        units.append(u)
    torch.cuda.synchronize()
    g = back.drain()
    assert g["dev_gap_ms"] < 0.05  # queued back to back: no gap
    span = units[0].start.elapsed_time(units[-1].end)
    covered = (g["dev_decode_ms"] + g["dev_prefill_ms"] + g["dev_pool_ms"]
               + g["dev_gap_ms"])
    assert covered == pytest.approx(span, rel=0.03)
    whole = a.start.elapsed_time(b.end)
    assert (a.start.elapsed_time(a.end) + f["dev_gap_ms"]
            + f["dev_prefill_ms"]) == pytest.approx(whole, rel=0.03)
