"""The readers of the port's device-timed flight fields (dev_*_ms,
exec_cpu_ms) on synthetic flight records, against hand counts; records
that end after the window, or a window with dropped units, left out; and
None where the records carry no such field, as a CPU run's or an untimed
program's do."""

import pytest

from benchmark import measures
from benchmark.arch import mistral
from benchmark.arch.mistral import Shape

SHAPE = Shape(32000, 4096, 14336, 32, 32, 8, 128, 1e4, 1e-5, 4096, 0, 0)
NEW = ("decode_device_ms_per_step", "device_gap_share",
       "engine_cpu_ms_per_step", "moe_device_share", "pool_device_share")


def ctx(flight):
    return measures.Context(shape=SHAPE, arch=mistral, seconds=10.0, t0=100.0,
                            t1=110.0, setup_s=1.0, requests=[], flight=flight)


def rec(t, steps, decode, prefill, pool, gap, cpu, moe=None, dur=50.0):
    r = {"t": t, "dur_ms": dur, "fetch_ms": 5.0, "decode_steps": steps,
         "decode_rows": 8, "dev_decode_ms": decode, "dev_prefill_ms": prefill,
         "dev_pool_ms": pool, "dev_gap_ms": gap, "exec_cpu_ms": cpu,
         "dev_units_dropped": 0}
    if moe is not None:
        r["dev_moe_ms"] = moe
    return r


FLIGHT = [
    rec(99.5, 8, 900.0, 900.0, 900.0, 900.0, 900.0, 900.0),  # before t0
    rec(100.2, 8, 80.0, 20.0, 5.0, 40.0, 6.0, 60.0),
    rec(104.0, 4, 40.0, 0.0, 0.0, 10.0, 3.0, 30.0),
    rec(106.0, 0, 0.0, 30.0, 15.0, 50.0, 2.0),  # no MoE unit resolved
    # begins in the window, ends after it: its drain holds the profiler's
    # start stall
    rec(109.99, 8, 900.0, 900.0, 900.0, 900.0, 900.0, 900.0, dur=400.0),
    rec(110.0, 8, 900.0, 900.0, 900.0, 900.0, 900.0, 900.0),  # at t1: out
]


def read(name, flight):
    return measures.load(name)(ctx(flight))


def test_decode_device_ms_per_step():
    assert read("decode_device_ms_per_step", FLIGHT) == pytest.approx(
        (80.0 + 40.0) / 12)


def test_device_gap_share_over_the_window():
    assert read("device_gap_share", FLIGHT) == pytest.approx(
        100.0 * (40.0 + 10.0 + 50.0) / 10000.0)


def test_engine_cpu_ms_per_step():
    assert read("engine_cpu_ms_per_step", FLIGHT) == pytest.approx(
        (6.0 + 3.0 + 2.0) / 12)


def test_moe_device_share_of_the_model_units():
    assert read("moe_device_share", FLIGHT) == pytest.approx(
        100.0 * (60.0 + 30.0) / (80.0 + 20.0 + 40.0 + 30.0))


def test_pool_device_share_of_all_units():
    assert read("pool_device_share", FLIGHT) == pytest.approx(
        100.0 * (5.0 + 15.0) / ((80.0 + 40.0) + (20.0 + 30.0) + (5.0 + 15.0)))


@pytest.mark.parametrize("name", NEW)
def test_untimed_records_read_none(name):
    """The parent program, a CPU run or a run with tracing off writes no
    device-timed field: every reader returns None and raises nothing."""
    plain = [{k: v for k, v in r.items()
              if not k.startswith("dev_") and k != "exec_cpu_ms"}
             for r in FLIGHT]
    assert read(name, plain) is None
    assert read(name, []) is None


def test_dense_model_has_no_moe_share():
    dense = [{k: v for k, v in r.items() if k != "dev_moe_ms"} for r in FLIGHT]
    assert read("moe_device_share", dense) is None
    assert read("pool_device_share", dense) is not None


def test_steps_free_window_reads_none_per_step():
    idle = [rec(101.0, 0, 0.0, 30.0, 1.0, 2.0, 1.0)]
    assert read("decode_device_ms_per_step", idle) is None
    assert read("engine_cpu_ms_per_step", idle) is None
    assert read("device_gap_share", idle) == pytest.approx(100.0 * 2.0 / 1e4)


@pytest.mark.parametrize("name", NEW)
def test_window_with_dropped_units_reads_none(name):
    """The unit queue overflowed in the window: the fields undercount, so
    no reader returns a number."""
    holed = [dict(r) for r in FLIGHT]
    holed[2]["dev_units_dropped"] = 4
    assert read(name, holed) is None
    # a hole before the window leaves the window's reading alone
    early = [dict(r) for r in FLIGHT]
    early[0]["dev_units_dropped"] = 4
    assert read(name, early) == read(name, FLIGHT)
