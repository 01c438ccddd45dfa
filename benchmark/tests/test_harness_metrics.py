"""Every metric reader on synthetic client, flight, span and device
records, against hand counts."""

import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import measures
from benchmark.arch import mistral
from benchmark.arch.mistral import Shape
from benchmark.devtrace import DeviceSummary, _merge

ROOT = Path(__file__).resolve().parents[2]
SHAPE = Shape(32000, 4096, 14336, 32, 32, 8, 128, 1e4, 1e-5, 4096, 0, 0)


def req(send, times, plen=100, n=None, status=200, finish="length"):
    ids = list(range(len(times)))
    return {"c": 0, "s": 0, "turn": 0, "prompt": [1] * plen,
            "max": len(times) if n is None else n, "status": status,
            "finish": finish, "ids": ids, "times": list(times),
            "send": send, "end": (times[-1] if times else send) + 0.001}


class Bursts:
    def __init__(self, bursts):
        self.bursts = bursts

    def between(self, t0, t1):
        return [rows for t, rows in self.bursts if t0 <= t < t1]


def ctx(**kw):
    base = dict(shape=SHAPE, arch=mistral, seconds=10.0, t0=100.0, t1=110.0,
                setup_s=42.5, requests=[])
    base.update(kw)
    return measures.Context(**base)


def test_every_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(measures.load(m["name"])), m["name"]


def test_out_tok_s_counts_tokens_inside_the_window():
    c = ctx(requests=[req(99.0, [99.5, 100.0, 105.0, 110.0]),
                      req(101.0, [101.2, 101.3])])
    assert measures.load("out_tok_s")(c) == pytest.approx(4 / 10.0)


def test_ttft_p95_over_requests_sent_in_window():
    reqs = [req(100.0 + i * 0.1, [100.0 + i * 0.1 + 0.001 * (i + 1)])
            for i in range(40)]
    reqs.append(req(99.0, [109.0]))  # sent before the window: not counted
    c = ctx(requests=reqs)
    # 40 values 1..40 ms: nearest rank 95% is the 38th
    assert measures.load("ttft_p95_ms")(c) == pytest.approx(38.0)


def test_failed_request_counts_as_missing_the_tail():
    reqs = [req(100.0 + i, [100.0 + i + 0.01]) for i in range(5)]
    reqs[2]["status"] = 429
    c = ctx(requests=reqs)
    assert measures.ttfts_ms(c).count(math.inf) == 1
    assert measures.load("ttft_p95_ms")(c) is None  # the tail is a failure


def test_tpot_p95():
    reqs = [req(100.0, [100.1, 100.2, 100.3]),  # 100 ms a token
            req(100.0, [100.1, 100.15, 100.2]),  # 50
            req(100.0, [100.1, 111.0])]  # ends after the window
    c = ctx(requests=reqs)
    assert sorted(measures.tpots_ms(c)) == pytest.approx([50.0, 100.0])
    assert measures.load("tpot_p95_ms")(c) == pytest.approx(100.0)


def test_setup_s():
    assert measures.load("setup_s")(ctx()) == 42.5


def test_flight_readers():
    flight = [
        {"t": 99.0, "dur_ms": 1000.0, "fetch_ms": 0.0, "decode_steps": 8,
         "decode_rows": 1},  # before the window
        {"t": 100.5, "dur_ms": 50.0, "fetch_ms": 10.0, "decode_steps": 8,
         "decode_rows": 64},
        {"t": 101.0, "dur_ms": 30.0, "fetch_ms": 6.0, "decode_steps": 4,
         "decode_rows": 32},
        {"t": 101.5, "dur_ms": 5.0, "fetch_ms": 0.0, "decode_steps": 0,
         "decode_rows": 0},
    ]
    c = ctx(flight=flight)
    assert measures.load("engine_host_ms_per_step")(c) == pytest.approx(
        (40.0 + 24.0 + 5.0) / 12)
    assert measures.load("decode_rows_mean")(c) == pytest.approx(
        (64 * 8 + 32 * 4) / 12)
    assert measures.load("decode_rows_mean")(ctx()) is None


def test_tunnel_overhead_from_spans():
    def span(name, tid, ts):
        return SimpleNamespace(name=name, trace_id=tid, ts=ts)

    spans = [span("engine.first_token", "a", 100.0),
             span("proxy.first_byte", "a", 100.002),
             span("engine.first_token", "b", 101.0),
             span("proxy.first_byte", "b", 101.004),
             span("engine.first_token", "c", 102.0),
             span("proxy.first_byte", "c", 102.010),
             span("proxy.first_byte", "d", 103.0),  # no engine span
             span("engine.first_token", "e", 90.0),
             span("proxy.first_byte", "e", 90.5)]  # before the window
    assert measures.load("tunnel_ttft_overhead_ms")(ctx(spans=spans)) \
        == pytest.approx(4.0)


def test_prefix_hit_share():
    reqs = [req(100.0, [100.1], plen=300), req(105.0, [105.1], plen=100),
            req(99.0, [99.1], plen=5000)]
    c = ctx(requests=reqs,
            counters={"engine_prefix_hit_tokens_total": (1000.0, 1300.0)})
    assert measures.load("prefix_hit_share")(c) == pytest.approx(75.0)


def test_step_mfu_by_hand():
    # one request: first token (prefill of 100) and two decode tokens
    reqs = [req(100.0, [100.1, 100.2, 100.3], plen=100)]
    c = ctx(requests=reqs,
            counters={"engine_prefix_hit_tokens_total": (0.0, 50.0)})
    flops = (mistral.prefill_flops(SHAPE, 50, 100)
             + mistral.decode_flops(SHAPE, 100)
             + mistral.decode_flops(SHAPE, 101))
    assert measures.load("step_mfu")(c) == pytest.approx(
        100.0 * flops / (10.0 * 989e12))


def summary(intervals, by_name, t0=200.0, t1=203.0, gaps=()):
    return DeviceSummary(window_s=t1 - t0, intervals=intervals,
                         by_name=by_name, t0=t0, t1=t1, gaps=list(gaps))


def test_device_idle_share():
    d = summary([(200.0, 200.5), (201.0, 202.0)], {})
    assert measures.load("device_idle_share")(ctx(device=d)) \
        == pytest.approx(50.0)
    assert measures.load("device_idle_share")(ctx()) is None


def test_decode_attn_roofline_by_hand():
    rows = [(1000, 8), (10, 8)]
    bursts = Bursts([(199.0, [(5, 8)]), (200.5, rows), (201.5, rows)])
    # 2 bursts x 8 steps x 32 layers = 512 launches, 1 ms each
    d = summary([], {"void fused_decode_layer_kernel<128, 4>(...)": (512, 0.512),
                     "gemm": (10, 1.0)})
    nbytes_per_step = sum(mistral.decode_attention_bytes(SHAPE, p + i)
                          for p, _ in rows for i in range(8)) / 8
    want = 100.0 * nbytes_per_step / 3.35e12 / 1e-3
    c = ctx(device=d, bursts=bursts)
    assert measures.load("decode_attn_roofline")(c) == pytest.approx(want)
    no_kernel = summary([], {"gemm": (10, 1.0)})
    assert measures.load("decode_attn_roofline")(
        ctx(device=no_kernel, bursts=bursts)) is None


def test_merge_and_gaps():
    assert _merge([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    d = summary([(200.0, 201.0)], {}, gaps=[(201.0, 203.0), (200.0, 200.0)])
    phases = [(199.0, "admit"), (200.9, "decode_fetch"), (201.5, "process")]
    assert d.top_gaps(phases) == [["decode_fetch", 2.0], ["admit", 0.0]]
    d2 = summary([], {"a": (1, 0.5), "b": (3, 1.5)})
    assert d2.top_ops() == [["b", 1.5], ["a", 0.5]]
    assert d2.kernel("a") == (1, 0.5)


def traced(*device_ops):
    """A profiled window from 200 s to 203 s on the host's clock whose
    trace holds the sync range at 0 us and ``(name, start s, end s)``
    device operations on the trace's clock."""
    from torch.autograd import DeviceType

    from benchmark.devtrace import DeviceWindow

    def ev(name, a, b, kind):
        return SimpleNamespace(name=name, device_type=kind,
                               time_range=SimpleNamespace(start=a * 1e6,
                                                          end=b * 1e6))

    events = [ev(DeviceWindow.SYNC, 0.0, 0.0, DeviceType.CPU)]
    events += [ev(n, a, b, DeviceType.CUDA) for n, a, b in device_ops]
    w = DeviceWindow()
    w._prof = SimpleNamespace(events=lambda: events)
    w.t0, w.t1, w._t_sync = 200.0, 203.0, 200.0
    return w.summary()


@pytest.mark.parametrize("ops", [
    [],
    [("Memset (Device)", 0.1, 0.2),
     ("Memcpy HtoD (Pageable -> Device)", 1.0, 1.1),
     ("Memcpy DtoH (Device -> Pinned)", 2.0, 2.1)],
])
def test_a_window_without_kernels_is_blind(ops):
    assert traced(*ops) is None


def test_a_window_with_kernels_reads_them():
    d = traced(("Memset (Device)", 0.1, 0.2), ("gemm", 1.0, 1.5),
               ("gemm", 1.4, 2.0))
    assert d.busy_s == pytest.approx(1.1)
    assert d.kernel("gemm") == (2, pytest.approx(1.1))


def test_every_reader_is_a_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.name[:-3] for p in measures.METRICS_DIR.glob("*.py")}
    assert files == names


def test_host_load_reads_threads_processes_and_gc():
    import gc

    from benchmark.probes import HostLoad

    host = HostLoad()
    host.start()
    gc.collect()
    t = time.monotonic()
    while time.monotonic() - t < 0.2:
        pass
    out = host.stop()
    assert out["gc_pauses"] >= 1 and out["gc_pause_s"] > 0
    assert 0.5 < out["stack_cpu_share"] < 2.0
    assert out["stack_threads"][0][0] == "MainThread"
    assert out["processes"] and out["processes"][0][1] > 0
    assert gc.callbacks.count(host._gc) == 0
