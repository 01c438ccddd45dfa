#!/usr/bin/env python
"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  One process, in order:

1. finds the cell in ``BENCHMARK.json``, its configuration file
   (``benchmark/configs/<config>.json``), its traffic mix
   (``benchmark/traffic/<traffic>.json``) and the readers of its metrics
   (``benchmark/metrics/<metric>.py``), all by name;
2. draws the weights from ``--seed`` on the card (the configuration's
   architecture, ``benchmark/arch/<name>.py``) and hands them to the
   port's engine, which serves them behind its tunnel
   (``stack.py``: engine -> serve -> loopback -> proxy on 127.0.0.1);
3. warms up: the engine's kernels and programs, then ``warmup_s`` of the
   cell's own traffic;
4. runs the traffic client as a child process (``client.py``) and measures
   for ``--seconds``; with ``--trace 1`` the port's request spans are on
   through the window and a ``torch.profiler`` window follows it, under
   the same traffic;
5. checks what was served against the plain reference (``check.py``) once
   the window has closed and the engine's state is freed, and prints the
   checks as the last lines of standard error and one JSON line as the
   last line of standard output.

Exits non-zero with no result when there is no card (or fewer than the
cell asks for), when the engine fenced a flag the configuration names,
and when ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded.
``--control 1`` judges the float8 control's tokens in place of the served
ones, through the same limits, so its run comes out as not correct
(calibration only; the benchmark's own runs do not).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
# Run as a script, the interpreter puts benchmark/ first on the path; the
# harness imports itself as the package ``benchmark`` from the root.
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that may not be loaded: the port runs without JAX.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "p2p_llm_tunnel_tpu"})
#: Seconds of the device window that follows a traced run's window, and
#: how many windows a traced run takes before it gives the device up.
DEVICE_WINDOW_S = 3.0
DEVICE_WINDOWS = 3
#: Counters whose change over the window the readers may ask for.
COUNTERS = ("engine_prefix_hit_tokens_total",)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc libraries already live in build/torch_kernels)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def load_cell(workload: str) -> Dict:
    """The cell ``workload`` with its configuration, mix and metric names,
    found by name in ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [(m["name"], m["unit"]) for m in metrics
                if workload in m.get("workloads", [workload])]

    return {
        "name": workload,
        "chips": int(cell["chips"]),
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "mix_file": str(HERE / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def _counters(names) -> Dict[str, float]:
    from p2p_llm_tunnel_tpu_torch.utils.metrics import global_metrics

    return {n: global_metrics.counter(n) for n in names}


async def _sleep_until(t: float, stack) -> None:
    while True:
        alive, why = stack.alive()
        if not alive:
            raise RuntimeError(f"the stack stopped serving: {why}")
        left = t - time.monotonic()
        if left <= 0:
            return
        await asyncio.sleep(min(0.25, left))


def _free_engine(engine) -> None:
    """Drop the engine's device state (cache, pool, carries) so the
    reference runs in the memory the program held."""
    for name in ("kv_cache", "_pool", "_bias", "_dev_tokens",
                 "_dev_positions", "_dev_counts"):
        if hasattr(engine, name):
            setattr(engine, name, None)


async def measure(cell: Dict, seed: int, seconds: float, trace: bool,
                  device: str, control: bool = False,
                  tamper: Optional[Callable] = None,
                  t_start: float = T_START) -> Dict:
    """One run of ``cell``; returns the result line's fields and the
    checks.  ``tamper(engine)``, for tests only, breaks the timed path."""
    import torch

    from p2p_llm_tunnel_tpu_torch.utils.flight import global_flight
    from p2p_llm_tunnel_tpu_torch.utils.tracing import global_tracer

    from benchmark import arch, check, measures, weights
    from benchmark.client import ok
    from benchmark.devtrace import DeviceWindow
    from benchmark.probes import BurstLog, HostLoad, PhaseLog
    from benchmark.stack import Stack, build_engine

    cfg = cell["config"]
    mix = json.loads(Path(cell["mix_file"]).read_text())
    model = arch.for_config(cfg)
    shape = model.shape(cfg)
    cuda = device == "cuda"

    marks = {"imports": time.monotonic() - t_start}
    params = model.draw(shape, seed, device)
    before = weights.digest(params)
    marks["weights"] = time.monotonic() - t_start
    global_flight.configure(capacity=1_000_000)
    global_flight.reset()
    global_tracer.configure(enabled=trace, capacity=1_000_000, sample=1.0)
    global_tracer.clear()
    engine = build_engine(cfg, params, device)
    marks["engine"] = time.monotonic() - t_start
    await engine.start()
    await engine.warmup()
    marks["warmup"] = time.monotonic() - t_start
    bursts = BurstLog(engine) if trace else None
    if tamper is not None:
        tamper(engine)
    stack = Stack(engine, int(cfg.get("serve", {}).get("max_inflight", 256)))
    port = await stack.start()
    if trace and cuda:
        DeviceWindow.warm()

    t_launch = time.monotonic()
    marks["stack"] = t_launch - t_start
    t0 = t_launch + float(mix["warmup_s"])
    t1 = t0 + seconds
    client = subprocess.Popen(
        [sys.executable, str(HERE / "client.py"), "--port", str(port),
         "--mix", cell["mix_file"], "--seed", str(seed),
         "--vocab", str(shape.vocab_size),
         "--stop-at", repr(t1 + DEVICE_WINDOW_S * DEVICE_WINDOWS + 5.0)],
        stdout=subprocess.PIPE, text=True)
    summary, blind, phases, host_load = None, 0, [], {}
    try:
        await _sleep_until(t0, stack)
        counters0 = _counters(COUNTERS)
        setup_s = time.monotonic() - t_start
        host = HostLoad()
        host.start()
        await _sleep_until(t1, stack)
        counters1 = _counters(COUNTERS)
        host_load = host.stop()
        if trace and cuda:
            for _ in range(DEVICE_WINDOWS):
                log = PhaseLog(global_flight)
                dw = DeviceWindow()
                dw.start()
                await _sleep_until(dw.t0 + DEVICE_WINDOW_S, stack)
                dw.stop()
                log.close()
                summary = dw.summary()
                if summary is not None:
                    phases = log.phases
                    break
                blind += 1
                print(f"[devtrace] blind device window {blind}", file=sys.stderr)
    finally:
        client.send_signal(signal.SIGUSR1)
        try:
            out, _ = await asyncio.to_thread(client.communicate, timeout=300)
        except subprocess.TimeoutExpired:  # a hung stream: end the client
            client.kill()
            out, _ = await asyncio.to_thread(client.communicate)
    recs = [json.loads(line) for line in out.splitlines() if line.strip()]
    flight = global_flight.records()
    spans = global_tracer.records() if trace else []
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    await stack.stop()
    _free_engine(engine)
    if bursts is not None:
        bursts.release()
    del engine, stack
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The window has closed: judge what it served.
    unchanged = bool(torch.equal(before, weights.digest(params)))
    sent = [r for r in recs if t0 <= r["send"] < t1]
    correct, checks, readings = check.judge(cfg, model, shape, params, recs,
                                            sent, seed, device, control,
                                            unchanged)

    ctx = measures.Context(
        shape=shape, arch=model, seconds=seconds, t0=t0, t1=t1,
        setup_s=setup_s, requests=recs, flight=flight, spans=spans,
        counters={n: (counters0[n], counters1[n]) for n in COUNTERS},
        device=summary, bursts=bursts)
    metrics = {}
    for name, unit in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = measures.load(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": len(sent),
              "failed": sum(1 for r in sent if not ok(r)),
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(),
                               "idle_gaps": summary.top_gaps(phases)}
    notes = {"setup_marks_s": {k: round(v, 2) for k, v in marks.items()},
             "tok_s_by_5s": measures.rate_series(recs, t_launch, t1, 5.0),
             "tails_ms": {
                 "ttft_p95": measures.nearest_rank(measures.ttfts_ms(ctx), 95),
                 "tpot_p95": measures.nearest_rank(measures.tpots_ms(ctx), 95)},
             "host": host_load,
             **readings,
             "blind_device_windows": blind,
             "requests_total": len(recs)}
    return {"result": result, "checks": checks, "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        print(f"[card] {card}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    out = asyncio.run(measure(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", control=bool(args.control)))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out["notes"]), file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    result = dict(out["result"])
    # A number that could not be read (no request finished) prints null.
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
