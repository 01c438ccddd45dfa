"""The benchmark's traffic: one general generator and a closed-loop client.

Standard library only, and run as a child process of the benchmark
(``python benchmark/client.py ...``), so that parsing the streams never
shares an interpreter lock with the stack under test.  The HTTP/1.1 and
server-sent-event reading follows ``scripts/loadgen.py``, extended with
token-id prompts, a stamp for each request's send and each token's arrival,
and sessions of several turns that resend their whole history.

A traffic mix is a JSON file of parameters (``benchmark/traffic/<name>.json``):

- ``clients``: the closed loop's size; each client sends its next request
  only when the previous one has finished;
- ``warmup_s``: seconds of the same traffic before the measured window;
- ``ramp_s``: the clients' first requests are spread evenly over these
  seconds, so the loop does not move in lock-step;
- ``documents`` (optional): ``count`` shared documents of ``tokens`` ids,
  each session picking one with Zipf skew ``zipf_s``;
- ``turns``: turns a session has; a later turn resends the document, every
  earlier question and every earlier answer (its ids as streamed), then
  its own question;
- ``question`` and ``output``: the lengths of a turn's new prompt tokens
  and of its answer, each ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``.

Every seed gets the same set of sizes in another order: each length and
each document choice comes from a fixed pool of ``strata`` quantiles of its
distribution, and each round of draws (one a client) hands the clients the
whole pool in a permutation drawn from the seed.  The token ids themselves
are uniform over the vocabulary, drawn from the seed.

Prints one JSON line per request on standard output when it ends.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import random
import signal
import statistics
import sys
import time
from typing import Dict, Iterator, List, Optional


def quantile_pool(spec: Dict, strata: int) -> List[int]:
    """``strata`` lengths at the mid-quantiles of the distribution ``spec``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    us = [(k + 0.5) / strata for k in range(strata)]
    if spec["dist"] == "uniform":
        vals = [lo + u * (hi - lo) for u in us]
    elif spec["dist"] == "lognormal":
        nd = statistics.NormalDist()
        vals = [float(spec["median"]) * math.exp(float(spec["sigma"])
                                                 * nd.inv_cdf(u)) for u in us]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in vals]


def zipf_pool(count: int, s: float, strata: int) -> List[int]:
    """Document indices at the mid-quantiles of a Zipf law over ``count``
    documents (rank r weighs ``r ** -s``)."""
    w = [(r + 1) ** -s for r in range(count)]
    total = sum(w)
    cum, acc = [], 0.0
    for x in w:
        acc += x / total
        cum.append(acc)
    out = []
    for k in range(strata):
        u = (k + 0.5) / strata
        out.append(next(i for i, c in enumerate(cum) if c >= u))
    return out


def _rounds(pool: List[int], tag: str, client: int) -> Iterator[int]:
    """Client ``client``'s values, one a round: in round ``k`` the clients
    take the pool in the ``k``-th permutation drawn from ``tag``, so every
    round of requests holds the whole pool once (with as many clients as
    strata), whatever the seed."""
    k = 0
    while True:
        order = list(range(len(pool)))
        random.Random(f"{tag}:{k}").shuffle(order)
        yield pool[order[client % len(pool)]]
        k += 1


def document(mix: Dict, seed: int, index: int, vocab: int) -> List[int]:
    """Document ``index`` of the mix under ``seed``."""
    rng = random.Random(f"{seed}:doc:{index}")
    return [rng.randrange(vocab) for _ in range(int(mix["documents"]["tokens"]))]


def sessions(mix: Dict, seed: int, client: int, vocab: int) -> Iterator[Dict]:
    """Client ``client``'s sessions, endlessly: each ``{"doc": index or -1,
    "turns": [(question ids, answer length), ...]}``."""
    strata = int(mix.get("strata", 64))
    q_len = _rounds(quantile_pool(mix["question"], strata),
                    f"{seed}:question", client)
    out_len = _rounds(quantile_pool(mix["output"], strata),
                      f"{seed}:output", client)
    docs = None
    if mix.get("documents"):
        d = mix["documents"]
        docs = _rounds(zipf_pool(int(d["count"]), float(d["zipf_s"]), strata),
                       f"{seed}:document", client)
    ids = random.Random(f"{seed}:client:{client}:ids")
    while True:
        turns = []
        for _ in range(int(mix.get("turns", 1))):
            q = [ids.randrange(vocab) for _ in range(next(q_len))]
            turns.append((q, next(out_len)))
        yield {"doc": -1 if docs is None else next(docs), "turns": turns}


# ---------------------------------------------------------------------------
# HTTP/1.1 and server-sent events over asyncio streams
# ---------------------------------------------------------------------------

async def _read_headers(reader):
    status_line = await reader.readline()
    if not status_line:
        raise ConnectionError("empty response")
    status = int(status_line.decode("latin-1").split(" ", 2)[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def _iter_body(reader, headers):
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            size = int((await reader.readline()).strip().split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)
            yield data
    else:
        n = int(headers.get("content-length", "0") or "0")
        if n:
            yield await reader.readexactly(n)


async def complete(host: str, port: int, prompt: List[int], max_tokens: int,
                   rec: Dict) -> None:
    """One streaming ``POST /v1/completions``, greedy, ``ignore_eos``; fills
    ``rec`` with the send stamp, each token's arrival and the ids streamed
    (parsed from the ``"<id> "`` text of each event)."""
    body = json.dumps({
        "model": "bench", "prompt": prompt, "max_tokens": max_tokens,
        "stream": True, "temperature": 0.0, "ignore_eos": True,
    }).encode()
    head = (f"POST /v1/completions HTTP/1.1\r\nhost: {host}:{port}\r\n"
            f"content-type: application/json\r\n"
            f"content-length: {len(body)}\r\nconnection: close\r\n\r\n")
    rec["send"] = time.monotonic()
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(head.encode() + body)
        await writer.drain()
        status, headers = await _read_headers(reader)
        rec["status"] = status
        buf = b""
        async for chunk in _iter_body(reader, headers):
            now = time.monotonic()
            if status != 200:
                buf += chunk
                continue
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if not event.startswith(b"data: ") or event == b"data: [DONE]":
                    continue
                payload = json.loads(event[6:])
                if isinstance(payload.get("error"), dict):
                    rec["finish"] = str(payload["error"].get("code"))
                    continue
                choices = payload.get("choices") or []
                if not choices:
                    continue
                if choices[0].get("finish_reason"):
                    rec["finish"] = choices[0]["finish_reason"]
                for tok in (choices[0].get("text") or "").split():
                    rec["ids"].append(int(tok))
                    rec["times"].append(now)
        if status != 200:
            rec["error"] = buf[:200].decode("utf-8", "replace")
    except (ConnectionError, asyncio.IncompleteReadError, OSError,
            ValueError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        rec["end"] = time.monotonic()
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


#: The stack listens on the loopback; a request that streams for longer
#: than this has hung.
HOST = "127.0.0.1"
REQUEST_TIMEOUT_S = 180.0


def ok(rec: Dict) -> bool:
    """Did the request stream every token it asked for, cleanly?"""
    return (rec.get("status") == 200 and not rec.get("error")
            and rec.get("finish") == "length"
            and len(rec["ids"]) == rec["max"])


async def _client(args, mix, client: int, docs, out: List[Dict],
                  stop: asyncio.Event) -> None:
    await asyncio.sleep(float(mix.get("ramp_s", 0.0)) * client
                        / int(mix["clients"]))
    for k, sess in enumerate(sessions(mix, args.seed, client, args.vocab)):
        history = list(docs[sess["doc"]]) if sess["doc"] >= 0 else []
        for turn, (question, n_out) in enumerate(sess["turns"]):
            if stop.is_set() or time.monotonic() >= args.stop_at:
                return
            prompt = history + question
            rec = {"c": client, "s": k, "turn": turn, "doc": sess["doc"],
                   "prompt": prompt, "max": n_out, "status": 0,
                   "finish": None, "ids": [], "times": []}
            out.append(rec)
            await asyncio.wait_for(
                complete(HOST, args.port, prompt, n_out, rec),
                timeout=REQUEST_TIMEOUT_S)
            if not ok(rec):
                break  # a broken history ends the session
            history = prompt + rec["ids"]


async def amain(args) -> List[Dict]:
    with open(args.mix) as f:
        mix = json.load(f)
    docs = {}
    if mix.get("documents"):
        docs = {i: document(mix, args.seed, i, args.vocab)
                for i in range(int(mix["documents"]["count"]))}
    out: List[Dict] = []
    # SIGUSR1 from the benchmark: send nothing more, finish what is open.
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGUSR1, stop.set)
    tasks = [asyncio.create_task(_client(args, mix, c, docs, out, stop))
             for c in range(int(mix["clients"]))]
    results = await asyncio.gather(*tasks, return_exceptions=True)
    for c, res in enumerate(results):
        if isinstance(res, BaseException):
            # A timed-out request stays in ``out`` with too few tokens:
            # it counts as failed.
            print(f"client {c}: {type(res).__name__}: {res}", file=sys.stderr)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--mix", required=True, help="traffic mix JSON file")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--vocab", type=int, required=True)
    ap.add_argument("--stop-at", type=float, required=True,
                    help="time.monotonic() after which no request is sent "
                         "(SIGUSR1 stops sending earlier)")
    args = ap.parse_args(argv)
    for rec in asyncio.run(amain(args)):
        sys.stdout.write(json.dumps(rec, separators=(",", ":")) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
