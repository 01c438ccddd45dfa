"""The traffic generator: deterministic by seed, the same sizes for every
seed, and within each cell's context."""

import json
from itertools import islice
from pathlib import Path

import pytest

from benchmark import client

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def plan(m, seed, c, n=6):
    return list(islice(client.sessions(m, seed, c, 32000), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    m = mix(name)
    assert plan(m, 2**31 + 11, 3) == plan(m, 2**31 + 11, 3)
    assert plan(m, 2**31 + 11, 3) != plan(m, 2**31 + 12, 3)
    assert plan(m, 2**31 + 11, 3) != plan(m, 2**31 + 11, 4)


@pytest.mark.parametrize("name", MIXES)
def test_every_round_holds_the_same_sizes_for_every_seed(name):
    m = mix(name)
    assert int(m["strata"]) == int(m["clients"])

    def rounds(seed):
        per_client = [plan(m, seed, c, 2) for c in range(int(m["clients"]))]
        out = []
        for k in range(2):
            sess = [p[k] for p in per_client]
            out.append((sorted(len(q) for s in sess for q, _ in s["turns"]),
                        sorted(n for s in sess for _, n in s["turns"]),
                        sorted(s["doc"] for s in sess)))
        return out

    a = rounds(5)
    assert a == rounds(2**31 + 99) == rounds(123456789)
    assert a[0] == a[1]


def test_quantile_pools():
    assert client.quantile_pool({"dist": "uniform", "min": 0, "max": 100}, 4) \
        == [12, 38, 62, 88]
    pool = client.quantile_pool({"dist": "lognormal", "median": 400,
                                 "sigma": 0.8, "min": 64, "max": 1536}, 64)
    assert pool == sorted(pool) and pool[0] == 64 and pool[-1] == 1536
    assert pool[31] <= 400 <= pool[32]
    z = client.zipf_pool(8, 1.1, 64)
    assert z == sorted(z) and set(z) == set(range(8))
    assert z.count(0) > z.count(1) > z.count(7)


def test_documents_are_shared_and_seeded():
    m = mix("doc-sessions")
    a = client.document(m, 7, 2, 32000)
    assert a == client.document(m, 7, 2, 32000) and len(a) == 2048
    assert a != client.document(m, 8, 2, 32000)
    assert all(0 <= t < 32000 for t in a)


def test_cells_fit_their_context():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    confs = {c["name"]: json.loads((ROOT / c["file"]).read_text())
             for c in bench["configs"]}
    for cell in bench["workloads"]:
        m = mix(cell["traffic"])
        max_seq = confs[cell["config"]]["engine"]["max_seq"]
        doc = m["documents"]["tokens"] if m.get("documents") else 0
        turns = int(m.get("turns", 1))
        longest = (doc + turns * m["question"]["max"]
                   + turns * m["output"]["max"])
        assert longest <= max_seq, cell["name"]
        if cell["traffic"] == "doc-sessions":
            assert longest - m["output"]["max"] < 3300
