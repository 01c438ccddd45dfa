"""The architecture modules (``benchmark/arch/``): the one the two
configurations name, ``mistral``, gives the weights, reference logits, work
counts and engine fields that the harness gave before they moved there (the
values below were read from that code and are pinned here), and nothing of
the harness outside the folder names an architecture."""

import ast
import hashlib
import json
import math
import re
from pathlib import Path

import pytest
import torch

from p2p_llm_tunnel_tpu_torch.models.config import get_config

from benchmark import arch, stack, weights
from benchmark.arch import mistral

HERE = Path(__file__).resolve().parents[1]
TINY = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "vocab_size": 300}
CASES = {
    "dense-window": dict(TINY, sliding_window=7),
    "moe": dict(TINY, sliding_window=None, num_local_experts=4,
                num_experts_per_tok=2),
}
SEEDS = (7, 2**31 + 11)
POSITIONS = (0, 1, 5, 6, 7, 8, 100, 4094, 4095, 4096, 5000)
#: What only an architecture module may name: its weight leaves and keys.
ARCH_NAMES = re.compile(r"\b(moe_gate|w_gate|num_local_experts)\b")
#: The ModelConfig fields the harness laid over each configuration's preset.
FIELDS = {
    "mistral-7b": {
        "vocab_size": 32000, "dim": 4096, "ffn_dim": 14336, "n_layers": 32,
        "n_heads": 32, "n_kv_heads": 8, "head_dim": 128,
        "rope_theta": 10000.0, "norm_eps": 1e-05, "sliding_window": 4096,
        "n_experts": 0, "n_experts_per_tok": 0},
    "mixtral-8x7b-16l": {
        "vocab_size": 32000, "dim": 4096, "ffn_dim": 14336, "n_layers": 16,
        "n_heads": 32, "n_kv_heads": 8, "head_dim": 128,
        "rope_theta": 1000000.0, "norm_eps": 1e-05, "sliding_window": None,
        "n_experts": 8, "n_experts_per_tok": 2},
}

#: ``weights.digest`` of the parent's ``draw`` (one float64 sum a leaf).
DIGESTS = {
    ('dense-window', 7): [
        190.828125, 191.75390625, 5.264430463314056, -18.904472783207893,
        -2.252259373664856, -14.857174158096313, 5.181648790836334,
        20.456976771354675, -29.056873321533203, 5.781565308570862,
        63.97265625, 4.718228280544281,
    ],
    ('dense-window', 2147483659): [
        193.0703125, 191.72265625, -16.298228703439236, 7.8575063943862915,
        17.820395052433014, -6.326621890068054, 16.220003366470337,
        -6.57986581325531, -4.416395917534828, 6.58028057217598, 63.84375,
        -38.90826940536499,
    ],
    ('moe', 7): [
        190.828125, 191.75390625, 41.58135455381125, -9.461429879069328,
        35.12218019366264, 0.5174064636230469, -14.857174158096313,
        5.181648790836334, 20.456976771354675, -29.056873321533203,
        1.211416631937027, 65.19140625, -18.505390375852585,
    ],
    ('moe', 2147483659): [
        193.0703125, 191.72265625, 28.437196414917707, 14.201755121350288,
        -65.37180515378714, -1.8966670036315918, -6.326621890068054,
        16.220003366470337, -6.57986581325531, -4.416395917534828,
        10.4660035520792, 64.1171875, 10.215309977531433,
    ],
}
#: sha256 (first 24 hex digits) of the parent's ``logits_at`` bytes, one
#: per sequence.
LOGITS = {
    ('dense-window', 7, 'fp32'):
        ('9c2f0ff0bc7f745826da0e74', '4a3a274ac768bd72c063c766'),
    ('dense-window', 7, 'fp8'):
        ('e684a6a8b9b93c47ab1aa34e', '03a16696855340ebd1941b11'),
    ('dense-window', 2147483659, 'fp32'):
        ('9ea0dc61c70ce4e447b19da2', 'c95de27bba0eec4aa7ebf7e9'),
    ('dense-window', 2147483659, 'fp8'):
        ('83a2d91c39e1aedff7916190', '08dc683cc152b2ae302e2851'),
    ('moe', 7, 'fp32'):
        ('85e4ae84820704424d39f412', '52c8c67ade2149ad45153de7'),
    ('moe', 7, 'fp8'):
        ('cb6f535cbca68d5621f2a89a', '5cb8d0ecfe8ba8b286486ce1'),
    ('moe', 2147483659, 'fp32'):
        ('5a11a36acb328b6228425850', '1d1c56e44fad2a9f87576a0a'),
    ('moe', 2147483659, 'fp8'):
        ('9f42ae4017d46b7fb2997f3d', '4b138a0d233ec6b7787bbadd'),
}
#: The parent's counts, each summed (``math.fsum``) over ``POSITIONS``
#: (``prefill_flops`` over every pair of them, ``burst_bytes`` over rows of
#: 8 steps from each).
COUNTS = {
    'mistral-7b': {
        'matmul_flops_per_token': 13958643712.0,
        'head_flops': 262144000.0,
        'attention_flops': 8654946304.0,
        'prefill_flops': 1871188665040896.0,
        'decode_flops': 165088329728.0,
        'decode_attention_bytes': 67878912.0,
        'burst_bytes': 543862784.0,
    },
    'mixtral-8x7b-16l': {
        'matmul_flops_per_token': 12617515008.0,
        'head_flops': 262144000.0,
        'attention_flops': 4564451328.0,
        'prefill_flops': 1634896431284224.0,
        'decode_flops': 146243584000.0,
        'decode_attention_bytes': 71589888.0,
        'burst_bytes': 573980672.0,
    },
    'dense-window': {
        'matmul_flops_per_token': 184320.0,
        'head_flops': 38400.0,
        'attention_flops': 46848.0,
        'prefill_flops': 23493427200.0,
        'decode_flops': 2499840.0,
        'decode_attention_bytes': 12544.0,
        'burst_bytes': 107904.0,
    },
    'moe': {
        'matmul_flops_per_token': 296448.0,
        'head_flops': 38400.0,
        'attention_flops': 13372416.0,
        'prefill_flops': 248688804864.0,
        'decode_flops': 17064192.0,
        'decode_attention_bytes': 2234368.0,
        'burst_bytes': 17914368.0,
    },
}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def shapes():
    out = {n: mistral.shape(config(n)) for n in FIELDS}
    out.update({c: mistral.shape(cfg) for c, cfg in CASES.items()})
    return out


def inputs(seed):
    gen = torch.Generator().manual_seed(seed % 1000)
    seqs = [torch.randint(0, 300, (n,), generator=gen) for n in (23, 9)]
    return seqs, [(5, 23), (0, 9)]


@pytest.mark.parametrize("case,seed", sorted(DIGESTS))
def test_draw_gives_the_pinned_weights(case, seed):
    params = mistral.draw(mistral.shape(CASES[case]), seed, "cpu")
    assert [float(x) for x in weights.digest(params)] == DIGESTS[case, seed]


@pytest.mark.parametrize("case,seed,precision", sorted(LOGITS))
def test_logits_at_gives_the_pinned_logits(case, seed, precision):
    shape = mistral.shape(CASES[case])
    params = mistral.draw(shape, seed, "cpu")
    seqs, want = inputs(seed)
    got = mistral.logits_at(shape, params, seqs, want, precision=precision)
    assert tuple(hashlib.sha256(t.contiguous().numpy().tobytes())
                 .hexdigest()[:24] for t in got) == LOGITS[case, seed, precision]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_give_the_pinned_numbers(name):
    s, m = shapes()[name], mistral
    got = {
        "matmul_flops_per_token": m.matmul_flops_per_token(s),
        "head_flops": m.head_flops(s),
        "attention_flops": math.fsum(m.attention_flops(s, p)
                                     for p in POSITIONS),
        "prefill_flops": math.fsum(m.prefill_flops(s, a, b)
                                   for a in POSITIONS for b in POSITIONS),
        "decode_flops": math.fsum(m.decode_flops(s, p) for p in POSITIONS),
        "decode_attention_bytes": math.fsum(
            m.decode_attention_bytes(s, p) for p in POSITIONS),
        "burst_bytes": m.burst_bytes(s, [(p, 8) for p in POSITIONS]),
    }
    assert got == COUNTS[name]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_a_configuration_without_arch_is_mistral(name):
    cfg = config(name)
    assert "arch" not in cfg
    assert arch.for_config(cfg) is mistral
    assert stack.model_config(cfg) == get_config(cfg["preset"], **FIELDS[name])


def test_an_unknown_arch_names_the_file_it_looked_for():
    assert arch.load("mistral") is mistral
    for name in ("no_such_model", "__init__"):
        with pytest.raises(ValueError) as e:
            arch.for_config({"arch": name})
        assert str(HERE / "arch" / f"{name}.py") in str(e.value)


def _harness_files():
    return [f for f in sorted(HERE.rglob("*.py"))
            if f.relative_to(HERE).parts[0] not in ("arch", "tests")]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_only_arch_modules_name_an_architecture():
    files = _harness_files()
    assert HERE / "run.py" in files and HERE / "measures.py" in files
    for f in files:
        tree = ast.parse(f.read_text())
        for name in _imports(tree):
            assert not name.startswith("benchmark.arch."), (f, name)
        for node in ast.walk(tree):
            words = []
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                words.append(node.value)
            elif isinstance(node, ast.Name):
                words.append(node.id)
            elif isinstance(node, ast.Attribute):
                words.append(node.attr)
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.arg,
                                   ast.keyword)):
                words.append(getattr(node, "name", None)
                             or getattr(node, "arg", None) or "")
            for w in words:
                assert not ARCH_NAMES.search(w), (f, w)
                assert "benchmark.arch." not in w, (f, w)
        assert not ARCH_NAMES.search(f.read_text()), f  # comments too


def test_arch_modules_import_nothing_of_the_port():
    mods = [f for f in sorted((HERE / "arch").glob("*.py"))
            if not f.name.startswith("_")]
    assert HERE / "arch" / "mistral.py" in mods
    for f in mods:
        top = {n.split(".")[0] for n in _imports(ast.parse(f.read_text()))}
        assert top <= {"__future__", "math", "dataclasses", "typing",
                       "torch", "benchmark"}, f
