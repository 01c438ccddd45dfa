"""Whether what the timed path served is right.

After the window has closed, a sample drawn from ``--seed`` of the
requests the window finished, the longest among them always, is run
through the plain reference of the configuration's architecture
(``benchmark/arch/<name>.py`` ``logits_at``) over each prompt and
the tokens served for it.  The number compared is the widest gap by which a
served token's logit lies below the reference's best logit at its
position: a greedy server at the configuration's precision keeps it near
the reference's own near-ties; a wrong token, a lost layer or a wrong cache
entry opens it wide.

Beside it the mean gap over the compared tokens, which a lone near-tie
(an expert chosen otherwise by one rounding) moves little and a lower
precision everywhere moves much.

The control is the reference itself computed with float8 operands, one
precision below the configuration's bfloat16.  With ``control`` the tokens
judged are the ones the float8 forward ranks first at the same positions of
the same prompts and served tokens, in place of the served ones, and go
through the same limits: the control's run comes out as not correct.
"""

from __future__ import annotations

import math
import random
import sys
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.client import ok


def sample(recs: Sequence[Dict], seed: int, tokens: int) -> List[Dict]:
    """The longest of ``recs`` (prompt plus answer), then others drawn from
    ``seed`` until the sample holds at least ``tokens`` served tokens."""
    if not recs:
        return []
    pool = sorted(recs, key=lambda r: (len(r["prompt"]) + len(r["ids"]),
                                       r["c"], r["s"], r["turn"]))
    chosen = [pool.pop()]
    rng = random.Random(f"{seed}:sample")
    rng.shuffle(pool)
    while pool and sum(len(r["ids"]) for r in chosen) < tokens:
        chosen.append(pool.pop())
    return chosen


def _inputs(recs: Sequence[Dict], device):
    seqs, want, served = [], [], []
    for r in recs:
        ids = list(r["prompt"]) + list(r["ids"][:-1])
        p = len(r["prompt"])
        seqs.append(torch.tensor(ids, dtype=torch.long, device=device))
        want.append((p - 1, p - 1 + len(r["ids"])))
        served.append(torch.tensor(r["ids"], dtype=torch.long, device=device))
    return seqs, want, served


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the best."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None])[:, 0]


def served_gaps(model, shape, params: Dict, recs: Sequence[Dict], device,
                control: bool = False) -> Dict[str, float]:
    """The widest gap of the tokens judged (``logit_gap``), the mean gap
    over them (``logit_gap_mean``), the number of tokens compared and how
    many the reference would have ranked otherwise.  The tokens judged are
    the ones served for ``recs``, or with ``control`` the ones the float8
    forward ranks first at the same positions; then the served tokens'
    two gaps are kept beside them (``served_gap``, ``served_gap_mean``).
    ``model`` is the configuration's architecture module, whose
    ``logits_at`` is the reference."""
    logits_at = model.logits_at
    seqs, want, served = _inputs(recs, device)
    ref = logits_at(shape, params, seqs, want)
    gaps = torch.cat([_gap(r, s) for r, s in zip(ref, served)])
    out = {}
    if control:
        out["served_gap"] = float(gaps.max())
        out["served_gap_mean"] = float(gaps.mean())
        low = logits_at(shape, params, seqs, want, precision="fp8")
        gaps = torch.cat([_gap(r, lo.argmax(-1)) for r, lo in zip(ref, low)])
    out.update({"tokens": float(gaps.numel()), "logit_gap": float(gaps.max()),
                "logit_gap_mean": float(gaps.mean()),
                "argmax_differs": float((gaps > 0).sum())})
    return out


def judge(cfg: Dict, model, shape, params: Dict, recs: Sequence[Dict],
          sent: Sequence[Dict], seed: int, device, control: bool,
          unchanged: bool) -> Tuple[bool, Dict, Dict]:
    """``correct``, each number compared with its limit, and the readings:
    every number the configuration's ``check.limits`` names, read on a
    sample of the window's finished requests (a number not read fails);
    every request of the run finished whole; the weights unwritten."""
    picked = sample([r for r in sent if ok(r)], seed,
                    int(cfg["check"]["tokens"]))
    readings = (served_gaps(model, shape, params, picked, device, control)
                if picked else {"tokens": 0.0})
    readings["sampled_requests"] = len(picked)
    failed = [r for r in recs if not ok(r)]
    for r in failed[:20]:
        print("[failed request]", {k: r.get(k) for k in (
            "c", "s", "turn", "status", "finish", "error", "max")},
            len(r["ids"]), len(r["prompt"]), file=sys.stderr)
    checks = {name: (readings.get(name, math.inf), float(limit))
              for name, limit in sorted(cfg["check"]["limits"].items())}
    checks["failed_requests"] = (float(len(failed)), 0.0)
    checks["weights_changed"] = (0.0 if unchanged else 1.0, 0.0)
    correct = (readings["tokens"] > 0
               and all(v <= lim for v, lim in checks.values()))
    return correct, checks, readings
