"""Whether the timed path's outputs are right: served tokens against the
plain reference.

After the window closes and the program's state is freed, ``check_batches``
batches that finished are drawn from the seed. Each is recomputed by the
reference's ``judge`` from its prompts and the program's served tokens
(teacher forcing), with the same Gumbel draws the program was handed, and
every judged token's gap is read: how far the served token's score lies
below the reference's best. A batch whose rows share their forwards' result
(an MoE's expert capacity drops tokens by who else is in the forward) is
judged over all of its rows; any other batch over the rows of one of its
requests, drawn from the seed.

The reference is the module ``reference/<module>.py`` that the configuration
file names with ``"reference": "<module>"``, loaded by path. Its contract:

* ``spec_of(config)`` takes the configuration file's dict and returns an
  object with ``experts``, non-zero where the rows that share a forward
  change the result;
* ``judge(spec, weights, prompts, rows_of, toks, rows, temperature, draw)``
  takes the benchmark's weights, the batch's prompts (R, L), each row's
  prompt (B,), the served tokens (B, N), the rows to judge, the temperature
  and ``draw(j)``, the batch's Gumbel draw for token j, and returns, a list
  over the judged rows under each key, ``gap_max``, ``gap_sum``,
  ``misses`` and ``mean_logprob``, and ``tokens``, the tokens a row;
* it imports nothing of the program.

The numbers, each over the judged rows; ``COMPARED`` names those held to
their limits in ``limits/<cell>.json``, the rest are printed beside them:

* ``gap_mean``: the gaps' mean over every judged token. A token whose score
  the program rounds past a near tie gets a small gap, so the mean grows
  with both how often and how far the served scores stray.
* ``gap_max``: the widest gap, a maximum over thousands of near ties.
* ``miss_rate``: the share of judged tokens the reference would not have
  chosen.
* ``row_gap_med``: the median over rows of a row's mean gap.
* ``lp_err_max``, ``lp_err_med``, ``lp_err_rms``, ``lp_bias``: of each row,
  the difference between its mean log-probability as the program reports
  it and as the reference computes it; its largest and median size, its
  root mean square and its mean.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, List

import numpy as np
import torch

from harness.spec import BENCH, load_module

COMPARED = ("gap_mean",)
#: where the reference modules live
REFERENCE = BENCH / "reference"


def reference(config: Dict[str, Any]) -> ModuleType:
    """The reference module that the configuration names, loaded from
    `REFERENCE`."""
    name = config.get("reference")
    if not name:
        raise LookupError(
            f"configuration {config.get('name')!r} names no reference: its "
            f"file needs \"reference\": \"<module>\" for "
            f"{REFERENCE}/<module>.py")
    path = REFERENCE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config.get('name')!r}: its reference {path} "
            f"does not exist")
    return load_module(path, "bench_reference_" + name.replace(".", "_"))


def check(runner, run) -> Dict[str, Any]:
    """The check's numbers (module docstring), or ``error``."""
    cell, mix = run.cell, run.cell.traffic
    ref = reference(cell.config)
    spec = ref.spec_of(cell.config)
    rng = np.random.default_rng(np.random.SeedSequence([run.seed, 9]))
    batches = []
    for bid, src in sorted(run.book.batches.items()):
        idx = [run.request_of[sid] for sid, _ in src.requests]
        if all(i in run.results for i in idx):
            batches.append((bid, idx, [n for _, n in src.requests]))
    out: Dict[str, Any] = {"batches": [], "tokens": 0, "misses": 0}
    if not batches:
        out["error"] = "no batch finished"
        return out
    pick = rng.choice(len(batches), size=min(mix["check_batches"],
                                             len(batches)), replace=False)
    dev = runner.device
    rows_all: Dict[str, List[np.ndarray]] = {"gap_max": [], "gap_sum": [],
                                              "misses": [], "lp_err": []}
    for p in sorted(int(x) for x in pick):
        bid, idx, ns = batches[p]
        src = run.book.batches[bid]
        B = sum(ns)
        N = mix["new_tokens"]
        rows_of = np.repeat(np.arange(len(idx)), ns)
        toks = np.stack([s for i in idx for s in run.results[i].samples])
        if toks.shape != (B, N) or len(src.shapes) != N or \
                any(sh[0] != B for sh in src.shapes):
            out["error"] = (f"batch {bid}: tokens {toks.shape}, "
                            f"{len(src.shapes)} noise draws")
            return out
        if spec.experts:
            rows = np.arange(B)
        else:
            r = int(rng.integers(len(idx)))
            rows = np.nonzero(rows_of == r)[0]
        prompts = torch.as_tensor(np.stack([run.prompts[i] for i in idx]),
                                  device=dev)
        res = ref.judge(spec, runner.weights, prompts,
                        torch.as_tensor(rows_of, device=dev),
                        torch.as_tensor(toks, device=dev),
                        torch.as_tensor(rows, device=dev),
                        mix["temperature"], src.draw)
        reported = np.asarray([lp for i in idx
                               for lp in run.results[i].logprobs])[rows]
        rows_all["lp_err"].append(reported
                                  - np.asarray(res["mean_logprob"]))
        for k in ("gap_max", "gap_sum", "misses"):
            rows_all[k].append(np.asarray(res[k], dtype=np.float64))
        out["tokens"] += len(rows) * res["tokens"]
        out["batches"].append(bid)
    r = {k: np.concatenate(v) for k, v in rows_all.items()}
    n = out["tokens"] / len(r["gap_sum"])           # tokens a row
    lp = r["lp_err"]
    out.update(
        misses=int(r["misses"].sum()),
        gap_max=float(r["gap_max"].max()),
        gap_mean=float(r["gap_sum"].sum() / out["tokens"]),
        miss_rate=float(r["misses"].sum() / out["tokens"]),
        row_gap_med=float(np.median(r["gap_sum"] / n)),
        lp_err_max=float(np.abs(lp).max()),
        lp_err_med=float(np.median(np.abs(lp))),
        lp_err_rms=float(np.sqrt(np.mean(lp ** 2))),
        lp_bias=float(lp.mean()))
    return out


def verdict(result: Dict[str, Any], limits: Dict[str, float]):
    """(correct, {number: (value, limit)}) of a check's result."""
    shown = {}
    ok = "error" not in result
    for name in COMPARED:
        value, limit = result.get(name), limits.get(name)
        shown[name] = (value, limit)
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, shown
