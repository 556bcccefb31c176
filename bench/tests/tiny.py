"""Small cells for the CPU tests: the real harness, each configuration at
the toy widths of its file's ``tiny`` group, and short mixes; and the cases
that the tests run over, read from BENCHMARK.json."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell, load_cell  # noqa: E402


def _json(path):
    with open(path) as f:
        return json.load(f)


def first_cells(bench: dict) -> list:
    """Each configuration's first cell of ``bench``, as (configuration,
    traffic)."""
    cells = {}
    for w in bench["workloads"]:
        cells.setdefault(w["config"], w["traffic"])
    return list(cells.items())


def control_cells(bench: dict, root: Path = ROOT) -> list:
    """The first cell of each configuration whose file names a ``control``,
    whatever its traffic: its control runs there."""
    files = {c["name"]: c["file"] for c in bench["configs"]}
    return [(c, t) for c, t in first_cells(bench)
            if _json(root / files[c]).get("control")]


BENCHMARK = _json(ROOT / "BENCHMARK.json")
#: every cell of BENCHMARK.json, as (configuration, traffic)
CELLS = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
FIRST_CELLS = first_cells(BENCHMARK)
CONTROL_CELLS = control_cells(BENCHMARK)


def merged(base: dict, over: dict) -> dict:
    """``over`` deep-merged over ``base``: groups merged key by key, any
    other value replaced."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def tiny_config(name: str) -> dict:
    """A configuration file's dict at toy widths: its ``tiny`` group (the
    cut of the published, ``assumed``, ``departures`` and ``port`` keys)
    deep-merged over it."""
    files = {c["name"]: c["file"] for c in BENCHMARK["configs"]}
    c = _json(ROOT / files[name])
    return merged(c, c.pop("tiny"))


def tiny_cell(config: str, traffic: str, **mix) -> Cell:
    """The cell ``config.traffic`` of BENCHMARK.json at toy sizes: the
    configuration's widths cut, the mix shortened (``mix`` overrides)."""
    real = load_cell(f"{config}.{traffic}")
    t = dict(real.traffic, prompt_tokens=12, new_tokens=6, samples=3,
             outstanding=4, stagger_steps=3, max_batch_requests=2,
             kv_block_size=4, check_batches=2)
    if t["loop"] == "open":
        t.update(rate_per_s=20.0, warm_s=0.2, warm_batch_sizes=[1, 2])
    else:
        t.update(warm_batch_sizes=[2])
    t.update(mix)
    return Cell(real.name, real.config_name, real.traffic_name, 1,
                tiny_config(config), t, {"gap_mean": 1e-6},
                real.end_to_end, real.per_layer)
