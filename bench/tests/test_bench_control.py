"""On the card: the control of the check is refused (``correct`` false) at
the cell's own size on three seeds, and a sound run of the same cell is
not. The control is the configuration file's ``control``, ``int8``: the
program's own int8 weight path served in place of bf16. Run on a machine
with a card, from the root of a checkout:

    python -m pytest -q -m gpu bench/tests/test_bench_control.py
"""
import json
import subprocess
import sys

import pytest
import torch

import tiny

#: the first cell of each configuration that names a control
CELLS = [f"{c}.{t}" for c, t in tiny.CONTROL_CELLS]


def _run(cell, seed, *extra):
    out = subprocess.run(
        [sys.executable, str(tiny.BENCH / "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", "10", "--trace", "0", *extra],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness.spec import load_cell
    control = load_cell(cell).config["control"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        line = _run(cell, seed, "--control", control)
        assert line["correct"] is False, line["check"]
    assert _run(cell, 2 ** 31 + 104)["correct"] is True
