"""`repro_torch.launch.dryrun` at train_4k on the single-pod mesh (256 fake
ranks, meta tensors, one subprocess) for the four archs whose mixers are
MLA, Mamba-2 or cross-attention: every mixer computes on its tensor
rank's heads, so a device computes at most 2.5x the ideal ``6 * N_active *
tokens / n_chips`` (3x for mamba2-370m, whose single group's B and C
columns run on every rank and whose SSD chunk products lie beyond 6N) and
holds under 80 GB by the artifact's accounting; the artifact names the
active-param divisor and the MoE's balanced slots among its analytic
measures."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
#: arch -> the most ``flops_per_6NT`` (over the active params) it may show
BOUNDS = {"deepseek-v2-lite-16b": 2.5, "jamba-v0.1-52b": 2.5,
          "mamba2-370m": 3.0, "musicgen-medium": 2.5}
FIT_BYTES = 80e9


@pytest.fixture(scope="module")
def artifacts():
    code = ("import json\n"
            "from repro_torch.launch import dryrun\n"
            f"for arch in {list(BOUNDS)!r}:\n"
            "    art = dryrun.lower_and_compile(arch, 'train_4k', 'single',\n"
            "                                   verbose=False)\n"
            "    print(json.dumps(art), flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    arts = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    return {a["arch"]: a for a in arts}


@pytest.mark.parametrize("arch", list(BOUNDS))
def test_mixer_archs_train_fits_a_card(artifacts, arch):
    art = artifacts[arch]
    mem, cost = art["memory_analysis"], art["cost_analysis"]
    assert cost["flops_per_6NT"] <= BOUNDS[arch], cost
    assert mem["held_bytes"] < FIT_BYTES, mem
    assert mem["held_bytes"] == sum(mem[k] for k in (
        "param_bytes", "grad_bytes", "opt_state_bytes",
        "gathered_param_bytes", "saved_bytes"))


@pytest.mark.parametrize("arch", list(BOUNDS))
def test_flops_are_over_the_active_params(artifacts, arch):
    """The ideal's N is the active param count (the MoE archs' top-k and
    shared experts; every param of a dense one)."""
    art = artifacts[arch]
    n = art["active_param_count"]
    tokens = art["global_batch"] * art["seq_len"]
    cost = art["cost_analysis"]
    assert cost["flops_per_6NT"] == pytest.approx(
        cost["flops"] / (6 * n * tokens / art["n_chips"]), rel=1e-12)
    assert {"active_param_count", "moe_balanced_slots"} <= set(
        art["analytic"])
    if arch in ("deepseek-v2-lite-16b", "jamba-v0.1-52b"):
        assert n < art["param_count"]
    else:
        assert n == art["param_count"]
