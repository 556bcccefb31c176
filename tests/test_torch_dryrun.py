"""`repro_torch.launch.dryrun` on the CPU: chatglm3-6b at full width at
all four shapes on the single-pod mesh (256 fake ranks) and at decode_32k
on the multi-pod mesh (512), traced on meta tensors in a subprocess. The
artifacts carry every key of the reference's (``src/repro/launch/
dryrun.py``'s artifact dict) and the ``analytic`` list; decode flops equal
the closed form of chatglm's matmuls and attention over the cache, split
over the tensor axis; train steps issue collectives; the per-device param
and gradient bytes are the sum of the policy's shards, and the gathered
bytes a block's worth; a failing pair writes an ``error`` artifact; nothing
is written under the reference's ``experiments/dryrun/``; qwen2-72b's
train step fits a card at full width."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import MeshShape, ShardingPolicy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import param_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "chatglm3-6b"
PAIRS = [(s, "single") for s in INPUT_SHAPES] + [("decode_32k", "multi")]
#: the keys of the reference's artifact (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "param_count",
            "active_param_count", "seq_len", "global_batch", "attn_window",
            "fsdp", "shard_hints", "mla_naive", "ssm_split", "no_tp",
            "microbatches", "cache_fp8", "cross_cache", "moe_dense",
            "memory_analysis", "cost_analysis", "collective_bytes",
            "hlo_bytes", "lower_s", "compile_s"}
MESHES = {"single": MeshShape(("data", "model"), (16, 16)),
          "multi": MeshShape(("pod", "data", "model"), (2, 16, 16))}


def _ref_dir_listing():
    d = ROOT / "experiments" / "dryrun"
    return sorted(os.listdir(d)) if d.is_dir() else None


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    before = _ref_dir_listing()
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"out = {str(out)!r}\n"
            f"for shape, mesh in {PAIRS!r}:\n"
            f"    dryrun.run_one({ARCH!r}, shape, mesh, out_dir=out)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert _ref_dir_listing() == before
    return {(a["shape"], a["mesh"]): a for a in
            (json.loads(p.read_text()) for p in sorted(out.glob("*.json")))}


@pytest.mark.parametrize("shape,mesh", PAIRS)
def test_artifact_keys_and_counts(artifacts, shape, mesh):
    art = artifacts[(shape, mesh)]
    assert "error" not in art, art.get("traceback")
    assert REF_KEYS <= set(art)
    assert set(art["analytic"]) == {"memory_analysis", "cost_analysis",
                                    "collective_bytes", "grad_bytes",
                                    "gathered_param_bytes", "saved_bytes",
                                    "held_bytes", "flops_per_6NT",
                                    "active_param_count",
                                    "moe_balanced_slots"}
    assert art["n_chips"] == (512 if mesh == "multi" else 256)
    assert art["cost_analysis"]["flops"] > 0
    assert art["cost_analysis"]["bytes accessed"] > 0
    assert set(art["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total", "n_ops"}
    if INPUT_SHAPES[shape].kind == "train":
        assert art["collective_bytes"]["reduce-scatter"] > 0
        assert art["collective_bytes"]["all-gather"] > 0
        assert art["memory_analysis"]["opt_state_bytes"] > 0
    else:
        assert art["memory_analysis"]["cache_bytes"] > 0
    if shape == "long_500k":
        assert art["attn_window"] == 4096


@pytest.mark.parametrize("shape,mesh", PAIRS)
def test_param_bytes_are_the_sum_of_the_shards(artifacts, shape, mesh):
    pol = ShardingPolicy(MESHES[mesh])
    model = Model(get_config(ARCH), device="meta")
    want = 0
    for path, t in flatten(param_specs(model)):
        n = t.element_size()
        for d, ax in zip(t.shape, pol.param_spec(path, t)):
            n *= d // (pol._size(ax) if ax is not None else 1)
        want += n
    mem = artifacts[(shape, mesh)]["memory_analysis"]
    assert mem["param_bytes"] == want
    # gathered a block at a time: alive at once, less than a tensor rank's
    # share of the whole model
    assert 0 < 16 * mem["gathered_param_bytes"] < 2 * model.param_count()
    if INPUT_SHAPES[shape].kind == "train":
        assert mem["grad_bytes"] == want         # the gradient's shards


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_flops_equal_the_closed_form(artifacts, mesh):
    """Per device: 2 x rows x (every matmul weight) + 4 x rows x heads x
    head dim x cache slots x layers (scores and values over the cache),
    split over the 16-wide tensor axis (every product computes on its
    shard: heads' head-dim chunks, the MLP's hidden dim, the
    vocabulary)."""
    cfg = get_config(ARCH)
    sh = INPUT_SHAPES["decode_32k"]
    rows = sh.global_batch // (32 if mesh == "multi" else 16)
    d, hd = cfg.d_model, cfg.hd
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd +
                 cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    weights = cfg.n_layers * per_layer + d * cfg.padded_vocab
    attn = 4 * rows * cfg.n_heads * hd * sh.seq_len * cfg.n_layers
    assert artifacts[("decode_32k", mesh)]["cost_analysis"]["flops"] == \
        (2 * rows * weights + attn) / 16


def test_a_failing_pair_writes_an_error_artifact(tmp_path):
    art = dryrun.run_one("no-such-arch", "decode_32k", "single",
                         out_dir=str(tmp_path), verbose=False)
    assert "error" in art and "traceback" in art
    saved = json.loads((tmp_path / "no-such-arch__decode_32k__single.json")
                       .read_text())
    assert saved["error"] == art["error"]


def test_artifacts_default_to_their_own_folder():
    assert Path(dryrun.ARTIFACT_DIR).resolve() == (
        ROOT / "experiments" / "dryrun_torch").resolve()


def test_trace_store_ingests_an_artifact(artifacts, tmp_path):
    """``--trace``: each artifact's flops and bytes become a ``dryrun``
    record of the telemetry trace."""
    from repro_torch.qeil2.telemetry import TraceStore
    store = TraceStore(path=str(tmp_path / "t.jsonl"))
    art = artifacts[("train_4k", "single")]
    rec = store.ingest_dryrun_artifact(art)
    assert rec["kind"] == "dryrun" and rec["n_chips"] == 256
    assert rec["flops"] == art["cost_analysis"]["flops"]
    assert rec["bytes_accessed"] == art["cost_analysis"]["bytes accessed"]


def test_qwen2_72b_train_fits_a_card():
    """qwen2-72b at train_4k on the single-pod mesh, full width on meta
    tensors: a device computes at most 2x the ideal ``6 * N * tokens /
    n_chips`` (every tensor rank its share, remat's recompute included) and
    holds under 80 GB by the artifact's accounting (param, gradient and
    moment shards, the gathered block, the bytes saved for backward)."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "art = dryrun.lower_and_compile('qwen2-72b', 'train_4k', "
            "'single', verbose=False)\n"
            "print(json.dumps(art))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    art = json.loads(res.stdout.strip().splitlines()[-1])
    mem = art["memory_analysis"]
    assert art["cost_analysis"]["flops_per_6NT"] <= 2.0, art["cost_analysis"]
    assert mem["held_bytes"] < 80e9, mem
    assert mem["held_bytes"] == sum(mem[k] for k in (
        "param_bytes", "grad_bytes", "opt_state_bytes",
        "gathered_param_bytes", "saved_bytes"))
    # the blocks' inputs under remat are d_model shards: 80 layers x 16
    # rows x 4096 tokens x 8192 / 16 x 2 bytes, and more
    assert mem["saved_bytes"] >= 80 * 16 * 4096 * 512 * 2
