"""What a new architecture brings as files alone: a reference module that
its configuration file names, loaded by path, and a ``port`` group whose
nested groups become the program's dataclasses; and that a toy MLA port
goes through the harness's pieces."""
import dataclasses
import json

import pytest

import tiny
from harness import check, work
from harness.report import run_cell
from harness.runner import arch_config
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.paper_models import PAPER_MODELS

STUB = '''"""A stand-in reference: every judged token at a gap of a quarter."""
from types import SimpleNamespace


def spec_of(config):
    if config["model_type"] != "toy-arch":
        raise ValueError(config["model_type"])
    return SimpleNamespace(experts=0)


def judge(spec, weights, prompts, rows_of, toks, rows, temperature, draw):
    n, k = toks.shape[1], len(rows)
    assert rows_of.shape[0] == toks.shape[0] == draw(0).shape[0]
    return {"gap_max": [0.5] * k, "gap_sum": [0.25 * n] * k,
            "misses": [n] * k, "tokens": n, "mean_logprob": [0.0] * k}
'''

#: a toy port of latent attention and shared experts after a dense layer
TOY_MLA = {"name": "toy-mla", "arch_type": "moe", "n_layers": 3,
           "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 96,
           "vocab_size": 256,
           "mla": {"kv_lora_rank": 32, "q_lora_rank": None,
                   "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                   "v_head_dim": 16},
           "moe": {"n_experts": 8, "top_k": 2, "n_shared": 1,
                   "d_expert": 24, "moe_period": 1, "first_dense": 1},
           "mrope_sections": [], "layer_pattern": None}


def test_a_configuration_without_reference_names_itself_and_the_path():
    with pytest.raises(LookupError) as e:
        check.reference({"name": "toy", "model_type": "toy-arch"})
    assert "'toy'" in str(e.value) and str(check.REFERENCE) in str(e.value)


def test_a_missing_reference_file_names_its_path(tmp_path, monkeypatch):
    monkeypatch.setattr(check, "REFERENCE", tmp_path)
    with pytest.raises(FileNotFoundError) as e:
        check.reference({"name": "toy", "reference": "absent"})
    assert "'toy'" in str(e.value) and str(tmp_path / "absent.py") in \
        str(e.value)


@pytest.mark.parametrize("config", [c["name"] for c in
                                    tiny.BENCHMARK["configs"]])
def test_each_configuration_names_a_reference_that_reads_it(config):
    c = tiny.tiny_config(config)
    assert check.reference(c).spec_of(c).experts >= 0


def test_a_stub_reference_judges_an_unknown_architecture(tmp_path,
                                                         monkeypatch):
    (tmp_path / "stub.py").write_text(STUB)
    monkeypatch.setattr(check, "REFERENCE", tmp_path)
    cell = tiny.tiny_cell("chatglm3-6b", "backlog")
    cell = dataclasses.replace(cell, config=dict(
        cell.config, model_type="toy-arch", reference="stub"))
    line = run_cell(cell, 2 ** 31 + 5, 1.0, False, device="cpu")
    assert line["check"]["gap_mean"]["value"] == 0.25
    assert line["correct"] is False


def test_a_controlled_configuration_without_a_backlog_cell_gets_its_cases(
        tmp_path):
    # the control runs in each controlled configuration's first cell, on
    # the CPU and on the card, whatever that cell's traffic
    import test_bench_control
    (tmp_path / "a.json").write_text(json.dumps({"control": "int8"}))
    (tmp_path / "b.json").write_text(json.dumps({}))
    bench = {"configs": [{"name": "a", "file": "a.json"},
                         {"name": "b", "file": "b.json"}],
             "workloads": [{"config": "b", "traffic": "backlog"},
                           {"config": "a", "traffic": "longdoc"},
                           {"config": "a", "traffic": "short"}]}
    assert tiny.first_cells(bench) == [("b", "backlog"), ("a", "longdoc")]
    assert tiny.control_cells(bench, tmp_path) == [("a", "longdoc")]
    # and the benchmark's own lists come from the same rule
    assert tiny.CONTROL_CELLS == tiny.control_cells(tiny.BENCHMARK)
    assert test_bench_control.CELLS == [f"{c}.{t}"
                                        for c, t in tiny.CONTROL_CELLS]


@pytest.mark.parametrize("name", ASSIGNED_ARCHS + list(PAPER_MODELS))
def test_arch_config_rebuilds_every_config(name):
    cfg = get_config(name)
    assert arch_config(dataclasses.asdict(cfg)) == cfg
    # as a configuration file holds it: tuples as lists
    as_json = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert arch_config(as_json) == cfg


def test_arch_config_refuses_an_unknown_key():
    with pytest.raises(ValueError, match="rope_base"):
        arch_config(dict(TOY_MLA, rope_base=1.0))
    with pytest.raises(ValueError, match="shared"):
        arch_config(dict(TOY_MLA, moe=dict(TOY_MLA["moe"], shared=1)))


def test_a_toy_mla_port_goes_through_arch_config_and_widths():
    from repro_torch.models.config import MLAConfig, MoEConfig
    cfg = arch_config(TOY_MLA)
    assert cfg.mla == MLAConfig(32, None, 16, 8, 16)
    assert cfg.moe == MoEConfig(8, 2, 1, 24, 1, 1)
    assert cfg.mrope_sections == ()
    w = work.Widths.of(TOY_MLA)
    assert w.moe_layers == sum(cfg.is_moe_layer(i) for i in range(3)) == 2
    assert w.dense_layers == 1
    # q 64 x 4 x 24, kv_a 64 x 40, kv_b 32 x 4 x 32, o 4 x 16 x 64
    attn = 6144 + 2560 + 4096 + 4096
    assert work.attn_params_per_token(w) == attn
    assert work.stack_params_per_token(w) == 3 * attn \
        + 2 * (64 * 8 + 3 * 3 * 64 * 24) + 3 * 64 * 96
