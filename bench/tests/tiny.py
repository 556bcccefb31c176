"""Small cells for the CPU tests: the real harness, configurations of the
two architectures at toy widths, and short mixes."""
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


def tiny_config(name: str) -> dict:
    """A configuration file's dict at toy widths, published and port keys
    cut alike."""
    c = copy.deepcopy(_json(BENCH / "configs" / f"{name}.json"))
    p = c["port"]
    if c["model_type"] == "chatglm":
        c.update(num_layers=2, hidden_size=64, num_attention_heads=4,
                 multi_query_group_num=2, kv_channels=16,
                 ffn_hidden_size=96, padded_vocab_size=256)
        c["assumed"]["rotary_dim"] = 8
        p.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                 vocab_size=256)
    else:
        c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=2, intermediate_size=32,
                 num_local_experts=8, num_experts_per_tok=2, vocab_size=250)
        c["departures"]["attention_multiplier"] = 0.25
        p.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
                 vocab_size=250)
        p["moe"] = dict(p["moe"], n_experts=8, top_k=2, d_expert=32)
    return c


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
