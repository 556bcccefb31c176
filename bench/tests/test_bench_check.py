"""The check of outputs on the CPU, through the whole harness at toy widths:
a sound run is correct, and each fault a served cell can have is caught.

Faults, planted under the program's timed path: a sampled token altered
where it is produced; a decode step that leaves the KV cache as it was (a
step that returns its state unchanged); half of a batch's rows given the
other half's tokens (half of the batch left out). A one-card cell has no
exchange between cards to leave out."""
import pytest
import torch

import tiny  # noqa: F401  (sys.path)
from harness.report import run_cell
from repro_torch.models import attention
from repro_torch.serving import backend

CELLS = [("chatglm3-6b", "backlog"), ("granite-moe-3b-a800m", "backlog"),
         ("chatglm3-6b", "poisson"), ("granite-moe-3b-a800m", "longdoc")]
SEED = 2 ** 31 + 77


def _run(config, traffic, control=None, seconds=1.0, **mix):
    cell = tiny.tiny_cell(config, traffic, **mix)
    torch.manual_seed(0)
    return run_cell(cell, SEED, seconds, False, device="cpu",
                    control=control)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_sound_run_is_correct(config, traffic):
    line = _run(config, traffic)
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check"
    assert line["check"]["gap_mean"]["value"] == 0.0


@pytest.mark.parametrize("config", ["chatglm3-6b", "granite-moe-3b-a800m"])
def test_int8_control_reads_above_a_sound_run(config):
    # the program's int8 weight path in place of float32 (its readings at
    # the cells' sizes are tests/test_bench_control.py's, on the card)
    # a batch of 16 new tokens takes some seconds of int8 steps on a busy
    # CPU: the window lasts until one has finished
    line = _run(config, "backlog", control="int8", seconds=6.0, samples=8,
                new_tokens=16)
    for name, c in line["check"].items():
        assert c["value"] > 0.0, name


def _altered(sample):
    def f(logits, temperature, noise, sampled=None):
        tok, lp = sample(logits, temperature, noise, sampled)
        return (tok + 1) % 200, lp
    return f


def _half(sample):
    def f(logits, temperature, noise, sampled=None):
        tok, lp = sample(logits, temperature, noise, sampled)
        h = tok.shape[0] // 2
        tok = tok.clone()
        tok[h:2 * h] = tok[:h]
        return tok, lp
    return f


def _stale(fill):
    def f(cache, k, v, pos1d, block_table):
        if pos1d.shape[1] == 1:          # a decode step writes nothing
            return cache
        return fill(cache, k, v, pos1d, block_table)
    return f


FAULTS = {"token_altered": (backend, "sample_tokens", _altered),
          "half_batch": (backend, "sample_tokens", _half),
          "state_unchanged": (attention, "_fill_cache_paged", _stale)}


@pytest.mark.parametrize("config,traffic", CELLS[:2])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, config, traffic, fault):
    mod, name, wrap = FAULTS[fault]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    line = _run(config, traffic)
    assert line["correct"] is False
    assert line["check"]["gap_mean"]["value"] > 1e-3
