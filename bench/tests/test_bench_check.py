"""The check of outputs on the CPU, through the whole harness at toy widths:
a sound run of each cell of BENCHMARK.json is correct, and in each
configuration's first cell each fault a served cell can have is caught.

Faults, planted under the program's timed path: a sampled token altered
where it is produced; a decode step that leaves the whole cache as it was,
whatever the architecture keeps there (a step that returns its state
unchanged); half of a batch's rows given the other half's tokens (half of
the batch left out). A one-card cell has no exchange between cards to leave
out."""
import pytest
import torch

import tiny
from harness.report import run_cell
from repro_torch.serving import backend

SEED = 2 ** 31 + 77


def _run(config, traffic, control=None, seconds=1.0, **mix):
    cell = tiny.tiny_cell(config, traffic, **mix)
    torch.manual_seed(0)
    return run_cell(cell, SEED, seconds, False, device="cpu",
                    control=control)


@pytest.mark.parametrize("config,traffic", tiny.CELLS)
def test_sound_run_is_correct(config, traffic):
    line = _run(config, traffic)
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check"
    assert line["check"]["gap_mean"]["value"] == 0.0


@pytest.mark.parametrize("config,traffic", tiny.CONTROL_CELLS,
                         ids=[c for c, _ in tiny.CONTROL_CELLS])
def test_int8_control_reads_above_a_sound_run(config, traffic):
    # the configuration's control (int8: the program's int8 weight path in
    # place of float32; its readings at the cells' sizes are
    # tests/test_bench_control.py's, on the card), in its first cell
    # a batch of 16 new tokens takes some seconds of int8 steps on a busy
    # CPU: the window lasts until one has finished
    control = tiny.tiny_config(config)["control"]
    line = _run(config, traffic, control=control, seconds=6.0, samples=8,
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


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    return [t for x in items for t in _tensors(x)]


def _stale(decode_fn):
    # every decode step puts back the whole cache as it found it, whatever
    # its entries (K/V, a latent, a state): a step that writes nothing
    def f(self, h, inputs):
        step, cache = decode_fn(self, h, inputs), self._cache(h)

        def g(*args):
            kept = [t.clone() for t in _tensors(cache)]
            out = step(*args)
            for t, k in zip(_tensors(cache), kept):
                t.copy_(k)
            return out
        return g
    return f


FAULTS = {"token_altered": (backend, "sample_tokens", _altered),
          "half_batch": (backend, "sample_tokens", _half),
          "state_unchanged": (backend.ExecutionBackend, "_decode_fn",
                              _stale)}


@pytest.mark.parametrize("config,traffic", tiny.FIRST_CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, config, traffic, fault):
    mod, name, wrap = FAULTS[fault]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    line = _run(config, traffic)
    assert line["correct"] is False
    assert line["check"]["gap_mean"]["value"] > 1e-3
