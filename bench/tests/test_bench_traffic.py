"""The traffic generator: the same seed gives the same requests, and every
seed the same work in another order."""
import numpy as np

import tiny  # noqa: F401  (sys.path)
from harness import traffic
from harness.spec import load_cell

SEED = 2 ** 31 + 11


def test_open_loop_same_seed_same_requests():
    mix = load_cell("chatglm3-6b.poisson").traffic
    a = traffic.open_loop(mix, SEED, 50.0, 65024)
    b = traffic.open_loop(mix, SEED, 50.0, 65024)
    assert [(r.tier, r.due_s) for r in a] == [(r.tier, r.due_s) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert all(len(r.prompt) == mix["prompt_tokens"] for r in a)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 65024 for r in a)


def test_open_loop_seeds_share_the_arrivals():
    mix = load_cell("chatglm3-6b.poisson").traffic
    da, ta = traffic.schedule(mix, SEED, 400)
    db, tb = traffic.schedule(mix, SEED + 1, 400)
    assert np.array_equal(da, db) and ta != tb
    assert sorted(ta) == sorted(tb)
    assert abs(400 / da[-1] - mix["rate_per_s"]) < 0.15 * mix["rate_per_s"]
    for t, p in mix["tiers"]:
        assert abs(ta.count(t) / 400 - p) < 0.08
    arrivals = traffic.open_loop(mix, SEED, 50.0, 1000)
    due = [r.due_s for r in arrivals]
    assert due == sorted(due) and due[-1] <= mix["warm_s"] + 50.0


def test_closed_loop_same_seed_same_requests():
    mix = load_cell("granite-moe-3b-a800m.longdoc").traffic
    for i in (0, 5, 31):
        a = traffic.closed_loop(mix, SEED, i, 49155)
        b = traffic.closed_loop(mix, SEED, i, 49155)
        assert a.tier == b.tier == "economy"
        assert np.array_equal(a.prompt, b.prompt)
        assert a.prompt.shape == (3840,)
    c = traffic.closed_loop(mix, SEED + 1, 0, 49155)
    assert not np.array_equal(c.prompt, traffic.closed_loop(
        mix, SEED, 0, 49155).prompt)
