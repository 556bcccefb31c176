"""The collectives of `repro_torch.distributed.tp` on a spawned 2-rank gloo
world (the tensor axis of a 1 x 2 mesh): each function's forward and
backward against the same arithmetic on one process, at f32 tolerance.

Every rank draws every rank's inputs from one seed, so it can compute the
one-process result itself: the forward is held to it, and the backward of
``sum(out * w_r)`` (``w_r`` differs by rank unless the function's dual
assumes whole gradients, as ``dual="slice"`` does) to the gradient of the
sum over ranks of those losses, taken on one process. Rank 0 writes each
case's largest difference to a JSON file the tests read.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

TOL = 1e-6
N = 2


def _inputs(shape, seed, n=N):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for _ in range(n)]


def _diff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _cases(rank, group):
    """{name: (forward diff, backward diff)} on this rank."""
    from repro_torch.distributed import tp
    out = {}

    def run(name, fn, xs, ws, want_out, want_grad):
        x = xs[rank].clone().requires_grad_()
        y = fn(x)
        (y * ws[rank]).sum().backward()
        out[name] = (_diff(y.detach(), want_out), _diff(x.grad, want_grad))

    # all_gather: concatenation; backward reduce-scatter of partial grads
    xs, ws = _inputs((3, 4), 1), _inputs((3, 8), 2)
    run("all_gather", lambda x: tp.all_gather(x, 1, group),
        xs, ws, torch.cat(xs, 1), sum(ws).chunk(N, 1)[rank])
    # all_gather with dual="slice": every rank's gradient is whole
    w_same = [_inputs((6, 4), 3)[0]] * N
    run("all_gather_slice",
        lambda x: tp.all_gather(x, 0, group, dual="slice"),
        xs, w_same, torch.cat(xs, 0), w_same[0].chunk(N, 0)[rank])
    # reduce_scatter: the sum's chunk; backward all-gather
    xs, ws = _inputs((2, 6), 4), _inputs((2, 3), 5)
    run("reduce_scatter", lambda x: tp.reduce_scatter(x, -1, group),
        xs, ws, sum(xs).chunk(N, -1)[rank], torch.cat(ws, -1))
    # copy_to: identity; backward all-reduce
    xs, ws = _inputs((5,), 8), _inputs((5,), 9)
    run("copy_to", lambda x: tp.copy_to(x, group), xs, ws, xs[rank],
        sum(ws))
    # reduce_from: all-reduce; backward identity (whole gradients)
    w_same = [_inputs((5,), 10)[0]] * N
    run("reduce_from", lambda x: tp.reduce_from(x, group), xs, w_same,
        sum(xs), w_same[0])
    # all_reduce_both: all-reduce both ways
    run("all_reduce_both", lambda x: tp.all_reduce_both(x, group), xs, ws,
        sum(xs), sum(ws))

    # relayout, same dim: even chunks -> uneven, overlapping index sets
    total = 8
    full = _inputs((3, total), 11)[0]
    xs = list(full.chunk(N, 1))
    sets = tp.Sets([[0, 1, 2, 5], [2, 3, 4, 5, 6, 7]])
    ws = [torch.randn(3, len(sets[r]), generator=torch.Generator()
                      .manual_seed(12 + r)) for r in range(N)]
    want_grad = torch.zeros(3, total)
    for r in range(N):
        want_grad.index_add_(1, torch.as_tensor(sets[r]), ws[r])
    run("relayout_same_dim",
        lambda x: tp.relayout(x, group, 1, 1, sets), xs, ws,
        full[:, torch.as_tensor(sets[rank])],
        want_grad.chunk(N, 1)[rank])
    # relayout, other dim: column chunks -> row sets (the wo / down route)
    full = _inputs((6, 4), 13)[0]
    xs = list(full.chunk(N, 1))
    sets = tp.Sets([[0, 1, 4], [2, 3, 5]])
    ws = [torch.randn(3, 4, generator=torch.Generator().manual_seed(14 + r))
          for r in range(N)]
    want_grad = torch.zeros(6, 4)
    for r in range(N):
        want_grad.index_add_(0, torch.as_tensor(sets[r]), ws[r])
    run("relayout_other_dim",
        lambda x: tp.relayout(x, group, 1, 0, sets), xs, ws,
        full[torch.as_tensor(sets[rank])], want_grad.chunk(N, 1)[rank])

    # gather_sets (forward only): uneven, overlapping head ranges
    full = _inputs((2, 5, 3), 15)[0]
    ranges = [range(0, 2), range(1, 5)]
    got = tp.gather_sets(full[:, ranges[rank].start:ranges[rank].stop],
                         1, group, ranges, 5)
    out["gather_sets"] = (_diff(got, full), 0.0)
    # gather_sets of index sets (forward only): uneven, overlapping,
    # out of order within the whole
    sets = tp.Sets([[4, 0, 2], [2, 1, 3]])
    got = tp.gather_sets(full[:, torch.as_tensor(sets[rank])], 1, group,
                         sets, 5)
    out["gather_index_sets"] = (_diff(got, full), 0.0)
    # all_reduce_max (forward only)
    xs = _inputs((4,), 16)
    got = tp.all_reduce_max(xs[rank], group)
    out["all_reduce_max"] = (_diff(got, torch.maximum(*xs)), 0.0)
    return out


def _leaf_case(rank, mesh):
    """`TensorParallel.take` of a leaf sharded on both dims of a 1 x 2 mesh
    (columns on the tensor axis) to uneven column sets: forward and the
    gradient at the at-rest shard."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import tp
    ctx = tp.TensorParallel(mesh, 1, [0])
    full = _inputs((4, 6), 17)[0]
    local = full.chunk(N, 1)[rank].clone().requires_grad_()
    leaf = tp.Leaf(local, (Replicate(), Shard(1)), full.shape, "w")
    sets = tp.Sets([[0, 1], [2, 3, 4, 5]])
    y = ctx.take(leaf, 1, sets)
    ws = [torch.randn(4, len(sets[r]), generator=torch.Generator()
                      .manual_seed(18 + r)) for r in range(N)]
    (y * ws[rank]).sum().backward()
    want_grad = torch.zeros(4, 6)
    for r in range(N):
        want_grad.index_add_(1, torch.as_tensor(sets[r]), ws[r])
    return (_diff(y.detach(), full[:, torch.as_tensor(sets[rank])]),
            _diff(local.grad, want_grad.chunk(N, 1)[rank]))


def _world(rank, mesh, out_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    results = _cases(rank, mesh.get_group(1))
    results["take"] = _leaf_case(rank, mesh)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, results)
    if rank == 0:
        worst = {k: [max(r[k][i] for r in every) for i in range(2)]
                 for k in results}
        Path(out_path).write_text(json.dumps(worst))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch.mesh import run_debug_world
    out = tmp_path_factory.mktemp("tp_ops") / "results.json"
    run_debug_world(_world, (str(out),), n_data=1, n_model=N, device="cpu")
    return json.loads(out.read_text())


CASES = ["all_gather", "all_gather_slice", "reduce_scatter", "copy_to",
         "reduce_from", "all_reduce_both", "relayout_same_dim",
         "relayout_other_dim", "gather_sets", "gather_index_sets",
         "all_reduce_max", "take"]


@pytest.mark.parametrize("case", CASES)
def test_forward_and_backward_equal_one_process(world, case):
    fwd, bwd = world[case]
    assert fwd <= TOL, (case, fwd)
    assert bwd <= TOL, (case, bwd)


def test_split_and_sets():
    from repro_torch.distributed import tp
    assert tp.split(56, 16)[:3] == [range(0, 3), range(3, 7), range(7, 10)]
    assert sum(len(r) for r in tp.split(56, 16)) == 56
    s = tp.Sets([[0, 1, 2], [3, 4, 5]])
    assert s.even(3) and not s.even(2)
    assert s.span(1) == (3, 3)
    assert tp.Sets([[0, 2]]).span(0) is None
