"""The speculative verify step as a CUDA graph on the card: a speculating
serve through real verify graphs against the same serve verifying eagerly
(``cuda_graphs=False``), on reduced chatglm3-6b in bf16 with the kernels
on, dense, paged, int4 paged and on the resident prefix pool (two batches
sharing one graph), greedy and sampled: tokens and logprobs bit-equal.
Marked ``gpu``: they skip without a CUDA device. Run on a machine with an
H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spec_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.quant.quantize import quantize_model  # noqa: E402
from repro_torch.serving import ExecutionBackend, GumbelNoise  # noqa: E402
from repro_torch.spec import make_draft_policy  # noqa: E402

pytestmark = pytest.mark.gpu

N, NEW = 3, 9
PAGED = dict(kv_blocks=64, kv_block_size=16)
#: case -> (backend kwargs, weight format)
CASES = {"dense": ({}, None), "paged": (PAGED, None),
         "int4-paged": (PAGED, "int4"),
         "pooled": (dict(PAGED, kv_pool=True), None)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _serve(be, prompts, temperature, noise):
    h = be.start_batch(prompts, 3, NEW, temperature, noise)
    while be.decode_step(h):
        pass
    out = ([list(r) for r in h.spec.toks], [list(r) for r in h.spec.lps])
    be.finalize(h)
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kind", ["ngram", "draft"])
@pytest.mark.parametrize("case", list(CASES))
def test_verify_graphs_on_the_card_equal_eager(cuda, case, kind,
                                               temperature):
    kw, fmt = CASES[case]
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg, dtype=torch.bfloat16, device=cuda, use_kernel=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    if fmt is not None:
        params = quantize_model(params, fmt, 32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(2)]
    out, stats = [], []
    for graphs in (False, True):
        be = ExecutionBackend(model, params, cuda_graphs=graphs,
                              spec_policy=make_draft_policy(
                                  kind, draft_model=model,
                                  draft_params=params), spec_n=N, **kw)
        noise = GumbelNoise(torch.Generator(device=cuda).manual_seed(3))
        out.append([_serve(be, prompts, temperature, noise)
                    for _ in range(2 if case == "pooled" else 1)])
        stats.append(be.graph_stats)
    assert out[1] == out[0]
    assert (stats[0].verify_captures, stats[0].verify_replays) == (0, 0)
    assert stats[1].verify_captures == 1 and stats[1].verify_replays >= 1
    assert (stats[1].captures, stats[1].replays) == (0, 0)
