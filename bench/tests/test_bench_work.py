"""The FLOP and byte counts of mfu and the two roofline shares, against
values worked by hand at chatglm3-6b's and granite-moe-3b-a800m's widths."""
import pytest

import tiny  # noqa: F401  (sys.path)
from harness import work
from harness.spec import load_cell

GLM = work.Widths.of(load_cell("chatglm3-6b.backlog").config["port"])
GRA = work.Widths.of(
    load_cell("granite-moe-3b-a800m.backlog").config["port"])


def test_widths():
    assert (GLM.layers, GLM.d, GLM.heads, GLM.kv_heads, GLM.head_dim,
            GLM.vocab, GLM.d_ff) == (28, 4096, 32, 2, 128, 65024, 13696)
    assert (GRA.layers, GRA.d, GRA.heads, GRA.kv_heads, GRA.head_dim,
            GRA.vocab, GRA.experts, GRA.top_k, GRA.d_expert) == \
        (32, 1536, 24, 8, 64, 49155, 40, 8, 512)


def test_params_a_token():
    # q, o: 4096 x 4096 each; k, v: 4096 x 256 each; SwiGLU 3 x 4096 x 13696
    assert work.layer_params_per_token(GLM) == \
        2 * 4096 * 4096 + 2 * 4096 * 256 + 3 * 4096 * 13696
    # q, o: 1536 x 1536; k, v: 1536 x 512; router 1536 x 40; 8 of 40
    # experts of 3 x 1536 x 512
    assert work.layer_params_per_token(GRA) == \
        2 * 1536 * 1536 + 2 * 1536 * 512 + 1536 * 40 + 8 * 3 * 1536 * 512


def test_mfu_flops():
    p = 203_948_032
    assert work.decode_flops(GLM, 160, 200) == \
        2 * p * 28 * 160 + 4 * 28 * 32 * 128 * 160 * 200 \
        + 2 * 4096 * 65024 * 160
    # a prefill needs the head at each prompt's last position only
    assert work.prefill_flops(GLM, 8, 128) == \
        2 * p * 28 * 1024 + 4 * 28 * 32 * 128 * 8 * 128 * 129 // 2 \
        + 2 * 4096 * 65024 * 8


def test_paged_decode_counts_shared_prompt_once():
    flops, nbytes = work.paged_decode_call(GLM, 8, 128, 160, 200, 24)
    assert flops == 4 * 160 * 32 * 128 * 200
    # 8 prompts x 128 shared positions + 160 rows x 72 own ones, K and V of
    # 2 heads x 128 in bf16, an int32 position a slot, q and out, the table
    positions = 8 * 128 + 160 * 72
    assert nbytes == positions * 2 * 128 * 2 * 2 + positions * 4 \
        + 2 * 160 * 32 * 128 * 2 + 160 * 24 * 4 + 160 * 4
    _, per_row = work.paged_decode_call(GLM, 160, 128, 160, 200, 24)
    assert per_row - nbytes == 152 * 128 * (2 * 128 * 2 * 2 + 4)
    least = work.least_s(flops, nbytes)
    assert least == pytest.approx(nbytes / 3.35e12)      # bytes bound


def test_moe_gemm_counts_every_expert_once():
    flops, nbytes = work.moe_gemm_call(GRA, 160, 1536, 512)
    assert flops == 2 * 1280 * 1536 * 512
    assert nbytes == (40 * 1536 * 512 + 1280 * (1536 + 512)) * 2
    calls = work.moe_forward_calls(GRA, 160)
    assert calls[0] == calls[1] == (flops, nbytes)
    assert calls[2] == (2 * 1280 * 512 * 1536,
                        (40 * 512 * 1536 + 1280 * 2048) * 2)
    assert work.least_s(flops, nbytes) == pytest.approx(68_157_440 / 3.35e12)
    # no expert of 40 idle at 160 tokens x top-8: (32/40)^160
    assert (32 / 40) ** 160 < 1e-15
