"""The FLOP and byte counts of mfu and the two roofline shares, against
values worked by hand at chatglm3-6b's, granite-moe-3b-a800m's and
DeepSeek-V2-Lite's widths; and the readers against the counts as they were
before they went by layer kind, to the bit, at every cell's sizes."""
import dataclasses

import pytest

import tiny
from harness import work
from harness.runner import Event, Run, Step
from harness.spec import load_cell, metric_reader
from harness.work import BF16

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


# DeepSeek-V2-Lite at its published widths (deepseek-ai/DeepSeek-V2-Lite
# config.json): MLA without q compression, a dense first layer of 10944,
# then 26 MoE layers of 64 routed experts (top-6) and 2 shared, all 1408
DSV2 = work.Widths.of({
    "name": "deepseek-v2-lite", "n_layers": 27, "d_model": 2048,
    "n_heads": 16, "n_kv_heads": 16, "d_ff": 10944, "vocab_size": 102400,
    "mla": {"kv_lora_rank": 512, "q_lora_rank": None,
            "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "v_head_dim": 128},
    "moe": {"n_experts": 64, "top_k": 6, "n_shared": 2, "d_expert": 1408,
            "moe_period": 1, "first_dense": 1}})


def test_mla_moe_layer_counts():
    assert (DSV2.moe_layers, DSV2.dense_layers) == (26, 1)
    # q 2048 x 16 x 192, kv_a 2048 x 576, kv_b 512 x 16 x 256, o 2048 x 2048
    assert work.attn_params_per_token(DSV2) == 13_762_560 == \
        6_291_456 + 1_179_648 + 2_097_152 + 4_194_304
    # router 2048 x 64, 6 routed and 2 shared experts of 3 x 2048 x 1408
    assert work.moe_ffn_params_per_token(DSV2) == 69_337_088 == \
        131_072 + 51_904_512 + 17_301_504
    assert work.dense_ffn_params_per_token(DSV2) == 67_239_936
    assert work.stack_params_per_token(DSV2) == 2_241_593_344 == \
        27 * 13_762_560 + 26 * 69_337_088 + 67_239_936
    # scores over nope + rope, P.V over v, 16 heads
    assert work.attn_flops_per_position(DSV2) == 10_240
    assert work.decode_flops(DSV2, 160, 200) == \
        2 * 2_241_593_344 * 160 + 27 * 10_240 * 160 * 200 \
        + 2 * 2048 * 102400 * 160


def test_mla_q_compression():
    w = dataclasses.replace(DSV2, q_lora=1536)
    assert work.attn_params_per_token(w) - work.attn_params_per_token(DSV2) \
        == 2048 * 1536 + 1536 * 16 * 192 - 2048 * 16 * 192


def test_latent_paged_decode_counts():
    flops, nbytes = work.paged_decode_call(DSV2, 8, 128, 160, 200, 24)
    # scores over the latent and the rope key (576), P.V over the latent
    assert flops == 2 * 160 * 16 * 576 * 200 + 2 * 160 * 16 * 512 * 200
    positions = 8 * 128 + 160 * 72
    # a position's latent and rope key in bf16, its int32 position; q over
    # 576 and the output over 512 a head; the table
    assert nbytes == positions * (1_152 + 4) + 160 * 16 * (576 + 512) * 2 \
        + 160 * 24 * 4 + 160 * 4
    _, per_row = work.paged_decode_call(DSV2, 160, 128, 160, 200, 24)
    assert per_row - nbytes == 152 * 128 * (1_152 + 4)


def test_uncounted_layers_are_refused():
    port = load_cell("chatglm3-6b.backlog").config["port"]
    for extra in ({"ssm": {"d_state": 128}}, {"layer_pattern": ["m", "a"]},
                  {"cross_attention": True}, {"n_codebooks": 4},
                  {"mlp_variant": "gelu"}):
        with pytest.raises(ValueError, match="no counts"):
            work.Widths.of(dict(port, **extra))


# The counts as they were before they went by layer kind: every layer one
# kind, attention 4 x heads x head dim a position
def _old_layer_params(w):
    attn = w.d * w.heads * w.head_dim * 2 + w.d * w.kv_heads * w.head_dim * 2
    if w.experts:
        ffn = w.d * w.experts + w.top_k * 3 * w.d * w.d_expert
    else:
        ffn = 3 * w.d * w.d_ff
    return attn + ffn


def _old_forward_flops(w, tokens, context_sum, head_rows):
    return (2.0 * _old_layer_params(w) * w.layers * tokens
            + 4.0 * w.layers * w.heads * w.head_dim * context_sum
            + 2.0 * w.d * w.vocab * head_rows)


def _old_paged_decode_call(w, prompts, plen, rows, context, table_blocks):
    flops = 4.0 * rows * w.heads * w.head_dim * context
    positions = prompts * plen + rows * (context - plen)
    kv = positions * w.kv_heads * w.head_dim * BF16 * 2
    pos = positions * 4
    qo = 2 * rows * w.heads * w.head_dim * BF16
    table = rows * table_blocks * 4 + rows * 4
    return flops, float(kv + pos + qo + table)


def _old_readings(w, steps, seconds, spent):
    flops = paged = moe = 0.0
    for s in steps:
        for e in s.events:
            if e.kind == "prefill":
                flops += _old_forward_flops(
                    w, e.prompts * e.plen,
                    e.prompts * e.plen * (e.plen + 1) // 2, e.prompts)
            else:
                flops += _old_forward_flops(w, e.rows, e.rows * e.context,
                                            e.rows)
                paged += w.layers * work.least_s(*_old_paged_decode_call(
                    w, e.prompts, e.plen, e.rows, e.context, e.table_blocks))
            tokens = e.prompts * e.plen if e.kind == "prefill" else e.rows
            moe += w.layers * sum(work.least_s(f, b) for f, b in
                                  work.moe_forward_calls(w, tokens))
    return {"mfu": 100.0 * flops / (seconds * work.PEAK_BF16_FLOPS),
            "paged_decode_roofline": 100.0 * paged / spent["paged"],
            "moe_gemm_roofline": 100.0 * moe / spent["moe"]}


def _recorded(mix):
    """The events the runner records for the mix's batches, one of each
    size it warms: a prefill and then a decode step for each later token,
    each row at its context through a table of its blocks."""
    plen, new, k = mix["prompt_tokens"], mix["new_tokens"], mix["samples"]
    nb = -(-(plen + new - 1) // mix["kv_block_size"])
    steps = []
    for b, n in enumerate(mix["warm_batch_sizes"]):
        steps.append(Step(len(steps), 0.0, 0.0,
                          [Event(b, "prefill", n, plen, n * k, plen, 0)], []))
        for s in range(1, new):
            steps.append(Step(len(steps), 0.0, 0.0, [Event(
                b, "decode", n, plen, n * k, plen + s, nb)], []))
    return steps


def _one_kind(cell):
    """Whether the old counts hold: grouped-query attention, and every
    layer's FFN of one kind."""
    w = work.Widths.of(load_cell(cell).config["port"])
    return not w.kv_lora and not w.n_shared and \
        w.moe_layers in (0, w.layers)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  tiny.BENCHMARK["workloads"]
                                  if _one_kind(w["name"])])
def test_readers_equal_the_old_counts_to_the_bit(cell):
    c = load_cell(cell)
    run = Run(c, 1, 1.0, None, work.Widths.of(c.config["port"]))
    run.steps = _recorded(c.traffic)
    run.window = (0.0, 10.0)
    spent = {"paged": 0.25, "moe": 0.5}
    run.profile = {"steps": run.steps, "kernels": [
        ("paged_decode_attention_split_kernel", 0.0, spent["paged"]),
        ("moe_gemm_tc_kernel", 0.0, spent["moe"])]}
    old = _old_readings(run.widths, run.steps, 10.0, spent)
    for name, value in old.items():
        if name == "moe_gemm_roofline" and not run.widths.experts:
            assert metric_reader(name)(run) is None
        else:
            assert metric_reader(name)(run) == value, name
