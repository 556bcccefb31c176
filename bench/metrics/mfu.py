"""Model FLOPs of every forward the window's steps ran (`harness.work`:
matmul parameters a token, attention at each row's real context, the
vocabulary head where logits are needed), over the window's seconds times
the card's dense bf16 peak, in percent. In a traced run the profiled slice
is left out, its steps' FLOPs and its profiler's wall both: the tracer
slows the slice's graph launches."""
from harness import work


def read(run):
    w = run.widths
    flops = 0.0
    for s in run.steps_untraced():
        for e in s.events:
            if e.kind == "prefill":
                flops += work.prefill_flops(w, e.prompts, e.plen)
            else:
                flops += work.decode_flops(w, e.rows, e.context)
    return 100.0 * flops / (run.untraced_s * work.PEAK_BF16_FLOPS)
