"""The MoE grouped GEMM's share of its roofline in the traced slice: the
least time of its three products in each MoE layer of every forward of the
slice's steps (every expert's weights once, each routed row in and out;
`harness.work.moe_gemm_call`) over the device time of the kernels that
implement it, in percent."""
from harness import work
from harness.trace import kernel_seconds

KERNELS = ["moe_gemm"]


def read(run):
    w = run.widths
    if run.profile is None or not w.experts:
        return None
    spent = kernel_seconds(run.profile, KERNELS)
    if spent <= 0:
        return None
    least = 0.0
    for s in run.profile["steps"]:
        for e in s.events:
            tokens = e.prompts * e.plen if e.kind == "prefill" else e.rows
            least += w.moe_layers * sum(work.least_s(f, b) for f, b in
                                        work.moe_forward_calls(w, tokens))
    return 100.0 * least / spent
