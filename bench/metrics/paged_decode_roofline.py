"""Paged decode attention's share of its roofline in the traced slice: the
least time of every call the slice's decode steps made (one a layer; the
prompt's KV counted once a batch, `harness.work.paged_decode_call`) over
the device time of the kernels that implement it, in percent."""
from harness import work
from harness.trace import kernel_seconds

KERNELS = ["paged_decode_attention"]


def read(run):
    if run.profile is None:
        return None
    spent = kernel_seconds(run.profile, KERNELS)
    if spent <= 0:
        return None
    w = run.widths
    least = 0.0
    for s in run.profile["steps"]:
        for e in s.events:
            if e.kind == "decode":
                least += w.layers * work.least_s(*work.paged_decode_call(
                    w, e.prompts, e.plen, e.rows, e.context, e.table_blocks))
    return 100.0 * least / spent
