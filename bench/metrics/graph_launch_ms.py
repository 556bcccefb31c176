"""Mean wall milliseconds of the ``enqueue`` children of the untraced
``decode`` spans: for a graph replay, loading its inputs (the noise draw
among them) and the graph launch."""
from harness.spans import children, untraced


def read(run):
    kids = children(run)
    d = [c.t1_s - c.t0_s for s in untraced(run, "decode")
         for c in kids.get(s.span_id, ()) if c.name == "enqueue"]
    return 1e3 * sum(d) / len(d) if d else None
