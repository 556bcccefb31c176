"""Median wall milliseconds of the untraced ``queued`` spans (submit to the
start of the ``step.form`` that placed the request) of the requests that
completed inside the window. A span that began before the window is not in
the run's spans."""
from harness.spans import untraced
from harness.stats import median


def read(run):
    done = {r.id for r in run.completed_in_window()}
    d = [(s.t1_s - s.t0_s) * 1e3 for s in untraced(run, "queued")
         if run.request_of.get(s.request_id) in done]
    return median(d) if d else None
