"""The 90th percentile, over the requests that completed inside the window,
of the time from when each was due to the end of the step whose prefill
sampled its first token."""
from harness.stats import percentile


def read(run):
    done = run.completed_in_window()
    if not done:
        return None
    return percentile([(r.first_token - r.due) * 1e3 for r in done], 90)
