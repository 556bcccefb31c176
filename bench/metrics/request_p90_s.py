"""The 90th percentile over every request that completed inside the window
of its time from when it was due to the end of the step that retired it."""
from harness.stats import percentile


def read(run):
    done = run.completed_in_window()
    if not done:
        return None
    return percentile([r.done - r.due for r in done], 90)
