"""Median milliseconds, over the requests that completed inside the window,
from when a request was due to the start of the scheduler step that formed
its batch."""
from harness.stats import median


def read(run):
    done = run.completed_in_window()
    if not done:
        return None
    return median([(r.formed_t0 - r.due) * 1e3 for r in done])
