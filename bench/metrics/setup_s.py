"""Seconds from the process's start to the window's start: weights, the
kernels' load (and build, in a checkout's first run), the router's anneal,
the warm-up's graph captures and the load that fills the system."""


def read(run):
    return run.setup_s
