"""Mean wall milliseconds of the backend's ``decode`` spans inside the
window: one graph replay and the synchronised copy of its tokens to the
host."""


def read(run):
    d = [s.t1_s - s.t0_s for s in run.spans if s.name == "decode"]
    return 1e3 * sum(d) / len(d) if d else None
