"""Mean rows a decode forward: the ``n_sequences`` of the backend's wall
``decode`` spans inside the window."""


def read(run):
    rows = [s.attrs["n_sequences"] for s in run.spans if s.name == "decode"]
    return sum(rows) / len(rows) if rows else None
