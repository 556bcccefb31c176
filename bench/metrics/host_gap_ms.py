"""Mean milliseconds a scheduler step holds the host while the device
holds no work of the program: each untraced ``step`` span's wall less its
forwards' device-outstanding windows (the first ``enqueue`` to the
``sync``) and its ``readout`` spans (`harness.spans.host_gap_ms`)."""
from harness.spans import host_gap_ms


def read(run):
    return host_gap_ms(run)
