"""Mean device milliseconds a decode forward spends routing tokens to
experts and combining their outputs: the ``moe.route`` (router product,
softmax, top-k, sort and dispatch) and ``moe.combine`` segments of the
untraced ``device_time`` spans, summed over layers."""
from harness.spans import device_ms

SEGMENTS = ("moe.route", "moe.combine")


def read(run):
    return device_ms(run, SEGMENTS)
