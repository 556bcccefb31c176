"""Mean device milliseconds a decode forward spends in the segments that
run no matrix product (norms, rotary and the KV write, the activation,
the residual adds, sampling) in the untraced ``device_time`` spans, summed
over layers."""
from harness.spans import device_ms

SEGMENTS = ("attn.norm", "attn.rope_kv", "attn.residual", "ffn.norm",
            "mlp.act", "ffn.residual", "head.norm", "head.sample")


def read(run):
    return device_ms(run, SEGMENTS)
