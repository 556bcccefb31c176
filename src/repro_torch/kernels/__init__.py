"""Hand-written Hopper kernels of the port, one per TPU kernel it replaces.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; its ``launches`` attribute counts kernel
launches, so a run can show that the main path went through the kernels
(the paged wrapper's second kernel, the grouped path's prefix kernel, has
a counter of its own).
A CUDA graph replays launches without calling the wrappers: its owner adds
the launches it captured at every replay (`add_launches`), so the counts
stay launches on the card.
"""
from typing import Dict

from repro_torch.kernels.decode_attention.ops import (
    decode_attention_cache, paged_decode_attention,
    paged_decode_attention_prefix)
from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul_int4,
                                                    dequant_matmul_int8)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gemm.ops import moe_gemm
from repro_torch.kernels.ssd_scan.ops import ssd_chunk

#: kernel name -> wrapper (or counter) carrying its ``launches`` count
KERNELS = {
    "flash_attention": flash_attention,
    "decode_attention": decode_attention_cache,
    "paged_decode_attention": paged_decode_attention,
    "paged_decode_attention_prefix": paged_decode_attention_prefix,
    "dequant_matmul_int8": dequant_matmul_int8,
    "dequant_matmul_int4": dequant_matmul_int4,
    "moe_gemm": moe_gemm,
    "ssd_scan": ssd_chunk,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches) to the wrappers' counts."""
    for name, n in delta.items():
        KERNELS[name].launches += n
