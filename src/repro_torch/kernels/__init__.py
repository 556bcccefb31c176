"""Hand-written Hopper kernels of the port, one per TPU kernel it replaces.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; its ``launches`` attribute counts kernel
launches, so a run can show that the main path went through the kernels.
"""
from repro_torch.kernels.decode_attention.ops import (decode_attention_cache,
                                                      paged_decode_attention)
from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul_int4,
                                                    dequant_matmul_int8)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gemm.ops import moe_gemm

#: kernel name -> wrapper carrying its ``launches`` count
KERNELS = {
    "flash_attention": flash_attention,
    "decode_attention": decode_attention_cache,
    "paged_decode_attention": paged_decode_attention,
    "dequant_matmul_int8": dequant_matmul_int8,
    "dequant_matmul_int4": dequant_matmul_int4,
    "moe_gemm": moe_gemm,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
