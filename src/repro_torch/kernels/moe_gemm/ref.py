"""Plain PyTorch version of the grouped expert GEMM, ported from
``repro.kernels.moe_gemm.ref``: the semantics the CUDA kernel in
``repro_torch/csrc/moe_gemm.cu`` is held to, at tolerance."""
import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), w (E, d, f) -> (E, C, f) with f32 accumulation, in x's
    dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
