from repro_torch.kernels.moe_gemm.ops import moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
