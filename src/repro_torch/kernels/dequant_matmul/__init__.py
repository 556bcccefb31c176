from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul,
                                                    dequant_matmul_int4,
                                                    dequant_matmul_int8)
from repro_torch.kernels.dequant_matmul.ref import (dequant_matmul_int4_ref,
                                                    dequant_matmul_int8_ref,
                                                    dequantize_int4,
                                                    dequantize_int8,
                                                    unpack_int4)
