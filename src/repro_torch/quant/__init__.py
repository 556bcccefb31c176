from repro_torch.quant.quantize import (BYTES_PER_PARAM, bytes_per_param_for,
                                        param_bytes, params_quant_format,
                                        quant_workload)

__all__ = ["BYTES_PER_PARAM", "bytes_per_param_for", "param_bytes",
           "params_quant_format", "quant_workload"]
