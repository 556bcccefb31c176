from repro_torch.quant.quantize import (BYTES_PER_PARAM, DEFAULT_GROUP_SIZE,
                                        EPS, QUANT_FORMATS, RAW_WEIGHT_KEYS,
                                        bytes_per_param_for, dequantize_dense,
                                        dequantize_model, group_size_for,
                                        is_quantized_dense, pack_int4,
                                        param_bytes, params_quant_format,
                                        qdense, quant_workload,
                                        quantize_dense, quantize_int4,
                                        quantize_int8, quantize_model)

__all__ = ["BYTES_PER_PARAM", "DEFAULT_GROUP_SIZE", "EPS", "QUANT_FORMATS",
           "RAW_WEIGHT_KEYS", "bytes_per_param_for", "dequantize_dense",
           "dequantize_model", "group_size_for", "is_quantized_dense",
           "pack_int4", "param_bytes", "params_quant_format", "qdense",
           "quant_workload", "quantize_dense", "quantize_int4",
           "quantize_int8", "quantize_model"]
