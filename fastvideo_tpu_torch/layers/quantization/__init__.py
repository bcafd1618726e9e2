from fastvideo_tpu_torch.layers.quantization.int8 import (
    Int8Linear, QuantizationConfig, quantize_model_linears)

__all__ = ["Int8Linear", "QuantizationConfig", "quantize_model_linears"]
