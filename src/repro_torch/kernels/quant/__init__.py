from repro_torch.kernels.quant.ops import (  # noqa: F401
    DEFAULT_CHUNK,
    chunk_rows,
    dequantize,
    int8_dequantize,
    int8_sr_encode,
    int8_sr_roundtrip,
    quantize,
)
from repro_torch.kernels.quant.ref import dequantize_ref, quantize_ref  # noqa: F401
