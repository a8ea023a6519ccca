from repro_torch.kernels.quant.ops import (  # noqa: F401
    DEFAULT_CHUNK,
    chunk_rows,
    dequantize,
    int8_dequantize,
    int8_sr_encode,
    int8_sr_roundtrip,
    int8_sr_uplink,
    quantize,
)
from repro_torch.kernels.quant.ref import (  # noqa: F401
    dequantize_ref,
    int8_sr_uplink_ref,
    quantize_ref,
)
