"""The compressed wire of the FL rounds (counterpart of repro/comm).

``make_channel("int8")`` gives a CommChannel whose uplink codec, broadcast
codec and error-feedback policy the round cores (core/algorithms.py)
follow, with exact per-round byte accounting.
"""
from repro_torch.comm.channel import (  # noqa: F401
    CODECS,
    IDENTITY_CHANNEL,
    CommChannel,
    make_channel,
)
from repro_torch.comm.codecs import (  # noqa: F401
    Bf16Codec,
    Codec,
    Fp32Codec,
    IdentityCodec,
    Int8SRCodec,
    TopKCodec,
    parse_codec,
)
from repro_torch.comm.schema import (  # noqa: F401
    CTRL_UPLINK,
    DELTA_UPLINK,
    DIR_UPLINK,
    GRAD_UPLINK,
    UplinkSpec,
    init_schema_state,
    uplink_byte_breakdown,
    validate_schema,
)
