from repro_torch.kernels.anderson.ops import flat_gram, flat_update  # noqa: F401
from repro_torch.kernels.anderson.ref import (  # noqa: F401
    acc_dtype,
    gram_ref,
    update_ref,
)
