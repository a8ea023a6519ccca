from repro_torch.kernels.local_update.ops import fused_trajectory  # noqa: F401
from repro_torch.kernels.local_update.ref import (  # noqa: F401
    LINKS,
    link_coeff,
    trajectory_ref,
)
