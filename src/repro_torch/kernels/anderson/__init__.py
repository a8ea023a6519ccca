from repro_torch.kernels.anderson.ops import (  # noqa: F401
    aa_step,
    flat_gram,
    flat_update,
)
from repro_torch.kernels.anderson.ref import (  # noqa: F401
    aa_step_ref,
    acc_dtype,
    gram_ref,
    jacobi_eigh_ref,
    update_ref,
)
