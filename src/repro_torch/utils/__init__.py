from repro_torch.utils.tree_math import (  # noqa: F401
    tree_axpy,
    tree_combine_stacked,
    tree_dot,
    tree_gram,
    tree_norm,
    tree_vdot_stacked,
)
