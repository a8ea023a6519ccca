"""The fused AA step's Jacobi eigen-solve (kernels/anderson/ref.py:
jacobi_eigh_ref) against numpy's eigh at condition number 1e4 in
float64: a part of tests/test_torch_aa_step.py's grid (see JACOBI_SIZES
there), in a file of its own so that the test files take similar time."""
import numpy as np
import pytest

from test_torch_aa_step import JACOBI_SIZES, check_jacobi


@pytest.mark.parametrize("dtype", [np.float64])
@pytest.mark.parametrize("m", JACOBI_SIZES)
@pytest.mark.parametrize("cond", [1e4])
def test_jacobi_matches_numpy_eigh(dtype, m, cond):
    check_jacobi(dtype, m, cond)
