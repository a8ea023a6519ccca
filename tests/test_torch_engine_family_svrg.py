"""The engine's parity with the per-round loop (tests/test_torch_engine.py:
test_chunked_run_equals_the_loop) for FedSVRG, FedOSAA-SVRG, one-step
L-BFGS and FedAvg: a part of its cases (``SVRG_CASES``), in a file of its
own so that the test files take similar time."""
import pytest

from test_torch_engine import (SVRG_CASES, check_chunked_run,  # noqa: F401
                               setup)

from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("algo,channel,chunk", SVRG_CASES)
def test_chunked_run_equals_the_loop(setup, algo, channel, chunk):  # noqa: F811
    check_chunked_run(setup, algo, channel, chunk)
