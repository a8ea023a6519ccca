"""The engine's parity with the per-round loop (tests/test_torch_engine.py:
test_chunked_run_equals_the_loop) for SCAFFOLD, FedOSAA-SCAFFOLD and
FedOSAA-AVG: a part of its cases (``SCAFFOLD_CASES``), in a file of its
own so that the test files take similar time."""
import pytest

from test_torch_engine import (SCAFFOLD_CASES, check_chunked_run,  # noqa: F401
                               setup)

from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("algo,channel,chunk", SCAFFOLD_CASES)
def test_chunked_run_equals_the_loop(setup, algo, channel, chunk):  # noqa: F811
    check_chunked_run(setup, algo, channel, chunk)
