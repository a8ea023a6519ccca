"""The engine's parity with the per-round loop (tests/test_torch_engine.py:
test_chunked_run_equals_the_loop) for the Newton family (GIANT, with and
without the line search, Newton-GMRES, DANE): a part of its cases
(``NEWTON_CASES``), in a file of its own so that the test files take
similar time."""
import pytest

from test_torch_engine import (NEWTON_CASES, check_chunked_run,  # noqa: F401
                               setup)


@pytest.mark.parametrize("algo,channel,chunk", NEWTON_CASES)
def test_chunked_run_equals_the_loop(setup, algo, channel, chunk):  # noqa: F811
    check_chunked_run(setup, algo, channel, chunk)
