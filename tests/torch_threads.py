"""One intra-op thread for the port's CPU tests.

torch gives every process as many intra-op threads as the host has cores.
Under ``pytest -n 6`` six workers then run up to six times the cores in
threads, and the port's small eager ops spend their time contending for
them: the acceptance run with its w* took ~300 s under that load against
~8 s alone. A port test module imports the fixture below, which runs the
module with one thread and restores the count after. A result that
depends on the thread count (a parallel sum's order) is compared within
the module, both sides on one thread, or at a tolerance far above it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
