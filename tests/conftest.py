def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card of compute capability 9.x (the port's "
        "hand-written kernels); skips elsewhere")
