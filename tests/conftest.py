def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; each such test skips itself where "
        "torch.cuda.is_available() is false",
    )
