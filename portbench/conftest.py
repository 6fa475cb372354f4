"""pytest settings of the benchmark's own tests (run with the tier-1
command pointed at ``portbench/tests``): the card-only marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")
