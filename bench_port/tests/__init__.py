"""CPU tests of the port's benchmark harness: ``python -m pytest bench_port/tests``."""
