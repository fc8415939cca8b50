"""The benchmark of the port, fluid2d_tpu_torch, on one H100: ``python3 -m bench_port.run``."""
