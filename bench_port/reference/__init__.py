"""The plain PyTorch reference the benchmark checks the port against."""
