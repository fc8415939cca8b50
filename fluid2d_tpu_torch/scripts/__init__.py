"""The port's probe scripts, each run as ``python -m fluid2d_tpu_torch.scripts.<name>``."""
