"""Stencil operators (eager PyTorch) and the CUDA kernel wrappers."""
