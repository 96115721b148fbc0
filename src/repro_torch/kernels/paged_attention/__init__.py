"""Paged-KV gather: the CUDA kernel's wrapper (kernel.py) and its plain
PyTorch version (ref.py)."""
