"""Fused RMSNorm: the program and its emitted CUDA kernel (kernel.py), its
plain PyTorch version (ref.py) and its registration (ops.py)."""
