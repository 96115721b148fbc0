"""Mamba-2 SSD (state-space dual): the chunked algorithm in plain PyTorch
(chunked.py), the naive oracle and the intra-chunk plain version (ref.py),
the intra-chunk program and its emitted CUDA kernel (kernel.py), and its
registration with the chunked assembly around it (ops.py)."""
