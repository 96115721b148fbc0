"""Kernel packages.  Each hot spot ships ``ref.py`` (the plain PyTorch
version) and ``kernel.py`` (the wrapper that launches the hand-written CUDA
kernel in ``src/repro_torch/csrc`` on a CUDA tensor, and the plain version on
a CPU tensor); :mod:`repro_torch.kernels._build` compiles and loads them."""
