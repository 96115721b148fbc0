"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Plain tensor code is PyTorch; every kernel that ``repro`` writes in Pallas
for the TPU is a CUDA C++ kernel written by hand for Hopper: a template in
``csrc/`` whose body ``Program.emit`` fills per SIP schedule, built and
loaded by :mod:`repro_torch.kernels._build`.  Nothing here imports JAX or
``repro``.
"""
