"""Kernel packages.  Each hot spot ships ``ref.py`` (the plain PyTorch
version), ``kernel.py`` (its ``make_program`` — every instruction with a
torch face and a CUDA face — and the launch of the emitted CUDA kernel) and
``ops.py``, the integration module that registers a declarative
``KernelSpec`` with ``repro_torch.core.registry`` at import time, under the
JAX package's kernel names.  :mod:`repro_torch.kernels._build` compiles the
emitted source of each schedule.

Adding a kernel touches ONLY its own package: drop a new directory with an
``ops`` module and :func:`load_all` discovers it.
"""

from __future__ import annotations

import importlib
import importlib.util
import pkgutil

import torch

# integration modules probed inside each kernel package, in import order
_INTEGRATION_MODULES = ("ops",)


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` on a call that autograd would record (grad
    mode on and an input that requires grad): the CUDA kernels have no
    backward, so their outputs would carry no gradient.  The model runs a
    kernel only under ``cfg.use_pallas``, which serving sets and training
    leaves off, as the JAX package keeps ``pallas_call`` off its
    differentiated paths."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; a differentiated "
            f"call takes the plain version (ModelConfig.use_pallas=False)")


def load_all() -> list[str]:
    """Import every kernel package's integration module, registering their
    KernelSpecs.  Returns the registered kernel names.

    Fails loudly (instead of silently dropping a kernel from tuning/CI)
    when a kernel package has no integration module or registers nothing.
    """
    from repro_torch.core.registry import registry

    for info in pkgutil.iter_modules(__path__):
        if not info.ispkg:
            continue
        found = False
        for mod in _INTEGRATION_MODULES:
            full = f"{__name__}.{info.name}.{mod}"
            if importlib.util.find_spec(full) is not None:
                importlib.import_module(full)
                found = True
        if not found:
            raise RuntimeError(
                f"kernel package {info.name!r} has no integration module "
                f"({' / '.join(_INTEGRATION_MODULES)})")
        prefix = f"{__name__}.{info.name}"
        if not any(s.module == prefix or s.module.startswith(prefix + ".")
                   for s in registry.specs()):
            raise RuntimeError(
                f"kernel package {info.name!r} registers no KernelSpec — "
                f"decorate its build factory with @sip_kernel (or call "
                f"registry.register) in its integration module")
    return registry.names()
