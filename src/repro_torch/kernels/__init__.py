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

# integration modules probed inside each kernel package, in import order
_INTEGRATION_MODULES = ("ops",)

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
