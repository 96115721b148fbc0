"""Kernel packages.  Each hot spot ships ``ref.py`` (the plain PyTorch
version), ``kernel.py`` (its ``make_program`` — every instruction with a
torch face and a CUDA face — and the launch of the emitted CUDA kernel) and
``ops.py``, the integration module that registers a declarative
``KernelSpec`` with ``repro_torch.core.registry`` at import time, under the
JAX package's kernel names.  :mod:`repro_torch.kernels._build` compiles the
emitted source of each schedule.

Adding a kernel touches ONLY its own package: drop a new directory with an
``ops`` module and :func:`load_all` discovers it.

Each launch is counted by :func:`count_launch`: the schedule object's own
``launches``, its module's ``launches`` (every schedule's, from every
thread) and flash's ``variant_launches``.  A captured step graph
(``serve.graphs``) records the launches of its capture on its own thread
(:func:`recording_launches`) and credits them on every replay
(:func:`credit_launches`), since a replay runs the kernels without their
Python wrappers.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import importlib.util
import pkgutil
import sys
import threading
from typing import Any, Iterator, Mapping

import torch

#: (kernel object, variant) -> launches, while this thread records
_recording = threading.local()

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


def count_launch(kern: Any, variant: Any = None) -> None:
    """One launch of ``kern``, a schedule's kernel object: one more on its
    own ``launches``, its module's and, given ``variant``, its module's
    ``variant_launches[variant]``.  While this thread records
    (:func:`recording_launches`) the launch is only recorded: a captured
    launch runs when its graph replays."""
    log = getattr(_recording, "log", None)
    if log is not None:
        log[kern, variant] += 1
    else:
        credit_launches({(kern, variant): 1})


def credit_launches(counts: Mapping[tuple[Any, Any], int]) -> None:
    """Add ``counts`` ((kernel object, variant) -> launches) to the
    counters :func:`count_launch` keeps."""
    for (kern, variant), n in counts.items():
        mod = sys.modules[type(kern).__module__]
        mod.launches += n
        kern.launches += n
        if variant is not None:
            mod.variant_launches[variant] += n


@contextlib.contextmanager
def recording_launches() -> Iterator[collections.Counter]:
    """Inside the block, this thread's launches are recorded into the
    yielded counter instead of counted (a graph capture runs nothing)."""
    log = _recording.log = collections.Counter()
    try:
        yield log
    finally:
        _recording.log = None


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
