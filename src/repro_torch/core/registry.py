"""Declarative kernel registry — the paper's one-line integration surface.

§4.1 / Listing 2 promise *declarative* adoption: decorate the kernel, and SIP
handles interception, offline search, and cached deployment.  This module is
that surface for the repro:

* :class:`KernelSpec` — everything SIP needs to tune and deploy one kernel
  (build / program_for / space_for / oracle / signature_fn), plus the
  kernel's own :class:`Workload` declarations (deployment shapes), so the
  offline driver needs zero per-kernel code.
* :func:`sip_kernel` — registration decorator over the ``build`` factory.
* :class:`KernelRegistry` / :data:`registry` — name -> spec, with memoized
  ``SipKernel`` instances per (name, schedule-cache) so model code resolves
  ONE shared kernel object instead of constructing fresh instances (and
  fresh build caches) per call.
* :func:`schedule_cache` — contextvar-scoped active :class:`ScheduleCache`:
  serving wraps its region in ``with schedule_cache(path):`` and every
  ``registry.get`` inside resolves tuned schedules from that store.

Deterministic seeding: :func:`workload_seed` derives a stable per
(kernel, workload) seed so tuning a subset of kernels — or reordering them —
never changes another kernel's inputs or search trajectory.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import os
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from repro_torch.core.cache import LRUCache, ScheduleCache
from repro_torch.core.ir import Program
from repro_torch.core.jit import SipKernel
from repro_torch.core.schedule import SearchSpace


def workload_seed(kernel_name: str, workload_name: str, base: int = 0) -> int:
    """Stable seed for one (kernel, workload) pair.

    Hash-derived (not position-derived), so results are independent of which
    other kernels are tuned and in what order; ``base`` folds in the session
    seed so distinct sessions still decorrelate.
    """
    digest = hashlib.sha256(
        f"{kernel_name}::{workload_name}::{base}".encode()).digest()
    return int.from_bytes(digest[:4], "little")


@dataclasses.dataclass(frozen=True)
class Workload:
    """One deployment shape, declared next to the kernel that owns it.

    ``make_args(rng)`` returns the example argument list ``SipKernel.tune``
    consumes; ``suites`` tags which tuning suites include it ("default" for
    real deployment shapes, "smoke" for the tiny CI shapes every kernel must
    provide).  ``dtypes`` names, per argument, the dtype its tensor takes
    (a bfloat16 argument is drawn as float32 numpy, which has no bfloat16,
    and rounded when it becomes a tensor); an argument it does not cover
    keeps its draw's dtype.
    """

    name: str
    make_args: Callable[[np.random.Generator], Sequence[Any]]
    suites: tuple[str, ...] = ("default",)
    dtypes: tuple[str, ...] = ()

    def arg_dtypes(self, args: Sequence[Any]) -> list[str]:
        """The tensor dtype of each of ``args`` (a ``make_args`` draw)."""
        return [self.dtypes[i] if i < len(self.dtypes)
                else np.asarray(a).dtype.name for i, a in enumerate(args)]

    def tensors(self, rng: np.random.Generator, device: Any = "cpu") -> list:
        """One ``make_args`` draw as tensors of :meth:`arg_dtypes` on
        ``device``: the arguments a tune or a correctness sweep runs on."""
        from repro_torch.core.testing import to_tensor
        args = list(self.make_args(rng))
        return [to_tensor(a, dt, device)
                for a, dt in zip(args, self.arg_dtypes(args))]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declarative description of one SIP-tunable kernel.

    The six callables are exactly ``SipKernel``'s constructor surface; the
    spec adds the kernel's workload declarations and is what lives in the
    registry (instances are materialized lazily per schedule cache).
    """

    name: str
    build: Callable[..., Callable[..., Any]]
    program_for: Callable[..., Program]
    space_for: Callable[..., SearchSpace]
    oracle: Callable[..., Any]
    signature_fn: Callable[..., dict[str, Any]]
    workloads: tuple[Workload, ...] = ()
    module: str = ""               # filled by register(); package provenance
    owner: "KernelRegistry | None" = dataclasses.field(
        default=None, repr=False, compare=False)  # filled by register()

    def instantiate(self, cache: ScheduleCache | None = None) -> SipKernel:
        """A fresh (unshared) SipKernel — the pre-registry construction path,
        kept for deprecation shims and bit-equivalence tests."""
        return SipKernel(name=self.name, build=self.build,
                         program_for=self.program_for,
                         space_for=self.space_for, oracle=self.oracle,
                         signature_fn=self.signature_fn, cache=cache)

    def workloads_in(self, suite: str) -> tuple[Workload, ...]:
        return tuple(w for w in self.workloads if suite in w.suites)

    def __call__(self, *args: Any) -> Any:
        """Deployment path: dispatch through the owning registry's shared
        instance for the active schedule cache."""
        return (self.owner if self.owner is not None else registry) \
            .get(self.name)(*args)


# ----------------------------------------------------------- active cache
# contextvar (not a module global): concurrent scopes in different
# threads/tasks must not see each other's cache.
_ACTIVE_CACHE: contextvars.ContextVar[tuple[ScheduleCache, ...]] = \
    contextvars.ContextVar("repro_schedule_cache", default=())

# path -> ScheduleCache, so re-entering `schedule_cache(path)` (e.g. a server
# wrapping every request) resolves the SAME store object — and therefore the
# same memoized kernel instances — instead of re-reading the JSON and minting
# a fresh instance per scope.  Bounded by the number of distinct paths used.
_PATH_CACHES: dict[str, ScheduleCache] = {}
_PATH_LOCK = threading.Lock()


def cache_for_path(path: str) -> ScheduleCache:
    """The process-wide ScheduleCache for ``path`` (interned by abspath)."""
    key = os.path.abspath(path)
    with _PATH_LOCK:
        inst = _PATH_CACHES.get(key)
        if inst is None:
            # construct with the interned key, not the raw path: a relative
            # path would flush wherever the cwd happens to be at flush time
            inst = _PATH_CACHES[key] = ScheduleCache(key)
    return inst


@contextlib.contextmanager
def schedule_cache(cache: ScheduleCache | str) -> Iterator[ScheduleCache]:
    """Activate ``cache`` (an instance or a path) for a region of code.

    ``registry.get`` calls inside the region bind kernel instances to this
    store, so models/serving resolve tuned schedules without threading a
    cache argument through every layer.  Reentrant; innermost wins.  Paths
    are interned (``cache_for_path``), so repeated scopes over the same file
    share one store and one set of kernel instances.
    """
    if isinstance(cache, str):
        cache = cache_for_path(cache)
    token = _ACTIVE_CACHE.set(_ACTIVE_CACHE.get() + (cache,))
    try:
        yield cache
    finally:
        _ACTIVE_CACHE.reset(token)


def active_schedule_cache() -> ScheduleCache | None:
    """The innermost ``schedule_cache`` scope's store, or None."""
    stack = _ACTIVE_CACHE.get()
    return stack[-1] if stack else None


# ---------------------------------------------------------------- registry
class KernelRegistry:
    """Name -> KernelSpec, with shared SipKernel instances per cache."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, KernelSpec] = {}
        # bounded: each entry pins a SipKernel plus its compiled-build
        # caches AND its ScheduleCache, so an unbounded dict would grow
        # monotonically in a process that keeps opening fresh instance-form
        # caches; LRU eviction drops the pin (a later get re-instantiates)
        self._instances: LRUCache = LRUCache(maxsize=64)
        # the shared in-memory store used when no schedule_cache is active
        self._default_cache = ScheduleCache()

    # ------------------------------------------------------------- specs
    def register(self, spec: KernelSpec) -> KernelSpec:
        if not spec.module:
            spec = dataclasses.replace(
                spec, module=getattr(spec.build, "__module__", "") or "")
        if spec.owner is not self:
            spec = dataclasses.replace(spec, owner=self)
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(
                    f"kernel {spec.name!r} is already registered "
                    f"(by {self._specs[spec.name].module or 'unknown'}); "
                    f"kernel names must be unique")
            self._specs[spec.name] = spec
        return spec

    def spec(self, name: str) -> KernelSpec:
        try:
            return self._specs[name]
        except KeyError:
            known = ", ".join(self.names()) or \
                "(none — import repro_torch.kernels and call load_all())"
            raise KeyError(f"unknown kernel {name!r}; registered kernels: "
                           f"{known}") from None

    def names(self) -> list[str]:
        return sorted(self._specs)

    def specs(self) -> list[KernelSpec]:
        return [self._specs[n] for n in self.names()]

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    # --------------------------------------------------------- instances
    def get(self, name: str, cache: ScheduleCache | None = None) -> SipKernel:
        """The shared SipKernel for ``name``, bound to ``cache`` (explicit >
        active ``schedule_cache`` scope > registry default).

        Memoized: repeated resolution — e.g. the model's attention path on
        every trace — returns ONE kernel object, preserving its build/resolve
        caches.  (The instance holds a strong reference to its cache, so the
        ``id``-based key cannot alias a collected store.)
        """
        spec = self.spec(name)
        if cache is None:
            cache = active_schedule_cache() or self._default_cache
        key = (name, id(cache))
        with self._lock:
            return self._instances.get_or_build(
                key, lambda: spec.instantiate(cache=cache))

    def instance_count(self) -> int:
        return len(self._instances)


class KernelHandle:
    """Late-binding module-level handle for a registered kernel.

    ``registry.get`` honors the ACTIVE ``schedule_cache`` scope, so a handle
    exported at module top (``gemm_leaky_relu = KernelHandle(NAME)``) must
    not freeze the instance that happened to be current at import time —
    every call/attribute access re-resolves the shared instance for the
    scope in effect *now*.
    """

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return registry.get(self._name)(*args, **kwargs)

    def __getattr__(self, attr: str) -> Any:
        return getattr(registry.get(self._name), attr)

    def __repr__(self) -> str:
        return f"<registry kernel {self._name!r}>"


def sip_kernel(*, name: str,
               program_for: Callable[..., Program],
               space_for: Callable[..., SearchSpace],
               oracle: Callable[..., Any],
               signature_fn: Callable[..., dict[str, Any]],
               workloads: Sequence[Workload] = (),
               registry_: KernelRegistry | None = None,
               ) -> Callable[[Callable[..., Any]], KernelSpec]:
    """Registration decorator over the kernel's ``build`` factory::

        @sip_kernel(name="my_kernel", program_for=program_for,
                    space_for=space, oracle=ref.my_kernel,
                    signature_fn=signature_fn,
                    workloads=[Workload("smoke", make_args, suites=("smoke",))])
        def build(schedule, **static): ...

    Returns the registered :class:`KernelSpec`; calling it dispatches through
    the registry's shared instance for the active schedule cache.
    """

    def wrap(build: Callable[..., Any]) -> KernelSpec:
        spec = KernelSpec(name=name, build=build, program_for=program_for,
                          space_for=space_for, oracle=oracle,
                          signature_fn=signature_fn,
                          workloads=tuple(workloads))
        # explicit None check: an empty KernelRegistry is falsy (__len__)
        target = registry if registry_ is None else registry_
        return target.register(spec)

    return wrap


#: process-wide registry; kernel modules register into it at import time
#: (``repro_torch.kernels.load_all()`` imports every kernel package's integration
#: module).
registry = KernelRegistry()
