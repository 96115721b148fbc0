"""Automatic probabilistic testing (paper §4.2).

Validation (theorem proving) is impossible for closed-semantics native code;
the paper instead draws random reference inputs, runs the *unmutated* kernel
to produce reference outputs, and rejects any mutated kernel whose outputs
mismatch.  We reproduce that contract: the oracle is the kernel's ``ref.py``
plain PyTorch version (equivalently the unmutated kernel — tests assert the
two agree), inputs are drawn with numpy from the kernel's input specs in the
JAX package's order and handed to both as tensors on the kernel's device,
and a mismatch anywhere in ``n_samples`` trials fails the candidate.

``FaultInjector`` supports the paper's Fig. 2 experiment (test samples vs
false positives): it wraps a correct kernel with a data-dependent fault that
only fires on rare inputs, so small sample counts let the broken kernel
through — exactly the false-positive mechanism the figure studies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch


def dtype_name(dtype: Any) -> str:
    """numpy's name of a torch or numpy dtype (``"float32"``, ``"bfloat16"``,
    ``"int32"``) — the spelling the JAX package's signatures use, so cache
    keys match across the two packages."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def to_tensor(x: Any, dtype: Any, device: str | torch.device) -> torch.Tensor:
    """A numpy draw as a tensor of ``dtype`` (any spelling) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=getattr(torch, dtype_name(dtype)))


def to_numpy(x: Any) -> np.ndarray:
    """A kernel's output as numpy (16-bit floats widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class InputSpec:
    shape: tuple[int, ...]
    dtype: Any = np.float32     # numpy or torch dtype, or its numpy name
    scale: float = 1.0

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        """A float32 standard-normal draw cast to ``dtype`` (kept float32 for
        bfloat16, which numpy lacks; :func:`to_tensor` rounds it)."""
        x = rng.standard_normal(self.shape).astype(np.float32) * self.scale
        name = dtype_name(self.dtype)
        return x if name == "bfloat16" else x.astype(name)


@dataclasses.dataclass
class TestReport:
    passed: bool
    samples_run: int
    first_failure: int | None = None
    max_err: float = 0.0


def probabilistic_test(candidate: Callable[..., Any],
                       oracle: Callable[..., Any],
                       specs: Sequence[InputSpec],
                       n_samples: int,
                       rng: np.random.Generator,
                       rtol: float = 2e-2,
                       atol: float = 2e-2,
                       batch: int = 16,
                       vectorize: str = "auto",
                       device: str | torch.device = "cpu") -> TestReport:
    """Run up to ``n_samples`` random trials; stop at the first mismatch.

    All ``batch`` input sets of an outer iteration are drawn up front (in the
    same sample-major order one-at-a-time testing would draw them), stacked
    along a new leading axis, and evaluated together:

    * ``vectorize="vmap"`` — one ``torch.func.vmap`` call per batch for
      candidate and oracle (one dispatch for the whole batch);
    * ``vectorize="loop"`` — per-sample calls over the pre-drawn stack, for
      callables vmap cannot trace (numpy oracles, :class:`FaultInjector`,
      a CUDA kernel's launch);
    * ``vectorize="auto"`` (default) — try vmap once, fall back to loop for
      the rest of the call if it raises.

    Reported pass/fail, ``samples_run``, ``first_failure`` and ``max_err``
    are identical across modes and to one-at-a-time testing: comparisons run
    per sample in draw order and stop at the first mismatch.  Draws are numpy
    (the JAX package's stream), converted to tensors on ``device``.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if vectorize not in ("auto", "vmap", "loop"):
        raise ValueError(f"vectorize must be auto|vmap|loop, got {vectorize!r}")
    use_vmap = vectorize in ("auto", "vmap")
    vmapped: tuple[Callable, Callable] | None = None
    max_err = 0.0
    done = 0
    while done < n_samples:
        todo = min(batch, n_samples - done)
        draws = [[s.sample(rng) for s in specs] for _ in range(todo)]
        got = want = None
        if use_vmap:
            stacked = [to_tensor(np.stack([d[i] for d in draws]), s.dtype,
                                 device) for i, s in enumerate(specs)]
            try:
                if vmapped is None:
                    vmapped = (torch.func.vmap(candidate),
                               torch.func.vmap(oracle))
                got = to_numpy(vmapped[0](*stacked))
                want = to_numpy(vmapped[1](*stacked))
            except Exception:
                if vectorize == "vmap":
                    raise
                got = want = None          # candidate may have vmapped fine
                use_vmap = False           # auto: loop for the rest of the call
        if got is None:
            tensors = [[to_tensor(a, s.dtype, device)
                        for a, s in zip(d, specs)] for d in draws]
            got = np.stack([to_numpy(candidate(*t)) for t in tensors])
            want = np.stack([to_numpy(oracle(*t)) for t in tensors])
        for j in range(todo):
            err = _rel_err(got[j], want[j])
            max_err = max(max_err, err)
            ok = np.allclose(got[j], want[j], rtol=rtol, atol=atol)
            done += 1
            if not ok:
                return TestReport(False, done, first_failure=done, max_err=max_err)
    return TestReport(True, done, max_err=max_err)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    denom = np.maximum(np.abs(want), 1e-6)
    return float(np.max(np.abs(got - want) / denom))


@dataclasses.dataclass
class FaultInjector:
    """Wrap ``fn`` with a fault that fires only when an input statistic
    exceeds ``threshold`` — a stand-in for a subtly-miscompiled schedule whose
    bug only manifests on rare data (Fig. 2's false-positive kernels).

    ``fire_prob`` is the per-sample probability that standard-normal inputs
    trip the threshold; it is determined by ``threshold`` and the input size.
    """

    fn: Callable[..., Any]
    threshold: float
    corruption: float = 1e-2

    def __call__(self, *args: Any) -> Any:
        out = to_numpy(self.fn(*args))
        stat = max(float(np.max(np.abs(to_numpy(a)))) for a in args)
        if stat > self.threshold:
            out = out + self.corruption * np.sign(out)   # silent corruption
        return out
