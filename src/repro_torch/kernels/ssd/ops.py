"""SIP integration + chunked-SSD assembly for the intra-chunk kernel — the
port of ``repro/kernels/ssd/pallas_ops.py``.

``ssd_intra_chunk`` registers with the reference's order-only space,
signature, workloads and oracle.  :func:`ssd_chunked_kernel` is
``chunked.ssd_chunked`` with the quadratic intra-chunk term on the kernel,
resolved through the registry at call time (so an active
``schedule_cache`` scope is honored); the chunk states and the inter-chunk
recurrence stay in torch (they are linear-cost).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import Workload, registry, sip_kernel
from repro_torch.core.schedule import Schedule, SearchSpace
from repro_torch.core.testing import dtype_name
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.ssd import chunked
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref

NAME = "ssd_intra_chunk"
#: a sequence that the configured chunk does not divide is padded at the end
#: to a multiple of min(chunk, PAD_CHUNK), which then is the chunk
PAD_CHUNK = 64


def space(**static) -> SearchSpace:
    return SearchSpace()        # order-only (paper-faithful) space


def program_for(schedule: Schedule, *, g, q, h, p, n, dtype="float32"):
    return K.make_program(q=q, n=n, p=p, dtype=dtype, grid=g * h)


def signature_fn(xb, la, B, C) -> dict:
    g, q, h, p = xb.shape
    return {"g": int(g), "q": int(q), "h": int(h), "p": int(p),
            "n": int(B.shape[-1]), "dtype": dtype_name(xb.dtype)}


def _ssd_args(g: int, q: int, h: int, p: int, n: int):
    def make_args(rng: np.random.Generator):
        xb = rng.standard_normal((g, q, h, p)).astype(np.float32)
        la = -np.abs(rng.standard_normal((g, q, h))).astype(np.float32) * 0.1
        B = rng.standard_normal((g, q, n)).astype(np.float32) * 0.3
        C = rng.standard_normal((g, q, n)).astype(np.float32) * 0.3
        return [xb, la, B, C]
    return make_args


WORKLOADS = (
    Workload("smoke_g2_q8_h2_p4_n8", _ssd_args(2, 8, 2, 4, 8),
             suites=("smoke",)),
    Workload("deploy_g4_q16_h4_p8_n16", _ssd_args(4, 16, 4, 8, 16)),
)


def build(schedule: Schedule, *, g, q, h, p, n, dtype="float32"):
    program = program_for(schedule, g=g, q=q, h=h, p=p, n=n, dtype=dtype)
    return K.SsdKernel(q=q, n=n, p=p, dtype=dtype, grid=g * h,
                       order=schedule.resolve_order(program))


SPEC = sip_kernel(name=NAME, program_for=program_for, space_for=space,
                  oracle=ref.intra_chunk, signature_fn=signature_fn,
                  workloads=WORKLOADS)(build)


def padded_chunk(s: int, chunk: int) -> tuple[int, int]:
    """(chunk, padded length) for a sequence of ``s``: ``chunk`` itself when
    it divides ``s``, else min(chunk, PAD_CHUNK) and ``s`` rounded up to a
    multiple of it.  The reference takes the largest power of two dividing
    ``s`` instead (``repro/models/ssm.py:223``), which gives an odd length
    chunks of 1: a kernel launch of S x H blocks of 1 x 1 work and an
    inter-chunk loop of S steps."""
    if s % chunk == 0:
        return chunk, s
    c = min(chunk, PAD_CHUNK)
    return c, -(-s // c) * c


def kernel_inputs(x, dt, A, B, C, *, chunk: int):
    """(chunk, xb, la, B, C) for the intra-chunk kernel: float32, contiguous
    (the model's B and C are column slices of the conv output), padded at
    the end per :func:`padded_chunk` with dt, x, B and C zero, and cut into
    (Bt * chunks, chunk, ...) rows."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    chunk, s_pad = padded_chunk(s, chunk)
    f32 = torch.float32
    xf, dtf, Bf, Cf = x.to(f32), dt.to(f32), B.to(f32), C.to(f32)
    if s_pad != s:
        pad = s_pad - s
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    g = bt * (s_pad // chunk)
    dtr = dtf.reshape(g, chunk, h)
    la = dtr * A.to(f32)[None, None, :]
    xb = xf.reshape(g, chunk, h, p) * dtr[..., None]
    return (chunk, xb, la, Bf.reshape(g, chunk, n).contiguous(),
            Cf.reshape(g, chunk, n).contiguous())


def ssd_chunked_kernel(x, dt, A, B, C, D, *, chunk: int = 64,
                       init_state=None, return_state: bool = False):
    """``chunked.ssd_chunked`` with the intra-chunk term on the kernel (its
    plain version on CPU tensors; a call that autograd would record
    raises, :func:`kernels.refuse_grad`: the kernel has no backward).
    x: (Bt,S,H,P); dt: (Bt,S,H); A: (H,); B,C: (Bt,S,N); D: (H,).

    S is padded at the end (:func:`padded_chunk`) with dt, x, B and C all
    zero: there la = 0 and xb = 0, so the real rows' outputs and the final
    state are exactly the unpadded ones (a padded row adds nothing to any
    state and decays nothing)."""
    return _ssd_padded(_intra_kernel, x, dt, A, B, C, D, chunk=chunk,
                       init_state=init_state, return_state=return_state)


def ssd_chunked_plain(x, dt, A, B, C, D, *, chunk: int = 64,
                      init_state=None, return_state: bool = False):
    """:func:`ssd_chunked_kernel`'s plain, differentiable version, on any
    device: the same padded chunks, the intra-chunk term in plain PyTorch
    (``ref.intra_chunk``)."""
    return _ssd_padded(ref.intra_chunk, x, dt, A, B, C, D, chunk=chunk,
                       init_state=init_state, return_state=return_state)


def _intra_kernel(xb, la, Br, Cr):
    if xb.device.type == "cpu":
        return ref.intra_chunk(xb, la, Br, Cr)
    refuse_grad("ssd_chunked_kernel", xb, la, Br, Cr)
    return registry.get(NAME)(xb, la, Br, Cr)


def _ssd_padded(intra, x, dt, A, B, C, D, *, chunk: int, init_state,
                return_state: bool):
    bt, s, h, p = x.shape
    n = B.shape[-1]
    chunk, xb, la, Br, Cr = kernel_inputs(x, dt, A, B, C, chunk=chunk)
    nc = xb.shape[0] // bt

    y_diag = intra(xb, la, Br, Cr).reshape(bt, nc, chunk, h, p)

    y_off, final = chunked.chunk_states(
        la.reshape(bt, nc, chunk, h), xb.reshape(bt, nc, chunk, h, p),
        Br.reshape(bt, nc, chunk, n), Cr.reshape(bt, nc, chunk, n),
        init_state)
    y = (y_diag + y_off).reshape(bt, nc * chunk, h, p)[:, :s]
    y = y + D.float()[None, None, :, None] * x.float()
    if return_state:
        return y, final
    return y
