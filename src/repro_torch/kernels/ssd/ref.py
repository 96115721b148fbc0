"""Plain PyTorch versions for the SSD: the naive O(S^2) oracle of the whole
operator (the port of ``repro/kernels/ssd/ref.py``) and the intra-chunk
term that the CUDA kernel computes (the oracle of
``repro/kernels/ssd/pallas_ops.py:151``).

The "attention form" of SSD [arXiv:2405.21060]: with per-step decay
``a_t = exp(dt_t * A_h)`` the output is

    y_i = sum_{j<=i} (C_i . B_j) * prod_{k=j+1..i} a_k * dt_j * x_j + D_h x_i
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.chunked import segsum


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """x: (Bt, S, H, P); dt: (Bt, S, H) (post-softplus, > 0); A: (H,) (< 0);
    B, C: (Bt, S, N); D: (H,).  Returns (Bt, S, H, P) float32."""
    x, dt = x.float(), dt.float()
    la = dt * A.float()[None, None, :]                      # log a_t (Bt,S,H)
    cum = torch.cumsum(la, dim=1)
    Lm = cum[:, :, None, :] - cum[:, None, :, :]            # (Bt,S,S,H) i,j
    s = x.shape[1]
    idx = torch.arange(s, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, :, :, None]
    Lm = torch.where(mask, torch.exp(Lm), torch.zeros_like(Lm))
    cb = torch.einsum("bin,bjn->bij", C.float(), B.float())  # (Bt,S,S)
    w = cb[:, :, :, None] * Lm * dt[:, None, :, :]           # (Bt,S,S,H)
    y = torch.einsum("bijh,bjhp->bihp", w, x)
    return y + D.float()[None, None, :, None] * x


def intra_chunk(xb: torch.Tensor, la: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor) -> torch.Tensor:
    """The intra-chunk term y = ((C B^T) * L) xb per (chunk, head), with
    L = exp(segsum(la)) and every non-finite decay mapped to 0.
    xb: (G, Q, H, P); la: (G, Q, H); B, C: (G, Q, N) -> (G, Q, H, P) in
    xb's dtype.

    S = C B^T, L and W = S * L are float32, as in the reference's oracle;
    the segment sums and exp are taken in float64 and L rounded once, and
    the two contractions sum float32 products in float64 and round once.
    At positive log-decays (the SIP tests' standard-normal draws) the decays
    span e^+-40 within a chunk and a row of y can cancel to a millionth of
    its largest term, so two float32 sums in different orders (cuBLAS picks
    split-K for some shapes) differ past the tests' 2e-2; two float64 sums
    of the same exact products round to the same float32.  The CUDA kernel
    does the same."""
    f64 = torch.float64
    lam = la.to(f64).movedim(-1, 1)                          # (G, H, Q)
    Lm = torch.exp(segsum(lam)).float()
    Lm = torch.where(torch.isfinite(Lm), Lm, torch.zeros_like(Lm))
    cb = torch.einsum("gin,gjn->gij", C.float().to(f64),
                      B.float().to(f64)).float()
    w = cb[:, None] * Lm                                     # (G, H, Q, Q)
    return torch.einsum("ghij,gjhp->gihp", w.to(f64),
                        xb.float().to(f64)).to(xb.dtype)
