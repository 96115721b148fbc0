"""Chunked SSD (state-space dual) in plain PyTorch — the port of
``repro/kernels/ssd/ops.py`` (that module name is taken here by the
registry module that ``kernels.load_all`` probes).

``ssd_chunked`` is the O(S·Q + S·N·P) algorithm: an intra-chunk quadratic
term, per-chunk final states, an inter-chunk recurrence (the reference's
``lax.scan``, here a loop over chunks) and the state's contribution to each
chunk's outputs.  ``ssd_step`` is the recurrent single step that drives
decode with O(1) state.
"""

from __future__ import annotations

import torch


def segsum(la: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} la[..., k] (j<=i),
    -inf above the diagonal.  la: (..., Q) -> (..., Q, Q)."""
    q = la.shape[-1]
    cum = torch.cumsum(la, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    idx = torch.arange(q, device=la.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def chunk_states(la: torch.Tensor, xb: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, init_state: torch.Tensor | None):
    """Steps 2-4 of the chunked algorithm (everything but the intra-chunk
    term).  la (b, c, q, h), xb (b, c, q, h, p), B/C (b, c, q, n), float32.
    Returns (y_off (b, c, q, h, p), final state (b, h, n, p))."""
    bt, nc, _, h = la.shape
    n, p = B.shape[-1], xb.shape[-1]
    cum = torch.cumsum(la, dim=2)                             # (b,c,q,h)
    tail = torch.exp(cum[:, :, -1:, :] - cum)                 # decay to chunk end
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", B, tail, xb)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (b,c,h)
    carry = (torch.zeros((bt, h, n, p), dtype=torch.float32,
                         device=la.device) if init_state is None
             else init_state.float())
    prev = []
    for c in range(nc):                                       # the lax.scan
        prev.append(carry)                                    # state *before* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (b,c,h,n,p)
    in_decay = torch.exp(cum)                                 # decay from chunk start
    y_off = torch.einsum("bcin,bcih,bchnp->bcihp", C, in_decay, prev_states)
    return y_off, carry


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 64, init_state: torch.Tensor | None = None,
                return_state: bool = False):
    """x: (Bt,S,H,P); dt: (Bt,S,H); A: (H,); B,C: (Bt,S,N); D: (H,).

    Returns y (Bt,S,H,P) float32 [and final state (Bt,H,N,P) if
    return_state]."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk "
                         f"{chunk}")
    nc = s // chunk
    xr = x.float().reshape(bt, nc, chunk, h, p)
    dtr = dt.float().reshape(bt, nc, chunk, h)
    Br = B.float().reshape(bt, nc, chunk, n)
    Cr = C.float().reshape(bt, nc, chunk, n)
    la = dtr * A.float()[None, None, None, :]                 # (b,c,q,h)
    xb = xr * dtr[..., None]                                  # dt-weighted input

    # ---- 1. intra-chunk (quadratic within chunk) ---------------------------
    Lm = torch.exp(segsum(la.movedim(-1, -2)))                # (b,c,h,q,q)
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)              # (b,c,q,q)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", cb, Lm, xb)

    # ---- 2.-4. chunk states, recurrence, state -> output --------------------
    y_off, final = chunk_states(la, xb, Br, Cr, init_state)

    y = (y_diag + y_off).reshape(bt, s, h, p)
    y = y + D.float()[None, None, :, None] * x.float()
    if return_state:
        return y, final
    return y


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
             D: torch.Tensor):
    """One recurrent decode step.

    state: (Bt,H,N,P); x_t: (Bt,H,P); dt_t: (Bt,H); B_t, C_t: (Bt,N).
    Returns (new_state, y_t (Bt,H,P)), float32."""
    xf, dtf = x_t.float(), dt_t.float()
    dec = torch.exp(dtf * A.float()[None, :])                        # (b,h)
    upd = torch.einsum("bn,bhp->bhnp", B_t.float(), xf * dtf[..., None])
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), new_state)
    y = y + D.float()[None, :, None] * xf
    return new_state, y
