"""A CPU model of what bf16 flash attention's rounding does to a row, and of
what two wrong kernels do, at h2o-danube's serve prefill (S 4,544, D 80,
window 4,096; 2 heads, unit-normal bf16 inputs, seed 0).

    python3 tools/flash_row_error_model.py

The reference is the attention computed in float32 from the bf16 inputs
and rounded to bf16; the model of the kernel also rounds the softmax
weights P to bf16 before P V, as the tensor-core kernel does.  It prints
the largest per-row ||got - want|| / ||want|| for that model and for two
controls: the last 64 keys zeroed, and no window.  ``chip_smoke.py`` holds
the card's kernel to ``ROW_RTOL`` on this measure and requires both
controls to fail it.
"""

from __future__ import annotations

import torch

S, H, D, WINDOW, TILE = 4544, 2, 80, 4096, 64


def attention(q, k, v, window, round_p: bool) -> torch.Tensor:
    s = (q.float() @ k.float().transpose(-1, -2)) * D ** -0.5
    rows = torch.arange(S)[:, None]
    cols = torch.arange(S)[None]
    mask = cols <= rows
    if window:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, float("-inf"))
    p = (s - s.amax(-1, keepdim=True)).exp()
    denom = p.sum(-1, keepdim=True)
    if round_p:
        p = p.bfloat16().float()
    return ((p @ v.float()) / denom).bfloat16()


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()


def main() -> None:
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, H, S, D).bfloat16() for _ in range(3))
    want = attention(q, k, v, WINDOW, False)
    got = attention(q, k, v, WINDOW, True)
    print("P rounded to bf16", row_rel_err(got, want),
          "max abs", (got.float() - want.float()).abs().max().item(),
          "max |want|", want.abs().max().item())
    kz, vz = k.clone(), v.clone()
    kz[:, :, -TILE:] = 0
    vz[:, :, -TILE:] = 0
    print("last key tile zeroed",
          row_rel_err(attention(q, kz, vz, WINDOW, True), want))
    print("no window", row_rel_err(attention(q, k, v, None, True), want))


if __name__ == "__main__":
    main()
