"""Top-k MoE with sort-based capacity dispatch (the port of
``repro.models.moe``).

  1. router logits (float32) -> top-k experts per token, their gates
     renormalised to sum to 1;
  2. token copies sorted by expert id (stable); a copy's position within
     its expert comes from the sorted segment starts, and copies past the
     expert's capacity are dropped (sent to the spare row ``e * cap``);
  3. the kept copies scattered into a dense (e, cap, d) buffer, and each
     expert's FFN run as one batched product over it;
  4. the results gathered back, gated, and each token's k copies summed.

The expert products are the reference's ``einsum``s, which it computes
outside any Pallas kernel; here they are ``torch.bmm``.  The k copies of a
token are summed in a fixed order (ascending expert id, the order the
reference's scatter-add visits them) in the compute dtype, never with
atomics, so a bf16 result is the same from run to run.

Dispatch scope: global (``cfg.moe_groups == 0``), or within each of
``moe_groups`` batch groups, each with its own capacity, the aux losses
averaged over the groups.  Decode and chunked prefill are ``dropless``:
capacity = the tokens of the dispatch, and the groups are not used.

Under tensor-parallel serving the experts, the router and the dispatch are
replicated on every rank and each expert's FFN hidden dim is sharded, so
the down projection's outputs are partial sums, all-reduced in
:func:`_dispatch_ffn` (``tp_allreduce``, the identity off a mesh), as the
reference does.  Training sharded along ``"model"`` cuts the same hidden
dim where the experts do not divide the ranks; where they do, the params
at rest cut the experts (``dist/partition.DEFAULT_RULES``) and the step
runs expert-parallel: the router's product gives each rank its experts'
logit columns and the FFN its experts' rows of the dispatch buffer, each
placed into a zero whole and summed over the ranks (``tp_allreduce``), so
routing and the dispatch stay replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.tp import model_part, tp_allreduce, tp_enter
from repro_torch.models.config import ModelConfig

#: the aux losses every decoder block returns (zeros for a dense MLP)
AUX_KEYS = ("load_balance", "router_z")


def moe_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One layer's MoE leaves (the reference's ``init_moe`` tree; its init
    scales are d**-0.5 for router, w_gate and w_up, f**-0.5 for w_down)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def _route(p, xt: torch.Tensor, cfg: ModelConfig):
    """xt: (T, d) -> (gates (T, k) float32, expert_idx (T, k), aux).

    The router product runs in float32 (the reference promotes the
    activations to the router's float32).  Top-k takes the k largest
    probabilities, ties to the lower expert id, as ``jax.lax.top_k``."""
    e, k = cfg.n_experts, cfg.top_k
    part = model_part("router")
    if part is None:
        logits = xt.float() @ p["router"].float()
    else:               # expert-parallel: this rank's columns, summed whole
        logits = _place(tp_enter(xt, "router").float() @ p["router"].float(),
                        part, e, -1, "router")
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # load balance counts each token's top-1 choice only
    density = F.one_hot(expert_idx[:, 0], e).float().mean(0)
    aux = {"load_balance": cfg.router_aux_weight * e
           * (density * probs.mean(0)).sum(),
           "router_z": cfg.router_z_weight
           * (torch.logsumexp(logits, dim=-1) ** 2).mean()}
    return gate_vals, expert_idx, aux


def _place(y: torch.Tensor, part: tuple[int, int], whole: int, dim: int,
           seam: str) -> torch.Tensor:
    """Rank ``part[0]`` of ``part[1]``'s block ``y`` of a dimension of size
    ``whole`` put at its place in zeros, summed over the ranks: the whole
    tensor on every rank (its gradient's block goes back to ``y``)."""
    r, n = part
    size = whole // n
    dim = dim % y.dim()
    pad = [0, 0] * (y.dim() - 1 - dim) + [r * size, whole - (r + 1) * size]
    return tp_allreduce(F.pad(y, pad), seam)


def _experts(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's FFN over its rows of ``buf`` (e, cap, d), summed over
    the ranks of a sharded layer (the manual-TP seam)."""
    part = model_part("experts")
    if part is None:
        # under TP each rank holds a share of every expert's hidden dim,
        # so the down projection is a partial sum
        return tp_allreduce(_expert_ffn(p, tp_enter(buf, "mlp"), cfg), "mlp")
    k = cfg.n_experts // part[1]
    mine = tp_enter(buf, "experts").narrow(0, part[0] * k, k)
    return _place(_expert_ffn(p, mine, cfg), part, cfg.n_experts, 0,
                  "experts")


def _expert_ffn(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's FFN over its rows: buf (e, cap, d) -> (e, cap, d)."""
    dt = buf.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate = torch.bmm(buf, p["w_gate"].to(dt))
        gate = F.silu(gate) if cfg.mlp_type == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = gate * torch.bmm(buf, p["w_up"].to(dt))
    elif cfg.mlp_type == "gelu":
        h = F.gelu(torch.bmm(buf, p["w_up"].to(dt)), approximate="tanh")
    else:
        raise ValueError(cfg.mlp_type)
    return torch.bmm(h, p["w_down"].to(dt))


def _dispatch_ffn(p, xt: torch.Tensor, gate_vals: torch.Tensor,
                  expert_idx: torch.Tensor, cfg: ModelConfig,
                  cap: int) -> torch.Tensor:
    """Sort-based capacity dispatch + per-expert FFN over (T, d) tokens."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    flat_expert = expert_idx.reshape(-1)                        # (T*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    sorted_expert, sort_idx = torch.sort(flat_expert, stable=True)
    sorted_token = flat_token[sort_idx]
    seg_start = torch.searchsorted(sorted_expert,
                                   torch.arange(e, device=dev))
    pos_in_exp = torch.arange(t * k, device=dev) - seg_start[sorted_expert]
    keep = pos_in_exp < cap
    dest = torch.where(keep, sorted_expert * cap + pos_in_exp, e * cap)

    # every dropped copy lands in the spare last row, which is cut off
    buf = xt.new_zeros((e * cap + 1, d))
    buf[dest] = xt[sorted_token]
    out = _experts(p, buf[:-1].reshape(e, cap, d), cfg)

    gathered = out.reshape(e * cap, d)[dest.clamp_max(e * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * gate_vals.reshape(-1)[sort_idx][:, None].to(xt.dtype)
    # each token's k copies in ascending expert order (their order in the
    # sorted list), summed left to right
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(t * k, device=dev)
    ascending = torch.sort(expert_idx, dim=-1).indices          # (T, k)
    copies = contrib[rank.view(t, k).gather(1, ascending)]      # (T, k, d)
    y = copies[:, 0]
    for j in range(1, k):
        y = y + copies[:, j]
    return y


def moe(p, x: torch.Tensor, cfg: ModelConfig, *, dropless: bool = False):
    """x: (B, S, d) -> (y, aux losses).

    ``dropless`` (decode and chunked prefill) sizes every expert for the
    worst case, capacity = the dispatch's tokens, so no copy is dropped."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = cfg.moe_groups
    if g and t % g == 0 and not dropless:
        tg = t // g
        cap = min(max(int(tg * k / e * cfg.capacity_factor), 1), tg)
        ys, auxes = [], []
        for xt in x.reshape(g, tg, d):
            gate_vals, expert_idx, aux = _route(p, xt, cfg)
            ys.append(_dispatch_ffn(p, xt, gate_vals, expert_idx, cfg, cap))
            auxes.append(aux)
        aux = {kk: torch.stack([a[kk] for a in auxes]).mean()
               for kk in AUX_KEYS}
        return torch.stack(ys).reshape(b, s, d), aux

    xt = x.reshape(t, d)
    gate_vals, expert_idx, aux = _route(p, xt, cfg)
    # top-k experts are distinct, so capacity t is always dropless
    cap = t if dropless else min(max(int(t * k / e * cfg.capacity_factor),
                                     1), t)
    y = _dispatch_ffn(p, xt, gate_vals, expert_idx, cfg, cap)
    return y.reshape(b, s, d), aux
