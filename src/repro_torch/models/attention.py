"""GQA attention with RoPE, qk-norm and a KV cache, in three modes.

* prefill (``cache=None``): the whole prompt through the flash-attention
  kernel (``kernels/flash_attention``; its plain version on CPU tensors)
  under ``cfg.use_pallas``, else through its plain version;
* per-slot contiguous decode (``cache={'k', 'v', 'len'}``): the new tokens
  are written into the preallocated cache in place and read back by the
  plain masked ``_sdpa``.  A sliding-window model's cache of at most
  ``window`` positions is a ring: position p lives at slot p % size, and
  every slot below ``len`` is in the window;
* paged (``cache`` also holds ``pt``): writes go through the page table into
  the shared page store, reads through the ``paged_gather`` kernel (its
  plain version unless ``cfg.use_pallas``).

``cfg.use_pallas`` picks the kernels, as in the reference: serving sets it
(``serve.engine``), training leaves it off, since the kernels have no
backward (they raise on a call that autograd would record).

An encoder-decoder's decoder adds :func:`cross_attention` over the K/V that
:func:`encode_kv` projects once from the encoder output.

Under tensor-parallel serving (``repro_torch.dist.tp``) ``cfg`` is a
rank's local config: its share of the heads and kv heads, whose params and
caches it holds, and every count here is that share.  Training sharded
along ``"model"`` runs the same way, the input entering the rank's heads
through ``tp_enter`` (its gradient summed over the ranks); where the kv
heads are fewer than the ranks, the rank's ``wk``/``wv`` are the one kv
head its query heads map to.

Layouts are ``repro``'s: activations (B, S, H, D), weights ``wq`` (d, H, D)
and ``wo`` (H, D, d), where H is :func:`phys_heads`.  A padded config's
extra heads have zero ``wo`` rows, which the reference also masks at use,
so they add nothing: every mode here runs attention over the first
``n_heads`` query heads only, grouped onto the K/V heads as the
reference's head map groups them (``i // (n_heads // n_kv_heads)``), and
projects with those heads' ``wo`` rows.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist.tp import tp_allreduce, tp_enter
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.paged_attention import kernel as pg_kernel
from repro_torch.kernels.paged_attention import ref as pg_ref
from repro_torch.models import modules as nn
from repro_torch.models.config import ModelConfig

#: finite, never -inf: a fully masked row (an empty slot, kv_len == 0) gives
#: a uniform softmax instead of NaN, and the garbage stays in that slot
NEG_INF = -1e30


# ------------------------------------------------------------------ heads
def phys_heads(cfg: ModelConfig) -> int:
    """The query heads the params hold: ``padded_heads`` when it pads."""
    return max(cfg.padded_heads, cfg.n_heads) if cfg.padded_heads \
        else cfg.n_heads


# ------------------------------------------------------------------- rope
def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; pos: (S,) positions shared by the batch,
    or (B, S) per-sequence positions (every slot at its own offset)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[..., None] * freqs       # (S, half) | (B, S, half)
    if pos.dim() == 2:
        cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    else:
        cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor,
          heads: int | None = None) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product, over the first
    ``heads`` heads of ``w`` (all by default): a column slice of the
    (d, h*k) view, which the product reads in place."""
    d, h, k = w.shape
    n = h if heads is None else heads
    return (x @ w.to(x.dtype).reshape(d, h * k)[:, :n * k]).reshape(
        x.shape[0], x.shape[1], n, k)


def _out(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') over the real heads' ``wo`` rows.  Under
    tensor-parallel serving the heads are this rank's share, so the product
    is a partial sum, reduced over the ranks here (the manual-TP seam;
    the identity off a mesh)."""
    b, s, h, hd = o.shape
    wo = p["wo"][:cfg.n_heads].to(o.dtype)
    return tp_allreduce(o.reshape(b, s, h * hd)
                        @ wo.reshape(h * hd, wo.shape[-1]), "attn")


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor):
    q = _proj(x, p["wq"], cfg.n_heads)
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = nn.rmsnorm_apply(p["q_norm"], q)
        k = nn.rmsnorm_apply(p["k_norm"], k)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def prefill_kv(p, x: torch.Tensor, cfg: ModelConfig) -> dict[str, Any]:
    """The cache a prefill of ``x`` (B, S, d) returns, without the
    attention: K (qk-normed, rotated) and V at positions 0..S-1."""
    s = x.shape[1]
    _, k, v = _qkv(p, x, cfg, torch.arange(s, device=x.device))
    return {"k": k, "v": v,
            "len": torch.tensor(s, dtype=torch.int32, device=x.device)}


def _sdpa(q, k, v, *, causal: bool, window: int | None = None,
          kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D) -> (B,Sq,H,D), plain PyTorch (GQA).

    ``kv_len``: optional scalar — only cache positions < kv_len are valid —
    or a (B,) vector for per-slot decode (every slot has its own valid
    prefix).  ``window``: keys more than ``window - 1`` positions behind
    the query are masked too."""
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    group = h // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, group, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (dh ** -0.5)
    cols = torch.arange(skv, device=dev)
    if kv_len is not None and kv_len.dim() > 0:
        # per-slot: mask is (B, sq, skv)
        rows = torch.arange(sq, device=dev)[None, :, None] \
            + (kv_len[:, None, None] - sq)
        mask = (cols[None, None, :] < kv_len[:, None, None]).expand(b, sq, skv)
        if causal:
            mask = mask & (cols[None, None, :] <= rows)
        if window is not None:
            mask = mask & (cols[None, None, :] > rows - window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
    else:
        base = skv if kv_len is None else kv_len
        rows = torch.arange(sq, device=dev)[:, None] + (base - sq)
        mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (cols[None, :] <= rows)
        if window is not None:
            mask = mask & (cols[None, :] > rows - window)
        if kv_len is not None:
            mask = mask & (cols[None, :] < kv_len)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True,
              pos_offset: int | torch.Tensor = 0,
              cache: dict[str, Any] | None = None,
              return_cache: bool = False):
    """Self-attention -> (out, new_cache).  Modes:
      prefill: cache=None (``return_cache`` -> a fresh cache, else None)
      decode: cache={'k','v','len'} preallocated, written in place
      paged: cache also holds 'pt' (see :func:`_paged_decode`)

    ``pos_offset`` / ``cache['len']`` may be (B,) vectors: per-slot decode,
    where each batch slot holds a request at its own position."""
    b, s, _ = x.shape
    ar = torch.arange(s, device=x.device)
    if torch.is_tensor(pos_offset) and pos_offset.dim() > 0:
        pos = ar[None, :] + pos_offset[:, None]          # (B, S) per slot
    else:
        pos = ar + pos_offset
    q, k, v = _qkv(p, tp_enter(x, "attn"), cfg, pos)

    new_cache = None
    if cache is not None and "pt" in cache:     # paged decode / chunk prefill
        o, new_cache = _paged_decode(cache, q, k, v, cfg, causal=causal)
    elif cache is not None:                     # decode: append to cache
        idx = cache["len"]
        ck, cv = cache["k"], cache["v"]
        size = ck.shape[1]
        # sliding-window ring: slot(p) = p % size once the cache is at most
        # window-sized
        rolling = cfg.window is not None and size <= cfg.window
        # in place where the JAX package donates the cache buffers
        if idx.dim() > 0:
            # per-slot (s == 1): each slot's token at its own position.  A
            # free slot keeps advancing in lockstep and may run past its row;
            # JAX drops such out-of-range writes, here they land on the row's
            # last position, and the next admission overwrites the whole row
            rows_b = torch.arange(b, device=x.device)
            w_idx = idx.long() % size if rolling \
                else idx.long().clamp(max=size - 1)
            ck[rows_b, w_idx] = k[:, 0].to(ck.dtype)
            cv[rows_b, w_idx] = v[:, 0].to(cv.dtype)
        else:
            positions = idx.long() + ar
            if rolling:
                positions = positions % size
            ck.index_copy_(1, positions, k.to(ck.dtype))
            cv.index_copy_(1, positions, v.to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "len": idx + s}
        # a ring's slots are not positions: the causal and window masks do
        # not apply, and every slot below min(len, size) is in the window
        o = _sdpa(q, ck, cv, causal=causal and not rolling,
                  window=None if rolling else cfg.window, kv_len=idx + s)
    else:
        attend = fa_kernel.flash_attention if cfg.use_pallas \
            else fa_ref.attention
        o = attend(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal,
            window=cfg.window).transpose(1, 2)
        if return_cache:
            new_cache = {"k": k, "v": v,
                         "len": torch.tensor(s, dtype=torch.int32,
                                             device=x.device)}
    return _out(p, o, cfg), new_cache


def _paged_decode(cache: dict[str, Any], q, k, v, cfg: ModelConfig, *,
                  causal: bool):
    """Page-table-indirect cache write + read (continuous batching over a
    paged KV store).

    ``cache`` holds the page stores ``k``/``v`` (P, ps, Hkv, D), the
    per-slot lengths ``len`` (B,), and the routing keys the model layer
    injects per step: ``pt`` (B, n_pages) int32 page tables, optional
    ``active`` (B,) bool (rows mid chunked prefill or idle write to the
    trash page and do not advance), optional ``n_valid`` (chunked prefill:
    how many of the s positions are real tokens).

    Writes scatter each token at (pt[b, pos // ps], pos % ps), in place;
    reads gather the slot's pages into a contiguous (B, n*ps, Hkv, D) view
    (the ``paged_gather`` kernel under ``cfg.use_pallas``) and reuse the
    per-slot masked SDPA.
    """
    store_k, store_v, idx = cache["k"], cache["v"], cache["len"]
    pt = cache["pt"]
    active = cache.get("active")
    n_valid = cache.get("n_valid")
    s = q.shape[1]
    ps = store_k.shape[1]
    n_pages = pt.shape[1]

    pos = idx.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    # positions past the table's end go to the trash page (page 0):
    # chunked-prefill padding can overrun a full table, and clamping would
    # scatter duplicate offsets onto the LAST real page, overwriting live KV
    # — the clamp below only keeps the gather index legal.  Inactive rows go
    # there too.  index_put_ keeps an arbitrary one of duplicate (page,
    # offset) writes; every duplicate lands on the trash page, which nothing
    # reads as live, so the choice is harmless.
    page_slot = pos // ps
    page_ids = torch.gather(pt.long(), 1, page_slot.clamp(max=n_pages - 1))
    page_ids = torch.where(page_slot < n_pages, page_ids, 0)
    if active is not None:
        page_ids = torch.where(active[:, None], page_ids, 0)
    offs = pos % ps
    # in place where the JAX package donates the page stores
    store_k[page_ids, offs] = k.to(store_k.dtype)
    store_v[page_ids, offs] = v.to(store_v.dtype)

    gk = _gather_pages(store_k, pt, cfg)                   # (B, n*ps, Hkv, D)
    gv = _gather_pages(store_v, pt, cfg)
    o = _sdpa(q, gk, gv, causal=causal, kv_len=idx + s)

    adv = s if n_valid is None else n_valid
    if active is not None:
        adv = torch.where(active, adv, 0)
    return o, {"k": store_k, "v": store_v, "len": idx + adv}


def _gather_pages(store: torch.Tensor, pt: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """(P, ps, H, D) store + (B, n) page table -> contiguous (B, n*ps, H, D)
    per-slot KV view, through the ``paged_gather`` kernel under
    ``cfg.use_pallas``."""
    gather = pg_kernel.paged_gather if cfg.use_pallas else pg_ref.paged_gather
    pages = gather(store, pt)
    b, n, ps, h, d = pages.shape
    return pages.reshape(b, n * ps, h, d)


def cross_attention(p, x: torch.Tensor, ctx_kv: dict[str, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention over the encoder's precomputed K/V
    (``ctx_kv`` {'k', 'v'} (B, T, Hkv, D), :func:`encode_kv`): no rotary
    and no mask, through the plain ``_sdpa`` as in the reference."""
    q = _proj(x, p["wq"], cfg.n_heads)
    if cfg.qk_norm:
        q = nn.rmsnorm_apply(p["q_norm"], q)
    return _out(p, _sdpa(q, ctx_kv["k"], ctx_kv["v"], causal=False), cfg)


def encode_kv(p, ctx: torch.Tensor, cfg: ModelConfig) -> dict[str, Any]:
    """Project the encoder output ``ctx`` (B, T, d) once into the
    cross-attention K/V {'k', 'v'} (B, T, Hkv, D); qk-norm on k."""
    k, v = _proj(ctx, p["wk"]), _proj(ctx, p["wv"])
    if cfg.qk_norm:
        k = nn.rmsnorm_apply(p["k_norm"], k)
    return {"k": k, "v": v}
