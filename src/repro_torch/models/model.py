"""The dense decoder LM and the Mamba-2 LM: init, forward, prefill and
decode entry points, and the per-slot and paged cache helpers the serving
engines use.

Params are a nested dict of tensors with ``repro``'s tree, leaf names and
layouts (``nn.unwrap(init_lm(...))``), per-layer leaves stacked on axis 0.
The layer stack is a Python loop over per-layer views.  The JAX package
keeps params in float32 and casts each weight to ``cfg.dtype`` at every use;
the port stores every weight in the compute dtype once, at load, which gives
the same values and halves the weight memory in bf16.  Norm gains stay
float32: RMSNorm casts its gain to float32, so storing them rounded would
change the result.  The same holds for the SSM leaves the reference reads
in float32 (``ssm.F32_LEAVES``).

Cache layouts, written out (``repro`` finds them structurally with
``jax.eval_shape``): dense ``k``/``v`` (L, B | P, S | ps, Hkv, D) in the
compute dtype and ``len`` int32 — (L,) from :func:`prefill`, (L, slots) for
the serving caches; ssm ``conv`` (L, B | slots, W-1, C) in the compute
dtype and ``ssd`` (L, B | slots, H, N, P) float32, with no ``len`` and no
paged store.  The decode paths update caches in place where the JAX
package donates them, and return the same dict.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import blocks
from repro_torch.models import modules as nn
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]
#: leaves that hold RMSNorm gains (kept in float32)
NORM_LEAVES = ("ln1", "ln2", "ln", "ln_f", "q_norm", "k_norm")
#: every leaf kept in float32
F32_LEAVES = NORM_LEAVES + ssm.F32_LEAVES


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===================================================================== init
def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The param tree's leaf shapes (layers stacked on axis 0)."""
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    top = {"embed": (cfg.vocab, d), "ln_f": (d,), "lm_head": (d, cfg.vocab)}
    if cfg.family == "ssm":
        mixer = {k: (n,) + v for k, v in ssm.mixer_shapes(cfg).items()}
        return {**top, "blocks": {"ln": (n, d), "mixer": mixer}}
    attn = {"wq": (n, d, cfg.n_heads, hd), "wk": (n, d, cfg.n_kv_heads, hd),
            "wv": (n, d, cfg.n_kv_heads, hd), "wo": (n, cfg.n_heads, hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = (n, hd)
        attn["k_norm"] = (n, hd)
    ffn = {"w_down": (n, cfg.d_ff, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        ffn["w_gate"] = (n, d, cfg.d_ff)
        ffn["w_up"] = (n, d, cfg.d_ff)
    elif cfg.mlp_type == "gelu":
        ffn["w_up"] = (n, d, cfg.d_ff)
    else:
        raise ValueError(cfg.mlp_type)
    return {**top, "blocks": {"ln1": (n, d), "attn": attn, "ln2": (n, d),
                              "ffn": ffn}}


def map_params(fn, shapes: dict[str, Any], path: tuple[str, ...] = ()):
    """Build a param tree from ``fn(path, shape)`` over :func:`param_shapes`."""
    return {k: map_params(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in shapes.items()}


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> Params:
    """Random weights from ``seed``, with ``repro``'s init scales: normal
    times 1 (embed), d**-0.5 (lm_head, wq, wk, wv, w_gate, w_up),
    (n_heads*hd)**-0.5 (wo), d_ff**-0.5 (w_down); norm gains are ones; the
    ssm mixer's as ``ssm.INIT`` says."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = compute_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    # the fan-in each normal weight is scaled by (its ** -0.5)
    fan_in = {"embed": 1, "lm_head": d, "wq": d, "wk": d, "wv": d,
              "wo": cfg.n_heads * cfg.hd, "w_gate": d, "w_up": d,
              "w_down": cfg.d_ff}

    def make(path, shape):
        name = path[-1]
        if name in NORM_LEAVES:
            return torch.ones(shape, dtype=torch.float32, device=dev)
        if path[-2:-1] == ("mixer",):
            if not isinstance(ssm.INIT[name], str):
                return torch.full(shape, ssm.INIT[name], dtype=torch.float32,
                                  device=dev)
            scale = ssm.init_scale(cfg, name)
        else:
            scale = fan_in[name] ** -0.5
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * scale).to(dt)

    return map_params(make, param_shapes(cfg))


def _layers(stacked: dict[str, Any]) -> list[dict[str, Any]]:
    """Per-layer views of the stacked block params."""
    def unbind(tree):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    per_leaf = unbind(stacked)
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(per_leaf, i) for i in range(first.shape[0])]


def _embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"][tokens.long()].to(compute_dtype(cfg))


def _logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    return nn.dense(p["lm_head"], x, x.dtype)


# ============================================================== forward
def forward(p: Params, inputs: dict[str, torch.Tensor], cfg: ModelConfig):
    """Eval forward over ``inputs['tokens']`` (B, S) -> (logits, aux)."""
    x = _embed(p, inputs["tokens"], cfg)
    for lp in _layers(p["blocks"]):
        if cfg.family == "ssm":
            x, _ = blocks.mamba_block(lp, x, cfg)
        else:
            x, _ = blocks.decoder_block(lp, x, cfg, causal=True)
    x = nn.rmsnorm_apply(p["ln_f"], x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(p, x), {"load_balance": zero, "router_z": zero}


# ============================================================ prefill / decode
def prefill(p: Params, inputs: dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: int):
    """Forward over the prompt, building decode caches sized ``max_len``.
    Returns (last_token_logits, caches).  An ssm model's caches are its
    per-layer conv and SSD states, whatever ``max_len``."""
    x = _embed(p, inputs["tokens"], cfg)
    if cfg.family == "ssm":
        states = []
        for lp in _layers(p["blocks"]):
            x, st = blocks.mamba_block(lp, x, cfg, return_state=True)
            states.append(st)
        caches = {k: torch.stack([st[k] for st in states]) for k in states[0]}
        x = nn.rmsnorm_apply(p["ln_f"], x[:, -1:])
        return _logits(p, x)[:, 0], caches
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    layers = _layers(p["blocks"])
    shape = (len(layers), b, max_len, cfg.n_kv_heads, cfg.hd)
    caches = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
              "v": torch.zeros(shape, dtype=x.dtype, device=x.device),
              "len": torch.full((len(layers),), s, dtype=torch.int32,
                                device=x.device)}
    for i, lp in enumerate(layers):
        x, cache = blocks.decoder_block(lp, x, cfg, causal=True,
                                        return_cache=True)
        caches["k"][i, :, :s] = cache["k"]
        caches["v"][i, :, :s] = cache["v"]
    x = nn.rmsnorm_apply(p["ln_f"], x[:, -1:])
    return _logits(p, x)[:, 0], caches


def decode_step(p: Params, caches, tokens: torch.Tensor, cfg: ModelConfig, *,
                pt: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """One decode step.  tokens: (B,) -> (logits (B, vocab), caches).

    ``pt`` (B, n_pages) routes cache traffic through a paged store (see
    :func:`alloc_paged_caches`); ``active`` (B,) masks rows that must neither
    write real pages nor advance (idle slots, slots mid chunked prefill) —
    their scatters land in the trash page.  An ssm model takes neither: its
    caches are dense per-slot states, advanced in place."""
    if cfg.family == "ssm":
        if pt is not None:
            raise ValueError(f"paged decode supports attention families "
                             f"(dense/moe/vlm), not {cfg.family!r}")
        x = _embed(p, tokens[:, None], cfg)
        for i, lp in enumerate(_layers(p["blocks"])):
            st = {"conv": caches["conv"][i], "ssd": caches["ssd"][i]}
            x, new = blocks.mamba_block(lp, x, cfg, state=st)
            caches["conv"][i] = new["conv"]
            caches["ssd"][i] = new["ssd"]
        x = nn.rmsnorm_apply(p["ln_f"], x)
        return _logits(p, x)[:, 0], caches
    logits, caches = decode_tokens(p, caches, tokens[:, None], cfg, pt=pt,
                                   active=active)
    return logits[:, 0], caches


def decode_tokens(p: Params, caches, tokens: torch.Tensor, cfg: ModelConfig,
                  *, pt: torch.Tensor | None = None,
                  active: torch.Tensor | None = None,
                  n_valid: int | None = None):
    """Cache-advancing forward over ``tokens`` (B, S) -> (logits (B, S,
    vocab), caches).

    S == 1 is the lockstep decode step; S > 1 is a chunked-prefill step.
    The paged routing keys go into each layer's cache dict for
    ``attention``'s paged branch: ``pt`` (B, n_pages) int32 page tables,
    ``active`` (B,) bool rows that may write real pages and advance, and
    ``n_valid`` — how many of the S positions are real (a padded final
    chunk advances ``len`` by n_valid)."""
    x = _embed(p, tokens, cfg)
    lens = caches["len"]
    for i, lp in enumerate(_layers(p["blocks"])):
        cache = {"k": caches["k"][i], "v": caches["v"][i], "len": lens[i]}
        if pt is not None:
            cache["pt"] = pt
            if active is not None:
                cache["active"] = active
            if n_valid is not None:
                cache["n_valid"] = n_valid
        x, new = blocks.decoder_block(lp, x, cfg, causal=True,
                                      pos_offset=cache["len"], cache=cache)
        lens[i] = new["len"]        # in place: k/v were written in place too
    x = nn.rmsnorm_apply(p["ln_f"], x)
    return _logits(p, x), caches


# ============================================== per-slot caches (cont. batching)
# The continuous-batching engine keeps a fixed-capacity decode batch whose
# slots hold independent requests.  A request is prefilled alone (or with a
# same-length group) and its cache is spliced into its slot; ``len`` becomes
# a per-slot (L, capacity) tensor so masks and rope run at each slot's own
# offset.

def alloc_slot_caches(cfg: ModelConfig, capacity: int, max_len: int, *,
                      device: str | torch.device) -> dict[str, torch.Tensor]:
    """Zero decode caches for ``capacity`` slots of ``max_len`` positions
    (an ssm model's per-slot states do not depend on ``max_len``)."""
    dt, dev = compute_dtype(cfg), torch.device(device)
    if cfg.family == "ssm":
        st = ssm.init_mamba_state(cfg, capacity, dt, dev)
        return {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                               dtype=v.dtype, device=dev)
                for k, v in st.items()}
    shape = (cfg.n_layers, capacity, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((cfg.n_layers, capacity), dtype=torch.int32,
                               device=dev)}


def insert_slots(caches, group_caches, slots: torch.Tensor):
    """Splice a batch-G prefill cache into slots ``slots`` ((G,) ints) in
    place — one scatter per leaf.  The group shares one prompt length."""
    slots = slots.long()
    for name, leaf in caches.items():
        grp = group_caches[name]
        leaf[:, slots] = grp[:, None] if name == "len" else grp.to(leaf.dtype)
    return caches


def evict_slot(caches, slot: int):
    """Invalidate slot ``slot``: zero its lengths so attention sees an empty
    prefix.  State leaves (k/v rows, ssm states) are left in place: the next
    insert into the slot overwrites them wholesale."""
    if "len" in caches:
        caches["len"][:, slot] = 0
    return caches


# ================================================== paged caches (serve/pages)
# Paged serving memory: the KV leaves become flat page stores (L, P, ps, H,
# D) indexed through per-slot page tables ((B, n_pages) int32 rows the
# engine owns host-side and passes into every decode/chunk step).  Page ids
# are layer-invariant: a slot's page holds that page's positions in every
# layer.

def alloc_paged_caches(cfg: ModelConfig, capacity: int, page_size: int,
                       num_pages: int, *,
                       device: str | torch.device) -> dict[str, torch.Tensor]:
    """Zero paged caches: (L, num_pages, page_size, Hkv, D) stores shared by
    every slot, and per-slot lengths (L, capacity)."""
    if cfg.window is not None:
        raise ValueError("paged caches are incompatible with sliding-window "
                         "ring buffers (cfg.window)")
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    dt, dev = compute_dtype(cfg), torch.device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((cfg.n_layers, capacity), dtype=torch.int32,
                               device=dev)}


def insert_pages(caches, group_caches, slots: torch.Tensor,
                 pages: torch.Tensor):
    """Splice a batch-G prefill cache (built at max_len rounded up to a page
    multiple, so its seq extent is ``n_pg * page_size``) into the page store
    at the group's page ids ``pages`` ((G, n_pg)), in place, and set the
    group's slot lengths."""
    flat = pages.reshape(-1).long()
    for name in ("k", "v"):
        store, grp = caches[name], group_caches[name]
        l, g, r, h, hd = grp.shape                # (L, G, n_pg*ps, H, D)
        ps = store.shape[2]
        store[:, flat] = grp.reshape(l, g * (r // ps), ps, h, hd).to(
            store.dtype)
    caches["len"][:, slots.long()] = group_caches["len"][:, None].to(
        torch.int32)
    return caches


def set_slot_lens(caches, slot: int, value: int):
    """Set slot ``slot``'s cache position to ``value`` (prefix-cache hits
    start a slot at the shared-prefix length without any KV traffic)."""
    caches["len"][:, slot] = value
    return caches


def slot_view(caches, slot: int):
    """A batch-1 view of one slot: its lengths sliced (a view, so writes go
    through), page stores passed whole."""
    return {"k": caches["k"], "v": caches["v"],
            "len": caches["len"][:, slot:slot + 1]}


def merge_slot(caches, view, slot: int):
    """Write a :func:`slot_view` back: the page stores are shared (writes
    already landed at absolute page ids); the lengths scatter at ``slot``."""
    caches["len"][:, slot:slot + 1] = view["len"]
    return caches


def prefill_chunk(p: Params, caches, tokens: torch.Tensor,
                  pt_row: torch.Tensor, slot: int, n_valid: int,
                  cfg: ModelConfig):
    """One chunked-prefill step for one slot over the paged cache.

    ``tokens`` (1, chunk) is the next prompt chunk, zero-padded past
    ``n_valid`` on the final chunk; ``pt_row`` (1, n_pages) is the slot's
    page table.  Returns the logits at the last valid position ((1, vocab),
    only meaningful on the final chunk) and the updated caches."""
    view = slot_view(caches, slot)
    logits, view = decode_tokens(p, view, tokens, cfg, pt=pt_row,
                                 n_valid=n_valid)
    return logits[:, n_valid - 1], merge_slot(caches, view, slot)
