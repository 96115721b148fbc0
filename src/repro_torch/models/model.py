"""The decoder LMs (dense with sliding-window attention included, MoE, and
VLM: a dense backbone whose prompt may be precomputed embeddings), the
Mamba-2 LM and the Zamba-2 hybrid: init, forward, prefill and decode entry
points, and the per-slot and paged cache helpers the serving engines use.

Params are a nested dict of tensors with ``repro``'s tree, leaf names and
layouts (``nn.unwrap(init_lm(...))``), per-layer leaves stacked on axis 0
(a hybrid's groups on two axes, see :func:`param_shapes`).  The layer stack
is a Python loop over per-layer views.  The JAX package keeps params in
float32 and casts each weight to ``cfg.dtype`` at every use; the port
stores every weight in the compute dtype once, at load, which gives the
same values and halves the weight memory in bf16.  Norm gains stay
float32: RMSNorm casts its gain to float32, so storing them rounded would
change the result.  The same holds for the SSM leaves the reference reads
in float32 (``ssm.F32_LEAVES``) and for an MoE router, whose product the
reference runs in float32.

Cache layouts, written out (``repro`` finds them structurally with
``jax.eval_shape``), with B the prefill batch or the serving slots:

* dense, moe, vlm: ``k``/``v`` (L, B | P, S | ps, Hkv, D) in the compute
  dtype and ``len`` int32 — (L,) from :func:`prefill`, (L, slots) for the
  serving caches.  A sliding-window model's S is ``kv_cache_len`` =
  min(max_len, window): a ring in which position p sits at slot p % S,
  filled by a longer prompt with its last S positions.  It is never
  paged;
* ssm: ``conv`` (L, B, W-1, C) in the compute dtype and ``ssd`` (L, B, H,
  N, P) float32, with no ``len`` and no paged store;
* hybrid: ``mamba.conv`` (G, g, B, W-1, C) and ``mamba.ssd`` (G, g, B, H,
  N, P) for the groups' blocks, ``attn`` the shared block's dense K/V per
  group (G, B, S, Hkv, D) with ``len`` (G,) | (G, slots), and
  ``trailing.conv``/``trailing.ssd`` in the ssm layout when n_layers %
  hybrid_group > 0.  Never paged.

The decode paths update caches in place where the JAX package donates
them, and return the same dict.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import blocks
from repro_torch.models import modules as nn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]
#: leaves that hold RMSNorm gains (kept in float32)
NORM_LEAVES = ("ln1", "ln2", "ln", "ln_f", "q_norm", "k_norm")
#: every leaf kept in float32
F32_LEAVES = NORM_LEAVES + ssm.F32_LEAVES + ("router",)
#: the attention families: K/V caches, paged serving, ``decode_tokens``
ATTENTION_FAMILIES = ("dense", "moe", "vlm")
#: a stacked leaf with more elements than this is drawn one slice of its
#: leading axis at a time (4 GiB in float32), so init never holds a
#: full-width float32 copy of a large leaf
DRAW_WHOLE = 2 ** 30


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
def _decoder_shapes(cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    """A decoder block's leaves, each with the leading axes ``lead``."""
    d, hd = cfg.d_model, cfg.hd
    attn = {"wq": (d, cfg.n_heads, hd), "wk": (d, cfg.n_kv_heads, hd),
            "wv": (d, cfg.n_kv_heads, hd), "wo": (cfg.n_heads, hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = (hd,)
        attn["k_norm"] = (hd,)
    if cfg.family == "moe":
        ffn = moe.moe_shapes(cfg)
    elif cfg.mlp_type in ("swiglu", "geglu"):
        ffn = {"w_down": (cfg.d_ff, d), "w_gate": (d, cfg.d_ff),
               "w_up": (d, cfg.d_ff)}
    elif cfg.mlp_type == "gelu":
        ffn = {"w_down": (cfg.d_ff, d), "w_up": (d, cfg.d_ff)}
    else:
        raise ValueError(cfg.mlp_type)
    block = {"ln1": (d,), "attn": attn, "ln2": (d,), "ffn": ffn}
    return map_params(lambda _, shape: lead + shape, block)


def _mamba_shapes(cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    """A mamba block's leaves, each with the leading axes ``lead``."""
    block = {"ln": (cfg.d_model,), "mixer": ssm.mixer_shapes(cfg)}
    return map_params(lambda _, shape: lead + shape, block)


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The param tree's leaf shapes, as the reference's ``init_lm`` lays
    them out: ``blocks`` stacked on a layer axis (dense, ssm); a hybrid's
    ``groups`` on (n_groups, hybrid_group), the one ``shared_attn``
    decoder block with no layer axis, and ``trailing`` mamba blocks on
    (n_layers % hybrid_group,) when there are any.  A moe layer's ``ffn``
    is ``moe.moe_shapes``; a vlm's tree is the dense one."""
    n, d = cfg.n_layers, cfg.d_model
    top = {"embed": (cfg.vocab, d), "ln_f": (d,), "lm_head": (d, cfg.vocab)}
    if cfg.family == "ssm":
        return {**top, "blocks": _mamba_shapes(cfg, (n,))}
    if cfg.family == "hybrid":
        n_groups, trailing = divmod(n, cfg.hybrid_group)
        tree = {**top,
                "groups": _mamba_shapes(cfg, (n_groups, cfg.hybrid_group)),
                "shared_attn": _decoder_shapes(cfg, ())}
        if trailing:
            tree["trailing"] = _mamba_shapes(cfg, (trailing,))
        return tree
    return {**top, "blocks": _decoder_shapes(cfg, (n,))}


def map_params(fn, shapes: dict[str, Any], path: tuple[str, ...] = ()):
    """Build a param tree from ``fn(path, shape)`` over :func:`param_shapes`."""
    return {k: map_params(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in shapes.items()}


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> Params:
    """Random weights from ``seed``, with ``repro``'s init scales: normal
    times 1 (embed), d**-0.5 (lm_head, wq, wk, wv, w_gate, w_up, router),
    (n_heads*hd)**-0.5 (wo), d_ff**-0.5 (w_down); norm gains are ones; the
    ssm mixer's as ``ssm.INIT`` says.  Each leaf is allocated in its
    stored dtype and drawn in float32, a stacked leaf past
    :data:`DRAW_WHOLE` elements one slice of its leading axis at a time."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = compute_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    # the fan-in each normal weight is scaled by (its ** -0.5)
    fan_in = {"embed": 1, "lm_head": d, "wq": d, "wk": d, "wv": d,
              "wo": cfg.n_heads * cfg.hd, "w_gate": d, "w_up": d,
              "w_down": cfg.d_ff, "router": d}

    def draw(out: torch.Tensor, scale: float) -> torch.Tensor:
        if out.dim() > 2 and out.numel() > DRAW_WHOLE:
            for part in out.unbind(0):
                draw(part, scale)
        else:
            out.copy_(torch.randn(out.shape, generator=gen,
                                  device=dev).mul_(scale))
        return out

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
        return draw(torch.empty(shape, dtype=torch.float32
                                if name in F32_LEAVES else dt, device=dev),
                    scale)

    return map_params(make, param_shapes(cfg))


def _embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"][tokens.long()].to(compute_dtype(cfg))


def embed_inputs(p: Params, inputs: dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """The first layer's input: ``inputs['embeds']`` (B, S, d) for an
    embeddings-mode model (a VLM's precomputed patch and text embeddings)
    that is given them, else the token embeddings."""
    if cfg.input_mode == "embeddings" and "embeds" in inputs:
        return inputs["embeds"].to(compute_dtype(cfg))
    return _embed(p, inputs["tokens"], cfg)


def _logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    return nn.dense(p["lm_head"], x, x.dtype)


# ============================================================== forward
def hybrid_flags(cfg: ModelConfig) -> list[bool]:
    """Whether each group runs the shared block: group i does when
    ``i % hybrid_attn_every == hybrid_attn_every - 1``."""
    every = cfg.hybrid_attn_every
    return [i % every == every - 1
            for i in range(cfg.n_layers // cfg.hybrid_group)]


def _sum_aux(auxes: list[dict], device: torch.device) -> dict:
    """The layers' aux losses summed, as float32 scalars on ``device``."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {k: sum((a[k] for a in auxes), zero) for k in moe.AUX_KEYS}


def forward(p: Params, inputs: dict[str, torch.Tensor], cfg: ModelConfig):
    """Eval forward over ``inputs['tokens']`` (B, S) (or an embeddings-mode
    model's ``inputs['embeds']``) -> (logits, aux): aux the MoE layers'
    losses summed over layers, zeros for every other family."""
    x = embed_inputs(p, inputs, cfg)
    auxes = []
    if cfg.family == "ssm":
        x, _ = blocks.mamba_stack(p["blocks"], x, cfg)
    elif cfg.family == "hybrid":
        groups = blocks.layer_views(p["groups"])
        for gp, flag in zip(groups, hybrid_flags(cfg)):
            x, _, _ = blocks.hybrid_group(gp, p["shared_attn"], x, cfg, flag)
        if "trailing" in p:
            x, _ = blocks.mamba_stack(p["trailing"], x, cfg)
    else:
        for lp in blocks.layer_views(p["blocks"]):
            x, aux, _ = blocks.decoder_block(lp, x, cfg, causal=True)
            auxes.append(aux)
    x = nn.rmsnorm_apply(p["ln_f"], x)
    return _logits(p, x), _sum_aux(auxes, x.device)


# ============================================================ prefill / decode
def kv_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Positions a KV cache holds: ``max_len``, or a sliding-window model's
    ring of at most ``window``."""
    return min(max_len, cfg.window) if cfg.window else max_len


def _kv_caches(n: int, b: int, s: int, max_len: int, cfg: ModelConfig,
               like: torch.Tensor) -> dict[str, torch.Tensor]:
    """Zero K/V caches for ``n`` layers of a batch-``b`` prefill of ``s``
    tokens, with ``len`` = s."""
    m = kv_cache_len(cfg, max_len)
    if s > m and cfg.window is None:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    shape = (n, b, m, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=like.dtype, device=like.device),
            "v": torch.zeros(shape, dtype=like.dtype, device=like.device),
            "len": torch.full((n,), s, dtype=torch.int32,
                              device=like.device)}


def _put_kv(caches: dict[str, torch.Tensor], i: int,
            cache: dict[str, torch.Tensor]) -> None:
    """Write layer ``i``'s prefill K/V (B, S, H, D) into its cache rows.  A
    prompt longer than the cache (a sliding-window ring) keeps its last
    ``size`` positions, rolled so that position p sits at slot p % size."""
    size = caches["k"].shape[2]
    for name in ("k", "v"):
        kv = cache[name]
        s = kv.shape[1]
        if s > size:
            kv = torch.roll(kv[:, s - size:], s % size, dims=1)
        caches[name][i, :, :kv.shape[1]] = kv


def prefill(p: Params, inputs: dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: int):
    """Forward over the prompt, building decode caches sized ``max_len``
    (a sliding-window model's: ``kv_cache_len``).  Returns
    (last_token_logits, caches).  An ssm model's caches are its per-layer
    conv and SSD states, whatever ``max_len``; a hybrid's are its groups'
    states (``mamba``), the shared block's K/V per group (``attn``) and the
    trailing blocks' states (``trailing``).  An embeddings-mode model given
    ``inputs['embeds']`` prefills from them (see :func:`embed_inputs`), and
    an MoE prefill is not dropless."""
    x = embed_inputs(p, inputs, cfg)
    b, s, _ = x.shape
    if cfg.family == "ssm":
        x, caches = blocks.mamba_stack(p["blocks"], x, cfg,
                                       return_state=True)
    elif cfg.family == "hybrid":
        flags = hybrid_flags(cfg)
        kv = _kv_caches(len(flags), b, s, max_len, cfg, x)
        states = []
        groups = blocks.layer_views(p["groups"])
        for i, (gp, flag) in enumerate(zip(groups, flags)):
            x, st, cache = blocks.hybrid_group(gp, p["shared_attn"], x, cfg,
                                               flag, return_state=True)
            states.append(st)
            _put_kv(kv, i, cache)
        caches = {"mamba": {k: torch.stack([st[k] for st in states])
                            for k in states[0]}, "attn": kv}
        if "trailing" in p:
            x, caches["trailing"] = blocks.mamba_stack(
                p["trailing"], x, cfg, return_state=True)
    else:
        layers = blocks.layer_views(p["blocks"])
        caches = _kv_caches(len(layers), b, s, max_len, cfg, x)
        for i, lp in enumerate(layers):
            x, _, cache = blocks.decoder_block(lp, x, cfg, causal=True,
                                               return_cache=True)
            _put_kv(caches, i, cache)
    x = nn.rmsnorm_apply(p["ln_f"], x[:, -1:])
    return _logits(p, x)[:, 0], caches


def decode_step(p: Params, caches, tokens: torch.Tensor, cfg: ModelConfig, *,
                pt: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """One decode step.  tokens: (B,) -> (logits (B, vocab), caches).

    ``pt`` (B, n_pages) routes cache traffic through a paged store (see
    :func:`alloc_paged_caches`); ``active`` (B,) masks rows that must neither
    write real pages nor advance (idle slots, slots mid chunked prefill) —
    their scatters land in the trash page.  An ssm or hybrid model takes
    neither: its caches are dense per-slot states and K/V, advanced in
    place."""
    if cfg.family in ATTENTION_FAMILIES:
        logits, caches = decode_tokens(p, caches, tokens[:, None], cfg,
                                       pt=pt, active=active)
        return logits[:, 0], caches
    if pt is not None:
        raise ValueError(f"paged decode supports attention families "
                         f"(dense/moe/vlm), not {cfg.family!r}")
    x = _embed(p, tokens[:, None], cfg)
    if cfg.family == "ssm":
        x, _ = blocks.mamba_stack(p["blocks"], x, cfg, states=caches)
    else:
        kv = caches["attn"]
        groups = zip(blocks.layer_views(p["groups"]),
                     blocks.layer_views(caches["mamba"]), hybrid_flags(cfg))
        for i, (gp, states, flag) in enumerate(groups):
            cache = {"k": kv["k"][i], "v": kv["v"][i], "len": kv["len"][i]}
            x, _, new = blocks.hybrid_group(
                gp, p["shared_attn"], x, cfg, flag, states=states,
                attn_cache=cache, pos_offset=cache["len"])
            kv["len"][i] = new["len"]   # k/v were written in place
        if "trailing" in p:
            x, _ = blocks.mamba_stack(p["trailing"], x, cfg,
                                      states=caches["trailing"])
    x = nn.rmsnorm_apply(p["ln_f"], x)
    return _logits(p, x)[:, 0], caches


def decode_tokens(p: Params, caches, tokens: torch.Tensor, cfg: ModelConfig,
                  *, pt: torch.Tensor | None = None,
                  active: torch.Tensor | None = None,
                  n_valid: int | None = None,
                  embeds: torch.Tensor | None = None):
    """Cache-advancing forward of an attention family over ``tokens`` (B,
    S) -> (logits (B, S, vocab), caches).

    S == 1 is the lockstep decode step; S > 1 is a chunked-prefill step.
    The paged routing keys go into each layer's cache dict for
    ``attention``'s paged branch: ``pt`` (B, n_pages) int32 page tables,
    ``active`` (B,) bool rows that may write real pages and advance, and
    ``n_valid`` — how many of the S positions are real (a padded final
    chunk advances ``len`` by n_valid).  ``embeds`` (B, S, d) replaces the
    token embeddings (a VLM prompt's chunk).  MoE layers are dropless
    here."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"decode_tokens supports attention families "
                         f"(dense/moe/vlm), not {cfg.family!r}")
    x = embeds.to(compute_dtype(cfg)) if embeds is not None \
        else _embed(p, tokens, cfg)
    lens = caches["len"]
    for i, lp in enumerate(blocks.layer_views(p["blocks"])):
        cache = {"k": caches["k"][i], "v": caches["v"][i], "len": lens[i]}
        if pt is not None:
            cache["pt"] = pt
            if active is not None:
                cache["active"] = active
            if n_valid is not None:
                cache["n_valid"] = n_valid
        x, _, new = blocks.decoder_block(lp, x, cfg, causal=True,
                                         pos_offset=cache["len"],
                                         cache=cache)
        lens[i] = new["len"]        # in place: k/v were written in place too
    x = nn.rmsnorm_apply(p["ln_f"], x)
    return _logits(p, x), caches


# ============================================== per-slot caches (cont. batching)
# The continuous-batching engine keeps a fixed-capacity decode batch whose
# slots hold independent requests.  A request is prefilled alone (or with a
# same-length group) and its cache is spliced into its slot; ``len`` becomes
# a per-slot (L, capacity) tensor so masks and rope run at each slot's own
# offset.

def _slot_axis(path: tuple[str, ...]) -> int | None:
    """The batch axis of the serving cache leaf at ``path``: 2 for a
    hybrid group's states (behind the group and member axes), 1 for every
    other leaf; None for a ``len``, whose slot axis is its last."""
    if path[-1] == "len":
        return None
    return 2 if path[0] == "mamba" else 1


def _leaves(tree, path: tuple[str, ...] = ()):
    """(path, leaf) over a cache tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def alloc_slot_caches(cfg: ModelConfig, capacity: int, max_len: int, *,
                      device: str | torch.device) -> dict[str, Any]:
    """Zero decode caches for ``capacity`` slots of ``max_len`` positions:
    the tree :func:`prefill` returns, batch ``capacity`` on each leaf's
    :func:`_slot_axis`, and a ``len`` per layer and slot.  A sliding-window
    model's K/V hold ``kv_cache_len`` positions; mamba states do not depend
    on ``max_len``."""
    dt, dev = compute_dtype(cfg), torch.device(device)

    def states(lead):
        st = ssm.init_mamba_state(cfg, capacity, dt, dev)
        return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                               device=dev) for k, v in st.items()}

    def kv(n):
        shape = (n, capacity, kv_cache_len(cfg, max_len), cfg.n_kv_heads,
                 cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "len": torch.zeros((n, capacity), dtype=torch.int32,
                                   device=dev)}

    if cfg.family == "ssm":
        return states((cfg.n_layers,))
    if cfg.family == "hybrid":
        n_groups, trailing = divmod(cfg.n_layers, cfg.hybrid_group)
        caches = {"mamba": states((n_groups, cfg.hybrid_group)),
                  "attn": kv(n_groups)}
        if trailing:
            caches["trailing"] = states((trailing,))
        return caches
    return kv(cfg.n_layers)


def insert_slots(caches, group_caches, slots: torch.Tensor):
    """Splice a batch-G prefill cache into slots ``slots`` ((G,) ints) in
    place — one scatter per leaf, on its :func:`_slot_axis`.  The group
    shares one prompt length."""
    slots = slots.long()
    for path, leaf in _leaves(caches):
        grp = _at(group_caches, path)
        ax = _slot_axis(path)
        if ax is None:
            leaf[:, slots] = grp[:, None].to(leaf.dtype)
        else:
            leaf.index_copy_(ax, slots, grp.to(leaf.dtype))
    return caches


def evict_slot(caches, slot: int):
    """Invalidate slot ``slot``: zero its lengths so attention sees an empty
    prefix.  State leaves (k/v rows, ssm states) are left in place: the next
    insert into the slot overwrites them wholesale."""
    for path, leaf in _leaves(caches):
        if _slot_axis(path) is None:
            leaf[:, slot] = 0
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
                  cfg: ModelConfig, embeds: torch.Tensor | None = None):
    """One chunked-prefill step for one slot over the paged cache.

    ``tokens`` (1, chunk) is the next prompt chunk, zero-padded past
    ``n_valid`` on the final chunk (``embeds`` (1, chunk, d), when given,
    in their place, padded alike); ``pt_row`` (1, n_pages) is the slot's
    page table.  Returns the logits at the last valid position ((1, vocab),
    only meaningful on the final chunk) and the updated caches."""
    view = slot_view(caches, slot)
    logits, view = decode_tokens(p, view, tokens, cfg, pt=pt_row,
                                 n_valid=n_valid, embeds=embeds)
    return logits[:, n_valid - 1], merge_slot(caches, view, slot)
