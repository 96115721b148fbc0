"""The decoder LMs (dense with sliding-window attention included, MoE, and
VLM: a dense backbone whose prompt may be precomputed embeddings), the
Mamba-2 LM, the Zamba-2 hybrid and the encoder-decoder (its encoder input
is precomputed frame embeddings): init, forward, loss, prefill and decode
entry points, and the per-slot and paged cache helpers the serving engines
use.

Params are a nested dict of tensors with ``repro``'s tree, leaf names and
layouts (``nn.unwrap(init_lm(...))``), per-layer leaves stacked on axis 0
(a hybrid's groups on two axes, see :func:`param_shapes`).  The layer stack
is a Python loop over per-layer views.  The JAX package keeps params in
float32 and casts each weight to ``cfg.dtype`` at every use; the port
stores every weight in the compute dtype once, at load, which gives the
same values and halves the weight memory in bf16.  Training keeps
float32 master weights instead (``init_lm(..., dtype=torch.float32)``),
which every use casts to the compute dtype as the reference does.  Norm
gains stay float32: RMSNorm casts its gain to float32, so storing them
rounded would change the result.  The same holds for the SSM leaves the reference reads
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
  hybrid_group > 0.  Never paged;
* enc_dec: ``self`` the decoder's K/V in the dense layout with L =
  dec_layers, and ``cross`` the cross-attention K/V ``k``/``v`` (L, B, T,
  Hkv, D) of the T encoder frames, with no ``len`` (the reference's is a
  (k, v) tuple).  Never paged.

The decode paths update caches in place where the JAX package donates
them, and return the same dict.

The serving entry points (:func:`prefill`, :func:`decode_step`,
:func:`decode_tokens`, :func:`prefill_chunk`) read every param through
``dist.partition``'s hooks, a layer at a time: on a GSPMD-path serving
rank (inside ``partition.materialising``) they gather the layer's param
and cache blocks whole before it runs and keep the rank's block of each
cache it wrote, except what the layout's split computes as blocks (an
SSM mixer's heads, a hybrid's shared attention and MLP: ``models/ssm.py``;
an encoder-decoder's attention and MLP, its self and cross K/V),
and the logits come from the rank's columns of ``lm_head``, gathered;
elsewhere the hooks hand the tensors back as they are.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist import partition
from repro_torch.dist import tp
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models import modules as nn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]
#: leaves that hold RMSNorm gains (kept in float32)
NORM_LEAVES = ("ln1", "ln2", "ln", "ln_f", "q_norm", "k_norm", "ln_x",
               "enc_ln", "dec_ln")
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
def _decoder_shapes(cfg: ModelConfig, lead: tuple[int, ...],
                    cross: bool = False) -> dict:
    """A decoder block's leaves, each with the leading axes ``lead``; with
    ``cross``, an encoder-decoder's ``ln_x`` and ``xattn`` besides.  ``wq``
    and ``wo`` hold ``attention.phys_heads`` heads."""
    d, hd, ph = cfg.d_model, cfg.hd, attn_mod.phys_heads(cfg)
    attn = {"wq": (d, ph, hd), "wk": (d, cfg.n_kv_heads, hd),
            "wv": (d, cfg.n_kv_heads, hd), "wo": (ph, hd, d)}
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
    if cross:
        block.update(ln_x=(d,), xattn=dict(attn))
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
    is ``moe.moe_shapes``; a vlm's tree is the dense one.  An enc_dec
    model has ``enc_blocks``, ``enc_ln``, ``dec_embed``, ``dec_blocks``
    (with ``ln_x`` and ``xattn``), ``dec_ln`` and ``lm_head``, and no
    ``embed`` or ``ln_f``."""
    n, d = cfg.n_layers, cfg.d_model
    if cfg.family == "enc_dec":
        return {"enc_blocks": _decoder_shapes(cfg, (cfg.enc_layers,)),
                "enc_ln": (d,), "dec_embed": (cfg.vocab, d),
                "dec_blocks": _decoder_shapes(cfg, (cfg.dec_layers,),
                                              cross=True),
                "dec_ln": (d,), "lm_head": (d, cfg.vocab)}
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


#: each leaf's logical axes behind its layer axes, as the reference's
#: ``nn.param`` calls name them (``repro.models``: attention, mlp, ssm)
_LEAF_AXES = {
    "embed": ("vocab", "embed"), "dec_embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"), "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
    "wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads",
                                                 "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim",
                                                    "embed"),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "in_proj": ("embed", "ssm_inner"), "conv_w": (None, "conv_ch"),
    "conv_b": ("conv_ch",), "A_log": ("ssm_heads",), "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",), "norm": ("ssm_inner",),
    "out_proj": ("ssm_inner", "embed"),
    **dict.fromkeys(("ln1", "ln2", "ln", "ln_f", "ln_x", "enc_ln", "dec_ln"),
                    ("embed",)),
}
#: an MoE layer's ``ffn`` leaves (the reference's ``init_moe``)
_MOE_AXES = {"router": ("embed", "experts"),
             "w_gate": ("experts", "embed", "mlp"),
             "w_up": ("experts", "embed", "mlp"),
             "w_down": ("experts", "mlp", "embed")}


def param_logical_axes(cfg: ModelConfig) -> dict[str, Any]:
    """The logical axes of every param leaf, the tree of
    :func:`param_shapes` with a tuple of axis names at each leaf: the
    reference's ``param_logical_axes``, leaf for leaf.  Stacked layer axes
    are ``"layers"`` (a hybrid's groups have two)."""
    def axes(path, shape):
        moe_leaf = cfg.family == "moe" and "ffn" in path
        base = (_MOE_AXES if moe_leaf else _LEAF_AXES)[path[-1]]
        return ("layers",) * (len(shape) - len(base)) + base

    return map_params(axes, param_shapes(cfg))


def cache_logical_axes(cfg: ModelConfig) -> dict[str, Any]:
    """The logical axes of every leaf of the caches :func:`prefill` returns
    (the module docstring's layouts), the reference's
    ``cache_logical_axes`` leaf for leaf (an encoder-decoder's ``cross``
    is a ``{'k', 'v'}`` dict here, a ``(k, v)`` tuple there).  Under
    tensor-parallel serving only ``kv_heads`` shards."""
    x = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    kv = {"k": x, "v": x, "len": ("layers",)}
    ssm_ = {"conv": (None, "batch", None, "conv_ch"),
            "ssd": (None, "batch", "ssm_heads", "ssm_state", None)}
    if cfg.family in ATTENTION_FAMILIES:
        return kv
    if cfg.family == "ssm":
        return ssm_
    if cfg.family == "hybrid":
        out = {"mamba": {k: (None,) + v for k, v in ssm_.items()},
               "attn": kv}
        if cfg.n_layers % cfg.hybrid_group:
            out["trailing"] = ssm_
        return out
    if cfg.family == "enc_dec":
        return {"self": kv, "cross": {"k": x, "v": x}}
    raise ValueError(cfg.family)


def serve_cache_axes(cfg: ModelConfig) -> dict[str, Any]:
    """:func:`cache_logical_axes` adapted to the serving caches
    (:func:`alloc_slot_caches`, :func:`alloc_paged_caches`): each ``len``
    gains its trailing slot axis, replicated; a paged store keeps the
    5-axis tuple, its page axis where ``batch`` was."""
    def adapt(tree):
        return {k: adapt(v) if isinstance(v, dict)
                else v + (None,) if k == "len" else v
                for k, v in tree.items()}
    return adapt(cache_logical_axes(cfg))


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda",
            dtype: torch.dtype | None = None,
            keep: Callable[[tuple[str, ...], torch.Tensor], torch.Tensor]
            | None = None) -> Params:
    """Random weights from ``seed``, with ``repro``'s init scales: normal
    times 1 (embed, dec_embed), d**-0.5 (lm_head, wq, wk, wv, w_gate, w_up,
    router), (n_heads*hd)**-0.5 (wo), d_ff**-0.5 (w_down); norm gains are
    ones; the ssm mixer's as ``ssm.INIT`` says; a padded config's extra
    heads' ``wq`` and ``wo`` slices are zero.  Weights are stored in
    ``dtype`` (default: the compute dtype, which serving keeps; training
    keeps ``cfg.param_dtype``, float32 master weights, and every use casts
    to the compute dtype as the reference does); :data:`F32_LEAVES` stay
    float32.  Each leaf is allocated in its stored dtype and drawn in
    float32, a stacked leaf past :data:`DRAW_WHOLE` elements one slice of
    its leading axis at a time.  ``keep(path, leaf)``, when given, replaces
    each whole leaf as soon as it is drawn (a rank of a mesh keeps its
    shard), so the draws, and the weights, are those of the whole model."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    # the fan-in each normal weight is scaled by (its ** -0.5)
    fan_in = {"embed": 1, "dec_embed": 1, "lm_head": d, "wq": d, "wk": d,
              "wv": d, "wo": cfg.n_heads * cfg.hd, "w_gate": d, "w_up": d,
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
        out = draw(torch.empty(shape, dtype=torch.float32
                               if name in F32_LEAVES else dt, device=dev),
                   scale)
        if name in ("wq", "wo"):        # zero the padded heads' slices
            heads = out.movedim(-2 if name == "wq" else -3, 0)
            heads[cfg.n_heads:] = 0
        return out

    if keep is None:
        return map_params(make, param_shapes(cfg))
    return map_params(lambda path, shape: keep(path, make(path, shape)),
                      param_shapes(cfg))


def _embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings (an encoder-decoder's decoder's: ``dec_embed``).
    Under a training scope that cuts the vocab, the table is this rank's
    rows: each id is looked up by the rank that holds it and the lookups
    are summed over the ranks (the vocab-parallel embedding)."""
    name = "dec_embed" if cfg.family == "enc_dec" else "embed"
    part = tp.model_part("vocab")
    if part is None:
        return partition.take(p[name], tokens.long(),
                              name).to(compute_dtype(cfg))
    table = p[name]
    ids, inside = _vocab_ids(tokens, table.shape[0], part)
    x = table[ids].to(compute_dtype(cfg))
    return tp.tp_allreduce(torch.where(inside[..., None], x, 0), "vocab")


def _vocab_ids(ids: torch.Tensor, rows: int, part: tuple[int, int]):
    """(``ids`` as rows of rank ``part[0]``'s block of ``rows`` vocab
    entries, clamped into it; whether each id lies in the block)."""
    local = ids.long() - part[0] * rows
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def embed_inputs(p: Params, inputs: dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """The first layer's input: ``inputs['embeds']`` (B, S, d) for an
    embeddings-mode model (a VLM's precomputed patch and text embeddings)
    that is given them, else the token embeddings."""
    if cfg.input_mode == "embeddings" and "embeds" in inputs:
        return inputs["embeds"].to(compute_dtype(cfg))
    return _embed(p, inputs["tokens"], cfg)


def _logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The vocab projection (a rank's columns under a training scope that
    cuts the vocab; on a GSPMD serving rank, its block of ``lm_head``'s
    columns and then the logits' columns gathered)."""
    x = tp.tp_enter(x, "vocab")
    return partition.by_columns(lambda w: nn.dense(w, x, x.dtype),
                                p["lm_head"], "lm_head")


def _norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """The top-level RMSNorm ``name`` (``ln_f``, ``enc_ln``, ``dec_ln``)."""
    return nn.rmsnorm_apply(partition.whole(p[name], name), x)


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


def _encode(p: Params, inputs: dict[str, torch.Tensor], cfg: ModelConfig):
    """An encoder-decoder's encoder over ``inputs['enc_embeds']`` (B, T, d):
    its blocks run bidirectionally -> (normed output, the blocks' aux)."""
    enc = inputs["enc_embeds"].to(compute_dtype(cfg))
    auxes = []
    layer = blocks.remat(blocks.decoder_block, cfg)
    for lp in blocks.layer_views(p["enc_blocks"]):
        enc, aux, _ = layer(partition.whole(lp, "enc_blocks"), enc, cfg,
                            causal=False)
        auxes.append(aux)
    return _norm(p, "enc_ln", enc), auxes


def _cross_layer(lp, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig):
    """An encoder-decoder's decoder layer: its cross K/V from ``enc``, then
    the block (the reference's scan body, one remat unit)."""
    x, aux, _ = blocks.decoder_block(
        lp, x, cfg, causal=True,
        cross_kv=attn_mod.encode_kv(lp["xattn"], enc, cfg))
    return x, aux


def forward(p: Params, inputs: dict[str, torch.Tensor], cfg: ModelConfig):
    """Training/eval forward over ``inputs['tokens']`` (B, S) (or an
    embeddings-mode model's ``inputs['embeds']``; an enc_dec model's
    decoder tokens beside its ``inputs['enc_embeds']``) -> (logits, aux):
    aux the MoE layers' losses summed over layers, zeros for every other
    family.  Under grad each layer runs under ``blocks.remat`` (one unit a
    layer, a hybrid's a group, as the reference's scan bodies).  Under a
    training scope that cuts the vocab (``dist.tp.training``) the logits
    are this rank's vocab columns."""
    if cfg.family == "enc_dec":
        enc, auxes = _encode(p, inputs, cfg)
        # every decoder layer projects its rank's cross K/V heads from
        # ``enc``: one seam sums their partial gradients over "model"
        enc = tp.tp_enter(enc, "attn")
        x = _embed(p, inputs["tokens"], cfg)
        layer = blocks.remat(_cross_layer, cfg)
        for lp in blocks.layer_views(p["dec_blocks"]):
            x, aux = layer(lp, x, enc, cfg)
            auxes.append(aux)
        x = nn.rmsnorm_apply(p["dec_ln"], x)
        return _logits(p, x), _sum_aux(auxes, x.device)
    x = embed_inputs(p, inputs, cfg)
    auxes = []
    if cfg.family == "ssm":
        x, _ = blocks.mamba_stack(p["blocks"], x, cfg, remat_each=True)
    elif cfg.family == "hybrid":
        groups = blocks.layer_views(p["groups"])
        layer = blocks.remat(blocks.hybrid_group, cfg)
        for gp, flag in zip(groups, hybrid_flags(cfg)):
            x, _, _ = layer(gp, p["shared_attn"], x, cfg, flag)
        if "trailing" in p:
            x, _ = blocks.mamba_stack(p["trailing"], x, cfg, remat_each=True)
    else:
        layer = blocks.remat(blocks.decoder_block, cfg)
        for lp in blocks.layer_views(p["blocks"]):
            x, aux, _ = layer(lp, x, cfg, causal=True)
            auxes.append(aux)
    x = nn.rmsnorm_apply(p["ln_f"], x)
    return _logits(p, x), _sum_aux(auxes, x.device)


# ===================================================================== loss
def loss_fn(p: Params, batch: dict[str, torch.Tensor], cfg: ModelConfig, *,
            denom: torch.Tensor | None = None, share: float = 1.0):
    """-> (total, metrics): the masked mean token cross-entropy over float32
    logits (the mask's sum clamped at 1) plus the aux losses, and the
    metrics ``loss``, ``aux/load_balance`` and ``aux/router_z``.
    ``cfg.logits_microbatch > 1`` takes the cross-entropy over that many
    chunks of the sequence, as the reference does.

    For a slice of a larger batch (a data-parallel rank's rows): ``denom``
    is the whole batch's token count (its mask's sum, clamped at 1) and
    ``share`` the slice's share of the batch's rows; the loss divides the
    slice's token sum by ``denom`` and the aux losses are scaled by
    ``share``, so each term and metric summed over the slices is the whole
    batch's."""
    logits, aux = forward(p, batch, cfg)
    mask = batch.get("mask")
    token_loss = token_losses(logits.float(), batch["labels"].long(), cfg)
    if denom is not None:
        loss = (token_loss if mask is None else token_loss * mask).sum() \
            / denom
    elif mask is not None:
        loss = (token_loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = token_loss.mean()
    if share != 1.0:
        aux = {k: v * share for k, v in aux.items()}
    total = loss + sum(aux.values())
    metrics = {"loss": loss, **{f"aux/{k}": v for k, v in aux.items()}}
    return total, metrics


def token_losses(logits_f32: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Each token's cross-entropy (B, S) from float32 logits, over
    ``cfg.logits_microbatch`` chunks of the sequence when it is above 1
    (vocab-parallel under a training scope that cuts the vocab: see
    :func:`_xent`)."""
    if cfg.logits_microbatch <= 1:
        return _xent(logits_f32, labels)
    s = labels.shape[1]
    if s % cfg.logits_microbatch:
        raise ValueError(f"logits_microbatch {cfg.logits_microbatch} "
                         f"does not divide the sequence length {s}")
    return torch.cat(
        [_xent(lf_c, l_c) for lf_c, l_c in zip(
            logits_f32.chunk(cfg.logits_microbatch, dim=1),
            labels.chunk(cfg.logits_microbatch, dim=1))], dim=1)


def _xent(logits_f32: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's cross-entropy.  Under a training scope that cuts the
    vocab, ``logits_f32`` are this rank's columns and the loss is the
    vocab-parallel one: the max over every rank's columns (no gradient),
    the sum of exponentials and the gold logit (the rank that holds it
    gives it) each summed over the ranks."""
    part = tp.model_part("vocab")
    if part is None:
        lse = torch.logsumexp(logits_f32, dim=-1)
        gold = torch.gather(logits_f32, -1, labels[..., None])[..., 0]
        return lse - gold
    top = tp.model_max(logits_f32.detach().amax(dim=-1), "vocab")
    sumexp = tp.tp_allreduce(
        torch.exp(logits_f32 - top[..., None]).sum(dim=-1), "vocab")
    ids, inside = _vocab_ids(labels, logits_f32.shape[-1], part)
    gold = torch.gather(logits_f32, -1, ids[..., None])[..., 0]
    gold = tp.tp_allreduce(torch.where(inside, gold, 0.0), "vocab")
    return top + torch.log(sumexp) - gold


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
    an MoE prefill is not dropless.  An enc_dec model runs its encoder over
    ``inputs['enc_embeds']``, projects each decoder layer's cross K/V from
    it once (``cross``) and prefills the decoder's caches (``self``)."""
    if cfg.family == "enc_dec":
        return _prefill_enc_dec(p, inputs, cfg, max_len)
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
        shared = partition.whole(p["shared_attn"], "shared_attn")
        for i, (gp, flag) in enumerate(zip(groups, flags)):
            x, st, cache = blocks.hybrid_group(gp, shared, x, cfg,
                                               flag, return_state=True)
            states.append(st)
            _put_kv(kv, i, cache)
        caches = {"mamba": {k: torch.stack([st[k] for st in states])
                            for k in states[0]}, "attn": kv}
        if "trailing" in p:
            x, caches["trailing"] = blocks.mamba_stack(
                p["trailing"], x, cfg, return_state=True, path=("trailing",))
    else:
        layers = blocks.layer_views(p["blocks"])
        caches = _kv_caches(len(layers), b, s, max_len, cfg, x)
        for i, lp in enumerate(layers):
            x, _, cache = blocks.decoder_block(
                partition.whole(lp, "blocks"), x, cfg, causal=True,
                return_cache=True)
            _put_kv(caches, i, cache)
    x = _norm(p, "ln_f", x[:, -1:])
    return _logits(p, x)[:, 0], caches


def _prefill_enc_dec(p: Params, inputs: dict[str, torch.Tensor],
                     cfg: ModelConfig, max_len: int):
    enc, _ = _encode(p, inputs, cfg)
    x = _embed(p, inputs["tokens"], cfg)
    b, s, _ = x.shape
    layers = blocks.layer_views(p["dec_blocks"])
    kv = _kv_caches(len(layers), b, s, max_len, cfg, x)
    shape = (len(layers),) + enc.shape[:2] + (cfg.n_kv_heads, cfg.hd)
    cross = {k: torch.empty(shape, dtype=x.dtype, device=x.device)
             for k in ("k", "v")}
    for i, lp in enumerate(layers):
        lp = partition.whole(lp, "dec_blocks")
        ckv = attn_mod.encode_kv(lp["xattn"], enc, cfg)
        x, _, cache = blocks.decoder_block(lp, x, cfg, causal=True,
                                           return_cache=True, cross_kv=ckv)
        _put_kv(kv, i, cache)
        for k in ("k", "v"):
            cross[k][i] = ckv[k]
    x = _norm(p, "dec_ln", x[:, -1:])
    return _logits(p, x)[:, 0], {"self": kv, "cross": cross}


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
    if cfg.family == "enc_dec":
        return _decode_enc_dec(p, caches, x, cfg)
    if cfg.family == "ssm":
        x, _ = blocks.mamba_stack(p["blocks"], x, cfg, states=caches)
    else:
        kv = caches["attn"]
        groups = zip(blocks.layer_views(p["groups"]),
                     blocks.layer_views(caches["mamba"]), hybrid_flags(cfg))
        shared = partition.whole(p["shared_attn"], "shared_attn")
        for i, (gp, states, flag) in enumerate(groups):
            view = {"k": kv["k"][i], "v": kv["v"][i]}
            # an off group leaves its cache alone: nothing to gather
            full = partition.whole_cache(view, "attn") if flag else view
            cache = {**full, "len": kv["len"][i]}
            x, _, new = blocks.hybrid_group(
                gp, shared, x, cfg, flag, states=states,
                attn_cache=cache, pos_offset=cache["len"])
            partition.write_back(view, full, "attn")
            kv["len"][i] = new["len"]   # k/v were written in place
        if "trailing" in p:
            x, _ = blocks.mamba_stack(p["trailing"], x, cfg,
                                      states=caches["trailing"],
                                      path=("trailing",),
                                      state_path=("trailing",))
    x = _norm(p, "ln_f", x)
    return _logits(p, x)[:, 0], caches


def _decode_enc_dec(p: Params, caches, x: torch.Tensor, cfg: ModelConfig):
    """The decoder over one embedded token per row ``x`` (B, 1, d): the
    self-attention caches advance in place, the cross K/V are read."""
    kv, cross = caches["self"], caches["cross"]
    for i, lp in enumerate(blocks.layer_views(p["dec_blocks"])):
        view = {"k": kv["k"][i], "v": kv["v"][i]}
        full = partition.whole_cache(view, "self")
        cache = {**full, "len": kv["len"][i]}
        x, _, new = blocks.decoder_block(
            partition.whole(lp, "dec_blocks"), x, cfg, causal=True,
            pos_offset=cache["len"], cache=cache,
            cross_kv=partition.whole_cache(
                {"k": cross["k"][i], "v": cross["v"][i]}, "cross"))
        partition.write_back(view, full, "self")
        kv["len"][i] = new["len"]       # k/v were written in place
    x = _norm(p, "dec_ln", x)
    return _logits(p, x)[:, 0], caches


def decode_tokens(p: Params, caches, tokens: torch.Tensor, cfg: ModelConfig,
                  *, pt: torch.Tensor | None = None,
                  active: torch.Tensor | None = None,
                  n_valid: int | torch.Tensor | None = None,
                  embeds: torch.Tensor | None = None):
    """Cache-advancing forward of an attention family over ``tokens`` (B,
    S) -> (logits (B, S, vocab), caches).

    S == 1 is the lockstep decode step; S > 1 is a chunked-prefill step.
    The paged routing keys go into each layer's cache dict for
    ``attention``'s paged branch: ``pt`` (B, n_pages) int32 page tables,
    ``active`` (B,) bool rows that may write real pages and advance, and
    ``n_valid`` — how many of the S positions are real (a padded final
    chunk advances ``len`` by n_valid; an int or a 0-dim device tensor).
    ``embeds`` (B, S, d) replaces the token embeddings (a VLM prompt's
    chunk).  MoE layers are dropless here."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"decode_tokens supports attention families "
                         f"(dense/moe/vlm), not {cfg.family!r}")
    x = embeds.to(compute_dtype(cfg)) if embeds is not None \
        else _embed(p, tokens, cfg)
    lens = caches["len"]
    for i, lp in enumerate(blocks.layer_views(p["blocks"])):
        view = {"k": caches["k"][i], "v": caches["v"][i]}
        full = partition.whole_cache(view)
        cache = {**full, "len": lens[i]}
        if pt is not None:
            cache["pt"] = pt
            if active is not None:
                cache["active"] = active
            if n_valid is not None:
                cache["n_valid"] = n_valid
        x, _, new = blocks.decoder_block(partition.whole(lp, "blocks"), x,
                                         cfg, causal=True,
                                         pos_offset=cache["len"],
                                         cache=cache)
        partition.write_back(view, full)
        lens[i] = new["len"]        # in place: k/v were written in place too
    x = _norm(p, "ln_f", x)
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
                      device: str | torch.device,
                      enc_len: int | None = None) -> dict[str, Any]:
    """Zero decode caches for ``capacity`` slots of ``max_len`` positions:
    the tree :func:`prefill` returns, batch ``capacity`` on each leaf's
    :func:`_slot_axis`, and a ``len`` per layer and slot.  A sliding-window
    model's K/V hold ``kv_cache_len`` positions; mamba states do not depend
    on ``max_len``; an enc_dec model's cross K/V hold ``enc_len`` frames
    (default ``cfg.enc_len``)."""
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
    if cfg.family == "enc_dec":
        shape = (cfg.dec_layers, capacity, enc_len or cfg.enc_len,
                 cfg.n_kv_heads, cfg.hd)
        return {"self": kv(cfg.dec_layers),
                "cross": {k: torch.zeros(shape, dtype=dt, device=dev)
                          for k in ("k", "v")}}
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


def slot_view(caches, slot: int | torch.Tensor):
    """A batch-1 view of one slot: its lengths sliced (a view, so writes go
    through) or, for a 0-dim device tensor ``slot``, selected (a copy that
    :func:`merge_slot` writes back); page stores passed whole."""
    lens = caches["len"]
    if isinstance(slot, torch.Tensor):
        lens = lens.index_select(1, slot.reshape(1).long())
    else:
        lens = lens[:, slot:slot + 1]
    return {"k": caches["k"], "v": caches["v"], "len": lens}


def merge_slot(caches, view, slot: int | torch.Tensor):
    """Write a :func:`slot_view` back: the page stores are shared (writes
    already landed at absolute page ids); the lengths scatter at ``slot``
    (an int, or a 0-dim device tensor)."""
    if isinstance(slot, torch.Tensor):
        caches["len"].index_copy_(1, slot.reshape(1).long(), view["len"])
    else:
        caches["len"][:, slot:slot + 1] = view["len"]
    return caches


def prefill_chunk(p: Params, caches, tokens: torch.Tensor,
                  pt_row: torch.Tensor, slot: int | torch.Tensor,
                  n_valid: int | torch.Tensor, cfg: ModelConfig,
                  embeds: torch.Tensor | None = None):
    """One chunked-prefill step for one slot over the paged cache.

    ``tokens`` (1, chunk) is the next prompt chunk, zero-padded past
    ``n_valid`` on the final chunk (``embeds`` (1, chunk, d), when given,
    in their place, padded alike); ``pt_row`` (1, n_pages) is the slot's
    page table.  ``slot`` and ``n_valid`` are ints or 0-dim device tensors,
    as the reference traces them: a chunk step captured once per chunk
    shape takes them as static inputs, so nothing here reads them on the
    host.  Returns the logits at the last valid position ((1, vocab), only
    meaningful on the final chunk) and the updated caches."""
    view = slot_view(caches, slot)
    logits, view = decode_tokens(p, view, tokens, cfg, pt=pt_row,
                                 n_valid=n_valid, embeds=embeds)
    if isinstance(n_valid, torch.Tensor):
        last = (n_valid.long() - 1).reshape(1, 1, 1).expand(
            logits.shape[0], 1, logits.shape[2])
        return (torch.gather(logits, 1, last)[:, 0],
                merge_slot(caches, view, slot))
    return logits[:, n_valid - 1], merge_slot(caches, view, slot)
