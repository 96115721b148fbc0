"""Model configuration — one dataclass covers all 10 assigned families.

Kept field for field with ``repro.models.config`` so a JAX config converts
with ``dataclasses.asdict``.  ``remat`` and ``remat_policy`` pick the
training forward's per-layer rematerialisation, as the reference's
``_maybe_remat`` does (``models/blocks.remat``: ``"full"`` runs each layer
again in the backward, ``"dots"`` keeps its matrix products, ``"none"``
keeps everything); ``force_microbatches`` sets the dry run's microbatch
count.  ``scan_layers`` and ``seq_shard`` are accepted and have no effect
in the port (its layer loop is a Python loop; sequence parallelism is not
ported).  ``use_pallas`` picks the model's kernels
(flash at prefill, the paged gather, the SSD), as in the reference: the
serving engines set it, and on CUDA tensors the kernels run (on CPU
tensors their plain versions); training leaves it off and runs the plain,
differentiable versions, since the kernels have no backward and raise on
a call that autograd would record (``kernels.refuse_grad``).
``logits_microbatch`` chunks the loss over the sequence
(``model.loss_fn``).  ``moe_groups`` is not a no-op either: it changes
which tokens an MoE layer drops, and the port routes within its groups as
the reference does (``models/moe.py``).  The port runs every family,
dense (sliding-window attention included), moe, vlm, ssm, hybrid and
enc_dec, and padded heads; :func:`check_supported` refuses any other.
"""

from __future__ import annotations

import dataclasses

#: the model families the port runs
SUPPORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "enc_dec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | enc_dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"       # swiglu | gelu | geglu
    qk_norm: bool = False
    window: int | None = None      # sliding-window attention (tokens)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    moe_groups: int = 0            # >0: group-local dispatch — tokens are
                                   # routed/sorted/scattered WITHIN each of
                                   # moe_groups batch groups (sharded over
                                   # pod×data) so dispatch needs no global
                                   # collective and the expert einsum is
                                   # already EP-aligned (§Perf lever)
    # --- SSM (Mamba-2) -------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4
    # --- hybrid (Zamba-2): groups of mamba layers + one shared attn block ----
    hybrid_group: int = 0          # mamba layers per scan group
    hybrid_attn_every: int = 0     # apply shared attn block every N groups
    # --- encoder-decoder ------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    enc_len: int = 0               # encoder context length (frontend frames)
    # --- inputs ----------------------------------------------------------------
    input_mode: str = "tokens"     # tokens | embeddings  (vlm/audio stubs)
    # --- execution ---------------------------------------------------------------
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"     # full | dots | none  (§Perf lever)
    padded_heads: int = 0          # pad q-heads to this count with zeroed
                                   # wq/wo so the heads dim shards over the
                                   # 16-way model axis (§Perf lever; exact:
                                   # zero wo rows contribute nothing)
    force_microbatches: int = 0    # override grad-accum count (§Perf lever)
    seq_shard: bool = False        # sequence parallelism: shard the residual
                                   # stream's seq dim over 'model' (§Perf
                                   # lever for long-seq prefill; GSPMD
                                   # gathers K/V inside attention)
    scan_layers: bool = True
    use_pallas: bool = False       # the CUDA kernels on fwd-only paths
    logits_microbatch: int = 0     # chunk the loss over seq (0 = off)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling (SSM / hybrid / SWA)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def validate(self) -> "ModelConfig":
        if self.family in ("dense", "moe", "vlm", "enc_dec"):
            assert self.n_heads > 0 and self.n_heads % self.n_kv_heads == 0
        if self.family == "moe":
            assert self.n_experts > 0 and 0 < self.top_k <= self.n_experts
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0 and self.d_inner % self.ssm_headdim == 0
        if self.family == "hybrid":
            # trailing (n_layers % hybrid_group) mamba layers run after the
            # scanned groups — see models/model.py
            assert self.hybrid_group > 0 and self.hybrid_attn_every > 0
            assert self.n_layers >= self.hybrid_group
        if self.family == "enc_dec":
            assert self.enc_layers > 0 and self.dec_layers > 0
        return self


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else cfg.hybrid_group * 2),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        enc_layers=min(cfg.enc_layers, 2),
        dec_layers=min(cfg.dec_layers, 2),
        enc_len=min(cfg.enc_len, 64) if cfg.enc_len else 0,
        window=min(cfg.window, 32) if cfg.window else None,
        hybrid_group=cfg.hybrid_group and min(cfg.hybrid_group, 2),
        hybrid_attn_every=cfg.hybrid_attn_every and min(cfg.hybrid_attn_every, 2),
        dtype="float32",
        param_dtype="float32",
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small).validate()


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Raise ``NotImplementedError`` for a family the port does not run
    (every family of ``configs`` runs); else the validated config."""
    if cfg.family not in SUPPORTED_FAMILIES:
        raise NotImplementedError(
            f"repro_torch runs the {', '.join(SUPPORTED_FAMILIES)} "
            f"families only; {cfg.name} is {cfg.family!r}")
    return cfg.validate()
