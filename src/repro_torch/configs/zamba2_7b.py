"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

Structure here: 13 scanned groups of 6 mamba blocks, each followed by the
ONE shared attention+MLP block (params reused across groups — the Zamba
trick), plus 3 trailing mamba blocks (81 = 13*6 + 3)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256, conv_width=4,
    hybrid_group=6, hybrid_attn_every=1,
)
