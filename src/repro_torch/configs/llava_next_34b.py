"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling [hf:llava-hf/llava-v1.6; unverified].

The vision frontend (anyres patch tiling + projector) is a STUB: input_specs
provide precomputed patch+text embeddings (B, S, d_model); the transformer
BACKBONE is modeled exactly."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    input_mode="embeddings", mlp_type="swiglu",
)
