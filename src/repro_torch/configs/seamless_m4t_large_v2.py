"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206; encoder-decoder, multimodal [arXiv:2308.11596; hf].

The speech frontend (conformer feature extractor) is a STUB: input_specs
provide precomputed frame embeddings (B, T_enc, d_model).  Both the 24-layer
encoder and the 24-layer decoder (self+cross attention) are modeled.
T_enc is capped at 4096 frames (DESIGN.md §4)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="enc_dec",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    enc_layers=24, dec_layers=24, enc_len=4096,
    input_mode="embeddings", mlp_type="gelu",
)
