"""internvl2-76b [vlm]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=28672,
vocab=128256 — InternViT + InternLM2. [arXiv:2404.16821; unverified]
Backbone only; the ViT patch frontend is a STUB (input_specs provides
precomputed patch embeddings prepended to the token sequence)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_patches=256,
    act="swiglu",
    rope_theta=1000000.0,
    subquadratic=False,
)
