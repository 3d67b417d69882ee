"""llama3.2-3b [dense]: 28L, d_model=3072, 24H (GQA kv=8), d_ff=8192,
vocab=128256 — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    act="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
    subquadratic=False,
)
