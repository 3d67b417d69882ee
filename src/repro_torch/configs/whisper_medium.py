"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024, 16H (GQA kv=16),
d_ff=4096, vocab=51865 — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    enc_frames=1500,
    act="gelu",
    rope_theta=10000.0,
    subquadratic=False,   # full attention -> long_500k skipped
)
