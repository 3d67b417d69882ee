"""zamba2-2.7b [hybrid]: 54L Mamba2, d_model=2560, shared attn block 32H
(GQA kv=32) every 6 layers, d_ff=10240, vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]. Sub-quadratic (SSM + a few shared-attention
invocations) -> long_500k runs."""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    subquadratic=True,
)
