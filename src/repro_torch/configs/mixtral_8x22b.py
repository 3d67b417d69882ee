"""mixtral-8x22b [moe]: 56L, d_model=6144, 48H (GQA kv=8), MoE 8 experts
top-2 (expert d_ff=16384), vocab=32768, SWA window 4096.
[arXiv:2401.04088; hf]. SWA -> sub-quadratic -> long_500k runs with a
ring KV cache of window size."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    sliding_window=4096,
    moe=MoEConfig(
        n_experts=8,
        top_k=2,
        d_ff_expert=16384,
        router_norm="softmax",
        capacity_factor=1.25,
        impl="grouped_local",
    ),
    subquadratic=True,
)
