"""deepseek-v3-671b [moe]: 61L, d_model=7168, 128H MLA, MoE 1 shared + 256
routed top-8 (expert d_ff=2048), vocab=129280, MTP. First 3 layers dense
(d_ff=18432). [arXiv:2412.19437; hf]"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-layer FFN width
    vocab=129280,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        n_dense_layers=3,
        router_norm="sigmoid",
        capacity_factor=1.25,
        impl="grouped_local",   # ep_a2a variant benchmarked in §Perf
    ),
    mtp=True,
    subquadratic=False,
)
