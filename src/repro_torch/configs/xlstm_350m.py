"""xlstm-350m [ssm]: 24L (alternating mLSTM/sLSTM), d_model=1024, 4H
(GQA kv=4), d_ff=0 (blocks carry their own projections), vocab=50304.
[arXiv:2405.04517; unverified]. O(1) state -> long_500k runs."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=2,
    subquadratic=True,
)
