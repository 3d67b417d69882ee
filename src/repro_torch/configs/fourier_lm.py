"""fourier_lm [spectral] — the PAPER'S OWN architecture in the framework:
an FNet-style masked LM whose token-mixing sublayer is the paper's
area-efficient 2D FFT engine (Re(FFT2) over (seq, d_model)). Bidirectional
mixing => encoder-style MLM; no decode shapes."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="fourier_lm",
    family="spectral",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=32768,
    act="gelu",
    seq_pad_to_pow2=True,
    fft_variant="auto",
    subquadratic=True,     # O(L log L) mixing
)
