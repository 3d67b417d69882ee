"""repro_torch.models — the LM stack's models (port of ``repro.models``).

``config`` (every architecture's dataclass), ``param`` (skeletons, init,
the weight carrier ``params_from_numpy``), ``layers``, ``attention`` (GQA
and cross-attention, prefill and cross-attention on the hand-written
``flash_attention_fwd`` on the card), ``xlstm`` (mLSTM, and sLSTM with its
prefill on the hand-written ``slstm_scan``), ``ssm`` (Mamba2),
``transformer`` (the dense decoder, the xLSTM and hybrid stacks, the
encoder-decoder and the spectral stack, whose mixing plans onto the FFT
kernels) and ``build`` (the ``Model`` bundle).
"""
