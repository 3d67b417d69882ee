"""repro_torch — the PyTorch/CUDA port of ``repro``.

The front door is :mod:`repro_torch.xfft`. Its entry points run on the
card: a tensor runs on its own device (a CPU tensor is the caller asking
for the CPU), and numpy arrays or Python data go to ``torch.device("cuda")``.
The package imports torch and numpy only; its CUDA kernels are built at
first use (``repro_torch.kernels._build``).
"""
