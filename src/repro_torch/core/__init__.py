"""The FFT engines in torch: the paper's reused-butterfly schedules, the
Stockham family, the two-for-one real path and the separable 2D passes."""
