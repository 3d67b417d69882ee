"""Synthetic multi-coil acquisition fixture: phantom + birdcage coils.

Port of ``repro.mri.phantom``: the port's own copy of the reference's
numpy fixture, bit for bit. The deterministic ground truth the recon
tests and ``chip_smoke.py`` share: a Shepp-Logan head phantom and a smooth
birdcage-style coil-sensitivity model. Pure numpy — generating the
fixture must not exercise the transform engines under test.
"""

from __future__ import annotations

import numpy as np

__all__ = ["shepp_logan", "birdcage_maps"]

# (intensity, a, b, x0, y0, phi_deg) — the modified (Toft) Shepp-Logan
# table, whose soft-tissue contrasts are visible without windowing.
_ELLIPSES = (
    (1.00, 0.6900, 0.9200, 0.00, 0.0000, 0.0),
    (-0.80, 0.6624, 0.8740, 0.00, -0.0184, 0.0),
    (-0.20, 0.1100, 0.3100, 0.22, 0.0000, -18.0),
    (-0.20, 0.1600, 0.4100, -0.22, 0.0000, 18.0),
    (0.10, 0.2100, 0.2500, 0.00, 0.3500, 0.0),
    (0.10, 0.0460, 0.0460, 0.00, 0.1000, 0.0),
    (0.10, 0.0460, 0.0460, 0.00, -0.1000, 0.0),
    (0.10, 0.0460, 0.0230, -0.08, -0.6050, 0.0),
    (0.10, 0.0230, 0.0230, 0.00, -0.6060, 0.0),
    (0.10, 0.0230, 0.0460, 0.06, -0.6050, 0.0),
)


def shepp_logan(n: int) -> np.ndarray:
    """(n, n) float32 modified Shepp-Logan phantom on the [-1, 1]² grid."""
    if n < 8:
        raise ValueError(f"phantom size must be >= 8, got {n}")
    grid = np.linspace(-1.0, 1.0, n, endpoint=False) + 1.0 / n
    x = grid[None, :]
    y = -grid[:, None]                       # row 0 is the top of the head
    img = np.zeros((n, n), np.float64)
    for value, a, b, x0, y0, phi_deg in _ELLIPSES:
        phi = np.deg2rad(phi_deg)
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        img += value * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)
    return img.astype(np.float32)


def birdcage_maps(n_coils: int, n: int, radius: float = 1.5) -> np.ndarray:
    """(n_coils, n, n) complex64 birdcage-style sensitivity maps, RSS ≈ 1.

    Each coil sits at angle ``2πc/C`` on a circle of ``radius`` (in
    half-FOV units) around the image: magnitude falls off with distance
    to the coil, phase ramps smoothly across the FOV with a per-coil
    offset. Normalised so the root-sum-of-squares is 1 everywhere — the
    convention ESPIRiT maps satisfy, and the one that keeps the CG-SENSE
    normal operator well conditioned.
    """
    if n_coils < 1:
        raise ValueError(f"need at least one coil, got {n_coils}")
    grid = np.linspace(-1.0, 1.0, n, endpoint=False) + 1.0 / n
    x = grid[None, :]
    y = grid[:, None]
    maps = np.empty((n_coils, n, n), np.complex128)
    for c in range(n_coils):
        ang = 2.0 * np.pi * c / n_coils
        cx, cy = radius * np.cos(ang), radius * np.sin(ang)
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        mag = 1.0 / d2
        phase = np.exp(1j * (0.5 * np.pi * (x * cy - y * cx) + ang))
        maps[c] = mag * phase
    rss = np.sqrt((np.abs(maps) ** 2).sum(axis=0))
    return (maps / rss).astype(np.complex64)
