"""Deterministic, restart-safe synthetic data pipeline.

Port of ``repro.data.pipeline``. Every batch is a pure function of (seed,
step), drawn with numpy exactly as the reference draws it, and returned as
torch tensors on the device asked for (default: the card). The token
stream is a learnable-structure Markov-ish sequence so tiny LMs show a
decreasing loss (not pure noise).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.param import _device

__all__ = ["SyntheticLM", "frames_for", "make_batch", "patches_for"]


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).to(_device(device))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq: int
    batch: int
    seed: int = 0
    device: Any = None  # where batches go (default: the card)

    def _tokens_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # structured stream: tok_{t+1} = (a·tok_t + b + noise) % V
        a = 31
        b = rng.integers(0, self.vocab, (self.batch, 1))
        t0 = rng.integers(0, self.vocab, (self.batch, 1))
        noise = (rng.random((self.batch, self.seq)) < 0.05) * rng.integers(
            0, self.vocab, (self.batch, self.seq)
        )
        toks = np.zeros((self.batch, self.seq), np.int64)
        toks[:, :1] = t0
        for t in range(1, self.seq):
            toks[:, t] = (a * toks[:, t - 1] + b[:, 0]) % self.vocab
        return (toks + noise) % self.vocab

    def batch_at(self, step: int) -> dict:
        """Batch for global step ``step`` (deterministic, O(1) state)."""
        return {"tokens": _tensor(self._tokens_at(step), torch.int32, self.device)}

    def mlm_batch_at(self, step: int, mask_rate: float = 0.15) -> dict:
        """Masked-LM variant (spectral/fourier_lm arch)."""
        base = self._tokens_at(step)
        rng = np.random.default_rng((self.seed << 21) ^ step)
        mask = rng.random((self.batch, self.seq)) < mask_rate
        corrupted = base.copy()
        corrupted[mask] = 0  # [MASK] id
        return {
            "tokens": _tensor(corrupted, torch.int32, self.device),
            "targets": _tensor(base, torch.int32, self.device),
            "mlm_mask": _tensor(mask, torch.float32, self.device),
        }


def frames_for(cfg, batch: int, step: int, seed: int = 0, device=None):
    rng = np.random.default_rng((seed << 22) ^ step)
    return _tensor(rng.standard_normal((batch, cfg.enc_frames, cfg.d_model)) * 0.02,
                   torch.float32, device)


def patches_for(cfg, batch: int, step: int, seed: int = 0, device=None):
    rng = np.random.default_rng((seed << 23) ^ step)
    return _tensor(rng.standard_normal((batch, cfg.n_patches, cfg.d_model)) * 0.02,
                   torch.float32, device)


def make_batch(cfg, batch: int, seq: int, step: int, seed: int = 0, device=None) -> dict:
    """Family-aware batch builder used by the train loop and examples."""
    pipe = SyntheticLM(cfg.vocab, seq, batch, seed, device)
    if cfg.family == "spectral":
        return pipe.mlm_batch_at(step)
    out = pipe.batch_at(step)
    if cfg.family == "audio":
        out["frames"] = frames_for(cfg, batch, step, seed, device)
    if cfg.family == "vlm":
        out = SyntheticLM(cfg.vocab, seq - cfg.n_patches, batch, seed, device).batch_at(step)
        out["patches"] = patches_for(cfg, batch, step, seed, device)
    return out
