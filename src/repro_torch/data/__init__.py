"""Synthetic data for the LM stack (port of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticLM, frames_for, make_batch, patches_for

__all__ = ["SyntheticLM", "make_batch", "frames_for", "patches_for"]
