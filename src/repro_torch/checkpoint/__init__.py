"""Fault-tolerant checkpoints of tensor trees (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    restore,
    restore_resharded,
    save,
)

__all__ = ["save", "restore", "restore_resharded", "latest_step", "AsyncCheckpointer"]
