"""Warn-once plumbing for the deprecated ``repro_torch.core`` transform
entry points.

Port of ``repro.core._deprecation``. The implementations live on as the
``*_impl`` functions that the xfft front door and the planner dispatch
to; only the public per-call ``variant=`` surface is deprecated in favour
of ``repro_torch.xfft``.
"""

from __future__ import annotations

import warnings
from typing import Set

_WARNED: Set[str] = set()


def warn_deprecated(old: str, new: str, *, stacklevel: int = 3) -> None:
    """Emit one DeprecationWarning per entry point per process."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"{old} is deprecated; call {new} instead (engine selection now "
        "lives in repro_torch.plan / repro_torch.xfft.config, not per-call kwargs)",
        DeprecationWarning,
        stacklevel=stacklevel,
    )


def reset_warnings() -> None:
    """Forget which warnings fired (tests)."""
    _WARNED.clear()


def forward(old: str, name: str, x, variant, **kw):
    """Warn once that ``old`` is deprecated, then run ``repro_torch.xfft``'s
    ``name`` on ``x``: planned when ``variant`` is None or ``"auto"``, else
    under a scoped ``xfft.config(variant=variant)``."""
    warn_deprecated(old, f"repro_torch.xfft.{name}", stacklevel=4)
    from repro_torch import xfft  # lazy: xfft builds on core

    fn = getattr(xfft, name)
    if variant is None or variant == "auto":
        return fn(x, **kw)
    with xfft.config(variant=variant):
        return fn(x, **kw)
