"""Plan objects: the software rendition of the paper's control unit.

Port of ``repro.plan.plan``. A :class:`ProblemKey` is the identity of one
FFT problem (kind, backend, device kind, shape, dtype, direction, axes,
precision, backend scope); an :class:`FFTPlan` freezes one scheduling
decision for it. Keys and plans serialise in the reference's wisdom
schema, version 5, so a wisdom file written by either package loads in
the other.

``backend`` is ``"cuda"`` or ``"cpu"``, the type of the device the
transform runs on, and ``device_kind`` is ``torch.cuda.get_device_name``
for a card and ``"cpu"`` for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "DIRECTIONS",
    "KINDS",
    "NORMS",
    "PLAN_SCHEMA_VERSION",
    "FFTPlan",
    "ProblemKey",
    "problem_key",
]

#: The reference's wisdom schema (v5: engine registry, precision and
#: backend scope in the key).
PLAN_SCHEMA_VERSION = 5

#: Problem kinds of the wisdom schema. The planner also plans ``oaconv2d``
#: (the tile of ``repro_torch.imaging.tiled.oaconvolve2``).
KINDS = (
    "fft1d", "fft2d", "fft2d_stream", "fft2d_pencil", "rfft1d", "rfft2d",
    "oaconv2d",
)

DIRECTIONS = ("fwd", "inv")

#: Normalization conventions (scipy.fft names). Not part of the key: the
#: norm is a scale applied outside the engine.
NORMS = ("backward", "ortho", "forward")

_WIDE_DTYPES = {"complex64": "complex128", "float32": "float64"}

_CANONICAL_AXES = {
    "fft1d": (-1,),
    "rfft1d": (-1,),
    "fft2d": (-2, -1),
    "rfft2d": (-2, -1),
    "fft2d_stream": (-2, -1),
    "fft2d_pencil": (-2, -1),
    "oaconv2d": (-2, -1),
}


@dataclasses.dataclass(frozen=True)
class ProblemKey:
    """Identity of one FFT problem: what the control unit dispatches on.

    ``shape`` is the shape the engine sees (transform axes last).
    """

    kind: str
    backend: str               # "cuda" | "cpu"
    device_kind: str           # e.g. "NVIDIA H100 80GB HBM3", "cpu"
    shape: Tuple[int, ...]
    dtype: str
    n_devices: int = 1
    direction: str = "fwd"
    axes: Tuple[int, ...] = ()
    precision: str = "single"
    backends: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown problem kind {self.kind!r}; want one of {KINDS}")
        if self.direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {self.direction!r}; want one of {DIRECTIONS}")
        from repro_torch.engines.registry import PRECISIONS  # lazy: one domain

        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; want one of {PRECISIONS}")
        if self.precision == "double":
            object.__setattr__(
                self, "dtype", _WIDE_DTYPES.get(str(self.dtype), str(self.dtype))
            )
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        axes = tuple(int(a) for a in self.axes) or _CANONICAL_AXES[self.kind]
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "backends", tuple(sorted(set(self.backends))))

    def cache_key(self) -> str:
        """Stable, versioned string key for the plan cache (schema v5).
        Built once a key: the cache lookup and the ``plan.resolve`` event
        of one resolution share it."""
        key = self.__dict__.get("_cache_key")
        if key is None:
            shape = "x".join(str(s) for s in self.shape)
            axes = ",".join(str(a) for a in self.axes)
            engines = ",".join(self.backends) if self.backends else "*"
            key = (
                f"v{PLAN_SCHEMA_VERSION}|{self.kind}|{self.direction}|{self.backend}"
                f"|{self.device_kind}|{shape}|{self.dtype}|d{self.n_devices}"
                f"|ax{axes}|{self.precision}|be{engines}"
            )
            self.__dict__["_cache_key"] = key  # not a field: eq, hash and repr ignore it
        return key

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "backend": self.backend,
            "device_kind": self.device_kind,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "n_devices": self.n_devices,
            "direction": self.direction,
            "axes": list(self.axes),
            "precision": self.precision,
            "backends": list(self.backends),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProblemKey":
        return cls(
            kind=d["kind"],
            backend=d["backend"],
            device_kind=d["device_kind"],
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            n_devices=int(d["n_devices"]),
            direction=d.get("direction", "fwd"),
            axes=tuple(d.get("axes", ())),
            precision=d.get("precision", "single"),
            backends=tuple(d.get("backends", ())),
        )


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """One frozen scheduling decision for a :class:`ProblemKey`.

    The fields after ``variant`` are the reference's, kept so wisdom round
    trips between the packages: ``tile`` is the overlap-save tile of an
    ``oaconv2d`` plan; ``unroll`` is the stream's frames a step, ``chunks``
    the pencil's corner-turn slabs, and ``measured_us`` belongs to
    MEASURE.
    """

    key: ProblemKey
    variant: str
    axis_order: Tuple[int, ...] = (-1, -2)
    precision: str = "single"
    unroll: int = 1
    chunks: int = 1
    mode: str = "estimate"
    est_time_s: float = 0.0
    measured_us: Optional[float] = None
    tile: Optional[Tuple[int, int]] = None
    degrade_reason: Optional[str] = None

    def __post_init__(self):
        from repro_torch.engines import has_engine, registered_variants  # lazy

        if not has_engine(self.variant):
            raise ValueError(
                f"plan variant must be a concrete registered engine, got "
                f"{self.variant!r} (registered engines: {registered_variants()})"
            )
        object.__setattr__(self, "precision", self.key.precision)
        if self.unroll < 1 or self.chunks < 1:
            raise ValueError("unroll and chunks must be >= 1")

    def to_dict(self) -> dict:
        return {
            "key": self.key.to_dict(),
            "variant": self.variant,
            "axis_order": list(self.axis_order),
            "precision": self.precision,
            "unroll": self.unroll,
            "chunks": self.chunks,
            "mode": self.mode,
            "est_time_s": self.est_time_s,
            "measured_us": self.measured_us,
            "tile": None if self.tile is None else list(self.tile),
            "degrade_reason": self.degrade_reason,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FFTPlan":
        tile = d.get("tile")
        return cls(
            key=ProblemKey.from_dict(d["key"]),
            variant=d["variant"],
            axis_order=tuple(d["axis_order"]),
            precision=d["precision"],
            unroll=int(d["unroll"]),
            chunks=int(d["chunks"]),
            mode=d["mode"],
            est_time_s=float(d["est_time_s"]),
            measured_us=None if d.get("measured_us") is None else float(d["measured_us"]),
            tile=None if tile is None else (int(tile[0]), int(tile[1])),
            degrade_reason=d.get("degrade_reason"),
        )


def device_kind(device: torch.device) -> str:
    """The ``device_kind`` a key carries for ``device``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def problem_key(
    kind: str,
    shape: Tuple[int, ...],
    device: torch.device,
    dtype: str = "complex64",
    n_devices: int = 1,
    direction: str = "fwd",
    axes: Optional[Tuple[int, ...]] = None,
    precision: str = "single",
    backends: Tuple[str, ...] = (),
) -> ProblemKey:
    """Build a :class:`ProblemKey` for a transform that runs on ``device``.
    A meta device (the dry-run, ``repro_torch.launch.dryrun``) keys as the
    card: it plans what a CUDA tensor runs, and its kernels launch nothing."""
    device = torch.device(device)
    return ProblemKey(
        kind=kind,
        backend="cuda" if device.type == "meta" else device.type,
        device_kind=device_kind(device),
        shape=tuple(shape),
        dtype=str(dtype),
        n_devices=int(n_devices),
        direction=direction,
        axes=tuple(axes) if axes else (),
        precision=precision,
        backends=tuple(backends),
    )
