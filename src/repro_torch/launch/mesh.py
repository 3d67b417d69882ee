"""Production mesh builders (the reference's shapes), over
``repro_torch.compat.make_mesh``.

Port of ``repro.launch.mesh``. Functions, not module constants: importing
this module touches no process group. Each needs the default process
group initialised over at least as many ranks as its mesh holds.
"""

from __future__ import annotations

from repro_torch.compat import make_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]


def _mesh(shape: tuple, axes: tuple, device_type: str):
    import torch.distributed as dist

    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh {axes} needs a process group of "
                           f"{need} ranks; this one has {world or 'none'}")
    return make_mesh(shape, axes, device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16,16) data×model single pod; (2,16,16) pod×data×model for 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Tiny analogue for the multi-rank tests (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)
