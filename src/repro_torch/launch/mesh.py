"""Production mesh builders (the reference's shapes), over
``repro_torch.compat.make_mesh``.

Port of ``repro.launch.mesh``. One table, :data:`MESHES`, holds every
mesh's shape and axis names: the builders read it, and so does the
dry-run (``repro_torch.launch.dryrun``), which needs the axis sizes only
and builds no process group (:func:`mesh_axes`). Functions, not module
constants: importing this module touches no process group. Each builder
needs the default process group initialised over at least as many ranks
as its mesh holds.
"""

from __future__ import annotations

from repro_torch.compat import make_mesh

__all__ = ["MESHES", "make_production_mesh", "make_test_mesh", "mesh_axes", "mesh_name"]

#: name -> (shape, axis names). ``pod1_16x16`` and ``pod2_2x16x16`` are the
#: reference's production meshes, ``test_4x2`` and ``test_2x2x2`` its test
#: meshes (8 ranks), ``card_1x1`` one card (the dry-run held against a
#: step on the card).
MESHES = {
    "pod1_16x16": ((16, 16), ("data", "model")),
    "pod2_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "test_4x2": ((4, 2), ("data", "model")),
    "test_2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "card_1x1": ((1, 1), ("data", "model")),
}


def mesh_name(*, multi_pod: bool = False, test: bool = False) -> str:
    """The table's name for the production (or test) mesh of one or two
    pods."""
    if test:
        return "test_2x2x2" if multi_pod else "test_4x2"
    return "pod2_2x16x16" if multi_pod else "pod1_16x16"


def mesh_axes(name: str) -> dict:
    """{axis name: size} of the mesh ``name``, in the mesh's order."""
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _mesh(name: str, device_type: str):
    import torch.distributed as dist

    shape, axes = MESHES[name]
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
    return _mesh(mesh_name(multi_pod=multi_pod), device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Tiny analogue for the multi-rank tests (8 ranks)."""
    return _mesh(mesh_name(multi_pod=multi_pod, test=True), device_type)
