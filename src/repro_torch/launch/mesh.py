"""Production meshes, as ``torch.distributed`` ``DeviceMesh`` es.

Port of ``repro/launch/mesh.py``. Functions, not module constants:
importing this module creates no process group, as JAX's never touches
device state. Each function needs a process group of as many ranks as
the mesh has devices: a real one, or the dry run's fake one
(``launch.dryrun.fake_world``).
"""
from __future__ import annotations


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A mesh of ``shape`` over axes named ``axes`` (tests, elastic
    restore)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.sharding import off_turn
    return off_turn(lambda: init_device_mesh(device_type, tuple(shape),
                                             mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 devices ("data", "model"); two of them, 512, with
    "pod" ahead. "pod" carries only data-parallel traffic; "data" is
    DP / FSDP / SP; "model" is TP / EP."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
