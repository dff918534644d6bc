"""Production and host meshes over ``torch.distributed``.

Counterpart of the reference package's ``launch/mesh.py``.  Both are
functions, never module-level constants, and neither initialises a
process group: each builds a ``DeviceMesh`` over the default group the
caller initialised -- NCCL on the card, gloo across CPU processes, or
the fake group of the dry run, where one process stands for 256 or 512
ranks (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 chips per pod, ``("data", "model")``; the
    multi-pod mesh adds a leading 2-pod axis (``("pod", "data",
    "model")``), used for data parallelism.  The default group must have
    256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import mesh_device_type

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh():
    """``(1, world_size)`` over ``("data", "model")``: whatever the
    default group has (one rank on one card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.sharding import mesh_device_type

    return init_device_mesh(mesh_device_type(), (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
