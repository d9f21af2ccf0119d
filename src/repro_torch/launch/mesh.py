"""Production mesh construction.

The counterpart of ``repro.launch.mesh``. FUNCTIONS, not module-level
constants: importing this module starts no process group and touches no
device. Both need ``torch.distributed`` initialised with the mesh's number
of ranks (``launch/dryrun.py`` initialises a fake group of 256 or 512 ranks
on the CPU). ``device_type`` is the ranks' device: the card unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the process group, as a 1D 'data' mesh (tests,
    examples)."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
