"""Device meshes: the production H100 meshes over a fake process group,
the CI-sized mini meshes, and a mesh over the real devices.

The reference's pods are 256 TPU chips as (data=16, model=16), and two
of them as (pod=2, data=16, model=16). The port re-expresses them as
H100 meshes of the same chip counts, with the model axis on one 8-GPU
NVLink node (a 16-way model axis would cross two nodes):

  single pod ``gpu32x8``:   (data=32, model=8)         = 256 GPUs
  multi-pod  ``gpu2x32x8``: (pod=2, data=32, model=8)  = 512 GPUs

The mini meshes stay the reference's (2, 2) and (2, 2, 2).

A dry-run traces rank 0 of such a mesh in one process over PyTorch's
fake process group (``torch.testing._internal.distributed.fake_pg``):
collectives return at once without moving data. The fake group is the
process's default group for as long as :func:`fake_mesh` is open and is
destroyed when it closes, so it never leaks into other code.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((32, 8), ("data", "model")),
              True: ((2, 32, 8), ("pod", "data", "model"))}
MINI = {False: ((2, 2), ("data", "model")),
        True: ((2, 2, 2), ("pod", "data", "model"))}


def mesh_name(multi_pod: bool, mini: bool = False) -> str:
    if mini:
        return "mini" + ("2x2x2" if multi_pod else "2x2")
    return "gpu2x32x8" if multi_pod else "gpu32x8"


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Tuple[str, ...],
              device_type: str = "cuda", rank: int = 0
              ) -> Iterator[DeviceMesh]:
    """A ``DeviceMesh`` of ``shape`` over a fake process group of
    ``prod(shape)`` ranks, this process being ``rank``. The group is
    created here and destroyed on exit; an initialised default group
    raises."""
    import torch.testing._internal.distributed.fake_pg as fake_pg
    if dist.is_initialized():
        raise RuntimeError("a default process group is already "
                           "initialised; a fake mesh needs its own")
    dist.init_process_group("fake", rank=rank,
                            world_size=math.prod(shape),
                            store=fake_pg.FakeStore())
    try:
        yield init_device_mesh(device_type, tuple(shape),
                               mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Context manager: rank 0 of the production mesh (see the module
    docstring) over a fake group."""
    return fake_mesh(*PRODUCTION[multi_pod], device_type=device_type)


def make_mini_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Context manager: rank 0 of the (2, 2[, 2]) mini mesh over a fake
    group."""
    return fake_mesh(*MINI[multi_pod], device_type=device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The ranks of the initialised default group (real devices, one per
    process), as a 1-D ``data`` mesh (tests/examples)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised default "
                           "process group")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
