"""Production mesh definitions, as ``torch.distributed`` device meshes.

The port of ``repro/launch/mesh.py``, with the same mesh shapes and axis
names:

Single pod: 256 devices as (data=16, model=16).
Multi-pod: 2 pods = 512 devices as (pod=2, data=16, model=16); the "pod"
axis crosses the inter-server network -- the contended inter-server path
(b^e) of the paper's model, where the intra-server links are b^i.

The hardware constants are the NVIDIA H100 SXM5 datasheet's, per GPU.
They are published figures, not measurements: no run of this repository
measures NVLink or InfiniBand.

A production mesh runs on one process: :func:`fake_world` starts a
``"fake"`` process group of the mesh's world size (collectives are
recorded, never sent), and the dry-run builds its tensors under
``FakeTensorMode``, so full width allocates nothing.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

# H100 SXM5 constants used by the roofline (per GPU), from NVIDIA's H100
# Tensor Core GPU datasheet (SXM5 column):
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
ICI_BW = 450e9                    # bytes/s: NVLink 4, 900 GB/s
                                  # bidirectional per GPU -- the
                                  # intra-server b^i
DCN_BW = 50e9                     # bytes/s: one 400 Gb/s NDR InfiniBand NIC
                                  # per GPU, as in DGX H100 -- the
                                  # inter-server b^e
HBM_PER_DEVICE = 80 * 2**30       # bytes, H100 SXM5 80 GB
POD_CHIPS = 256

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def fake_world(size: int) -> None:
    """Make the default process group a one-process ``"fake"`` group of
    world size ``size`` (rank 0), tearing down a group of another size or
    backend first.  Collectives on it complete without sending anything.
    """
    if dist.is_initialized():
        if (dist.get_world_size() == size
                and dist.get_backend() == "fake"):
            return
        dist.destroy_process_group()
    # an internal torch API: kept to this one place
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


# (default group, shape, axes, device type) -> its mesh
_MESHES: dict = {}


def _mesh(shape: tuple, axes: tuple, device) -> DeviceMesh:
    """A mesh of ``shape`` over the default group, starting a fake group
    of that size when no group of that size is up.

    One mesh a world: the same call on the same default group returns the
    same mesh.  DTensor (torch 2.11) caches its sharding decisions by a
    mesh's layout, not by its process groups, and replays a cached
    decision on the groups it was made on.  Each new mesh makes new
    groups, so after a world of several meshes is torn down a decision
    cached there names groups that no longer exist; one mesh a world
    makes the groups of a world's mesh the first it creates, named alike
    in every world."""
    dev = resolve_device(device)
    n = math.prod(shape)
    if not (dist.is_initialized() and dist.get_world_size() == n):
        fake_world(n)
    key = (dist.group.WORLD, tuple(shape), tuple(axes), dev.type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(dev.type, shape,
                                        mesh_dim_names=axes)
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, on ``device`` (the card unless the caller asks for the
    CPU; raises without a card)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cuda") -> DeviceMesh:
    """A small (data, model) mesh over the default group (a fake one of
    ``data * model`` ranks when no group of that size is up)."""
    return _mesh((data, model), ("data", "model"), device)
