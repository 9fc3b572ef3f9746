"""Meshes of ranks over torch.distributed: the port of
graph_kmer_index_tpu/parallel/mesh.py.

A JAX mesh is the devices one program sees; here it is the ranks of a
process group, one rank per card. The group is started explicitly
(:func:`start_process_group`): an init method (``tcp://address:port``), a
world size and a rank, NCCL for ``cuda`` and gloo for ``cpu``; a single
rank needs no address. Nothing is read from the environment here (the CLI
reads a launcher's variables and passes them on).

Rank ``r`` sits at data index ``r // n_table`` and table index
``r % n_table``: the JAX package's ``devices.reshape(n_data, n_table)``.
The JAX collectives map to ``all_reduce``: ``psum(..., ("data",
"table"))`` over the world, ``psum(..., "table")`` over the rank's table
subgroup (:func:`subgroups`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS, TABLE_AXIS = "data", "table"


def start_process_group(device="cuda", init_method=None, world_size=1,
                        rank=0, local_rank=None) -> torch.device:
    """Join (or, as rank 0, start) the default process group and return
    this rank's device: NCCL on ``cuda`` (card ``local_rank``, by default
    ``rank`` modulo the cards present), gloo on ``cpu``. More than one
    rank needs ``init_method``; one rank alone uses an in-process store."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already started")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_rank is None:
            local_rank = rank % torch.cuda.device_count()
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks need an init method "
                             "(tcp://address:port)")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return dev


def stop_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def build_mesh(n_data: int | None = None, n_table: int = 1,
               data_axis: str = DATA_AXIS, table_axis: str = TABLE_AXIS):
    """2-D mesh over every rank of the started group: ``data`` shards
    read/query batches, ``table`` shards bucket ranges of the k-mer table
    (for indexes too big for one card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(start_process_group)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_table
    if n_data * n_table != world:
        raise ValueError(f"a {n_data} x {n_table} mesh needs "
                         f"{n_data * n_table} ranks, the group has {world}")
    return init_device_mesh(group_device().type, (n_data, n_table),
                            mesh_dim_names=(data_axis, table_axis))


def data_mesh(n_devices: int | None = None, axis: str = DATA_AXIS):
    """A mesh whose ``data`` dimension holds every rank (the table
    replicated, as a (n, 1) mesh)."""
    return build_mesh(n_devices, 1, data_axis=axis)


def subgroups(mesh, data_axis: str = DATA_AXIS, table_axis: str = TABLE_AXIS):
    """(data subgroup, table subgroup) of this rank: the ranks that share
    its table index, and those that share its data index."""
    return mesh.get_group(data_axis), mesh.get_group(table_axis)


def coordinates(mesh, data_axis: str = DATA_AXIS,
                table_axis: str = TABLE_AXIS) -> tuple[int, int]:
    """(data index, table index) of this rank."""
    return mesh.get_local_rank(data_axis), mesh.get_local_rank(table_axis)


def group_device() -> torch.device:
    """The device of this rank's tensors in the started group: its card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
