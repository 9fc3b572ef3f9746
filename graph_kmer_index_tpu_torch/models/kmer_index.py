"""KmerIndex: the rows (kmers, nodes) and modulo of a collision-free k-mer
index on an explicit device, with the read-mapping queries of
graph_kmer_index_tpu.models.kmer_index.CollisionFreeKmerIndex."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lookup import DeviceKmerIndex
from ..read_kmers import DeviceReadKmers


def _as_int64(a) -> np.ndarray:
    """uint64 hashes (< 2^62) as int64, without a copy where possible."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a.astype(np.int64)


class KmerIndex:
    """``modulo`` is the source index's own (the size of its
    hashes_to_index table, as ``to_file`` stored it). The packed lookup
    does not read it: it hashes into ``internal_modulo(len(kmers))``."""

    def __init__(self, kmers: torch.Tensor, nodes: torch.Tensor,
                 modulo: int):
        self.kmers = kmers
        self.nodes = nodes
        self.modulo = int(modulo)
        self.device = kmers.device
        self.device_index = DeviceKmerIndex(kmers, nodes)

    @classmethod
    def from_arrays(cls, kmers, nodes, modulo, device) -> "KmerIndex":
        """Rows from numpy arrays or tensors, placed on ``device``."""
        dev = resolve_device(device)
        if not isinstance(kmers, torch.Tensor):
            kmers = torch.from_numpy(_as_int64(kmers))
        if not isinstance(nodes, torch.Tensor):
            nodes = torch.from_numpy(np.asarray(nodes).astype(np.int64))
        return cls(kmers.to(dev, torch.int64), nodes.to(dev, torch.int64),
                   modulo)

    @classmethod
    def from_jax_state(cls, kmers, nodes, modulo, device="cpu"):
        """The state carried across from the JAX package: its index's
        ``_kmers``, ``_nodes`` and ``_modulo`` as numpy arrays, so that
        both packages compute on the same table."""
        return cls.from_arrays(np.asarray(kmers), np.asarray(nodes),
                               int(modulo), device)

    @classmethod
    def from_file(cls, path, device) -> "KmerIndex":
        """Read the ``kmers``, ``nodes`` and ``modulo`` of the npz that
        CollisionFreeKmerIndex.to_file writes (the modulo-sized
        hashes_to_index / n_kmers tables are not loaded)."""
        try:
            data = np.load(str(path) + ".npz")
        except FileNotFoundError:
            data = np.load(path)
        with data:
            return cls.from_arrays(data["kmers"], data["nodes"],
                                   int(data["modulo"]), device)

    def max_node_id(self) -> int:
        return int(self.nodes.max())

    def _queries(self, kmers) -> torch.Tensor:
        if isinstance(kmers, torch.Tensor):
            return kmers.to(self.device, torch.int64)
        return torch.from_numpy(_as_int64(kmers)).to(self.device)

    def map_kmers(self, kmers, n_nodes: int) -> np.ndarray:
        """Node hit counts (int64, length n_nodes, nodes >= n_nodes
        dropped) for query k-mers: a DeviceReadKmers, a tensor or a numpy
        array of hashes."""
        if isinstance(kmers, DeviceReadKmers):
            counts = self.device_index.map_read_kmers(kmers, n_nodes)
        else:
            counts = self.device_index.map_kmers(self._queries(kmers), n_nodes)
        return counts.cpu().numpy()

    def has_kmers(self, kmers) -> np.ndarray:
        """Membership of each query k-mer (bool, in query order)."""
        if isinstance(kmers, DeviceReadKmers):
            hit = self.device_index.has_read_kmers(kmers)
        else:
            hit = self.device_index.has_kmers(self._queries(kmers))
        return hit.cpu().numpy()
