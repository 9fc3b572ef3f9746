"""Sharded index checkpoints: per-shard npz files + a manifest, the port
of graph_kmer_index_tpu/parallel/checkpoint.py. The files are the JAX
package's, byte layout and all, so each package reads the other's:

    {prefix}.manifest.npz                   layout + shapes + version
    {prefix}.shard-TTTTT-of-NNNNN.npz       one file per table shard

with deterministic shard IDs (SURVEY.md §5.4). Packed records are stored
as the JAX package's ``(groups, 128)`` uint32 per shard, k-mers as
uint64; the containers (parallel.sharded) hold the int32 ``(m2_local,
8)`` and int64 views of the same bytes.

Save works from a container whose columns hold every shard (numpy, or
tensors anywhere), or on a mesh from each rank's own shard on its card
(each rank writes its own file). Load targets the host (every shard file
read and stacked) or a mesh: each rank reads only its own table shard's
file and places it on its card, so a serving fleet never materializes
the whole table anywhere.

A row slab may be stored shorter than the manifest's shape (the
out-of-core build writes exact lengths); the loader pads it with zeros
only after checking that it holds the shard's ``shard_rows[t]`` rows,
and raises otherwise (the JAX loader pads without that check).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import TABLE_AXIS, coordinates, mesh_device
from .shard_files import _VERSION, _atomic_savez, manifest_path, shard_path
from .sharded import PackedTableShards, TableShards, _local
from ..utils.hugepages import hp_empty, hp_zeros

# per-kind column schema on disk: name -> (per-shard ndim, dtype)
_SCHEMAS = {
    "packed": {"records": (2, np.uint32), "row_kmers": (1, np.uint64),
               "row_nodes": (1, np.int32)},
    "csr": {"starts": (1, np.int64), "sizes": (1, np.int32),
            "row_kmers": (1, np.uint64), "row_nodes": (1, np.int32)},
}

def _to_disk(name: str, a: np.ndarray) -> np.ndarray:
    """One shard's column as the file holds it."""
    if name == "records":
        return a.view(np.uint32).reshape(-1, 128)
    if name == "row_kmers":
        return a.view(np.uint64)
    return a


def _from_disk(name: str, a: np.ndarray) -> np.ndarray:
    """One shard's column as the containers hold it."""
    if name == "records":
        return a.view(np.int32).reshape(-1, 8)
    if name == "row_kmers":
        return a.view(np.int64)
    return a


def _layout(shards):
    """(kind, columns, manifest fields) of a shard container."""
    if isinstance(shards, PackedTableShards):
        kind = "packed"
        cols = {"records": shards.records, "row_kmers": shards.row_kmers,
                "row_nodes": shards.row_nodes}
        meta = dict(kind=kind, version=_VERSION, n_table=shards.n_table,
                    m2_local=shards.m2_local, modulo2=shards.modulo2,
                    max_scan=shards.max_scan, has_dup=int(shards.has_dup))
    elif isinstance(shards, TableShards):
        kind = "csr"
        cols = {"starts": shards.starts, "sizes": shards.sizes,
                "row_kmers": shards.row_kmers, "row_nodes": shards.row_nodes}
        meta = dict(kind=kind, version=_VERSION, n_table=shards.n_table,
                    m_local=shards.m_local, modulo=shards.modulo,
                    max_scan=shards.max_scan)
    else:
        raise TypeError(f"not a shard container: {type(shards).__name__}")
    return kind, cols, meta


def _save_shard_file(prefix: str, kind: str, t: int, n_table: int,
                     cols: dict) -> str:
    """Shard ``t``'s file from its columns (numpy, as the containers hold
    them)."""
    path = shard_path(prefix, t, n_table)
    schema = _SCHEMAS[kind]
    _atomic_savez(path, **{
        name: np.ascontiguousarray(
            _to_disk(name, np.ascontiguousarray(cols[name]))
        ).astype(schema[name][1], copy=False)
        for name in schema})
    return path


def save_shards(shards, prefix: str, mesh=None,
                axis: str = TABLE_AXIS) -> list[str]:
    """Checkpoint a shard container to ``{prefix}.*`` files. Returns the
    paths this process wrote. Writes are atomic (tmp + rename), so a
    crashed save never leaves a torn shard file behind.

    Without a mesh the container holds every shard (numpy, or tensors
    anywhere). With a mesh every rank passes its own table shard (the
    sharded builds' output, leading axis 1, on its card): the ranks at
    data index 0 write their shard's file, rank 0 the manifest, which
    holds every shard's row count (``shard_rows``, one all-gather over
    the table group), the widest row slab's shape and ``max_node`` (an
    ``all_reduce`` MAX). Row slabs are written at their own length, which
    both packages' loaders pad; the call returns once every file is
    written."""
    kind, cols, meta = _layout(shards)
    if mesh is not None:
        return _save_own_shard(kind, cols, meta, prefix, mesh, axis)
    n_table = int(shards.n_table)
    cols = {name: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                   else np.asarray(a)) for name, a in cols.items()}
    for name, a in cols.items():
        if a.shape[0] != n_table:
            raise ValueError(f"column {name} holds {a.shape[0]} shards, "
                             f"not {n_table}")
    nodes = cols["row_nodes"]
    meta["max_node"] = int(nodes.max()) if nodes.size else 0
    shapes = {f"shape_{name}": np.asarray(_to_disk(name, a[0]).shape,
                                          dtype=np.int64)
              for name, a in cols.items()}

    written = [_save_shard_file(prefix, kind, t, n_table,
                                {name: a[t] for name, a in cols.items()})
               for t in range(n_table)]
    path = manifest_path(prefix)
    _atomic_savez(path, **meta, **shapes)
    written.append(path)
    return written


def _save_own_shard(kind, cols, meta, prefix, mesh, axis) -> list[str]:
    """save_shards on a mesh: this rank's table shard (see there)."""
    n_table = int(meta["n_table"])
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size != n_table:
        raise ValueError(f"mesh axis {axis!r} has {size} devices but the "
                         f"shards are {n_table}")
    d, t = coordinates(mesh, table_axis=axis)
    dev = mesh_device(mesh)
    group = mesh.get_group(axis)
    own = {name: _local(a, t, torch.device("cpu")).numpy()
           for name, a in cols.items()}
    rows = torch.tensor([own["row_kmers"].shape[0]], dtype=torch.int64,
                        device=dev)
    shard_rows = [torch.empty_like(rows) for _ in range(n_table)]
    dist.all_gather(shard_rows, rows, group=group)
    shard_rows = np.asarray([int(r) for r in shard_rows], dtype=np.int64)
    nodes = own["row_nodes"]
    max_node = torch.tensor([int(nodes.max()) if nodes.size else 0],
                            dtype=torch.int64, device=dev)
    dist.all_reduce(max_node, op=dist.ReduceOp.MAX, group=group)
    meta.update(max_node=int(max_node), shard_rows=shard_rows)
    shapes = {f"shape_{name}": np.asarray(
        (int(shard_rows.max()),) if name.startswith("row_")
        else _to_disk(name, a).shape, dtype=np.int64)
        for name, a in own.items()}
    written = []
    if d == 0:
        written.append(_save_shard_file(prefix, kind, t, n_table, own))
    if dist.get_rank() == 0:
        path = manifest_path(prefix)
        _atomic_savez(path, **meta, **shapes)
        written.append(path)
    # every rank returns once every file exists (a barrier on the card)
    dist.all_reduce(torch.zeros(1, device=dev))
    return written


def _read_manifest(prefix: str):
    with np.load(manifest_path(prefix)) as z:
        meta = {k: z[k] for k in z.files}
    version = int(meta["version"])
    if version > _VERSION:
        raise ValueError(f"shard checkpoint version {version} is newer "
                         f"than this library understands ({_VERSION})")
    kind = str(meta["kind"])
    if kind not in _SCHEMAS:
        raise ValueError(f"unknown shard checkpoint kind {kind!r}")
    return kind, meta


def manifest_info(prefix: str) -> dict:
    """Layout metadata of a checkpoint without reading any shard file:
    ``{"kind", "n_table", "max_scan", and the layout's modulo fields}``."""
    kind, meta = _read_manifest(prefix)
    info = {"kind": kind, "n_table": int(meta["n_table"]),
            "max_scan": int(meta["max_scan"])}
    if "max_node" in meta:
        info["max_node"] = int(meta["max_node"])
    if kind == "packed":
        info.update(m2_local=int(meta["m2_local"]),
                    modulo2=int(meta["modulo2"]),
                    has_dup=bool(int(meta["has_dup"])))
    else:
        info.update(m_local=int(meta["m_local"]),
                    modulo=int(meta["modulo"]))
    return info


def _read_shard(prefix: str, kind: str, meta: dict, t: int) -> dict:
    """Every column of shard ``t``, as the containers hold it, checked
    against the manifest; a short row slab is padded with zeros once it
    is shown to hold the shard's rows."""
    schema = _SCHEMAS[kind]
    n_table = int(meta["n_table"])
    shard_rows = meta.get("shard_rows")
    out = {}
    with np.load(shard_path(prefix, t, n_table)) as z:
        for name, (ndim, dtype) in schema.items():
            a = z[name]
            want = tuple(int(d) for d in meta[f"shape_{name}"])
            if a.ndim != ndim or a.dtype != dtype \
                    or any(g > m for g, m in zip(a.shape, want)):
                raise ValueError(
                    f"shard {t} column {name}: got {a.dtype}{a.shape}, "
                    f"manifest says {np.dtype(dtype)}{want}")
            if a.shape != want:
                # ONLY the 1-D row_* slabs may be stored short: bucket
                # tables and packed records must match exactly
                if not name.startswith("row_") or ndim != 1:
                    raise ValueError(
                        f"shard {t} column {name}: got {a.shape}, "
                        f"manifest says {want} (only row_* columns may be "
                        f"stored short)")
                if shard_rows is None or a.shape[0] < int(shard_rows[t]):
                    held = ("no shard_rows" if shard_rows is None
                            else f"{int(shard_rows[t])} rows")
                    raise ValueError(
                        f"shard {t} column {name}: a short slab of "
                        f"{a.shape[0]} rows, and the manifest says {held}")
                full = hp_zeros(want, dtype, populate=True)
                full[: a.shape[0]] = a
                a = full
            out[name] = _from_disk(name, a)
    return out


def _container(kind: str, meta: dict, cols: dict, n_table: int):
    if kind == "packed":
        return PackedTableShards(
            cols["records"], cols["row_kmers"], cols["row_nodes"],
            m2_local=int(meta["m2_local"]), modulo2=int(meta["modulo2"]),
            max_scan=int(meta["max_scan"]), n_table=n_table,
            has_dup=bool(int(meta["has_dup"])))
    return TableShards(
        cols["starts"], cols["sizes"], cols["row_kmers"],
        cols["row_nodes"], m_local=int(meta["m_local"]),
        modulo=int(meta["modulo"]), max_scan=int(meta["max_scan"]),
        n_table=n_table)


def load_shard(prefix: str, t: int, device):
    """Table shard ``t`` alone, its columns tensors on ``device`` with a
    leading axis of 1 (what a rank of a mesh holds)."""
    kind, meta = _read_manifest(prefix)
    cols = _read_shard(prefix, kind, meta, t)
    cols = {name: torch.from_numpy(a).to(device)[None]
            for name, a in cols.items()}
    return _container(kind, meta, cols, int(meta["n_table"]))


def load_shards(prefix: str, mesh=None, axis: str = TABLE_AXIS):
    """Load a shard checkpoint written by :func:`save_shards` (or by the
    JAX package's save_shards and out-of-core build).

    With ``mesh=None`` returns a host-numpy container (all shard files
    read and stacked). With a mesh, this rank's own table shard
    (:func:`load_shard`) on its card; the mesh's ``axis`` size must equal
    the checkpoint's ``n_table``."""
    kind, meta = _read_manifest(prefix)
    n_table = int(meta["n_table"])
    if mesh is not None:
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        if size != n_table:
            raise ValueError(
                f"mesh axis {axis!r} has {size} devices but the checkpoint "
                f"has {n_table} shards")
        _, t = coordinates(mesh, table_axis=axis)
        return load_shard(prefix, t, mesh_device(mesh))
    cols = {}
    for t in range(n_table):
        for name, a in _read_shard(prefix, kind, meta, t).items():
            if name not in cols:
                cols[name] = hp_empty((n_table,) + a.shape, a.dtype)
            cols[name][t] = a
    return _container(kind, meta, cols, n_table)
