"""KmerIndex: a collision-free k-mer index on an explicit device, the port
of graph_kmer_index_tpu.models.kmer_index.CollisionFreeKmerIndex.

Layout (the JAX package's, and the reference's on disk): rows sorted by
bucket = kmer % modulo; ``hashes_to_index[bucket]`` = the bucket's first
row, ``n_kmers[bucket]`` = its size; rows carry kmers, nodes, ref_offsets,
frequencies and allele_frequencies. kmers and nodes live on the index's
device as int64, since every query path reads them. The other columns
stay as they were given (numpy arrays from a file, tensors from
``from_rows``) and move to the device when a query path reads them
(ops.lookup.DeviceKmerIndex). An index of kmers and nodes alone
(``from_arrays``) serves map/has through the packed path, which does not
need the rows in bucket order.

The query views (``device_index``, the native view) take the columns when
they are made and keep no reference to the index; every mutator ends in
``_invalidate_query_caches``, which makes them anew.

The query results are numpy arrays in the dtypes the JAX package returns:
each column's own dtype as it was given (``dtypes``), frequencies as
uint16 once ``set_frequencies`` has computed them.

Also here, as in the JAX module: MinimalKmerIndex, KmerIndex2 and
CounterKmerIndex (host numpy), and the name CollisionFreeKmerIndex for
KmerIndex.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..containers import Counter, HashTable, MultiValueHashTable
from ..device import resolve_device
from ..flat_kmers import FlatKmers, host_column, is_tensor
from ..hashing import (kmer_hashes_to_complement_hashes,
                       kmer_hashes_to_reverse_complement_hash)
from ..ops import host_buffers
from ..ops.encode import revcomp_hashes
from ..ops.lookup import DeviceKmerIndex, as_device_tensor
from ..read_kmers import DeviceReadKmers
from ..utils import profiling
from ..utils.hugepages import hp_empty, hp_zeros

# the reference's default modulo (CollisionFreeKmerIndex.from_flat_kmers)
DEFAULT_MODULO = 452930477
_COLUMNS = ("ref_offsets", "frequencies", "allele_frequencies",
            "hashes_to_index", "n_kmers")


def _np_dtype(col):
    """The numpy dtype of a column (None for a missing one)."""
    if col is None:
        return None
    if isinstance(col, torch.Tensor):
        return torch.empty(0, dtype=col.dtype).numpy().dtype
    return np.asarray(col).dtype


def _to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


def build_modulo_layout(hashes: torch.Tensor, modulo: int, row_arrays):
    """Sort rows by bucket and fill the bucket tables, in torch on the
    tensors' device (JAX _build_modulo_layout): a stable sort by
    ``hashes`` (kmer % modulo); int32 row starts (int64 from 2^31 rows)
    and int32 bucket sizes (the JAX package's uint32, the same values),
    each of length ``modulo``. Returns (starts, sizes, sorted rows,
    sorting)."""
    dev = hashes.device
    n = hashes.shape[0]
    hs, sorting = torch.sort(hashes, stable=True)
    rows = [a[sorting] for a in row_arrays]
    starts_tbl = torch.zeros(modulo, device=dev, dtype=(
        torch.int32 if n < 2 ** 31 else torch.int64))
    sizes_tbl = torch.zeros(modulo, dtype=torch.int32, device=dev)
    if n:
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = hs[1:] != hs[:-1]
        starts = torch.nonzero(first).flatten()
        sizes = torch.diff(starts, append=torch.tensor([n], device=dev))
        buckets = hs[starts]
        starts_tbl[buckets] = starts.to(starts_tbl.dtype)
        sizes_tbl[buckets] = sizes.to(torch.int32)
    return starts_tbl, sizes_tbl, rows, sorting


def frequencies_by_distinct_ref_offsets(kmers: torch.Tensor,
                                        ref_offsets: torch.Tensor):
    """frequency[row] = the number of DISTINCT ref offsets among the rows
    of its k-mer, wrapped to 16 bits as the JAX package's uint16 column
    (JAX _frequencies_by_distinct_ref_offsets). Its lexsort by (kmer,
    ref_offset) is two stable sorts here. int32 values in [0, 2^16)."""
    n = kmers.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=kmers.device)
    by_offset = torch.sort(ref_offsets, stable=True).indices
    order = by_offset[torch.sort(kmers[by_offset], stable=True).indices]
    km, ro = kmers[order], ref_offsets[order]
    new_kmer = torch.ones(n, dtype=torch.bool, device=kmers.device)
    new_kmer[1:] = km[1:] != km[:-1]
    new_pair = new_kmer.clone()
    new_pair[1:] |= ro[1:] != ro[:-1]
    seg = torch.cumsum(new_kmer, 0) - 1
    per_kmer = torch.bincount(seg[new_pair], minlength=int(seg[-1]) + 1)
    freqs = torch.empty(n, dtype=torch.int32, device=kmers.device)
    freqs[order] = (per_kmer[seg] & 0xFFFF).to(torch.int32)
    return freqs


def numpy_modulo_layout(hashes, modulo, row_arrays):
    """:func:`build_modulo_layout` on the host in numpy, for the index
    models that live there (JAX _build_modulo_layout): int32 row starts
    (int64 from 2^31 rows) and uint32 bucket sizes of length ``modulo``,
    the rows sorted by ``hashes``, and the sorting."""
    sorting = np.argsort(hashes, kind="stable")

    def take(a):
        out = hp_empty(len(a), a.dtype)
        np.take(a, sorting, out=out)
        return out
    hashes = take(hashes)
    rows = [take(a) for a in row_arrays]
    # ediff1d on an EMPTY array still emits the to_begin element, which
    # would fabricate a bucket start at row 0 of a 0-row table
    diffs = (np.ediff1d(hashes, to_begin=hashes.dtype.type(1))
             if len(hashes) else np.zeros(0, np.int64))
    starts = np.nonzero(diffs)[0]
    unique_hashes = hashes[starts].astype(np.int64)
    idx_dtype = np.int32 if len(hashes) < 2**31 else np.int64
    lookup = hp_zeros(modulo, idx_dtype, populate=True)
    lookup[unique_hashes] = starts
    n_entries = np.ediff1d(starts, to_end=len(hashes) - starts[-1]) \
        if len(starts) else np.zeros(0, dtype=np.int64)
    n_kmers = hp_zeros(modulo, np.uint32, populate=True)
    n_kmers[unique_hashes] = n_entries
    return lookup, n_kmers, rows, sorting


# the JAX class's property names (the keys of an IndexBundle entry) ->
# this class's attributes
_PROPERTY_TO_ATTRIBUTE = {
    "_hashes_to_index": "hashes_to_index", "_n_kmers": "n_kmers",
    "_nodes": "nodes", "_ref_offsets": "ref_offsets", "_kmers": "kmers",
    "_frequencies": "frequencies",
    "_allele_frequencies": "allele_frequencies",
}


class KmerIndex:
    """``modulo`` is the reference modulo of the bucket layout (the size
    of hashes_to_index). The packed lookup does not read it: it hashes
    into ``internal_modulo(len(kmers))``."""

    # the JAX class's properties: what an IndexBundle stores of an index
    properties = set(_PROPERTY_TO_ATTRIBUTE) | {"_modulo"}

    # below this batch size the scalar get loop is used, as in the JAX
    # package
    _BATCH_QUERY_THRESHOLD = 32

    def __init__(self, kmers: torch.Tensor, nodes: torch.Tensor,
                 modulo: int, *, ref_offsets=None, frequencies=0,
                 allele_frequencies=None, hashes_to_index=None,
                 n_kmers=None, dtypes=None):
        self.kmers = kmers
        self.nodes = nodes
        self.modulo = int(modulo)
        self.device = kmers.device
        self.ref_offsets = ref_offsets
        self.frequencies = frequencies
        self.allele_frequencies = allele_frequencies
        self.hashes_to_index = hashes_to_index
        self.n_kmers = n_kmers
        self.dtypes = {"kmers": np.dtype(np.int64), "nodes": _np_dtype(nodes)}
        for name in _COLUMNS:
            self.dtypes[name] = _np_dtype(getattr(self, name))
        self.dtypes.update(dtypes or {})
        self._invalidate_query_caches()

    @classmethod
    def from_arrays(cls, kmers, nodes, modulo, device,
                    **columns) -> "KmerIndex":
        """Rows from numpy arrays or tensors: kmers and nodes placed on
        ``device`` as int64, the other columns (keywords of the
        constructor) kept as they are."""
        dev = resolve_device(device)
        return cls(as_device_tensor(kmers, torch.int64, dev),
                   as_device_tensor(nodes, torch.int64, dev), modulo,
                   dtypes={"nodes": _np_dtype(nodes)}, **columns)

    @classmethod
    def from_jax_state(cls, kmers, nodes, modulo, device="cpu", **columns):
        """The state carried across from the JAX package: its index's
        ``_kmers``, ``_nodes`` and ``_modulo`` (and, as keywords, any
        other column) as numpy arrays, so that both packages compute on
        the same table."""
        return cls.from_arrays(np.asarray(kmers), np.asarray(nodes),
                               int(modulo), device, **columns)

    @classmethod
    def from_properties(cls, properties: dict, device) -> "KmerIndex":
        """An index from the JAX class's eight properties under their
        names there (``_kmers``, ``_nodes``, ``_modulo``,
        ``_hashes_to_index``, ``_n_kmers``, ``_ref_offsets``,
        ``_frequencies``, ``_allele_frequencies``) as numpy arrays: the
        entry of an IndexBundle, or a JAX-package index's attributes. A
        missing column stays None (frequencies: 0)."""
        columns = {attr: properties[prop]
                   for prop, attr in _PROPERTY_TO_ATTRIBUTE.items()
                   if properties.get(prop) is not None
                   and attr not in ("kmers", "nodes")}
        return cls.from_arrays(
            np.asarray(properties["_kmers"]), np.asarray(properties["_nodes"]),
            int(properties.get("_modulo", DEFAULT_MODULO)), device, **columns)

    def to_properties(self) -> dict:
        """The inverse of :meth:`from_properties`: host numpy arrays in
        the dtypes of the JAX class's file (k-mers uint64), a placeholder
        column as it is, ``_modulo`` an int."""
        out = {prop: self._file_column(attr)
               for prop, attr in _PROPERTY_TO_ATTRIBUTE.items()
               if getattr(self, attr) is not None}
        out["_modulo"] = int(self.modulo)
        return out

    @classmethod
    def from_rows(cls, kmers, nodes, ref_offsets, allele_frequencies,
                  modulo=DEFAULT_MODULO, *, device,
                  skip_frequencies=False, dtypes=None) -> "KmerIndex":
        """Build the bucket layout from unsorted rows (numpy arrays or
        tensors) on ``device``: CollisionFreeKmerIndex.from_flat_kmers
        with arrays in place of a FlatKmers. ``dtypes`` names the numpy
        dtype a column's query results take where it is not the column's
        own (a tensor cannot say uint64)."""
        dev = resolve_device(device)
        dtypes = {"nodes": _np_dtype(nodes),
                  "ref_offsets": _np_dtype(ref_offsets),
                  "allele_frequencies": _np_dtype(allele_frequencies),
                  "n_kmers": np.dtype(np.uint32),
                  **(dtypes or {})}
        with profiling.span("kmer_index.build"):
            km = as_device_tensor(kmers, torch.int64, dev)
            cols = [km, as_device_tensor(nodes, torch.int64, dev),
                    as_device_tensor(ref_offsets, torch.int64, dev),
                    as_device_tensor(allele_frequencies, None, dev)]
            starts, sizes, (km, nd, ro, af), _ = build_modulo_layout(
                km % int(modulo), int(modulo), cols)
            index = cls(km, nd, modulo, ref_offsets=ro,
                        allele_frequencies=af, hashes_to_index=starts,
                        n_kmers=sizes, dtypes=dtypes)
            index.set_frequencies(skip_frequencies)
            return index

    @classmethod
    def from_flat_kmers(cls, flat_kmers, modulo=DEFAULT_MODULO,
                        skip_frequencies=False, skip_singletons=False, *,
                        device) -> "KmerIndex":
        """CollisionFreeKmerIndex.from_flat_kmers on ``device``. A
        FlatKmers whose columns are tensors on ``device`` (a device
        finalize's, parallel.host_pool.find_kmers_parallel_device) is
        built where it lies, with no trip through the host; numpy columns
        are uploaded once. ``skip_singletons`` drops every hash's first
        row and adds one to every frequency (in 16 bits), as there."""
        if skip_singletons:
            flat_kmers = flat_kmers.get_new_without_singletons()
        # a tensor holds the uint64 ref offsets' bits as int64
        dtypes = ({"ref_offsets": np.dtype(np.uint64)}
                  if is_tensor(flat_kmers._ref_offsets) else None)
        index = cls.from_rows(
            flat_kmers._hashes, flat_kmers._nodes, flat_kmers._ref_offsets,
            flat_kmers._allele_frequencies, modulo, device=device,
            skip_frequencies=skip_frequencies, dtypes=dtypes)
        if skip_singletons:
            index.frequencies = (index.frequencies + 1) & 0xFFFF
            index._invalidate_query_caches()
        return index

    def _file_column(self, name: str):
        """A column as the npz of CollisionFreeKmerIndex.to_file holds it:
        k-mers uint64, every other column in its dtype (``dtypes``; a
        built index's bucket sizes are uint32)."""
        col = getattr(self, name)
        if not isinstance(col, torch.Tensor):
            return col
        a = _to_numpy(col, self.dtypes[name])
        return a.view(np.uint64) if name == "kmers" else a

    def to_file(self, file_name) -> None:
        """The npz that CollisionFreeKmerIndex.from_file (and
        :meth:`from_file`) reads."""
        np.savez(file_name, modulo=self.modulo,
                 **{name: self._file_column(name)
                    for name in ("kmers", "nodes") + _COLUMNS})

    @classmethod
    def from_file(cls, path, device) -> "KmerIndex":
        """Every column of the npz that CollisionFreeKmerIndex.to_file
        writes; allele frequencies default to float64 zeros when the file
        has none, as in the JAX package."""
        try:
            data = np.load(str(path) + ".npz")
        except FileNotFoundError:
            data = np.load(path)
        with data:
            af = (data["allele_frequencies"] if "allele_frequencies" in data
                  else np.zeros(len(data["ref_offsets"])))
            return cls.from_arrays(
                data["kmers"], data["nodes"], int(data["modulo"]), device,
                ref_offsets=data["ref_offsets"],
                frequencies=data["frequencies"], allele_frequencies=af,
                hashes_to_index=data["hashes_to_index"],
                n_kmers=data["n_kmers"])

    # -- maintenance ---------------------------------------------------------

    def _invalidate_query_caches(self) -> None:
        """A fresh device view, and no native view, after a column
        changes: the views hold the columns they were made from, so no
        query reads a stale copy. Every mutator ends here; a cleared
        index has no views."""
        self.device_index = (None if self.kmers is None
                             else DeviceKmerIndex(self))
        self._native_index = None

    def set_frequencies(self, skip=False) -> None:
        """Frequencies by distinct ref offsets, computed on the index's
        device (zeros with ``skip``); uint16 values, as in the JAX
        package."""
        self.dtypes["frequencies"] = np.dtype(np.uint16)
        if skip:
            self.frequencies = torch.zeros(self.kmers.shape[0],
                                           dtype=torch.int32,
                                           device=self.device)
        else:
            self.frequencies = frequencies_by_distinct_ref_offsets(
                self.kmers,
                as_device_tensor(self.ref_offsets, torch.int64, self.device))
        self._invalidate_query_caches()

    def remove_ref_offsets(self) -> None:
        self.ref_offsets = np.array([0])
        self.dtypes["ref_offsets"] = self.ref_offsets.dtype
        self._invalidate_query_caches()

    def remove_frequencies(self) -> None:
        self.frequencies = np.array([0])
        self.dtypes["frequencies"] = self.frequencies.dtype
        self._invalidate_query_caches()

    def max_node_id(self) -> int:
        return int(self.nodes.max())

    def set_frequencies_using_other_index(self, other, multiplier=1,
                                          min_frequency=1) -> None:
        """frequency[row] = max(min_frequency, multiplier x the frequency
        of the row's k-mer in ``other``), where ``other`` is anything with
        ``get_frequencies`` (reference collision_free_kmer_index.py:252-265).
        The distinct k-mers are found, and each row matched to its own,
        on the index's device; the column comes back in its dtype."""
        unique = torch.unique(self.kmers)
        queries = (unique if isinstance(other, KmerIndex)
                   else unique.cpu().numpy().view(np.uint64))
        freqs = np.asarray(other.get_frequencies(queries), dtype=np.int64)
        idx = torch.searchsorted(unique, self.kmers).cpu().numpy()
        dtype = (self.dtypes["frequencies"] if np.ndim(self.frequencies)
                 else np.dtype(np.uint16))
        self.frequencies = np.maximum(
            min_frequency, freqs[idx] * multiplier).astype(dtype)
        self.dtypes["frequencies"] = dtype
        self._invalidate_query_caches()

    def set_allele_frequencies(self, frequencies) -> None:
        pass  # reference no-op (collision_free_kmer_index.py:234-235)

    def copy(self) -> "KmerIndex":
        def dup(col):
            if isinstance(col, torch.Tensor):
                return col.clone()
            return col.copy() if np.ndim(col) else col

        return KmerIndex(
            dup(self.kmers), dup(self.nodes), self.modulo,
            dtypes=dict(self.dtypes),
            **{name: dup(getattr(self, name)) for name in _COLUMNS})

    def clear(self) -> None:
        self.hashes_to_index = None
        self.n_kmers = None
        self.nodes = None
        self.kmers = None
        self.modulo = None
        self._invalidate_query_caches()

    def convert_to_int32(self) -> None:
        """Bucket tables and nodes as int32 (in every result and file;
        the node column on the device stays int64, which the lookup
        kernel reads)."""
        for name in ("hashes_to_index", "n_kmers"):
            col = getattr(self, name)
            setattr(self, name, col.to(torch.int32)
                    if isinstance(col, torch.Tensor)
                    else np.asarray(col).astype(np.int32))
        for name in ("hashes_to_index", "n_kmers", "nodes"):
            self.dtypes[name] = np.dtype(np.int32)
        self._invalidate_query_caches()

    def get_kmers(self) -> np.ndarray:
        return self._file_column("kmers")

    def convert_kmers_to_complement(self, k=31,
                                    skip_frequencies=True) -> "KmerIndex":
        """A new index over the base-complemented k-mers (same order of
        bases), on this index's device."""
        kmers = self._file_column("kmers")
        chunks = np.array_split(kmers, max(1, len(kmers) // 10000000))
        new_kmers = np.concatenate(
            [kmer_hashes_to_complement_hashes(c, k) for c in chunks])
        return KmerIndex.from_flat_kmers(
            FlatKmers(new_kmers, self._file_column("nodes"),
                      self._file_column("ref_offsets"),
                      self._file_column("allele_frequencies")),
            modulo=self.modulo, skip_frequencies=skip_frequencies,
            device=self.device)

    # -- scalar queries (API parity) -----------------------------------------

    def _rows_of(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Rows of a column as numpy in its dtype; a tensor column is
        indexed where it lies."""
        col = getattr(self, name)
        if isinstance(col, torch.Tensor):
            picked = col[torch.from_numpy(rows).to(col.device)]
            return _to_numpy(picked, self.dtypes[name])
        return np.asarray(col)[rows]

    def get(self, kmer, max_hits=10):
        """(nodes, ref_offsets, frequencies, allele_frequencies) of the
        rows that hold ``kmer``, or four Nones when there are none or the
        first row's frequency exceeds ``max_hits``."""
        kmer = int(kmer)
        h = kmer % self.modulo
        position = int(self.hashes_to_index[h])
        n_hits = int(self.n_kmers[h])
        bucket = self._rows_of("kmers", np.arange(position,
                                                  position + n_hits))
        rows = np.nonzero(bucket.view(np.uint64) == np.uint64(kmer))[0]
        rows += position
        frequencies = self._rows_of("frequencies", rows)
        allele_frequencies = self._rows_of("allele_frequencies", rows)
        if len(rows) == 0 or frequencies[0] > max_hits:
            return None, None, None, None
        return (self._rows_of("nodes", rows),
                self._rows_of("ref_offsets", rows), frequencies,
                allele_frequencies)

    def __contains__(self, item) -> bool:
        return self.get(int(item), 100000000000)[0] is not None

    def get_nodes(self, kmer, max_hits=10):
        return self.get(kmer, max_hits)[0]

    def get_grouped_nodes(self, kmer, max_hits=10):
        hits = self.get(kmer, max_hits)
        if hits[0] is None:
            return None
        nodes, ref_offsets = hits[0], hits[1]
        sorting = np.argsort(ref_offsets, kind="stable")
        ref_offsets = ref_offsets[sorting]
        nodes = nodes[sorting]
        _, starts = np.unique(ref_offsets, return_index=True)
        bounds = list(starts) + [len(ref_offsets)]
        return [nodes[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def get_frequency(self, kmer, include_reverse_complement=True, k=31):
        hits = self.get(kmer, max_hits=10**15)
        f = 0 if hits[0] is None else int(hits[2][0])
        if include_reverse_complement:
            rev = int(kmer_hashes_to_reverse_complement_hash(
                np.array([kmer], dtype=np.uint64), k)[0])
            rhits = self.get(rev, max_hits=10**15)
            if rhits[0] is not None:
                f += int(rhits[2][0])
        return f

    def get_frequencies(self, kmers, include_reverse_complement=True,
                        k=31, backend=None) -> np.ndarray:
        """:meth:`get_frequency` of a batch (a tensor or a numpy array of
        hashes), int64: the first hit's frequency plus the reverse
        complement's first hit's, the complement taken with ``k`` = 31
        unless the caller names another (the reference's quirk, kept).
        ``backend`` 'device' answers from the bucket ranges on the
        index's device (plain torch; no column leaves the device),
        'native' through the host C++ library, as the JAX package does
        (an index on a CUDA device is copied to the host once for it);
        None: 'device' for an index on a CUDA device, and for one on the
        CPU 'native' where the library is there. The same numbers either
        way."""
        q = self._queries(kmers)
        if backend is None:
            backend = ("native" if self.device.type == "cpu"
                       and self._native() is not None else "device")
        if backend == "device":
            first_frequencies = self.device_index.first_frequencies
            freqs = first_frequencies(q)
            if include_reverse_complement:
                freqs = freqs + first_frequencies(revcomp_hashes(q, k))
            return freqs.cpu().numpy()
        if backend != "native":
            raise ValueError(f"unknown backend {backend!r}")
        nk = self._native()
        if nk is None:
            raise RuntimeError("the native host library is not available")
        big = 1 << 60

        def first_freqs(qs):
            hits = nk.get(qs, hit_cap=big, freq_cap=big)
            out = np.zeros(len(qs), dtype=np.int64)
            qi = hits[2].astype(np.int64)
            # reversed write: the FIRST hit per query wins
            out[qi[::-1]] = hits[3][::-1].astype(np.int64)
            return out

        queries = q.cpu().numpy().view(np.uint64)
        freqs = first_freqs(queries)
        if include_reverse_complement:
            freqs = freqs + first_freqs(
                kmer_hashes_to_reverse_complement_hash(queries, k))
        return freqs

    # -- batched queries -------------------------------------------------------

    def _queries(self, kmers) -> torch.Tensor:
        """The queries as int64 on the index's device, uint64 bits kept.
        Host queries bound for a CUDA device go through its staging ring
        of pinned blocks (ops/host_buffers.py: ``upload``); a tensor
        already on a device is used as it is, and a CPU index reads a host
        array in place."""
        with profiling.span("kmer_index.upload"):
            if self.device.type == "cuda" and not (
                    isinstance(kmers, torch.Tensor)
                    and kmers.device.type != "cpu"):
                return host_buffers.upload(kmers, self.device)
            if not isinstance(kmers, torch.Tensor):
                kmers = np.asarray(kmers, dtype=np.uint64)
            return as_device_tensor(kmers, torch.int64, self.device)

    def _native(self):
        """The native (C++) view of this index, made at first use; None
        without the native library."""
        if self._native_index is None:
            from .native_index import NativeKmerIndex
            self._native_index = (NativeKmerIndex(self)
                                  if NativeKmerIndex.available() else False)
        return self._native_index or None

    def _host_queries(self, kmers) -> np.ndarray:
        if isinstance(kmers, DeviceReadKmers):
            return kmers.to_numpy()
        return np.ascontiguousarray(host_column(kmers, unsigned=True),
                                    dtype=np.uint64)

    def map_kmers(self, kmers, n_nodes: int, backend="device") -> np.ndarray:
        """Node hit counts (int64, length n_nodes, nodes >= n_nodes
        dropped) for query k-mers: a DeviceReadKmers, a tensor or a numpy
        array of hashes. ``backend``: 'device' (the lookup on the index's
        device) or 'native' (host C++; the device lookup where there is
        no native library, as in the JAX package). Counts made on a CUDA
        device come back in a pinned host block (ops/host_buffers.py),
        lent until the returned array and every view of it are gone."""
        with profiling.span("kmer_index.map_kmers"):
            if backend == "native" and self._native() is not None:
                return self._native().map_kmers(self._host_queries(kmers),
                                                n_nodes)
            if isinstance(kmers, DeviceReadKmers):
                counts = self.device_index.map_read_kmers(kmers, n_nodes)
            else:
                counts = self.device_index.map_kmers(self._queries(kmers),
                                                     n_nodes)
            with profiling.span("kmer_index.counts_to_host"):
                if counts.device.type != "cuda":
                    return counts.cpu().numpy()
                block = host_buffers.take(counts.numel(), counts.dtype)
                block.copy_(counts)
                return block.numpy()

    def has_kmers(self, kmers, backend="device") -> np.ndarray:
        """Membership of each query k-mer (bool, in query order)."""
        if backend == "native" and self._native() is not None:
            return self._native().has_kmers(self._host_queries(kmers))
        if isinstance(kmers, DeviceReadKmers):
            hit = self.device_index.has_read_kmers(kmers)
        else:
            hit = self.device_index.has_kmers(self._queries(kmers))
        return hit.cpu().numpy()

    def has_kmers_parallel(self, kmers, n_threads) -> np.ndarray:
        """Membership, the queries cut into ``n_threads`` parts (the
        reference forks processes, the JAX package shards over a mesh; the
        answer is the same). Inside a started process group the parts go
        to the ranks (parallel.sharded.has_kmers_sharded, every rank
        holding this index); outside one they are answered one after
        another on the index's device."""
        if dist.is_initialized():
            from ..parallel.sharded import has_kmers_sharded
            return has_kmers_sharded(self, kmers, n_shards=n_threads)
        q = self._queries(kmers)
        parts = [self.device_index.has_kmers(c)
                 for c in torch.tensor_split(q, max(1, int(n_threads)))]
        return torch.cat(parts).cpu().numpy()

    def get_batched(self, kmers, max_hits=10) -> np.ndarray:
        """(5, n_hits) uint64 [node, ref_offset, query index, frequency,
        int(1000 * allele_frequency)] with the default caps: the
        CythonKmerIndex.get contract, bucket-0 k-mers looked up like any
        other (PARITY.md)."""
        out = self.device_index.get_batched(self._queries(kmers),
                                            max_hits=max_hits)
        return out.cpu().numpy().astype(np.uint64)

    def _result_dtype(self, name: str, default):
        return (self.dtypes[name] if np.ndim(getattr(self, name))
                else np.dtype(default))

    def get_nodes_and_ref_offsets_from_multiple_kmers(self, kmers,
                                                      max_hits=10):
        """Batched ``get``: (nodes, ref_offsets, query index as float64,
        frequencies) of every hit. A query is dropped whole when its FIRST
        hit's frequency exceeds ``max_hits``; no cap applies otherwise."""
        q = self._queries(kmers)
        if q.shape[0] < self._BATCH_QUERY_THRESHOLD:
            return self._get_from_multiple_kmers_scalar(
                q.cpu().numpy().view(np.uint64), max_hits)
        big = (1 << 31) - 1  # the JAX package's caps off
        out = self.device_index.get_batched(q, hit_cap=big, frequency_cap=big)
        nodes, offs, qi, freqs = out[0], out[1], out[2], out[3]
        if qi.shape[0] == 0:
            return (np.array([]),) * 4
        # rows come grouped by query; the first row of each group carries
        # the frequency that gates the whole query
        first = torch.ones_like(qi, dtype=torch.bool)
        first[1:] = qi[1:] != qi[:-1]
        keep_query = torch.zeros(q.shape[0], dtype=torch.bool,
                                 device=q.device)
        keep_query[qi[first]] = freqs[first] <= max_hits
        keep = keep_query[qi]
        return (_to_numpy(nodes[keep], self.dtypes["nodes"]),
                _to_numpy(offs[keep], self._result_dtype("ref_offsets",
                                                         np.int64)),
                _to_numpy(qi[keep], np.float64),
                _to_numpy(freqs[keep], self._result_dtype("frequencies",
                                                          np.uint16)))

    def _get_from_multiple_kmers_scalar(self, kmers, max_hits):
        all_nodes, all_offsets, all_read_offsets, all_freqs = [], [], [], []
        for i, h in enumerate(kmers):
            nodes, offs, freqs, _ = self.get(h, max_hits=max_hits)
            if nodes is None:
                continue
            all_nodes.append(nodes)
            all_offsets.append(offs)
            all_read_offsets.append(np.zeros(len(nodes)) + i)
            all_freqs.append(freqs)
        if not all_nodes:
            return (np.array([]),) * 4
        return (np.concatenate(all_nodes), np.concatenate(all_offsets),
                np.concatenate(all_read_offsets), np.concatenate(all_freqs))

    def get_nodes_from_multiple_kmers(self, kmers, max_hits=10):
        kmers = (kmers.cpu().numpy().view(np.uint64)
                 if isinstance(kmers, torch.Tensor)
                 else np.asarray(kmers, dtype=np.uint64))
        if len(kmers) >= self._BATCH_QUERY_THRESHOLD:
            return self.get_nodes_and_ref_offsets_from_multiple_kmers(
                kmers, max_hits=max_hits)[0]
        out = [self.get(h, max_hits=max_hits)[0] for h in kmers]
        out = [o for o in out if o is not None]
        return np.concatenate(out) if out else np.array([])


CollisionFreeKmerIndex = KmerIndex


class MinimalKmerIndex:
    """Modulo layout minus ref_offsets/frequencies (reference
    collision_free_kmer_index.py:44-106); host numpy."""

    def __init__(self, hashes_to_index, n_kmers, nodes, kmers, modulo):
        self._hashes_to_index = hashes_to_index.astype(np.int64)
        self._n_kmers = n_kmers.astype(np.uint32)
        self._nodes = nodes.astype(np.uint32)
        self._kmers = kmers
        self._modulo = np.int64(modulo)

    def max_node_id(self):
        return int(np.max(self._nodes))

    def to_file(self, file_name):
        np.savez(file_name, hashes_to_index=self._hashes_to_index,
                 n_kmers=self._n_kmers, nodes=self._nodes, kmers=self._kmers,
                 modulo=self._modulo)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(str(file_name) + ".npz")
        except FileNotFoundError:
            data = np.load(file_name)
        return cls(data["hashes_to_index"], data["n_kmers"], data["nodes"],
                   data["kmers"], data["modulo"])

    @classmethod
    def from_flat_kmers(cls, flat_kmers, modulo=DEFAULT_MODULO):
        kmers = np.asarray(host_column(flat_kmers._hashes, unsigned=True),
                           dtype=np.uint64)
        hashes = kmers % np.uint64(modulo)
        lookup, n_kmers, rows, _ = numpy_modulo_layout(
            hashes, modulo, [kmers, host_column(flat_kmers._nodes)])
        kmers_s, nodes_s = rows
        return cls(lookup, n_kmers, nodes_s, kmers_s, modulo)


class KmerIndex2:
    """kmer -> {nodes, start_nodes, start_offsets, allele_frequencies}
    multi-map (reference collision_free_kmer_index.py:110-158); frequency =
    number of unique (start_node, start_offset) pairs per kmer."""

    def __init__(self, data, frequencies=None):
        self._data = data
        self._frequencies = frequencies

    def get_start_nodes(self, kmer):
        return self._data[kmer]["start_nodes"]

    def get_start_offsets(self, kmer):
        return self._data[kmer]["start_offsets"]

    def get_nodes(self, kmer):
        return self._data[kmer]["nodes"]

    def get_all_kmers(self):
        return self._data.get_all_keys()

    def get_kmer_frequency(self, kmer):
        assert self._frequencies is not None, "Frequencies not set"
        return self._frequencies[kmer]

    @classmethod
    def from_flat_kmers(cls, flat_kmers, modulo=None, skip_frequencies=False):
        table = MultiValueHashTable.from_keys_and_values(
            np.asarray(flat_kmers._hashes),
            {"nodes": np.asarray(flat_kmers._nodes),
             "start_nodes": np.asarray(flat_kmers._start_nodes),
             "start_offsets": np.asarray(flat_kmers._start_offsets),
             "allele_frequencies": np.asarray(flat_kmers._allele_frequencies)},
            mod=modulo)
        index = cls(table)
        if not skip_frequencies:
            index.count_unique_kmer_occurences()
        return index

    def count_unique_kmer_occurences(self):
        """Vectorized: distinct (start_node, start_offset) pairs per kmer.
        NB keys must come from row_keys() — get_all_keys() returns the
        hash-sorted layout, which would pair scrambled rows against the
        insertion-ordered value arrays and miscount."""
        kmers = self._data.row_keys()
        if len(np.asarray(kmers)) == 0:
            # ediff1d on empty arrays still emits to_begin
            self._frequencies = HashTable(np.zeros(0, np.int64),
                                          np.zeros(0, np.int64))
            return
        sn = self._data._values["start_nodes"]
        so = self._data._values["start_offsets"]
        order = np.lexsort((np.asarray(so), np.asarray(sn), np.asarray(kmers)))
        km, s1, s2 = (np.asarray(kmers)[order], np.asarray(sn)[order],
                      np.asarray(so)[order])
        new_kmer = np.ediff1d(km, to_begin=km.dtype.type(1)) != 0
        new_pair = new_kmer | (np.ediff1d(s1, to_begin=s1.dtype.type(1)) != 0) | \
            (np.ediff1d(s2, to_begin=s2.dtype.type(1)) != 0)
        seg = np.cumsum(new_kmer) - 1
        counts = np.bincount(seg, weights=new_pair.astype(np.int64)).astype(
            np.int64)
        self._frequencies = HashTable(km[new_kmer], counts)


class CounterKmerIndex:
    """Counter over index kmers; get_node_counts = bincount(nodes,
    counter[kmers]) — the genotyping node-count kernel (reference
    collision_free_kmer_index.py:14-40); host numpy."""

    def __init__(self, kmers, nodes, counter):
        self.kmers = kmers
        self.nodes = nodes
        self.counter = counter

    @classmethod
    def from_kmer_index(cls, kmer_index, modulo=None):
        kmers = kmer_index._file_column("kmers").astype(np.int64)
        nodes = kmer_index._file_column("nodes")
        unique_kmers = np.unique(kmers)
        counter = Counter(unique_kmers, 0,
                          mod=modulo if modulo else kmer_index.modulo,
                          value_dtype=np.uint16)
        return cls(kmers, nodes, counter)

    def count_kmers(self, kmers, update_counter=True):
        if not update_counter:
            self.counter._counts[:] = 0
        self.counter.count(np.asarray(kmers).astype(np.int64))

    def get_node_counts(self, min_nodes=0):
        return np.bincount(self.nodes, self.counter[self.kmers],
                           minlength=min_nodes)
