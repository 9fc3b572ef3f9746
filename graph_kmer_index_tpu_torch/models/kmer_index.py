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

The query results are numpy arrays in the dtypes the JAX package returns:
each column's own dtype as it was given (``dtypes``), frequencies as
uint16 once ``set_frequencies`` has computed them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..flat_kmers import is_tensor
from ..ops.lookup import DeviceKmerIndex, as_device_tensor
from ..read_kmers import DeviceReadKmers

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


class KmerIndex:
    """``modulo`` is the reference modulo of the bucket layout (the size
    of hashes_to_index). The packed lookup does not read it: it hashes
    into ``internal_modulo(len(kmers))``."""

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
        self.device_index = DeviceKmerIndex(self)

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
                  **(dtypes or {})}
        km = as_device_tensor(kmers, torch.int64, dev)
        cols = [km, as_device_tensor(nodes, torch.int64, dev),
                as_device_tensor(ref_offsets, torch.int64, dev),
                as_device_tensor(allele_frequencies, None, dev)]
        starts, sizes, (km, nd, ro, af), _ = build_modulo_layout(
            km % int(modulo), int(modulo), cols)
        index = cls(km, nd, modulo, ref_offsets=ro, allele_frequencies=af,
                    hashes_to_index=starts, n_kmers=sizes, dtypes=dtypes)
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
            index._invalidate_query_caches()
            index.frequencies = (index.frequencies + 1) & 0xFFFF
        return index

    def _file_column(self, name: str):
        """A column as the npz of CollisionFreeKmerIndex.to_file holds it:
        k-mers uint64, bucket sizes uint32, every other column in its
        dtype."""
        col = getattr(self, name)
        if not isinstance(col, torch.Tensor):
            return col
        if name == "n_kmers":
            return _to_numpy(col, np.uint32)
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
        """A fresh device view after a column changes, so that no query
        reads a stale copy."""
        self.device_index = DeviceKmerIndex(self)

    def set_frequencies(self, skip=False) -> None:
        """Frequencies by distinct ref offsets, computed on the index's
        device (zeros with ``skip``); uint16 values, as in the JAX
        package."""
        self._invalidate_query_caches()
        self.dtypes["frequencies"] = np.dtype(np.uint16)
        if skip:
            self.frequencies = torch.zeros(self.kmers.shape[0],
                                           dtype=torch.int32,
                                           device=self.device)
            return
        self.frequencies = frequencies_by_distinct_ref_offsets(
            self.kmers,
            as_device_tensor(self.ref_offsets, torch.int64, self.device))

    def remove_ref_offsets(self) -> None:
        self._invalidate_query_caches()
        self.ref_offsets = np.array([0])
        self.dtypes["ref_offsets"] = self.ref_offsets.dtype

    def remove_frequencies(self) -> None:
        self._invalidate_query_caches()
        self.frequencies = np.array([0])
        self.dtypes["frequencies"] = self.frequencies.dtype

    def max_node_id(self) -> int:
        return int(self.nodes.max())

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

    # -- batched queries -------------------------------------------------------

    def _queries(self, kmers) -> torch.Tensor:
        if not isinstance(kmers, torch.Tensor):
            kmers = np.asarray(kmers, dtype=np.uint64)
        return as_device_tensor(kmers, torch.int64, self.device)

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
