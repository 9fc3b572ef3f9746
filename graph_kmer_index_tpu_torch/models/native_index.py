"""Host-side native (C++) lookup front-end, the port of
graph_kmer_index_tpu/models/native_index.py: the API of the reference's
CythonKmerIndex (cython_kmer_index.pyx:22-109) and of the external
``kmer_mapper`` package's entry points (map_kmers_to_graph_index /
in_graph_index, used at reference collision_free_kmer_index.py:210-232).

The device lookup (ops.lookup.DeviceKmerIndex) is the production path;
this class serves host-resident pipelines (``map_reads -b native``, the
frequency scoring of an index that lies on the CPU) and is the exact
behavioural spec for the device lookup (the tests assert equality).

Marshalling is lazy and copy-averse: each table is taken from the index
at first use and kept. A column of a CPU index is read where it lies
(``Tensor.numpy()`` shares the memory; int64 k-mer bits are viewed as
uint64, int32 bucket tables are passed to C at their width, int32 sizes
viewed as uint32); a column on a CUDA device is copied to the host once.
The index drops this view whenever a column changes
(KmerIndex._invalidate_query_caches), so no stale copy is read.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np

from .. import native
from ..flat_kmers import host_column
from ..utils.hugepages import hp_empty


def _host_contig(arr, dtype) -> np.ndarray:
    """``arr`` (a numpy array or a tensor on any device) as a contiguous
    host array of ``dtype``. Same-width integer columns are reinterpreted
    (int64 k-mer bits as uint64, int32 sizes as uint32: every value is
    non-negative); a conversion that must copy lands in a populated
    hugepage buffer (utils/hugepages.py)."""
    a = host_column(arr)
    dtype = np.dtype(dtype)
    if (a.dtype != dtype and a.dtype.kind in "iu" and dtype.kind in "iu"
            and a.dtype.itemsize == dtype.itemsize
            and a.flags.c_contiguous):
        a = a.view(dtype)
    if a.dtype == dtype and a.flags.c_contiguous:
        return a
    out = hp_empty(a.shape, dtype)
    np.copyto(out, a, casting="unsafe")
    return out


class NativeKmerIndex:
    """Wraps a KmerIndex's columns for native batched lookup."""

    def __init__(self, index):
        self._index = index
        self.modulo = int(index.modulo)

    @property
    def _n(self) -> int:
        return int(self._index.kmers.shape[0])

    def _row_table(self, value, dtype) -> np.ndarray:
        """Host-marshal a per-row table; anything that is not a length-n
        vector (None, scalar 0 placeholder, remove_ref_offsets()'s
        1-element stub — the C kernels would read past it, UB) becomes
        zeros like the reference's missing-table behavior."""
        n = self._n
        if value is None or np.ndim(value) != 1 or np.shape(value)[0] != n:
            return np.zeros(n, dtype)
        return _host_contig(value, dtype)

    @cached_property
    def table_kmers(self) -> np.ndarray:
        return _host_contig(self._index.kmers, np.uint64)

    @cached_property
    def table_nodes(self) -> np.ndarray:
        return _host_contig(self._index.nodes, np.uint32)

    @cached_property
    def table_ref_offsets(self) -> np.ndarray:
        return self._row_table(self._index.ref_offsets, np.uint64)

    @cached_property
    def table_frequencies(self) -> np.ndarray:
        return self._row_table(self._index.frequencies, np.uint16)

    @cached_property
    def table_allele_frequencies(self) -> np.ndarray:
        return self._row_table(self._index.allele_frequencies, np.float32)

    @cached_property
    def starts_tbl(self) -> np.ndarray:
        # int32 (the device build's layout) passes through at native
        # width — native._starts_args dispatches to the *32 C entry
        # points; only exotic dtypes pay the int64 widening
        a = host_column(self._index.hashes_to_index)
        if a.dtype in (np.int32, np.int64) and a.flags.c_contiguous:
            return a
        return _host_contig(a, np.int64)

    @cached_property
    def sizes_tbl(self) -> np.ndarray:
        return _host_contig(self._index.n_kmers, np.uint32)

    @staticmethod
    def available() -> bool:
        return native.available()

    @cached_property
    def _get_args(self):
        """Cached ctypes pointers + starts-width suffix for get() — the
        per-call marshal otherwise dominates small-batch lookups (the
        CythonKmerIndex.get usage pattern: many tiny batches)."""
        import ctypes
        starts, starts_ptr, suffix = native._starts_args(self.starts_tbl)
        p = native._ptr
        return (p(self.table_kmers, ctypes.c_uint64),
                p(self.table_nodes, ctypes.c_uint32),
                p(self.table_ref_offsets, ctypes.c_uint64),
                p(self.table_frequencies, ctypes.c_uint16),
                p(self.table_allele_frequencies, ctypes.c_float),
                starts_ptr,
                p(self.sizes_tbl, ctypes.c_uint32)), suffix, starts

    def get(self, kmers, hit_cap=10000, freq_cap=20):
        """(5, n_hits) uint64 [node, ref_offset, query_index, frequency,
        1000*allele_frequency] (cython_kmer_index.pyx:101-106)."""
        import ctypes
        lib = native.get_lib()
        if lib is None:
            return None
        native._check_modulo(self.modulo)  # modulo==0 is SIGFPE in C
        (ptrs, suffix, _starts_keepalive) = self._get_args
        kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
        args = (native._ptr(kmers, ctypes.c_uint64), len(kmers), *ptrs,
                int(self.modulo), int(hit_cap), int(freq_cap))
        fn = getattr(lib, f"gki_bucket_lookup{suffix}")
        n_hits = fn(*args, 1, None, 0)
        out = np.zeros((5, max(1, n_hits)), dtype=np.uint64)
        if n_hits > 0:
            fn(*args, 0, native._ptr(out, ctypes.c_uint64), n_hits)
        return out[:, :n_hits]

    # host records cost 64B/row; above this budget keep the bucket chase
    PACKED_BYTE_BUDGET = 16 << 30

    # packed records answer a query faster but cost a records-table
    # build: a rent-or-buy tradeoff. None = auto: chase until cumulative
    # query volume reaches 4x the table rows, then build. True/False
    # force one path.
    prefer_packed: bool | None = None
    _q_seen = 0

    def _use_packed(self, n_queries: int) -> bool:
        if self.prefer_packed is not None:
            return self.prefer_packed
        built = getattr(self, "_packed_np", None)
        if built is not None:
            return bool(built)
        self._q_seen += int(n_queries)
        return self._q_seen >= 4 * max(1, self._n)

    def _packed(self):
        """Host packed-record tables (same layout as ops/lookup.py): one
        cache miss per query plus a prefetch pipeline."""
        if getattr(self, "_packed_np", None) is None:
            # the next prime >= max(67, 2n + 1); ops.lookup computes the
            # same, but imports torch
            from ..ops.lookup import internal_modulo
            n = len(self.table_kmers)
            modulo2 = internal_modulo(n)
            if modulo2 * 32 > self.PACKED_BYTE_BUDGET:
                self._packed_np = False
            else:
                built = native.build_packed(self.table_kmers,
                                            self.table_nodes, modulo2)
                self._packed_np = (False if built is None
                                   else (*built, modulo2))
        return self._packed_np or None

    def map_kmers(self, kmers, n_nodes):
        p = self._packed() if self._use_packed(len(kmers)) else None
        if p is not None:
            rec, rows_k, rows_n, modulo2 = p
            return native.packed_map_kmers(kmers, rec, rows_k, rows_n,
                                           modulo2, int(n_nodes))
        return native.map_kmers(kmers, self.table_kmers, self.table_nodes,
                                self.starts_tbl, self.sizes_tbl, self.modulo,
                                int(n_nodes))

    def has_kmers(self, kmers):
        p = self._packed() if self._use_packed(len(kmers)) else None
        if p is not None:
            rec, rows_k, rows_n, modulo2 = p
            return native.packed_has_kmers(kmers, rec, rows_k, modulo2)
        return native.has_kmers(kmers, self.table_kmers, self.starts_tbl,
                                self.sizes_tbl, self.modulo)
