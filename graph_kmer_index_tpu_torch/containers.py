"""Array containers (layer L2): growable numpy lists, array hash tables.

Replaces the reference's nplist.py / npset.py / multi_value_hashtable.py /
logn_hash_map.py and its external ``npstructures`` dependency (HashTable,
Counter). Everything is flat-array-based so tables can ship to device.
(The port's copy of graph_kmer_index_tpu/containers.py.)
"""
from __future__ import annotations

import numpy as np

from .utils.hugepages import hp_zeros


class NpList:
    """Amortized-growth numpy-backed list (reference nplist.py:4-69):
    x1.5 growth on append, x2 on extend; ``set_n_elements`` truncates for
    DFS backtracking."""

    def __init__(self, dtype=None):
        self._dtype = dtype
        self._data = np.empty(0, dtype=dtype if dtype is not None else np.float64)
        self._n_elements = 0

    def _initialize_array(self, first_element):
        if self._dtype is None:
            self._dtype = type(first_element)
        self._data = np.zeros(100, dtype=self._dtype)

    def _grow(self, new_length):
        # populate=True: the copy below immediately writes the whole
        # prefix (>= 1/1.5 of the buffer), and lazily-faulted pages are
        # slow under heap fragmentation (utils/hugepages.py)
        new_data = hp_zeros(new_length, self._data.dtype, populate=True)
        new_data[: self._n_elements] = self._data[: self._n_elements]
        self._data = new_data

    def append(self, element):
        if len(self._data) == 0:
            self._initialize_array(element)
        if self._n_elements == len(self._data):
            self._grow(int(len(self._data) * 1.5))
        self._data[self._n_elements] = element
        self._n_elements += 1

    def extend(self, elements):
        n = len(elements)
        if n == 0:
            return
        if len(self._data) == 0:
            self._initialize_array(elements[0])
        if self._n_elements + n >= len(self._data):
            self._grow((self._n_elements + n) * 2)
        self._data[self._n_elements : self._n_elements + n] = elements
        self._n_elements += n

    def __getitem__(self, item):
        return self.get_nparray()[item]

    def get_nparray(self):
        return self._data[: self._n_elements]

    def set_n_elements(self, n):
        self._n_elements = n

    def copy(self):
        new = NpList(dtype=self._dtype)
        new.extend(self.get_nparray())
        return new

    def __eq__(self, other):
        return bool(np.all(self.get_nparray() == other.get_nparray()))

    def __len__(self):
        return self._n_elements

    def __str__(self):
        return str(self.get_nparray())

    def __repr__(self):
        return "NpList(" + str(self) + ")"


class HashTable:
    """Flat multi-map: keys -> values, collision-free via stored full keys.

    Sorted-unique-key layout (searchsorted lookup). Replaces
    npstructures.HashTable for this package's needs; repeated keys are
    allowed and scalar ``table[key]`` returns ALL values for that key in
    insertion order (what KmerIndex2 relies on, reference
    collision_free_kmer_index.py:110-158). Vectorized ``table[keys]``
    returns one value per key (missing -> 0) and raises on multi-maps.
    """

    def __init__(self, keys, values, mod=None):
        keys = np.asarray(keys)
        values = np.asarray(values)
        order = np.argsort(keys, kind="stable")
        self._sorted_keys = keys[order]
        self._sorted_values = values[order]
        self._unique_keys, starts = np.unique(self._sorted_keys, return_index=True)
        self._starts = starts
        self._counts = np.diff(np.concatenate([starts, [len(keys)]]))
        self.dtype = keys.dtype.type

    @property
    def _keys(self):
        return self._sorted_keys

    def __getitem__(self, key):
        if np.ndim(key) == 0:
            i = np.searchsorted(self._unique_keys, key)
            if i >= len(self._unique_keys) or self._unique_keys[i] != key:
                return self._sorted_values[:0]
            s = self._starts[i]
            return self._sorted_values[s : s + self._counts[i]]
        # vectorized: one value per key; missing -> 0. Only meaningful on
        # unique-key tables — a multi-map would need a ragged result, so
        # refuse loudly instead of silently returning first-hits only
        # (use the scalar path per key for multi-maps)
        if len(self._unique_keys) != len(self._sorted_keys):
            raise ValueError(
                "vectorized HashTable lookup on a table with repeated "
                "keys would drop values; query multi-maps per key")
        key = np.asarray(key)
        i = np.clip(np.searchsorted(self._unique_keys, key), 0,
                    max(len(self._unique_keys) - 1, 0))
        if len(self._unique_keys) == 0:
            return np.zeros(len(key), dtype=self._sorted_values.dtype)
        hit = self._unique_keys[i] == key
        out = np.where(hit, self._sorted_values[self._starts[i]], 0)
        return out


class Counter:
    """Exact counting restricted to a fixed key universe (replaces
    npstructures.Counter as used by KmerCounter / CounterKmerIndex)."""

    def __init__(self, keys, values=0, mod=None, value_dtype=np.int64):
        keys = np.asarray(keys)
        self._keys, inverse = np.unique(keys, return_inverse=True)
        if np.ndim(values) == 0:
            counts = np.full(len(self._keys), values, dtype=value_dtype)
        else:
            # values align with the CALLER's key order; np.unique sorted
            # and dedup'd the keys, so scatter them through the inverse
            # permutation (duplicate keys sum their values)
            counts = np.zeros(len(self._keys), dtype=value_dtype)
            np.add.at(counts, inverse,
                      np.asarray(values).astype(value_dtype))
        self._counts = counts

    def count(self, kmers):
        kmers = np.asarray(kmers)
        i = np.clip(np.searchsorted(self._keys, kmers), 0,
                    max(len(self._keys) - 1, 0))
        if len(self._keys) == 0:
            return
        hit = self._keys[i] == kmers
        np.add.at(self._counts, i[hit], 1)

    def __getitem__(self, kmers):
        if np.ndim(kmers) == 0:
            i = np.searchsorted(self._keys, kmers)
            if i >= len(self._keys) or self._keys[i] != kmers:
                return self._counts[:0]
            return self._counts[i : i + 1]
        kmers = np.asarray(kmers)
        if len(self._keys) == 0:
            return np.zeros(len(kmers), dtype=self._counts.dtype)
        i = np.clip(np.searchsorted(self._keys, kmers), 0,
                    len(self._keys) - 1)
        hit = self._keys[i] == kmers
        return np.where(hit, self._counts[i], 0)

    def values(self):
        return self._counts

    def keys(self):
        return self._keys


class NpSet:
    """Membership set over a HashTable (reference npset.py:5-18)."""

    def __init__(self, values):
        if isinstance(values, HashTable):
            self._values = values
        else:
            unique = np.unique(np.asarray(values))
            self._values = HashTable(unique, np.ones(len(unique)))

    def __contains__(self, item):
        return len(self._values[self._values.dtype(item)]) > 0


class MultiValueHashTable:
    """key -> {name: all values} multi-map (reference
    multi_value_hashtable.py:5-23)."""

    def __init__(self, hash_table: HashTable, values: dict):
        self._hash_table = hash_table
        self._values = values

    @classmethod
    def from_keys_and_values(cls, keys, values: dict, mod=None):
        table = HashTable(keys, np.arange(len(keys), dtype=np.int64), mod=mod)
        return cls(table, values)

    def get_unique_keys(self):
        return np.unique(self._hash_table._keys.ravel())

    def get_all_keys(self):
        return self._hash_table._keys.ravel()

    def row_keys(self):
        """Per-row keys ALIGNED WITH THE VALUE ARRAYS (original insertion
        order) — get_all_keys returns the hash-sorted layout, which must
        not be zipped against ``_values``. Reconstructed through the
        stored arange permutation, so no extra array is kept. Requires
        the ``from_keys_and_values`` construction (whose HashTable values
        are the arange row indices); a hand-built table with other
        values has no recoverable row order."""
        t = self._hash_table
        rk = np.empty(len(t._sorted_keys), dtype=t._sorted_keys.dtype)
        rk[t._sorted_values] = t._sorted_keys
        return rk

    def __getitem__(self, key):
        indexes = self._hash_table[key]
        return {name: value[indexes] for name, value in self._values.items()}


class BaseHashMap:
    def to_file(self, file_name):
        np.save(file_name, self._hashes)

    @classmethod
    def from_file(cls, file_name):
        data = np.load(str(file_name) + ".npy")
        if data.dtype != np.int64:
            data = data.astype(np.int64)
        return cls(data)

    def unhash(self, hash_):
        return self._hashes[hash_]


class ModuloHashMap(BaseHashMap):
    """hash -> dense index via a modulo table (reference logn_hash_map.py:21-45)."""

    def __init__(self, hashes):
        self._hashes = np.asarray(hashes).astype(np.int64)

    @classmethod
    def from_sorted_array(cls, sorted_hash_array, modulo=452930477):
        sorted_hash_array = np.unique(sorted_hash_array)
        hashes = np.zeros(modulo, dtype=np.int64)
        slots = (sorted_hash_array % modulo).astype(np.int64)
        hashes[slots] = np.arange(len(sorted_hash_array), dtype=np.int64)
        return cls(hashes)

    def hash(self, key, modulo=452930477):
        index = self._hashes[int(key) % modulo]
        if index == 0:
            return None
        return int(index)


class LogNHashMap(BaseHashMap):
    """hash -> dense index via searchsorted over sorted uniques
    (reference logn_hash_map.py:48-57)."""

    def __init__(self, sorted_hash_array):
        self._hashes = np.unique(sorted_hash_array)

    def hash(self, key):
        index = np.searchsorted(self._hashes, key)
        if index >= len(self._hashes) or self._hashes[index] != key:
            return None
        return int(index)
